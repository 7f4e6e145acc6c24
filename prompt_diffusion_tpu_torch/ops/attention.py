"""Scaled dot-product attention with fp32 softmax, and the rule that sends
it to the flash kernel (`prompt_diffusion_tpu/ops/attention.py`).

Layout: (batch, seq, heads, head_dim), as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from prompt_diffusion_tpu_torch.ops.flash_attention import _torch_attention, flash_attention


def dot_product_attention(
    q: torch.Tensor,  # (B, Nq, H, D)
    k: torch.Tensor,  # (B, Nk, H, D)
    v: torch.Tensor,  # (B, Nk, H, D)
    *,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,  # bool, broadcastable to (B, H, Nq, Nk)
    use_flash: Optional[bool] = None,
) -> torch.Tensor:
    """Multi-head attention. `use_flash=None` takes the flash kernel when
    the shapes qualify (`_flash_eligible`)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if use_flash is None:
        use_flash = _flash_eligible(q, k, mask)
    if use_flash:
        if mask is not None:
            raise ValueError(
                "use_flash=True with a mask: the flash kernel has no mask "
                "support — drop use_flash or drop the mask")
        return flash_attention(q, k, v, scale=scale)
    return _torch_attention(q, k, v, float(scale), mask=mask)


def _flash_eligible(q, k, mask) -> bool:
    """The chip rule of the TPU package: no mask, and at least 1024 queries
    and 1024 keys (the self-attention at 64² and 32² latents and the VAE
    mid-block). The wrapper then picks the kernel or, on the CPU, the
    plain version."""
    return mask is None and q.shape[1] >= 1024 and k.shape[1] >= 1024
