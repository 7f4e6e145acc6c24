"""LayerNorm kernel K4, in Triton, its plain version and its dispatch.

Replaces `prompt_diffusion_tpu/ops/fused_layer_norm.py::fused_layer_norm`
(`_ln_kernel`): row LayerNorm with fp32 statistics and affine, at the three
pre-LNs of every transformer block.

What bounds it: memory traffic only (one read and one write of the
activation). One program holds a block of whole rows in registers
(C = 320, 640 or 1280 on the SD1.5 path), so the mean, the variance of the
deviations and the affine take a single read.
"""

from __future__ import annotations

import torch

from prompt_diffusion_tpu_torch.ops.dispatch import use_kernel

_TILE = 4096  # elements of one program's row block
_MIN_LN_ELEMS = 1 << 16  # smallest activation that takes the kernel


def _torch_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      eps: float) -> torch.Tensor:
    """Plain LayerNorm over the last axis (`_jnp_layer_norm`)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """x (..., C) -> LayerNorm over the last axis; the kernel on CUDA, the
    plain version on the CPU."""
    if not use_kernel(x):
        return _torch_layer_norm(x, scale, bias, eps)
    return _launch(x, scale, bias, eps)


fused_layer_norm.launches = 0


def _launch(x, scale, bias, eps):
    import triton

    from prompt_diffusion_tpu_torch.ops import _triton_norms as tk

    c = x.shape[-1]
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"affine must be ({c},), got {tuple(scale.shape)}, {tuple(bias.shape)}")
    if not x.dtype.is_floating_point:
        raise ValueError(f"fused_layer_norm takes a float tensor, got {x.dtype}")
    x2 = x.contiguous().view(-1, c)
    n = x2.shape[0]
    block_c = triton.next_power_of_2(c)
    block_r = max(1, _TILE // block_c)
    y = torch.empty_like(x2)
    with torch.cuda.device(x.device):
        tk.ln_kernel[(triton.cdiv(n, block_r),)](
            x2, y, scale.float().contiguous(), bias.float().contiguous(), n, c,
            float(eps), BLOCK_R=block_r, BLOCK_C=block_c)
    fused_layer_norm.launches += 1
    return y.view(x.shape)


def layer_norm_auto(x, scale, bias, eps=1e-5):
    """The kernel rule of the TPU package: at least 2^16 elements and
    C >= 128 go through `fused_layer_norm`; the rest through the plain
    version. (The TPU rule's row-blocking limit has no counterpart: the
    kernel masks the row tail.)"""
    if x.numel() >= _MIN_LN_ELEMS and x.shape[-1] >= 128:
        return fused_layer_norm(x, scale, bias, eps)
    return _torch_layer_norm(x, scale, bias, eps)
