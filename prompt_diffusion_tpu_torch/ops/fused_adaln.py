"""AdaLN -> int8 kernel K13, in Triton, and its plain version.

Replaces `prompt_diffusion_tpu/ops/fused_adaln.py::fused_adaln_quant`
(`_adaln_quant_kernel`): the four modulation sites of every SD3 JointBlock
in the int8 serving mode (norm1 / norm2 of the image and the context
stream, and norm1_context of the last block), LayerNorm without affine
(eps 1e-6) in fp32, then x * (1 + scale[b]) + shift[b] with per-sample
modulation vectors, then int8 codes with one fp32 scale per row, which the
q/k/v and `ff_in` `QuantDense`s take as a pair.

What bounds it: memory traffic (one read of the bf16 activation, one int8
write). One program holds a block of whole rows in registers (C = 1536 on
the SD3 path), takes the row's sample index as row // N to read the
modulation vectors, and masks the row tail; the TPU kernel's pad of the
row count to 8 is a tiling rule with no counterpart here. The JAX CPU path
quantizes the fp32 value like the TPU kernel (`fused_adaln.py:144-146`),
and so do this kernel and its plain version.

K12 (`fused_adaln`, the same without the int8 epilogue) is called by no
model and is not ported yet.
"""

from __future__ import annotations

import torch

from prompt_diffusion_tpu_torch.ops.dispatch import use_kernel
from prompt_diffusion_tpu_torch.ops.fused_layer_norm import _TILE, rowquant


def _torch_adaln(x, scale, shift, eps: float):
    """Plain AdaLN (`_jnp_adaln`) in fp32; scale and shift broadcast
    against x (B, N, C) as (B, 1, C)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    h = (xf - mean) * torch.rsqrt(var + eps)
    return h * (1.0 + scale.float()) + shift.float()


def fused_adaln_quant(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                      eps: float = 1e-6):
    """K13: x (B, N, C), scale and shift (B, 1, C) or (B, C) -> (int8 (B, N,
    C), fp32 row scales (B, N, 1)); the kernel on CUDA, the plain version on
    the CPU."""
    if x.ndim != 3:
        raise ValueError(f"fused_adaln_quant expects (B, N, C), got {tuple(x.shape)}")
    b, n, c = x.shape
    scale, shift = scale.reshape(b, 1, c), shift.reshape(b, 1, c)
    if not use_kernel(x):
        return rowquant(_torch_adaln(x, scale, shift, eps))
    import triton

    from prompt_diffusion_tpu_torch.ops import _triton_quant as tq

    if not x.dtype.is_floating_point:
        raise ValueError(f"fused_adaln_quant takes a float tensor, got {x.dtype}")
    x2 = x.contiguous().view(b * n, c)
    sc = scale.float().contiguous()
    sh = shift.float().contiguous()
    block_c = triton.next_power_of_2(c)
    block_r = max(1, _TILE // block_c)
    q = torch.empty((b, n, c), dtype=torch.int8, device=x.device)
    s_a = torch.empty((b, n, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        tq.adaln_quant_kernel[(triton.cdiv(b * n, block_r),)](
            x2, sc, sh, q, s_a, b * n, n, c, float(eps), BLOCK_R=block_r, BLOCK_C=block_c)
    fused_adaln_quant.launches += 1
    return q, s_a


fused_adaln_quant.launches = 0
