"""AdaLN kernel K12 with its gradient and AdaLN -> int8 kernel K13, and
their plain versions.

Replaces `prompt_diffusion_tpu/ops/fused_adaln.py`:
  * K13 `fused_adaln_quant` (`_adaln_quant_kernel`): the four modulation
    sites of every SD3 JointBlock in the int8 serving mode (norm1 / norm2
    of the image and the context stream, and norm1_context of the last
    block), LayerNorm without affine (eps 1e-6) in fp32, then
    x * (1 + scale[b]) + shift[b] with per-sample modulation vectors, then
    int8 codes with one fp32 scale per row, which the q/k/v and `ff_in`
    `QuantDense`s take as a pair. CUDA C++ (`csrc/row_quant.cu`, launched
    by `row_quant.adaln_quant`, one launch per call): a warp per row, the
    modulation read in place from the model's (B, 1, C) views of one
    projection and staged once per block (the design is described in the
    source);
  * K12 `fused_adaln` (`_adaln_kernel`): the same without the int8
    epilogue, in x's dtype, with a gradient (the JAX `custom_vjp`, whose
    `_bwd` recomputes through `_jnp_adaln`). No model calls it, as none
    does in the JAX package (its bf16 MMDiT uses LayerNorm plus
    modulation). Forward: K13's kernel body with a float epilogue (op
    ADALN_F of `row_quant.cu`, launched by `row_quant.adaln`, one launch):
    y stored in x's dtype by 16-byte stores, the last multiply-add
    contracted as K13's. Backward: `adaln_bwd_kernel` of the same file
    (`row_quant.adaln_bwd`), one cooperative launch: each row's dx from x
    and the output's gradient (mean and rstd recomputed), the column sums
    of dscale and dshift per block in registers, then merged over the
    sample's blocks in a fixed order after a grid barrier, so repeats are
    bit-equal. Both take K13's domain: bf16 or fp32, C a multiple of 8 up
    to `row_quant.MAX_ROW_BYTES` (the Triton program before them took any
    C); the SD3 streams' C = 1536 lies inside it.

What bounds them: memory traffic. K13 and K12 read the activation once
and write the int8 or bf16 result; K12's backward reads x and the
gradient once and writes dx. The JAX CPU path quantizes the fp32 value
like the TPU kernel (`fused_adaln.py:144-146`), and so do K13 and its plain
version.
"""

from __future__ import annotations

from typing import Optional

import torch

from prompt_diffusion_tpu_torch.ops.dispatch import use_kernel
from prompt_diffusion_tpu_torch.ops.fused_layer_norm import rowquant
from prompt_diffusion_tpu_torch.ops.row_quant import adaln, adaln_bwd, adaln_quant


def _torch_adaln(x, scale, shift, eps: float):
    """Plain AdaLN (`_jnp_adaln`) in fp32; scale and shift broadcast
    against x (B, N, C) as (B, 1, C)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    h = (xf - mean) * torch.rsqrt(var + eps)
    return h * (1.0 + scale.float()) + shift.float()


def _torch_adaln_bwd(x, scale, g, eps: float, shift: Optional[torch.Tensor] = None):
    """Plain backward of `_torch_adaln(x, scale, shift, eps).to(x.dtype)`
    for the output's gradient g, the explicit formula in fp32 (no
    autograd): with xhat = (x - mean) * rstd and ghat = g * (1 + scale[b]),
    dx = rstd * (ghat - mean_c ghat - xhat * mean_c(ghat * xhat)),
    dscale = sum_n g * xhat, dshift = sum_n g. Returns dx in x's dtype,
    dscale in scale's dtype and shape, dshift in shift's (scale's where
    shift is not given: its values are not read)."""
    b, _, c = x.shape
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    d = xf - mean
    rstd = torch.rsqrt(d.square().mean(dim=-1, keepdim=True) + eps)
    xh = d * rstd
    gf = g.float()
    gh = gf * (1.0 + scale.float().reshape(b, 1, c))
    dx = rstd * (gh - gh.mean(dim=-1, keepdim=True)
                 - xh * (gh * xh).mean(dim=-1, keepdim=True))
    shift = scale if shift is None else shift
    return (dx.to(x.dtype), (gf * xh).sum(dim=1).to(scale.dtype).reshape(scale.shape),
            gf.sum(dim=1).to(shift.dtype).reshape(shift.shape))


def _prep(name, x, scale, shift):
    """x (B, N, C); scale and shift, (B, 1, C) or (B, C) with x's B and C,
    as (B, 1, C) views."""
    if x.ndim != 3:
        raise ValueError(f"{name} expects (B, N, C), got {tuple(x.shape)}")
    b, n, c = x.shape
    for arg, t in (("scale", scale), ("shift", shift)):
        if t.shape not in ((b, 1, c), (b, c)):
            raise ValueError(f"{name}: {arg} must be ({b}, 1, {c}) or ({b}, {c}) for x "
                             f"{tuple(x.shape)}, got {tuple(t.shape)}")
    return b, n, c, scale.reshape(b, 1, c), shift.reshape(b, 1, c)


class _AdaLN(torch.autograd.Function):
    """K12 with its gradient: on CUDA tensors the forward and backward
    kernels, on the CPU the plain forward and backward; x and the (B, 1, C)
    scale and shift saved (shift for its gradient's dtype and shape)."""

    @staticmethod
    def forward(ctx, x, scale, shift, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale, shift)
        if not use_kernel(x):
            return _torch_adaln(x, scale, shift, eps).to(x.dtype)
        out = adaln(x, scale, shift, eps)
        fused_adaln.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, shift = ctx.saved_tensors
        return (*fused_adaln_bwd(x, scale, g, ctx.eps, shift), None)


def fused_adaln_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, eps: float = 1e-6,
                    shift: Optional[torch.Tensor] = None):
    """K12's backward: x (B, N, C), scale (B, 1, C) or (B, C), the output's
    gradient g -> (dx, dscale, dshift) in the inputs' dtypes and shapes
    (dshift in shift's, or scale's where shift is not given). The kernel on
    CUDA (one cooperative launch, counted in `fused_adaln.backward_launches`;
    a g that is not contiguous, such as the expanded gradient of a sum,
    is copied first), the plain version on the CPU."""
    if not use_kernel(x):
        return _torch_adaln_bwd(x, scale, g, eps, shift)
    g = g.contiguous()
    out = adaln_bwd(x, scale, g, eps, shift)
    fused_adaln.backward_launches += 1
    return out


def fused_adaln(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """K12: x (B, N, C), scale and shift (B, 1, C) or (B, C) -> LayerNorm
    without affine, then x * (1 + scale[b]) + shift[b], in x's dtype;
    differentiable in x, scale and shift (gradients in their input shapes
    and dtypes, `fused_adaln_bwd`). The kernels on CUDA (bf16 or fp32, C a
    multiple of 8 up to `row_quant.MAX_ROW_BYTES`, dense rows; one launch
    each way, counted in `launches` and `backward_launches`), the plain
    versions on the CPU."""
    b, n, c, s3, t3 = _prep("fused_adaln", x, scale, shift)
    return _AdaLN.apply(x, s3, t3, eps)


fused_adaln.launches = 0
fused_adaln.backward_launches = 0


def fused_adaln_quant(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                      eps: float = 1e-6):
    """K13: x (B, N, C), scale and shift (B, 1, C) or (B, C) -> (int8 (B, N,
    C), fp32 row scales (B, N, 1)); the CUDA kernel on the card (bf16 or
    fp32, C a multiple of 8 up to `row_quant.MAX_ROW_BYTES`, dense rows; the
    modulation read in place, one launch), the plain version on the CPU."""
    b, n, c, s3, t3 = _prep("fused_adaln_quant", x, scale, shift)
    if not use_kernel(x):
        return rowquant(_torch_adaln(x, s3, t3, eps))
    out = adaln_quant(x, s3, t3, eps)
    fused_adaln_quant.launches += 1
    return out


fused_adaln_quant.launches = 0
