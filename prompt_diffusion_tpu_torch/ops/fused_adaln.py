"""AdaLN kernel K12 with its gradient and AdaLN -> int8 kernel K13, and
their plain version.

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
    epilogue, in x's dtype, with a gradient. No model calls it, as none
    does in the JAX package (its bf16 MMDiT uses LayerNorm plus modulation).
    The gradient recomputes through autograd of the plain version, as the
    JAX `custom_vjp` recomputes through `_jnp_adaln`. A Triton program
    (`adaln_kernel` with QUANT=False) holds a block of whole rows in
    registers (C = 1536 on the SD3 path), takes the row's sample index as
    row // N to read the modulation vectors, and masks the row tail; the
    TPU kernels' pad of the row count to 8 is a tiling rule with no
    counterpart here.

What bounds them: memory traffic (one read of the activation, one write of
the bf16 or int8 result). The JAX CPU path quantizes the fp32 value like
the TPU kernel (`fused_adaln.py:144-146`), and so do K13 and its plain
version.
"""

from __future__ import annotations

import torch

from prompt_diffusion_tpu_torch.ops.dispatch import use_kernel
from prompt_diffusion_tpu_torch.ops.fused_layer_norm import _TILE, rowquant
from prompt_diffusion_tpu_torch.ops.row_quant import adaln_quant


def _torch_adaln(x, scale, shift, eps: float):
    """Plain AdaLN (`_jnp_adaln`) in fp32; scale and shift broadcast
    against x (B, N, C) as (B, 1, C)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    h = (xf - mean) * torch.rsqrt(var + eps)
    return h * (1.0 + scale.float()) + shift.float()


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


def _launch(x, scale, shift, eps):
    """Run K12's `adaln_kernel` on (B, N, C) x: the result in x's dtype."""
    import triton

    from prompt_diffusion_tpu_torch.ops import _triton_quant as tq

    if not x.dtype.is_floating_point:
        raise ValueError(f"AdaLN takes a float tensor, got {x.dtype}")
    b, n, c = x.shape
    x2 = x.contiguous().view(b * n, c)
    sc = scale.float().contiguous()
    sh = shift.float().contiguous()
    block_c = triton.next_power_of_2(c)
    block_r = max(1, _TILE // block_c)
    out = torch.empty((b, n, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        tq.adaln_kernel[(triton.cdiv(b * n, block_r),)](
            x2, sc, sh, out, out, b * n, n, c, float(eps), BLOCK_R=block_r, BLOCK_C=block_c,
            QUANT=False)
    return out


class _AdaLN(torch.autograd.Function):
    """K12 forward on the card; the backward recomputes through autograd of
    the plain version (the JAX `_bwd`), with x and the (B, 1, C) scale and
    shift saved."""

    @staticmethod
    def forward(ctx, x, scale, shift, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale, shift)
        out = _launch(x, scale, shift, eps)
        fused_adaln.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, shift = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (x, scale, shift)]
            out = _torch_adaln(*inputs, ctx.eps).to(x.dtype)
            grads = torch.autograd.grad(out, inputs, g)
        return (*grads, None)


def fused_adaln(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """K12: x (B, N, C), scale and shift (B, 1, C) or (B, C) -> LayerNorm
    without affine, then x * (1 + scale[b]) + shift[b], in x's dtype;
    differentiable in x, scale and shift (gradients in their input shapes).
    The kernel on CUDA, the plain version on the CPU."""
    b, n, c, s3, t3 = _prep("fused_adaln", x, scale, shift)
    if not use_kernel(x):
        return _torch_adaln(x, s3, t3, eps).to(x.dtype)
    return _AdaLN.apply(x, s3, t3, eps)


fused_adaln.launches = 0


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
