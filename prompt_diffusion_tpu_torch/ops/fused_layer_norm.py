"""LayerNorm kernels K4 (Triton) and K6 (CUDA C++), their plain versions
and the dispatch, and `rowquant`.

K4 replaces `prompt_diffusion_tpu/ops/fused_layer_norm.py::fused_layer_norm`
(`_ln_kernel`): row LayerNorm with fp32 statistics and affine, at the three
pre-LNs of every transformer block. One Triton program holds a block of
whole rows in registers (C = 320, 640 or 1280 on the SD1.5 path), so the
mean, the variance of the deviations and the affine take a single read;
the rows are masked at the tail (the TPU kernel's pad of the row count to
a multiple of 8 is a tiling rule with no counterpart).

K6 replaces `fused_layer_norm_quant` (`_ln_quant_kernel`): the same
LayerNorm, then int8 codes with one fp32 scale per row, which the q/k/v
and FF `QuantDense`s of the int8 serving mode (SD1.5's transformer blocks,
the DPT ViT's) take as a pair. It is CUDA C++ (`csrc/row_quant.cu`, op LN,
launched by `row_quant.ln_quant`; its design is described there): rows in
16-byte vectors held in registers with no power-of-two padding, the affine
staged once per block, IEEE divisions for the statistics and the
quotient. Its former Triton program (`_triton_quant.ln_quant_kernel`)
stays only as the parent design that `tools/quant_tune.py --part time`
launches beside it; no wrapper routes to it.

What bounds both: memory traffic (one read of the activation, one write of
it or of its int8 codes and the row scales).
"""

from __future__ import annotations

import torch

from prompt_diffusion_tpu_torch.ops.dispatch import recompute_grads, use_kernel
from prompt_diffusion_tpu_torch.ops.row_quant import ln_quant

_TILE = 4096  # elements of one program's row block
_MIN_LN_ELEMS = 1 << 16  # smallest activation that takes the kernel


def rowquant(h: torch.Tensor):
    """fp32 (..., C) -> (int8 (..., C), fp32 (..., 1) scales): symmetric
    per-row int8, the quantize step of K6 and K7 (`rowquant` of the JAX
    package): scale max(amax / 127, 1e-8), codes round(h / scale) with
    ties to even, clipped to +-127."""
    return rowquant_amax(h, h.abs().amax(dim=-1, keepdim=True))


def rowquant_amax(h: torch.Tensor, amax: torch.Tensor):
    """`rowquant` of fp32 h (..., C) with each row's amax given (fp32
    (..., 1)): the second half of K10's and K11's split over a tensor
    group, where the amax spans more columns than h holds."""
    s_a = torch.clamp_min(amax / 127.0, 1e-8)
    return torch.clamp(torch.round(h / s_a), -127, 127).to(torch.int8), s_a


def _layer_norm_f32(x, scale, bias, eps):
    """Plain LayerNorm over the last axis (`_jnp_layer_norm`), in fp32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return out * scale.float() + bias.float()


def _torch_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      eps: float) -> torch.Tensor:
    """Plain LayerNorm over the last axis, in the input dtype."""
    return _layer_norm_f32(x, scale, bias, eps).to(x.dtype)


class _LayerNorm(torch.autograd.Function):
    """K4 with its gradient: the kernel forward on CUDA tensors (the plain
    version on the CPU), the backward by autograd of `_torch_layer_norm`
    recomputed from the saved x and affine (the JAX `custom_vjp`'s
    `jax.vjp` of `_jnp_layer_norm`)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale, bias)
        if not use_kernel(x):
            return _torch_layer_norm(x, scale, bias, eps)
        return _launch(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        fused_layer_norm.backward_calls += 1
        plain = lambda x, s, b: _torch_layer_norm(x, s, b, ctx.eps)
        return (*recompute_grads(plain, g, ctx.saved_tensors, ctx.needs_input_grad[:3]), None)


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """x (..., C) -> LayerNorm over the last axis; the kernel on CUDA, the
    plain version on the CPU. Differentiable in x, scale and bias (each
    backward counted in `backward_calls`)."""
    return _LayerNorm.apply(x, scale, bias, eps)


fused_layer_norm.launches = 0
fused_layer_norm.backward_calls = 0


def _rows(x, scale, bias):
    """K4's (x as contiguous (N, C) rows, fp32 affine, row block, column
    block)."""
    import triton

    c = x.shape[-1]
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"affine must be ({c},), got {tuple(scale.shape)}, {tuple(bias.shape)}")
    if not x.dtype.is_floating_point:
        raise ValueError(f"fused_layer_norm takes a float tensor, got {x.dtype}")
    block_c = triton.next_power_of_2(c)
    return (x.contiguous().view(-1, c), scale.float().contiguous(), bias.float().contiguous(),
            max(1, _TILE // block_c), block_c)


def _launch(x, scale, bias, eps):
    import triton

    from prompt_diffusion_tpu_torch.ops import _triton_norms as tk

    x2, w, b, block_r, block_c = _rows(x, scale, bias)
    n, c = x2.shape
    y = torch.empty_like(x2)
    with torch.cuda.device(x.device):
        tk.ln_kernel[(triton.cdiv(n, block_r),)](
            x2, y, w, b, n, c, float(eps), BLOCK_R=block_r, BLOCK_C=block_c)
    fused_layer_norm.launches += 1
    return y.view(x.shape)


def fused_layer_norm_quant(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                           eps: float = 1e-5):
    """K6: x (..., C) -> LayerNorm over the last axis -> (int8 (..., C),
    fp32 row scales (..., 1)); the CUDA kernel on the card (bf16 or fp32
    rows, C a multiple of 8 up to `row_quant.MAX_ROW_BYTES`, a (C,) affine,
    one launch, no copy of x), the plain version on the CPU. Both quantize
    the fp32 value, as the TPU kernel does (the JAX CPU fallback first
    rounds it to the input dtype)."""
    if not use_kernel(x):
        return rowquant(_layer_norm_f32(x, scale, bias, eps))
    out = ln_quant(x, scale, bias, eps)
    fused_layer_norm_quant.launches += 1
    return out


fused_layer_norm_quant.launches = 0


def layer_norm_auto(x, scale, bias, eps=1e-5):
    """The kernel rule of the TPU package: at least 2^16 elements and
    C >= 128 go through `fused_layer_norm`; the rest through the plain
    version. (The TPU rule's row-blocking limit has no counterpart: the
    kernel masks the row tail.)"""
    if x.numel() >= _MIN_LN_ELEMS and x.shape[-1] >= 128:
        return fused_layer_norm(x, scale, bias, eps)
    return _torch_layer_norm(x, scale, bias, eps)
