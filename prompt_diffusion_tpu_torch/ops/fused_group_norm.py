"""GroupNorm(+SiLU or ReLU) kernels K3 and K5, and their dispatch.

K3 replaces `prompt_diffusion_tpu/ops/fused_group_norm.py::fused_group_norm`,
both its one-pass VMEM-resident kernel (`_gn_kernel`) and its two-pass
row-blocked kernel (`_stats_kernel` + `_apply_kernel`), with either
epilogue: SiLU (the SD1.5 and SD3 models) or ReLU (timm's GroupNormAct in
the MiDaS DPT-Hybrid backbone); SiLU wins when both are set. K5 replaces
`fused_group_norm_quant` (`_gn_quant_kernel`): the same GroupNorm, then
int8 codes with one fp32 scale per sample (the int8 serving mode).

What bounds them: nothing but memory traffic. A sample is 2.6 MB in the
512² UNet and up to 268 MB in the SD3 VAE decoder at 1024², far beyond one
SM's shared memory. Both are CUDA C++ (`csrc/gn_quant.cu`, plans and
launchers in `gn_quant.py`): one cooperative launch of a persistent grid,
the group statistics of every sample's blocks merged across a grid
barrier (Chan's parallel formula, no E[x²] - E[x]² cancellation on the
VAE's large-mean activations), by one code path in both kernels. K3 then
writes x * scale + shift (+ SiLU or ReLU) in x's dtype, from the block's
last chunk kept in registers and the others read again (from L2 where the
activation fits there); K5 takes the sample's amax from each channel's
min and max of x across a second barrier and writes the codes. The TPU
kernels held a sample in VMEM and read it once; JAX falls back to jnp (K5)
or a two-pass kernel (K3) above 8 MB samples, while these serve every
size.

The parent designs stay only for `tools/quant_tune.py --part time`: K3's
three Triton programs (`_triton_norms.py`: stats, combine, apply) and K5's
five launches (K3's stats and combine, a fill, `_triton_quant.py`'s
`gn_amax_kernel` and `gn_quant_kernel`). No wrapper routes to them.
"""

from __future__ import annotations

import torch

from prompt_diffusion_tpu_torch.ops.dispatch import recompute_grads, use_kernel
from prompt_diffusion_tpu_torch.ops.gn_quant import (
    ACT_NONE,
    ACT_RELU,
    ACT_SILU,
    gn_float,
    gn_quant,
)
from prompt_diffusion_tpu_torch.ops.norms import group_norm as _torch_group_norm
from prompt_diffusion_tpu_torch.ops.norms import group_norm_f32

_MIN_GN_ELEMS = 1 << 18  # smallest activation that takes the kernel


class _GroupNorm(torch.autograd.Function):
    """K3 with its gradient: the kernel forward on CUDA tensors (the plain
    version on the CPU), the backward by autograd of the plain version
    recomputed from the saved x and affine (the JAX `custom_vjp`'s
    `jax.vjp` of `_jnp_group_norm`)."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, apply_silu, apply_relu):
        ctx.args = (num_groups, eps, apply_silu, apply_relu)
        ctx.save_for_backward(x, scale, bias)
        if not use_kernel(x):
            return _torch_group_norm(x, num_groups, scale, bias, eps=eps,
                                     apply_silu=apply_silu, apply_relu=apply_relu)
        act = ACT_SILU if apply_silu else ACT_RELU if apply_relu else ACT_NONE
        y = gn_float(x, scale, bias, num_groups, eps, act)
        fused_group_norm.launches += 1
        fused_group_norm.relu_launches += act == ACT_RELU
        return y

    @staticmethod
    def backward(ctx, g):
        fused_group_norm.backward_calls += 1
        num_groups, eps, apply_silu, apply_relu = ctx.args
        plain = lambda x, s, b: _torch_group_norm(x, num_groups, s, b, eps=eps,
                                                  apply_silu=apply_silu, apply_relu=apply_relu)
        return (*recompute_grads(plain, g, ctx.saved_tensors, ctx.needs_input_grad[:3]),
                None, None, None, None)


def fused_group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     num_groups: int, eps: float = 1e-5,
                     apply_silu: bool = False, apply_relu: bool = False) -> torch.Tensor:
    """GroupNorm(+SiLU or ReLU) of an NCHW tensor with fp32 statistics and
    affine; K3 on CUDA (bf16 or fp32, C a multiple of 8 up to 4096, else a
    ValueError; one launch for a channels_last input), the plain version on
    the CPU. Differentiable in x, scale and bias (each backward counted in
    `backward_calls`).
    `fused_group_norm.relu_launches` counts the launches with the ReLU
    epilogue among `launches`."""
    return _GroupNorm.apply(x, scale, bias, num_groups, eps, apply_silu, apply_relu)


fused_group_norm.launches = fused_group_norm.relu_launches = 0
fused_group_norm.backward_calls = 0


def _torch_group_norm_quant(x, num_groups, scale, bias, eps, apply_silu):
    """Plain K5: the fp32 GroupNorm(+SiLU), then int8 codes and one scale
    per sample. It quantizes the fp32 value, as the TPU kernel does (the
    JAX CPU fallback first rounds it to the input dtype)."""
    y = group_norm_f32(x, num_groups, scale, bias, eps=eps, apply_silu=apply_silu)
    s_a = torch.clamp_min(y.abs().amax(dim=(1, 2, 3)) / 127.0, 1e-8)
    q = torch.clamp(torch.round(y / s_a.view(-1, 1, 1, 1)), -127, 127).to(torch.int8)
    return q, s_a


def fused_group_norm_quant(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                           num_groups: int, eps: float = 1e-5,
                           apply_silu: bool = False):
    """K5: GroupNorm(+SiLU) of an NCHW tensor -> (int8 (B, C, H, W) in
    channels_last memory, fp32 scale per sample (B,)); the CUDA kernel on
    the card at every size (bf16 or fp32, C a multiple of 8, one launch for
    a channels_last input), the plain version on the CPU."""
    if not use_kernel(x):
        return _torch_group_norm_quant(x, num_groups, scale, bias, eps, apply_silu)
    out = gn_quant(x, scale, bias, num_groups, eps, apply_silu)
    fused_group_norm_quant.launches += 1
    return out


fused_group_norm_quant.launches = 0


def group_norm_auto(x, num_groups, scale, bias, eps=1e-5, apply_silu=False,
                    apply_relu=False):
    """The kernel rule of the TPU package: 4-D activations of at least
    2^18 elements whose channels split into the groups go through
    `fused_group_norm` (on the card K3, which raises on what it does not
    take: a dtype other than bf16 and fp32, C not a multiple of 8 or above
    4096; every site of the ported models is bf16 or fp32 with C = 64 ...
    2560); the rest through the plain version."""
    if x.ndim == 4 and x.numel() >= _MIN_GN_ELEMS and x.shape[1] % num_groups == 0:
        return fused_group_norm(x, scale, bias, num_groups, eps, apply_silu, apply_relu)
    return _torch_group_norm(x, num_groups, scale, bias, eps=eps,
                             apply_silu=apply_silu, apply_relu=apply_relu)
