"""GroupNorm(+SiLU or ReLU) kernels K3 and K5, and their dispatch.

K3 replaces `prompt_diffusion_tpu/ops/fused_group_norm.py::fused_group_norm`,
both its one-pass VMEM-resident kernel (`_gn_kernel`) and its two-pass
row-blocked kernel (`_stats_kernel` + `_apply_kernel`), with either
epilogue: SiLU (the SD1.5 and SD3 models) or ReLU (timm's GroupNormAct in
the MiDaS DPT-Hybrid backbone); SiLU wins when both are set. K5 replaces
`fused_group_norm_quant` (`_gn_quant_kernel`): the same GroupNorm, then
int8 codes with one fp32 scale per sample (the int8 serving mode).

What bounds them: nothing but memory traffic. A sample is 2.6 MB in the
512² UNet and 64 MB in the VAE decoder, far beyond one SM's shared memory.
K3 is Triton (`_triton_norms.py`): a stats pass over (sample, row block,
channel block) tiles writes each tile's per-channel mean and sum of squared
deviations; a small combine program per (sample, group) merges them with
Chan's parallel formula (no E[x²] - E[x]² cancellation on the VAE's
large-mean activations) and folds the affine into one per-channel scale and
shift; an apply pass writes x * scale + shift (+ SiLU or ReLU). That is two
reads and one write of the activation, like the TPU's two-pass path.

K5 is CUDA C++ (`csrc/gn_quant.cu`, plan and launcher in `gn_quant.py`):
one cooperative launch of a persistent grid whose two grid barriers carry
the group statistics and the sample's amax, the amax taken from each
channel's min and max of x, a second read of the activation (from L2
where it fits) for the codes. The TPU kernel held a sample in VMEM and read it once;
JAX falls back to jnp above 8 MB samples, while this kernel serves every
size (the int8 VAE's 64 MB samples included). Its parent design, K3's
stats and combine programs followed by `_triton_quant.gn_amax_kernel`
(after a memset of the amax slots) and `gn_quant_kernel`, five device
launches, stays only for `tools/quant_tune.py --part time`; no wrapper
routes to it.
"""

from __future__ import annotations

import torch

from prompt_diffusion_tpu_torch.ops.dispatch import use_kernel
from prompt_diffusion_tpu_torch.ops.gn_quant import gn_quant
from prompt_diffusion_tpu_torch.ops.norms import group_norm as _torch_group_norm
from prompt_diffusion_tpu_torch.ops.norms import group_norm_f32

_ROWS = 128      # pixels per stats/apply tile
_BLOCK_C = 64    # channels per stats/apply tile
_BLOCK_R = 64    # row-block partials per combine step
_MIN_GN_ELEMS = 1 << 18  # smallest activation that takes the kernel


def fused_group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     num_groups: int, eps: float = 1e-5,
                     apply_silu: bool = False, apply_relu: bool = False) -> torch.Tensor:
    """GroupNorm(+SiLU or ReLU) of an NCHW tensor with fp32 statistics and
    affine; the kernel on CUDA, the plain version on the CPU.
    `fused_group_norm.relu_launches` counts the launches with the ReLU
    epilogue among `launches`."""
    if not use_kernel(x):
        return _torch_group_norm(x, num_groups, scale, bias, eps=eps,
                                 apply_silu=apply_silu, apply_relu=apply_relu)
    return _launch(x, scale, bias, num_groups, eps, apply_silu, apply_relu)


fused_group_norm.launches = fused_group_norm.relu_launches = 0


def _check(x, scale, bias, num_groups):
    if x.ndim != 4:
        raise ValueError(f"fused_group_norm takes (B, C, H, W), got {tuple(x.shape)}")
    c = x.shape[1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"affine must be ({c},), got {tuple(scale.shape)}, {tuple(bias.shape)}")
    if not x.dtype.is_floating_point:
        raise ValueError(f"fused_group_norm takes a float tensor, got {x.dtype}")
    return x.contiguous(memory_format=torch.channels_last)


def _stats(x, scale, bias, num_groups, eps):
    """K3's stats and combine programs: per-(sample, channel) fp32 scale
    and shift with the affine folded in. Runs on the current device."""
    import triton

    from prompt_diffusion_tpu_torch.ops import _triton_norms as tk

    b, c, h, w = x.shape
    hw, cg = h * w, c // num_groups
    rb, cb = triton.cdiv(hw, _ROWS), triton.cdiv(c, _BLOCK_C)
    f32 = dict(dtype=torch.float32, device=x.device)
    part_mean = torch.empty((b, rb, c), **f32)
    part_m2 = torch.empty((b, rb, c), **f32)
    eff_scale = torch.empty((b, c), **f32)
    eff_shift = torch.empty((b, c), **f32)
    tk.gn_stats_kernel[(b, rb, cb)](x, part_mean, part_m2, hw, c, rb,
                                    ROWS=_ROWS, BLOCK_C=_BLOCK_C)
    tk.gn_combine_kernel[(b, num_groups)](
        part_mean, part_m2, scale.float().contiguous(), bias.float().contiguous(),
        eff_scale, eff_shift, hw, c, rb, cg, float(eps),
        ROWS=_ROWS, BLOCK_R=_BLOCK_R, BLOCK_CG=triton.next_power_of_2(cg))
    return eff_scale, eff_shift, (b, rb, cb)


def _launch(x, scale, bias, num_groups, eps, apply_silu, apply_relu):
    from prompt_diffusion_tpu_torch.ops import _triton_norms as tk

    x = _check(x, scale, bias, num_groups)
    b, c, h, w = x.shape
    y = torch.empty_like(x)
    relu = bool(apply_relu) and not apply_silu
    with torch.cuda.device(x.device):
        eff_scale, eff_shift, grid = _stats(x, scale, bias, num_groups, eps)
        tk.gn_apply_kernel[grid](x, y, eff_scale, eff_shift, h * w, c,
                                 ROWS=_ROWS, BLOCK_C=_BLOCK_C, APPLY_SILU=bool(apply_silu),
                                 APPLY_RELU=relu)
    fused_group_norm.launches += 1
    fused_group_norm.relu_launches += relu
    return y


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
    `fused_group_norm`; the rest through the plain version."""
    if x.ndim == 4 and x.numel() >= _MIN_GN_ELEMS and x.shape[1] % num_groups == 0:
        return fused_group_norm(x, scale, bias, num_groups, eps, apply_silu, apply_relu)
    return _torch_group_norm(x, num_groups, scale, bias, eps=eps,
                             apply_silu=apply_silu, apply_relu=apply_relu)
