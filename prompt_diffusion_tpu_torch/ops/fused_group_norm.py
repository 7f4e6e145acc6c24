"""GroupNorm(+SiLU) kernel K3, in Triton, and its dispatch.

Replaces `prompt_diffusion_tpu/ops/fused_group_norm.py::fused_group_norm`,
both its one-pass VMEM-resident kernel (`_gn_kernel`) and its two-pass
row-blocked kernel (`_stats_kernel` + `_apply_kernel`).

What bounds it: nothing but memory traffic. A sample is 2.6 MB in the 512²
UNet and 64 MB in the VAE decoder, far beyond one SM's shared memory, so
one design serves every size: a stats pass over (sample, row block,
channel block) tiles writes each tile's per-channel mean and sum of squared
deviations; a small combine program per (sample, group) merges them with
Chan's parallel formula (no E[x²] - E[x]² cancellation on the VAE's
large-mean activations) and folds the affine into one per-channel scale and
shift; an apply pass writes x * scale + shift (+ SiLU). That is two reads
and one write of the activation, like the TPU's two-pass path.
"""

from __future__ import annotations

import torch

from prompt_diffusion_tpu_torch.ops.dispatch import use_kernel
from prompt_diffusion_tpu_torch.ops.norms import group_norm as _torch_group_norm

_ROWS = 128      # pixels per stats/apply tile
_BLOCK_C = 64    # channels per stats/apply tile
_BLOCK_R = 64    # row-block partials per combine step
_MIN_GN_ELEMS = 1 << 18  # smallest activation that takes the kernel


def fused_group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     num_groups: int, eps: float = 1e-5,
                     apply_silu: bool = False) -> torch.Tensor:
    """GroupNorm(+SiLU) of an NCHW tensor with fp32 statistics and affine;
    the kernel on CUDA, the plain version on the CPU."""
    if not use_kernel(x):
        return _torch_group_norm(x, num_groups, scale, bias, eps=eps,
                                 apply_silu=apply_silu)
    return _launch(x, scale, bias, num_groups, eps, apply_silu)


fused_group_norm.launches = 0


def _launch(x, scale, bias, num_groups, eps, apply_silu):
    import triton

    from prompt_diffusion_tpu_torch.ops import _triton_norms as tk

    if x.ndim != 4:
        raise ValueError(f"fused_group_norm takes (B, C, H, W), got {tuple(x.shape)}")
    b, c, h, w = x.shape
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"affine must be ({c},), got {tuple(scale.shape)}, {tuple(bias.shape)}")
    if not x.dtype.is_floating_point:
        raise ValueError(f"fused_group_norm takes a float tensor, got {x.dtype}")
    x = x.contiguous(memory_format=torch.channels_last)
    hw, cg = h * w, c // num_groups
    rb, cb = triton.cdiv(hw, _ROWS), triton.cdiv(c, _BLOCK_C)
    f32 = dict(dtype=torch.float32, device=x.device)
    part_mean = torch.empty((b, rb, c), **f32)
    part_m2 = torch.empty((b, rb, c), **f32)
    eff_scale = torch.empty((b, c), **f32)
    eff_shift = torch.empty((b, c), **f32)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        tk.gn_stats_kernel[(b, rb, cb)](x, part_mean, part_m2, hw, c, rb,
                                        ROWS=_ROWS, BLOCK_C=_BLOCK_C)
        tk.gn_combine_kernel[(b, num_groups)](
            part_mean, part_m2, scale.float().contiguous(), bias.float().contiguous(),
            eff_scale, eff_shift, hw, c, rb, cg, float(eps),
            ROWS=_ROWS, BLOCK_R=_BLOCK_R, BLOCK_CG=triton.next_power_of_2(cg))
        tk.gn_apply_kernel[(b, rb, cb)](x, y, eff_scale, eff_shift, hw, c,
                                        ROWS=_ROWS, BLOCK_C=_BLOCK_C,
                                        APPLY_SILU=bool(apply_silu))
    fused_group_norm.launches += 1
    return y


def group_norm_auto(x, num_groups, scale, bias, eps=1e-5, apply_silu=False):
    """The kernel rule of the TPU package: 4-D activations of at least
    2^18 elements whose channels split into the groups go through
    `fused_group_norm`; the rest through the plain version."""
    if x.ndim == 4 and x.numel() >= _MIN_GN_ELEMS and x.shape[1] % num_groups == 0:
        return fused_group_norm(x, scale, bias, num_groups, eps, apply_silu)
    return _torch_group_norm(x, num_groups, scale, bias, eps=eps,
                             apply_silu=apply_silu)
