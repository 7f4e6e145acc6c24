"""Plain GroupNorm with fp32 statistics.

Counterpart of `prompt_diffusion_tpu/ops/norms.py::group_norm` (the
reference's GroupNorm32: stats and affine in fp32, result cast back to the
activation dtype), on NCHW tensors, with the two-pass variance. SiLU takes
precedence when both activations are asked for, as in the JAX package.
"""

from __future__ import annotations

import torch


def group_norm(x: torch.Tensor, num_groups: int, scale: torch.Tensor,
               bias: torch.Tensor, eps: float = 1e-5,
               apply_silu: bool = False, apply_relu: bool = False) -> torch.Tensor:
    """GroupNorm(+SiLU or ReLU) over channel groups of an (B, C, ...) tensor."""
    return group_norm_f32(x, num_groups, scale, bias, eps, apply_silu,
                          apply_relu).to(x.dtype)


def group_norm_f32(x: torch.Tensor, num_groups: int, scale: torch.Tensor,
                   bias: torch.Tensor, eps: float = 1e-5,
                   apply_silu: bool = False, apply_relu: bool = False) -> torch.Tensor:
    """`group_norm` before the cast back: the fp32 result."""
    c = x.shape[1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    grouped = x.float().unflatten(1, (num_groups, c // num_groups))
    red = tuple(range(2, grouped.ndim))
    mean = grouped.mean(dim=red, keepdim=True)
    var = (grouped - mean).square().mean(dim=red, keepdim=True)
    normed = ((grouped - mean) * torch.rsqrt(var + eps)).flatten(1, 2)
    shape = (1, c) + (1,) * (x.ndim - 2)
    out = normed * scale.float().reshape(shape) + bias.float().reshape(shape)
    if apply_silu:
        out = out * torch.sigmoid(out)
    elif apply_relu:
        out = torch.relu(out)
    return out
