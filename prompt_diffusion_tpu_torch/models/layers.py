"""Shared building blocks of the SD1.5 UNet, ControlNet and VAE.

Counterparts of `prompt_diffusion_tpu/models/layers.py`. Activations are
NCHW tensors in channels_last memory, so convolutions and the norm kernels
see C-contiguous rows. Attribute names follow the Flax parameter names
(`in_norm`, `emb_proj`, `block_0.attn1.to_q`, ...), which keeps the weight
bridge (`tools/jax_bridge.py`) mechanical.

Under a policy with `quant="int8"` (the W8A8 serving mode) the hot convs
and denses are `QuantConv` / `QuantDense` with the same state dict, and
the norms that feed them emit (int8, scale) pairs from their kernels' int8
epilogues: GroupNorm one scale per sample (K5), LayerNorm and GEGLU one per
row (K6, K7). Two serving options of that mode, set on the modules by
`PromptDiffusionSD15.create` (the JAX package's `PD_SD15_INT8_ATTN` and
`PD_SD15_FUSED_GEGLU=0`): `CrossAttention.int8_attention` sends the
kernel-eligible self-attention through K9 instead of K1, and
`GEGLUFeedForward.fused_geglu = False` replaces K7 by the GEGLU in the
compute dtype and `out`'s dynamic per-tensor quantization.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from prompt_diffusion_tpu_torch.ops.attention import _flash_eligible, dot_product_attention
from prompt_diffusion_tpu_torch.ops.flash_attention import (
    flash_attention_packed,
    flash_attention_packed_int8,
)
from prompt_diffusion_tpu_torch.ops.fused_act import fused_geglu_quant
from prompt_diffusion_tpu_torch.ops.fused_group_norm import fused_group_norm_quant, group_norm_auto
from prompt_diffusion_tpu_torch.ops.fused_layer_norm import fused_layer_norm_quant, layer_norm_auto
from prompt_diffusion_tpu_torch.ops.quant import QuantConv, QuantDense
from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding in [cos | sin] order, fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class Dense(nn.Linear):
    """Linear layer that casts its input to the weight dtype first, as a
    Flax Dense with `dtype=` does."""

    def forward(self, x):
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class Conv(nn.Conv2d):
    """Conv2d that casts its input to the weight dtype first."""

    def forward(self, x):
        return self._conv_forward(x.to(self.weight.dtype), self.weight, self.bias)


def _int8(policy: Optional[DTypePolicy]) -> bool:
    return policy is not None and policy.quant == "int8"


def conv3x3(cin: int, cout: int, dtype: torch.dtype, stride: int = 1,
            policy: Optional[DTypePolicy] = None) -> nn.Conv2d:
    """3x3 conv, padding 1; `policy=` with `quant="int8"` makes the site a
    `QuantConv` (same state dict)."""
    if _int8(policy):
        return QuantConv(cin, cout, 3, stride=stride, padding=1, out_dtype=dtype)
    return Conv(cin, cout, 3, stride=stride, padding=1, dtype=dtype)


def conv1x1(cin: int, cout: int, dtype: torch.dtype,
            policy: Optional[DTypePolicy] = None) -> nn.Conv2d:
    if _int8(policy):
        return QuantConv(cin, cout, 1, out_dtype=dtype)
    return Conv(cin, cout, 1, dtype=dtype)


class FusedLayerNorm(nn.Module):
    """LayerNorm with fp32 statistics and fp32 affine; the Triton kernel on
    the card at the sizes `layer_norm_auto` picks. `quant_out=True` returns
    (int8, per-row scale) from K6 instead."""

    def __init__(self, dim: int, eps: float = 1e-5, quant_out: bool = False):
        super().__init__()
        self.eps, self.quant_out = eps, quant_out
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32))

    def forward(self, x):
        if self.quant_out:
            return fused_layer_norm_quant(x, self.weight, self.bias, eps=self.eps)
        return layer_norm_auto(x, self.weight, self.bias, eps=self.eps)


class GroupNorm32(nn.Module):
    """GroupNorm(+SiLU) with fp32 statistics and fp32 affine; the Triton
    kernel on the card at the sizes `group_norm_auto` picks. `quant_out=True`
    returns (int8, per-sample scale) from K5 instead, at every size."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5,
                 apply_silu: bool = False, quant_out: bool = False):
        super().__init__()
        self.num_groups, self.eps, self.apply_silu = num_groups, eps, apply_silu
        self.quant_out = quant_out
        self.weight = nn.Parameter(torch.ones(channels, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=torch.float32))

    def forward(self, x):
        if self.quant_out:
            return fused_group_norm_quant(x, self.weight, self.bias, self.num_groups,
                                          eps=self.eps, apply_silu=self.apply_silu)
        return group_norm_auto(x, self.num_groups, self.weight, self.bias,
                               eps=self.eps, apply_silu=self.apply_silu)


class TimeEmbedMLP(nn.Module):
    """Linear -> SiLU -> Linear."""

    def __init__(self, in_dim: int, embed_dim: int, policy: DTypePolicy):
        super().__init__()
        self.fc1 = Dense(in_dim, embed_dim, dtype=policy.compute_dtype)
        self.fc2 = Dense(embed_dim, embed_dim, dtype=policy.compute_dtype)

    def forward(self, t_emb):
        return self.fc2(F.silu(self.fc1(t_emb)))


class ResBlock(nn.Module):
    """GN -> SiLU -> conv, + time embedding, GN -> SiLU -> conv, residual.
    With `use_scale_shift_norm` the embedding projects to 2 * out_ch
    channels, (scale, shift), applied as GN(h) * (1 + scale) + shift before
    the SiLU; such a block's norms emit no int8 under an int8 policy (its
    convs quantize their float inputs)."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int, policy: DTypePolicy,
                 use_scale_shift_norm: bool = False):
        super().__init__()
        dt = policy.compute_dtype
        q8 = _int8(policy) and not use_scale_shift_norm
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_norm = GroupNorm32(in_ch, apply_silu=True, quant_out=q8)
        self.in_conv = conv3x3(in_ch, out_ch, dt, policy=policy)
        self.emb_proj = Dense(emb_dim, 2 * out_ch if use_scale_shift_norm else out_ch, dtype=dt)
        self.out_norm = GroupNorm32(out_ch, apply_silu=not use_scale_shift_norm, quant_out=q8)
        self.out_conv = conv3x3(out_ch, out_ch, dt, policy=policy)
        self.skip = conv1x1(in_ch, out_ch, dt, policy=policy) if in_ch != out_ch else None

    def forward(self, x, emb):
        h = self.in_conv(self.in_norm(x))
        emb_out = self.emb_proj(F.silu(emb))[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = F.silu(self.out_norm(h) * (1 + scale) + shift)
        else:
            h = self.out_norm(h + emb_out.to(h.dtype))
        h = self.out_conv(h)
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class Downsample(nn.Module):
    """Stride-2 3x3 conv."""

    def __init__(self, in_ch: int, out_ch: int, policy: DTypePolicy):
        super().__init__()
        self.conv = conv3x3(in_ch, out_ch, policy.compute_dtype, stride=2, policy=policy)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest 2x (output pixel i reads input pixel i // 2, as
    `jax.image.resize(method="nearest")` does) + 3x3 conv."""

    def __init__(self, in_ch: int, out_ch: int, policy: DTypePolicy):
        super().__init__()
        self.conv = conv3x3(in_ch, out_ch, policy.compute_dtype, policy=policy)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class ScaledDense(nn.Linear):
    """Bias-free linear layer whose weight is multiplied by a constant at
    call time. The weight stays fp32 so that the product is rounded to the
    compute dtype once, as the JAX package folds the softmax scale into
    `to_q` in fp32 before its bf16 cast."""

    def __init__(self, in_dim: int, out_dim: int, scale: float, policy: DTypePolicy):
        super().__init__(in_dim, out_dim, bias=False, dtype=torch.float32)
        self.scale = scale
        self.compute_dtype = policy.compute_dtype

    def forward(self, x):
        w = (self.weight * self.scale).to(self.compute_dtype)
        return F.linear(x.to(self.compute_dtype), w)


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when `context` is None. In int8
    mode the projections are `QuantDense`s and `x` (and the self-attention
    context) may be a pre-quantized (int8, per-row scale) pair; with
    `int8_attention` set the attention that takes a kernel runs K9
    (int8 Q.K^T) instead of K1. The attribute is read at call time and is
    honoured in int8 mode only."""

    def __init__(self, query_dim: int, context_dim: int, heads: int, dim_head: int,
                 policy: DTypePolicy):
        super().__init__()
        inner = heads * dim_head
        dt = policy.compute_dtype
        self.heads, self.dim_head = heads, dim_head
        self.quant, self.int8_attention = _int8(policy), False
        # softmax scale folded into the query projection; attention runs at scale 1
        scale = dim_head ** -0.5
        if _int8(policy):
            self.to_q = QuantDense(query_dim, inner, bias=False, pre_scale=scale, out_dtype=dt)
            self.to_k = QuantDense(context_dim, inner, bias=False, out_dtype=dt)
            self.to_v = QuantDense(context_dim, inner, bias=False, out_dtype=dt)
            self.to_out = QuantDense(inner, query_dim, out_dtype=dt)
        else:
            self.to_q = ScaledDense(query_dim, inner, scale, policy)
            self.to_k = Dense(context_dim, inner, bias=False, dtype=dt)
            self.to_v = Dense(context_dim, inner, bias=False, dtype=dt)
            self.to_out = Dense(inner, query_dim, dtype=dt)

    def forward(self, x, context: Optional[torch.Tensor] = None):
        context = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(context), self.to_v(context)
        if _flash_eligible(q, k, None):
            attend = (flash_attention_packed_int8 if self.quant and self.int8_attention
                      else flash_attention_packed)
            out = attend(q, k, v, self.heads, scale=1.0)
        else:
            split = lambda t: t.unflatten(-1, (self.heads, self.dim_head))
            out = dot_product_attention(split(q), split(k), split(v), scale=1.0,
                                        use_flash=False)
            out = out.flatten(-2)
        return self.to_out(out)


class GEGLUFeedForward(nn.Module):
    """Linear -> h * gelu_erf(gate) -> Linear. In int8 mode both linears
    are `QuantDense`s and the GEGLU runs in K7, which hands `out` an
    (int8, per-row scale) pair; with `fused_geglu` cleared (read at call
    time) it runs in the compute dtype and `out` quantizes its input per
    tensor."""

    def __init__(self, dim: int, policy: DTypePolicy, mult: int = 4):
        super().__init__()
        inner = dim * mult
        dt = policy.compute_dtype
        self.quant, self.fused_geglu = _int8(policy), True
        if self.quant:
            self.proj = QuantDense(dim, inner * 2, out_dtype=dt)
            self.out = QuantDense(inner, dim, out_dtype=dt)
        else:
            self.proj = Dense(dim, inner * 2, dtype=dt)
            self.out = Dense(inner, dim, dtype=dt)

    def forward(self, x):
        if self.quant and self.fused_geglu:
            return self.out(fused_geglu_quant(self.proj(x)))
        h, gate = self.proj(x).chunk(2, dim=-1)
        return self.out(h * F.gelu(gate))


class BasicTransformerBlock(nn.Module):
    """Self-attention, cross-attention and GEGLU feed-forward, each with a
    pre-LayerNorm and a residual. In int8 mode each pre-LN hands its
    consumers an (int8, per-row scale) pair from K6."""

    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int,
                 policy: DTypePolicy):
        super().__init__()
        q8 = _int8(policy)
        self.norm1 = FusedLayerNorm(dim, quant_out=q8)
        self.attn1 = CrossAttention(dim, dim, heads, dim_head, policy)
        self.norm2 = FusedLayerNorm(dim, quant_out=q8)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head, policy)
        self.norm3 = FusedLayerNorm(dim, quant_out=q8)
        self.ff = GEGLUFeedForward(dim, policy)

    def forward(self, x, context=None):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context=context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GroupNorm, 1x1 projection to tokens, transformer blocks, 1x1
    projection back, residual."""

    def __init__(self, channels: int, context_dim: int, heads: int, dim_head: int,
                 depth: int, policy: DTypePolicy):
        super().__init__()
        inner = heads * dim_head
        dt = policy.compute_dtype
        self.depth = depth
        self.norm = GroupNorm32(channels, eps=1e-6, quant_out=_int8(policy))
        self.proj_in = conv1x1(channels, inner, dt, policy=policy)
        for d in range(depth):
            self.add_module(f"block_{d}", BasicTransformerBlock(
                inner, context_dim, heads, dim_head, policy))
        self.proj_out = conv1x1(inner, channels, dt, policy=policy)

    def forward(self, x, context=None):
        b, _, h, w = x.shape
        residual = x
        x = self.proj_in(self.norm(x))
        inner = x.shape[1]
        x = x.permute(0, 2, 3, 1).reshape(b, h * w, inner)
        for d in range(self.depth):
            x = getattr(self, f"block_{d}")(x, context=context)
        x = x.reshape(b, h, w, inner).permute(0, 3, 1, 2)
        return self.proj_out(x) + residual
