"""Plain fp32 building blocks of the reference models, with the port's int8
W8A8 arithmetic worked out again where a cell asks for it.

Every tensor here is fp32, and no matrix product may run in TF32
(`run.py` and the tests turn it off). A `Mode` says how each linear or
convolution computes:

* `site_bits`: the bits of the sites that the port quantizes under its
  int8 policy (`QuantDense`, `QuantConv`, the int8 attention's Q and K),
  or None where they run in float;
* `round_bf16`: whether the sampler update rounds its operands to bf16
  (the control's stand-in for fp32 arithmetic);
* `fp8`: whether every linear and convolution rounds its weight, its
  input and its output to fp8 (e4m3, one scale a tensor), the control of
  what the configuration runs in bf16.

A quantized site takes symmetric integer codes of its weight, one scale
per output channel, and of its input, with the input's scale set by what
produced it: one per tensor for a float input (the port's `quant_act`),
one per sample after a GroupNorm, one per row after a LayerNorm, AdaLN,
GEGLU, GELU or the attention output (the port's K5, K6, K7, K10, K11 and
K13 epilogues). Such a producer returns a `Quantized` value, the codes
times their scales; a float input is quantized at the site. Scale
max(amax / qmax, 1e-8), codes round(x / scale) with ties to even, clipped
to +-qmax, qmax = 2^(bits-1) - 1. The products of codes and scales are
formed in fp32, so they differ from the port's int32 sums only by fp32
rounding.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class Mode:
    site_bits: Optional[int] = None
    round_bf16: bool = False
    fp8: bool = False


FLOAT = Mode()


class Quantized:
    """A fake-quantized activation: `value` (fp32) is codes times scale."""

    def __init__(self, value: torch.Tensor):
        self.value = value


def fake_quant(x: torch.Tensor, bits: int, dims) -> torch.Tensor:
    """Symmetric fake quantization of fp32 `x` with one scale per slice
    reduced over `dims` (None: the whole tensor)."""
    qmax = float(2 ** (bits - 1) - 1)
    a = x.abs()
    amax = a.amax() if dims is None else a.amax(dim=dims, keepdim=True)
    s = torch.clamp_min(amax / qmax, EPS)
    return torch.clamp(torch.round(x / s), -qmax, qmax) * s


def quant_rows(x: torch.Tensor, bits: Optional[int]):
    """The per-row epilogue of K6, K7, K10, K11 and K13, or `x` itself."""
    return x if bits is None else Quantized(fake_quant(x, bits, -1))


def quant_samples(x: torch.Tensor, bits: Optional[int]):
    """The per-sample epilogue of K5 over an NCHW tensor, or `x` itself."""
    return x if bits is None else Quantized(fake_quant(x, bits, (1, 2, 3)))


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to e4m3 with one scale for the tensor (its amax maps to
    e4m3's largest value, 448, as scaled fp8 inference takes it), and back."""
    s = torch.clamp_min(x.abs().amax() / 448.0, 1e-30)
    return (x / s).to(torch.float8_e4m3fn).float() * s


def as_float(x, bits: Optional[int]) -> torch.Tensor:
    """The input a site multiplies: a `Quantized` value as it is, a float
    tensor quantized per tensor when the site has bits."""
    if isinstance(x, Quantized):
        return x.value
    return x if bits is None else fake_quant(x, bits, None)


class Linear(nn.Module):
    """y = x W^T + b, fp32. `site` marks a `QuantDense` of the port;
    `pre_scale` multiplies the weight before it is quantized (the softmax
    scale folded into `to_q`)."""

    def __init__(self, cin: int, cout: int, bias: bool = True, site: bool = False,
                 pre_scale: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.site, self.pre_scale = site, pre_scale
        self.mode = FLOAT

    def bits(self):
        return self.mode.site_bits if self.site else None

    def forward(self, x):
        bits = self.bits()
        w = self.weight if self.pre_scale == 1.0 else self.weight * self.pre_scale
        if bits is not None:
            w = fake_quant(w, bits, 1)
        if self.mode.fp8:
            return to_fp8(F.linear(to_fp8(as_float(x, bits)), to_fp8(w), self.bias))
        return F.linear(as_float(x, bits), w, self.bias)


class Conv(nn.Module):
    """fp32 convolution over NCHW; `site` marks a `QuantConv` of the port."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
                 bias: bool = True, site: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride, self.padding, self.site = stride, padding, site
        self.mode = FLOAT

    def bits(self):
        return self.mode.site_bits if self.site else None

    def forward(self, x):
        bits = self.bits()
        w = self.weight if bits is None else fake_quant(self.weight, bits, (1, 2, 3))
        if self.mode.fp8:
            return to_fp8(F.conv2d(to_fp8(as_float(x, bits)), to_fp8(w), self.bias,
                                   self.stride, self.padding))
        return F.conv2d(as_float(x, bits), w, self.bias, self.stride, self.padding)


def set_mode(model: nn.Module, mode: Mode) -> nn.Module:
    """Sets `mode` on every module of `model` that has one."""
    for m in model.modules():
        if hasattr(m, "mode"):
            m.mode = mode
    return model


class GroupNorm(nn.Module):
    """GroupNorm(+SiLU) with an fp32 affine; `quant_out` marks the port's
    K5 site (codes per sample under the site bits)."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5,
                 silu: bool = False, quant_out: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.groups, self.eps, self.silu, self.quant_out = groups, eps, silu, quant_out
        self.mode = FLOAT

    def forward(self, x):
        b, c = x.shape[:2]
        g = x.reshape(b, self.groups, -1)
        mean = g.mean(dim=-1, keepdim=True)
        var = (g - mean).square().mean(dim=-1, keepdim=True)
        y = ((g - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        shape = (1, c) + (1,) * (x.ndim - 2)
        y = y * self.weight.reshape(shape) + self.bias.reshape(shape)
        if self.silu:
            y = y * torch.sigmoid(y)
        return quant_samples(y, self.mode.site_bits) if self.quant_out else y


def layer_norm(x, weight=None, bias=None, eps: float = 1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


class LayerNorm(nn.Module):
    """LayerNorm with an fp32 affine; `quant_out` marks the port's K6 site."""

    def __init__(self, dim: int, eps: float = 1e-5, quant_out: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))
        self.eps, self.quant_out = eps, quant_out
        self.mode = FLOAT

    def forward(self, x):
        y = layer_norm(x, self.weight, self.bias, self.eps)
        return quant_rows(y, self.mode.site_bits) if self.quant_out else y


# query rows per block of the attention: (B, H, rows, Nk) fp32 logits stay
# near this many elements, so the reference fits beside the card's program
ATTN_BLOCK_ELEMS = 1 << 28


def attention(q, k, v, scale: float, mask=None):
    """Exact attention over (B, N, H, D) fp32 tensors in blocks of query
    rows, softmax in fp32."""
    b, nq, h, d = q.shape
    nk = k.shape[1]
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    rows = max(1, ATTN_BLOCK_ELEMS // max(1, b * h * nk))
    out = []
    for r0 in range(0, nq, rows):
        logits = torch.matmul(qh[:, :, r0:r0 + rows], kh.transpose(-1, -2)) * scale
        if mask is not None:
            logits = logits.masked_fill(~mask[..., r0:r0 + rows, :],
                                        torch.finfo(torch.float32).min)
        out.append(torch.matmul(torch.softmax(logits, dim=-1), vh))
    return torch.cat(out, dim=2).permute(0, 2, 1, 3)


def int8_attention(q, k, v, heads: int, bits: int, scale: float):
    """The port's K9 over packed (B, N, H*D) fp32 tensors at `bits`: K
    with one scale per (batch, head), Q one per (row, head), the logits
    from the codes times both scales and `scale`, exact softmax, P.V in
    fp32."""
    b, nq, hd = q.shape
    d = hd // heads
    kf = k.view(b, -1, heads, d)
    qf = q.view(b, nq, heads, d)
    kq = fake_quant(kf, bits, (1, 3))
    qq = fake_quant(qf, bits, -1)
    return attention(qq, kq, v.view(b, -1, heads, d), scale).reshape(b, nq, hd)


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000):
    """Sinusoidal embedding in [cos | sin] order, fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref|| over fp32 (float64 sums)."""
    got, ref = got.double(), ref.double()
    return float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref).clamp_min(1e-30))
