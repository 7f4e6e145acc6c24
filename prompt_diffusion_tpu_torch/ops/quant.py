"""int8 W8A8 building blocks of the serving mode.

Counterpart of `prompt_diffusion_tpu/ops/quant.py`:
  * weights: symmetric int8 per output channel, quantized from the fp32
    parameters (scale max(amax / 127, 1e-8), codes round(w / scale) with
    ties to even, clipped to +-127). The state dict is that of `Dense` /
    `Conv` with fp32 values. The quantization is loop-invariant: each
    module quantizes once and reuses the result until its weight changes
    (`load_state_dict`, `random_init_`, a move to another device);
  * activations: a float tensor is quantized here, dynamically, with one
    scale over the whole tensor (inside a call whose batch is split over
    ranks, `parallel.mesh.sharded_batch`, the amax is all-reduced with MAX
    over them first, so the scale is the unsharded call's and spans the
    whole batch as the JAX package's does); a `(int8, scale)` pair from a kernel's
    int8 epilogue (per sample from GroupNorm, per row from LayerNorm and
    GEGLU) is taken as it is;
  * the product is int8 x int8 -> int32 (`int8_matmul`, or the K8 kernel
    for a 3x3 stride-1 conv), dequantized as
    f32(acc) * (s_a * s_w) + bias with the product s_a * s_w formed first,
    then cast to the output dtype.
Inference only.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

from prompt_diffusion_tpu_torch.ops.int8_conv import VARIANTS, conv3x3_int8, im2col3x3, int8_matmul
from prompt_diffusion_tpu_torch.parallel.mesh import batch_shard

_EPS = 1e-8

Activation = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def quant_weight(w: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 weight -> (int8 weight, fp32 scale reduced over `dims`, kept)."""
    s_w = torch.clamp_min(w.abs().amax(dim=dims, keepdim=True) / 127.0, _EPS)
    return torch.clamp(torch.round(w / s_w), -127, 127).to(torch.int8), s_w


def quant_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Activation -> (int8 tensor, 0-d fp32 scale), one scale per tensor;
    inside `sharded_batch` the amax is the MAX over the group's ranks (one
    all-reduce, counted in `quant_act.all_reduces`)."""
    xf = x.float()
    amax = xf.abs().amax()
    shard = batch_shard()
    if shard is not None:
        dist.all_reduce(amax.view(1), op=dist.ReduceOp.MAX, group=shard.group)
        quant_act.all_reduces += 1
    s_a = torch.clamp_min(amax / 127.0, _EPS)
    return torch.clamp(torch.round(xf / s_a), -127, 127).to(torch.int8), s_a


quant_act.all_reduces = 0


def quant_act_pair(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize an activation once for several consumers (the pair is
    passed to each instead of the float tensor)."""
    return quant_act(x)


def _dequant(acc, scale, bias, out_dtype):
    out = acc.float() * scale
    if bias is not None:
        out = out + bias
    return out.to(out_dtype)


class _QuantizedWeight:
    """Caches (int8 weight, fp32 scale per output channel) of `self.weight`,
    keyed by the weight's storage and version counter: any in-place write
    (`copy_`, `fill_`, a state-dict load) or a new storage quantizes anew."""

    _cache = None

    def _quantize(self):
        raise NotImplementedError

    def quantized(self):
        w = self.weight
        key = (w.data_ptr(), w._version, w.device)
        if self._cache is None or self._cache[0] != key:
            with torch.no_grad():
                self._cache = (key, *self._quantize())
        return self._cache[1:]


class QuantDense(_QuantizedWeight, nn.Linear):
    """int8 W8A8 dense layer; the state dict of `Dense` (fp32 weight
    (out, in), optional bias). `pre_scale` multiplies the fp32 weight
    before it is quantized (the softmax scale folded into `to_q`)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 pre_scale: float = 1.0, out_dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_features, out_features, bias=bias, dtype=torch.float32)
        self.pre_scale, self.out_dtype = pre_scale, out_dtype

    def _quantize(self):
        w = self.weight if self.pre_scale == 1.0 else self.weight * self.pre_scale
        wq, s_w = quant_weight(w, dims=1)
        return wq, s_w.view(-1)

    def forward(self, x: Activation) -> torch.Tensor:
        """`x` is a float tensor or an (int8, scale) pair whose scale
        broadcasts against (..., N, 1): a 0-d one or one per row."""
        xq, s_a = x if isinstance(x, tuple) else quant_act(x)
        wq, s_w = self.quantized()
        acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), wq)
        return _dequant(acc.view(*xq.shape[:-1], -1), s_a * s_w, self.bias, self.out_dtype)


class QuantConv(_QuantizedWeight, nn.Conv2d):
    """int8 W8A8 convolution; the state dict of `Conv` (fp32 OIHW weight,
    bias). Takes NCHW activations (channels_last memory), returns NCHW in
    channels_last memory. Serves the 1x1 conv (the int8 GEMM over pixels),
    the 3x3 stride-1 conv (K8) and the 3x3 stride-2 conv (int8 im2col +
    the GEMM), each with padding 1 for 3x3, as the SD1.5 models use them.
    `conv_variant` picks K8's variant for the 3x3 stride-1 conv ("im2col"
    or "xshift"; the same bits)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 out_dtype: torch.dtype = torch.bfloat16, conv_variant: str = "im2col"):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=bias, dtype=torch.float32)
        form = (self.kernel_size, self.stride, self.padding)
        if form not in (((1, 1), (1, 1), (0, 0)), ((3, 3), (1, 1), (1, 1)),
                        ((3, 3), (2, 2), (1, 1))):
            raise ValueError(f"QuantConv has no int8 path for kernel/stride/padding {form}")
        if conv_variant not in VARIANTS:
            raise ValueError(f"unknown conv_variant {conv_variant!r}; one of {VARIANTS}")
        self.out_dtype, self.conv_variant = out_dtype, conv_variant

    def _quantize(self):
        # (Cout, kh, kw, Cin): the order of the NHWC im2col columns
        wq, s_w = quant_weight(self.weight.permute(0, 2, 3, 1), dims=(1, 2, 3))
        return wq.contiguous(), s_w.view(-1)

    def forward(self, x: Activation) -> torch.Tensor:
        """`x` is a float tensor or an (int8, per-sample (B,) scale) pair."""
        if isinstance(x, tuple):
            xq, s_a = x
            s_a = s_a.reshape(-1, 1, 1, 1)
        else:
            xq, s_a = quant_act(x)
        xh = xq.permute(0, 2, 3, 1)  # NHWC; a view of channels_last memory
        b, h, w, cin = xh.shape
        wq, s_w = self.quantized()
        cout = wq.shape[0]
        if self.kernel_size == (1, 1):
            acc = int8_matmul(xh.reshape(-1, cin), wq.view(cout, cin)).view(b, h, w, cout)
        elif self.stride == (1, 1):
            s_vec = s_a.reshape(-1).expand(b).contiguous()
            y = conv3x3_int8(xh.contiguous(), s_vec, wq, s_w, self.bias, self.out_dtype,
                             self.conv_variant)
            return y.permute(0, 3, 1, 2)
        else:
            ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
            acc = int8_matmul(im2col3x3(xh, 2), wq.view(cout, 9 * cin)).view(b, ho, wo, cout)
        return _dequant(acc, s_a * s_w, self.bias, self.out_dtype).permute(0, 3, 1, 2)
