"""Least time of one call from its shapes, by the rule of the port's
`tools/timing.py::roofline`, copied here so the yardstick stays fixed: the
largest of the bytes the call must move (each input read once, each output
written once) over the memory rate, its tensor-core operations over their
dense peak, and its exponentials over the special-function rate. The peaks
are NVIDIA's published H100 SXM figures at the 700 W limit (dense, no
sparsity); ~3.9e12 exponentials/s is 132 SMs x 16 results per clock
(FlashAttention-3, Shah et al. 2024, section 1)."""

from __future__ import annotations

from math import prod

HBM_BYTES_S, BF16_OPS_S, INT8_OPS_S, EXP_S = 3.35e12, 989e12, 1979e12, 3.9e12
OUT_BYTES = 2  # the int8 layers dequantize into bf16


def roofline_s(nbytes: float = 0.0, int8_ops: float = 0.0, bf16_ops: float = 0.0,
               exps: float = 0.0) -> float:
    return max(nbytes / HBM_BYTES_S, int8_ops / INT8_OPS_S + bf16_ops / BF16_OPS_S,
               exps / EXP_S)


def int8_dense_s(in_shape, out_features: int, act_bytes: int) -> float:
    """An int8 dense layer: activation (..., K) at `act_bytes` an element
    (1 for int8 codes handed over by a kernel, the float's size for an
    input the layer quantizes), weight codes (N, K), bf16 output (..., N)."""
    m, k = prod(in_shape[:-1]), in_shape[-1]
    ops = 2.0 * m * k * out_features
    nbytes = m * k * act_bytes + out_features * k + m * out_features * OUT_BYTES
    return roofline_s(nbytes, int8_ops=ops)


def int8_conv_s(in_shape, out_channels: int, kernel: int, stride: int, padding: int,
                act_bytes: int) -> float:
    """An int8 convolution over an NCHW input, as `int8_dense_s` counts."""
    b, cin, h, w = in_shape
    ho = (h + 2 * padding - kernel) // stride + 1
    wo = (w + 2 * padding - kernel) // stride + 1
    ops = 2.0 * b * ho * wo * out_channels * cin * kernel * kernel
    nbytes = (b * cin * h * w * act_bytes + out_channels * cin * kernel * kernel
              + b * ho * wo * out_channels * OUT_BYTES)
    return roofline_s(nbytes, int8_ops=ops)


def attention_s(b: int, nq: int, nk: int, heads: int, d: int, elem_bytes: int = 2) -> float:
    """Exact attention of (B, Nq, H, D) queries over Nk keys and values:
    Q.K^T and P.V at the bf16 rate, one exponential a logit, q, k, v read
    and the output written once. Any kernel that computes it is charged
    this work."""
    ops = 4.0 * b * heads * nq * nk * d
    nbytes = (2 * nq + 2 * nk) * b * heads * d * elem_bytes
    return roofline_s(nbytes, bf16_ops=ops, exps=float(b * heads * nq * nk))


def least_s(work: dict) -> float:
    """A whole request's least time: its int8 and bf16 operations at their
    peaks (`mfu`'s numerator)."""
    return work["int8_ops"] / INT8_OPS_S + work["bf16_ops"] / BF16_OPS_S
