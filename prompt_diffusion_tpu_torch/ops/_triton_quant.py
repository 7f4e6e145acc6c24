"""Triton programs: the parent designs of kernels that are now CUDA C++.
K10 (tanh-GELU->int8), K13 (AdaLN->int8), K12 (AdaLN), K7
(GEGLU->int8), K6 (LayerNorm->int8) and K11 (row->int8) are in
`csrc/row_quant.cu`, K5 (GroupNorm->int8) in `csrc/gn_quant.cu`; their
former Triton programs stay here only as the parent designs that
`tools/quant_tune.py --part time` launches beside the CUDA kernels:
`act_quant_kernel` (GELU=True: K10; GELU=False: K11), `adaln_kernel`
(QUANT=True: K13; QUANT=False: K12), `geglu_quant_kernel` (K7),
`ln_quant_kernel` (K6), and `gn_amax_kernel` with `gn_quant_kernel` (K5,
after K3's stats and combine programs). No wrapper routes to them.

This module imports `triton` at its top, so only `tools/quant_tune.py`
imports it, inside the function that launches, on the card.

Every quantize step follows `quant.py` of the JAX package: the fp32 value
is divided by its scale with an IEEE-rounded division (`div_rn`: Triton's
`/` on fp32 is the approximate `div.full.f32`), rounded half to even
(`rint`), clipped to [-127, 127]; the scale is max(amax / 127, 1e-8), also
with `div_rn`.
"""

import triton
import triton.language as tl

try:
    from triton.language.extra import libdevice
except ImportError:  # older layout
    from triton.language.extra.cuda import libdevice


@triton.jit
def _quantize(y, s):
    """fp32 y / s -> int8 codes (round half to even, clip to +-127)."""
    q = libdevice.rint(libdevice.div_rn(y, s))
    return tl.minimum(tl.maximum(q, -127.0), 127.0).to(tl.int8)


@triton.jit
def _scale(amax):
    return tl.maximum(libdevice.div_rn(amax, 127.0), 1e-8)


@triton.jit
def _rowquant(y, mask):
    """Per-row int8 of a (rows, cols) fp32 block; masked entries count as 0."""
    y = tl.where(mask, y, 0.0)
    s = _scale(tl.max(tl.abs(y), axis=1))
    return _quantize(y, s[:, None]), s


# ---- K5's parent design (timed by tools/quant_tune.py only) -------------
# GroupNorm(+SiLU) -> int8 with one scale per sample. The statistics come from K3's stats and combine programs
# (`_triton_norms.gn_stats_kernel`, `gn_combine_kernel`), which leave a
# per-(sample, channel) scale and shift. The sample's amax is a reduction
# over the whole sample, across programs: `gn_amax_kernel` takes each
# tile's max and folds it into one slot per sample with an atomic max on
# the fp32 bits (non-negative floats order as their int32 bits, so the
# result does not depend on the order); `gn_quant_kernel` then recomputes
# the normalised value with the same helper, so the max and the codes see
# the same fp32 numbers, and writes the codes.


@triton.jit
def _gn_value(x_ptr, sc_ptr, sh_ptr, b, rb, cb, HW, C,
              ROWS: tl.constexpr, BLOCK_C: tl.constexpr, APPLY_SILU: tl.constexpr):
    rows = rb * ROWS + tl.arange(0, ROWS)
    cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    mask = (rows < HW)[:, None] & cmask[None, :]
    offs = b.to(tl.int64) * HW * C + rows.to(tl.int64)[:, None] * C + cols[None, :]
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    sc = tl.load(sc_ptr + b * C + cols, mask=cmask, other=0.0)
    sh = tl.load(sh_ptr + b * C + cols, mask=cmask, other=0.0)
    y = x * sc[None, :] + sh[None, :]
    if APPLY_SILU:
        y = y * tl.sigmoid(y)
    return y, mask, offs


@triton.jit
def gn_amax_kernel(x_ptr, sc_ptr, sh_ptr, amax_ptr, HW, C,
                   ROWS: tl.constexpr, BLOCK_C: tl.constexpr, APPLY_SILU: tl.constexpr):
    b = tl.program_id(0)
    y, mask, _ = _gn_value(x_ptr, sc_ptr, sh_ptr, b, tl.program_id(1), tl.program_id(2),
                           HW, C, ROWS, BLOCK_C, APPLY_SILU)
    m = tl.max(tl.max(tl.where(mask, tl.abs(y), 0.0), axis=1), axis=0)
    tl.atomic_max(amax_ptr + b, m.to(tl.int32, bitcast=True))


@triton.jit
def gn_quant_kernel(x_ptr, sc_ptr, sh_ptr, amax_ptr, q_ptr, s_ptr, HW, C,
                    ROWS: tl.constexpr, BLOCK_C: tl.constexpr, APPLY_SILU: tl.constexpr):
    b = tl.program_id(0)
    rb = tl.program_id(1)
    cb = tl.program_id(2)
    s = _scale(tl.load(amax_ptr + b).to(tl.float32, bitcast=True))
    y, mask, offs = _gn_value(x_ptr, sc_ptr, sh_ptr, b, rb, cb, HW, C, ROWS, BLOCK_C,
                              APPLY_SILU)
    tl.store(q_ptr + offs, _quantize(y, s), mask=mask)
    tl.store(s_ptr + b, s, mask=(rb == 0) & (cb == 0))


# ---- K6's parent design (timed by tools/quant_tune.py only) -------------
# LayerNorm -> int8 with one scale per row


@triton.jit
def ln_quant_kernel(x_ptr, q_ptr, s_ptr, w_ptr, b_ptr, N, C, eps,
                    BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
    """LayerNorm of BLOCK_R whole rows in registers (as K4), then the
    row's int8 codes and scale."""
    pid = tl.program_id(0)
    rows = pid * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < C
    rmask = rows < N
    mask = rmask[:, None] & cmask[None, :]
    offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=1) / C
    dev = tl.where(mask, x - mean[:, None], 0.0)
    var = tl.sum(dev * dev, axis=1) / C
    rstd = 1.0 / tl.sqrt(var + eps)
    w = tl.load(w_ptr + cols, mask=cmask, other=0.0)
    bias = tl.load(b_ptr + cols, mask=cmask, other=0.0)
    q, s = _rowquant(dev * rstd[:, None] * w[None, :] + bias[None, :], mask)
    tl.store(q_ptr + offs, q, mask=mask)
    tl.store(s_ptr + rows, s, mask=rmask)


# ---- K7's parent design (timed by tools/quant_tune.py only) -------------
# GEGLU -> int8 with one scale per row


@triton.jit
def geglu_quant_kernel(x_ptr, q_ptr, s_ptr, N, I,
                       BLOCK_R: tl.constexpr, BLOCK_I: tl.constexpr):
    """Rows of [h | gate] (2I wide) -> h * gelu_erf(gate), then the row's
    int8 codes (I wide) and scale. Exact-erf GELU, as the reference."""
    pid = tl.program_id(0)
    rows = pid * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = tl.arange(0, BLOCK_I)
    rmask = rows < N
    mask = rmask[:, None] & (cols < I)[None, :]
    src = rows.to(tl.int64)[:, None] * (2 * I) + cols[None, :]
    h = tl.load(x_ptr + src, mask=mask, other=0.0).to(tl.float32)
    gate = tl.load(x_ptr + src + I, mask=mask, other=0.0).to(tl.float32)
    g = 0.5 * gate * (1.0 + libdevice.erf(gate * 0.7071067811865476))
    q, s = _rowquant(h * g, mask)
    tl.store(q_ptr + rows.to(tl.int64)[:, None] * I + cols[None, :], q, mask=mask)
    tl.store(s_ptr + rows, s, mask=rmask)


# ---- K11's and K10's parent design (timed by tools/quant_tune.py only) --
# row -> int8, one scale per row


@triton.jit
def act_quant_kernel(x_ptr, q_ptr, s_ptr, N, C,
                     BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr, GELU: tl.constexpr):
    """BLOCK_R whole rows: optionally x * 0.5 * (1 + tanh(sqrt(2/pi) *
    (x + 0.044715 x^3))) (`jax.nn.gelu(approximate=True)`), then the row's
    int8 codes and scale: GELU=False is K11's parent design, GELU=True
    K10's, both launched only by `tools/quant_tune.py`."""
    pid = tl.program_id(0)
    rows = pid * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = tl.arange(0, BLOCK_C)
    rmask = rows < N
    mask = rmask[:, None] & (cols < C)[None, :]
    offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    if GELU:
        inner = 0.7978845608028654 * (x + 0.044715 * (x * x * x))
        x = x * (0.5 * (1.0 + libdevice.tanh(inner)))
    q, s = _rowquant(x, mask)
    tl.store(q_ptr + offs, q, mask=mask)
    tl.store(s_ptr + rows, s, mask=rmask)


# ---- K12's and K13's parent design: AdaLN (LayerNorm without affine,
# per-sample modulation), -> int8 with QUANT


@triton.jit
def adaln_kernel(x_ptr, sc_ptr, sh_ptr, q_ptr, s_ptr, R, N, C, eps,
                 BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr, QUANT: tl.constexpr):
    """BLOCK_R whole rows of the (B*N, C) activation: fp32 LayerNorm
    statistics, (x - mean) * rsqrt(var + eps) * (1 + scale[b]) + shift[b]
    with b = row // N; with QUANT the row's int8 codes and scale (`q_ptr`,
    `s_ptr`), else the value in `q_ptr`'s dtype (`s_ptr` unused): K13's and
    K12's parent design, launched only by `tools/quant_tune.py`."""
    pid = tl.program_id(0)
    rows = pid * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = tl.arange(0, BLOCK_C)
    rmask = rows < R
    mask = rmask[:, None] & (cols < C)[None, :]
    offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    cf = C.to(tl.float32)
    mean = libdevice.div_rn(tl.sum(x, axis=1), cf)
    dev = tl.where(mask, x - mean[:, None], 0.0)
    var = libdevice.div_rn(tl.sum(dev * dev, axis=1), cf)
    h = dev * libdevice.rsqrt(var + eps)[:, None]
    mod = (rows // N).to(tl.int64)[:, None] * C + cols[None, :]
    sc = tl.load(sc_ptr + mod, mask=mask, other=0.0)
    sh = tl.load(sh_ptr + mod, mask=mask, other=0.0)
    y = h * (1.0 + sc) + sh
    if QUANT:
        q, s = _rowquant(y, mask)
        tl.store(q_ptr + offs, q, mask=mask)
        tl.store(s_ptr + rows, s, mask=rmask)
    else:
        tl.store(q_ptr + offs, y.to(q_ptr.dtype.element_ty), mask=mask)
