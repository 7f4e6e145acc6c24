"""Triton kernels of the LayerNorm port (K4) and of K3's parent design.

This module imports `triton` at its top, so only the launcher in
`fused_layer_norm.py` and `tools/quant_tune.py` import it, inside the
function that launches, on the card. The three GroupNorm programs (stats,
combine, apply; C-contiguous (B, HW, C) memory, an NCHW tensor in
channels_last) are K3's design before `csrc/gn_quant.cu::gn_float_kernel`
took its place; no wrapper launches them, only `quant_tune --part time`
(K3's and K5's parents).
"""

import triton
import triton.language as tl


@triton.jit
def gn_stats_kernel(x_ptr, mean_ptr, m2_ptr, HW, C, RB,
                    ROWS: tl.constexpr, BLOCK_C: tl.constexpr):
    """Per (sample, row block, channel): the block's mean and its sum of
    squared deviations from that mean (shifted sums, fp32)."""
    b = tl.program_id(0)
    rb = tl.program_id(1)
    cb = tl.program_id(2)
    rows = rb * ROWS + tl.arange(0, ROWS)
    cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    mask = (rows < HW)[:, None] & cmask[None, :]
    offs = b.to(tl.int64) * HW * C + rows.to(tl.int64)[:, None] * C + cols[None, :]
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    n = tl.minimum(HW - rb * ROWS, ROWS).to(tl.float32)
    mean = tl.sum(x, axis=0) / n
    dev = tl.where(mask, x - mean[None, :], 0.0)
    m2 = tl.sum(dev * dev, axis=0)
    out = (b * RB + rb).to(tl.int64) * C + cols
    tl.store(mean_ptr + out, mean, mask=cmask)
    tl.store(m2_ptr + out, m2, mask=cmask)


@triton.jit
def gn_combine_kernel(mean_ptr, m2_ptr, gamma_ptr, beta_ptr, scale_ptr, shift_ptr,
                      HW, C, RB, CG, eps,
                      ROWS: tl.constexpr, BLOCK_R: tl.constexpr, BLOCK_CG: tl.constexpr):
    """Per (sample, group): merges the row blocks' partials (Chan's
    parallel formula) into the group mean and variance, then folds them
    with the affine into one per-channel scale and shift."""
    b = tl.program_id(0)
    g = tl.program_id(1)
    j = tl.arange(0, BLOCK_CG)
    cmask = j < CG
    cols = g * CG + j
    count = HW * CG * 1.0  # a scalar argument of 1 arrives as a constant

    acc = tl.zeros([BLOCK_R, BLOCK_CG], dtype=tl.float32)
    for r0 in range(0, RB, BLOCK_R):
        rbs = r0 + tl.arange(0, BLOCK_R)
        mask = (rbs < RB)[:, None] & cmask[None, :]
        n = tl.minimum(HW - rbs * ROWS, ROWS).to(tl.float32)
        offs = (b * RB + rbs).to(tl.int64)[:, None] * C + cols[None, :]
        mu = tl.load(mean_ptr + offs, mask=mask, other=0.0)
        acc += tl.where(mask, n[:, None] * mu, 0.0)
    mean = tl.sum(tl.sum(acc, axis=1), axis=0) / count

    acc = tl.zeros([BLOCK_R, BLOCK_CG], dtype=tl.float32)
    for r0 in range(0, RB, BLOCK_R):
        rbs = r0 + tl.arange(0, BLOCK_R)
        mask = (rbs < RB)[:, None] & cmask[None, :]
        n = tl.minimum(HW - rbs * ROWS, ROWS).to(tl.float32)
        offs = (b * RB + rbs).to(tl.int64)[:, None] * C + cols[None, :]
        mu = tl.load(mean_ptr + offs, mask=mask, other=0.0)
        m2 = tl.load(m2_ptr + offs, mask=mask, other=0.0)
        dm = mu - mean
        acc += tl.where(mask, m2 + n[:, None] * dm * dm, 0.0)
    var = tl.sum(tl.sum(acc, axis=1), axis=0) / count

    rstd = 1.0 / tl.sqrt(var + eps)
    gamma = tl.load(gamma_ptr + cols, mask=cmask, other=0.0)
    beta = tl.load(beta_ptr + cols, mask=cmask, other=0.0)
    sc = gamma * rstd
    tl.store(scale_ptr + b * C + cols, sc, mask=cmask)
    tl.store(shift_ptr + b * C + cols, beta - mean * sc, mask=cmask)


@triton.jit
def gn_apply_kernel(x_ptr, y_ptr, scale_ptr, shift_ptr, HW, C,
                    ROWS: tl.constexpr, BLOCK_C: tl.constexpr, APPLY_SILU: tl.constexpr,
                    APPLY_RELU: tl.constexpr):
    """y = x * scale[b, c] + shift[b, c] in fp32, then SiLU or ReLU (SiLU
    when both are set), stored in the activation dtype."""
    b = tl.program_id(0)
    rb = tl.program_id(1)
    cb = tl.program_id(2)
    rows = rb * ROWS + tl.arange(0, ROWS)
    cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    mask = (rows < HW)[:, None] & cmask[None, :]
    offs = b.to(tl.int64) * HW * C + rows.to(tl.int64)[:, None] * C + cols[None, :]
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    sc = tl.load(scale_ptr + b * C + cols, mask=cmask, other=0.0)
    sh = tl.load(shift_ptr + b * C + cols, mask=cmask, other=0.0)
    y = x * sc[None, :] + sh[None, :]
    if APPLY_SILU:
        y = y * tl.sigmoid(y)
    elif APPLY_RELU:
        y = tl.maximum(y, 0.0)
    tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)


@triton.jit
def ln_kernel(x_ptr, y_ptr, w_ptr, b_ptr, N, C, eps,
              BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
    """LayerNorm of BLOCK_R rows of an (N, C) matrix: fp32 mean, fp32
    variance of the deviations, fp32 affine, stored in the input dtype."""
    pid = tl.program_id(0)
    rows = pid * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < C
    mask = (rows < N)[:, None] & cmask[None, :]
    offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=1) / C
    dev = tl.where(mask, x - mean[:, None], 0.0)
    var = tl.sum(dev * dev, axis=1) / C
    rstd = 1.0 / tl.sqrt(var + eps)
    w = tl.load(w_ptr + cols, mask=cmask, other=0.0)
    bias = tl.load(b_ptr + cols, mask=cmask, other=0.0)
    y = dev * rstd[:, None] * w[None, :] + bias[None, :]
    tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)
