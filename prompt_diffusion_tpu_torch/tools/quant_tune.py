"""The int8 epilogue kernels in CUDA C++ on the card: K10, K13, K7, K6 and
K11 (the row -> int8 kernels of `ops/csrc/row_quant.cu`) and K5 (GroupNorm
-> int8, `ops/csrc/gn_quant.cu`); and K3 (GroupNorm(+SiLU or ReLU), the
same source), K9p (K9's per-head K quantization, `ops/csrc/
int8_attention.cu`) and K12 (AdaLN in x's dtype, `row_quant.cu`) with its
backward (K12b).

    python3 -m prompt_diffusion_tpu_torch.tools.quant_tune
        [--part sass|check|time|phases]
        [--kernels K10,K13,K7,K5,K6,K11,K3,K9p,K12,K12b] [--iters N]

  sass   nvcc -cubin of `row_quant.cu` as built and of a copy whose K10
         takes CUDA's tanhf (TANHF): ptxas's registers and spills of every
         instantiation the SD3 shapes take, and, from `cuobjdump -sass`,
         SASS instructions and MUFU operations per value (the difference
         between two instantiations that differ only in the vectors per
         thread, over the values they differ by) and per thread and row
         group (static, slow paths included); from the per-value counts a
         compute bound at the SD3 shapes (a lower bound: the per-row work
         is left out), beside the byte bound; the same for K7 (its
         per-value count from 2 and 4 vectors per thread of h and gate, at
         the SD1.5 shapes), K6 (from 2 and 5 vectors, at the SD1.5 and
         ViT-B shapes) and K11 (3 and 6, at the SD3 attention slices), and
         ptxas's registers and spills of K5's instantiations; K3's
         (`gn_float_kernel`), with SASS instructions and MUFU operations per
         value (its K = 8 and K = 4 instantiations differ by 4 pixels of 8
         values in every pass that holds a chunk; fp32's K = 4 and K = 2 by
         2), and K9p's (`k_head_quant_kernel`); K12's forward
         (`adaln_float_kernel`) and backward (`adaln_bwd_kernel`):
         registers and spills of every instantiation, and SASS
         instructions and MUFU operations per value (forward: 3 and 6
         vectors per thread; backward: 1 and 3, of x and of g);
  check  the quotient of `rq::quotient` (y * 1/s with one FMA correction)
         against `__fdiv_rn(y, s)` bit for bit: over every value of the SD3
         K10 and K13 cases (K10's y from the kernel's own GELU, K13's from
         the plain fp32 version, each row's s from the kernel) and over
         every float y in [s/4, 128 s] for SWEEP_SCALES values of s; then
         both kernels against their plain versions (chip_smoke.py's bounds:
         scales within 1e-6 relative, codes at most 1 apart and >= 99.9%
         equal) at the SD3 shapes, at every plan `time` sweeps, in fp32, at
         other widths (warp rows, rows of several warps, ragged vectors and
         rows, 32 KB rows) and with strided modulation; one device launch
         per call; two runs bit-equal. K7 and K5 likewise: the quotient on
         their SD1.5 values, K7 at its SD1.5 shapes and every plan `time`
         sweeps, ragged and fp32; K5 at the SD1.5 sites (64² to 8², with
         and without SiLU), the int8 VAE's (4,128,512,512), fp32, ragged,
         an affine so small that the amax comes from the values (SiLU's
         interior), and every K. K6 and K11 likewise: the quotient on
         their values (K6's plain fp32 LayerNorm at the SD1.5 and ViT-B
         rows, K11's rows of the MMDiT's attention slices), K6 at every
         plan `time` sweeps (rows of 8 to 64 threads), fp32, ragged, a bf16
         and a strided affine; K11 on both slices of one packed
         (2, 4429, 1536) attention output at every plan swept, on
         contiguous rows, fp32, ragged, 32 KB rows and a batch-1 slice;
  time   device ms (`tools/timing.py::device_ms`) at every SD3 shape of the
         parent's Triton programs (launched as the parent's wrappers
         launched them, K13's modulation casts included) and the CUDA
         kernels, in turns (parent, new, new, parent), L2-warm (20
         back-to-back calls on one input) and L2-cold (the calls rotate
         through copies of the inputs that hold more than COLD_BYTES, so
         each call reads its input from device memory); the bound share is
         the cold reading's. Then the plan sweep (K10's threads per row,
         both kernels' row groups) and K10 with tanhf (the copy), cold.
         K7 and K5 likewise at their SD1.5 shapes (and the int8 VAE's for
         K5), against the parent's Triton programs (K7's
         `geglu_quant_kernel`; K5's fill of the amax slots, K3's stats and
         combine programs, `gn_amax_kernel` and `gn_quant_kernel`, five
         launches); the sweep of K7's threads and row groups and of K5's
         vectors per thread K. K6 at its SD1.5 rows (CFG batch 8) and the
         ViT-B's against the parent's `ln_quant_kernel`, K11 on the
         MMDiT's two attention slices against the parent's wrapper as it
         ran there (`x.contiguous()`, a copy, then `act_quant_kernel`);
         the sweep of K6's threads per row (8, 16, 32, 64: rows of one
         warp's aligned lanes or more) and row groups, and of K11's. K3 at
         its paths' shapes (K3_SHAPES) against the parent's three Triton
         programs (`_triton_norms.py`'s stats, combine and apply), with the
         device launches per call of each, and the sweep of K, all timed
         by `timing.stream_ms` (CUDA events
         around calls queued behind a spin kernel; no profiler trace);
         K9p likewise at the SD3 joint shape and on the ViT-B's K
         column slice against the parent's memset, `k_amax_kernel` and
         `k_codes_kernel` (PARENT_K9P, built with nvcc, called through
         ctypes), and the sweep of its blocks per SM. K12 at the SD3
         streams against the parent's Triton `adaln_kernel` (QUANT=False,
         the modulation cast to contiguous fp32 first), with the sweep of
         its row groups; K12b (the backward alone, fp32 and bf16) against
         the parent's backward, autograd of the plain version (about
         twenty plain kernels), with each one's error against the plain
         backward and device launches per call, and the sweep of the
         backward's threads per row and blocks per SM; all by
         `timing.device_ms`.
  phases K5 and K3: `gn_quant.cu` built with -DGN_PHASE_STAMPS (nvcc,
         called through ctypes): thread 0 of every block adds the clock64()
         cycles of each phase to its slot and stamps %globaltimer at its
         start and end. Printed per shape: each phase's mean cycles a
         block and share, the blocks' mean span and the kernel's (first
         start to last end) in µs, and the spread of the blocks' starts;
         for K5 also a copy without SiLU in the codes pass (NO_SILU_CODES;
         its codes are wrong, its time is the point), timed beside the copy
         as built.

Needs one CUDA card and nvcc; without a card it exits 2.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import os
import re
import subprocess
import sys

import torch

from prompt_diffusion_tpu_torch.ops import gn_quant
from prompt_diffusion_tpu_torch.ops import row_quant as rq
from prompt_diffusion_tpu_torch.ops.dispatch import plain_ops
from prompt_diffusion_tpu_torch.ops.fused_act import fused_gelu_quant, fused_quant_rows
from prompt_diffusion_tpu_torch.ops.fused_adaln import fused_adaln_quant
from prompt_diffusion_tpu_torch.ops.fused_layer_norm import fused_layer_norm_quant
from prompt_diffusion_tpu_torch.tools.attn_tune import _CSRC_DIR, _REPO, _nvcc
from prompt_diffusion_tpu_torch.tools.timing import (
    EXP_S,
    HBM_BYTES_S,
    card,
    device_launches,
    device_ms,
    stream_ms,
)

OUT_DIR = os.path.join(_REPO, "build", "quant_tune")
SOURCE = os.path.join(_CSRC_DIR, "row_quant.cu")
GN_SOURCE = os.path.join(_CSRC_DIR, "gn_quant.cu")
# the SD3 int8 step's shapes (CFG batch 2 at 1024²: 4096 image tokens and
# 333 context tokens of 1536; the FF's 4 x 1536 = 6144)
K10_SHAPES = ((8192, 6144), (666, 6144))
K13_SHAPES = ((2, 4096, 1536), (2, 333, 1536))
# the SD1.5 int8 step's at CFG batch 8 (a request of 4 at 512²): K7's rows
# (tokens x 2I) at 64², 32², 16² and 8²; K5's sites, (B, C, H, W), SiLU, eps
K7_SHAPES = ((32768, 2560), (8192, 5120), (2048, 10240), (512, 10240))
K5_SHAPES = (((8, 320, 64, 64), True, 1e-5), ((8, 960, 64, 64), True, 1e-5),
             ((8, 640, 32, 32), True, 1e-5), ((8, 1280, 16, 16), True, 1e-5),
             ((8, 1280, 8, 8), True, 1e-5), ((8, 2560, 8, 8), True, 1e-5),
             ((8, 320, 64, 64), False, 1e-6), ((4, 128, 512, 512), True, 1e-6))
# K6's rows (tokens x C, eps) at the SD1.5 int8 step at CFG batch 8 (64²,
# 32², 16², 8²), the 8² rows at CFG batch 4, and the DPT-Hybrid ViT-B's
# (16 x 1025 tokens); K11's: the MMDiT's attention output (B, N_h + N_c, C)
# at CFG batch 2, read as its image and context slices
K6_SHAPES = ((32768, 320, 1e-5), (8192, 640, 1e-5), (2048, 1280, 1e-5), (512, 1280, 1e-5),
             (256, 1280, 1e-5), (16400, 768, 1e-6))
K11_SLICES = (2, 4096, 333, 1536)
K6_THREADS = (8, 16, 32, 64)
# K3's shapes on its paths, (B, C, H, W), epilogue, eps, mean: the SD1.5
# 64² site with and without SiLU and an 8² one (CFG batch 8), the SD3 VAE's
# at 1024² (128 channels, the VAE's 4.0-mean case, and 512 at 128²), the
# SD1.5 VAE's at 512² (batch 4), and the DPT-Hybrid backbone's ReLU stem
# and stage 3 (batch 16 at 512²); K9p's: the SD3 joint K, and the ViT-B's K
# column slice of its (16, 1025, 2304) qkv projection
K3_SHAPES = (((8, 320, 64, 64), "silu", 1e-5, 0.0), ((8, 320, 64, 64), "none", 1e-6, 0.0),
             ((8, 1280, 8, 8), "silu", 1e-5, 0.0), ((1, 512, 128, 128), "none", 1e-6, 0.0),
             ((1, 128, 1024, 1024), "silu", 1e-6, 4.0), ((4, 128, 512, 512), "silu", 1e-6, 4.0),
             ((16, 64, 256, 256), "relu", 1e-5, 0.0), ((16, 256, 32, 32), "relu", 1e-5, 0.0))
K9P_SHAPES = (((2, 4429, 1536), 24, 1536), ((16, 1025, 768), 12, 2304))
KERNELS = ("K10", "K13", "K7", "K5", "K6", "K11", "K3", "K9p", "K12", "K12b")
# K12's backward alone at the SD3 image stream in fp32 and bf16 and the
# context stream in bf16 ((B, C) modulation there)
K12B_SHAPES = (((2, 4096, 1536), torch.float32), ((2, 4096, 1536), torch.bfloat16),
               ((2, 333, 1536), torch.bfloat16))
SCALE_REL_BOUND, CODES_EQUAL_BOUND = 1e-6, 0.999
SWEEP_SCALES = 128
COLD_BYTES = 120e6  # > twice the H100's 50 MB L2
# K10's GELU in the tanh form of the plain version, with CUDA's tanhf,
# returned ahead of the kernel's x * sigmoid(2z): the edit that makes the copy
_GELU_FIRST_LINE = "  const float u = x * fmaf(kGeluC3, x * x, kGeluC1);"
TANHF = (_GELU_FIRST_LINE,
         "  if (true) return x * (0.5f * (1.0f + tanhf(0.7978845608028654f * (x + 0.044715f * "
         "(x * x * x)))));\n" + _GELU_FIRST_LINE)
# every thread-instruction issues at most at the fp32 rate, one per lane per
# clock (67 TFLOP/s of FFMA, NVIDIA's data sheet); MUFU at the
# special-function rate of `timing.EXP_S`
ISSUE_S = 33.5e12


def _x(gen, *shape, dtype=torch.bfloat16):
    return (2 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)


def _mod(gen, b, c, dtype=torch.bfloat16):
    """scale and shift as the MMDiT passes them: (B, 1, C) chunks of one
    (B, 1, 6C) projection."""
    proj = (0.1 * torch.randn((b, 1, 6 * c), generator=gen, device="cuda")).to(dtype)
    chunks = proj.chunk(6, dim=-1)
    return chunks[1], chunks[0]


def _ln_inputs(gen, n, c, dtype=torch.bfloat16):
    """x (n, c) and an fp32 affine near (1, 0), as the LayerNorm modules
    hold it."""
    w = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    return _x(gen, n, c, dtype=dtype), w, 0.1 * torch.randn(c, generator=gen, device="cuda")


def _attn(gen, b, n_h, n_c, c, dtype=torch.bfloat16):
    """The MMDiT's packed (B, N_h + N_c, C) attention output and its image
    and context slices, as the JointBlock hands them to K11."""
    attn = _x(gen, b, n_h + n_c, c, dtype=dtype)
    return attn[:, :n_h], attn[:, n_h:]


def _parent_ln_quant(x, w, b, eps):
    """K6 as the parent launched it: Triton `ln_quant_kernel` over rows
    padded to a power of two."""
    import triton

    from prompt_diffusion_tpu_torch.ops import _triton_quant as tq
    from prompt_diffusion_tpu_torch.ops import fused_layer_norm as fl

    x2, wf, bf, block_r, block_c = fl._rows(x, w, b)
    n, c = x2.shape
    q = torch.empty((n, c), dtype=torch.int8, device=x.device)
    s_a = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    tq.ln_quant_kernel[(triton.cdiv(n, block_r),)](
        x2, q, s_a, wf, bf, n, c, float(eps), BLOCK_R=block_r, BLOCK_C=block_c)
    return q.view(x.shape), s_a.view(*x.shape[:-1], 1)


def _parent_gelu_quant(x):
    """K10 as the parent launched it: Triton `act_quant_kernel`, GELU=True."""
    return _parent_act_quant(x, gelu=True)


def _parent_quant_rows(x):
    """K11 as the parent launched it: a copy of x to contiguous rows (the
    MMDiT's slices are not), then Triton `act_quant_kernel`, GELU=False."""
    return _parent_act_quant(x, gelu=False)


def _parent_act_quant(x, gelu):
    import triton

    from prompt_diffusion_tpu_torch.ops import _triton_quant as tq
    from prompt_diffusion_tpu_torch.ops.fused_layer_norm import _TILE

    c = x.shape[-1]
    x2 = x.contiguous().view(-1, c)
    n = x2.shape[0]
    block_c = triton.next_power_of_2(c)
    block_r = max(1, _TILE // block_c)
    q = torch.empty((n, c), dtype=torch.int8, device=x.device)
    s_a = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    tq.act_quant_kernel[(triton.cdiv(n, block_r),)](
        x2, q, s_a, n, c, BLOCK_R=block_r, BLOCK_C=block_c, GELU=gelu,
        num_warps=8 if block_c >= 4096 else 4)
    return q.view(x.shape), s_a.view(*x.shape[:-1], 1)


def _parent_adaln_quant(x, scale, shift, eps=1e-6):
    """K13 as the parent launched it: the modulation cast to contiguous
    fp32, then Triton `adaln_kernel`, QUANT=True."""
    return _parent_adaln_program(x, scale, shift, eps, quant=True)


def _parent_adaln(x, scale, shift, eps=1e-6):
    """K12's forward as the parent launched it: the same, QUANT=False, y in
    x's dtype."""
    return _parent_adaln_program(x, scale, shift, eps, quant=False)


def _parent_adaln_bwd(x, scale, shift, g, eps=1e-6):
    """K12's backward as the parent ran it: the plain forward recomputed
    under autograd, then `torch.autograd.grad` at g."""
    from prompt_diffusion_tpu_torch.ops.fused_adaln import _torch_adaln

    b, _, c = x.shape
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (x, scale, shift)]
        out = _torch_adaln(inputs[0], inputs[1].reshape(b, 1, c), inputs[2].reshape(b, 1, c),
                           eps).to(x.dtype)
        return torch.autograd.grad(out, inputs, g)


def _parent_adaln_program(x, scale, shift, eps, quant):
    import triton

    from prompt_diffusion_tpu_torch.ops import _triton_quant as tq
    from prompt_diffusion_tpu_torch.ops.fused_layer_norm import _TILE

    b, n, c = x.shape
    x2 = x.contiguous().view(b * n, c)
    sc = scale.reshape(b, 1, c).float().contiguous()
    sh = shift.reshape(b, 1, c).float().contiguous()
    block_c = triton.next_power_of_2(c)
    block_r = max(1, _TILE // block_c)
    out = torch.empty((b, n, c), dtype=torch.int8 if quant else x.dtype, device=x.device)
    s_a = torch.empty((b, n, 1), dtype=torch.float32, device=x.device) if quant else out
    tq.adaln_kernel[(triton.cdiv(b * n, block_r),)](
        x2, sc, sh, out, s_a, b * n, n, c, float(eps), BLOCK_R=block_r, BLOCK_C=block_c,
        QUANT=quant)
    return (out, s_a) if quant else out


def _gn_inputs(gen, shape, mean=0.0, gain=1.0, dtype=torch.bfloat16):
    """x (channels_last) and an affine near (gain, 0), as the models pass
    them."""
    x = (torch.randn(shape, generator=gen, device="cuda") + mean).to(dtype)
    c = shape[1]
    w = gain * (1 + 0.1 * torch.randn(c, generator=gen, device="cuda"))
    b = 0.1 * gain * torch.randn(c, generator=gen, device="cuda")
    return x.contiguous(memory_format=torch.channels_last), w, b


def _gn_plan(x, silu, **kwargs):
    """K5's plan for x with the card's occupancy; kwargs force K."""
    from prompt_diffusion_tpu_torch.ops import gn_quant as gq

    dev, bf16 = x.device.index or 0, x.dtype == torch.bfloat16
    b, c, h, w = x.shape
    return gq.gn_plan(b, c, h * w, 32, x.dtype, sms=gq._sms(dev),
                      occupancy=lambda k, t, m: gq._occupancy(dev, bf16, silu, k, t, m),
                      **kwargs)


K3_ACTS = {"none": gn_quant.ACT_NONE, "silu": gn_quant.ACT_SILU, "relu": gn_quant.ACT_RELU}


def _k3_plan(x, act, **kwargs):
    """K3's plan for x with the card's occupancy; kwargs force K."""
    from prompt_diffusion_tpu_torch.ops import gn_quant as gq

    dev, bf16 = x.device.index or 0, x.dtype == torch.bfloat16
    b, c, h, w = x.shape
    return gq.gn_float_plan(
        b, c, h * w, 32, x.dtype, sms=gq._sms(dev),
        occupancy=lambda k, t, m: gq._float_occupancy(dev, bf16, K3_ACTS[act], k, t, m),
        **kwargs)


def _parent_geglu_quant(proj):
    """K7 as the parent launched it: Triton `geglu_quant_kernel` over rows
    padded to a power of two."""
    import triton

    from prompt_diffusion_tpu_torch.ops import _triton_quant as tq
    from prompt_diffusion_tpu_torch.ops.fused_layer_norm import _TILE

    inner = proj.shape[-1] // 2
    x2 = proj.contiguous().view(-1, 2 * inner)
    n = x2.shape[0]
    block_i = triton.next_power_of_2(inner)
    block_r = max(1, _TILE // block_i)
    q = torch.empty((n, inner), dtype=torch.int8, device=proj.device)
    s_a = torch.empty((n, 1), dtype=torch.float32, device=proj.device)
    tq.geglu_quant_kernel[(triton.cdiv(n, block_r),)](
        x2, q, s_a, n, inner, BLOCK_R=block_r, BLOCK_I=block_i,
        num_warps=8 if block_i >= 4096 else 4)
    return q.view(*proj.shape[:-1], inner), s_a.view(*proj.shape[:-1], 1)


# the parent K3's tiles: pixels and channels of a stats or apply program,
# row-block partials per combine step
_GN_ROWS, _GN_BLOCK_C, _GN_BLOCK_R = 128, 64, 64


def _parent_gn_stats(x, w, b, groups, eps):
    """The parent K3's stats and combine programs (`_triton_norms.py`):
    per-(sample, channel) fp32 scale and shift with the affine folded in,
    and the (sample, row block, channel block) grid of its apply program."""
    import triton

    from prompt_diffusion_tpu_torch.ops import _triton_norms as tk

    bsz, c, h, wd = x.shape
    hw, cg = h * wd, c // groups
    rb, cb = triton.cdiv(hw, _GN_ROWS), triton.cdiv(c, _GN_BLOCK_C)
    f32 = dict(dtype=torch.float32, device=x.device)
    part_mean = torch.empty((bsz, rb, c), **f32)
    part_m2 = torch.empty((bsz, rb, c), **f32)
    eff_scale = torch.empty((bsz, c), **f32)
    eff_shift = torch.empty((bsz, c), **f32)
    tk.gn_stats_kernel[(bsz, rb, cb)](x, part_mean, part_m2, hw, c, rb, ROWS=_GN_ROWS,
                                      BLOCK_C=_GN_BLOCK_C)
    tk.gn_combine_kernel[(bsz, groups)](
        part_mean, part_m2, w.float().contiguous(), b.float().contiguous(), eff_scale,
        eff_shift, hw, c, rb, cg, float(eps), ROWS=_GN_ROWS, BLOCK_R=_GN_BLOCK_R,
        BLOCK_CG=triton.next_power_of_2(cg))
    return eff_scale, eff_shift, (bsz, rb, cb)


def _parent_gn(x, w, b, eps, act):
    """K3 as the parent launched it: its Triton stats, combine and apply
    programs (three device launches) over channels_last x."""
    from prompt_diffusion_tpu_torch.ops import _triton_norms as tk

    x = x.contiguous(memory_format=torch.channels_last)
    y = torch.empty_like(x)
    eff_scale, eff_shift, grid = _parent_gn_stats(x, w, b, 32, eps)
    tk.gn_apply_kernel[grid](x, y, eff_scale, eff_shift, x.shape[2] * x.shape[3], x.shape[1],
                             ROWS=_GN_ROWS, BLOCK_C=_GN_BLOCK_C, APPLY_SILU=act == "silu",
                             APPLY_RELU=act == "relu")
    return y


def _parent_gn_quant(x, w, b, eps, silu):
    """K5 as the parent launched it: a fill of the amax slots, K3's Triton
    stats and combine programs, then `gn_amax_kernel` and
    `gn_quant_kernel` (five device launches)."""
    from prompt_diffusion_tpu_torch.ops import _triton_quant as tq

    x = x.contiguous(memory_format=torch.channels_last)
    bsz, c, h, wd = x.shape
    q = torch.empty_like(x, dtype=torch.int8)
    s_a = torch.empty((bsz,), dtype=torch.float32, device=x.device)
    amax = torch.zeros((bsz,), dtype=torch.int32, device=x.device)
    eff_scale, eff_shift, grid = _parent_gn_stats(x, w, b, 32, eps)
    meta = dict(ROWS=_GN_ROWS, BLOCK_C=_GN_BLOCK_C, APPLY_SILU=bool(silu))
    tq.gn_amax_kernel[grid](x, eff_scale, eff_shift, amax, h * wd, c, **meta)
    tq.gn_quant_kernel[grid](x, eff_scale, eff_shift, amax, q, s_a, h * wd, c, **meta)
    return q, s_a


# K9p's parent, three device operations per call: a memset of a (B, H)
# buffer, `k_amax_kernel` (warp maxima, one atomicMax on a float's bits per
# block) and `k_codes_kernel` (IEEE division per value), as
# `int8_attention.cu` held them before K9p
PARENT_K9P = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
constexpr int QK_THREADS = 256, AMAX_ROWS = 128;
__device__ __forceinline__ void load8(float (&x)[8], const __nv_bfloat16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ float abs_max8(const float (&x)[8]) {
  float m = 0.f;
  for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(x[e]));
  return m;
}
__device__ __forceinline__ uint32_t code8(float x, float s) {
  const float c = fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(c)) & 0xffu;
}
template <int D>
__global__ void __launch_bounds__(QK_THREADS) k_amax_kernel(const __nv_bfloat16* k, int64_t k_sb,
    int64_t k_sn, int heads, int nk, float* amax) {
  constexpr int CH = D / 8;
  __shared__ float part[QK_THREADS / 32];
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int r0 = blockIdx.x * AMAX_ROWS, rows = min(AMAX_ROWS, nk - r0);
  const __nv_bfloat16* kb = k + b * k_sb + h * D;
  float mx = 0.f;
  for (int i = threadIdx.x; i < rows * CH; i += QK_THREADS) {
    float x[8];
    load8(x, kb + (int64_t)(r0 + i / CH) * k_sn + (i % CH) * 8);
    mx = fmaxf(mx, abs_max8(x));
  }
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < QK_THREADS / 32; ++w) mx = fmaxf(mx, part[w]);
    atomicMax(reinterpret_cast<int*>(amax) + bh, __float_as_int(mx));
  }
}
template <int D>
__global__ void __launch_bounds__(QK_THREADS) k_codes_kernel(const __nv_bfloat16* k, int64_t k_sb,
    int64_t k_sn, int batch, int heads, int nk, const float* amax, float* sk, int8_t* codes) {
  constexpr int CH = D / 8;
  const int64_t row_ch = (int64_t)heads * CH, total = (int64_t)batch * nk * row_ch;
  const int64_t i = (int64_t)blockIdx.x * QK_THREADS + threadIdx.x;
  if (i >= total) return;
  const int b = static_cast<int>(i / (nk * row_ch));
  const int64_t rem = i - (int64_t)b * nk * row_ch;
  const int n = static_cast<int>(rem / row_ch);
  const int c = static_cast<int>(rem - (int64_t)n * row_ch), h = c / CH;
  float x[8];
  load8(x, k + b * k_sb + (int64_t)n * k_sn + c * 8);
  const float s = fmaxf(__fdiv_rn(amax[b * heads + h], 127.f), 1e-8f);
  if (n == 0 && c % CH == 0) sk[b * heads + h] = s;
  uint2 out;
  out.x = code8(x[0], s) | (code8(x[1], s) << 8) | (code8(x[2], s) << 16) | (code8(x[3], s) << 24);
  out.y = code8(x[4], s) | (code8(x[5], s) << 8) | (code8(x[6], s) << 16) | (code8(x[7], s) << 24);
  *reinterpret_cast<uint2*>(codes + i * 8) = out;
}
extern "C" int parent_quant_k(const void* k, int64_t k_sb, int64_t k_sn, int batch, int heads,
                              int nk, void* amax, void* sk, void* codes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(float) * batch * heads, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  k_amax_kernel<64><<<dim3((nk + AMAX_ROWS - 1) / AMAX_ROWS, batch * heads), QK_THREADS, 0, s>>>(
      kp, k_sb, k_sn, heads, nk, static_cast<float*>(amax));
  const int64_t chunks = (int64_t)batch * nk * heads * 8;
  k_codes_kernel<64><<<(unsigned)((chunks + QK_THREADS - 1) / QK_THREADS), QK_THREADS, 0, s>>>(
      kp, k_sb, k_sn, batch, heads, nk, static_cast<const float*>(amax),
      static_cast<float*>(sk), static_cast<int8_t*>(codes));
  return static_cast<int>(cudaGetLastError());
}
"""


def _parent_k9p():
    """The parent K9p (PARENT_K9P, D = 64) as a call k, heads -> (codes,
    scales)."""
    os.makedirs(OUT_DIR, exist_ok=True)
    src = os.path.join(OUT_DIR, "parent_k9p.cu")
    with open(src, "w") as f:
        f.write(PARENT_K9P)
    so = ctypes.CDLL(_build("parent_k9p.so", src, "-shared", "-Xcompiler", "-fPIC")[0])
    so.parent_quant_k.argtypes = ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
                                  + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4)
    so.parent_quant_k.restype = ctypes.c_int

    def quant_k(k, heads):
        b, nk, hd = k.shape
        codes = torch.empty((b, nk, hd), dtype=torch.int8, device=k.device)
        amax, scales = torch.empty((2, b, heads), dtype=torch.float32, device=k.device)
        err = so.parent_quant_k(k.data_ptr(), k.stride(0), k.stride(1), b, heads, nk,
                                amax.data_ptr(), scales.data_ptr(), codes.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the parent K9p's launch failed: {err}")
        return codes, scales

    return quant_k


def _compare(out, ref):
    """(largest relative scale error, largest code difference, share of
    equal codes)."""
    (q, s), (rq_, rs) = out, ref
    scale_err = ((s.float() - rs).abs() / rs).max().item()
    diff = (q.int() - rq_.int()).abs()
    return scale_err, diff.max().item(), (diff == 0).float().mean().item()


def _within(out, ref):
    scale_err, code_diff, equal = _compare(out, ref)
    ok = scale_err <= SCALE_REL_BOUND and code_diff <= 1 and equal >= CODES_EQUAL_BOUND
    return ok, (f"scales within {scale_err:.3g} relative, codes at most {code_diff} apart, "
                f"{equal:.6f} equal")


def _tanhf_source():
    """A copy of the source whose K10 takes tanhf (TANHF)."""
    src = open(SOURCE).read()
    if TANHF[0] not in src:
        raise RuntimeError("the TANHF edit no longer matches row_quant.cu")
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "row_quant_tanhf.cu")
    with open(path, "w") as f:
        f.write(src.replace(TANHF[0], TANHF[1]))
    return path


def _build(name, src, *flags):
    os.makedirs(OUT_DIR, exist_ok=True)
    out = os.path.join(OUT_DIR, name)
    log, _ = _nvcc(src, out, "-I", _CSRC_DIR, *flags).communicate()
    if not os.path.isfile(out):
        raise RuntimeError(f"nvcc failed on {src}:\n{log[-3000:]}")
    return out, log


# ---- sass ----------------------------------------------------------------

_KERNEL = re.compile(r"(gelu|adaln|geglu|ln|rows)_quant_kernelI(13__nv_bfloat16|f)Li(\d)ELb([01])E")
_GN_KERNEL = re.compile(r"gn_quant_kernelI(13__nv_bfloat16|f)Li(\d)ELb([01])E")
_K3_KERNEL = re.compile(r"gn_float_kernelI(13__nv_bfloat16|f)Li(\d)ELi(\d)E")
_K9P_KERNEL = re.compile(r"k_head_quant_kernelILi(\d+)E")
_K12_KERNEL = re.compile(r"adaln_(float|bwd)_kernelI(13__nv_bfloat16|f)Li(\d)E(?:Lb([01])E)?")
# K12's kernels: the two vectors-per-thread counts compared (of x, and of g
# in the backward)
_K12_SASS = {"K12": ("float", 3, 6), "K12b": ("bwd", 1, 3)}


def _row_key(m):
    return (m.group(1), "bf16" if m.group(2) != "f" else "fp32", int(m.group(3)),
            m.group(4) == "1")


def _sass_counts(cubin, pattern=_KERNEL, key_of=_row_key):
    """{key_of(match): (instructions, MUFU operations)} of every kernel
    instantiation in `cubin` whose name `pattern` matches (by default the
    row kernels: (op, dtype, vpt, pipe))."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME, "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", cubin], capture_output=True, text=True,
                          check=True).stdout
    counts, key = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            m = pattern.search(line)
            key = None if m is None else key_of(m)
            if key:
                counts[key] = [0, 0]
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if key and m:
            counts[key][0] += 1
            counts[key][1] += m.group(1).startswith("MUFU")
    return counts


# (op, the two vectors-per-thread counts compared, values between them per
# row group, shapes as (samples, rows, output width), input values per output)
_SASS_OPS = {"K10": ("gelu", 3, 6, 24, [(1, r, c) for r, c in K10_SHAPES], 1),
             "K13": ("adaln", 3, 6, 24, K13_SHAPES, 1),
             "K7": ("geglu", 2, 4, 16, [(1, r, w // 2) for r, w in K7_SHAPES], 2),
             "K6": ("ln", 2, 5, 24, [(1, r, c) for r, c, _ in K6_SHAPES], 1),
             "K11": ("rows", 3, 6, 24, [(K11_SLICES[0], n, K11_SLICES[3])
                                        for n in K11_SLICES[1:3]], 1)}


def _ptxas(log, pattern, keep):
    """(instantiation, "registers | spills") from ptxas's report in `log` for
    the kernels `pattern` matches and `keep(match)` selects."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\w+)'", line)
        k = m and pattern.search(m.group(1))
        if k and keep(k):
            yield k, " | ".join(x.split(":", 2)[-1].strip() for x in lines[i + 1:i + 4]
                                if "registers" in x or "spill" in x)


def sass(_gen, _iters, kernels):
    """Registers, spills, SASS instructions and MUFU operations per value."""
    builds = [("built", SOURCE)] + ([("tanhf", _tanhf_source())] if "K10" in kernels else [])
    for label, src in builds:
        cubin, log = _build(f"row_quant_{label}.cubin", src, "-cubin")
        for k, info in _ptxas(log, _KERNEL, lambda k: int(k.group(3)) in (2, 3, 5, 6)):
            print(f"[quant_tune] ptxas {label} {k.group(1)}<{k.group(2)}, {k.group(3)}, "
                  f"pipe={k.group(4)}>: {info}", flush=True)
        counts = _sass_counts(cubin)
        for name, (op, lo, hi, span, shapes, inputs) in _SASS_OPS.items():
            if name not in kernels or (label == "tanhf" and name != "K10"):
                continue
            for pipe in (False, True):
                (i_lo, m_lo), (i_hi, m_hi) = (counts[(op, "bf16", lo, pipe)],
                                              counts[(op, "bf16", hi, pipe)])
                per_value, mufu_value = (i_hi - i_lo) / span, (m_hi - m_lo) / span
                per_thread = i_lo - lo * span / (hi - lo) * per_value
                msg = []
                for b, n, c in shapes:
                    plan = rq.row_plan(b * n, c, torch.bfloat16, samples=b, inputs=inputs)
                    values, threads = b * n * c, b * n * plan.threads
                    issue = values * per_value / ISSUE_S * 1e3
                    mufu = values * mufu_value / EXP_S * 1e3
                    static = threads * per_thread / ISSUE_S * 1e3
                    nbytes = ((2 * inputs + 1) * values + 4 * b * n
                              + {"adaln": 4 * b * c, "ln": 8 * c}.get(op, 0))
                    msg.append(f"({b},{n},{c}) compute bound {max(issue, mufu):.4f} ms (issue "
                               f"{issue:.4f}, MUFU {mufu:.4f}; the static per-thread part "
                               f"would add at most {static:.4f}) beside bytes "
                               f"{nbytes / HBM_BYTES_S * 1e3:.4f}")
                print(f"[quant_tune] sass {label} {name} {op} bf16 pipe={pipe}: {i_lo} "
                      f"instructions at VPT={lo}, {i_hi} at VPT={hi}: {per_value:.2f} per output "
                      f"value ({mufu_value:.2f} MUFU), {per_thread:.0f} static per thread and "
                      f"row group (slow paths of the divisions included); " + "; ".join(msg),
                      flush=True)
        if label == "built" and kernels & set(_K12_SASS):
            _sass_k12(cubin, log, kernels)
    if kernels & {"K5", "K3"}:
        cubin, log = _build("gn_quant.cubin", GN_SOURCE, "-cubin")
        for k, info in _ptxas(log, _GN_KERNEL, lambda k: "K5" in kernels):
            print(f"[quant_tune] ptxas gn_quant_kernel<{k.group(1)}, K={k.group(2)}, "
                  f"silu={k.group(3)}>: {info}", flush=True)
        for k, info in _ptxas(log, _K3_KERNEL, lambda k: "K3" in kernels):
            print(f"[quant_tune] ptxas gn_float_kernel<{k.group(1)}, K={k.group(2)}, "
                  f"act={k.group(3)}>: {info}", flush=True)
        if "K3" in kernels:
            counts = _sass_counts(cubin, _K3_KERNEL, lambda m: (m.group(1), int(m.group(2)),
                                                                int(m.group(3))))
            for dt, (hi, lo) in (("13__nv_bfloat16", (8, 4)), ("f", (4, 2))):
                for act, name in enumerate(("none", "silu", "relu")):
                    (i_hi, m_hi), (i_lo, m_lo) = counts[(dt, hi, act)], counts[(dt, lo, act)]
                    values = 8 * (hi - lo)  # the values K = hi holds beyond K = lo, a pass
                    dtype = "fp32" if dt == "f" else "bf16"
                    print(f"[quant_tune] sass K3 gn_float_kernel<{dtype}, {name}>: {i_hi} "
                          f"instructions at K={hi}, {i_lo} at K={lo}: "
                          f"{(i_hi - i_lo) / values:.2f} per value over its passes "
                          f"({(m_hi - m_lo) / values:.2f} MUFU)", flush=True)
    if "K9p" in kernels:
        cubin, log = _build("int8_attention.cubin", os.path.join(_CSRC_DIR, "int8_attention.cu"),
                            "-cubin")
        for k, info in _ptxas(log, _K9P_KERNEL, lambda k: True):
            print(f"[quant_tune] ptxas k_head_quant_kernel<D={k.group(1)}>: {info}", flush=True)
        counts = _sass_counts(cubin, _K9P_KERNEL, lambda m: int(m.group(1)))
        for d, (instr, mufu) in sorted(counts.items()):
            print(f"[quant_tune] sass K9p k_head_quant_kernel<D={d}>: {instr} instructions "
                  f"({mufu} MUFU), static", flush=True)


def _sass_k12(cubin, log, kernels):
    """K12's forward and backward: ptxas's registers and spills of every
    instantiation, and instructions per value from two vector counts."""
    for name, (kind, lo, hi) in _K12_SASS.items():
        if name not in kernels:
            continue
        for k, info in _ptxas(log, _K12_KERNEL, lambda k, kind=kind: k.group(1) == kind):
            print(f"[quant_tune] ptxas adaln_{kind}_kernel<{k.group(2)}, VPT={k.group(3)}"
                  + ("" if k.group(4) is None else f", pipe={k.group(4)}") + f">: {info}",
                  flush=True)
        counts = _sass_counts(cubin, _K12_KERNEL, lambda m: (m.group(1), m.group(2),
                                                             int(m.group(3)), m.group(4) == "1"))
        for dt, e in (("13__nv_bfloat16", 8), ("f", 4)):
            for pipe in ((False, True) if kind == "float" else (False,)):
                (i_lo, m_lo), (i_hi, m_hi) = counts[(kind, dt, lo, pipe)], counts[(kind, dt, hi,
                                                                                   pipe)]
                span = (hi - lo) * e
                dtype = "fp32" if dt == "f" else "bf16"
                print(f"[quant_tune] sass {name} adaln_{kind}_kernel<{dtype}"
                      + (f", pipe={pipe}" if kind == "float" else "") + f">: {i_lo} "
                      f"instructions at VPT={lo}, {i_hi} at VPT={hi}: "
                      f"{(i_hi - i_lo) / span:.2f} per value ({(m_hi - m_lo) / span:.2f} MUFU)",
                      flush=True)


# ---- check ---------------------------------------------------------------

_DIV_CHECK = r"""
#include "{source}"

// bad[0] += quotients of rq::quotient that differ from __fdiv_rn
__global__ void div_rows_kernel(const float* y, const float* s, long long n, int c,
                                unsigned long long* bad) {{
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  unsigned long long miss = 0;
  for (; i < n; i += (long long)gridDim.x * blockDim.x) {{
    const float sr = s[i / c];
    miss += __float_as_uint(rq::quotient(y[i], sr, __frcp_rn(sr))) !=
            __float_as_uint(__fdiv_rn(y[i], sr));
  }}
  atomicAdd(bad, miss);
}}

// the same with y = the kernel's GELU of bf16 x
__global__ void gelu_rows_kernel(const __nv_bfloat16* x, const float* s, long long n, int c,
                                 unsigned long long* bad) {{
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  unsigned long long miss = 0;
  for (; i < n; i += (long long)gridDim.x * blockDim.x) {{
    const float sr = s[i / c], y = gelu(__bfloat162float(x[i]));
    miss += __float_as_uint(rq::quotient(y, sr, __frcp_rn(sr))) !=
            __float_as_uint(__fdiv_rn(y, sr));
  }}
  atomicAdd(bad, miss);
}}

// every float y (both signs) in [s/4, 128 s] for each s of the list
__global__ void div_sweep_kernel(const float* scales, int ns, unsigned long long* bad,
                                 unsigned long long* count) {{
  unsigned long long miss = 0, seen = 0;
  for (int k = 0; k < ns; ++k) {{
    const float s = scales[k], r = __frcp_rn(s);
    const unsigned lo = __float_as_uint(0.25f * s), hi = __float_as_uint(128.f * s);
    for (unsigned u = lo + blockIdx.x * blockDim.x + threadIdx.x; u <= hi;
         u += gridDim.x * blockDim.x) {{
      const float y = __uint_as_float(u);
      miss += __float_as_uint(rq::quotient(y, s, r)) != __float_as_uint(__fdiv_rn(y, s));
      miss += __float_as_uint(rq::quotient(-y, s, r)) != __float_as_uint(__fdiv_rn(-y, s));
      seen += 2;
    }}
  }}
  atomicAdd(bad, miss);
  atomicAdd(count, seen);
}}

extern "C" int div_rows(const void* y, const void* s, long long n, int c, int gelu_of_bf16,
                        void* bad, void* stream) {{
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gelu_of_bf16) {{
    gelu_rows_kernel<<<1024, 256, 0, st>>>(static_cast<const __nv_bfloat16*>(y),
                                           static_cast<const float*>(s), n, c,
                                           static_cast<unsigned long long*>(bad));
  }} else {{
    div_rows_kernel<<<1024, 256, 0, st>>>(static_cast<const float*>(y),
                                          static_cast<const float*>(s), n, c,
                                          static_cast<unsigned long long*>(bad));
  }}
  return static_cast<int>(cudaGetLastError());
}}

extern "C" int div_sweep(const void* scales, int ns, void* bad, void* count, void* stream) {{
  div_sweep_kernel<<<4096, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scales), ns, static_cast<unsigned long long*>(bad),
      static_cast<unsigned long long*>(count));
  return static_cast<int>(cudaGetLastError());
}}
"""


def _div_lib():
    os.makedirs(OUT_DIR, exist_ok=True)
    src = os.path.join(OUT_DIR, "div_check.cu")
    with open(src, "w") as f:
        f.write(_DIV_CHECK.format(source=SOURCE))
    lib, _ = _build("div_check.so", src, "-shared", "-Xcompiler", "-fPIC")
    so = ctypes.CDLL(lib)
    so.div_rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    so.div_sweep.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_void_p]
    so.div_rows.restype = so.div_sweep.restype = ctypes.c_int
    return so


def _div_cases(gen, kernels):
    """(label, y or bf16 x as (rows, c), per-row s, is x): K10's x at the
    SD3 shapes with the kernel's row scales, K13's plain fp32 values with
    the kernel's; K7's and K5's plain fp32 values at their SD1.5 shapes
    with the kernels' scales (K5: one row per sample); K6's at its SD1.5
    and ViT-B rows, K11's rows of the MMDiT's attention slices."""
    import torch.nn.functional as F

    from prompt_diffusion_tpu_torch.ops.fused_adaln import _torch_adaln
    from prompt_diffusion_tpu_torch.ops.fused_act import fused_geglu_quant
    from prompt_diffusion_tpu_torch.ops.fused_group_norm import fused_group_norm_quant
    from prompt_diffusion_tpu_torch.ops.norms import group_norm_f32

    if "K10" in kernels:
        for n, c in K10_SHAPES:
            x = _x(gen, n, c)
            yield f"K10 ({n},{c})", x, fused_gelu_quant(x)[1], True
    if "K13" in kernels:
        for b, n, c in K13_SHAPES:
            x, (sc, sh) = _x(gen, b, n, c), _mod(gen, b, c)
            yield f"K13 ({b},{n},{c})", _torch_adaln(x, sc, sh, 1e-6), \
                fused_adaln_quant(x, sc, sh)[1], False
    if "K7" in kernels:
        for n, w in K7_SHAPES[:2]:
            x = _x(gen, n, w)
            h, g = x.float().chunk(2, dim=-1)
            yield f"K7 ({n},{w})", h * F.gelu(g), fused_geglu_quant(x)[1], False
    if "K5" in kernels:
        for shape, silu, eps in K5_SHAPES[:2]:
            x, w, b = _gn_inputs(gen, shape)
            y = group_norm_f32(x, 32, w, b, eps=eps, apply_silu=silu)
            yield (f"K5 {shape}", y.reshape(shape[0], -1),
                   fused_group_norm_quant(x, w, b, 32, eps, silu)[1], False)
    if "K6" in kernels:
        from prompt_diffusion_tpu_torch.ops.fused_layer_norm import _layer_norm_f32

        for n, c, eps in K6_SHAPES:
            x, w, b = _ln_inputs(gen, n, c)
            yield (f"K6 ({n},{c})", _layer_norm_f32(x, w, b, eps),
                   fused_layer_norm_quant(x, w, b, eps)[1], False)
    if "K11" in kernels:
        b, n_h, n_c, c = K11_SLICES
        for x in _attn(gen, b, n_h, n_c, c):
            yield (f"K11 {tuple(x.shape)} slice", x.float().reshape(-1, c),
                   fused_quant_rows(x)[1], False)


def _check_division(gen, kernels):
    so = _div_lib()
    stream = torch.cuda.current_stream().cuda_stream
    failed = []
    for label, y, s, is_x in _div_cases(gen, kernels):
        bad = torch.zeros(1, dtype=torch.int64, device="cuda")
        y, s = y.contiguous(), s.contiguous()
        err = so.div_rows(y.data_ptr(), s.data_ptr(), y.numel(), y.shape[-1], int(is_x),
                          bad.data_ptr(), stream)
        if err:
            raise RuntimeError(f"div_rows launch failed: {err}")
        miss = bad.item()
        print(f"[quant_tune] check quotient {label}: {y.numel()} values, {miss} differ from "
              f"__fdiv_rn", flush=True)
        if miss:
            failed.append(label)
    # scales as the kernels make them (amax / 127, at least 1e-8) over many
    # binades, and significands at the ends of [1, 2)
    amax = torch.exp(torch.empty(SWEEP_SCALES - 4, device="cuda").uniform_(-12, 8,
                                                                             generator=gen))
    edge = torch.tensor([1e-8, 1.0, 1.9999999, 1.0000001], device="cuda")
    scales = torch.cat([torch.clamp_min(amax / torch.tensor(127.0, device="cuda"), 1e-8), edge])
    bad, count = torch.zeros(2, dtype=torch.int64, device="cuda")
    err = so.div_sweep(scales.data_ptr(), scales.numel(), bad.data_ptr(), count.data_ptr(),
                       stream)
    if err:
        raise RuntimeError(f"div_sweep launch failed: {err}")
    print(f"[quant_tune] check quotient sweep: every float y in [s/4, 128 s], both signs, "
          f"{scales.numel()} values of s: {count.item()} quotients, {bad.item()} differ from "
          f"__fdiv_rn", flush=True)
    if bad.item():
        failed.append("sweep")
    return failed


def _kernel_cases(gen, kernels):
    """(label, kernel call, plain call) for `check`."""
    from prompt_diffusion_tpu_torch.ops import gn_quant as gq
    from prompt_diffusion_tpu_torch.ops.fused_act import fused_geglu_quant
    from prompt_diffusion_tpu_torch.ops.fused_group_norm import fused_group_norm_quant

    cases = []
    if "K10" in kernels:
        plans10 = [(t, g) for t in (128, 256) for g in (1, 2, 4)]
        for n, c in K10_SHAPES + ((200, 256), (37, 2056), (5, 8), (3, 16384)):
            x = _x(gen, n, c)
            variants = plans10 if c == 6144 else [(None, 1), (None, 3)]
            for t, g in variants:
                plan = rq.row_plan(n, c, x.dtype, threads=t, groups=g)
                cases.append((f"K10 ({n},{c}) bf16 threads={plan.threads} vectors={plan.vectors} "
                              f"groups={g}", lambda x=x, p=plan: rq.gelu_quant(x, p),
                              lambda x=x: fused_gelu_quant(x)))
        for n, c in ((50, 6144), (70, 8192)):
            x = _x(gen, n, c, dtype=torch.float32)
            cases.append((f"K10 ({n},{c}) fp32", lambda x=x: fused_gelu_quant(x),
                          lambda x=x: fused_gelu_quant(x)))
    if "K13" in kernels:
        for b, n, c in K13_SHAPES + ((3, 77, 4096), (1, 5, 16384), (4, 9, 8)):
            x, (sc, sh) = _x(gen, b, n, c), _mod(gen, b, c)
            for g in ((1, 2, 4, 8) if c == 1536 else (1, 3)):
                plan = rq.row_plan(b * n, c, x.dtype, samples=b, groups=g)
                cases.append((f"K13 ({b},{n},{c}) bf16, (B,1,6C) chunks, threads={plan.threads} "
                              f"vectors={plan.vectors} groups={g}",
                              lambda x=x, sc=sc, sh=sh, p=plan: rq.adaln_quant(x, sc, sh, 1e-6, p),
                              lambda x=x, sc=sc, sh=sh: fused_adaln_quant(x, sc, sh)))
        # fp32 x and (B, C) fp32 modulation; a column-strided (B, C) shift
        b, n, c = K13_SHAPES[0]
        x = _x(gen, b, n, c, dtype=torch.float32)
        sc = 0.1 * torch.randn((b, c), generator=gen, device="cuda")
        sh = (0.1 * torch.randn((c, b), generator=gen, device="cuda")).t()
        cases.append((f"K13 ({b},{n},{c}) fp32, (B,C) fp32, shift column stride {sh.stride(1)}",
                      lambda: fused_adaln_quant(x, sc, sh), lambda: fused_adaln_quant(x, sc, sh)))
    if "K7" in kernels:
        for n, w in K7_SHAPES + ((333, 2576), (5, 16), (3, 16384)):
            x = _x(gen, n, w)
            plans = (_plans(n, w // 2, x.dtype, (64, 128, 256), (1, 2, 4), inputs=2)
                     if (n, w) == K7_SHAPES[0] else [rq.row_plan(n, w // 2, x.dtype, inputs=2)])
            for plan in plans:
                cases.append((f"K7 ({n},{w}) bf16 threads={plan.threads} vectors={plan.vectors} "
                              f"groups={plan.groups}", lambda x=x, p=plan: rq.geglu_quant(x, p),
                              lambda x=x: fused_geglu_quant(x)))
        for n, w in ((77, 2048), (9, 8192)):
            x = _x(gen, n, w, dtype=torch.float32)
            cases.append((f"K7 ({n},{w}) fp32", lambda x=x: fused_geglu_quant(x),
                          lambda x=x: fused_geglu_quant(x)))
    if "K6" in kernels:
        cases += _k6_cases(gen)
    if "K11" in kernels:
        cases += _k11_cases(gen)
    if "K5" in kernels:
        extra = (((2, 64, 16, 16), True, 1e-5, 0.0, 1.0, torch.float32),
                 ((3, 40, 7, 9), True, 1e-5, 0.5, 1.0, torch.bfloat16),
                 ((8, 320, 64, 64), True, 1e-5, 0.0, 0.05, torch.bfloat16),
                 ((8, 320, 64, 64), False, 1e-6, 4.0, 1.0, torch.float32))
        for shape, silu, eps, mean, gain, dt in (
                [(sh, si, ep, 4.0 if sh[0] == 4 else 0.0, 1.0, torch.bfloat16)
                 for sh, si, ep in K5_SHAPES] + list(extra)):
            x, w, b = _gn_inputs(gen, shape, mean=mean, gain=gain, dtype=dt)
            groups = 32 if shape[1] % 32 == 0 else 8
            plain = (lambda x=x, w=w, b=b, g=groups, e=eps, si=silu:
                     fused_group_norm_quant(x, w, b, g, e, si))
            label = (f"K5 {shape} {str(dt)[6:]} {'silu' if silu else 'no silu'} eps={eps} "
                     f"mean={mean} gain={gain}")
            forced = [dict()]
            if shape in ((8, 320, 64, 64), (8, 2560, 8, 8)) and dt == torch.bfloat16 and gain == 1:
                forced += [dict(k=k) for k in gq.KS[dt]]
            for f in forced:
                plan = _gn_plan(x, silu, **f) if groups == 32 else None
                tag = f"K={plan.k} bps={plan.bps}" if plan else "plan"
                cases.append((f"{label} {tag}",
                              lambda x=x, w=w, b=b, g=groups, e=eps, si=silu, p=plan:
                              gq.gn_quant(x, w, b, g, e, si, p), plain))
    return cases


def _plans(rows, c, dtype, threads, groups, samples=1, inputs=1):
    """The plans of `row_plan` at each (threads, groups) that can hold the
    row."""
    plans = []
    for t, g in itertools.product(threads, groups):
        try:
            plans.append(rq.row_plan(rows, c, dtype, samples=samples, threads=t, groups=g,
                                     inputs=inputs))
        except ValueError:
            continue  # too few threads for the row
    return plans


def _k6_cases(gen):
    """K6 at its path rows at every plan swept; fp32, ragged, 32 KB rows, a
    bf16 and a column-strided affine at the default plan."""
    cases = []
    for n, c, eps in K6_SHAPES:
        x, w, b = _ln_inputs(gen, n, c)
        for plan in [None] + _plans(n, c, x.dtype, K6_THREADS, (1, 2, 4)):
            tag = "plan" if plan is None else (f"threads={plan.threads} vectors={plan.vectors} "
                                               f"groups={plan.groups}")
            cases.append((f"K6 ({n},{c}) eps={eps} bf16 {tag}",
                          lambda x=x, w=w, b=b, e=eps, p=plan: rq.ln_quant(x, w, b, e, p),
                          lambda x=x, w=w, b=b, e=eps: fused_layer_norm_quant(x, w, b, e)))
    for n, c, dt, form in ((77, 320, torch.float32, "fp32"), (33, 768, torch.float32, "fp32"),
                           (37, 328, torch.bfloat16, "ragged"), (5, 8, torch.bfloat16, "ragged"),
                           (3, 16384, torch.bfloat16, "32 KB rows"),
                           (300, 640, torch.bfloat16, "bf16 affine"),
                           (300, 640, torch.bfloat16, "strided affine")):
        x, w, b = _ln_inputs(gen, n, c, dtype=dt)
        if form == "bf16 affine":
            w, b = w.bfloat16(), b.bfloat16()
        elif form == "strided affine":  # column stride 2
            w, b = (torch.stack([t, t], dim=1).reshape(-1)[::2] for t in (w, b))
        cases.append((f"K6 ({n},{c}) {str(dt)[6:]} {form}",
                      lambda x=x, w=w, b=b: fused_layer_norm_quant(x, w, b),
                      lambda x=x, w=w, b=b: fused_layer_norm_quant(x, w, b)))
    return cases


def _k11_cases(gen):
    """K11 on both attention slices at every plan swept; contiguous rows,
    fp32 slices, ragged, 32 KB rows and a batch-1 slice at the default
    plan."""
    cases = []
    b, n_h, n_c, c = K11_SLICES
    for x in _attn(gen, b, n_h, n_c, c):
        n = x.shape[1]
        for plan in [None] + _plans(b * n, c, x.dtype, (32, 64, 128), (1, 2, 4), samples=b):
            tag = "plan" if plan is None else (f"threads={plan.threads} vectors={plan.vectors} "
                                               f"groups={plan.groups}")
            cases.append((f"K11 {tuple(x.shape)} slice bf16 {tag}",
                          lambda x=x, p=plan: rq.quant_rows(x, p),
                          lambda x=x: fused_quant_rows(x)))
    others = [("(8192,1536) contiguous", _x(gen, 8192, 1536)),
              ("(666,1536) contiguous", _x(gen, 666, 1536)),
              ("(37,2056) ragged", _x(gen, 37, 2056)), ("(3,16384) 32 KB rows", _x(gen, 3, 16384))]
    others += [(f"{tuple(x.shape)} fp32 slice", x)
               for x in _attn(gen, 2, 77, 154, 1536, dtype=torch.float32)]
    others += [(f"{tuple(x.shape)} batch-1 slice", x) for x in _attn(gen, 1, 4096, 333, 1536)]
    for label, x in others:
        cases.append((f"K11 {label}", lambda x=x: fused_quant_rows(x),
                      lambda x=x: fused_quant_rows(x)))
    return cases


def check(gen, _iters, kernels):
    """The quotient bit for bit; the kernels against their plain versions."""
    failed = _check_division(gen, kernels)
    for label, kernel, plain in _kernel_cases(gen, kernels):
        out = kernel()
        with plain_ops():
            xs = plain()
        torch.cuda.synchronize()
        ok, msg = _within(out, (xs[0], xs[1].float()))
        again = kernel()
        repeat = torch.equal(out[0], again[0]) and torch.equal(out[1], again[1])
        launches = device_launches(kernel, iters=3)
        ok = ok and repeat and launches == 1
        print(f"[quant_tune] check {label}: {msg}; repeat bit-equal {repeat}; "
              f"{launches} device launches per call: {'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            failed.append(label)
    if failed:
        raise RuntimeError(f"quant_tune check failed: {failed}")


# ---- time ----------------------------------------------------------------


def _cold(make, nbytes):
    """A call that rotates through enough copies of the inputs (`make()`
    gives one set) to hold more than COLD_BYTES."""
    copies = max(2, int(-(-COLD_BYTES // nbytes)))
    sets = itertools.cycle([make() for _ in range(copies)])
    return lambda fn: (lambda: fn(*next(sets)))


def _tanhf_lib():
    lib, _ = _build("row_quant_tanhf.so", _tanhf_source(), "-shared", "-Xcompiler", "-fPIC")
    fn = ctypes.CDLL(lib).pd_row_quant
    fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64]
                   + [ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64] * 2
                   + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int

    def gelu_quant(x):
        n, c = x.shape
        plan = rq.row_plan(n, c, x.dtype)
        codes = torch.empty((n, c), dtype=torch.int8, device="cuda")
        scales = torch.empty((n,), dtype=torch.float32, device="cuda")
        err = fn(rq.GELU, x.data_ptr(), 1, n * c, c, 1, n, c, None, 0, 0, 0, None, 0, 0, 0, 0.0,
                 plan.threads, plan.vectors, plan.groups, plan.grid[0], codes.data_ptr(),
                 scales.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"tanhf build launch failed: {err}")
        return codes, scales

    return gelu_quant


def _turns(label, bound, parent, new, iters, launches=(None, None), timer=None):
    """Parent and new in turns, by `timer(fn, iters)` or else
    `timing.device_ms` with `launches`, the device activities of a parent
    and of a new call where known."""
    times = {"parent": [], "new": []}
    for who in ("parent", "new", "new", "parent"):
        fn = parent if who == "parent" else new
        times[who].append(timer(fn, iters) if timer else
                          device_ms(fn, iters=iters, launches=launches[who == "new"]))
    best = min(times["new"])
    return (f"{label}: parent={'/'.join(f'{t:.4f}' for t in times['parent'])} "
            f"new={'/'.join(f'{t:.4f}' for t in times['new'])} "
            f"share_of_bound={bound / best:.3f}")


def time_(gen, iters, kernels):
    """Parent and new in turns, warm and cold; the plan sweep; tanhf."""
    if "K10" in kernels:
        tanhf = _tanhf_lib()
        for n, c in K10_SHAPES:
            nbytes = 3 * n * c + 4 * n
            bound = nbytes / HBM_BYTES_S * 1e3
            x = _x(gen, n, c)
            with plain_ops():
                ref = fused_gelu_quant(x)
            parent = _within(_parent_gelu_quant(x), ref)[1]
            copy = _within(tanhf(x), (ref[0].view(n, c), ref[1].view(n)))[1]
            print(f"[quant_tune] parity K10 ({n},{c}): parent {parent}; tanhf {copy}", flush=True)
            cold = _cold(lambda: (_x(gen, n, c),), nbytes)
            warm = _turns("warm", bound, lambda: _parent_gelu_quant(x),
                          lambda: fused_gelu_quant(x), iters)
            colds = _turns("cold", bound, cold(_parent_gelu_quant), cold(fused_gelu_quant), iters)
            print(f"[quant_tune] time K10 ({n},{c}) bound_ms={bound:.4f} (bytes) | {warm} | "
                  f"{colds}", flush=True)
            sweep = []
            for t, g in [(t, g) for t in (128, 256) for g in (1, 2, 4)]:
                plan = rq.row_plan(n, c, x.dtype, threads=t, groups=g)
                call = cold(lambda x, p=plan: rq.gelu_quant(x, p))
                sweep.append(f"threads={t} groups={g}: {device_ms(call, iters=iters):.4f}")
            sweep.append(f"tanhf: {device_ms(cold(tanhf), iters=iters):.4f}")
            print(f"[quant_tune] sweep K10 ({n},{c}) cold: " + "; ".join(sweep), flush=True)
    if "K13" in kernels:
        for b, n, c in K13_SHAPES:
            nbytes = 3 * b * n * c + 4 * b * n + 2 * 2 * b * c
            bound = nbytes / HBM_BYTES_S * 1e3
            x, (sc, sh) = _x(gen, b, n, c), _mod(gen, b, c)
            with plain_ops():
                ref = fused_adaln_quant(x, sc, sh)
            print(f"[quant_tune] parity K13 ({b},{n},{c}): parent "
                  f"{_within(_parent_adaln_quant(x, sc, sh), ref)[1]}", flush=True)
            cold = _cold(lambda: (_x(gen, b, n, c), *_mod(gen, b, c)), nbytes)
            warm = _turns("warm", bound, lambda: _parent_adaln_quant(x, sc, sh),
                          lambda: fused_adaln_quant(x, sc, sh), iters)
            colds = _turns("cold", bound, cold(_parent_adaln_quant), cold(fused_adaln_quant), iters)
            print(f"[quant_tune] time K13 ({b},{n},{c}) (B,1,6C) chunks bound_ms={bound:.4f} "
                  f"(bytes) | {warm} | {colds}", flush=True)
            sweep = []
            for g in (1, 2, 4, 8):
                plan = rq.row_plan(b * n, c, x.dtype, samples=b, groups=g)
                call = cold(lambda x, s, t, p=plan: rq.adaln_quant(x, s, t, 1e-6, p))
                sweep.append(f"groups={g}: {device_ms(call, iters=iters):.4f}")
            print(f"[quant_tune] sweep K13 ({b},{n},{c}) cold: " + "; ".join(sweep), flush=True)
    if "K7" in kernels:
        _time_k7(gen, iters)
    if "K5" in kernels:
        _time_k5(gen, iters)
    if "K6" in kernels:
        _time_k6(gen, iters)
    if "K11" in kernels:
        _time_k11(gen, iters)
    if "K3" in kernels:
        _time_k3(gen, iters)
    if "K9p" in kernels:
        _time_k9p(gen, iters)
    if "K12" in kernels:
        _time_k12(gen, iters)
    if "K12b" in kernels:
        _time_k12b(gen, iters)


def _stream(fn, iters):
    """`timing.stream_ms`, best of two: K3's and K9p's A/B reads no
    profiler trace (traces of these runs lost activities, PERF.md)."""
    return min(stream_ms(fn, iters=iters) for _ in range(2))


def _time_k3(gen, iters):
    """K3 against its parent's three Triton programs; the sweep of K,
    L2-cold; all by `stream_ms`."""
    from prompt_diffusion_tpu_torch.ops import gn_quant as gq
    from prompt_diffusion_tpu_torch.ops.fused_group_norm import fused_group_norm

    for shape, act, eps, mean in K3_SHAPES:
        bsz, c, h, w = shape
        nbytes = 4 * bsz * c * h * w + 8 * c
        bound = nbytes / HBM_BYTES_S * 1e3
        x, wt, bs = _gn_inputs(gen, shape, mean=mean)
        silu, relu = act == "silu", act == "relu"
        new = lambda x, w, b: fused_group_norm(x, w, b, 32, eps, silu, relu)
        parent = lambda x, w, b: _parent_gn(x, w, b, eps, act)
        with plain_ops():
            ref = new(x.float(), wt, bs)
        errs = [(f(x, wt, bs).float() - ref).abs().max().item() for f in (parent, new)]
        launches = [device_launches(lambda f=f: f(x, wt, bs)) for f in (parent, new)]
        print(f"[quant_tune] parity K3 {shape} {act}: max abs error against the plain version "
              f"in fp32: parent {errs[0]}, new {errs[1]}; device launches per call: parent "
              f"{launches[0]}, new {launches[1]}", flush=True)
        cold = _cold(lambda: _gn_inputs(gen, shape, mean=mean), nbytes)
        warm = _turns("warm", bound, lambda: parent(x, wt, bs), lambda: new(x, wt, bs), iters,
                      timer=_stream)
        colds = _turns("cold", bound, cold(parent), cold(new), iters, timer=_stream)
        plan = _k3_plan(x, act)
        print(f"[quant_tune] time K3 {shape} {act} bound_ms={bound:.4f} (bytes) plan K={plan.k} "
              f"threads={plan.threads} bps={plan.bps} "
              f"blocks/SM={plan.blocks_per_sm} chunks/block<={-(-plan.chunks // plan.bps)} "
              f"| {warm} | {colds}", flush=True)
        sweep = []
        for k in gq.KS[x.dtype]:
            p = _k3_plan(x, act, k=k)
            call = cold(lambda x, w, b, p=p: gq.gn_float(x, w, b, 32, eps, K3_ACTS[act], p))
            sweep.append(f"K={p.k} (bps={p.bps}): {_stream(call, iters):.4f}")
        print(f"[quant_tune] sweep K3 {shape} {act} cold: " + "; ".join(sweep), flush=True)


def _k9_on(q, codes, scales, v, heads):
    """K9's attention kernel on given K codes and (B, H) scales, at the
    scale and query tile `flash_attention_packed_int8` takes."""
    from prompt_diffusion_tpu_torch.ops import flash_attention as fa
    from prompt_diffusion_tpu_torch.ops._build import cuda_ext

    b, nq, hd = q.shape
    out = torch.empty((b, nq, hd), dtype=q.dtype, device=q.device)
    cuda_ext().int8_attention_fwd(
        q.data_ptr(), codes.data_ptr(), scales.data_ptr(), False, v.data_ptr(), out.data_ptr(),
        b, heads, nq, codes.shape[1], hd // heads, q.stride(0), q.stride(1), codes.stride(0),
        codes.stride(1), v.stride(0), v.stride(1), out.stride(0), out.stride(1),
        (hd // heads) ** -0.5, fa.int8_block_q(nq), torch.cuda.current_stream().cuda_stream)
    return out


def _time_k9p(gen, iters):
    """K9p against its parent (PARENT_K9P), bit for bit and in turns; the
    sweep of its blocks per SM, L2-cold; all by `stream_ms`."""
    from prompt_diffusion_tpu_torch.ops import flash_attention as fa

    parent = _parent_k9p()
    dev = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for (b, n, hd), h, row in K9P_SHAPES:
        make = lambda: (_x(gen, b, n, row)[..., hd:2 * hd] if row != hd else _x(gen, b, n, hd),)
        nbytes = 3 * b * n * hd + 4 * b * h
        bound = nbytes / HBM_BYTES_S * 1e3
        (k,) = make()
        with plain_ops():
            ref = fa.quant_k_int8(k, h)
        equal = [all(torch.equal(a, r) for a, r in zip(f(k, h), ref))
                 for f in (parent, fa.quant_k_int8)]
        launches = [device_launches(lambda f=f: f(k, h)) for f in (parent, fa.quant_k_int8)]
        label = f"({b},{n},{hd}) H={h}" + (f" K slice of ({b},{n},{row})" if row != hd else "")
        q, v = _x(gen, b, n, hd), _x(gen, b, n, hd)
        k9_equal = torch.equal(fa.flash_attention_packed_int8(q, k, v, h),
                               _k9_on(q, *parent(k, h), v, h))
        print(f"[quant_tune] parity K9p {label}: bit-equal to the plain version: parent "
              f"{equal[0]}, new {equal[1]}; K9's output bit-equal to K9 on the parent's codes "
              f"{k9_equal}; device operations per call: parent {launches[0]}, new "
              f"{launches[1]}", flush=True)
        cold = _cold(make, nbytes)
        new = lambda k: fa.quant_k_int8(k, h)
        old = lambda k: parent(k, h)
        warm = _turns("warm", bound, lambda: old(k), lambda: new(k), iters, timer=_stream)
        colds = _turns("cold", bound, cold(old), cold(new), iters, timer=_stream)
        occ = lambda t: fa._quant_k_occupancy(dev, hd // h, t)
        plan = fa.quant_k_plan(b, n, h, hd // h, occupancy=occ, sms=sms)
        print(f"[quant_tune] time K9p {label} bound_ms={bound:.4f} (bytes) plan "
              f"threads={plan.threads} rows={plan.rows} bps={plan.bps} "
              f"blocks/SM={plan.blocks_per_sm} (occupancy {occ(plan.threads)}) | {warm} | "
              f"{colds}", flush=True)
        sweep = []
        for per_sm in (1, 2, 4, 8, 16):
            p = fa._quant_k_plan(b, n, h, hd // h, plan.cv, plan.rows, plan.threads,
                                 occ(plan.threads), sms, per_sm)
            call = cold(lambda k, p=p: fa._quant_k_head(k, p))
            sweep.append(f"blocks/SM={p.blocks_per_sm} (bps={p.bps}): {_stream(call, iters):.4f}")
        print(f"[quant_tune] sweep K9p {label} cold: " + "; ".join(sweep), flush=True)


def _k12_mod(gen, b, c, n, dtype=torch.bfloat16):
    """K12's scale and shift at a stream: (B, 1, C) chunks of one (B, 1, 6C)
    projection at the image stream, (B, C) ones at the context stream."""
    sc, sh = _mod(gen, b, c, dtype)
    return (sc, sh) if n > 1000 else (sc[:, 0], sh[:, 0])


def _time_k12(gen, iters):
    """K12's forward against the parent's Triton program, warm and cold;
    the sweep of its row groups, cold."""
    from prompt_diffusion_tpu_torch.ops.fused_adaln import fused_adaln

    for b, n, c in K13_SHAPES:
        nbytes = 4 * b * n * c + 2 * 2 * b * c
        bound = nbytes / HBM_BYTES_S * 1e3
        x, (sc, sh) = _x(gen, b, n, c), _k12_mod(gen, b, c, n)
        with plain_ops():
            ref = fused_adaln(x.float(), sc.float(), sh.float())
        errs = [(f(x, sc, sh).float() - ref).abs().max().item() for f in (_parent_adaln,
                                                                          fused_adaln)]
        launches = [device_launches(lambda f=f: f(x, sc, sh)) for f in (_parent_adaln,
                                                                         fused_adaln)]
        print(f"[quant_tune] parity K12 ({b},{n},{c}): max abs error against the plain version "
              f"in fp32: parent {errs[0]}, new {errs[1]}; device launches per call: parent "
              f"{launches[0]}, new {launches[1]}", flush=True)
        cold = _cold(lambda: (_x(gen, b, n, c), *_k12_mod(gen, b, c, n)), nbytes)
        warm = _turns("warm", bound, lambda: _parent_adaln(x, sc, sh),
                      lambda: fused_adaln(x, sc, sh), iters)
        colds = _turns("cold", bound, cold(_parent_adaln), cold(fused_adaln), iters)
        print(f"[quant_tune] time K12 ({b},{n},{c}) bound_ms={bound:.4f} (bytes) | {warm} | "
              f"{colds}", flush=True)
        sweep = []
        for g in (1, 2, 4, 8):
            plan = rq.row_plan(b * n, c, x.dtype, samples=b, groups=g)
            call = cold(lambda x, s, t, p=plan: rq.adaln(x, s, t, 1e-6, p))
            sweep.append(f"groups={g}: {device_ms(call, iters=iters):.4f}")
        print(f"[quant_tune] sweep K12 ({b},{n},{c}) cold: " + "; ".join(sweep), flush=True)


def _time_k12b(gen, iters):
    """K12's backward alone against the parent's (autograd of the plain
    version), warm and cold; the sweep of threads per row and blocks per
    SM, cold."""
    from prompt_diffusion_tpu_torch.ops.fused_adaln import _torch_adaln_bwd, fused_adaln_bwd

    dev = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for (b, n, c), dtype in K12B_SHAPES:
        size = torch.empty((), dtype=dtype).element_size()
        nbytes = 3 * size * b * n * c + 3 * size * b * c
        bound = nbytes / HBM_BYTES_S * 1e3
        make = lambda: (_x(gen, b, n, c, dtype=dtype), *_k12_mod(gen, b, c, n, dtype),
                        _x(gen, b, n, c, dtype=dtype))
        x, sc, sh, g = make()
        new = lambda x, sc, sh, g: fused_adaln_bwd(x, sc, g, 1e-6, sh)
        ref = _torch_adaln_bwd(x.float(), sc.float(), g.float(), 1e-6)
        errs = [[(a.float() - r).abs().max().item() for a, r in zip(f(x, sc, sh, g), ref)]
                for f in (_parent_adaln_bwd, new)]
        launches = [device_launches(lambda f=f: f(x, sc, sh, g)) for f in (_parent_adaln_bwd,
                                                                            new)]
        label = f"({b},{n},{c}) {str(dtype)[6:]}"
        print(f"[quant_tune] parity K12b {label}: max abs error of dx, dscale, dshift against "
              f"the plain backward in fp32 (largest {[r.abs().max().item() for r in ref]}): "
              f"parent {errs[0]}, new {errs[1]}; device launches per call: parent "
              f"{launches[0]}, new {launches[1]}", flush=True)
        cold = _cold(make, nbytes)
        warm = _turns("warm", bound, lambda: _parent_adaln_bwd(x, sc, sh, g),
                      lambda: new(x, sc, sh, g), iters)
        colds = _turns("cold", bound, cold(_parent_adaln_bwd), cold(new), iters)
        bf16 = dtype == torch.bfloat16
        occ = lambda v: rq._bwd_occupancy(dev, bf16, v, c)
        plan = rq.adaln_bwd_plan(b, n, c, dtype, occupancy=occ, sms=sms)
        print(f"[quant_tune] time K12b {label} bound_ms={bound:.4f} (bytes) plan "
              f"threads={plan.row.threads} vectors={plan.row.vectors} groups={plan.row.groups} "
              f"bps={plan.bps} blocks/SM={plan.blocks_per_sm} lanes={plan.merge_lanes} | "
              f"{warm} | {colds}", flush=True)
        sweep = []
        for threads, per_sm in itertools.product((32, 64, 128, 256), (1, 2)):
            try:
                p = rq.adaln_bwd_plan(b, n, c, dtype, occupancy=occ, sms=sms, threads=threads,
                                      per_sm=per_sm)
            except ValueError as err:
                sweep.append(f"threads={threads} blocks/SM<={per_sm}: {err}")
                continue
            call = cold(lambda x, s, t, g, p=p: rq.adaln_bwd(x, s, g, 1e-6, t, p))
            sweep.append(f"threads={threads} vectors={p.row.vectors} blocks/SM={p.blocks_per_sm} "
                         f"(groups={p.row.groups}, bps={p.bps}): "
                         f"{device_ms(call, iters=iters):.4f}")
        print(f"[quant_tune] sweep K12b {label} cold: " + "; ".join(sweep), flush=True)


def _time_k6(gen, iters):
    for n, c, eps in K6_SHAPES:
        nbytes = 3 * n * c + 4 * n + 8 * c
        bound = nbytes / HBM_BYTES_S * 1e3
        x, w, b = _ln_inputs(gen, n, c)
        new = lambda x, w, b: fused_layer_norm_quant(x, w, b, eps)
        parent = lambda x, w, b: _parent_ln_quant(x, w, b, eps)
        with plain_ops():
            ref = new(x, w, b)
        print(f"[quant_tune] parity K6 ({n},{c}): parent {_within(parent(x, w, b), ref)[1]}",
              flush=True)
        cold = _cold(lambda: _ln_inputs(gen, n, c), nbytes)
        warm = _turns("warm", bound, lambda: parent(x, w, b), lambda: new(x, w, b), iters)
        colds = _turns("cold", bound, cold(parent), cold(new), iters)
        plan = rq.row_plan(n, c, x.dtype)
        print(f"[quant_tune] time K6 ({n},{c}) eps={eps} bound_ms={bound:.4f} (bytes) plan "
              f"threads={plan.threads} vectors={plan.vectors} groups={plan.groups} | {warm} | "
              f"{colds}", flush=True)
        call = lambda p: cold(lambda x, w, b: rq.ln_quant(x, w, b, eps, p))
        sweep = [f"threads={p.threads} groups={p.groups}: "
                 f"{device_ms(call(p), iters=iters):.4f}"
                 for p in _plans(n, c, x.dtype, K6_THREADS, (1, 2, 4))]
        print(f"[quant_tune] sweep K6 ({n},{c}) cold: " + "; ".join(sweep), flush=True)


def _time_k11(gen, iters):
    """K11 on the MMDiT's slices; the parent as its wrapper ran there, with
    the copy of the slice to contiguous rows."""
    b, n_h, n_c, c = K11_SLICES
    for i, n in enumerate((n_h, n_c)):
        nbytes = 3 * b * n * c + 4 * b * n
        bound = nbytes / HBM_BYTES_S * 1e3
        x = _attn(gen, b, n_h, n_c, c)[i]
        with plain_ops():
            ref = fused_quant_rows(x)
        print(f"[quant_tune] parity K11 {tuple(x.shape)} slice: parent "
              f"{_within(_parent_quant_rows(x), ref)[1]}; device launches per call: parent "
              f"{device_launches(lambda: _parent_quant_rows(x))}, new "
              f"{device_launches(lambda: fused_quant_rows(x))}", flush=True)
        cold = _cold(lambda: (_attn(gen, b, n_h, n_c, c)[i],), nbytes)
        # the parent's copy and program: a trace that lost one of them would
        # read short (seen on the H100)
        warm = _turns("warm", bound, lambda: _parent_quant_rows(x), lambda: fused_quant_rows(x),
                      iters, launches=(2, 1))
        colds = _turns("cold", bound, cold(_parent_quant_rows), cold(fused_quant_rows), iters,
                       launches=(2, 1))
        plan = rq.row_plan(b * n, c, x.dtype, samples=b)
        print(f"[quant_tune] time K11 {tuple(x.shape)} slice of {(b, n_h + n_c, c)} "
              f"bound_ms={bound:.4f} (bytes) plan threads={plan.threads} groups={plan.groups} | "
              f"{warm} | {colds}", flush=True)
        sweep = [f"threads={p.threads} groups={p.groups}: "
                 f"{device_ms(cold(lambda x, p=p: rq.quant_rows(x, p)), iters=iters):.4f}"
                 for p in _plans(b * n, c, x.dtype, (32, 64, 128), (1, 2, 4), samples=b)]
        print(f"[quant_tune] sweep K11 {tuple(x.shape)} slice cold: " + "; ".join(sweep),
              flush=True)


def _time_k7(gen, iters):
    from prompt_diffusion_tpu_torch.ops.fused_act import fused_geglu_quant

    for n, w in K7_SHAPES:
        nbytes = 2 * n * w + n * w // 2 + 4 * n
        bound = nbytes / HBM_BYTES_S * 1e3
        x = _x(gen, n, w)
        with plain_ops():
            ref = fused_geglu_quant(x)
        print(f"[quant_tune] parity K7 ({n},{w}): parent "
              f"{_within(_parent_geglu_quant(x), ref)[1]}", flush=True)
        cold = _cold(lambda: (_x(gen, n, w),), nbytes)
        warm = _turns("warm", bound, lambda: _parent_geglu_quant(x),
                      lambda: fused_geglu_quant(x), iters)
        colds = _turns("cold", bound, cold(_parent_geglu_quant), cold(fused_geglu_quant), iters)
        print(f"[quant_tune] time K7 ({n},{w}) bound_ms={bound:.4f} (bytes) | {warm} | {colds}",
              flush=True)
        sweep = [f"threads={p.threads} groups={p.groups}: "
                 f"{device_ms(cold(lambda x, p=p: rq.geglu_quant(x, p)), iters=iters):.4f}"
                 for p in _plans(n, w // 2, x.dtype, (64, 128, 256), (1, 2, 4), inputs=2)]
        print(f"[quant_tune] sweep K7 ({n},{w}) cold: " + "; ".join(sweep), flush=True)


def _time_k5(gen, iters):
    from prompt_diffusion_tpu_torch.ops import gn_quant as gq
    from prompt_diffusion_tpu_torch.ops.fused_group_norm import fused_group_norm_quant

    for shape, silu, eps in K5_SHAPES:
        mean = 4.0 if shape[0] == 4 else 0.0
        numel = shape[0] * shape[1] * shape[2] * shape[3]
        nbytes = 3 * numel + 4 * shape[0]
        bound = nbytes / HBM_BYTES_S * 1e3
        x, w, b = _gn_inputs(gen, shape, mean=mean)
        with plain_ops():
            ref = fused_group_norm_quant(x, w, b, 32, eps, silu)
        parent = lambda x, w, b: _parent_gn_quant(x, w, b, eps, silu)
        new = lambda x, w, b: fused_group_norm_quant(x, w, b, 32, eps, silu)
        print(f"[quant_tune] parity K5 {shape}: parent {_within(parent(x, w, b), ref)[1]}; "
              f"device launches per call: parent {device_launches(lambda: parent(x, w, b))}, "
              f"new {device_launches(lambda: new(x, w, b))}", flush=True)
        cold = _cold(lambda: _gn_inputs(gen, shape, mean=mean), nbytes)
        warm = _turns("warm", bound, lambda: parent(x, w, b), lambda: new(x, w, b), iters)
        colds = _turns("cold", bound, cold(parent), cold(new), iters)
        plan = _gn_plan(x, silu)
        print(f"[quant_tune] time K5 {shape} {'silu' if silu else 'no silu'} bound_ms={bound:.4f} "
              f"(bytes) plan K={plan.k} threads={plan.threads} bps={plan.bps} "
              f"blocks/SM={plan.blocks_per_sm} chunks/block<={-(-plan.chunks // plan.bps)} "
              f"| {warm} | {colds}", flush=True)
        sweep = []
        for k in gq.KS[x.dtype]:
            p = _gn_plan(x, silu, k=k)
            call = cold(lambda x, w, b, p=p: gq.gn_quant(x, w, b, 32, eps, silu, p))
            sweep.append(f"K={k} (bps={p.bps}): {device_ms(call, iters=iters):.4f}")
        print(f"[quant_tune] sweep K5 {shape} cold: " + "; ".join(sweep), flush=True)


# ---- phases (K5, K3) --------------------------------------------------------

# the phase that ends at each stamp of `gn_quant.cu` (GN_STAMP(i)); slots 0
# and STAMP_SLOTS - 1 hold each block's first and last %globaltimer (ns)
STAMP_SLOTS = 16
K5_PHASES = {1: "reads and statistics", 2: "block merge", 3: "barrier 1",
             4: "sample merge and terms", 5: "amax", 6: "barrier 2", 7: "scale", 8: "codes"}
K3_PHASES = {1: "reads and statistics", 2: "block merge", 3: "barrier",
             4: "sample merge and terms", 5: "apply"}
NO_SILU_CODES = ("          const float z = epilogue<ACT>(fmaf(f[e], sc[e], sh[e]));",
                 "          const float z = fmaf(f[e], sc[e], sh[e]);")


def _gn_copy(name, edits, *flags):
    """A ctypes handle on a copy of gn_quant.cu with (old, new) edits, built
    with `flags`."""
    src = open(GN_SOURCE).read()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"the {name} edit no longer matches gn_quant.cu: {old[:40]!r}")
        src = src.replace(old, new, 1)
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"gn_quant_{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    so = ctypes.CDLL(_build(f"gn_quant_{name}.so", path, "-shared", "-Xcompiler", "-fPIC",
                            *flags)[0])
    so.pd_gn_quant.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                               + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 6
                               + [ctypes.c_void_p])
    so.pd_gn_float.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                               + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 6
                               + [ctypes.c_void_p])
    so.pd_gn_quant_occupancy.argtypes = so.pd_gn_float_occupancy.argtypes = [ctypes.c_int] * 5
    return so


def _gn_call(so, x, w, b, eps, act, quant):
    """(plan, a call of K5 (quant) or K3 through `so` on x)."""
    from prompt_diffusion_tpu_torch.ops import gn_quant as gq

    bsz, c, h, wd = x.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    if quant:
        occ = lambda k, t, m: so.pd_gn_quant_occupancy(1, k, int(act == "silu"), t, m)
        plan = gq.gn_plan(bsz, c, h * wd, 32, torch.bfloat16, occupancy=occ, sms=sms)
        out = (torch.empty_like(x, dtype=torch.int8), torch.empty(bsz, device="cuda"))
    else:
        occ = lambda k, t, m: so.pd_gn_float_occupancy(1, k, K3_ACTS[act], t, m)
        plan = gq.gn_float_plan(bsz, c, h * wd, 32, torch.bfloat16, occupancy=occ, sms=sms)
        out = (torch.empty_like(x),)
    ws = torch.empty(plan.workspace, device="cuda")
    ptrs = (x.data_ptr(), 1, w.data_ptr(), b.data_ptr(), *(t.data_ptr() for t in out),
            ws.data_ptr(), bsz, h * wd, c, 32, eps)
    if quant:
        args = ptrs + (int(act == "silu"), plan.k, plan.rows, plan.threads, plan.chunks,
                       plan.bps, stream)
        return plan, lambda: so.pd_gn_quant(*args)
    args = ptrs + (K3_ACTS[act], plan.k, plan.rows, plan.threads, plan.chunks, plan.bps,
                   stream)
    return plan, lambda: so.pd_gn_float(*args)


def _phase_line(stamped, plan, run, phases):
    """Each phase's mean cycles a block and share; the blocks' mean span,
    the kernel's span and the spread of the blocks' starts in µs."""
    st = torch.zeros(plan.grid * STAMP_SLOTS, dtype=torch.int64)
    stamped.pd_gn_read_stamps(st.data_ptr(), st.numel())  # zeroes the slots
    if run():
        raise RuntimeError("the stamped copy's launch failed")
    torch.cuda.synchronize()
    stamped.pd_gn_read_stamps(st.data_ptr(), st.numel())
    st = st.view(plan.grid, STAMP_SLOTS).double()
    cycles = {i: st[:, i].mean().item() for i in phases}
    total = sum(cycles.values())
    start, end = st[:, 0], st[:, STAMP_SLOTS - 1]
    return (f"{total:.0f} cycles a block (mean): "
            + ", ".join(f"{phases[i]} {cycles[i]:.0f} ({100 * cycles[i] / total:.0f}%)"
                        for i in phases)
            + f"; block span {(end - start).mean().item() / 1e3:.2f} µs (mean), kernel span "
            f"{(end.max() - start.min()).item() / 1e3:.2f} µs, block starts spread over "
            f"{(start.max() - start.min()).item() / 1e3:.2f} µs; grid {plan.grid} blocks of "
            f"{plan.threads} threads")


def phases(gen, iters, kernels):
    """K5's and K3's cycles by phase; K5's time without SiLU in the codes
    pass."""
    if not kernels & {"K5", "K3"}:
        return
    stamped = _gn_copy("stamped", [], "-DGN_PHASE_STAMPS")
    stamped.pd_gn_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    built = _gn_copy("built", [])
    if "K5" in kernels:
        copies = {"as built": built,
                  "no SiLU in the codes": _gn_copy("no_silu_codes", [NO_SILU_CODES])}
        for shape, silu, eps in K5_SHAPES:
            x, w, b = _gn_inputs(gen, shape, mean=4.0 if shape[0] == 4 else 0.0)
            act = "silu" if silu else "none"
            plan, run = _gn_call(stamped, x, w, b, eps, act, True)
            line = _phase_line(stamped, plan, run, K5_PHASES)
            run_of = lambda so: _gn_call(so, x, w, b, eps, act, True)[1]
            times = "; ".join(f"{name} {device_ms(run_of(so), iters=iters, launches=1):.4f} ms"
                              for name, so in copies.items())
            print(f"[quant_tune] phases K5 {shape} {act}: {line} | {times}", flush=True)
    if "K3" in kernels:
        for shape, act, eps, mean in K3_SHAPES:
            x, w, b = _gn_inputs(gen, shape, mean=mean)
            plan, run = _gn_call(stamped, x, w, b, eps, act, False)
            line = _phase_line(stamped, plan, run, K3_PHASES)
            ms = device_ms(_gn_call(built, x, w, b, eps, act, False)[1], iters=iters, launches=1)
            print(f"[quant_tune] phases K3 {shape} {act}: {line} | as built {ms:.4f} ms",
                  flush=True)


PARTS = {"sass": sass, "check": check, "time": time_, "phases": phases}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--part", choices=PARTS, action="append",
                    help="a part to run (repeatable; all when not given)")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help=f"comma-separated subset of {','.join(KERNELS)} (all when not given)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("quant_tune: no CUDA device", file=sys.stderr)
        return 2
    print(f"[quant_tune] {card()} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    kernels = set(args.kernels.split(","))
    if not kernels <= set(KERNELS):
        ap.error(f"--kernels takes a subset of {KERNELS}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for part in args.part or PARTS:
        PARTS[part](gen, args.iters, kernels)
    return 0


if __name__ == "__main__":
    sys.exit(main())
