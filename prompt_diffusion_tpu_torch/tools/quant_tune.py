"""K10 and K13, the row -> int8 kernels of `ops/csrc/row_quant.cu`, on the card.

    python3 -m prompt_diffusion_tpu_torch.tools.quant_tune [--part sass|check|time]
        [--iters N]

  sass   nvcc -cubin of `row_quant.cu` as built and of a copy whose K10
         takes CUDA's tanhf (TANHF): ptxas's registers and spills of every
         instantiation the SD3 shapes take, and, from `cuobjdump -sass`,
         SASS instructions and MUFU operations per value (the difference
         between two instantiations that differ only in the vectors per
         thread, over the values they differ by) and per thread and row
         group (static, slow paths included); from the per-value counts a
         compute bound at the SD3 shapes (a lower bound: the per-row work
         is left out), beside the byte bound;
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
         per call; two runs bit-equal;
  time   device ms (`tools/timing.py::device_ms`) at every SD3 shape of the
         parent's Triton programs (launched as the parent's wrappers
         launched them, K13's modulation casts included) and the CUDA
         kernels, in turns (parent, new, new, parent), L2-warm (20
         back-to-back calls on one input) and L2-cold (the calls rotate
         through copies of the inputs that hold more than COLD_BYTES, so
         each call reads its input from device memory); the bound share is
         the cold reading's. Then the plan sweep (K10's threads per row,
         both kernels' row groups) and K10 with tanhf (the copy), cold.

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

from prompt_diffusion_tpu_torch.ops import row_quant as rq
from prompt_diffusion_tpu_torch.ops.dispatch import plain_ops
from prompt_diffusion_tpu_torch.ops.fused_act import fused_gelu_quant
from prompt_diffusion_tpu_torch.ops.fused_adaln import fused_adaln_quant
from prompt_diffusion_tpu_torch.tools.attn_tune import _CSRC_DIR, _REPO, _nvcc
from prompt_diffusion_tpu_torch.tools.timing import (
    EXP_S,
    HBM_BYTES_S,
    card,
    device_launches,
    device_ms,
)

OUT_DIR = os.path.join(_REPO, "build", "quant_tune")
SOURCE = os.path.join(_CSRC_DIR, "row_quant.cu")
# the SD3 int8 step's shapes (CFG batch 2 at 1024²: 4096 image tokens and
# 333 context tokens of 1536; the FF's 4 x 1536 = 6144)
K10_SHAPES = ((8192, 6144), (666, 6144))
K13_SHAPES = ((2, 4096, 1536), (2, 333, 1536))
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


def _parent_gelu_quant(x):
    """K10 as the parent launched it: Triton `act_quant_kernel`, GELU=True."""
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
        x2, q, s_a, n, c, BLOCK_R=block_r, BLOCK_C=block_c, GELU=True,
        num_warps=8 if block_c >= 4096 else 4)
    return q.view(x.shape), s_a.view(*x.shape[:-1], 1)


def _parent_adaln_quant(x, scale, shift, eps=1e-6):
    """K13 as the parent launched it: the modulation cast to contiguous
    fp32, then Triton `adaln_kernel`, QUANT=True."""
    import triton

    from prompt_diffusion_tpu_torch.ops import _triton_quant as tq
    from prompt_diffusion_tpu_torch.ops.fused_layer_norm import _TILE

    b, n, c = x.shape
    x2 = x.contiguous().view(b * n, c)
    sc = scale.reshape(b, 1, c).float().contiguous()
    sh = shift.reshape(b, 1, c).float().contiguous()
    block_c = triton.next_power_of_2(c)
    block_r = max(1, _TILE // block_c)
    out = torch.empty((b, n, c), dtype=torch.int8, device=x.device)
    s_a = torch.empty((b, n, 1), dtype=torch.float32, device=x.device)
    tq.adaln_kernel[(triton.cdiv(b * n, block_r),)](
        x2, sc, sh, out, s_a, b * n, n, c, float(eps), BLOCK_R=block_r, BLOCK_C=block_c,
        QUANT=True)
    return out, s_a


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
    log, _ = _nvcc(src, out, *flags).communicate()
    if not os.path.isfile(out):
        raise RuntimeError(f"nvcc failed on {src}:\n{log[-3000:]}")
    return out, log


# ---- sass ----------------------------------------------------------------

_KERNEL = re.compile(r"(gelu|adaln)_quant_kernelI(13__nv_bfloat16|f)Li(\d)ELb([01])E")


def _sass_counts(cubin):
    """{(op, dtype, vpt, pipe): (instructions, MUFU operations)} of every
    kernel instantiation in `cubin`."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME, "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", cubin], capture_output=True, text=True,
                          check=True).stdout
    counts, key = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            m = _KERNEL.search(line)
            key = None if m is None else (m.group(1), "bf16" if m.group(2) != "f" else "fp32",
                                          int(m.group(3)), m.group(4) == "1")
            if key:
                counts[key] = [0, 0]
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if key and m:
            counts[key][0] += 1
            counts[key][1] += m.group(1).startswith("MUFU")
    return counts


def sass(_gen, _iters):
    """Registers, spills, SASS instructions and MUFU operations per value."""
    for label, src in (("built", SOURCE), ("tanhf", _tanhf_source())):
        cubin, log = _build(f"row_quant_{label}.cubin", src, "-cubin")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"Compiling entry function '(\w+)'", line)
            k = m and _KERNEL.search(m.group(1))
            if k and int(k.group(3)) in (3, 6):
                info = " | ".join(x.split(":", 2)[-1].strip() for x in lines[i + 1:i + 4]
                                  if "registers" in x or "spill" in x)
                print(f"[quant_tune] ptxas {label} {k.group(1)}<{k.group(2)}, {k.group(3)}, "
                      f"pipe={k.group(4)}>: {info}", flush=True)
        counts = _sass_counts(cubin)
        for op, shapes in (("gelu", [(1, r, c) for r, c in K10_SHAPES]), ("adaln", K13_SHAPES)):
            for pipe in (False, True):
                (i3, m3), (i6, m6) = counts[(op, "bf16", 3, pipe)], counts[(op, "bf16", 6, pipe)]
                per_value, mufu_value = (i6 - i3) / 24, (m6 - m3) / 24
                per_thread = i3 - 24 * per_value
                msg = []
                for b, n, c in shapes:
                    plan = rq.row_plan(b * n, c, torch.bfloat16, samples=b)
                    values, threads = b * n * c, b * n * plan.threads
                    issue = values * per_value / ISSUE_S * 1e3
                    mufu = values * mufu_value / EXP_S * 1e3
                    static = threads * per_thread / ISSUE_S * 1e3
                    nbytes = 3 * values + 4 * b * n + (4 * b * c if op == "adaln" else 0)
                    msg.append(f"({b},{n},{c}) compute bound {max(issue, mufu):.4f} ms (issue "
                               f"{issue:.4f}, MUFU {mufu:.4f}; the static per-thread part "
                               f"would add at most {static:.4f}) beside bytes "
                               f"{nbytes / HBM_BYTES_S * 1e3:.4f}")
                print(f"[quant_tune] sass {label} {op} bf16 pipe={pipe}: {i3} instructions at "
                      f"VPT=3, {i6} at VPT=6: {per_value:.2f} per value ({mufu_value:.2f} "
                      f"MUFU), {per_thread:.0f} static per thread and row group (slow paths "
                      f"of the divisions included); " + "; ".join(msg), flush=True)


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


def _div_cases(gen):
    """(label, y or bf16 x, per-row s, is x) at the SD3 shapes: K10's x with
    the kernel's row scales, K13's plain fp32 values with the kernel's."""
    from prompt_diffusion_tpu_torch.ops.fused_adaln import _torch_adaln

    for n, c in K10_SHAPES:
        x = _x(gen, n, c)
        yield f"K10 ({n},{c})", x, fused_gelu_quant(x)[1], True
    for b, n, c in K13_SHAPES:
        x, (sc, sh) = _x(gen, b, n, c), _mod(gen, b, c)
        yield f"K13 ({b},{n},{c})", _torch_adaln(x, sc, sh, 1e-6), \
            fused_adaln_quant(x, sc, sh)[1], False


def _check_division(gen):
    so = _div_lib()
    stream = torch.cuda.current_stream().cuda_stream
    failed = []
    for label, y, s, is_x in _div_cases(gen):
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


def _kernel_cases(gen):
    """(label, kernel call, plain call) for `check`."""
    cases = []
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
    return cases


def check(gen, _iters):
    """The quotient bit for bit; the kernels against their plain versions."""
    failed = _check_division(gen)
    for label, kernel, plain in _kernel_cases(gen):
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


def _turns(label, bound, parent, new, iters):
    times = {"parent": [], "new": []}
    for who in ("parent", "new", "new", "parent"):
        times[who].append(device_ms(parent if who == "parent" else new, iters=iters))
    best = min(times["new"])
    return (f"{label}: parent={'/'.join(f'{t:.4f}' for t in times['parent'])} "
            f"new={'/'.join(f'{t:.4f}' for t in times['new'])} "
            f"share_of_bound={bound / best:.3f}")


def time_(gen, iters):
    """Parent and new in turns, warm and cold; the plan sweep; tanhf."""
    tanhf = _tanhf_lib()
    for n, c in K10_SHAPES:
        nbytes = 3 * n * c + 4 * n
        bound = nbytes / HBM_BYTES_S * 1e3
        x = _x(gen, n, c)
        with plain_ops():
            ref = fused_gelu_quant(x)
        print(f"[quant_tune] parity K10 ({n},{c}): parent {_within(_parent_gelu_quant(x), ref)[1]}"
              f"; tanhf {_within(tanhf(x), (ref[0].view(n, c), ref[1].view(n)))[1]}", flush=True)
        cold = _cold(lambda: (_x(gen, n, c),), nbytes)
        warm = _turns("warm", bound, lambda: _parent_gelu_quant(x), lambda: fused_gelu_quant(x),
                      iters)
        colds = _turns("cold", bound, cold(_parent_gelu_quant), cold(fused_gelu_quant), iters)
        print(f"[quant_tune] time K10 ({n},{c}) bound_ms={bound:.4f} (bytes) | {warm} | {colds}",
              flush=True)
        sweep = []
        for t, g in [(t, g) for t in (128, 256) for g in (1, 2, 4)]:
            plan = rq.row_plan(n, c, x.dtype, threads=t, groups=g)
            sweep.append(f"threads={t} groups={g}: "
                         f"{device_ms(cold(lambda x, p=plan: rq.gelu_quant(x, p)), iters=iters):.4f}")
        sweep.append(f"tanhf: {device_ms(cold(tanhf), iters=iters):.4f}")
        print(f"[quant_tune] sweep K10 ({n},{c}) cold: " + "; ".join(sweep), flush=True)
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


PARTS = {"sass": sass, "check": check, "time": time_}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--part", choices=PARTS, action="append",
                    help="a part to run (repeatable; all when not given)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("quant_tune: no CUDA device", file=sys.stderr)
        return 2
    print(f"[quant_tune] {card()} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for part in args.part or PARTS:
        PARTS[part](gen, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
