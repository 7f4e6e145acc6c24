"""K1's, K2's and K9's tiles and what bounds them, on the card.

    python3 -m prompt_diffusion_tpu_torch.tools.attn_tune [--iters N]
        [--part sweep|int8|ablate|sm90|wide|host|lab|sass] [--quick] [--csrc DIR]

  sweep     the online mode of `ops/csrc/flash_attention.cu` at every tile
            of `LAB_TILES` on K1's shapes in the SD1.5 paths (CFG batch 4
            and 8; D = 40 at 64² latents, 80 at 32²), beside
            `scaled_dot_product_attention` on the same inputs: the data
            behind `ops/flash_attention.py::kernel_tile`;
  ablate    copies of the source with one part of the narrow kernel taken
            out (the exponentials, the P.V products, the K/V loads, the
            register cap), each compiled by nvcc into its own library under
            `build/attn_tune/` and called through ctypes at K1's tile; the
            time each part costs, and ptxas's registers and spills of the
            K1 kernel of each copy. The outputs of an ablated copy are
            wrong by design and are not checked;
  int8      K9 (`ops/csrc/int8_attention.cu`): ptxas's registers and spills
            of every instantiation (nvcc -Xptxas=-v on the source), then
            its device time (`tools/timing.py::device_ms`, its prologue
            included) at both query tiles on its path shapes (the SD3
            joint attention, the ViT-B's qkv column slices) and the lab's
            per-row-K shape, in turns, beside `int8_block_q`'s choice: the
            data behind that rule;
  sm90      the warpgroup kernels of `ops/csrc/attention_sm90.cuh`: copies of
            the source built by nvcc in parallel into libraries under
            `build/attn_tune/` (the kernel, and ablated copies without the
            exponentials, the P.V products, the K/V copies after the first
            stages, the ping-pong of the consumers); the plan of `ops/flash_attention.py` against
            the build's query rows, key tile and shared memory; ptxas's registers,
            spills and warnings of every instantiation; the count of
            warpgroup (`HGMMA`, `IGMMA`) and `mma.sync` (`HMMA`, `IMMA`)
            instructions in each kernel's SASS (`cuobjdump -sass`), beside the
            parents' (`fa_narrow_kernel`, `int8_attn_kernel`); the kernel's
            error against the plain version in fp32 at every head dim and
            tail; then, in turns, the device ms of the sm90 kernel (K9 also
            on the consumer count its plan did not take, and beside K1's
            kernel on the same inputs), its parent (where one takes the head
            width) and SDPA (for K9 a yardstick: another function) at the
            path shapes,
            and of each other copy, and the host us a call spends in the
            wrapper. With `--quick` only the kernel's copy,
            its errors and its times beside SDPA (no parent: the extension
            is not built);
  wide      K2 at the VAE's D = 512 (`ops/csrc/attention_sm90_wide.cuh`):
            an L2 probe first (a kernel in which every block re-reads a
            buffer the size of K and V at the SD3 VAE shape, 33.5 MB, from
            L2; the card's L2 read rate in TB/s, which bounds what a CTA
            per SM without shared K/V tiles can reach); copies of the
            source built by nvcc in parallel (the kernel, and ablated
            copies without the exponentials, the P.V products, the K/V
            copies after the first stages, the exchange of the partial
            logits, the Q.K^T products) beside the parent
            (`flash_attention.cu`'s `fa_wide_kernel`); the plan of
            `ops/flash_attention.py::wide_plan` against the build; ptxas's
            registers and spills; the SASS counts (`HGMMA`, no `HMMA`) of
            the kernel and of the parent; the error against the plain
            version in fp32 on the VAE shapes and ragged ones; then, in
            turns, the device ms of the kernel, the parent and SDPA at the
            three VAE shapes of `chip_smoke.py`, each ablated copy, and the
            host us a call of the wrapper and of the parent's; with
            `--quick` no extension build (no wrapper host times).
  lab       the attention lab's online (L1), no-softmax (L2), two-pass (L3)
            and per-row-K int8 (L4) modes on the sm90 kernel
            (`ops/csrc/attention_sm90_lab.cu`, `_lab_two_pass.cu`): copies
            of the source (its C interface, K1's and the lab's
            instantiations; K9's launches left out) built by nvcc in
            parallel into libraries under `build/attn_tune/` (the kernel,
            and the ablated copies of `sm90`), with ptxas's registers,
            spills and warnings and the SASS counts of every lab
            instantiation; the lab plans' shared memory against the
            build's; the error against the plain version in fp32 of every
            instantiation at ragged lengths; then, in turns, the device ms
            of every tile the lab runs at the lab's shapes ((8,4096,8,40)
            for L1, L2 and L3, (8,4096,8,64) and (8,4096,8,128) for L3;
            L4 at (2,4250,24,64) on both of K9's plans, the prologue's
            codes and scales made beforehand), of the parent (nvcc copies
            of `flash_attention.cu`'s `fa_narrow_kernel` at
            `lab_parent_tile`, and for L4 of `int8_attention.cu`'s
            `int8_attn_kernel`), of K1's kernel on the same inputs and of
            SDPA (not for L2, which has no softmax), beside the bound; then
            each ablated copy at K1's tile (L4: its plan's). With `--quick`
            no ablated copies. Nothing here needs the extension;
  sass      SHA-1 digests of the SASS of every K1, K9 and lab
            instantiation (the translation units of `SASS_UNITS` built by
            nvcc into cubins from `--csrc`, this package's sources by
            default): against another checkout's digests they show whether
            a change of the shared header moved those kernels' code;
  host      where the sm90 wrappers' host time goes at K1's, K2's and K9's
            path shapes: host us a call of the whole wrapper, of its three
            `sm90_check_view` calls, of the plan lookups, of the bare
            extension call (its three tensor-map encodes included), and of
            the parent's wrapper (where one takes the head width); for K9
            also its checks, its setup lookup, its two allocations and K9p's
            bare launch (what this package has of them).

The K1 parts' times are CUDA-event medians. It needs one CUDA card and
nvcc; without a card it exits 2.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from prompt_diffusion_tpu_torch.ops import flash_attention as fa
from prompt_diffusion_tpu_torch.tools.timing import card, device_ms, roofline, time_ms

_CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "ops", "csrc")
_CSRC = os.path.join(_CSRC_DIR, "flash_attention.cu")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT_DIR = os.path.join(_REPO, "build", "attn_tune")
SHAPES = ((8, 4096, 8, 40), (4, 4096, 8, 40), (8, 1024, 8, 80), (4, 1024, 8, 80))
# K9's shapes (B, N, H, D, per-row K): the SD3 joint attention, the ViT-B's
# qkv column slices (packed qkv of width 3 * H * D), the lab's per-row mode
INT8_SHAPES = (("SD3 joint", 2, 4429, 24, 64, False), ("ViT-B qkv slices", 16, 1025, 12, 64, False),
               ("lab per-row K", 2, 4250, 24, 64, True))
# (old, new) edits of the source for each ablated copy
_EX2 = 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));'
_PV = ("mma_bf16(o[2 * n2], a, vf[0], vf[1]);\n"
       "          if (n2 * 16 + 8 < p.d) mma_bf16(o[2 * n2 + 1], a, vf[2], vf[3]);")
ABLATIONS = {
    "kernel": [],
    "no exponentials": [(_EX2, "y = x * 0.5f;")],
    "no P.V products": [(_PV, "")],
    "no K/V loads after the first tiles": [("    issue(j + NST - 1, true);\n", "")],
    "no register cap": [("return bk <= 64 && dk == 64 ? 256 / bq : 1;", "return 1;")],
}


def _inputs(gen, b, n, h, d):
    return [torch.randn(b, n, h, d, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(3)]


def sweep(gen, iters):
    """Online-mode ms at every lab tile on K1's path shapes, and SDPA's."""
    for b, n, h, d in SHAPES:
        q, k, v = _inputs(gen, b, n, h, d)
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in (q, k, v))), iters=iters)
        times = {tile: time_ms(lambda tile=tile: fa._parent_launch(q, k, v, d ** -0.5, "online",
                                                                   tile),
                               iters=iters) for tile in fa.LAB_TILES}
        best = min(times, key=times.get)
        print(f"[attn_tune] sweep ({b},{n},{h},{d}) sdpa_ms={sdpa:.4f} "
              + " ".join(f"{bq}x{bk}={ms:.4f}" for (bq, bk), ms in times.items())
              + f" best={best[0]}x{best[1]} kernel_tile={fa.kernel_tile(d)}", flush=True)


def _nvcc(src, out, *flags):
    """Start nvcc for sm_90a with ptxas's report on `src` (a source or a
    tuple of them); returns the process."""
    from torch.utils.cpp_extension import CUDA_HOME

    srcs = (src,) if isinstance(src, str) else tuple(src)
    cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), "-gencode=arch=compute_90a,code=sm_90a",
           "-O3", "-std=c++17", "-Xptxas=-v", *flags, "-o", out, *srcs]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _compile(name, edits):
    """Start nvcc on a copy of the source with `edits`; returns (library
    path, the process) or (None, why not)."""
    src = open(_CSRC).read()
    for old, new in edits:
        if old not in src:
            return None, f"edit no longer matches the source: {old[:40]!r}"
        src = src.replace(old, new)
    os.makedirs(OUT_DIR, exist_ok=True)
    stem = os.path.join(OUT_DIR, re.sub(r"\W+", "_", name))
    open(stem + ".cu", "w").write(src)
    return stem + ".so", _nvcc(stem + ".cu", stem + ".so", "-shared", "-Xcompiler", "-fPIC")


def _load(lib, proc):
    """Wait for nvcc; returns (the launch function, ptxas's registers and
    spills of K1's D = 40 kernel)."""
    out, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {lib}:\n{out[-3000:]}")
    lines = out.splitlines()
    bq, bk = fa.kernel_tile(40)
    key = f"Li{bq}ELi{bk}ELi64ELi0E"  # <BQ, BK, DK 64, online>
    info = next((" | ".join(x.split(":")[-1].strip() for x in lines[i + 1:i + 5]
                            if "registers" in x or "spill" in x)
                 for i, line in enumerate(lines) if "Compiling" in line and key in line), "")
    fn = ctypes.CDLL(lib).pd_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 12
                   + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, info


def ablate(gen, iters):
    """ms of K1's tile in each ablated copy at the headline K1 shapes; the
    copies compile in parallel."""
    builds = {name: _compile(name, edits) for name, edits in ABLATIONS.items()}
    for name, (lib, proc) in builds.items():
        if lib is None:
            print(f"[attn_tune] ablate {name}: skipped, {proc}", flush=True)
            continue
        fn, info = _load(lib, proc)
        row = []
        for b, n, h, d in (SHAPES[0], SHAPES[2]):
            q, k, v = _inputs(gen, b, n, h, d)
            o = torch.empty_like(q)
            bq, bk = fa.kernel_tile(d)

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, n, n, d,
                         *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                         d ** -0.5, 0, bq, bk, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")

            row.append(f"({b},{n},{h},{d}) {time_ms(call, iters=iters):.4f}")
        print(f"[attn_tune] ablate {name}: " + " ".join(row) + f" | ptxas (D=40 tile) {info}",
              flush=True)


def int8(gen, iters):
    """ptxas's report of every kernel in `int8_attention.cu`, then K9's
    device ms at BQ 64 and 128 on its shapes, timed 64, 128, 128, 64."""
    os.makedirs(OUT_DIR, exist_ok=True)
    out, _ = _nvcc(os.path.join(_CSRC_DIR, "int8_attention.cu"),
                   os.path.join(OUT_DIR, "int8_attention.o"), "-c").communicate()
    lines = out.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\w*?"
                      r"(int8_attn_kernel|k_codes_kernel|k_amax_kernel)I(\w*?)E(?:Ev|EEv)", line)
        if m:
            targs = ", ".join(re.findall(r"L[ib](\d+)E", m.group(2) + "E"))
            info = " | ".join(x.split(":", 2)[-1].strip() for x in lines[i + 1:i + 4]
                              if "registers" in x or "spill" in x)
            print(f"[attn_tune] ptxas {m.group(1)}<{targs}>: {info}", flush=True)
    for label, b, n, h, d, per_row in INT8_SHAPES:
        hd = h * d
        if label.startswith("ViT"):
            q, k, v = torch.randn(b, n, 3 * hd, generator=gen, device="cuda").to(
                torch.bfloat16).chunk(3, dim=-1)
        else:
            q, k, v = (torch.randn(b, n, hd, generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(3))
        times = {64: [], 128: []}
        for bq in (64, 128, 128, 64):
            times[bq].append(device_ms(lambda bq=bq: fa._int8_parent_launch(
                q, k, v, h, d ** -0.5, per_row, bq), iters=iters))
        print(f"[attn_tune] int8 {label} ({b},{n},{hd}) H={h}: device_ms " + " ".join(
            f"bq{bq}={'/'.join(f'{t:.4f}' for t in ts)}" for bq, ts in times.items())
            + f" int8_block_q={fa.int8_block_q(n)}", flush=True)


_SM90 = tuple(os.path.join(_CSRC_DIR, f) for f in ("attention_sm90.cu", "attention_sm90_bf16.cu",
                                                    "attention_sm90_int8.cu"))
# the sm90 kernel's path shapes: (label, B, N, H, D, int8, qkv column slices)
SM90_SHAPES = (
    ("K1 SD1.5 64² CFG 8", 8, 4096, 8, 40, False, False),
    ("K1 SD1.5 64² CFG 4", 4, 4096, 8, 40, False, False),
    ("K1 SD1.5 32² CFG 8", 8, 1024, 8, 80, False, False),
    ("K1 UniFormer stage 3", 16, 1024, 5, 64, False, True),
    ("K1 DPT ViT-B", 16, 1025, 12, 64, False, True),
    ("K2 MMDiT joint", 2, 4429, 24, 64, False, False),
    ("K9 SD3 joint", 2, 4429, 24, 64, True, False),
    ("K9 DPT ViT-B", 16, 1025, 12, 64, True, True),
    ("K9 UniFormer stage 3", 16, 1024, 5, 64, True, True),
    ("K9 SD1.5 64² CFG 8", 8, 4096, 8, 40, True, False),
    ("K9 SD1.5 32² CFG 8", 8, 1024, 8, 80, True, False),
)
# every instantiation, with ragged and short key and query lengths
# (K9 at D = 40 on 4 heads: its code rows must be whole 16-byte units)
SM90_CHECKS = tuple((f"D={d}{' int8' if i8 else ''} N={n}", 2, n, 4 if i8 and d == 40 else 3, d,
                     i8, sl)
                    for d, i8 in ((40, False), (64, False), (80, False), (128, False),
                                  (32, True), (40, True), (64, True), (80, True), (128, True))
                    for n, sl in ((77, False), (1100, True)))
# the sm90 kernel's instantiations: (D, int8, consumers)
SM90_INSTANCES = ((40, False, 3), (64, False, 3), (80, False, 2), (128, False, 2),
                  (32, True, 3), (32, True, 2), (40, True, 3), (40, True, 2), (64, True, 3),
                  (64, True, 2), (80, True, 2), (128, True, 2))
# nvcc flags of each copy of the source (`attention_sm90.cuh`'s header): the
# kernel and the ablated copies
SM90_COPIES = {"kernel": (), "no exponentials": ("-DPD_SM90_ABLATE=1",),
               "no P.V products": ("-DPD_SM90_ABLATE=2",),
               "no K/V copies after the first stages": ("-DPD_SM90_ABLATE=4",),
               "no ping-pong": ("-DPD_SM90_ABLATE=8",)}
_SASS_OPS = ("HGMMA", "IGMMA", "HMMA", "IMMA")


def _sm90_inputs(gen, b, n, h, d, slices):
    """bf16 packed (B, N, H*D) q, k, v, as column slices of one qkv
    projection with `slices`."""
    r = lambda w: torch.randn(b, n, w, generator=gen, device="cuda").to(torch.bfloat16)
    if slices:
        return r(3 * h * d).chunk(3, dim=-1)
    return r(h * d), r(h * d), r(h * d)


def _ptxas(out, names):
    """{kernel: 'registers, spills' report} from nvcc -Xptxas=-v output for
    the entry functions whose mangled name holds one of `names`, with
    ptxas's warnings."""
    lines, rows = out.splitlines(), {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m and any(nm in m.group(1) for nm in names):
            rows[m.group(1)] = " | ".join(x.split(":", 2)[-1].strip() for x in lines[i + 1:i + 5]
                                          if "registers" in x or "spill" in x)
    warnings = sorted({x.strip() for x in lines if "warning" in x.lower()})
    return rows, warnings


def _sass_counts(lib, names):
    """{kernel: {op: count}} of `_SASS_OPS` in the SASS of `lib`'s kernels
    whose mangled name holds one of `names` (cuobjdump -sass)."""
    from torch.utils.cpp_extension import CUDA_HOME

    out = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", lib],
                         capture_output=True, text=True, check=True).stdout
    counts, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = m.group(1) if any(nm in m.group(1) for nm in names) else None
            if cur:
                counts[cur] = dict.fromkeys(_SASS_OPS, 0)
        elif cur:
            for op in _SASS_OPS:
                if re.search(rf"\b{op}\b", line):
                    counts[cur][op] += 1
    return counts


def _demangled(name):
    m = re.search(r"(attn_sm90_\w+?_kernel|fa_narrow_kernel|int8_attn_kernel)I(\w*?)EEv", name)
    return f"{m.group(1)}<{', '.join(re.findall(r'L[ib](\d+)E', m.group(2) + 'E'))}>" if m else name


def _sm90_builds(quick):
    """Start nvcc on the kernel's copies (one per ablation) at once; returns
    {name: (library, process)}."""
    os.makedirs(OUT_DIR, exist_ok=True)
    builds = {}
    for name, flags in SM90_COPIES.items():
        if quick and flags:
            continue
        lib = os.path.join(OUT_DIR, f"sm90_{re.sub(r'\W+', '_', name)}.so")
        builds[name] = lib, _nvcc(_SM90, lib, "-shared", "-Xcompiler", "-fPIC", *flags)
    return builds


def _sm90_fn(lib):
    fn = ctypes.CDLL(lib).pd_attention_sm90_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _k9_codes(k, h):
    """The plain prologue's codes of packed K as a (B, N, H, D) view laid
    out as K9p writes them for the sm90 kernel (heads
    `Sm90Plan.k_head_bytes` apart; dense in a package without it), and
    the (B, H) scales."""
    b, n, hd = k.shape
    d = hd // h
    codes, sk = fa._quant_k_per_head(k, h)
    kd = getattr(fa.sm90_plan(d, True), "k_head_bytes", d)
    k4 = torch.zeros((b, n, h, kd), dtype=torch.int8, device=k.device)[..., :d]
    k4.copy_(codes.unflatten(-1, (h, d)))
    return k4, sk


def _sm90_call(fn, q, k, v, h, int8, consumers=None):
    """A call of a library copy on packed (B, N, H*D) inputs on `consumers`
    warpgroups (the plan's by default; K9: codes and scales from the plain
    prologue, bit-equal to K9p, laid out as K9p writes them for the kernel:
    heads `Sm90Plan.k_head_bytes` apart); returns (call, out)."""
    b, nq, hd = q.shape
    d = hd // h
    consumers = consumers or fa.sm90_consumers(d, int8, nq, k.shape[1])
    heads = lambda t: t.unflatten(-1, (h, d))
    k4, sk = _k9_codes(k, h) if int8 else (heads(k), None)
    q4, v4 = heads(q), heads(v)
    out = torch.empty((b, nq, h, d), dtype=torch.bfloat16, device="cuda")

    def call():
        err = fn(q4.data_ptr(), k4.data_ptr(), sk.data_ptr() if int8 else None, v4.data_ptr(),
                 out.data_ptr(), int(int8), b, h, nq, k4.shape[1], d, *q4.stride()[:3],
                 *k4.stride()[:3], *v4.stride()[:3], *out.stride()[:3], d ** -0.5, consumers,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"attention_sm90 launch failed: {err}")

    return call, out


def _plain(q, k, v, h, int8):
    """The plain version in fp32 on the same bf16 inputs."""
    args = (q.float(), k.float(), v.float(), h, (q.shape[-1] // h) ** -0.5)
    return (fa._torch_int8_attention if int8 else fa._packed_ref)(*args).float()


def _host_us(fn, calls=50, rounds=5):
    """Host microseconds a call spends before it returns (enqueue only):
    the median of `rounds` rounds of `calls` calls after a round of
    warm-up, the device drained between rounds."""
    per_call = []
    for r in range(rounds + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        if r:
            per_call.append((time.perf_counter() - t) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(per_call)


def sm90(gen, iters, quick=False):
    """The sm90 kernel: build and SASS report, errors, then times beside
    its parent, SDPA and its ablated copies."""
    builds = _sm90_builds(quick)
    fns = {}
    for name, (lib, proc) in builds.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {lib}:\n{out[-4000:]}")
        fns[name] = _sm90_fn(lib)
        if name == "kernel":
            rows, warnings = _ptxas(out, ("attn_sm90_",))
            for kname, info in rows.items():
                print(f"[attn_tune] sm90 ptxas {_demangled(kname)}: {info}", flush=True)
            print(f"[attn_tune] sm90 ptxas warnings: {warnings or 'none'}", flush=True)
            for kname, ops in _sass_counts(lib, ("attn_sm90_",)).items():
                print(f"[attn_tune] sm90 sass {_demangled(kname)}: {ops}", flush=True)
    lib = ctypes.CDLL(builds["kernel"][0])
    for d, int8, nc in SM90_INSTANCES:
        plan = fa.sm90_plan(d, int8, nc)
        built = tuple(getattr(lib, f"pd_attention_sm90_{x}")(d, int8, nc)
                      for x in ("block_q", "block_k", "smem"))
        print(f"[attn_tune] sm90 plan D={d}{' int8' if int8 else ''} on {nc} consumers: "
              f"(block_q, block_k, smem) {built} as built, "
              f"{(plan.block_q, plan.block_k, plan.smem)} in the plan", flush=True)
        if built != (plan.block_q, plan.block_k, plan.smem):
            raise RuntimeError(f"sm90_plan({d}, {int8}, {nc}) disagrees with the build: {built}")
    if not quick:
        from prompt_diffusion_tpu_torch.ops._build import BUILD_DIR, cuda_ext

        cuda_ext()
        ext = [os.path.join(BUILD_DIR, f) for f in os.listdir(BUILD_DIR) if f.endswith(".so")]
        for kname, ops in _sass_counts(ext[0], ("attn_sm90_", "fa_narrow_kernel",
                                                "int8_attn_kernel")).items():
            print(f"[attn_tune] sm90 sass (extension) {_demangled(kname)}: {ops}", flush=True)
    for label, b, n, h, d, int8, slices in SM90_CHECKS + SM90_SHAPES:
        q, k, v = _sm90_inputs(gen, b, n, h, d, slices)
        call, out = _sm90_call(fns["kernel"], q, k, v, h, int8)
        call()
        ref = _plain(q, k, v, h, int8)
        err = (out.flatten(2).float() - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        finite = bool(torch.isfinite(out).all())
        print(f"[attn_tune] sm90 check {label} ({b},{n},{h * d}) H={h}: max_abs_err={err:.3g} "
              f"({rel:.3g} of the largest output) finite={finite}", flush=True)
        del ref
    for label, b, n, h, d, int8, slices in SM90_SHAPES:
        q, k, v = _sm90_inputs(gen, b, n, h, d, slices)
        call, _ = _sm90_call(fns["kernel"], q, k, v, h, int8)
        scale = d ** -0.5
        heads = lambda t: t.unflatten(-1, (h, -1)).transpose(1, 2)
        cands = {"sm90": call}
        if int8 and d <= fa.SM90_WIDE_CONSUMERS_D:  # K9 on the consumers the plan did not take
            other = 5 - fa.sm90_consumers(d, int8, n, n)
            cands[f"sm90 on {other} consumers"] = _sm90_call(fns["kernel"], q, k, v, h, int8,
                                                              other)[0]
        # SDPA (for K9 a yardstick: another function) and, beside K9, K1's
        # sm90 kernel on the same inputs
        cands["sdpa"] = lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                                               scale=scale)
        if int8:
            cands["k1 sm90"] = _sm90_call(fns["kernel"], q, k, v, h, False)[0]
        if not quick:
            if int8:  # both with K9p, the prologue
                cands["wrapper"] = lambda: fa._int8_launch(q, k, v, h, scale)
                if d in getattr(fa, "INT8_PARENT_HEAD_DIMS", (32, 64, 128)):
                    cands["parent"] = lambda: fa._int8_parent_launch(q, k, v, h, scale)
            else:
                q4, k4, v4 = (t.unflatten(-1, (h, d)) for t in (q, k, v))
                cands["wrapper"] = lambda: fa._launch(q4, k4, v4, scale)
                cands["parent"] = lambda: fa._parent_launch(q4, k4, v4, scale, "online",
                                                            fa.kernel_tile(d))
        times = {c: [] for c in cands}
        for c in list(cands) + list(cands)[::-1]:
            times[c].append(device_ms(cands[c], iters=iters))
        host = {c: _host_us(cands[c]) for c in ("wrapper", "parent") if c in cands}
        print(f"[attn_tune] sm90 time {label} ({b},{n},{h * d}) H={h}: device_ms "
              + " ".join(f"{c}={'/'.join(f'{t:.4f}' for t in ts)}" for c, ts in times.items())
              + (f" host_us {' '.join(f'{c}={u:.1f}' for c, u in host.items())}" if host else ""),
              flush=True)
        for name, fn in fns.items():
            if name == "kernel":
                continue
            acall, _ = _sm90_call(fn, q, k, v, h, int8)
            print(f"[attn_tune] sm90 copy {label}: {name} device_ms="
                  f"{device_ms(acall, iters=iters):.4f}", flush=True)


# a kernel in which every block re-reads the whole buffer from L2 in 16-byte
# loads that skip L1 (ld.global.cg), starting at its own offset; one word
# per block keeps the loads live
_L2_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void l2_probe_kernel(const uint4* __restrict__ buf, size_t n, uint32_t* out) {
  uint32_t acc = 0;
  const size_t start = (static_cast<size_t>(blockIdx.x) * 7919 * blockDim.x) % n;
  for (size_t i = threadIdx.x; i < n; i += 4 * blockDim.x) {
    uint4 a[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      size_t j = start + i + u * blockDim.x;
      if (j >= n) j -= n;
      a[u] = __ldcg(buf + j);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) acc ^= a[u].x ^ a[u].y ^ a[u].z ^ a[u].w;
  }
  if (acc == 0x9e3779b9u) out[blockIdx.x] = acc;
}
extern "C" int pd_l2_probe(const void* buf, size_t bytes, int blocks, int threads, void* out,
                           void* stream) {
  l2_probe_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(buf), bytes / 16, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""
# K2's VAE shapes (B, N, H, D) in `chip_smoke.py`: SD1.5 at 512² (batch 4),
# SD3 at 1024², ragged; and short ones that cross the key and query tails
WIDE_SHAPES = ((4, 4096, 1, 512), (1, 16384, 1, 512), (1, 1100, 1, 512))
WIDE_CHECKS = ((2, 77, 2, 512), (1, 130, 1, 512), (1, 33, 3, 512)) + WIDE_SHAPES
_WIDE = os.path.join(_CSRC_DIR, "attention_sm90_wide.cu")
WIDE_COPIES = {"kernel": (), "no exponentials": ("-DPD_SM90_ABLATE=1",),
               "no P.V products": ("-DPD_SM90_ABLATE=2",),
               "no K/V copies after the first stages": ("-DPD_SM90_ABLATE=4",),
               "no exchange of the partial logits": ("-DPD_SM90_ABLATE=32",),
               "no Q.K^T products": ("-DPD_SM90_ABLATE=64",)}
# the instructions whose order in the kernel's SASS `_sass_order` prints:
# warpgroup products, their waits, exponentials, named and mbarrier syncs
_ORDER_OPS = ("HGMMA", "WARPGROUP.DEPBAR", "WARPGROUP.ARRIVE", "MUFU.EX2", "BAR.SYNC",
              "BAR.ARV", "SYNCS")
# L2_PROBE_BYTES: K and V at the SD3 VAE shape, (1, 16384, 1, 512) bf16 each
L2_PROBE_BYTES, L2_PROBE_BLOCKS_PER_SM = 2 * 16384 * 512 * 2, 2


def _wide_fn(lib):
    fn = ctypes.CDLL(lib).pd_attention_sm90_wide_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 12
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _parent_fn(lib):
    fn = ctypes.CDLL(lib).pd_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 12
                   + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _strided_call(fn, q, k, v, tail):
    """A call of a library's launch on (B, N, H, D) q, k, v with `tail`
    (the arguments after the scale); returns (call, out)."""
    b, nq, h, d = q.shape
    out = torch.empty_like(q)

    def call():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, nq, k.shape[1],
                 d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                 d ** -0.5, *tail, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")

    return call, out


def _sass_order(lib, name):
    """The order of `_ORDER_OPS` in the SASS of `lib`'s first kernel whose
    mangled name holds `name`, with runs counted: where the waits for the
    products fall against the exponentials."""
    from torch.utils.cpp_extension import CUDA_HOME

    out = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", lib],
                         capture_output=True, text=True, check=True).stdout
    seq, cur = [], False
    for line in out.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            if cur:
                break
            cur = name in m.group(1)
        elif cur:
            op = next((o for o in _ORDER_OPS if re.search(rf"\b{re.escape(o)}\b", line)), None)
            if op:
                if seq and seq[-1][0] == op:
                    seq[-1][1] += 1
                else:
                    seq.append([op, 1])
    return " ".join(f"{op}x{n}" if n > 1 else op for op, n in seq)


def l2_probe(lib, iters):
    """The card's L2 read rate (TB/s): every block re-reads a buffer of
    L2_PROBE_BYTES, which stays in the 50 MB L2 after the warm-up."""
    fn = ctypes.CDLL(lib).pd_l2_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    buf = torch.randint(0, 1 << 30, (L2_PROBE_BYTES // 4,), dtype=torch.int32, device="cuda")
    blocks = sms * L2_PROBE_BLOCKS_PER_SM
    out = torch.zeros(blocks, dtype=torch.int32, device="cuda")
    call = lambda: fn(buf.data_ptr(), L2_PROBE_BYTES, blocks, 512, out.data_ptr(),
                      torch.cuda.current_stream().cuda_stream)
    ms = device_ms(call, iters=iters)
    rate = blocks * L2_PROBE_BYTES / (ms * 1e-3) / 1e12
    print(f"[attn_tune] wide L2 probe: {blocks} blocks ({L2_PROBE_BLOCKS_PER_SM} per SM) each "
          f"re-reading {L2_PROBE_BYTES / 1e6:.1f} MB: {ms:.4f} device ms, {rate:.2f} TB/s from L2",
          flush=True)
    return rate


def wide(gen, iters, quick=False):
    """K2 at D = 512: the L2 probe, the build, plan, ptxas and SASS report,
    errors, then times beside the parent, SDPA and the ablated copies, and
    the wrappers' host us."""
    os.makedirs(OUT_DIR, exist_ok=True)
    builds = {}
    for name, flags in WIDE_COPIES.items():
        lib = os.path.join(OUT_DIR, f"wide_{re.sub(r'\W+', '_', name)}.so")
        builds[name] = lib, _nvcc(_WIDE, lib, "-shared", "-Xcompiler", "-fPIC", *flags)
    parent_lib, parent_proc = _compile("wide parent", [])
    probe_src = os.path.join(OUT_DIR, "l2_probe.cu")
    open(probe_src, "w").write(_L2_PROBE)
    probe_lib = os.path.join(OUT_DIR, "l2_probe.so")
    probe_proc = _nvcc(probe_src, probe_lib, "-shared", "-Xcompiler", "-fPIC")
    if not quick:
        from prompt_diffusion_tpu_torch.ops._build import cuda_ext

        cuda_ext()
    for lib, proc in ((probe_lib, probe_proc), (parent_lib, parent_proc)):
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {lib}:\n{out[-3000:]}")
    l2_probe(probe_lib, iters)
    fns = {}
    for name, (lib, proc) in builds.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {lib}:\n{out[-4000:]}")
        fns[name] = _wide_fn(lib)
        if name == "kernel":  # the others are ablated
            rows, warnings = _ptxas(out, ("attn_sm90_wide_kernel",))
            for kname, info in rows.items():
                print(f"[attn_tune] wide ptxas ({name}) {_demangled(kname)}: {info}", flush=True)
            print(f"[attn_tune] wide ptxas ({name}) warnings: {warnings or 'none'}", flush=True)
            for kname, ops in _sass_counts(lib, ("attn_sm90_wide_kernel",)).items():
                print(f"[attn_tune] wide sass ({name}) {_demangled(kname)}: {ops}", flush=True)
            print(f"[attn_tune] wide sass order: {_sass_order(lib, 'attn_sm90_wide_kernel')}",
                  flush=True)
    for kname, ops in _sass_counts(parent_lib, ("fa_wide_kernel",)).items():
        print(f"[attn_tune] wide sass (parent) {kname}: {ops}", flush=True)
    parent = _parent_fn(parent_lib)
    plan_fn = ctypes.CDLL(builds["kernel"][0]).pd_attention_sm90_wide_plan
    plan = fa.wide_plan(512)
    built = tuple(plan_fn(i) for i in range(7))
    want = (plan.rows, plan.block_k, plan.smem, plan.stages, *plan.regs, plan.consumers)
    print(f"[attn_tune] wide plan (rows, block_k, smem, stages, producer regs, consumer regs, "
          f"consumers) {built} as built, {want} in the plan", flush=True)
    if built != want:
        raise RuntimeError(f"wide_plan disagrees with the build: {built}")
    bf = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
    for b, n, h, d in WIDE_CHECKS:
        q, k, v = bf(b, n, h, d), bf(b, n, h, d), bf(b, n, h, d)
        ref = fa._torch_attention(q.float(), k.float(), v.float(), d ** -0.5)
        errs = {}
        for name, (fn, tail) in (("kernel", (fns["kernel"], ())),
                                 ("parent", (parent, (0, *fa.WIDE_TILE)))):
            call, out = _strided_call(fn, q, k, v, tail)
            call()
            torch.cuda.synchronize()
            errs[name] = (out.float() - ref).abs().max().item(), bool(torch.isfinite(out).all())
        print(f"[attn_tune] wide check ({b},{n},{h},{d}): largest output "
              f"{ref.abs().max().item():.4g}; max_abs_err, finite: "
              + "; ".join(f"{c}={e:.3g},{f}" for c, (e, f) in errs.items()), flush=True)
        del ref
    for b, n, h, d in WIDE_SHAPES:
        q, k, v = bf(b, n, h, d), bf(b, n, h, d), bf(b, n, h, d)
        cands = {"kernel": _strided_call(fns["kernel"], q, k, v, ())[0],
                 "parent": _strided_call(parent, q, k, v, (0, *fa.WIDE_TILE))[0]}
        cands["sdpa"] = lambda: F.scaled_dot_product_attention(*(t.transpose(1, 2)
                                                                 for t in (q, k, v)))
        times = {c: [] for c in cands}
        for c in list(cands) + list(cands)[::-1]:
            times[c].append(device_ms(cands[c], iters=iters))
        bound = 4 * b * n * n * h * d / 989e12 * 1e3
        print(f"[attn_tune] wide time ({b},{n},{h},{d}): device_ms "
              + " ".join(f"{c}={'/'.join(f'{t:.4f}' for t in ts)}" for c, ts in times.items())
              + f" bound={bound:.4f} (products at 989 TFLOP/s)", flush=True)
        for name, fn in fns.items():
            if name == "kernel":
                continue
            acall = _strided_call(fn, q, k, v, ())[0]
            print(f"[attn_tune] wide copy ({b},{n},{h},{d}): {name} "
                  f"device_ms={device_ms(acall, iters=iters):.4f}", flush=True)
        if not quick:
            row = _wrapper_host_us(q.flatten(2), k.flatten(2), v.flatten(2), h)
            print(f"[attn_tune] wide host ({b},{n},{h},{d}): "
                  + " ".join(f"{k}={u:.1f}" for k, u in row.items()), flush=True)


_LAB = tuple(os.path.join(_CSRC_DIR, f) for f in ("attention_sm90.cu", "attention_sm90_bf16.cu",
                                                   "attention_sm90_lab.cu",
                                                   "attention_sm90_lab_two_pass.cu"))
# K9's launches, which the lab part's copies leave out (its instantiations
# take the longest to build): every call refused
_NO_INT8 = r"""
#include "attention_sm90.cuh"
namespace pd_sm90 {
int launch_int8(int, int, const CUtensorMap&, const CUtensorMap&, const CUtensorMap&,
                const Params&, int, cudaStream_t) {
  return static_cast<int>(cudaErrorInvalidValue);
}
}  // namespace pd_sm90
"""
# the lab modes' shapes on the sm90 kernel: (label, B, N, H, D, mode): the
# lab's SD1.5 64² self-attention, lab3's heads padded to 64 and 128, and
# the int8 lab's SD3 joint length (per-row K)
LAB_SHAPES = (("L1 SD1.5 64²", 8, 4096, 8, 40, "tiled"),
              ("L2 SD1.5 64²", 8, 4096, 8, 40, "no_softmax"),
              ("L3 SD1.5 64²", 8, 4096, 8, 40, "two_pass"),
              ("L3 heads padded to 64", 8, 4096, 8, 64, "two_pass"),
              ("L3 heads padded to 128", 8, 4096, 8, 128, "two_pass"),
              ("L4 SD3 joint (lab)", 2, 4250, 24, 64, "int8_rowk"))
_LAB_KERNELS = ("attn_sm90_lab_kernel", "attn_sm90_rowk_kernel")


def _lab_fn(lib):
    fn = ctypes.CDLL(lib).pd_attention_sm90_lab_fwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 5 + [ctypes.c_int64] * 12 + [ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _int8_parent_fn(lib):
    fn = ctypes.CDLL(lib).pd_int8_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 5 + [ctypes.c_int64] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _lab_tiles(d, mode, nq=None):
    """The tiles a lab mode instantiates at `d`: SM90_LAB_TILES' legal ones,
    or L4's two plans (K9's on three and on two consumers), the plan's for
    `nq` first."""
    if mode != "int8_rowk":
        return fa.sm90_lab_tiles(d, mode)
    tiles = [(fa.SM90_CONSUMER_ROWS * nc, fa.Sm90Plan(d=d, int8=True, consumers=nc).block_k)
             for nc in (3, 2)]
    if nq is not None and fa.sm90_rowk_plan(d, nq, nq).consumers == 2:
        tiles.reverse()
    return tuple(tiles)


def _lab_smem(d, mode, tile):
    """The lab plan's shared memory at a tile of `_lab_tiles`."""
    if mode == "int8_rowk":
        plan = fa.Sm90Plan(d=d, int8=True, consumers=tile[0] // fa.SM90_CONSUMER_ROWS, row_k=True)
        return plan.smem
    return fa.sm90_lab_plan(d, mode, tile).smem


def _lab_code(mode):
    return fa.SM90_ROWK_MODE if mode == "int8_rowk" else fa._MODES[mode]


def _rowk_operands(k, h):
    """L4's K operands from the plain per-row prologue (bit-equal to
    `k_row_codes_kernel`): packed (B, N, H*D) K -> its codes as a (B, N,
    H, D) view and the (B, H, N) scales laid out as the kernel's map reads
    them, rows `Sm90Plan.scale_pitch(N)` floats apart."""
    b, n, hd = k.shape
    codes, sk = fa._quant_k_per_row(k, h)
    pitch = fa.Sm90Plan(d=hd // h, int8=True, consumers=3, row_k=True).scale_pitch(n)
    rows = torch.zeros((b, h, pitch), dtype=torch.float32, device=k.device)[..., :n]
    rows.copy_(sk)
    return codes.unflatten(-1, (h, hd // h)), rows


def _lab_call(fn, q, k, v, mode, tile, h=None):
    """A call of a library copy's lab entry on (B, N, H, D) bf16 views of
    q, k and v at `tile`, or for L4 on packed (B, N, H*D) ones of `h`
    heads with the plain prologue's codes and scales; returns (call,
    out)."""
    sk, pitch = None, 0
    if mode == "int8_rowk":
        d = q.shape[-1] // h
        k, sk = _rowk_operands(k, h)
        pitch = sk.stride(1)
        q, v = (t.unflatten(-1, (h, d)) for t in (q, v))
    b, nq, hh, d = q.shape
    out = torch.empty((b, nq, hh, d), dtype=torch.bfloat16, device=q.device)
    tail = (_lab_code(mode), tile[0] // fa.SM90_CONSUMER_ROWS, tile[1])

    def call():
        err = fn(q.data_ptr(), k.data_ptr(), None if sk is None else sk.data_ptr(), pitch,
                 v.data_ptr(), out.data_ptr(), b, hh, nq, k.shape[1], d, *q.stride()[:3],
                 *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], d ** -0.5, *tail,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"attention_sm90_lab launch failed: {err}")

    return call, out.flatten(2) if mode == "int8_rowk" else out


def _int8_parent_call(fn, q, k, v, h):
    """L4's parent `int8_attn_kernel` (an nvcc copy of
    `int8_attention.cu`) on packed (B, N, H*D) inputs with the plain
    prologue's dense codes and scales, at `int8_block_q` query rows per
    block; returns (call, out)."""
    b, n, hd = q.shape
    codes, sk = fa._quant_k_per_row(k, h)
    out = torch.empty_like(q)

    def call():
        err = fn(q.data_ptr(), codes.data_ptr(), sk.data_ptr(), 1, v.data_ptr(), out.data_ptr(),
                 b, h, n, n, hd // h, q.stride(0), q.stride(1), codes.stride(0), codes.stride(1),
                 v.stride(0), v.stride(1), out.stride(0), out.stride(1), (hd // h) ** -0.5,
                 fa.int8_block_q(n), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"int8_attention launch failed: {err}")

    return call, out


def _lab_plain(q, k, v, mode, h=None):
    """A lab mode's plain version in fp32 on the same bf16 inputs."""
    args = (q.float(), k.float(), v.float())
    if mode == "int8_rowk":
        return fa._torch_int8_attention(*args, h, (q.shape[-1] // h) ** -0.5, row_k=True)
    plain = fa._torch_attention_no_softmax if mode == "no_softmax" else fa._torch_attention
    return plain(*args, q.shape[-1] ** -0.5)


def _lab_work(b, n, h, d, mode):
    """(bytes, int8 ops, bf16 ops, exponentials) of a lab mode's call."""
    ops = 2 * b * h * n * n * d
    if mode == "int8_rowk":
        return 8 * b * n * h * d, ops, ops, b * h * n * n
    return 8 * b * n * h * d, 0, 2 * ops, 0 if mode == "no_softmax" else b * h * n * n


def lab(gen, iters, quick=False):
    """L1, L2, L3 and L4 on the sm90 kernel: the build, ptxas and SASS
    report, the plans, errors, then times beside the parent, K1, SDPA and
    the ablated copies."""
    os.makedirs(OUT_DIR, exist_ok=True)
    stub = os.path.join(OUT_DIR, "no_int8.cu")
    open(stub, "w").write(_NO_INT8)
    t0 = time.perf_counter()
    builds = {}
    for name, flags in SM90_COPIES.items():
        if quick and flags:
            continue
        lib = os.path.join(OUT_DIR, f"lab_{re.sub(r'\W+', '_', name)}.so")
        builds[name] = lib, _nvcc(_LAB + (stub,), lib, "-shared", "-Xcompiler", "-fPIC",
                                  f"-I{_CSRC_DIR}", *flags)
    int8_lib = os.path.join(OUT_DIR, "lab_int8_parent.so")
    int8_proc = _nvcc(os.path.join(_CSRC_DIR, "int8_attention.cu"), int8_lib, "-shared",
                      "-Xcompiler", "-fPIC")
    parent_lib, parent_proc = _compile("lab parent", [])
    for lib, proc in ((parent_lib, parent_proc), (int8_lib, int8_proc)):
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {lib}:\n{out[-3000:]}")
    fns = {}
    for name, (lib, proc) in builds.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {lib}:\n{out[-4000:]}")
        fns[name] = _lab_fn(lib)
        if name == "kernel":
            print(f"[attn_tune] lab build: {time.perf_counter() - t0:.1f}s", flush=True)
            rows, warnings = _ptxas(out, _LAB_KERNELS + ("attn_sm90_bf16_kernel",))
            for kname, info in rows.items():
                print(f"[attn_tune] lab ptxas {_demangled(kname)}: {info}", flush=True)
            print(f"[attn_tune] lab ptxas warnings: {warnings or 'none'}", flush=True)
            for kname, ops in _sass_counts(lib, _LAB_KERNELS).items():
                print(f"[attn_tune] lab sass {_demangled(kname)}: {ops}", flush=True)
    lib = ctypes.CDLL(builds["kernel"][0])
    modes = dict(fa.SM90_LAB_HEAD_DIMS, int8_rowk=fa.SM90_ROWK_HEAD_DIMS)
    instances = [(mode, d, tile) for mode, dims in modes.items() for d in dims
                 for tile in _lab_tiles(d, mode)]
    for mode, d, tile in instances:
        built = lib.pd_attention_sm90_lab_smem(d, _lab_code(mode), tile[0] // fa.SM90_CONSUMER_ROWS,
                                               tile[1])
        want = _lab_smem(d, mode, tile)
        print(f"[attn_tune] lab plan {mode} D={d} {tile}: smem {built} as built, {want} in "
              f"the plan", flush=True)
        if built != want:
            raise RuntimeError(f"the lab plan of {mode} at D = {d}, {tile} disagrees with the "
                               f"build")
    parent, k1 = _parent_fn(parent_lib), _sm90_fn(builds["kernel"][0])
    int8_parent = _int8_parent_fn(int8_lib)
    bf = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
    for mode, d, tile in instances:
        for n in (77, 1100):
            h = 3
            if mode == "int8_rowk":
                q, k, v = bf(2, n, h * d), bf(2, n, h * d), bf(2, n, h * d)
            else:
                q, k, v = bf(2, n, h, d), bf(2, n, h, d), bf(2, n, h, d)
            call, out = _lab_call(fns["kernel"], q, k, v, mode, tile, h)
            call()
            ref = _lab_plain(q, k, v, mode, h)
            err = (out.float() - ref).abs().max().item()
            print(f"[attn_tune] lab check {mode} D={d} {tile[0]}x{tile[1]} {tuple(q.shape)}: "
                  f"max_abs_err={err:.3g} ({err / ref.abs().max().item():.3g} of the largest "
                  f"output) finite={bool(torch.isfinite(out).all())}", flush=True)
    for label, b, n, h, d, mode in LAB_SHAPES:
        int8 = mode == "int8_rowk"
        shape = (b, n, h * d) if int8 else (b, n, h, d)
        q, k, v = bf(*shape), bf(*shape), bf(*shape)
        cands = {}
        for tile in _lab_tiles(d, mode, n):
            cands[f"sm90 {tile[0]}x{tile[1]}"] = _lab_call(fns["kernel"], q, k, v, mode, tile,
                                                           h)[0]
        if int8:
            cands[f"parent bq{fa.int8_block_q(n)}"] = _int8_parent_call(int8_parent, q, k, v, h)[0]
        else:
            for tile in fa.sm90_lab_tiles(d, mode):
                ptile = fa.lab_parent_tile(tile)
                cands[f"parent {ptile[0]}x{ptile[1]}"] = _strided_call(
                    parent, q, k, v, (fa._MODES[mode], *ptile))[0]
        flat = (q, k, v) if int8 else (q.flatten(2), k.flatten(2), v.flatten(2))
        cands["k1 sm90"] = _sm90_call(k1, *flat, h, False)[0]
        heads = (lambda t: t.view(b, n, h, d).transpose(1, 2)) if int8 else (
            lambda t: t.transpose(1, 2))
        if mode != "no_softmax":
            cands["sdpa"] = lambda: F.scaled_dot_product_attention(*(heads(t) for t in (q, k, v)))
        times = {c: [] for c in cands}
        for c in list(cands) + list(cands)[::-1]:
            times[c].append(device_ms(cands[c], iters=iters))
        bound_ms, bound_by = roofline(*_lab_work(b, n, h, d, mode))
        print(f"[attn_tune] lab time {label} ({b},{n},{h},{d}) {mode}: device_ms "
              + " ".join(f"{c}={'/'.join(f'{t:.4f}' for t in ts)}" for c, ts in times.items())
              + f" bound={bound_ms:.4f} ({bound_by})", flush=True)
        for name, fn in fns.items():
            if name == "kernel":
                continue
            tile = _lab_tiles(d, mode, n)[0] if int8 else fa.sm90_lab_tile(d)
            acall = _lab_call(fn, q, k, v, mode, tile, h)[0]
            print(f"[attn_tune] lab copy {label} {mode}: {name} "
                  f"device_ms={device_ms(acall, iters=iters):.4f}", flush=True)


# the translation units of K1's, K9's and the lab modes' instantiations
# (an older checkout holds L3's in attention_sm90_lab.cu)
SASS_UNITS = ("attention_sm90_bf16.cu", "attention_sm90_int8.cu", "attention_sm90_lab.cu",
              "attention_sm90_lab_two_pass.cu")


def sass(csrc):
    """SHA-1 digests of the SASS of every K1, K9 and lab instantiation
    built from the sources in `csrc` (the translation units of SASS_UNITS
    it holds), each instruction without its address and encoding; the
    instructions themselves go to
    `build/attn_tune/sass_<digest of csrc's path>/<kernel>.sass`, for a
    diff."""
    import hashlib

    from torch.utils.cpp_extension import CUDA_HOME

    os.makedirs(OUT_DIR, exist_ok=True)
    tag = hashlib.sha1(os.path.abspath(csrc).encode()).hexdigest()[:8]
    procs = {}
    for unit in (u for u in SASS_UNITS if os.path.exists(os.path.join(csrc, u))):
        cubin = os.path.join(OUT_DIR, f"sass_{tag}_{unit}.cubin")
        procs[unit] = cubin, _nvcc(os.path.join(csrc, unit), cubin, "-cubin")
    for unit, (cubin, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {unit}:\n{out[-3000:]}")
        dump = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", cubin],
                              capture_output=True, text=True, check=True).stdout
        funcs, cur = {}, None
        for line in dump.splitlines():
            m = re.search(r"Function : (\w+)", line)
            if m:
                cur = m.group(1)
                funcs[cur] = []
            elif cur:
                ins = re.sub(r"/\*.*?\*/", "", line).strip()
                if ins:
                    funcs[cur].append(" ".join(ins.split()))
        keep = os.path.join(OUT_DIR, f"sass_{tag}")
        os.makedirs(keep, exist_ok=True)
        for name, lines in sorted(funcs.items()):
            digest = hashlib.sha1("\n".join(lines).encode()).hexdigest()[:16]
            with open(os.path.join(keep, re.sub(r"\W+", "_", _demangled(name)) + ".sass"),
                      "w") as f:
                f.write("\n".join(lines) + "\n")
            print(f"[attn_tune] sass {os.path.abspath(csrc)} {_demangled(name)}: {digest} "
                  f"({len(lines)} lines)", flush=True)


def _wrappers(q, k, v, heads, int8):
    """(the wrapper's call, its parent design's call) of K1, K2 (packed (B,
    N, H*D) inputs viewed as (B, N, H, D)) or K9."""
    if int8:
        scale = (q.shape[-1] // heads) ** -0.5
        return (lambda: fa._int8_launch(q, k, v, heads, scale),
                lambda: fa._int8_parent_launch(q, k, v, heads, scale))
    q, k, v = (t.unflatten(-1, (heads, -1)) for t in (q, k, v))
    d = q.shape[-1]
    return (lambda: fa._launch(q, k, v, d ** -0.5),
            lambda: fa._parent_launch(q, k, v, d ** -0.5, "online", fa.kernel_tile(d)))


def _wrapper_host_us(q, k, v, heads, int8=False):
    """Host us a call of K1's, K2's or K9's wrapper and of its parent's
    wrapper (where the parent takes the head width)."""
    wrapper, parent = _wrappers(q, k, v, heads, int8)
    row = {"wrapper": _host_us(wrapper)}
    if not int8 or q.shape[-1] // heads in getattr(fa, "INT8_PARENT_HEAD_DIMS", (32, 64, 128)):
        row["parent"] = _host_us(parent)
    return row


def _k9_parts_host_us(q, k, v, h):
    """Host us of the parts of K9's wrapper: its checks, the setup lookup
    (cached), the two allocations, K9p's bare launch."""
    b, n, hd = q.shape
    d = hd // h
    from prompt_diffusion_tpu_torch.ops._build import cuda_ext

    ext = cuda_ext()
    plan, qk, off_sk, off_ws, nbytes = fa._int8_sm90_setup(b, n, n, h, d, q.device.index)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
    codes = scratch.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    return {
        "checks": _host_us(lambda: fa._check_int8(q, k, v, h, d ** -0.5)),
        "setup": _host_us(lambda: fa._int8_sm90_setup(b, n, n, h, d, q.device.index)),
        "alloc x2": _host_us(lambda: (torch.empty(nbytes, dtype=torch.uint8, device=q.device),
                                      torch.empty((b, n, hd), dtype=torch.bfloat16,
                                                  device=q.device))),
        "K9p bare": _host_us(lambda: ext.int8_quant_k_head(
            k.data_ptr(), k.stride(0), k.stride(1), b, h, n, d, qk.rows, qk.threads, qk.bps,
            codes + off_ws, codes + off_sk, codes, plan.k_head_bytes, stream)),
    }


def host(gen, iters):
    """Where the sm90 wrappers' host us go, at the path shapes of K1, K2
    and K9 and K2's two VAE shapes: the whole wrapper, its three
    `sm90_check_view` calls, the plan lookups, the bare extension call, the
    parent's wrapper. It runs against an older checkout too
    (`PYTHONPATH=<checkout> python3 <this file> --part host`): what that
    build lacks (the wide sm90 kernel) is left out of its rows."""
    from prompt_diffusion_tpu_torch.ops._build import cuda_ext

    ext = cuda_ext()
    shapes = list(SM90_SHAPES) + [("K2 VAE", b, n, h, d, False, False)
                                  for b, n, h, d in WIDE_SHAPES[:2]]
    for label, b, n, h, d, int8, slices in shapes:
        q, k, v = _sm90_inputs(gen, b, n, h, d, slices)
        try:
            row = _wrapper_host_us(q, k, v, h, int8)
        except ValueError as e:  # an older package without K9 at this head width
            print(f"[attn_tune] host {label}: refused ({e})", flush=True)
            continue
        if int8 and hasattr(fa, "_int8_sm90_setup"):
            row.update(_k9_parts_host_us(q, k, v, h))
        q4, k4, v4 = (t.unflatten(-1, (h, d)) for t in (q, k, v))
        row["check_view x3"] = _host_us(lambda: [fa.sm90_check_view(nm, t) for nm, t in
                                                 (("q", q4), ("k", k4), ("v", v4))])
        out = torch.empty_like(q4)
        stream = torch.cuda.current_stream().cuda_stream
        bare = None
        if d > fa.NARROW_D:
            if hasattr(fa, "wide_plan"):
                row["plan"] = _host_us(lambda: fa.wide_plan(d))
                args = (q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(), b, h, n, n,
                        d, *q4.stride()[:3], *k4.stride()[:3], *v4.stride()[:3],
                        *out.stride()[:3], d ** -0.5, stream)
                bare = lambda: ext.attention_sm90_wide_fwd(*args)
        else:
            kk, sk = _k9_codes(k, h) if int8 else (k4, None)
            row["plan"] = _host_us(lambda: fa.sm90_plan(d, int8, fa.sm90_consumers(d, int8, n, n)))
            args = (q4.data_ptr(), kk.data_ptr(), sk.data_ptr() if int8 else 0, v4.data_ptr(),
                    out.data_ptr(), int8, b, h, n, n, d, *q4.stride()[:3], *kk.stride()[:3],
                    *v4.stride()[:3], *out.stride()[:3], d ** -0.5,
                    fa.sm90_consumers(d, int8, n, n), stream)
            bare = lambda: ext.attention_sm90_fwd(*args)
        if bare is not None:
            row["bare call"] = _host_us(bare)
        print(f"[attn_tune] host {label} ({b},{n},{h * d}) H={h}: host_us "
              + " ".join(f"{k}={u:.1f}" for k, u in row.items()), flush=True)


PARTS = {"sweep": sweep, "int8": int8, "ablate": ablate, "sm90": sm90, "wide": wide,
         "host": host, "lab": lab, "sass": sass}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--part", choices=PARTS, action="append",
                    help="a part to run (repeatable; all when not given)")
    ap.add_argument("--quick", action="store_true",
                    help="sm90, wide: no extension build (sm90: the kernel's own copy, errors "
                         "and times beside SDPA only); lab: no ablated copies")
    ap.add_argument("--csrc", default=_CSRC_DIR,
                    help="sass: the directory of the sources to digest (this package's)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attn_tune: no CUDA device", file=sys.stderr)
        return 2
    print(f"[attn_tune] {card()} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for part in args.part or PARTS:
        if part == "sass":
            sass(args.csrc)
        elif part in ("sm90", "wide", "lab"):
            PARTS[part](gen, args.iters, args.quick)
        else:
            PARTS[part](gen, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
