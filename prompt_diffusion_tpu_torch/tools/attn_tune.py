"""K1's and K9's tiles and what bounds them, on the card.

    python3 -m prompt_diffusion_tpu_torch.tools.attn_tune [--iters N] [--part sweep|int8|ablate]

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
            on the consumer count its plan did not take), its parent and
            SDPA (where one call computes the function) at the path shapes,
            and of each other copy, and the host us a call spends in the
            wrapper. With `--quick` only the kernel's copy,
            its errors and its times beside SDPA (no parent: the extension
            is not built).

The K1 parts' times are CUDA-event medians. It needs one CUDA card and
nvcc; without a card it exits 2.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from prompt_diffusion_tpu_torch.ops import flash_attention as fa
from prompt_diffusion_tpu_torch.tools.timing import card, device_ms, time_ms

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
        times = {tile: time_ms(lambda tile=tile: fa._launch(q, k, v, d ** -0.5, "online", tile),
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
            times[bq].append(device_ms(lambda bq=bq: fa._int8_launch(q, k, v, h, d ** -0.5,
                                                                    per_row, bq), iters=iters))
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
)
# every instantiation, with ragged and short key and query lengths
SM90_CHECKS = tuple((f"D={d}{' int8' if i8 else ''} N={n}", 2, n, 3, d, i8, sl)
                    for d, i8 in ((40, False), (64, False), (80, False), (128, False),
                                  (32, True), (64, True), (128, True))
                    for n, sl in ((77, False), (1100, True)))
# the sm90 kernel's instantiations: (D, int8, consumers)
SM90_INSTANCES = ((40, False, 3), (64, False, 3), (80, False, 2), (128, False, 2),
                  (32, True, 3), (32, True, 2), (64, True, 3), (64, True, 2), (128, True, 2))
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


def _sm90_call(fn, q, k, v, h, int8, consumers=None):
    """A call of a library copy on packed (B, N, H*D) inputs on `consumers`
    warpgroups (the plan's by default; K9: codes and scales from the plain
    prologue, bit-equal to K9p); returns (call, out)."""
    b, nq, hd = q.shape
    d = hd // h
    consumers = consumers or fa.sm90_consumers(d, int8, nq, k.shape[1])
    sk = None
    if int8:
        k, sk = fa._quant_k_per_head(k, h)
    heads = lambda t: t.unflatten(-1, (h, d))
    q4, k4, v4 = heads(q), heads(k), heads(v)
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


def _host_us(fn, calls=200):
    """Host microseconds a call spends before it returns (enqueue only)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return host


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
        if not int8:
            cands["sdpa"] = lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                                                   scale=scale)
        if not quick:
            if int8:  # both with K9p, the prologue
                cands["wrapper"] = lambda: fa._int8_launch(q, k, v, h, scale)
                cands["parent"] = lambda: fa._int8_launch(q, k, v, h, scale, False,
                                                          fa.int8_block_q(n))
            else:
                q4, k4, v4 = (t.unflatten(-1, (h, d)) for t in (q, k, v))
                cands["wrapper"] = lambda: fa._launch(q4, k4, v4, scale)
                cands["parent"] = lambda: fa._launch(q4, k4, v4, scale, "online",
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


PARTS = {"sweep": sweep, "int8": int8, "ablate": ablate, "sm90": sm90}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--part", choices=PARTS, action="append",
                    help="a part to run (repeatable; all when not given)")
    ap.add_argument("--quick", action="store_true",
                    help="sm90: the kernel's own copy, errors and times beside SDPA only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attn_tune: no CUDA device", file=sys.stderr)
        return 2
    print(f"[attn_tune] {card()} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for part in args.part or PARTS:
        if part == "sm90":
            sm90(gen, args.iters, args.quick)
        else:
            PARTS[part](gen, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
