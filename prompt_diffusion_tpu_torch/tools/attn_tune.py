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
            data behind that rule.

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
    """Start nvcc for sm_90a with ptxas's report on `src`; returns the process."""
    from torch.utils.cpp_extension import CUDA_HOME

    cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), "-gencode=arch=compute_90a,code=sm_90a",
           "-O3", "-std=c++17", "-Xptxas=-v", *flags, "-o", out, src]
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


PARTS = {"sweep": sweep, "int8": int8, "ablate": ablate}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--part", choices=PARTS, action="append",
                    help="a part to run (repeatable; all when not given)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attn_tune: no CUDA device", file=sys.stderr)
        return 2
    print(f"[attn_tune] {card()} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for part in args.part or PARTS:
        PARTS[part](gen, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
