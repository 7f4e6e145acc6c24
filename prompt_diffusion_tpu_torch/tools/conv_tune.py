"""K8, the int8 3x3 conv, against an earlier copy of its source, on the card.

    python3 -m prompt_diffusion_tpu_torch.tools.conv_tune [--parent PATH] [--iters N]
        [--part ptxas|check|time|splits]

  ptxas   nvcc -Xptxas=-v on `ops/csrc/int8_conv.cu`: the registers, spills
          and static shared memory of every kernel instantiation;
  check   both variants through their wrappers against the plain version,
          bit for bit, at SHAPES and at ragged ones, with the plan's split
          count and with forced ones (`conv_plan(splits=...)`);
  time    the device ms (`tools/timing.py::device_ms`) of both variants at
          SHAPES, this source through its wrappers and the source at PATH
          (an earlier `int8_conv.cu`, with the launcher signature it had
          before split-K, built by nvcc into a library under `build/conv_tune/`
          and called through ctypes), timed in turns (parent, new, new,
          parent); beside them the plan's split count, the bound and one
          bf16 `F.conv2d` over channels_last tensors at the same shape (cuDNN:
          not the same function, the bar an int8 conv must clear for the int8
          serving mode to pay). Without a file at PATH the parent columns are
          left out;
  splits  each variant's device ms at every split count up to 8 on the
          shapes whose tiles fill less than a wave: the data behind
          `conv_plan`'s rule.

PATH defaults to `build/conv_parent/int8_conv.cu`; write it before the
call, e.g. `git show HEAD~1:prompt_diffusion_tpu_torch/ops/csrc/int8_conv.cu`.
Needs one CUDA card and nvcc; without a card it exits 2.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import sys

import torch
import torch.nn.functional as F

from prompt_diffusion_tpu_torch.ops import int8_conv as ic
from prompt_diffusion_tpu_torch.ops.dispatch import plain_ops
from prompt_diffusion_tpu_torch.tools.attn_tune import _CSRC_DIR, _REPO, _nvcc
from prompt_diffusion_tpu_torch.tools.timing import card, device_ms, roofline

OUT_DIR = os.path.join(_REPO, "build", "conv_tune")
PARENT = os.path.join(_REPO, "build", "conv_parent", "int8_conv.cu")
# (B, H, W, Cin, Cout): the SD1.5 int8 sites at CFG batch 8 that carry most
# of a step's operations, the 8x8 latents (split-K), a Cin that 128 does not
# divide, the latent input conv (Cin = 4), the CFG batch 4 of the profiled
# step at 8x8 and 16x16, and the int8 VAE's 512-wide rows
SHAPES = ((8, 64, 64, 320, 320), (8, 32, 32, 640, 640), (8, 16, 16, 1280, 1280),
          (8, 8, 8, 1280, 1280), (8, 8, 8, 2560, 1280), (8, 64, 64, 960, 320),
          (8, 64, 64, 4, 320), (4, 8, 8, 1280, 1280), (4, 16, 16, 1280, 1280),
          (2, 512, 512, 128, 128))
# ragged pixel, channel and K tails; the last two take 256-pixel tiles
# (a 251-wide row: xshift's x tiling; 101 wide: its tall tiles)
RAGGED = ((3, 5, 11, 48, 72), (2, 7, 9, 24, 40), (1, 3, 130, 32, 16), (5, 8, 8, 176, 136),
          (3, 45, 251, 32, 16), (5, 67, 101, 48, 24))
VARIANTS = ("im2col", "xshift")


def conv_inputs(gen, b, h, w, cin, cout, bias=True):
    """Uniform int8 codes, scales and an N(0, 1) bias on the card."""
    codes = lambda *s: torch.randint(-127, 128, s, generator=gen, device="cuda",
                                     dtype=torch.int8)
    uniform = lambda n, lo, hi: lo + (hi - lo) * torch.rand(n, generator=gen, device="cuda")
    return (codes(b, h, w, cin), uniform(b, 0.01, 0.1), codes(cout, 3, 3, cin),
            uniform(cout, 1e-4, 1e-3),
            torch.randn(cout, generator=gen, device="cuda") if bias else None)


def conv_work(b, h, w, cin, cout, out_bytes=2):
    """(bytes, int8 ops) of the function: each input read once, the output
    written once."""
    nbytes = b * h * w * (cin + out_bytes * cout) + 9 * cin * cout + 4 * (b + 2 * cout)
    return nbytes, 2 * b * h * w * cout * 9 * cin


def bf16_conv(gen, b, h, w, cin, cout):
    """A bf16 SAME 3x3 conv over channels_last tensors at the shape (cuDNN)."""
    x = torch.randn(b, cin, h, w, generator=gen, device="cuda").to(torch.bfloat16)
    wt = torch.randn(cout, cin, 3, 3, generator=gen, device="cuda").to(torch.bfloat16)
    x, wt = (t.contiguous(memory_format=torch.channels_last) for t in (x, wt))
    bias = torch.randn(cout, generator=gen, device="cuda").to(torch.bfloat16)
    return lambda: F.conv2d(x, wt, bias, padding=1)


def ptxas(_gen, _iters):
    """Registers, spills and shared memory of every instantiation."""
    os.makedirs(OUT_DIR, exist_ok=True)
    out, _ = _nvcc(os.path.join(_CSRC_DIR, "int8_conv.cu"), os.path.join(OUT_DIR, "int8_conv.o"),
                   "-c").communicate()
    lines = out.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\w*?(conv3x3_int8\w*?kernel|splitk_\w*?kernel)"
                      r"(?:ILb(\d)E(?:Li(\d)E)?)?", line)
        if m:
            info = " | ".join(x.split(":", 2)[-1].strip() for x in lines[i + 1:i + 4]
                              if "registers" in x or "spill" in x or "smem" in x)
            targs = "" if m.group(2) is None else f"<VEC={m.group(2)}" + (
                "" if m.group(3) is None else f", MT={m.group(3)}") + ">"
            print(f"[conv_tune] ptxas {m.group(1)}{targs}: {info}", flush=True)
    if "error" in out.lower():
        print(out[-3000:], flush=True)


def check(gen, _iters):
    """Both variants bit-equal to the plain version, plan and forced splits;
    each case names the plan's tile height."""
    failed = []
    for shape in SHAPES + RAGGED:
        b, h, w, cin, cout = shape
        for bias, dt in ((True, torch.bfloat16), (False, torch.float32)):
            args = conv_inputs(gen, *shape, bias=bias)
            with plain_ops():
                ref = ic.conv3x3_int8(*args, dt)
            for variant in VARIANTS:
                plan = ic.conv_plan(*shape, variant=variant)
                for splits in sorted({plan.splits, 1, 3}):
                    got = ic._launch(*args, dt, variant == "xshift", splits)
                    ok = torch.equal(got, ref)
                    err = (got.float() - ref.float()).abs().max().item()
                    forced = ic.conv_plan(*shape, variant=variant, splits=splits).splits
                    print(f"[conv_tune] check {shape} {variant} {dt} bias={bias} "
                          f"block_m={plan.block_m} splits={forced}"
                          f"{' (plan)' if splits == plan.splits else ''}: "
                          f"{'bit-equal' if ok else f'DIFFERS, max abs {err}'}", flush=True)
                    if not ok:
                        failed.append((shape, variant, dt, splits))
            del ref
    if failed:
        raise RuntimeError(f"K8 differs from its plain version: {failed}")


def _parent():
    """The parent's two launchers through ctypes, or None without a copy."""
    if not os.path.isfile(PARENT):
        return None
    os.makedirs(OUT_DIR, exist_ok=True)
    lib = os.path.join(OUT_DIR, "parent_int8_conv.so")
    out, _ = _nvcc(PARENT, lib, "-shared", "-Xcompiler", "-fPIC").communicate()
    if not os.path.isfile(lib):
        raise RuntimeError(f"nvcc failed on {PARENT}:\n{out[-3000:]}")
    so = ctypes.CDLL(lib)
    fns = {}
    for variant, name in (("im2col", "pd_conv3x3_int8"), ("xshift", "pd_conv3x3_int8_xshift")):
        fn = getattr(so, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[variant] = fn
    return fns


def _parent_call(fn, xq, s_a, wq, s_w, bias):
    b, h, w, cin = xq.shape
    cout = wq.shape[0]
    out = torch.empty((b, h, w, cout), dtype=torch.bfloat16, device="cuda")

    def call():
        err = fn(xq.data_ptr(), wq.data_ptr(), s_a.data_ptr(), s_w.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), b, h, w, cin, cout, 1, int(cin % 16 == 0),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent launch failed: {err}")
        return out

    return call


def time_(gen, iters):
    """Device ms of the parent and of this source, in turns, per shape."""
    parent = _parent()
    for shape in SHAPES:
        b, h, w, cin, cout = shape
        args = conv_inputs(gen, *shape)
        bound, _ = roofline(*conv_work(*shape))
        row = []
        for variant in VARIANTS:
            xshift = variant == "xshift"
            new = lambda: ic._launch(*args, torch.bfloat16, xshift)
            if parent is None:
                times = {"new": [device_ms(new, iters=iters), device_ms(new, iters=iters)]}
            else:
                old = _parent_call(parent[variant], *args)
                with plain_ops():
                    ref = ic.conv3x3_int8(*args)
                if not torch.equal(old(), ref):
                    raise RuntimeError(f"the parent's {variant} kernel differs at {shape}")
                times = {"parent": [], "new": []}
                for who in ("parent", "new", "new", "parent"):
                    times[who].append(device_ms(old if who == "parent" else new, iters=iters))
            best = {who: min(ts) for who, ts in times.items()}
            plan = ic.conv_plan(*shape, variant=variant)
            row.append(f"{variant} block_m={plan.block_m} splits={plan.splits} "
                       + " ".join(f"{who}={'/'.join(f'{t:.4f}' for t in ts)}"
                                  for who, ts in times.items())
                       + f" share_of_bound={bound / best['new']:.3f}")
        cudnn = device_ms(bf16_conv(gen, *shape), iters=iters)
        print(f"[conv_tune] time {shape} bound_ms={bound:.4f} bf16_conv_device_ms={cudnn:.4f} | "
              + " | ".join(row), flush=True)


def splits(gen, iters):
    """Device ms at every split count on the shapes that fill less than a wave."""
    for shape in SHAPES:
        args = conv_inputs(gen, *shape)
        for variant in VARIANTS:
            plan = ic.conv_plan(*shape, variant=variant)
            wave = ic.SMS * ic.blocks_per_sm(variant, plan.block_m)
            if plan.m_tiles * plan.n_tiles >= wave or shape[3] % 16:
                continue
            times = {}
            for s in range(1, ic.MAX_SPLITS + 1):
                forced = ic.conv_plan(*shape, variant=variant, splits=s).splits
                if forced not in times:
                    times[forced] = device_ms(
                        lambda: ic._launch(*args, torch.bfloat16, variant == "xshift", forced),
                        iters=iters)
            print(f"[conv_tune] splits {shape} {variant} plan={plan.splits}: "
                  + " ".join(f"{s}={t:.4f}" for s, t in times.items()), flush=True)


PARTS = {"ptxas": ptxas, "check": check, "time": time_, "splits": splits}


def main(argv=None) -> int:
    global PARENT
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--parent", default=PARENT, help="an earlier int8_conv.cu to time against")
    ap.add_argument("--part", choices=PARTS, action="append",
                    help="a part to run (repeatable; all when not given)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("conv_tune: no CUDA device", file=sys.stderr)
        return 2
    PARENT = args.parent
    print(f"[conv_tune] {card()} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for part in args.part or PARTS:
        PARTS[part](gen, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
