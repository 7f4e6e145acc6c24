"""Where the time of one SD1.5 request goes on the card.

    python3 -m prompt_diffusion_tpu_torch.tools.profile_sd15 [--int8 [--conv-variant xshift]
        [--int8-attention] [--unfused-geglu]]
    python3 -m prompt_diffusion_tpu_torch.tools.profile_sd15 --vae

Builds SD1.5 at the default widths (bf16 policy, or with `--int8` the int8
W8A8 serving policy with the int8 VAE, its 3x3 convs through K8's
`--conv-variant`, with `--int8-attention` the 64² and 32² self-attention
through K9 and with `--unfused-geglu` the GEGLU without K7; random weights
from a seed), the configurations
`chip_smoke.py` runs, and one request of batch 2 at 512² with CFG 9. Every part runs once to warm up (kernel builds, Triton
compiles, cuDNN heuristics). Then:
  * the wall time of each part of the request, synchronised, median of 3:
    the two CLIP encodes, the hint encoders, one CFG denoise step
    (ControlNet + UNet on the double batch) and the VAE decode;
  * a torch.profiler trace of three denoise steps: device time by kernel
    name, device launches per step, and the device's busy share of the
    profiled wall time (the union of the kernels' device intervals);
  * under the int8 policy, the int8 GEMMs of one step (QuantDense, the 1x1
    and stride-2 QuantConv) and the least time they could take with the
    dequant fused into them (G1 in ROADMAP.md); K8's calls of one step (the
    3x3 stride-1 QuantConv), by shape, their int8 operations and least
    time, and K8's device ms per step from the trace (its kernels and the
    split-K epilogue); K5's, K6's and K7's calls of one step (GroupNorm ->
    int8, LayerNorm -> int8 and GEGLU -> int8), by shape, each shape's
    byte bound, its device ms and device launches per call alone
    (`timing.device_ms`, warm, seeded inputs of the shape), and their sums
    per step; and K5's, K6's and K7's device ms and launches per step from
    the trace, by kernel name (`EPILOGUE_NAMES`);
  * under either policy, K3's device ms and launches per step from the
    trace, and those of its parent design (`K3_K9P_NAMES`; the bf16 step
    makes 88 K3 calls); and the attention kernels' (`ATTN_NAMES`: K1 and
    K2 on `attention_sm90.cuh` and on `flash_attention.cu`'s wide kernel,
    and from an older checkout the narrow parent).
With `--vae`, the bf16 VAE decode of one request alone: its wall time
(median of 3) and a torch.profiler trace of one decode, with the device
ms and launches of K2 at D = 512 (`attention_sm90_wide.cuh`, or the
parent `fa_wide_kernel` from an older checkout) and of K3.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch

from prompt_diffusion_tpu_torch.tools.timing import (
    busy_us,
    card,
    device_kernels,
    device_trace,
    roofline,
)

BATCH, SIZE, CFG = 2, 512, 9.0
STEPS, TOP = 3, 30  # denoise steps traced, kernel names printed
# K5's, K6's and K7's device functions, by a part of their name: the CUDA
# C++ kernels (`gn_quant_kernel`, `ln_quant_kernel`, `geglu_quant_kernel`),
# or in the former designs (run from an older checkout for a comparison)
# Triton programs of the same names, K5's after a fill of its amax slots
# and K3's stats and combine programs (`gn_stats_kernel`,
# `gn_combine_kernel`, which K3's own calls launched too before
# `gn_float_kernel`). No SD1.5 step runs K13's `adaln_quant_kernel`, whose
# name holds K6's.
EPILOGUE_NAMES = (("K7", ("geglu_quant_kernel",)), ("K6", ("ln_quant_kernel",)),
                  ("K5", ("gn_quant_kernel", "gn_amax_kernel")),
                  ("K3's stats and combine (K5's, then)", ("gn_stats_kernel",
                                                           "gn_combine_kernel")))


# K3's and K9p's device functions, by a part of their name: the CUDA kernels
# (`gn_float_kernel`, `k_head_quant_kernel`), and from an older checkout
# their parent designs: K3's three Triton programs, K9p's amax and codes
# kernels after a memset (`cudaMemsetAsync` shows as "Memset")
K3_K9P_NAMES = (("K3", ("gn_float_kernel",)),
                ("K3's parent (Triton stats, combine, apply)",
                 ("gn_stats_kernel", "gn_combine_kernel", "gn_apply_kernel")),
                ("K9p", ("k_head_quant_kernel",)),
                ("K9p's parent (amax, codes)", ("k_amax_kernel", "k_codes_kernel")),
                ("memsets", ("Memset",)))


# the attention kernels by a part of their name: K1 and K2 on
# `attention_sm90.cuh` (and K9 there under int8), K2 at D = 512 on
# `attention_sm90_wide.cuh`, and the parents (`fa_wide_kernel`,
# `fa_narrow_kernel`, `int8_attn_kernel`), which an older checkout's paths
# launch
ATTN_NAMES = (("K1/K2 sm90", ("attn_sm90_bf16_kernel",)),
              ("K2 wide sm90", ("attn_sm90_wide_kernel",)),
              ("K1/K2 wide parent", ("fa_wide_kernel",)),
              ("K1/K2 narrow parent", ("fa_narrow_kernel",)),
              ("K9 sm90", ("attn_sm90_int8_kernel",)), ("K9 parent", ("int8_attn_kernel",)))


def trace_by_name(fn):
    """One call of `fn` under the profiler: ({kernel name: (launches, device
    us)}, device busy us, wall us, device launches)."""
    with device_trace() as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_kernels(prof)
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    by_name = {}
    for name, s, e in kernels:
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + (e - s))
    return by_name, busy_us([(s, e) for _, s, e in kernels]), wall_us, len(kernels)


def print_named(by_name, count, unit, table=K3_K9P_NAMES):
    """Device ms and launches per `unit` of the kernels whose names hold a
    part listed in `table`, from {name: (launches, µs)} over `count`
    units."""
    for label, parts in table:
        hits = [(n, us) for name, (n, us) in by_name.items() if any(p in name for p in parts)]
        print(f"[profile] {label} in the trace: {sum(us for _, us in hits) / count / 1e3:.3f} "
              f"device ms, {sum(n for n, _ in hits) / count:.0f} launches per {unit}")


def _wall_ms(fn, reps=3):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def int8_gemm_bound(step):
    """Runs `step` once, recording every int8 GEMM of `QuantDense` and
    `QuantConv` (`ops.quant.int8_matmul`, M x K by N x K); returns (calls,
    int8 ops, bytes, bound ms) of those GEMMs with the dequant fused: each
    reads its int8 operands once and writes a bf16 (M, N) output, and the
    bound is the sum over the calls of each call's roofline."""
    from prompt_diffusion_tpu_torch.ops import quant

    shapes, real = [], quant.int8_matmul

    def record(a, w):
        shapes.append((a.shape[0], a.shape[1], w.shape[0]))
        return real(a, w)

    quant.int8_matmul = record
    try:
        step()
    finally:
        quant.int8_matmul = real
    ops = sum(2 * m * k * n for m, k, n in shapes)
    nbytes = sum(m * k + n * k + 2 * m * n for m, k, n in shapes)
    bound = sum(roofline(m * k + n * k + 2 * m * n, 2 * m * k * n)[0] for m, k, n in shapes)
    return len(shapes), ops, nbytes, bound


def print_int8_gemm_bound(step):
    calls, ops, nbytes, bound = int8_gemm_bound(step)
    print(f"[profile] int8 GEMMs of one denoise step (G1): {calls} calls, {ops / 1e12:.3f} "
          f"TOP, {nbytes / 1e9:.3f} GB with the dequant fused; least time {bound:.3f} ms "
          f"(each call's larger of bytes at 3.35 TB/s and int8 ops at 1,979 TOP/s)")


def k8_calls(step):
    """Runs `step` once, recording every K8 call of the 3x3 stride-1
    `QuantConv`; returns {(B, H, W, Cin, Cout): calls}."""
    from prompt_diffusion_tpu_torch.ops import quant

    shapes, real = {}, quant.conv3x3_int8

    def record(xq, *args, **kwargs):
        key = tuple(xq.shape) + (args[1].shape[0],)  # (B, H, W, Cin) + Cout of wq
        shapes[key] = shapes.get(key, 0) + 1
        return real(xq, *args, **kwargs)

    quant.conv3x3_int8 = record
    try:
        step()
    finally:
        quant.conv3x3_int8 = real
    return shapes


def print_k8_bound(step):
    from prompt_diffusion_tpu_torch.tools.conv_tune import conv_work

    shapes = k8_calls(step)
    work = {k: conv_work(*k) for k in shapes}
    calls = sum(shapes.values())
    ops = sum(n * work[k][1] for k, n in shapes.items())
    bound = sum(n * roofline(*work[k])[0] for k, n in shapes.items())
    print(f"[profile] K8 (int8 3x3 convs) of one denoise step: {calls} calls, {ops / 1e12:.3f} "
          f"TOP; least time {bound:.3f} ms (each call's larger of bytes at 3.35 TB/s and int8 "
          f"ops at 1,979 TOP/s); calls by (B, H, W, Cin, Cout):")
    for k, n in sorted(shapes.items(), key=lambda kv: -kv[1] * work[kv[0]][1]):
        print(f"  {n:3d} x {k}")


def k5_k7_calls(step):
    """Runs `step` once, recording the calls of K5 (`GroupNorm32` with
    quant_out) and K7 (the int8 GEGLU) that the models make; returns
    ({(B, C, H, W, silu, eps): calls}, {(rows, 2I): calls})."""
    from prompt_diffusion_tpu_torch.models import layers

    k5, k7 = {}, {}
    gn, geglu = layers.fused_group_norm_quant, layers.fused_geglu_quant

    def record_gn(x, *args, **kwargs):
        key = tuple(x.shape) + (bool(kwargs.get("apply_silu")), kwargs.get("eps"))
        k5[key] = k5.get(key, 0) + 1
        return gn(x, *args, **kwargs)

    def record_geglu(proj):
        key = (proj.numel() // proj.shape[-1], proj.shape[-1])
        k7[key] = k7.get(key, 0) + 1
        return geglu(proj)

    layers.fused_group_norm_quant, layers.fused_geglu_quant = record_gn, record_geglu
    try:
        step()
    finally:
        layers.fused_group_norm_quant, layers.fused_geglu_quant = gn, geglu
    return k5, k7


def k6_calls(step):
    """Runs `step` once, recording the K6 calls (`FusedLayerNorm` with
    quant_out) that the models make; returns {(rows, C, eps): calls}."""
    from prompt_diffusion_tpu_torch.models import layers

    k6, ln = {}, layers.fused_layer_norm_quant

    def record(x, weight, bias, eps=1e-5):
        key = (x.numel() // x.shape[-1], x.shape[-1], eps)
        k6[key] = k6.get(key, 0) + 1
        return ln(x, weight, bias, eps=eps)

    layers.fused_layer_norm_quant = record
    try:
        step()
    finally:
        layers.fused_layer_norm_quant = ln
    return k6


def print_int8_epilogues(step):
    """K5's, K6's and K7's calls of one step by shape: the byte bound (one
    read of the bf16 input, one int8 write, the scales, K6's fp32 affine),
    device ms and launches per call of the wrapper alone, and the sums per
    step."""
    from prompt_diffusion_tpu_torch.ops.fused_act import fused_geglu_quant
    from prompt_diffusion_tpu_torch.ops.fused_group_norm import fused_group_norm_quant
    from prompt_diffusion_tpu_torch.ops.fused_layer_norm import fused_layer_norm_quant
    from prompt_diffusion_tpu_torch.tools.timing import device_launches, device_ms

    k5, k7 = k5_k7_calls(step)
    k6 = k6_calls(step)
    gen = torch.Generator(device="cuda").manual_seed(7)
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
    rows = []
    for (b, c, h, w, silu, eps), n in k5.items():
        x = randn(b, c, h, w).contiguous(memory_format=torch.channels_last)
        wt = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        bs = 0.1 * torch.randn(c, generator=gen, device="cuda")
        call = (lambda x=x, wt=wt, bs=bs, silu=silu, eps=eps:
                fused_group_norm_quant(x, wt, bs, 32, eps, silu))
        rows.append(("K5", f"({b},{c},{h},{w}) {'silu' if silu else 'no silu'} eps={eps}", n,
                     roofline(3 * x.numel() + 4 * b)[0], call))
    for (r, w2), n in k7.items():
        x = randn(r, w2)
        rows.append(("K7", f"({r},{w2})", n, roofline(2 * r * w2 + r * w2 // 2 + 4 * r)[0],
                     lambda x=x: fused_geglu_quant(x)))
    for (r, c, eps), n in k6.items():
        x = randn(r, c)
        wt = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        bs = 0.1 * torch.randn(c, generator=gen, device="cuda")
        rows.append(("K6", f"({r},{c}) eps={eps}", n, roofline(3 * r * c + 4 * r + 8 * c)[0],
                     lambda x=x, wt=wt, bs=bs, eps=eps: fused_layer_norm_quant(x, wt, bs, eps)))
    totals = {}
    print("[profile] K5, K6 and K7 calls of one denoise step: calls x shape, byte bound ms, "
          "device ms and device launches per call alone (warm):")
    for kern, label, n, bound, call in sorted(rows, key=lambda r: (r[0], -r[2] * r[3])):
        ms, launches = device_ms(call), device_launches(call)
        t = totals.setdefault(kern, [0, 0.0, 0.0, 0.0])
        t[0] += n
        t[1] += n * bound
        t[2] += n * ms
        t[3] += n * launches
        print(f"  {kern} {n:3d} x {label:40s} bound {bound:.4f} device {ms:.4f} "
              f"launches {launches:g}")
    for kern, (n, bound, ms, launches) in sorted(totals.items()):
        print(f"[profile] {kern} per denoise step: {n} calls, device {ms:.3f} ms alone, "
              f"bound {bound:.3f} ms, {launches:g} device launches")


def build(int8=False, seed=0, conv_variant="im2col", int8_attention=False, fused_geglu=True):
    """SD1.5 at the default configs with `random_init_` weights (bf16, or
    the int8 policy with the int8 VAE, K8's `conv_variant` and `create`'s
    `int8_attention` and `fused_geglu`), and one request's inputs, on the
    card."""
    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
    from prompt_diffusion_tpu_torch.utils.dtypes import default_policy, int8_policy, random_init_

    pipe = PromptDiffusionSD15.create(policy=int8_policy() if int8 else default_policy(),
                                      vae_int8=int8, device="cuda", conv_variant=conv_variant,
                                      int8_attention=int8_attention, fused_geglu=fused_geglu)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for m in (pipe.unet, pipe.controlnet, pipe.vae, pipe.text_encoder):
        random_init_(m, gen)
    vocab = pipe.text_encoder.config.vocab_size
    ids = lambda: torch.randint(0, vocab, (BATCH, 77), generator=gen, device="cuda")
    cond = lambda c: torch.rand((BATCH, SIZE, SIZE, c), generator=gen, device="cuda") * 2 - 1
    request = dict(token_ids=ids(), neg_token_ids=ids(), example_pair=cond(6), query=cond(3))
    x = torch.randn((BATCH, 4, SIZE // 8, SIZE // 8), generator=gen, device="cuda")
    return pipe, request, x.contiguous(memory_format=torch.channels_last)


@torch.no_grad()
def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--int8", action="store_true",
                        help="the int8 W8A8 serving policy and the int8 VAE")
    parser.add_argument("--conv-variant", choices=("im2col", "xshift"), default="im2col",
                        help="K8's variant for the int8 3x3 convs")
    parser.add_argument("--int8-attention", action="store_true",
                        help="int8: the 64² and 32² self-attention through K9")
    parser.add_argument("--unfused-geglu", action="store_true",
                        help="int8: the GEGLU without K7, then a per-tensor quantization")
    parser.add_argument("--vae", action="store_true",
                        help="the VAE decode alone: wall ms and its trace (K2 at D = 512, K3)")
    args = parser.parse_args(argv)
    if (args.int8_attention or args.unfused_geglu) and not args.int8:
        parser.error("--int8-attention and --unfused-geglu take --int8")
    if not torch.cuda.is_available():
        print("profile_sd15: no CUDA device", file=sys.stderr)
        return 2
    policy = (f"int8, K8 {args.conv_variant}" + (", int8 attention" if args.int8_attention
                                                 else "")
              + (", unfused GEGLU" if args.unfused_geglu else "")) if args.int8 else "bf16"
    print(f"[profile] {card()}; policy {policy}")
    pipe, request, x = build(int8=args.int8, conv_variant=args.conv_variant,
                             int8_attention=args.int8_attention,
                             fused_geglu=not args.unfused_geglu)
    if args.vae:
        decode = lambda: pipe.decode_latents(x.permute(0, 2, 3, 1))
        decode()  # warm-up
        print(f"[profile] VAE decode (batch {BATCH}, {SIZE}²): {_wall_ms(decode):.3f} ms wall, "
              f"median of 3")
        by_name, busy, wall_us, launches = trace_by_name(decode)
        print(f"[profile] one VAE decode under the profiler: {wall_us / 1e3:.3f} ms wall, device "
              f"busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), {launches} device "
              f"launches")
        print_named(by_name, 1, "VAE decode", ATTN_NAMES[1:3] + K3_K9P_NAMES[:1])
        return 0
    t = torch.full((BATCH,), 999, dtype=torch.int32, device="cuda")
    eps_fn = pipe.make_eps_fn(**request, guidance_scale=CFG)
    pair2 = torch.cat([request["example_pair"]] * 2).permute(0, 3, 1, 2)
    query2 = torch.cat([request["query"]] * 2).permute(0, 3, 1, 2)
    to_cl = lambda a: a.contiguous(memory_format=torch.channels_last)
    parts = {
        "2x CLIP encode": lambda: (pipe.encode_prompt(request["neg_token_ids"]),
                                   pipe.encode_prompt(request["token_ids"])),
        "hint encoders": lambda: pipe.controlnet(example_pair=to_cl(pair2), query=to_cl(query2),
                                                 hint_only=True),
        "denoise step": lambda: eps_fn(x, t),
        "VAE decode": lambda: pipe.decode_latents(x.permute(0, 2, 3, 1)),
    }
    for fn in parts.values():  # warm-up
        fn()
    print(f"[profile] request parts (batch {BATCH}, {SIZE}², CFG {CFG}), wall ms, median of 3:")
    for name, fn in parts.items():
        print(f"  {name:16s} {_wall_ms(fn):9.3f}")
    if args.int8:
        print_int8_gemm_bound(parts["denoise step"])
        print_k8_bound(parts["denoise step"])
        print_int8_epilogues(parts["denoise step"])

    with device_trace() as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            eps_fn(x, t)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_kernels(prof)
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    by_name = {}
    for name, s, e in kernels:
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + (e - s))
    busy = busy_us([(s, e) for _, s, e in kernels])
    print(f"[profile] {STEPS} denoise steps under the profiler: "
          f"{wall_us / STEPS / 1e3:.3f} ms wall per step, device busy "
          f"{busy / STEPS / 1e3:.3f} ms per step ({100 * busy / wall_us:.1f}%), "
          f"{len(kernels) / STEPS:.0f} device launches per step")
    print("[profile] device ms per step, launches per step, kernel:")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for name, (n, us) in ranked[:TOP]:
        print(f"  {us / STEPS / 1e3:9.3f} {n / STEPS:6.0f}  {name[:110]}")
    rest = sum(us for _, (_, us) in ranked[TOP:])
    print(f"  {rest / STEPS / 1e3:9.3f}         (the other {max(0, len(ranked) - TOP)} names)")
    print_named(by_name, STEPS, "step", K3_K9P_NAMES[:3 if args.int8_attention else 2])
    print_named(by_name, STEPS, "step", ATTN_NAMES)
    if args.int8:
        k8 = [(n, us) for name, (n, us) in by_name.items()
              if "conv3x3_int8" in name or "splitk_epilogue" in name]
        print(f"[profile] K8 device ms per step: {sum(us for _, us in k8) / STEPS / 1e3:.3f} "
              f"({sum(n for n, _ in k8) / STEPS:.0f} launches, split-K epilogues included)")
        for label, parts_of_name in EPILOGUE_NAMES:
            hits = [(n, us) for name, (n, us) in by_name.items()
                    if any(part in name for part in parts_of_name)]
            print(f"[profile] {label} in the trace: {sum(us for _, us in hits) / STEPS / 1e3:.3f} "
                  f"device ms, {sum(n for n, _ in hits) / STEPS:.0f} launches per step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
