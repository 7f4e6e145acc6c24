"""Where the time of one SD3 request goes on the card.

    python3 -m prompt_diffusion_tpu_torch.tools.profile_sd3 [--vae]

Builds SD3 Prompt-Diffusion at full width in the int8 serving mode of
`bench.py --config sd3` (MMDiT 24 x 1536, the 12-block ControlNet,
CLIP-L, CLIP-bigG, T5-XXL, the z=16 bf16 VAE; random weights from a seed),
the configuration `chip_smoke.py` runs, and one request of batch 1 at
1024² with CFG 7. T5-XXL runs staged: it is timed, then freed before the
rest is built. Every part runs once to warm up (kernel builds, Triton
compiles, cuDNN heuristics). Then:
  * the wall time of each part of the request, synchronised, median of 3:
    the T5-XXL encode (L = 256), the CLIP-L and CLIP-bigG encodes, the two
    VAE encodes (support pair with `down_proj`, query condition), one CFG
    denoise step (ControlNet + MMDiT on the double batch) and the VAE
    decode;
  * a torch.profiler trace of two denoise steps: device time by kernel
    name, device launches per step, and the device's busy share of the
    profiled wall time; the device ms and launches per step of the int8
    epilogue kernels K10, K11 and K13 and of the copy kernels
    (`KERNEL_NAMES`; the former K11 wrapper copied each of its 71
    attention slices per step to contiguous rows first), and of K9p and
    its parent design (`profile_sd15.K3_K9P_NAMES`), and of the attention
    kernels (`profile_sd15.ATTN_NAMES`: K9 and its parent);
  * a torch.profiler trace of one VAE decode: its device ms, busy share
    and launches, and K3's device ms and launches in it (the bf16 VAE's
    GroupNorms; the denoise step makes no K3 call);
  * the int8 GEMMs of one step and the least time they could take with the
    dequant fused into them (G1 in ROADMAP.md).
With `--vae`, the request's VAE parts alone (no T5, no denoise step): the
wall time of each (median of 3), then a torch.profiler trace of one
request's three of them, with the device ms and launches of K2 at D =
512 per request (`profile_sd15.ATTN_NAMES`: `attention_sm90_wide.cuh`, or
the parent `fa_wide_kernel` from an older checkout) and of K3.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from prompt_diffusion_tpu_torch.tools.profile_sd15 import (
    ATTN_NAMES,
    K3_K9P_NAMES,
    _wall_ms,
    print_int8_gemm_bound,
    print_named,
    trace_by_name,
)
from prompt_diffusion_tpu_torch.tools.timing import busy_us, card, device_kernels, device_trace

BATCH, SIZE, CFG, T5_LEN = 1, 1024, 7.0, 256
STEPS, TOP = 2, 30  # denoise steps traced, kernel names printed
# the int8 epilogue kernels of the step, summed by a part of their device
# name: K10, K13 and K11 in CUDA (`ops/csrc/row_quant.cu`), and from an
# older checkout the Triton program that ran K11 (and K10 before it was
# CUDA) and K12's, which ran K13 before it was CUDA; then PyTorch's copy
# kernels (`.contiguous()`, `.copy_`, dtype casts)
KERNEL_NAMES = (("K10", "gelu_quant_kernel"), ("K13", "adaln_quant_kernel"),
                ("K11", "rows_quant_kernel"),
                ("a Triton K11 (or K10)", "act_quant_kernel"),
                ("a Triton K13", "adaln_kernel"), ("copies and casts", "copy_kernel"))


def vae_parts(pipe, gen):
    """The request's VAE parts (the support pair through `down_proj`, the
    query condition, the decode) on seeded inputs: {name: call}."""
    img = lambda: torch.rand((BATCH, SIZE, SIZE, 3), generator=gen, device="cuda") * 2 - 1
    cond, gt, control = img(), img(), img()
    control_nchw = control.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    x = torch.randn((BATCH, pipe.vae.config.z_channels, SIZE // 8, SIZE // 8), generator=gen,
                    device="cuda")
    return {"VAE encode, pair": lambda: pipe.encode_support_pair(cond, gt, gen),
            "VAE encode, query": lambda: pipe._encode_vae(control_nchw, gen),
            "VAE decode": lambda: pipe.decode_latents(x)}


def vae_only(pipe, gen):
    """`--vae`: the wall ms of each VAE part, then one request's VAE parts
    under the profiler with K2's (D = 512) and K3's device ms."""
    parts = vae_parts(pipe, gen)
    for fn in parts.values():  # warm-up
        fn()
    print(f"[profile] VAE parts of a request (batch {BATCH}, {SIZE}²), wall ms, median of 3:")
    for name, fn in parts.items():
        print(f"  {name:18s} {_wall_ms(fn):9.3f}")
    by_name, busy, wall_us, launches = trace_by_name(lambda: [fn() for fn in parts.values()])
    print(f"[profile] one request's VAE parts under the profiler: {wall_us / 1e3:.3f} ms wall, "
          f"device busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), {launches} "
          f"device launches")
    print_named(by_name, 1, "request", [row for row in ATTN_NAMES if "wide" in row[0]]
                + list(K3_K9P_NAMES[:1]))
    return 0


@torch.no_grad()
def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--vae", action="store_true",
                        help="the request's VAE parts alone: wall ms and a trace (K2, K3)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_sd3: no CUDA device", file=sys.stderr)
        return 2
    from prompt_diffusion_tpu_torch.models.t5_text import T5Encoder
    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd3 import PromptDiffusionSD3
    from prompt_diffusion_tpu_torch.utils.dtypes import int8_policy, random_init_

    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.vae:
        print(f"[profile] {card()}; SD3, int8 policy, the request's VAE parts")
        pipe = PromptDiffusionSD3.create(policy=int8_policy(), device="cuda")
        for m in (pipe.down_proj, pipe.vae):
            random_init_(m, gen)
        return vae_only(pipe, gen)
    print(f"[profile] {card()}; SD3, int8 policy, staged T5")
    with torch.device("cuda"):
        t5 = T5Encoder()
    random_init_(t5.eval().requires_grad_(False), gen)
    ids_t5 = torch.randint(0, t5.config.vocab_size, (2, BATCH, T5_LEN), generator=gen,
                           device="cuda")
    t5_fn = lambda: PromptDiffusionSD3.encode_t5(t5, ids_t5[0])
    t5_fn()
    parts = {"T5-XXL encode": _wall_ms(t5_fn)}
    t5_seq, neg_t5_seq = t5_fn(), PromptDiffusionSD3.encode_t5(t5, ids_t5[1])
    del t5
    torch.cuda.empty_cache()

    pipe = PromptDiffusionSD3.create(policy=int8_policy(), device="cuda")
    for m in (pipe.transformer, pipe.controlnet, pipe.down_proj, pipe.vae, pipe.clip_l,
              pipe.clip_g):
        random_init_(m, gen)
    ids = lambda: torch.randint(0, 49408, (BATCH, 77), generator=gen, device="cuda")
    img = lambda: torch.rand((BATCH, SIZE, SIZE, 3), generator=gen, device="cuda") * 2 - 1
    request = dict(prompt_ids=dict(l=ids(), g=ids()), neg_prompt_ids=dict(l=ids(), g=ids()),
                   control_image=img(), support_cond=img(), support_image=img(),
                   t5_seq=t5_seq, neg_t5_seq=neg_t5_seq)
    velocity_fn = pipe.make_velocity_fn(**request, guidance_scale=CFG, generator=gen)
    x = torch.randn((BATCH, pipe.vae.config.z_channels, SIZE // 8, SIZE // 8), generator=gen,
                    device="cuda")
    t = torch.full((BATCH,), 1000.0, device="cuda")
    control_nchw = request["control_image"].permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    steps = {
        "CLIP-L encode": lambda: pipe.clip_l(request["prompt_ids"]["l"], output_hidden_layer=2),
        "CLIP-bigG encode": lambda: pipe.clip_g(request["prompt_ids"]["g"],
                                                output_hidden_layer=2),
        "VAE encode, pair": lambda: pipe.encode_support_pair(
            request["support_cond"], request["support_image"], gen),
        "VAE encode, query": lambda: pipe._encode_vae(control_nchw, gen),
        "denoise step": lambda: velocity_fn(x, t),
        "VAE decode": lambda: pipe.decode_latents(x),
    }
    for fn in steps.values():  # warm-up
        fn()
    parts.update({name: _wall_ms(fn) for name, fn in steps.items()})
    print(f"[profile] request parts (batch {BATCH}, {SIZE}², CFG {CFG}), wall ms, median of 3:")
    for name, ms in parts.items():
        print(f"  {name:18s} {ms:9.3f}")
    print_int8_gemm_bound(steps["denoise step"])

    with device_trace() as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            velocity_fn(x, t)
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
    for label, key in KERNEL_NAMES:
        hits = [(n, us) for name, (n, us) in by_name.items() if key in name]
        print(f"[profile] {label} ({key}): {sum(us for _, us in hits) / STEPS / 1e3:.3f} device "
              f"ms, {sum(n for n, _ in hits) / STEPS:.0f} launches per step")
    print_named(by_name, STEPS, "step", K3_K9P_NAMES[2:])
    print_named(by_name, STEPS, "step", ATTN_NAMES)

    with device_trace() as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps["VAE decode"]()
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
    print(f"[profile] one VAE decode under the profiler: {wall_us / 1e3:.3f} ms wall, device "
          f"busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), {len(kernels)} device "
          f"launches")
    print_named(by_name, 1, "VAE decode", K3_K9P_NAMES[:2])
    return 0


if __name__ == "__main__":
    sys.exit(main())
