"""int8 W8A8 quality against bf16 on the card, with no external weights.

    python -m prompt_diffusion_tpu_torch.tools.int8_quality --stack sd15 --n 256 --batch 4
    python -m prompt_diffusion_tpu_torch.tools.int8_quality --stack sd3 --n 16 --batch 1
        [--size S] [--steps T] [--vae-int8] [--dump DIR | --from-dump DIR |
         --bf16-from-dump DIR] [--device cuda]

The port's counterpart of `scripts/int8_quality.py`, with its protocol,
flags and output lines (one JSON object per metric on stdout, progress on
stderr):

  1. One set of random weights (`random_init_`, seed 0, which also fills
     the zero-initialised convs, as the JAX script's `perturb_zero_init`
     does) for the bf16 pipeline; the int8 pipeline is built from the bf16
     one's state dicts and shares its text encoders (SD1.5: and its bf16
     VAE, `bench.py`'s default, unless `--vae-int8`; SD3: and its VAE and
     down-projection, unless `--vae-int8`). SD3 runs without T5, as the JAX
     script does (zero T5 slots).
  2. SD1.5 only: the full model's ε (ControlNet + UNet, batch 2) under
     int8 against bf16, relative L2 at t ∈ {1, 250, 500, 750, 999}.
  3. N images per mode from identical starting noise: image i's x_T comes
     from its own generator, seeded from i; each batch is timed with
     `utils.profiling.StepTimer`.
  4. SSIM(bf16_i, int8_i) per pair (p05, p50, mean).
  5. FID(bf16 set, int8 set) with the port's Inception features (random
     He-normal weights, seed 0) against the floor FID(bf16 half A, bf16
     half B): int8 passes when its drift is within 2x the same-mode split
     (identical protocol, disjoint seeds).

The numbers are the port's own: they come from the port's random weights
and are not compared with any JAX run. `main(argv, bf16=, int8=,
features=)` lets a caller pass the pipelines (a bf16 one alone: the int8
one is built from it by `int8_twin`) and a `(feature_fn, dim)` pair in
place of the Inception extractor.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from prompt_diffusion_tpu_torch.evaluation.ssim import batch_ssim as ssim
from prompt_diffusion_tpu_torch.utils.profiling import StepTimer

_T0 = time.perf_counter()
# x_T of image i is drawn from a generator seeded NOISE_SEED << 32 | i
NOISE_SEED = 5
EPS_TIMESTEPS = (1, 250, 500, 750, 999)
FID_CHUNK = 16


def log(m):
    print(f"[int8q +{time.perf_counter() - _T0:.0f}s] {m}", file=sys.stderr, flush=True)


def start_noise(first: int, count: int, shape, device) -> torch.Tensor:
    """x_T of images first .. first + count - 1, (count, *shape) fp32: one
    generator per image, seeded from its index."""
    return torch.stack([
        torch.randn(shape, generator=torch.Generator(device=device).manual_seed(
            (NOISE_SEED << 32) | i), device=device)
        for i in range(first, first + count)])


def _random_init(modules, device, seed: int = 0) -> None:
    from prompt_diffusion_tpu_torch.utils.dtypes import random_init_

    gen = torch.Generator(device=device).manual_seed(seed)
    for m in modules:
        random_init_(m, gen)


def _stack(stack: str):
    """(pipeline class, {model attribute: constructor of its int8 twin from
    the bf16 model and a policy}, the pipeline's other models)."""
    from prompt_diffusion_tpu_torch.models.controlnet_sd15 import ControlNetSD15
    from prompt_diffusion_tpu_torch.models.controlnet_sd3 import SD3ControlNet
    from prompt_diffusion_tpu_torch.models.mmdit_sd3 import SD3Transformer
    from prompt_diffusion_tpu_torch.models.unet_sd15 import UNetSD15
    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd3 import PromptDiffusionSD3
    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15

    if stack == "sd15":
        return PromptDiffusionSD15, {
            "unet": lambda m, p: UNetSD15(m.config, p),
            "controlnet": lambda m, p: ControlNetSD15(
                m.config, m.input_hint_block.conv_0.in_channels, p),
        }, ("vae", "text_encoder", "schedule")
    return PromptDiffusionSD3, {
        "transformer": lambda m, p: SD3Transformer(m.config, p),
        "controlnet": lambda m, p: SD3ControlNet(m.config, p),
    }, ("vae", "down_proj", "clip_l", "clip_g")


def int8_twin(stack: str, pipe_bf, vae_int8: bool = False, policy=None):
    """The int8 pipeline of `stack` with `pipe_bf`'s weights: its denoiser
    and ControlNet (and with `vae_int8` its VAE) rebuilt at their widths
    under `policy` (default `int8_policy()`) from `pipe_bf`'s state dicts;
    the other models (SD1.5: the text encoder and otherwise the bf16 VAE;
    SD3: the down-projection, the text encoders and otherwise the VAE)
    shared."""
    from prompt_diffusion_tpu_torch.models.vae import AutoencoderKL
    from prompt_diffusion_tpu_torch.utils.dtypes import int8_policy

    pipe_cls, rebuild, others = _stack(stack)
    if vae_int8:
        rebuild = dict(rebuild, vae=lambda m, p: AutoencoderKL(m.config, p))
    policy = policy or int8_policy()
    with torch.device(pipe_bf.device):
        models = {name: make(getattr(pipe_bf, name), policy) for name, make in rebuild.items()}
    for name, m in models.items():
        m.load_state_dict(getattr(pipe_bf, name).state_dict())
    shared = {name: getattr(pipe_bf, name) for name in others if name not in models}
    return pipe_cls.create(**models, **shared, device=pipe_bf.device)


def build(stack: str, vae_int8: bool, device):
    """(bf16 pipeline with random weights, its int8 twin); SD3 without T5."""
    pipe_bf = _stack(stack)[0].create(device=device)
    _random_init(pipe_bf.jax_modules().values(), device)
    return pipe_bf, int8_twin(stack, pipe_bf, vae_int8)


def _request(stack: str, batch: int, size: int):
    """The JAX script's request: (`generate`'s positional arguments, its
    guidance scale)."""
    rngq = np.random.default_rng(7)
    uniform = lambda c: torch.from_numpy(
        rngq.uniform(-1, 1, (batch, size, size, c)).astype(np.float32))
    ids = torch.zeros((batch, 77), dtype=torch.int64)
    if stack == "sd15":
        return (ids, ids, uniform(6), uniform(3)), 9.0
    ids = {"l": ids, "g": ids}
    img = uniform(3)
    return (ids, ids, img, img, img), 7.0


def generate_set(stack: str, pipe, n, batch, size, steps, tag, timer):
    """n images of `pipe` in batches, image i from its own x_T; each batch
    timed by `timer`."""
    dev = pipe.device
    args, guidance = _request(stack, batch, size)
    zc = pipe.vae.config.z_channels
    imgs = []
    t0 = time.perf_counter()
    for i in range(n // batch):
        noise = start_noise(i * batch, batch, (size // 8, size // 8, zc), dev)
        with timer.step() as holder:
            out = pipe.generate(*args, num_steps=steps, guidance_scale=guidance,
                                init_noise=noise,
                                generator=torch.Generator(device=dev).manual_seed(0))
            holder["out"] = out
        imgs.append(out.float().cpu().numpy())
        if i == 0:
            log(f"{tag}: first batch in {time.perf_counter() - t0:.0f}s")
    log(f"{tag}: {n} images in {time.perf_counter() - t0:.0f}s; per batch {timer.stats()}")
    return np.concatenate(imgs)


@torch.no_grad()
def eps_relerr_sd15(pipe_bf, pipe_i8, size):
    """Full-model ε(bf16) vs ε(int8) rel-err at spread timesteps."""
    dev = pipe_bf.device
    rng = np.random.default_rng(3)
    b = 2
    nchw = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev).permute(0, 3, 1, 2) \
        .contiguous(memory_format=torch.channels_last)
    x = nchw(rng.normal(size=(b, size // 8, size // 8, 4)))
    ctx_dim = pipe_bf.unet.config.context_dim  # 768 at SD1.5's width, as in the JAX script
    ctx = torch.from_numpy((rng.normal(size=(b, 77, ctx_dim)) * 0.3).astype(np.float32)).to(dev)
    pair = nchw(rng.uniform(-1, 1, (b, size, size, 6)))
    query = nchw(rng.uniform(-1, 1, (b, size, size, 3)))

    def eps(pipe, tb):
        control = pipe.controlnet(x, tb, pair, query, ctx)
        return pipe.unet(x, tb, ctx, control=control).double().cpu().numpy()

    errs = {}
    for t in EPS_TIMESTEPS:
        tb = torch.full((b,), t, dtype=torch.int32, device=dev)
        a, c = eps(pipe_bf, tb), eps(pipe_i8, tb)
        errs[t] = float(np.linalg.norm(c - a) / max(np.linalg.norm(a), 1e-9))
    return errs


def fid_of(feats_fn, a, b, dim, device="cuda"):
    from prompt_diffusion_tpu_torch.evaluation.fid import (
        compute_stats_from_iterator,
        frechet_distance,
    )

    chunks = lambda s: iter([s[i:i + FID_CHUNK] for i in range(0, len(s), FID_CHUNK)])
    sa = compute_stats_from_iterator(feats_fn, chunks(a), dim, device)
    sb = compute_stats_from_iterator(feats_fn, chunks(b), dim, device)
    return frechet_distance(*sa.finalize(), *sb.finalize())


def _free(device) -> None:
    """Hands the finished generation's cached blocks back to the card."""
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stack", choices=["sd15", "sd3"], default="sd15")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--vae-int8", action="store_true",
                    help="int8 pipeline also quantizes the VAE interior convs")
    ap.add_argument("--dump", default=None, metavar="DIR",
                    help="save the generated image sets as .npy under DIR (so the FID/SSIM "
                         "stages can rerun without generating again)")
    ap.add_argument("--from-dump", default=None, metavar="DIR",
                    help="skip generation; load bf16/int8 image sets from DIR")
    ap.add_argument("--bf16-from-dump", default=None, metavar="DIR",
                    help="load only the bf16 set from DIR (gates an int8 variant, e.g. "
                         "--vae-int8, against an already-dumped bf16 set)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None, bf16=None, int8=None, features=None) -> dict:
    """The protocol. Returns {"lines": the printed JSON objects, "images":
    {"bf16", "int8"}: the sets, "timing": each mode's `StepTimer.stats()`,
    "pipes": {"bf16", "int8"} when it generated}."""
    args = parse_args(argv)
    size = args.size or (512 if args.stack == "sd15" else 1024)
    steps = args.steps or (50 if args.stack == "sd15" else 28)
    dev = args.device
    out = {"lines": [], "timing": {}, "pipes": {}}

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        out["lines"].append(json.loads(line))

    def load(directory, mode):
        return np.load(os.path.join(directory, f"{args.stack}_{mode}.npy"))

    if args.from_dump:
        imgs_bf, imgs_i8 = load(args.from_dump, "bf16"), load(args.from_dump, "int8")
        log(f"loaded {len(imgs_bf)}+{len(imgs_i8)} images from {args.from_dump}")
    else:
        if bf16 is None:
            log("init params...")
            bf16, int8 = build(args.stack, args.vae_int8, dev)
        elif int8 is None:
            int8 = int8_twin(args.stack, bf16, args.vae_int8)
        out["pipes"] = {"bf16": bf16, "int8": int8}
        if args.stack == "sd15":
            errs = eps_relerr_sd15(bf16, int8, size)
            emit({"metric": "sd15 eps rel-err by t", "value": errs})
        timers = {mode: StepTimer() for mode in ("bf16", "int8")}
        gen = lambda pipe, mode: generate_set(args.stack, pipe, args.n, args.batch, size, steps,
                                              mode, timers[mode])
        if args.bf16_from_dump:
            imgs_bf = load(args.bf16_from_dump, "bf16")
            log(f"loaded {len(imgs_bf)} bf16 images from {args.bf16_from_dump}")
        else:
            imgs_bf = gen(bf16, "bf16")
            _free(dev)
        imgs_i8 = gen(int8, "int8")
        _free(dev)
        out["timing"] = {mode: t.stats() for mode, t in timers.items()}
    out["images"] = {"bf16": imgs_bf, "int8": imgs_i8}

    if args.dump and not args.from_dump:
        os.makedirs(args.dump, exist_ok=True)
        np.save(os.path.join(args.dump, f"{args.stack}_bf16.npy"), imgs_bf)
        np.save(os.path.join(args.dump, f"{args.stack}_int8.npy"), imgs_i8)
        log(f"dumped image sets to {args.dump}")

    # SSIM distribution (identical seeds → pairwise comparable)
    s = ssim(imgs_bf, imgs_i8)
    emit({
        "metric": f"{args.stack} SSIM(bf16_i, int8_i)",
        "p05": round(float(np.percentile(s, 5)), 4),
        "p50": round(float(np.percentile(s, 50)), 4),
        "mean": round(float(s.mean()), 4),
    })

    # FID vs the same-mode split floor
    if features is None:
        from prompt_diffusion_tpu_torch.evaluation.fid import default_feature_fn

        features = default_feature_fn(dev)
    feats_fn, dim = features
    h = len(imgs_bf) // 2
    floor = fid_of(feats_fn, imgs_bf[:h], imgs_bf[h:], dim, dev)
    cross = fid_of(feats_fn, imgs_bf, imgs_i8, dim, dev)
    cross_same_seed = fid_of(feats_fn, imgs_bf[:h], imgs_i8[:h], dim, dev)
    verdict = "PASS" if cross <= max(2 * floor, floor + 1e-3) else "FAIL"
    emit({
        "metric": f"{args.stack} FID drift (random-init relative features)",
        "fid_bf16_split_floor": round(floor, 4),
        "fid_bf16_vs_int8": round(cross, 4),
        "fid_bf16_vs_int8_same_seeds_half": round(cross_same_seed, 4),
        "acceptance": "cross <= 2x same-mode split floor",
        "verdict": verdict,
    })
    return out


if __name__ == "__main__":
    main()
