"""Where the time of one training step goes on the card.

    python3 -m prompt_diffusion_tpu_torch.tools.profile_train [--sd3]

Builds the trainer's pipeline at the default widths with random weights
from a seed, as the entries build it: SD1.5 at BASELINE config 5 (batch 8
at 512², gradient checkpointing, bf16 with fp32 masters, EMA), or with
`--sd3` SD3 (batch 1 at 1024²); one synthetic batch (seeded tensors, text
through the pipeline's encoders). Two steps warm up (kernel builds, Triton
compiles, cuDNN heuristics). Then:
  * the wall time of the step's parts, synchronised, median of 3: the loss
    with its backward, and the optimizer update with the EMA;
  * a torch.profiler trace of STEPS whole steps: device time by kernel
    name, device launches per step, the device's busy share of the
    profiled wall time, and the device ms and launches of K1-K4 and of
    the rest;
  * peak device memory of a step.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch

from prompt_diffusion_tpu_torch.tools.timing import busy_us, card, device_kernels, device_trace

STEPS, TOP = 2, 25  # steps traced, kernel names printed
# the device functions of K1-K4 by a part of their name (`attention_sm90.cuh`'s
# kernel and `flash_attention.cu`'s wide one, and the narrow parent that an
# older checkout launches; K3's `gn_float_kernel`, K4's Triton `ln_kernel`)
KERNEL_NAMES = (("K1/K2 attention", ("attn_sm90_bf16_kernel", "fa_narrow_kernel",
                                     "fa_wide_kernel")),
                ("K3 GroupNorm", ("gn_float_kernel",)), ("K4 LayerNorm", ("ln_kernel",)))


def _wall_ms(fn, before=None, reps=3):
    """Median synchronised wall ms of `fn`, each run after `before`."""
    times = []
    for _ in range(reps):
        if before is not None:
            before()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def build(sd3: bool, seed: int = 0):
    """(pipe, state, loss_fn, finish) of one step: `loss_fn()` runs the loss
    and its backward, `finish()` the optimizer and the EMA."""
    from prompt_diffusion_tpu_torch import train_sd3, train_sd15
    from prompt_diffusion_tpu_torch.training import sd3 as t3
    from prompt_diffusion_tpu_torch.training import sd15 as t15
    from prompt_diffusion_tpu_torch.training.optimizer import finish_step, step_generator
    from prompt_diffusion_tpu_torch.utils.dtypes import random_init_

    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    rand = lambda *s: torch.rand(s, generator=g, device="cuda")
    ids = torch.randint(1000, 49000, (8, 77), generator=g, device="cuda")
    if sd3:
        pipe = train_sd3.build_pipe(False, "cuda")
        for m in pipe.jax_modules().values():
            random_init_(m, torch.Generator(device="cuda").manual_seed(seed))
        cfg = t3.SD3TrainConfig(use_ema=True)
        state, opt = t3.init_sd3_train_state(cfg, pipe, seed), t3.make_sd3_optimizer(cfg)
        ctx, pooled = pipe.encode_prompt(ids[:1], ids[:1])
        batch = t3.sd3_device_batch(
            {"image": rand(1, 1024, 1024, 3) * 2 - 1, "control": rand(1, 1024, 1024, 3) * 2 - 1,
             "support_cond": rand(1, 1024, 1024, 3) * 2 - 1,
             "support_image": rand(1, 1024, 1024, 3) * 2 - 1, "context": ctx,
             "pooled": pooled}, "cuda")
        sched = t3.FlowMatchSchedule.create(shift=cfg.shift, device="cuda")
        draws = t3.make_sd3_draws(step_generator(seed, 0, "cuda"), (1, 16, 128, 128))
        loss = lambda: t3.sd3_loss(pipe, cfg, sched, batch, draws)
    else:
        pipe = train_sd15.build_pipe(False, "cuda", use_checkpoint=True)
        train_sd15.init_weights(pipe, seed)
        cfg = t15.SD15TrainConfig(use_ema=True, accum_steps=1)
        state, opt = t15.init_train_state(cfg, pipe, seed), t15.make_optimizer(cfg)
        batch = t15.device_batch({"image": rand(8, 512, 512, 3) * 2 - 1,
                                  "query": rand(8, 512, 512, 3),
                                  "example_pair": rand(8, 512, 512, 6) * 2 - 1,
                                  "token_ids": ids, "null_ids": ids[:1] * 0 + 49407}, "cuda")
        draws = t15.make_draws(step_generator(seed, 0, "cuda"), (8, 4, 64, 64), 1000)
        loss = lambda: t15.sd15_loss(pipe, cfg, batch, draws)
    return pipe, state, lambda: loss().backward(), lambda: finish_step(state, opt, cfg.ema_decay)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sd3", action="store_true", help="the SD3 step (batch 1 at 1024²)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    what = "SD3, batch 1 at 1024²" if args.sd3 else "SD1.5 config 5, batch 8 at 512²"
    print(f"[profile] {card()}; {what}")
    pipe, state, backward, finish = build(args.sd3)
    step = lambda: (backward(), finish())
    for _ in range(2):
        step()
    torch.cuda.reset_peak_memory_stats()
    step()
    peak = torch.cuda.max_memory_allocated()
    print(f"[profile] step parts, wall ms, median of 3: loss + backward "
          f"{_wall_ms(backward, before=finish):.3f}, optimizer + EMA "
          f"{_wall_ms(finish, before=backward):.3f}; peak device memory of a step "
          f"{peak / 2**30:.2f} GiB")
    with device_trace() as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step()
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
    print(f"[profile] {STEPS} steps under the profiler: {wall_us / STEPS / 1e3:.3f} ms wall per "
          f"step, device busy {busy / STEPS / 1e3:.3f} ms per step ({100 * busy / wall_us:.1f}%), "
          f"{len(kernels) / STEPS:.0f} device launches per step")
    print("[profile] device ms per step, launches per step, kernel:")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for name, (n, us) in ranked[:TOP]:
        print(f"  {us / STEPS / 1e3:9.3f} {n / STEPS:6.0f}  {name[:110]}")
    rest = sum(us for _, (_, us) in ranked[TOP:])
    print(f"  {rest / STEPS / 1e3:9.3f}         (the other {max(0, len(ranked) - TOP)} names)")
    mine = 0.0
    for label, parts in KERNEL_NAMES:
        hits = [(n, us) for name, (n, us) in by_name.items() if any(p in name for p in parts)]
        mine += sum(us for _, us in hits)
        print(f"[profile] {label}: {sum(us for _, us in hits) / STEPS / 1e3:.3f} device ms, "
              f"{sum(n for n, _ in hits) / STEPS:.0f} launches per step")
    total = sum(us for _, us in by_name.values())
    print(f"[profile] everything else (convs, GEMMs, the plain backward recomputes, the "
          f"optimizer): {(total - mine) / STEPS / 1e3:.3f} device ms per step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
