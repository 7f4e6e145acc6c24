"""Where the time of one annotation batch goes on the card: MiDaS
DPT-Hybrid or UniFormer-S/UperNet segmentation.

    python3 -m prompt_diffusion_tpu_torch.tools.profile_midas [--policy bf16|int8|both]
        [--model midas|seg]

Builds the model at full width with random weights from a seed: DPT-Hybrid
(ViT-B 768 x 12, ResNetV2 (3, 4, 9), features 256; `chip_smoke.py`'s
`[midas]`, `bench.py --config annotate --annotator midas`), run as x /
127.5 - 1 -> depth -> normals; or UniFormer-S with the UperNet head
(`[seg]`, `--annotator uniformer`), run as logits -> argmax. Batches of 16
uniform [0, 255] images at 512², under each policy asked for.
After a warm-up batch (Triton compiles, cuDNN heuristics):
  * the wall time of one batch, synchronised, median of 3;
  * a torch.profiler trace of two batches: device time by kernel name,
    device launches per batch, and the device's busy share of the
    profiled wall time; K3's and K9p's device ms and launches per batch,
    and their parent designs' (`profile_sd15.K3_K9P_NAMES`).
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from prompt_diffusion_tpu_torch.tools.profile_sd15 import K3_K9P_NAMES, _wall_ms, print_named
from prompt_diffusion_tpu_torch.tools.timing import busy_us, card, device_kernels, device_trace

BATCH, SIZE = 16, 512
BATCHES, TOP = 2, 25  # batches traced, kernel names printed


def profile_policy(name: str, policy, state=None, seed=0, model_name="midas"):
    """Prints the wall time and the device breakdown of one batch under
    `policy`; returns the model's state dict (the weights of every run)."""
    from prompt_diffusion_tpu_torch.annotators.midas import DPTHybridDepth, depth_to_normals
    from prompt_diffusion_tpu_torch.annotators.uniformer import UniFormerSeg
    from prompt_diffusion_tpu_torch.utils.dtypes import random_init_

    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.device("cuda"):
        cls = DPTHybridDepth if model_name == "midas" else UniFormerSeg
        model = cls(policy=policy).eval().requires_grad_(False)
    if state is None:
        random_init_(model, gen)
    else:
        model.load_state_dict(state)
    imgs = torch.rand((BATCH, SIZE, SIZE, 3), generator=gen, device="cuda") * 255
    x = imgs.permute(0, 3, 1, 2)
    if model_name == "midas":
        batch = lambda: depth_to_normals(model(x / 127.5 - 1.0))
    else:
        batch = lambda: model(x).argmax(dim=1)
    batch()
    wall = _wall_ms(batch)
    print(f"[profile] {name}: {wall:.3f} ms wall per batch of {BATCH} at {SIZE}² "
          f"({BATCH / wall * 1e3:.2f} images/s), median of 3")
    with device_trace() as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(BATCHES):
            batch()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_kernels(prof)
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    by_name = {}
    for kname, s, e in kernels:
        n, us = by_name.get(kname, (0, 0.0))
        by_name[kname] = (n + 1, us + (e - s))
    busy = busy_us([(s, e) for _, s, e in kernels])
    print(f"[profile] {name}: {BATCHES} batches under the profiler: "
          f"{wall_us / BATCHES / 1e3:.3f} ms wall per batch, device busy "
          f"{busy / BATCHES / 1e3:.3f} ms per batch ({100 * busy / wall_us:.1f}%), "
          f"{len(kernels) / BATCHES:.0f} device launches per batch")
    print(f"[profile] {name}: device ms per batch, launches per batch, kernel:")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for kname, (n, us) in ranked[:TOP]:
        print(f"  {us / BATCHES / 1e3:9.3f} {n / BATCHES:6.0f}  {kname[:110]}")
    rest = sum(us for _, (_, us) in ranked[TOP:])
    print(f"  {rest / BATCHES / 1e3:9.3f}         (the other {max(0, len(ranked) - TOP)} names)")
    print_named(by_name, BATCHES, "batch", K3_K9P_NAMES)
    state = model.state_dict()
    del model
    torch.cuda.empty_cache()
    return state


@torch.no_grad()
def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--policy", choices=("bf16", "int8", "both"), default="both")
    p.add_argument("--model", choices=("midas", "seg"), default="midas")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_midas: no CUDA device", file=sys.stderr)
        return 2
    from prompt_diffusion_tpu_torch.utils.dtypes import default_policy, int8_policy

    title = "MiDaS DPT-Hybrid" if args.model == "midas" else "UniFormer-S/UperNet seg"
    print(f"[profile] {card()}; {title}, policy {args.policy}")
    state = None
    if args.policy in ("bf16", "both"):
        state = profile_policy("bf16", default_policy(), model_name=args.model)
    if args.policy in ("int8", "both"):
        profile_policy("int8", int8_policy(), state, model_name=args.model)
    return 0


if __name__ == "__main__":
    sys.exit(main())
