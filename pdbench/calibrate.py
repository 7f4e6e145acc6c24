"""The readings that the correctness limits are set from, on the card at a
cell's own size: for each seed one request of the program, with its timed
path kept, and the check's readings of it (`--seeds`); for each of
`--control-seeds` also the readings of the control, the reference one
precision below what the configuration states, at the same states. One
process, one JSON line a seed on standard output.

    python3 pdbench/calibrate.py --workload sd15.int8.b8 --seeds 1,2,3 --control-seeds 1,2,3
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seed: int, control: bool, device="cuda") -> dict:
    """{"program": readings, "control": readings or None} of request 0 of
    `seed`, with the steps the run's check would take."""
    import torch

    from pdbench import families, harness, inputs

    cfg, traffic = cell.config, cell.traffic
    fam = families.load(cfg["family"])
    pipe = fam.build(cfg, traffic, seed, device)
    req = inputs.request_inputs(cfg["family"], traffic, cfg, seed, 0, device)
    cap = fam.capture(pipe, traffic["batch"], device)
    images = fam.generate(pipe, req, traffic).cpu()
    cap.remove()
    del pipe
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    cap.load(device)
    steps = harness.check_steps(seed, traffic["steps"], harness.CHECK_STEPS)
    with torch.no_grad():
        out = {"program": fam.check(cfg, traffic, seed, req, cap, images, steps, device)}
        out["control"] = (fam.check(cfg, traffic, seed, req, cap, images, steps, device,
                                    control=True) if control else None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from pdbench.run import CACHES

    os.environ.update(CACHES)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from pdbench import spec

    cell = spec.cell(spec.benchmark(ROOT), args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed in seeds + sorted(controls - set(seeds)):
        t = time.perf_counter()
        r = readings(cell, seed, seed in controls)
        print(json.dumps({"workload": args.workload, "seed": seed, **r,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
