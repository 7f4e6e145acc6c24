"""The benchmark of the PyTorch and CUDA port on one card.

    python3 pdbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs the cell named in `BENCHMARK.json` (its configuration and traffic
files under `pdbench/`): builds the pipeline with weights from the seed,
warms it up, serves requests back to back for the window, compares what
the timed path produced with the plain reference, and prints one JSON line
last on standard output. Exits non-zero, printing no result, without a CUDA
card (or fewer than the cell asks for), without the port beside it, or when
JAX or the JAX package is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "prompt_diffusion_tpu")
# every build and kernel cache of the program at a fixed place in the checkout;
# one host thread for PyTorch's CPU work (the timed path's work is on the
# card), so no thread pool competes with the thread that launches it
CACHES = {"TRITON_CACHE_DIR": os.path.join(ROOT, "build", "triton_cache"),
          "TORCH_EXTENSIONS_DIR": os.path.join(ROOT, "build", "torch_extensions"),
          "USE_FLAX": "0", "USE_JAX": "0", "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, Flax's or the
    JAX package's, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.update(CACHES)
    sys.path.insert(0, ROOT)
    if not os.path.isdir(os.path.join(ROOT, "prompt_diffusion_tpu_torch")):
        print("the port (prompt_diffusion_tpu_torch/) is not in this checkout", file=sys.stderr)
        return 2

    from pdbench import spec

    bench = spec.benchmark(ROOT)
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"needs {entry['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)

    from pdbench import harness

    result = harness.run(spec.cell(bench, args.workload), args.seed, args.seconds,
                         bool(args.trace), T0)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
              "memory_peak_bytes": result["peak"], "power_limit": _power_limit(),
              **result["device"]}
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"], "device": device}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["cell"] = args.workload
    line["memory_bytes"] = result["memory"]  # allocated after the build, peaks after each phase
    line["checked"] = result["checked"]
    line["check"] = result["check"]
    print(json.dumps(line), flush=True)
    return 0


def _power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as err:
        return f"unknown ({type(err).__name__})"
    return out.stdout.strip().splitlines()[0]


if __name__ == "__main__":
    sys.exit(main())
