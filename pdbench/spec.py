"""The benchmark's data: `BENCHMARK.json` at the checkout's root and the
files under `pdbench/` that its names lead to. A cell (`workloads` entry)
names a configuration, found as `configs/<config>.json`, and a traffic mix,
`traffic/<traffic>.json`; its correctness limits are `limits/<cell>.json`;
a per-layer metric's reader is `metrics/<metric>.py` (or that of the name
before its first dot), a module with `read(rec) -> float | None`. Nothing here needs editing for a new cell,
configuration, traffic mix or metric: adding the files and the entries is
enough."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(root: str, *parts) -> dict:
    with open(os.path.join(root, "pdbench", *parts)) as f:
        return json.load(f)


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def cell(bench: dict, name: str, root: str = ROOT) -> Cell:
    """The cell `name` with its files under `root` and the metrics it
    reports."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    reports = lambda m: name in m.get("workloads", [name])
    return Cell(name, config, _json(root, "traffic", entry["traffic"] + ".json"),
                _json(root, "limits", name + ".json"),
                [m for m in bench["end_to_end"] if reports(m)],
                [m for m in bench["per_layer"] if reports(m)])


def reader(metric: str, root: str = ROOT):
    """The `read` function of `metrics/<metric>.py` under `root`, or, where
    there is none, of the reader its name starts with (before the first
    dot): `denoise_ms.sd3` is read by `metrics/denoise_ms.py`."""
    path = os.path.join(root, "pdbench", "metrics", metric + ".py")
    if not os.path.exists(path):
        path = os.path.join(root, "pdbench", "metrics", metric.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location("pdbench_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
