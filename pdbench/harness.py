"""One run of one cell: set-up, the measured window, the traced requests
(`--trace 1`), and the comparison with the plain reference that decides
`correct`. `run.py` checks for the card first; the tests drive `run`
directly on the CPU at small widths."""

from __future__ import annotations

import gc
import math
import sys
import time

import torch

from pdbench import families, inputs, spec, tracing, window
from pdbench.counts.layers import least_s
from pdbench.families.common import fine_spans
from pdbench.seeds import rng

CAPTURED = 2  # the checked request is one of the window's first this many, drawn from the seed
WARM_STEPS = 2  # set-up warms the cell's shapes with one request of this many steps
CHECK_STEPS = 4  # denoise steps the check recomputes (the sampler's it takes at every step)
TRACE_INDEX = 1 << 20  # request indices of the traced requests start here
# the profiler now and then loses an activity of a trace (one of 133,774 in
# an SD3 request on the H100), and a lost marker leaves the spans unread: a
# traced request is taken again, up to this many times in all
TRACE_TRIES = 3


def check_steps(seed: int, n: int, count: int) -> list:
    """The denoise steps the check recomputes: the first, the last and
    `count - 2` others drawn from the seed."""
    inner = list(range(1, n - 1))
    picked = rng(seed, "check", "steps").choice(inner, size=min(count - 2, len(inner)),
                                                replace=False)
    return sorted({0, n - 1, *map(int, picked)})


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def traced_requests(fam, pipe, cell, seed: int, device) -> dict:
    """Two requests after the window under the device trace: one with
    spans around the pipeline's stages only (the idle share, launches,
    breakdown, stage times), one with spans around every int8 layer and
    attention call (the rooflines). Their span readings, None where no
    try read."""
    records = {}
    for kind in ("coarse", "fine"):
        for attempt in range(TRACE_TRIES):
            records[kind] = _traced_request(fam, pipe, cell, seed, device, kind, attempt)
            if records[kind] is not None:
                break
    return records


def _traced_request(fam, pipe, cell, seed: int, device, kind: str, attempt: int):
    """One traced request with the `kind` of spans; its spans read, or None
    when its markers do not match."""
    traffic, cfg = cell.traffic, cell.config
    req = inputs.request_inputs(cfg["family"], traffic, cfg, seed,
                                TRACE_INDEX + 2 * attempt + (kind == "fine"), device)
    marks = tracing.Marks()
    if kind == "coarse":
        undo = []
        for module, stage in fam.stages(pipe):
            key = (lambda st: lambda m, a, k: ("stage", fam.stage_of(st, k)))(stage)
            undo += [h.remove for h in tracing.hook_spans(marks, module, key)]
    else:
        undo = fine_spans(marks, fam.denoisers(pipe))
    _sync(device)
    try:
        with tracing.device_trace() as tr:
            marks.open(("request",))
            fam.generate(pipe, req, traffic).cpu()
            marks.close(("request",))
    finally:
        for u in undo:
            u()
    read = tracing.spans(tr["events"], marks.labels)
    if read is None:
        found = sum(tracing.is_marker(e[0]) for e in tr["events"])
        print(f"trace {kind}: {found} markers for {len(marks.labels)} labels, "
              f"{len(tr['events'])} activities, {tr['sentinels']} of {2 * tracing.SENTINELS} "
              "sentinels; not read", file=sys.stderr)
    return read


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, t0: float,
        device="cuda", clock=time.perf_counter, log=sys.stderr) -> dict:
    """The result line's fields for one run of `cell`."""
    cfg, traffic = cell.config, cell.traffic
    fam = families.load(cfg["family"])
    b = traffic["batch"]
    make = lambda i: inputs.request_inputs(cfg["family"], traffic, cfg, seed, i, device)

    pipe = fam.build(cfg, traffic, seed, device)
    cuda = torch.device(device).type == "cuda"
    mem = (lambda f: f() if cuda else 0)
    if cuda:  # the peak of serving: the weights, not the scratch that made them
        torch.cuda.reset_peak_memory_stats()
    memory = {"weights": mem(torch.cuda.memory_allocated)}
    fam.generate(pipe, make(-1), traffic, steps=WARM_STEPS).cpu()
    _sync(device)
    setup_s = clock() - t0
    memory["warm_up_peak"] = mem(torch.cuda.max_memory_allocated)

    k = int(rng(seed, "check", "request").integers(CAPTURED))
    kept = {}

    def request(i):
        cap = fam.capture(pipe, b, device) if i == k else None
        images = fam.generate(pipe, make(i), traffic).cpu()
        if cap is not None:
            cap.remove()
            kept[i] = (cap, images)
        return images.shape[0]

    win = window.run(seconds, request, clock)
    peak = memory["window_peak"] = mem(torch.cuda.max_memory_allocated)
    if k not in kept:  # a window shorter than k + 1 requests: serve it after the close
        request(k)
    work = fam.work(cfg, traffic)
    # each end-to-end metric is the quantity its name starts with (before
    # the first dot): `images_per_s.sd3` is `images_per_s` in the SD3 cells
    base = {"images_per_s": win.images_per_s, "peak_mem_gib": peak / 2 ** 30,
            "setup_s": setup_s}
    result = {"attempted": win.requests}
    dev = {}
    if trace:
        records = traced_requests(fam, pipe, cell, seed, device)
        rec = {"coarse": records["coarse"], "fine": records["fine"], "batch": b,
               "steps": traffic["steps"], "policy": traffic["policy"],
               "window": {"seconds": win.seconds, "requests": win.requests,
                          "images": win.images},
               "least_s_per_request": least_s(work)}
        values = {}
        for m in cell.per_layer:
            v = spec.reader(m["name"])(rec)
            if v is not None:
                values[m["name"]] = (v, m["unit"])
        coarse = records["coarse"]
        if coarse is not None:
            req = next(c for c in coarse["calls"] if c["key"] == ("request",))
            busy = tracing.busy_us([(s, e) for _, s, e, _ in coarse["activities"]
                                    if req["start"] <= s and e <= req["end"]])
            dev = {"busy_s": busy / 1e6, "window_s": (req["end"] - req["start"]) / 1e6}
            result["breakdown"] = tracing.breakdown(coarse)
    else:
        values = {m["name"]: (base[m["name"].split(".")[0]], m["unit"])
                  for m in cell.end_to_end}

    del pipe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    cap, images = kept[k]
    cap.load(device)
    steps = check_steps(seed, traffic["steps"], CHECK_STEPS)
    with torch.no_grad():
        readings = fam.check(cfg, traffic, seed, make(k), cap, images, steps, device)
    limits = cell.limits["limits"]
    compared = {name: {"value": readings.get(name, float("inf")), "limit": limits[name]}
                for name in sorted(limits)}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in compared.values())
    for name, c in compared.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=log)
    result.update(correct=correct, failed=0 if correct else 1,
                  metrics={k: {"value": v, "unit": u} for k, (v, u) in values.items()},
                  device=dev, peak=peak, memory=memory, check=compared,
                  checked={"request": k, "steps": steps, "request_ends_s": list(win.ends)})
    return result
