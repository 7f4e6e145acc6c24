"""Spans of the benchmark's own, read from the device trace.

The program has no spans of its own, so the benchmark opens them around
calls into the port's modules, with forward pre- and post-hooks. A span's
ends are markers on the device: each hook launches one spin kernel
(`torch.cuda._sleep(1)`, named `spin_kernel`) and appends its label on the
host. The stream runs in order, so every device activity between two
markers belongs to the spans open there, and no host and device clocks need
to agree. The trace is a `torch.profiler` trace of the device only (no host
operators recorded), between `SENTINELS` spin kernels at each end and
`PAD_S` of host time, as the port's `tools/timing.py::device_trace` guards
against a trace that loses its end activities; the sentinels spin longer
than a marker, which tells them apart. A trace whose markers do not
match the labels one for one is not read.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

MARKER = "spin_kernel"  # a part of the name (at::cuda::(anonymous namespace)::spin_kernel)
SENTINELS, PAD_S = 128, 0.005
# a sentinel spins ~100 us, a marker one cycle (~2 us on the device): the
# sentinels are told apart by their length, since a trace can lose some of
# them (seen on the H100: 2, 4, then 6 spin kernels of ~41,000 lost by
# successive traces of one process, every other activity kept; 56 of the
# first activities of a trace, 16 sentinels among them, late in another)
SENTINEL_CYCLES, SENTINEL_MIN_US = 200_000, 20.0


def is_marker(name: str) -> bool:
    return MARKER in name


class Marks:
    """The labels of the markers launched, in order: ("open", key) or
    ("close", key)."""

    def __init__(self, launch=None):
        self.labels = []
        self._launch = launch

    def _emit(self, label):
        if self._launch is None:
            import torch

            self._launch = lambda: torch.cuda._sleep(1)
        self._launch()
        self.labels.append(label)

    def open(self, key):
        self._emit(("open", key))

    def close(self, key):
        self._emit(("close", key))


def hook_spans(marks: Marks, module, key_of) -> list:
    """Opens a span around each call of `module`; `key_of(module, args,
    kwargs)` gives the span's key (a tuple whose first item is its kind).
    Returns the hook handles."""
    keys = []

    def pre(m, args, kwargs):
        key = key_of(m, args, kwargs)
        keys.append(key)
        marks.open(key)

    def post(m, args, kwargs, out):
        marks.close(keys.pop())

    return [module.register_forward_pre_hook(pre, with_kwargs=True),
            module.register_forward_hook(post, with_kwargs=True)]


def wrap_method(marks: Marks, obj, name: str, key_of):
    """Opens a span around each call of the bound method `obj.name` (a
    call that is no module's forward); returns a function that undoes it."""
    inner = getattr(obj, name)

    def wrapped(*args, **kwargs):
        key = key_of(*args, **kwargs)
        marks.open(key)
        out = inner(*args, **kwargs)
        marks.close(key)
        return out

    setattr(obj, name, wrapped)
    return lambda: delattr(obj, name)


@contextlib.contextmanager
def device_trace():
    """Yields a holder whose "events" the block's device activities fill
    when it ends: [(name, start_us, end_us)] sorted by start, sentinels
    dropped, markers kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    holder = {}
    sentinels = lambda: [torch.cuda._sleep(SENTINEL_CYCLES) for _ in range(SENTINELS)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PAD_S)
        sentinels()
        yield holder
        sentinels()
        torch.cuda.synchronize()
        time.sleep(PAD_S)
    events = device_events(prof)
    holder["events"] = strip_sentinels(events)
    holder["sentinels"] = len(events) - len(holder["events"])


def device_events(prof) -> list:
    """[(name, start_us, end_us)] of the device activities in a finished
    profile, sorted by start."""
    import torch

    out = []
    kin = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if kin is not None:
        for e in kin.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                start = e.start_ns() / 1e3
                out.append((e.name(), start, start + e.duration_ns() / 1e3))
    else:
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                out.append((e.name, e.time_range.start, e.time_range.end))
    return sorted(out, key=lambda e: (e[1], e[2]))


def strip_sentinels(events: list) -> list:
    """The events without the sentinels (spin kernels of SENTINEL_MIN_US
    or more)."""
    return [e for e in events if not (is_marker(e[0]) and e[2] - e[1] >= SENTINEL_MIN_US)]


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    return total + (cur_end - cur_start if cur_end is not None else 0.0)


def spans(events: list, labels: list):
    """Reads the spans: {"calls": [{"key", "self_us", "total_us", "start",
    "end"}] in the order they opened, "activities": [(name, start, end,
    key of the innermost open span or None)], "gaps": [(start, end, key of
    the innermost span open at the gap or None)]}; None when the markers
    and labels do not match one for one."""
    markers = [e for e in events if is_marker(e[0])]
    if len(markers) != len(labels):
        return None
    stack, calls, acts, gaps = [], [], [], []
    li, prev_end = 0, None
    for name, start, end in events:
        if prev_end is not None and start > prev_end and stack:
            gaps.append((prev_end, start, calls[stack[-1]]["key"]))
        prev_end = end if prev_end is None else max(prev_end, end)
        if is_marker(name):
            op, key = labels[li]
            li += 1
            if op == "open":
                calls.append({"key": key, "self_us": 0.0, "total_us": 0.0, "start": end,
                              "end": None})
                stack.append(len(calls) - 1)
            else:
                if not stack or calls[stack[-1]]["key"] != key:
                    return None
                calls[stack.pop()]["end"] = start
            continue
        acts.append((name, start, end, calls[stack[-1]]["key"] if stack else None))
        if stack:
            calls[stack[-1]]["self_us"] += end - start
            for i in stack:
                calls[i]["total_us"] += end - start
    return None if stack else {"calls": calls, "activities": acts, "gaps": gaps}


def breakdown(read: dict, top: int = 10) -> dict:
    """The device operations that took most time and the device's idle time
    by the span the host was in, seconds, at most `top` of each."""
    ops, idle = defaultdict(float), defaultdict(float)
    for name, start, end, _ in read["activities"]:
        ops[name] += (end - start) / 1e6
    for start, end, key in read["gaps"]:
        idle[key[1] if key[0] == "stage" else key[0]] += (end - start) / 1e6
    best = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": best(ops), "idle_gaps": best(idle)}
