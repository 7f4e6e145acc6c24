"""Timing on the card and the least time the card could take for a piece of
work, shared by `chip_smoke.py`, the attention lab and the profiles.

`device_ms` is the time a call keeps the card busy: the union of the
device intervals of everything the call launches (kernels, copies,
memsets), from a `torch.profiler` trace of back-to-back calls, per call.
`stream_ms` reads the same without the profiler, from CUDA events around
calls queued behind a spin kernel (the device's gaps between launches
included), where a trace cannot be trusted to hold every activity.
It leaves out the host's part of a call (the wrapper's Python, the launch
itself), which `time_ms`, CUDA events around one synchronised call,
includes: below ~0.1 ms of device work that host time is most of a
`time_ms` reading.

The bound is the largest of the bytes the function must move (each input
read once, each output written once) over the memory rate, its
tensor-core operations over their dense peak, and its exponentials over
the special-function units' rate, from the published peaks of one NVIDIA
H100 SXM at its 700 W limit (NVIDIA's data sheet; ~3.9e12 exponentials/s
from the FlashAttention-3 paper, Shah et al. 2024, §1: 132 SMs x 16
special-function results per clock). A softmax takes one exponential per
logit, which at small head dimensions outweighs the tensor work. A card
set to a lower power limit runs slower: print `card()` beside every
number.
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import time

HBM_BYTES_S, BF16_OPS_S, INT8_OPS_S, EXP_S = 3.35e12, 989e12, 1979e12, 3.9e12


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=10, warmup=2):
    """Median milliseconds of one call, from CUDA events around each call
    (the host's part of the call included)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_kernels(prof):
    """(name, start_us, end_us) of every device activity in a trace but
    `device_trace`'s sentinels."""
    import torch

    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and SENTINEL not in e.name]


def busy_us(intervals):
    """Length of the union of [start, end) intervals."""
    total, cur_start, cur_end = 0, None, None
    for s, e in sorted(intervals):
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    return total + (cur_end - cur_start if cur_end is not None else 0)


# A trace can lose a few activities at its ends: seen on the H100 a few
# minutes into a `quant_tune` run, where every trace of 5 calls of one
# launch held 1 to 3 of them and one of 15 launches held 11, with the
# window padded by 5 or 50 ms of host time as with none. `device_trace`
# launches SENTINELS spin kernels (`torch.cuda._sleep`, named SENTINEL) at
# each end of its block, which `device_kernels` leaves out, and pads the
# window by PROFILE_PAD_S on both sides.
SENTINELS, SENTINEL, PROFILE_PAD_S = 16, "spin_kernel", 0.005


def _sentinels():
    import torch

    for _ in range(SENTINELS):
        torch.cuda._sleep(1)


@contextlib.contextmanager
def device_trace():
    """`torch.profiler.profile` of the device over the block, which ends
    synchronised, between sentinels and padding (above)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        _sentinels()
        yield prof
        _sentinels()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)


# CUPTI now and then hands back a trace with no device activity (seen once
# among the ~170 traces of a `chip_smoke.py` run on the H100), or one that
# lost some of its activities (seen on the H100: one launch of three in a
# trace, and a K13 reading below its byte bound with its inputs rotated out
# of L2); a trace is taken again, up to this many times in all, while it is
# empty or its activities are not a whole number per call
PROFILE_TRIES = 3


def _device_trace(fn, iters, warmup, what, launches=None):
    """(name, start_us, end_us) of the device activities of `iters`
    back-to-back calls of `fn` under `torch.profiler`, after `warmup`
    calls: the first trace whose count is a whole number per call (with
    `launches`, exactly that many per call), else the fullest of
    PROFILE_TRIES (a lost activity only lowers the count).
    Raises without a CUDA device or when every trace is empty; it never
    falls back to a host clock."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    fullest = []
    for _ in range(PROFILE_TRIES):
        with device_trace() as prof:
            for _ in range(iters):
                fn()
        kernels = device_kernels(prof)
        if kernels and (len(kernels) == launches * iters if launches
                        else len(kernels) % iters == 0):
            return kernels
        fullest = max(fullest, kernels, key=len)
    if fullest:
        return fullest
    raise RuntimeError(f"the profiler recorded no device activity in {PROFILE_TRIES} traces")


def device_ms(fn, iters=20, warmup=3, launches=None):
    """Device milliseconds per call of `fn`: the union of the device
    intervals of `iters` back-to-back calls over `iters`; `launches`, the
    device activities a call makes where known, rejects a trace that lost
    some in whole calls' worth, and where every trace lost some, the
    fullest one's union is divided by the calls it holds."""
    kernels = _device_trace(fn, iters, warmup, "device_ms", launches)
    calls = min(iters, len(kernels) / launches) if launches else iters
    return busy_us([(s, e) for _, s, e in kernels]) / calls / 1e3


# cycles of the spin kernel that holds the stream while `stream_ms` queues
# its calls (~10 ms at the H100's clock, longer than the host needs to
# queue 20 calls of any wrapper timed here)
SPIN_CYCLES = 20_000_000


def stream_ms(fn, iters=20, warmup=3):
    """Device milliseconds per call of `fn`, without the profiler: CUDA
    events around `iters` calls queued behind a spin kernel, so the device
    runs them back to back whatever the host's pace (the gaps between
    launches on the device included, the host's part of a call not).
    Raises without a CUDA device."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("stream_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_launches(fn, iters=5, warmup=1):
    """Device activities (kernels, copies, memsets) per call of `fn`."""
    return len(_device_trace(fn, iters, warmup, "device_launches")) / iters


def device_launch_names(fn, iters=5, warmup=1):
    """{name: device activities of that name per call of `fn`}."""
    names = [name for name, _, _ in _device_trace(fn, iters, warmup, "device_launch_names")]
    return {name: names.count(name) / iters for name in sorted(set(names))}


def roofline(nbytes, int8_ops=0.0, bf16_ops=0.0, exps=0.0):
    """(bound_ms, bound_by): the largest of the bytes over the memory rate,
    the tensor-core operations over their dense peaks and the exponentials
    over the special-function rate; bound_by is "bytes", "operations" or
    "exponentials"."""
    times = {"bytes": nbytes / HBM_BYTES_S,
             "operations": int8_ops / INT8_OPS_S + bf16_ops / BF16_OPS_S,
             "exponentials": exps / EXP_S}
    by = max(times, key=times.get)
    return times[by] * 1e3, by
