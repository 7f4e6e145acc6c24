"""PyTorch port, the timer (`prompt_diffusion_tpu_torch/tools/timing.py`):
the union of device intervals behind `device_ms` and the profiles, that
`device_ms` refuses to run without a card, and the bound PERF.md states
for K9's SD3 row."""

import pytest
import torch

from prompt_diffusion_tpu_torch.tools import timing


@pytest.fixture(autouse=True)
def _no_sentinels(monkeypatch):
    """The fake traces below hold no sentinel kernels, and no card runs
    them."""
    monkeypatch.setattr(timing, "_sentinels", lambda: None)
    monkeypatch.setattr(timing, "PROFILE_PAD_S", 0.0)


@pytest.mark.parametrize("intervals,union", [
    ([], 0),
    ([(0, 5)], 5),
    ([(0, 2), (4, 7), (10, 11)], 6),           # disjoint
    ([(0, 4), (2, 6), (5, 9)], 9),             # overlapping in a chain
    ([(0, 10), (2, 3), (4, 8)], 10),           # nested
    ([(5, 9), (0, 4), (3, 6), (20, 21)], 10),  # unsorted, overlapping and disjoint
    ([(0, 3), (3, 5)], 5),                     # touching
])
def test_busy_us_is_the_union(intervals, union):
    assert timing.busy_us(intervals) == union


def test_stream_ms_raises_without_a_card(monkeypatch):
    """No CUDA device: `stream_ms` raises before it calls the function."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    with pytest.raises(RuntimeError, match="CUDA device"):
        timing.stream_ms(lambda: calls.append(1))
    assert calls == []


def test_device_ms_raises_without_a_card(monkeypatch):
    """No CUDA device: `device_ms` raises and never calls the function or
    falls back to a host clock."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    with pytest.raises(RuntimeError, match="CUDA device"):
        timing.device_ms(lambda: calls.append(1))
    assert calls == []


def test_roofline_k9_sd3_bound():
    """K9 at the SD3 joint shape (CFG batch 2, 4096 + 333 tokens, 24 heads
    of 64), the work `chip_smoke.py` gives it: its exponentials bound it
    at 0.241 ms (PERF.md §6), above its bytes and tensor operations."""
    b, n, hd, h = 2, 4429, 1536, 24
    bound_ms, by = timing.roofline(8 * b * n * hd, 2 * b * n * n * hd, 2 * b * n * n * hd,
                                   b * h * n * n)
    assert by == "exponentials"
    assert round(bound_ms, 3) == 0.241


class _Trace:
    """A stand-in for `torch.profiler.profile`; `device_kernels` is faked."""

    def __init__(self, activities):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("traces,expected", [
    ([[("k", 0, 20), ("k", 20, 40)]], 0.02),
    ([[], [], [("k", 0, 30), ("k", 10, 50)]], 0.025),  # the third trace holds the calls
    ([[], [], [], [("k", 0, 40)]], None),               # PROFILE_TRIES empty traces: raises
])
def test_device_ms_retakes_an_empty_trace(monkeypatch, traces, expected):
    """A trace with no device activity is taken again, up to PROFILE_TRIES
    traces in all; then `device_ms` raises rather than read a host clock."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.profiler, "profile", _Trace)
    pending = list(traces)
    monkeypatch.setattr(timing, "device_kernels", lambda prof: pending.pop(0))
    calls = []
    if expected is None:
        with pytest.raises(RuntimeError, match="no device activity"):
            timing.device_ms(lambda: calls.append(1), iters=2, warmup=1)
        assert len(calls) == 1 + 2 * timing.PROFILE_TRIES
    else:
        assert timing.device_ms(lambda: calls.append(1), iters=2, warmup=1) == pytest.approx(expected)
        assert len(calls) == 1 + 2 * len(traces)


@pytest.mark.parametrize("traces,expected", [
    ([[("k", 0, 4)] * 3], 1.0),                                  # one launch per call
    ([[("k", 0, 4)] * 6], 2.0),                                  # two
    ([[("k", 0, 4)], [("k", 0, 4)] * 3], 1.0),                   # a loss, then a whole trace
    ([[("k", 0, 4)] * 2, [("k", 0, 4)], [("k", 0, 4)] * 4], 4 / 3),  # losses in every trace
])
def test_device_launches_retakes_a_trace_with_losses(monkeypatch, traces, expected):
    """`device_launches` counts device activities per call; a trace that
    does not hold a whole number per call lost some and is taken again, up
    to PROFILE_TRIES traces, and the fullest is kept."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.profiler, "profile", _Trace)
    pending = list(traces)
    monkeypatch.setattr(timing, "device_kernels", lambda prof: pending.pop(0))
    assert timing.device_launches(lambda: None, iters=3, warmup=0) == pytest.approx(expected)
    assert not pending


def test_device_ms_retakes_a_trace_with_losses(monkeypatch):
    """`device_ms` reads the first trace that holds a whole number of
    activities per call: one that lost some would read short."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.profiler, "profile", _Trace)
    pending = [[("k", 0, 10)], [("k", 0, 10), ("k", 10, 20)]]
    monkeypatch.setattr(timing, "device_kernels", lambda prof: pending.pop(0))
    assert timing.device_ms(lambda: None, iters=2, warmup=0) == pytest.approx(0.01)
    assert not pending


def test_device_ms_with_known_launches_retakes_a_trace_that_lost_whole_calls(monkeypatch):
    """With `launches`, a trace counts only with exactly that many
    activities per call: one that lost a call's worth (a whole number per
    call all the same) is taken again."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.profiler, "profile", _Trace)
    pending = [[("copy", 0, 10), ("k", 10, 20)],
               [("copy", 0, 10), ("k", 10, 20), ("copy", 20, 30), ("k", 30, 40)]]
    monkeypatch.setattr(timing, "device_kernels", lambda prof: pending.pop(0))
    assert timing.device_ms(lambda: None, iters=2, warmup=0, launches=2) == pytest.approx(0.02)
    assert not pending


def test_device_ms_with_known_launches_divides_by_the_calls_it_holds(monkeypatch):
    """Where every trace lost activities, `device_ms` with `launches` reads
    the fullest trace per call it holds, not per call made: a lost call
    would otherwise read as idle time."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.profiler, "profile", _Trace)
    pending = [[("k", 0, 10)], [("k", 0, 10), ("k", 10, 20)], [("k", 0, 10)]]
    monkeypatch.setattr(timing, "device_kernels", lambda prof: pending.pop(0))
    assert timing.device_ms(lambda: None, iters=4, warmup=0, launches=1) == pytest.approx(0.01)
    assert not pending


def test_device_kernels_leave_out_the_sentinels():
    """`device_trace`'s spin kernels at the ends of a trace are not the
    traced calls' activities; host events are not device activities."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    event = lambda name, dev, s, e: type("E", (), {
        "name": name, "device_type": dev,
        "time_range": type("R", (), {"start": s, "end": e})})
    prof = type("P", (), {"events": lambda self: [
        event("void at::cuda::(anonymous namespace)::spin_kernel(long)", cuda, 0, 2),
        event("gn_float_kernel", cuda, 2, 9), event("aten::empty", cpu, 0, 1),
        event("void at::cuda::(anonymous namespace)::spin_kernel(long)", cuda, 9, 11)]})()
    assert timing.device_kernels(prof) == [("gn_float_kernel", 2, 9)]
