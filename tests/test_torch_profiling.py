"""PyTorch port, `utils/profiling.py`: `StepTimer.stats()` equals the JAX
package's on the same `record()` sequence (and with `skip_first` and no
steps), `step()` times a block and waits on a CPU result without a card,
and `trace` writes a Chrome trace on the CPU that names an `annotate`d
range, also when the block raises."""

import json
import os

import pytest
import torch

from prompt_diffusion_tpu.utils import profiling as jprofiling
from prompt_diffusion_tpu_torch.utils import profiling


@pytest.mark.parametrize("skip_first,seconds", [
    (1, [0.5, 0.012, 0.010, 0.011, 0.0135, 0.009]),
    (0, [0.25, 0.125, 2.0]),
    (3, [0.1, 0.2])])
def test_step_timer_stats_match_jax(skip_first, seconds):
    mine, theirs = profiling.StepTimer(skip_first), jprofiling.StepTimer(skip_first)
    for s in seconds:
        mine.record(s)
        theirs.record(s)
    assert mine.stats() == theirs.stats()
    assert mine.times == theirs.times


def test_step_timer_times_a_block():
    timer = profiling.StepTimer(skip_first=1)
    for _ in range(3):
        with timer.step() as holder:
            holder["out"] = {"x": [torch.ones(4) * 2, (torch.zeros(2),)]}
    stats = timer.stats()
    assert stats["steps"] == 2 and 0 <= stats["min_ms"] <= stats["p50_ms"] <= stats["p90_ms"]


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "tr")
    with profiling.trace(logdir):
        with profiling.annotate("eval/step"):
            torch.randn(32, 32) @ torch.randn(32, 32)
    path = os.path.join(logdir, profiling.TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "eval/step" for e in events)
    with pytest.raises(ValueError):
        with profiling.trace(str(tmp_path / "raised")):
            raise ValueError("inside the trace")
    assert os.path.exists(os.path.join(str(tmp_path / "raised"), profiling.TRACE_FILE))
