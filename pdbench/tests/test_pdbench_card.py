"""On the card (`-m card`): one short run of each cell comes out correct,
and its control fails a limit, at the cell's own sizes."""

import io
import time

import pytest

from pdbench import harness, spec
from pdbench.calibrate import readings

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_is_correct(card, name):
    cell = spec.cell(BENCH, name)
    result = harness.run(cell, 4_000_000_001, 1.0, False, time.perf_counter(), device=card,
                         log=io.StringIO())
    assert result["correct"], result["check"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_a_limit(card, name):
    cell = spec.cell(BENCH, name)
    got = readings(cell, 4_000_000_002, True, card)
    limits = cell.limits["limits"]
    assert all(got["program"][k] <= v for k, v in limits.items()), got["program"]
    assert any(got["control"][k] > v for k, v in limits.items()), got["control"]
