"""The closed loop's window arithmetic under a fake clock."""

import pytest

from pdbench import window


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


@pytest.mark.parametrize("seconds,per_request,want_requests", [
    (10.0, 3.0, 4),   # starts at 0, 3, 6, 9; the last ends at 12
    (9.0, 3.0, 3),    # the third ends at 9, when the window's time is up
    (1.0, 5.0, 1),    # one request longer than the window
])
def test_requests_start_until_the_time_is_up(seconds, per_request, want_requests):
    clock = FakeClock()

    def request(i):
        clock.now += per_request
        return 8

    win = window.run(seconds, request, clock)
    assert win.requests == want_requests
    assert win.images == 8 * want_requests
    assert win.seconds == pytest.approx(per_request * want_requests)
    assert win.images_per_s == pytest.approx(8 / per_request)


def test_rate_takes_all_the_time_of_the_window():
    clock = FakeClock()
    durations = iter([2.0, 6.0, 1.0])

    def request(i):
        clock.now += next(durations)
        return 1

    win = window.run(8.5, request, clock)
    assert (win.requests, win.images) == (3, 3)
    assert win.images_per_s == pytest.approx(3 / 9.0)


def test_spans_read_markers_and_drop_sentinels():
    """Sentinels (long spin kernels) are dropped whatever their number; the
    markers nest the spans; self time leaves out the inner span's."""
    from pdbench import tracing

    spin = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    ev = [(spin, 0.0, 100.0), (spin, 110.0, 111.0), ("k1", 120.0, 130.0), (spin, 131.0, 132.0),
          ("k2", 140.0, 150.0), (spin, 151.0, 152.0), ("k3", 160.0, 165.0),
          (spin, 170.0, 171.0), (spin, 180.0, 280.0)]
    labels = [("open", ("request",)), ("open", ("stage", "denoise")),
              ("close", ("stage", "denoise")), ("close", ("request",))]
    read = tracing.spans(tracing.strip_sentinels(ev), labels)
    req, den = read["calls"]
    assert den["self_us"] == 10.0 and req["self_us"] == 15.0 and req["total_us"] == 25.0
    den_key, req_key = ("stage", "denoise"), ("request",)
    assert [g[2] for g in read["gaps"]] == [req_key, req_key, den_key, den_key, req_key, req_key]
    assert tracing.breakdown(read)["idle_gaps"] == [["request", 23.0 / 1e6], ["denoise", 9.0 / 1e6]]
    assert tracing.spans(tracing.strip_sentinels(ev[1:]), labels[:3]) is None


@pytest.mark.parametrize("name", ["sd15.int8.b8", "sd3.int8.b1", "sd15.bf16.b8"])
def test_spans_nest_in_a_request(name):
    """The stage spans and the per-layer spans the traced requests open
    around a tiny CPU request close in the order they opened."""
    from pdbench import families, inputs, tracing
    from pdbench.families.common import fine_spans
    from pdbench.tests.tiny import tiny_cell

    cell = tiny_cell(name, steps=2)
    fam = families.load(cell.config["family"])
    pipe = fam.build(cell.config, cell.traffic, 1, "cpu")
    req = inputs.request_inputs(cell.config["family"], cell.traffic, cell.config, 1, 0, "cpu")
    for kind in ("coarse", "fine"):
        marks = tracing.Marks(launch=lambda: None)
        if kind == "coarse":
            undo = [h.remove for module, stage in fam.stages(pipe)
                    for h in tracing.hook_spans(marks, module, lambda m, a, k: ("stage", "x"))]
        else:
            undo = fine_spans(marks, fam.denoisers(pipe))
        fam.generate(pipe, req, cell.traffic)
        for u in undo:
            u()
        stack = []
        for op, key in marks.labels:
            if op == "open":
                stack.append(key)
            else:
                assert stack.pop() == key
        assert not stack and marks.labels
        if kind == "fine":
            kinds = {key[0] for _, key in marks.labels}
            assert "attention" in kinds
            assert ("int8_layer" in kinds) == (cell.traffic["policy"] == "int8")
