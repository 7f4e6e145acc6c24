"""The measured window: one client in a closed loop. Requests start back to
back while less than the window's seconds have passed since its start; the
window ends when the last request has finished, so its rate is taken over
all the work and all the time it holds."""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass(frozen=True)
class Window:
    start: float
    end: float
    requests: int
    images: int
    ends: tuple = ()  # each request's end, seconds after the start

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def images_per_s(self) -> float:
        return self.images / self.seconds


def run(seconds: float, request, clock=time.perf_counter) -> Window:
    """`request(i)` serves request i and returns the images it completed
    (on the host)."""
    start = clock()
    n = images = 0
    ends = []
    while True:
        images += request(n)
        n += 1
        end = clock()
        ends.append(end - start)
        if end - start >= seconds:
            return Window(start, end, n, images, tuple(ends))
