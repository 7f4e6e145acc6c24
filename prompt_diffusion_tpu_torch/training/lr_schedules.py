"""Learning-rate schedules as plain functions of the optimizer step.

Counterpart of `prompt_diffusion_tpu/training/lr_schedules.py` (the
reference's `LambdaLinearScheduler`, ldm/lr_scheduler.py:81-97, used by
models/cldm_v15.yaml:21-28, and the warmup-cosine variant). Each returns a
function step -> learning rate (a Python float).
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def lambda_linear(base_lr: float, warm_up_steps: int = 0, f_start: float = 1e-6,
                  f_max: float = 1.0, f_min: float = 1.0,
                  cycle_length: float = 1e13) -> Schedule:
    """f ramps f_start -> f_max over the warmup, then decays linearly toward
    f_min over the cycle, f = f_min + (f_max - f_min) * (L - n) / L; the
    learning rate is base_lr * f. The PD config's single cycle has f_min
    == f_max and L = 1e13, a constant after the warmup."""

    def schedule(step: int) -> float:
        if warm_up_steps > 0 and step < warm_up_steps:
            f = f_start + (f_max - f_start) * step / warm_up_steps
        else:
            f = f_min + (f_max - f_min) * (cycle_length - step) / cycle_length
        return base_lr * f

    return schedule


def warmup_cosine(base_lr: float, warm_up_steps: int, lr_min: float, lr_max: float,
                  lr_start: float, max_steps: int) -> Schedule:
    """A linear warmup lr_start -> lr_max, then a cosine from lr_max to
    lr_min over the remaining steps (held at lr_min after max_steps); the
    learning rate is base_lr times that factor."""

    def schedule(step: int) -> float:
        if step < warm_up_steps:
            f = lr_start + (lr_max - lr_start) * step / max(warm_up_steps, 1)
        else:
            t = (step - warm_up_steps) / max(max_steps - warm_up_steps, 1)
            t = min(max(t, 0.0), 1.0)
            f = lr_min + 0.5 * (lr_max - lr_min) * (1 + math.cos(t * math.pi))
        return base_lr * f

    return schedule
