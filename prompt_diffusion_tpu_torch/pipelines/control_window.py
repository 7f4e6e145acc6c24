"""Per-step ControlNet guidance window (`control_guidance_start/end`).

Counterpart of `prompt_diffusion_tpu/pipelines/control_window.py`: the
reference pipelines multiply a per-step 0/1 factor into the conditioning
scale,

    keep_i = 1.0 - float(i / N < start  or  (i + 1) / N > end),

which the JAX package computes in fp32 inside its denoise loop. Here the
loop runs on the host, so the factor is a Python float computed with the
same fp32 arithmetic.
"""

from __future__ import annotations

import numpy as np


def control_keep(step_index: int, num_steps: int, start: float, end: float) -> float:
    """The keep factor of sampling step `step_index` of `num_steps`: 1.0
    when the step's [i/N, (i+1)/N) window lies inside [start, end], else
    0.0 (comparisons in fp32, as the JAX package makes them)."""
    i, n = np.float32(step_index), np.float32(num_steps)
    drop = bool(i / n < np.float32(start)) or bool((i + np.float32(1.0)) / n > np.float32(end))
    return 0.0 if drop else 1.0


def step_index_from_timestep(table_timesteps: np.ndarray, t: int) -> int:
    """Sampling-order step index of model timestep `t`: the number of table
    entries with a larger timestep, whether the table is stored ascending
    (DDIM, PLMS) or descending (UniPC, DPM-Solver)."""
    return int((np.asarray(table_timesteps) > t).sum())


def keep_by_timestep(table_timesteps: np.ndarray, num_timesteps: int, start: float,
                     end: float) -> np.ndarray:
    """(num_timesteps,) fp32: the keep factor of the step that evaluates the
    model at each DDPM timestep, the step index taken from the timestep as
    `step_index_from_timestep` takes it and N the full table length, as the
    JAX package computes it inside its loop. A sampler's timesteps then
    gather their factor on the device."""
    n = len(table_timesteps)
    return np.asarray([control_keep(step_index_from_timestep(table_timesteps, t), n, start, end)
                       for t in range(num_timesteps)], np.float32)


def is_default_window(start, end) -> bool:
    """True when the window keeps every step (start 0, end 1)."""
    return float(start) == 0.0 and float(end) == 1.0


def validate_window(start, end) -> None:
    """The reference's check_inputs constraints on the window."""
    if float(start) >= float(end):
        raise ValueError(f"control_guidance_start ({start}) cannot be larger or equal to "
                         f"control_guidance_end ({end})")
    if not 0.0 <= float(start) <= 1.0:
        raise ValueError(f"control_guidance_start ({start}) must be in [0, 1]")
    if not 0.0 <= float(end) <= 1.0:
        raise ValueError(f"control_guidance_end ({end}) must be in [0, 1]")
