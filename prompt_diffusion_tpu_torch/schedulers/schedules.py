"""Noise schedule and DDIM tables, built in float64 numpy.

Counterpart of `prompt_diffusion_tpu/schedulers/schedules.py`, restricted
to what DDIM sampling reads. The arithmetic is the same, step for step
(including the fp32 rounding of alphas_cumprod before the DDIM tables are
built from it), so the tables are bit-equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def make_beta_schedule(schedule: str, n_timestep: int, linear_start: float = 1e-4,
                       linear_end: float = 2e-2) -> np.ndarray:
    """Beta schedule, float64. "linear" is SD's sqrt-space linear ramp."""
    if schedule != "linear":
        raise ValueError(f"schedule {schedule!r} is not ported (only 'linear')")
    return np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64) ** 2


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """DDPM process tables that sampling needs (fp32 numpy, length T)."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    @classmethod
    def create(cls, schedule: str = "linear", timesteps: int = 1000,
               linear_start: float = 0.00085, linear_end: float = 0.0120) -> "DiffusionSchedule":
        betas = make_beta_schedule(schedule, timesteps, linear_start, linear_end)
        acp = np.cumprod(1.0 - betas, axis=0)
        return cls(betas=betas.astype(np.float32), alphas_cumprod=acp.astype(np.float32))


def make_ddim_timesteps(num_ddim_timesteps: int, num_ddpm_timesteps: int) -> np.ndarray:
    """Uniform DDIM sub-sequence of DDPM steps, with the reference's +1
    offset clamped to the last valid timestep. Its length exceeds
    `num_ddim_timesteps` when that does not divide the DDPM count."""
    c = num_ddpm_timesteps // num_ddim_timesteps
    ddim_timesteps = np.asarray(list(range(0, num_ddpm_timesteps, c)))
    return np.minimum(ddim_timesteps + 1, num_ddpm_timesteps - 1)


def make_ddim_tables(alphas_cumprod: np.ndarray, ddim_timesteps: np.ndarray,
                     eta: float = 0.0):
    """(sigma, alpha, alpha_prev) per DDIM step, float64."""
    acp = np.asarray(alphas_cumprod, dtype=np.float64)
    alphas = acp[ddim_timesteps]
    alphas_prev = np.asarray([acp[0]] + acp[ddim_timesteps[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev
