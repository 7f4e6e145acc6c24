"""DDIM sampling for the PyTorch port.

Counterpart of `prompt_diffusion_tpu/schedulers/ddim.py`. Update rule:
    pred_x0 = (x - sqrt(1 - a_t) * eps) / sqrt(a_t)
    dir_xt  = sqrt(1 - a_prev - sigma^2) * eps
    x_prev  = sqrt(a_prev) * pred_x0 + dir_xt + sigma * z
The loop is a Python loop over the table (the JAX package's `lax.scan`).
The per-step scalars are computed in fp32 numpy, as the JAX package
computes them in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from prompt_diffusion_tpu_torch.schedulers.schedules import (
    DiffusionSchedule,
    make_ddim_tables,
    make_ddim_timesteps,
)


@dataclasses.dataclass(frozen=True)
class DDIMTables:
    """Per-DDIM-step tables (fp32 numpy; timesteps int32), by ascending
    DDPM timestep. Sampling runs index S-1 -> 0."""

    timesteps: np.ndarray
    alphas: np.ndarray
    alphas_prev: np.ndarray
    sqrt_one_minus_alphas: np.ndarray
    sigmas: np.ndarray

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])

    @classmethod
    def create(cls, schedule: DiffusionSchedule, num_steps: int,
               eta: float = 0.0) -> "DDIMTables":
        ddim_ts = make_ddim_timesteps(num_steps, schedule.num_timesteps)
        sigmas, alphas, alphas_prev = make_ddim_tables(schedule.alphas_cumprod, ddim_ts, eta)
        f32 = lambda a: np.asarray(a).astype(np.float32)
        return cls(
            timesteps=ddim_ts.astype(np.int32),
            alphas=f32(alphas),
            alphas_prev=f32(alphas_prev),
            sqrt_one_minus_alphas=f32(np.sqrt(1.0 - alphas)),
            sigmas=f32(sigmas),
        )


def ddim_step(x: torch.Tensor, eps: torch.Tensor, index: int, tables: DDIMTables,
              noise: Optional[torch.Tensor] = None):
    """One DDIM update x_t -> x_{t-1}. Returns (x_prev, pred_x0)."""
    a_prev = tables.alphas_prev[index]
    sigma_t = tables.sigmas[index]
    pred_x0 = (x - float(tables.sqrt_one_minus_alphas[index]) * eps) / float(
        np.sqrt(tables.alphas[index]))
    dir_xt = float(np.sqrt(1.0 - a_prev - sigma_t**2)) * eps
    x_prev = float(np.sqrt(a_prev)) * pred_x0 + dir_xt
    if noise is not None:
        x_prev = x_prev + float(sigma_t) * noise
    return x_prev, pred_x0


def ddim_sample_loop(eps_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                     x_T: torch.Tensor, tables: DDIMTables,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Run every entry of the table. `eps_fn(x, t)` returns the
    (CFG-combined) epsilon. With a `generator` (eta > 0) each step adds
    sigma-scaled noise drawn from it."""
    x = x_T
    for i in range(tables.num_steps):
        index = tables.num_steps - 1 - i
        t_b = torch.full((x.shape[0],), int(tables.timesteps[index]), dtype=torch.int32,
                         device=x.device)
        eps = eps_fn(x, t_b)
        noise = None
        if generator is not None:
            noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        x, _ = ddim_step(x, eps, index, tables, noise=noise)
    return x
