"""DDIM sampling and inversion for the PyTorch port.

Counterpart of `prompt_diffusion_tpu/schedulers/ddim.py`. Update rule:
    pred_x0 = (x - sqrt(1 - a_t) * eps) / sqrt(a_t)
    dir_xt  = sqrt(1 - a_prev - sigma^2) * eps
    x_prev  = sqrt(a_prev) * pred_x0 + dir_xt + sigma * z * temperature
The loops are Python loops over the table (the JAX package's `lax.scan`).
The per-step scalars are computed in fp32 numpy, as the JAX package
computes them in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from prompt_diffusion_tpu_torch.schedulers.schedules import (
    DiffusionSchedule,
    make_ddim_tables,
    make_ddim_timesteps,
)

EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


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
    def create(cls, schedule: DiffusionSchedule, num_steps: int, eta: float = 0.0,
               method: str = "uniform") -> "DDIMTables":
        ddim_ts = make_ddim_timesteps(num_steps, schedule.num_timesteps, method)
        sigmas, alphas, alphas_prev = make_ddim_tables(schedule.alphas_cumprod, ddim_ts, eta)
        f32 = lambda a: np.asarray(a).astype(np.float32)
        return cls(
            timesteps=ddim_ts.astype(np.int32),
            alphas=f32(alphas),
            alphas_prev=f32(alphas_prev),
            sqrt_one_minus_alphas=f32(np.sqrt(1.0 - alphas)),
            sigmas=f32(sigmas),
        )


def timestep_batch(x: torch.Tensor, t) -> torch.Tensor:
    """(B,) int32 timesteps t on x's device, B = x's batch."""
    return torch.full((x.shape[0],), int(t), dtype=torch.int32, device=x.device)


def ddim_step(x: torch.Tensor, eps: torch.Tensor, index: int, tables: DDIMTables,
              noise: Optional[torch.Tensor] = None, temperature: float = 1.0):
    """One DDIM update x_t -> x_{t-1}. Returns (x_prev, pred_x0)."""
    a_prev = tables.alphas_prev[index]
    sigma_t = tables.sigmas[index]
    pred_x0 = (x - float(tables.sqrt_one_minus_alphas[index]) * eps) / float(
        np.sqrt(tables.alphas[index]))
    dir_xt = float(np.sqrt(1.0 - a_prev - sigma_t**2)) * eps
    x_prev = float(np.sqrt(a_prev)) * pred_x0 + dir_xt
    if noise is not None:
        x_prev = x_prev + float(sigma_t) * noise * temperature
    return x_prev, pred_x0


def ddim_sample_loop(eps_fn: EpsFn, x_T: torch.Tensor, tables: DDIMTables,
                     generator: Optional[torch.Generator] = None,
                     temperature: float = 1.0,
                     noise_rows: Optional[Tuple[int, slice]] = None) -> torch.Tensor:
    """Run every entry of the table. `eps_fn(x, t)` returns the
    (CFG-combined) epsilon. With a `generator` (eta > 0) each step adds
    sigma-scaled noise drawn from it; with `noise_rows` = (whole batch,
    x's rows of it), x being one rank's rows of a sharded call, each
    step's noise is drawn for the whole batch and x's rows taken."""
    x = x_T
    for i in range(tables.num_steps):
        index = tables.num_steps - 1 - i
        eps = eps_fn(x, timestep_batch(x, tables.timesteps[index]))
        noise = None
        if generator is not None:
            shape = x.shape if noise_rows is None else (noise_rows[0],) + x.shape[1:]
            noise = torch.randn(shape, generator=generator, device=x.device, dtype=x.dtype)
            if noise_rows is not None:
                noise = noise[noise_rows[1]]
        x, _ = ddim_step(x, eps, index, tables, noise=noise, temperature=temperature)
    return x


def ddim_encode_loop(eps_fn: EpsFn, x0: torch.Tensor, tables: DDIMTables,
                     t_enc: int) -> torch.Tensor:
    """Deterministic DDIM inversion x_0 -> x_{t_enc}: the update run
    backwards through the first `t_enc` DDIM steps."""
    x = x0
    for i in range(t_enc):
        eps = eps_fn(x, timestep_batch(x, tables.timesteps[i]))
        a_next, a_cur = tables.alphas[i], tables.alphas_prev[i]
        x0_pred = (x - float(np.sqrt(1.0 - a_cur)) * eps) / float(np.sqrt(a_cur))
        x = float(np.sqrt(a_next)) * x0_pred + float(np.sqrt(1.0 - a_next)) * eps
    return x


def stochastic_encode(x0: torch.Tensor, t_index: int, tables: DDIMTables,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """q_sample with the DDIM alpha sub-table; the noise is drawn from
    `generator` on x0's device."""
    a = tables.alphas[t_index]
    noise = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
    return float(np.sqrt(a)) * x0 + float(np.sqrt(1.0 - a)) * noise


def ddim_decode_loop(eps_fn: EpsFn, x_t: torch.Tensor, tables: DDIMTables,
                     t_start: int) -> torch.Tensor:
    """Denoise from DDIM index t_start - 1 down to 0 (the second half of
    edit-by-inversion)."""
    if not 0 <= t_start <= tables.num_steps:
        raise ValueError(f"t_start {t_start} outside [0, {tables.num_steps}]")
    x = x_t
    for index in range(t_start - 1, -1, -1):
        eps = eps_fn(x, timestep_batch(x, tables.timesteps[index]))
        x, _ = ddim_step(x, eps, index, tables)
    return x
