"""DPM-Solver and DPM-Solver++ multistep samplers for the PyTorch port.

Counterpart of `prompt_diffusion_tpu/schedulers/dpm_solver.py`: log-SNR
knot tables computed once on the host, multistep orders 1-3 for data
prediction ("dpmsolver++", `predict_x0=True`) and noise prediction
("dpmsolver"), with the reference's warm-up (the order ramps 1, 2, 3 over
the first updates) and `lower_order_final` (the order capped to the
updates left when S < 15); `dpm_solver_pp_2m_loop` is the fast path of the
common 2M case.

    lambda = ln(alpha / sigma),  h = lambda_t - lambda_s,  r_k = h_k / h
    D1_0 = (m_0 - m_1) / r_0,  D1_1 = (m_1 - m_2) / r_1
    D1 = D1_0 + r_0 / (r_0 + r_1) (D1_0 - D1_1),  D2 = (D1_0 - D1_1) / (r_0 + r_1)

The JAX `lax.switch` over the orders becomes a branch on the host's order
schedule, so only the selected update is computed. The per-step scalars
are fp32 numpy, as JAX computes them in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from prompt_diffusion_tpu_torch.schedulers.ddim import timestep_batch
from prompt_diffusion_tpu_torch.schedulers.schedules import DiffusionSchedule

_F = np.float32
# the least knot spacing, as in JAX (where the clamp keeps the unselected
# branches finite; here it only guards the selected ones)
_TINY = _F(1e-12)


@dataclasses.dataclass(frozen=True)
class DPMTables:
    """timesteps (S,) int32, descending; alpha, sigma, lam (S+1,) fp32:
    entry i is the state after i updates, entry 0 the start."""

    timesteps: np.ndarray
    alpha: np.ndarray
    sigma: np.ndarray
    lam: np.ndarray

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])

    @classmethod
    def create(cls, schedule: DiffusionSchedule, num_steps: int) -> "DPMTables":
        T = schedule.num_timesteps
        acp = np.asarray(schedule.alphas_cumprod, np.float64)
        # uniform-in-t grid from T-1 down to 0 (S+1 knots)
        ts = np.linspace(T - 1, 0, num_steps + 1).round().astype(np.int64)
        alpha = np.sqrt(acp[ts])
        sigma = np.sqrt(1.0 - acp[ts])
        f32 = lambda a: np.asarray(a, dtype=np.float32)
        return cls(timesteps=ts[:-1].astype(np.int32), alpha=f32(alpha), sigma=f32(sigma),
                   lam=f32(np.log(alpha / sigma)))


def _order_schedule(num_steps: int, order: int, lower_order_final: bool) -> np.ndarray:
    """The order of each update: updates 1..order-1 warm up at their index;
    afterwards `order`, capped to the updates left when lower_order_final
    and S < 15."""
    orders = []
    for j in range(1, num_steps + 1):  # update j lands on knot j
        o = min(order, j)
        if lower_order_final and num_steps < 15:
            o = min(o, num_steps + 1 - j)
        orders.append(o)
    return np.asarray(orders, np.int32)


def dpm_solver_multistep_loop(eps_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                              x_T: torch.Tensor, tables: DPMTables, order: int = 2,
                              predict_x0: bool = True,
                              lower_order_final: bool = True) -> torch.Tensor:
    """Multistep DPM-Solver(++), orders 1-3: `predict_x0=True` is
    "dpmsolver++" (data prediction), False "dpmsolver" (noise prediction)."""
    if order not in (1, 2, 3):
        raise ValueError(f"order must be 1, 2 or 3, got {order}")
    orders = _order_schedule(tables.num_steps, order, lower_order_final)
    lam = tables.lam
    x, m1, m2 = x_T, None, None  # the previous two model values, m1 newer
    for i in range(tables.num_steps):
        eps = eps_fn(x, timestep_batch(x, tables.timesteps[i]))
        a_s, s_s = tables.alpha[i], tables.sigma[i]
        a_t, s_t = tables.alpha[i + 1], tables.sigma[i + 1]
        m0 = (x - float(s_s) * eps) / float(a_s) if predict_x0 else eps
        h = lam[i + 1] - lam[i]
        o = int(orders[i])
        if o >= 2:
            h0 = max(lam[i] - lam[max(i - 1, 0)], _TINY)
            r0 = h0 / h
            d1_0 = (m0 - m1) / float(r0)
        if o == 3:
            h1 = max(lam[max(i - 1, 0)] - lam[max(i - 2, 0)], _TINY)
            r1 = h1 / h
            d1_1 = (m1 - m2) / float(r1)
            d1 = d1_0 + float(r0 / (r0 + r1)) * (d1_0 - d1_1)
            d2 = (d1_0 - d1_1) / float(r0 + r1)
        if predict_x0:
            phi1 = np.expm1(-h)
            x_next = float(s_t / s_s) * x - float(a_t * phi1) * m0
            if o == 2:
                x_next = x_next - float(_F(0.5) * a_t * phi1) * d1_0
            elif o == 3:
                x_next = (x_next + float(a_t * (phi1 / h + _F(1.0))) * d1
                          - float(a_t * ((phi1 + h) / (h * h) - _F(0.5))) * d2)
        else:
            phi1 = np.expm1(h)
            x_next = float(a_t / a_s) * x - float(s_t * phi1) * m0
            if o == 2:
                x_next = x_next - float(_F(0.5) * s_t * phi1) * d1_0
            elif o == 3:
                x_next = (x_next - float(s_t * (phi1 / h - _F(1.0))) * d1
                          - float(s_t * ((phi1 - h) / (h * h) - _F(0.5))) * d2)
        x, m1, m2 = x_next, m0, m1
    return x


def dpm_solver_pp_2m_loop(eps_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                          x_T: torch.Tensor, tables: DPMTables) -> torch.Tensor:
    """DPM-Solver++(2M): the first update is first order, the last too when
    S < 15 (lower_order_final)."""
    S = tables.num_steps
    lam = tables.lam
    x, x0_prev = x_T, None
    for i in range(S):
        eps = eps_fn(x, timestep_batch(x, tables.timesteps[i]))
        a_s, s_s, l_s = tables.alpha[i], tables.sigma[i], lam[i]
        a_t, s_t, l_t = tables.alpha[i + 1], tables.sigma[i + 1], lam[i + 1]
        x0 = (x - float(s_s) * eps) / float(a_s)
        h = l_t - l_s
        d = x0
        if i > 0 and not (S < 15 and i == S - 1):
            r = max(l_s - lam[max(i - 1, 0)], _TINY) / h
            c = _F(1.0) / (_F(2.0) * r)
            d = float(_F(1.0) + c) * x0 - float(c) * x0_prev
        x = float(s_t / s_s) * x - float(a_t * np.expm1(-h)) * d
        x0_prev = x0
    return x
