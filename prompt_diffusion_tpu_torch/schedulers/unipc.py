"""UniPC (unified predictor-corrector) sampler for the PyTorch port.

Counterpart of `prompt_diffusion_tpu/schedulers/unipc.py`: solver order 2,
solver type "bh2", data prediction from an epsilon model,
`lower_order_final`, on diffusers' "linspace" timestep spacing. In log-SNR
space (alpha_t = sqrt(acp_t), sigma_t = sqrt(1 - acp_t),
lambda = ln(alpha / sigma), h = lambda_next - lambda_cur):
    predictor (order 2): x_next = (sn/sc) x - an phi1 m0 - an B_h (D1 / 2)
    corrector (order 2): solve R rho = b over the history differences
with phi1 = expm1(-h) and B_h = phi1 (bh2).

The JAX `lax.scan` becomes a Python loop, and its `jnp.where` order
selects become branches on the tables' integer orders, so the branch a
step does not take is never computed (in JAX it is, and the `r1 == 0`
guards keep it finite at step 0, where the carry starts at lambda 0). The
per-step scalars are fp32 numpy, as JAX computes them in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from prompt_diffusion_tpu_torch.schedulers.ddim import timestep_batch
from prompt_diffusion_tpu_torch.schedulers.schedules import DiffusionSchedule

_F = np.float32


@dataclasses.dataclass(frozen=True)
class UniPCTables:
    """Per-step tables, length S (fp32 numpy; timesteps and orders int32).
    *_next holds the target of step i (entry S-1 targets DDPM t=0);
    corr_order 0 skips the corrector."""

    timesteps: np.ndarray
    alpha_cur: np.ndarray
    sigma_cur: np.ndarray
    lambda_cur: np.ndarray
    alpha_next: np.ndarray
    sigma_next: np.ndarray
    lambda_next: np.ndarray
    pred_order: np.ndarray
    corr_order: np.ndarray

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])

    @classmethod
    def create(cls, schedule: DiffusionSchedule, num_steps: int, order: int = 2) -> "UniPCTables":
        T = schedule.num_timesteps
        acp = np.asarray(schedule.alphas_cumprod, dtype=np.float64)
        # diffusers "linspace" spacing: S+1 points 0..T-1, reversed, drop last
        ts = np.linspace(0, T - 1, num_steps + 1).round()[::-1][:-1].astype(np.int64)
        t_next = np.concatenate([ts[1:], [0]])

        def tables(t_idx):
            a = np.sqrt(acp[t_idx])
            s = np.sqrt(1.0 - acp[t_idx])
            return a, s, np.log(a / s)

        a_c, s_c, l_c = tables(ts)
        a_n, s_n, l_n = tables(t_next)
        idx = np.arange(num_steps)
        # warm-up (lower_order_nums) and lower_order_final
        pred_order = np.minimum(np.minimum(order, idx + 1), num_steps - idx)
        corr_order = np.concatenate([[0], pred_order[:-1]])  # no corrector at step 0
        f32 = lambda a: np.asarray(a, dtype=np.float32)
        return cls(
            timesteps=ts.astype(np.int32),
            alpha_cur=f32(a_c), sigma_cur=f32(s_c), lambda_cur=f32(l_c),
            alpha_next=f32(a_n), sigma_next=f32(s_n), lambda_next=f32(l_n),
            pred_order=pred_order.astype(np.int32),
            corr_order=corr_order.astype(np.int32),
        )


def _bh2_coeffs(hh):
    phi1 = np.expm1(hh)
    phi2 = phi1 / hh - _F(1.0)
    phi3 = phi2 / hh - _F(0.5)
    return phi1, phi2, phi3, phi1  # B_h = phi1 (bh2)


def _sigma_of_lambda(lmbda):
    """sigma from lambda: 1 / sqrt(1 + e^(2 lambda)) (alpha^2 + sigma^2 = 1)."""
    return _F(1.0) / np.sqrt(_F(1.0) + np.exp(_F(2.0) * lmbda))


def _nonzero(v):
    return v if v != 0 else _F(1.0)


def unipc_sample_loop(eps_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                      x_T: torch.Tensor, tables: UniPCTables) -> torch.Tensor:
    """The full UniPC-2 (bh2) loop. `eps_fn(x, t)` returns the
    (CFG-combined) epsilon."""
    x = x_T
    x_last = m_prev = m_prevprev = None
    l_prev = l_prevprev = _F(0.0)
    for i in range(tables.num_steps):
        eps = eps_fn(x, timestep_batch(x, tables.timesteps[i]))
        a_c, s_c, l_c = tables.alpha_cur[i], tables.sigma_cur[i], tables.lambda_cur[i]
        model_t = (x - float(s_c) * eps) / float(a_c)  # eps -> x0 (data prediction)

        # corrector: x at t again, from x_last (at the previous step)
        corr = int(tables.corr_order[i])
        if corr >= 1:
            h = l_c - l_prev
            phi1, phi2, phi3, b_h = _bh2_coeffs(-h)
            d1_t = model_t - m_prev
            base = float(s_c / _sigma_of_lambda(l_prev)) * x_last
            if corr >= 2:
                r1 = (l_prevprev - l_prev) / h
                d1_0 = (m_prevprev - m_prev) / float(_nonzero(r1))
                b1 = phi2 / b_h
                b2 = phi3 * _F(2.0) / b_h
                # solve [[1, 1], [r1, 1]] rho = [b1, b2]
                rho0 = (b1 - b2) / _nonzero(_F(1.0) - r1)
                rho1 = b1 - rho0
                x = (base - float(a_c * phi1) * m_prev
                     - float(a_c * b_h) * (float(rho0) * d1_0 + float(rho1) * d1_t))
            else:
                x = base - float(a_c * phi1) * m_prev - float(a_c * b_h) * (0.5 * d1_t)
        # model_t stays the one evaluated before the correction (as diffusers)

        # predictor: x from t to t_next
        a_n, s_n, l_n = tables.alpha_next[i], tables.sigma_next[i], tables.lambda_next[i]
        h = l_n - l_c
        phi1, _, _, b_h = _bh2_coeffs(-h)
        x_next = float(s_n / s_c) * x - float(a_n * phi1) * model_t
        if int(tables.pred_order[i]) >= 2:
            r1 = (l_prev - l_c) / h
            d1 = (m_prev - model_t) / float(_nonzero(r1))
            x_next = x_next - float(a_n * b_h) * (0.5 * d1)

        x_last, m_prevprev, m_prev = x, m_prev, model_t
        l_prevprev, l_prev = l_prev, l_c
        x = x_next
    return x
