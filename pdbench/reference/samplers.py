"""The samplers' updates in plain fp32: DDIM (eta 0, uniform timesteps, the
SD linear beta schedule) and SD3's flow-match Euler with its shifted
sigmas. With `round_bf16` the update's operands and result are rounded to
bf16 (the control's stand-in for the stated fp32)."""

from __future__ import annotations

import numpy as np
import torch


def ddim_table(num_steps: int, timesteps: int = 1000, linear_start: float = 0.00085,
               linear_end: float = 0.012):
    """(DDPM timestep, alpha, alpha_prev) per DDIM index, ascending."""
    betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, timesteps, dtype=np.float64) ** 2
    acp = np.cumprod(1.0 - betas).astype(np.float32).astype(np.float64)
    c = timesteps // num_steps
    ts = np.minimum(np.arange(0, timesteps, c) + 1, timesteps - 1)
    alphas = acp[ts]
    prev = np.asarray([acp[0]] + acp[ts[:-1]].tolist())
    return ts, alphas, prev


def ddim_update(x, eps, alpha: float, alpha_prev: float, round_bf16: bool = False):
    if round_bf16:
        x, eps = x.bfloat16(), eps.bfloat16()
    x0 = (x - float(np.sqrt(1.0 - alpha)) * eps) / float(np.sqrt(alpha))
    out = float(np.sqrt(alpha_prev)) * x0 + float(np.sqrt(1.0 - alpha_prev)) * eps
    return out.float()


def flow_sigmas(num_steps: int, shift: float, timesteps: int = 1000):
    """(timesteps (S,), sigmas (S + 1,)) float64, sigmas ending with 0."""
    ts = np.linspace(1.0, timesteps, num_steps, dtype=np.float64)[::-1]
    s = ts / timesteps
    s = shift * s / (1 + (shift - 1) * s)
    return s * timesteps, np.concatenate([s, [0.0]])


def euler_update(x, v, sigma: float, sigma_next: float, round_bf16: bool = False):
    if round_bf16:
        x, v = x.bfloat16(), v.bfloat16()
    return (x + float(np.float32(sigma_next) - np.float32(sigma)) * v).float()


def cfg(pair: torch.Tensor, scale: float) -> torch.Tensor:
    """Classifier-free guidance over an (uncond || cond) double batch."""
    u, c = pair.chunk(2)
    return u + scale * (c - u)
