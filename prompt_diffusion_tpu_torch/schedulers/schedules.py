"""Noise schedules and diffusion-process tables, built in float64 numpy.

Counterpart of `prompt_diffusion_tpu/schedulers/schedules.py`. The
arithmetic is the same, step for step (the tables are built in float64 and
cast to fp32 once, and the DDIM tables are built from the fp32
alphas_cumprod), so the tables are bit-equal to the JAX package's. The
forward-process helpers gather from the fp32 tables on the tensor's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def make_beta_schedule(schedule: str, n_timestep: int, linear_start: float = 1e-4,
                       linear_end: float = 2e-2, cosine_s: float = 8e-3) -> np.ndarray:
    """Beta schedule, float64. "linear" is SD's sqrt-space linear ramp."""
    if schedule == "linear":
        betas = np.linspace(linear_start**0.5, linear_end**0.5, n_timestep,
                            dtype=np.float64) ** 2
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = np.clip(1 - alphas[1:] / alphas[:-1], 0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"schedule '{schedule}' unknown.")
    return betas


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """DDPM process tables (fp32 numpy, length T), named as the standard
    DDPM buffers."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    @classmethod
    def create(cls, schedule: str = "linear", timesteps: int = 1000,
               linear_start: float = 0.00085, linear_end: float = 0.0120,
               cosine_s: float = 8e-3, v_posterior: float = 0.0) -> "DiffusionSchedule":
        betas = make_beta_schedule(schedule, timesteps, linear_start, linear_end, cosine_s)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas, axis=0)
        acp_prev = np.append(1.0, acp[:-1])
        post_var = ((1 - v_posterior) * betas * (1.0 - acp_prev) / (1.0 - acp)
                    + v_posterior * betas)
        f32 = lambda a: np.asarray(a).astype(np.float32)
        return cls(
            betas=f32(betas),
            alphas_cumprod=f32(acp),
            alphas_cumprod_prev=f32(acp_prev),
            sqrt_alphas_cumprod=f32(np.sqrt(acp)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
            log_one_minus_alphas_cumprod=f32(np.log(1.0 - acp)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1)),
            posterior_variance=f32(post_var),
            posterior_log_variance_clipped=f32(np.log(np.maximum(post_var, 1e-20))),
            posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
            posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
        )

    # --- forward process and parameterization changes ---

    @staticmethod
    def _gather(table: np.ndarray, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """table[t] on t's device, shaped to broadcast over an ndim tensor."""
        out = torch.from_numpy(table).to(t.device)[t.long()]
        return out.reshape(out.shape + (1,) * (ndim - out.ndim))

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """x_t = sqrt(acp_t) * x0 + sqrt(1 - acp_t) * eps."""
        nd = x_start.ndim
        return (self._gather(self.sqrt_alphas_cumprod, t, nd) * x_start
                + self._gather(self.sqrt_one_minus_alphas_cumprod, t, nd) * noise)

    def get_v(self, x: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """v-target: v = sqrt(acp) * eps - sqrt(1 - acp) * x0."""
        nd = x.ndim
        return (self._gather(self.sqrt_alphas_cumprod, t, nd) * noise
                - self._gather(self.sqrt_one_minus_alphas_cumprod, t, nd) * x)

    def predict_start_from_z_and_v(self, x_t, t, v):
        nd = x_t.ndim
        return (self._gather(self.sqrt_alphas_cumprod, t, nd) * x_t
                - self._gather(self.sqrt_one_minus_alphas_cumprod, t, nd) * v)

    def predict_eps_from_z_and_v(self, x_t, t, v):
        nd = x_t.ndim
        return (self._gather(self.sqrt_alphas_cumprod, t, nd) * v
                + self._gather(self.sqrt_one_minus_alphas_cumprod, t, nd) * x_t)

    def predict_start_from_noise(self, x_t, t, noise):
        nd = x_t.ndim
        return (self._gather(self.sqrt_recip_alphas_cumprod, t, nd) * x_t
                - self._gather(self.sqrt_recipm1_alphas_cumprod, t, nd) * noise)


def make_ddim_timesteps(num_ddim_timesteps: int, num_ddpm_timesteps: int,
                        method: str = "uniform") -> np.ndarray:
    """DDIM sub-sequence of DDPM steps ("uniform" or "quad" spacing), with
    the reference's +1 offset clamped to the last valid timestep. The
    uniform table is longer than `num_ddim_timesteps` when that does not
    divide the DDPM count."""
    if method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        ddim_timesteps = np.asarray(list(range(0, num_ddpm_timesteps, c)))
    elif method == "quad":
        ddim_timesteps = (np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8),
                                      num_ddim_timesteps) ** 2).astype(int)
    else:
        raise NotImplementedError(f"unknown ddim discretization: {method}")
    return np.minimum(ddim_timesteps + 1, num_ddpm_timesteps - 1)


def make_ddim_tables(alphas_cumprod: np.ndarray, ddim_timesteps: np.ndarray,
                     eta: float = 0.0):
    """(sigma, alpha, alpha_prev) per DDIM step, float64."""
    acp = np.asarray(alphas_cumprod, dtype=np.float64)
    alphas = acp[ddim_timesteps]
    alphas_prev = np.asarray([acp[0]] + acp[ddim_timesteps[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev
