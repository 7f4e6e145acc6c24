"""Flow-matching Euler sampler (SD3 inference path).

Counterpart of `prompt_diffusion_tpu/schedulers/flow_match.py` (diffusers'
FlowMatchEulerDiscreteScheduler): shift-resolved sigmas, linear from 1 to
1/T, sigma' = s * sigma / (1 + (s - 1) * sigma), timestep = sigma' * T, and
the Euler step x + (sigma_next - sigma) * v. The tables are the JAX
package's float64 numpy arithmetic, taken to fp32 where the loop uses them.
Training uses `FlowMatchSchedule` (the sigma table over the training
timesteps, `add_noise`) and `logit_normal_timestep_density`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FlowMatchSchedule:
    """Training-time sigma table over T = num_train_timesteps levels:
    sigmas (T,) fp32 descending from 1 to 1/T after the shift, timesteps =
    sigmas * T."""

    sigmas: torch.Tensor
    timesteps: torch.Tensor
    num_train_timesteps: int
    shift: float

    @classmethod
    def create(cls, num_train_timesteps: int = 1000, shift: float = 3.0,
               device: torch.device | str = "cpu") -> "FlowMatchSchedule":
        ts = np.linspace(1, num_train_timesteps, num_train_timesteps, dtype=np.float64)[::-1]
        sigmas = ts / num_train_timesteps
        sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
        as32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
        return cls(as32(sigmas), as32(sigmas * num_train_timesteps), num_train_timesteps, shift)

    def sigma_for_timestep_index(self, idx: torch.Tensor) -> torch.Tensor:
        return self.sigmas[idx]

    def add_noise(self, x0: torch.Tensor, sigma: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """x_sigma = (1 - sigma) * x0 + sigma * noise, sigma broadcast over
        x0's trailing axes (train_promptdiffusion_sd3.py:1217)."""
        s = sigma.reshape(sigma.shape + (1,) * (x0.ndim - sigma.ndim)).to(x0.dtype)
        return (1.0 - s) * x0 + s * noise


def logit_normal_timestep_density(batch: int, logit_mean: float = 0.0, logit_std: float = 1.0,
                                  generator: Optional[torch.Generator] = None,
                                  normals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Logit-normal u in (0, 1) for training-timestep sampling (diffusers'
    compute_density_for_timestep_sampling, train_promptdiffusion_sd3.py:
    1207-1215): sigmoid(n * std + mean) of `batch` standard normals, given
    or drawn in fp32 from `generator` on its device."""
    if normals is None:
        normals = torch.randn((batch,), generator=generator, device=generator.device)
    return torch.sigmoid(normals.float() * logit_std + logit_mean)


def make_inference_sigmas(num_inference_steps: int, num_train_timesteps: int = 1000,
                          shift: float = 3.0) -> Tuple[np.ndarray, np.ndarray]:
    """(timesteps (S,), sigmas (S + 1,)) float64 for an S-step flow-match
    Euler run; sigmas end with 0 so step i goes sigmas[i] -> sigmas[i + 1]."""
    ts = np.linspace(1.0, num_train_timesteps, num_inference_steps, dtype=np.float64)[::-1]
    sigmas = ts / num_train_timesteps
    sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
    timesteps = sigmas * num_train_timesteps
    return timesteps, np.concatenate([sigmas, [0.0]])


def flow_match_step(x: torch.Tensor, v: torch.Tensor, sigma, sigma_next) -> torch.Tensor:
    """Euler: x + (sigma_next - sigma) * v, the difference taken in fp32."""
    return x + float(np.float32(sigma_next) - np.float32(sigma)) * v


def flow_match_sample_loop(velocity_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                           x_T: torch.Tensor, num_inference_steps: int,
                           num_train_timesteps: int = 1000, shift: float = 3.0) -> torch.Tensor:
    """The whole Euler loop; `velocity_fn(x, t_b)` takes the (B,) fp32
    timesteps."""
    timesteps, sigmas = make_inference_sigmas(num_inference_steps, num_train_timesteps, shift)
    x = x_T
    for i in range(num_inference_steps):
        t_b = torch.full((x.shape[0],), float(np.float32(timesteps[i])), dtype=torch.float32,
                         device=x.device)
        x = flow_match_step(x, velocity_fn(x, t_b), sigmas[i], sigmas[i + 1])
    return x
