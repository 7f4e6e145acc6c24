"""Flow-matching Euler sampler (SD3 inference path).

Counterpart of `prompt_diffusion_tpu/schedulers/flow_match.py` (diffusers'
FlowMatchEulerDiscreteScheduler): shift-resolved sigmas, linear from 1 to
1/T, sigma' = s * sigma / (1 + (s - 1) * sigma), timestep = sigma' * T, and
the Euler step x + (sigma_next - sigma) * v. The tables are the JAX
package's float64 numpy arithmetic, taken to fp32 where the loop uses them.
The training parts (`FlowMatchSchedule.add_noise`, the logit-normal
timestep density) come with the training slice.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch


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
