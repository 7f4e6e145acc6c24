"""PLMS (pseudo linear multistep) sampler for the PyTorch port.

Counterpart of `prompt_diffusion_tpu/schedulers/plms.py`: Adams-Bashforth
multistep over the deterministic DDIM update, on the DDIM tables walked in
reverse (index = S - 1 - i),
    e' = (e_t + e(x', t_next)) / 2          (step 0: a Runge-Kutta-style
                                             corrector through x', two
                                             epsilon evaluations)
    e' = (3 e_t - e_1) / 2                  (1 epsilon of history)
    e' = (23 e_t - 16 e_1 + 5 e_2) / 12     (2)
    e' = (55 e_t - 59 e_1 + 37 e_2 - 9 e_3) / 24
where the history count is the number of epsilons kept (1 after step 0,
the reference's `len(old_eps)`), not one less.
"""

from __future__ import annotations

from typing import Callable

import torch

from prompt_diffusion_tpu_torch.schedulers.ddim import DDIMTables, ddim_step, timestep_batch


def plms_sample_loop(eps_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                     x_T: torch.Tensor, tables: DDIMTables) -> torch.Tensor:
    """The full PLMS loop (eta is 0 by construction)."""
    S = tables.num_steps
    x = x_T
    hist = []  # the last epsilons, newest first (at most 3)
    for i in range(S):
        index = S - 1 - i
        e_t = eps_fn(x, timestep_batch(x, tables.timesteps[index]))
        if not hist:
            x_prev_1, _ = ddim_step(x, e_t, index, tables)
            t_next = tables.timesteps[max(index - 1, 0)]
            e_prime = (e_t + eps_fn(x_prev_1, timestep_batch(x, t_next))) / 2
        elif len(hist) == 1:
            e_prime = (3 * e_t - hist[0]) / 2
        elif len(hist) == 2:
            e_prime = (23 * e_t - 16 * hist[0] + 5 * hist[1]) / 12
        else:
            e_prime = (55 * e_t - 59 * hist[0] + 37 * hist[1] - 9 * hist[2]) / 24
        x, _ = ddim_step(x, e_prime, index, tables)
        hist = [e_t] + hist[:2]
    return x
