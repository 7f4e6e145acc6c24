"""Exponential moving average of the trainable parameters, in fp32.

Counterpart of `prompt_diffusion_tpu/training/ema.py` (the reference's
`LitEma`, ldm/modules/ema.py:5-80): decay 0.9999 with the update-count
warmup decay_n = min(decay, (1 + n) / (10 + n)), taken over the fp32 master
weights. Under gradient accumulation the average moves once per optimizer
step, when the weights change (`update_every`).
"""

from __future__ import annotations

from typing import Sequence

import torch


class EMA:
    """fp32 copies of `params` (never aliases), and the update count;
    `copy=False` keeps the fp32 tensors `params` themselves as the average
    (buffers the caller owns, as `TrainState`'s flat EMA chunk)."""

    def __init__(self, params: Sequence[torch.Tensor], copy: bool = True):
        self.params = [p.detach().float().clone() if copy else p for p in params]
        self.count = 0

    @torch.no_grad()
    def update(self, new_params: Sequence[torch.Tensor], decay: float = 0.9999) -> None:
        """e <- e - (1 - d) * (e - p), d = min(decay, (1 + n) / (10 + n))
        with n the count after this update."""
        self.count += 1
        d = min(decay, (1.0 + self.count) / (10.0 + self.count))
        for e, p in zip(self.params, new_params):
            e.sub_((e - p.float()) * (1.0 - d))

    def update_every(self, new_params: Sequence[torch.Tensor], decay: float, step: int,
                     every: int) -> None:
        """The update at micro-step `step` (counted from 0) of a run that
        steps the optimizer every `every` micro-steps: only on the step
        that ends an accumulation, so the count advances once per
        optimizer step."""
        if every <= 1 or (step + 1) % every == 0:
            self.update(new_params, decay)
