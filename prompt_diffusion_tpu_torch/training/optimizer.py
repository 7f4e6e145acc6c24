"""Training state and optimizer shared by the SD1.5 and SD3 trainers.

The JAX package trains with `optax.chain(clip_by_global_norm(max),
adamw(lr, weight_decay))`, wrapped in `optax.MultiSteps` when gradients
accumulate, over fp32 parameters cast to the compute dtype before each
matmul. The port's modules hold their compute weights already cast (bf16
under the default policy), so `TrainState` keeps an fp32 master of every
trainable tensor (the tensor itself where it is fp32 already, as the norm
affines are) and writes each update back into the module in its dtype.
The gradient of a bf16 weight is what JAX gets through its cast; it is
taken to fp32 before anything sums it.

`AdamW.apply` is optax's arithmetic in its order: the micro-steps'
running mean (`MultiSteps`, emitting every k-th call), the clip
g * max / ||g|| where ||g|| >= max, then Adam's bias-corrected moments
(b1 0.9, b2 0.999, eps 1e-8 outside the square root), the decoupled weight
decay on every tensor and the step at the schedule's rate for the count of
updates before this one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from prompt_diffusion_tpu_torch.training.ema import EMA


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element, fp32 (`optax.global_norm`)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


@dataclasses.dataclass(frozen=True)
class AdamW:
    """clip_by_global_norm(max_grad_norm) then AdamW at `schedule(count)`,
    applied once every `accum_steps` calls to the mean of their gradients."""

    schedule: Callable[[int], float]
    weight_decay: float
    max_grad_norm: float
    accum_steps: int = 1
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    @torch.no_grad()
    def apply(self, state: "TrainState", grads: List[torch.Tensor]) -> bool:
        """One micro-step's fp32 gradients into `state`; True where the
        weights were updated (every `accum_steps`-th call)."""
        if self.accum_steps > 1:
            n = state.mini_step
            torch._foreach_add_(state.acc, torch._foreach_div(
                torch._foreach_sub(grads, state.acc), float(n + 1)))
            state.mini_step = (n + 1) % self.accum_steps
            if state.mini_step:
                return False
            grads = [a.clone() for a in state.acc]
            torch._foreach_zero_(state.acc)
        norm = global_norm(grads)
        clip = torch.where(norm < self.max_grad_norm, torch.ones_like(norm),
                           self.max_grad_norm / norm)
        torch._foreach_mul_(grads, clip)
        lr = self.schedule(state.count)
        state.count += 1
        torch._foreach_mul_(state.mu, self.b1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(state.nu, self.b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_div(state.nu, 1.0 - self.b2 ** state.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(state.mu, 1.0 - self.b1 ** state.count)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, state.master, alpha=self.weight_decay)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(state.master, upd)
        state.sync_params()
        return True


class TrainState:
    """Everything a training run carries between steps: the micro-step
    count `step`, the seed its draws come from, the trainable tensors of
    the modules by name, their fp32 masters, Adam's moments and update
    count, the accumulation buffers and position, and the EMA."""

    def __init__(self, named: Dict[str, nn.Parameter], accum_steps: int = 1,
                 use_ema: bool = False, seed: int = 0):
        self.names = list(named)
        self.params = list(named.values())
        for p in self.params:
            p.requires_grad_(True)
        self.master = [p.detach() if p.dtype == torch.float32 else p.detach().float().clone()
                       for p in self.params]
        self.mu = [torch.zeros_like(m) for m in self.master]
        self.nu = [torch.zeros_like(m) for m in self.master]
        self.acc = [torch.zeros_like(m) for m in self.master] if accum_steps > 1 else []
        self.ema: Optional[EMA] = EMA(self.master) if use_ema else None
        self.step = self.count = self.mini_step = 0
        self.seed = seed

    @torch.no_grad()
    def sync_params(self) -> None:
        """Writes the masters into the modules' tensors, in their dtypes."""
        for p, m in zip(self.params, self.master):
            if p.data_ptr() != m.data_ptr():
                p.copy_(m)

    def take_grads(self) -> List[torch.Tensor]:
        """The modules' gradients in fp32 (zeros where none arrived), then
        cleared."""
        grads = []
        for p, m in zip(self.params, self.master):
            grads.append(torch.zeros_like(m) if p.grad is None else p.grad.float())
            p.grad = None
        return grads

    def tensors(self) -> Dict[str, torch.Tensor]:
        """{kind/name: tensor} of the state's tensors, for a checkpoint."""
        kinds = {"master": self.master, "mu": self.mu, "nu": self.nu, "acc": self.acc,
                 "ema": self.ema.params if self.ema is not None else []}
        return {f"{kind}/{n}": t for kind, ts in kinds.items() for n, t in zip(self.names, ts)}

    def meta(self) -> dict:
        return {"step": self.step, "seed": self.seed, "count": self.count,
                "mini_step": self.mini_step, "names": self.names,
                "ema_count": self.ema.count if self.ema is not None else None}

    @torch.no_grad()
    def load(self, tensors: Dict[str, torch.Tensor], meta: dict) -> None:
        """Takes a checkpoint's tensors and counters into this state (which
        must have the same names and options) and the modules' tensors."""
        if meta["names"] != self.names:
            raise ValueError("the checkpoint holds other trainable tensors than this run")
        mine = self.tensors()
        if set(tensors) != set(mine):
            raise ValueError(f"checkpoint tensors differ: {sorted(set(tensors) ^ set(mine))[:4]}")
        for key, t in mine.items():
            t.copy_(tensors[key])
        self.step, self.seed = meta["step"], meta["seed"]
        self.count, self.mini_step = meta["count"], meta["mini_step"]
        if self.ema is not None:
            self.ema.count = meta["ema_count"]
        self.sync_params()


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of micro-step `step`'s draws, seeded from (seed, step)
    alone (the counterpart of `jax.random.fold_in(key, step)`), so a
    resumed run draws what the uninterrupted one would."""
    import numpy as np

    s = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]) >> 1
    return torch.Generator(device=device).manual_seed(s)


def finish_step(state: TrainState, opt: AdamW, ema_decay: float) -> torch.Tensor:
    """After `loss.backward()`: the optimizer and the EMA on this
    micro-step's gradients, the step count advanced. Returns the
    micro-step gradient's global norm before clipping."""
    grads = state.take_grads()
    norm = global_norm(grads)
    opt.apply(state, grads)
    if state.ema is not None:
        state.ema.update_every(state.master, ema_decay, state.step, opt.accum_steps)
    state.step += 1
    return norm
