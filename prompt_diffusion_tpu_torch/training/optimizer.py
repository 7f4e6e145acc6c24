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

Each kind (master, mu, nu, acc, EMA) is one flat fp32 buffer over the
trainable tensors (`parallel/mesh.py::FlatLayout`), and `master`, `mu`,
... are the views of the pieces of the tensors that lie in it. With a
`mesh` the state is ZeRO-sharded: a rank holds one chunk of each buffer,
`take_grads` reduce-scatters the gradient into the same pieces,
`global_norm` adds the chunks' squares over the mesh and `sync_params`
all-gathers the masters into the modules. `mesh=None` is one device, the
group of one rank that exchanges nothing, and its chunk is the whole
buffer. `AdamW.apply` and the EMA run unchanged on the pieces.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from prompt_diffusion_tpu_torch.parallel.mesh import (
    FlatLayout,
    fsdp_size,
    gather_fsdp,
    reduce_gradient,
    sum_over_ranks,
)
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
        norm = state.global_norm(grads)
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
    count, the accumulation buffers and position, and the EMA: this rank's
    chunk of each (the whole of each without a mesh; see the module's
    docstring)."""

    def __init__(self, named: Dict[str, nn.Parameter], accum_steps: int = 1,
                 use_ema: bool = False, seed: int = 0, mesh=None):
        self.names = list(named)
        self.params = list(named.values())
        self.mesh = mesh
        for p in self.params:
            p.requires_grad_(True)
        self.step = self.count = self.mini_step = 0
        self.seed = seed
        self.layout = FlatLayout([p.shape for p in self.params], fsdp_size(mesh),
                                 0 if mesh is None else mesh.get_local_rank("fsdp"))
        lo = self.layout.lo
        full = self.layout.pack([p.detach() for p in self.params], self.params[0].device)
        master = full[lo:lo + self.layout.chunk].clone()
        del full
        # this rank's chunk of each kind; the lists below are views of them
        self.flat = {"master": master, "mu": torch.zeros_like(master),
                     "nu": torch.zeros_like(master)}
        if accum_steps > 1:
            self.flat["acc"] = torch.zeros_like(master)
        if use_ema:
            self.flat["ema"] = master.clone()
        views = lambda kind: self.layout.views(self.flat[kind]) if kind in self.flat else []
        self.master, self.mu, self.nu, self.acc = (views(k) for k in ("master", "mu", "nu", "acc"))
        self.ema: Optional[EMA] = EMA(views("ema"), copy=False) if use_ema else None

    @torch.no_grad()
    def sync_params(self) -> None:
        """Writes the masters, all-gathered, into the modules' tensors in
        their dtypes."""
        full = gather_fsdp(self.flat["master"], self.mesh)
        for p, m in zip(self.params, self.layout.unpack(full)):
            p.copy_(m)

    def take_grads(self) -> List[torch.Tensor]:
        """This rank's pieces of the modules' fp32 gradients (zeros where
        none arrived), averaged over the ranks; the modules' are cleared."""
        flat = torch.zeros(self.layout.total, dtype=torch.float32,
                           device=self.flat["master"].device)
        for p, seg in zip(self.params, self.layout.unpack(flat)):
            if p.grad is not None:
                seg.copy_(p.grad)
            p.grad = None
        return self.layout.views(reduce_gradient(flat, self.mesh))

    def global_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global norm of gradients in the masters' layout, over every
        rank's pieces."""
        local = global_norm(grads) if grads else torch.zeros((), device=self.flat["master"].device)
        if fsdp_size(self.mesh) == 1:
            return local
        return torch.sqrt(sum_over_ranks(local * local, self.mesh, "fsdp"))

    def tensors(self) -> Dict[str, torch.Tensor]:
        """{kind/name: tensor} of the state's tensors, for a checkpoint: the
        whole tensors, all-gathered (every rank must call)."""
        out = {}
        for kind, chunk in self.flat.items():
            full = gather_fsdp(chunk, self.mesh)
            out.update({f"{kind}/{n}": t for n, t in zip(self.names, self.layout.unpack(full))})
        return out

    def local_bytes(self) -> int:
        """The bytes this rank holds of the state (fp32 masters, moments,
        accumulation and EMA; the modules' own tensors not counted)."""
        return sum(t.numel() * t.element_size() for t in self.flat.values())

    def meta(self) -> dict:
        return {"step": self.step, "seed": self.seed, "count": self.count,
                "mini_step": self.mini_step, "names": self.names,
                "ema_count": self.ema.count if self.ema is not None else None}

    @torch.no_grad()
    def load(self, tensors: Dict[str, torch.Tensor], meta: dict) -> None:
        """Takes this rank's pieces of a checkpoint's whole tensors, and its
        counters, into this state (which must have the same names and
        options) and the modules' tensors."""
        if meta["names"] != self.names:
            raise ValueError("the checkpoint holds other trainable tensors than this run")
        mine = {f"{kind}/{n}" for kind in self.flat for n in self.names}
        if set(tensors) != mine:
            raise ValueError(f"checkpoint tensors differ: {sorted(set(tensors) ^ mine)[:4]}")
        for kind, chunk in self.flat.items():
            for (i, a, b), t in zip(self.layout.pieces, self.layout.views(chunk)):
                t.view(-1).copy_(tensors[f"{kind}/{self.names[i]}"].reshape(-1)[a:b])
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
    norm = state.global_norm(grads)
    opt.apply(state, grads)
    if state.ema is not None:
        state.ema.update_every(state.master, ema_decay, state.step, opt.accum_steps)
    state.step += 1
    return norm
