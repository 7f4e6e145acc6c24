"""Where each kernel wrapper sends a tensor.

A tensor on the CPU goes to the kernel's plain PyTorch version; a CUDA
tensor goes to the kernel, which launches or raises. Nothing falls back
from a failed build or launch to the plain version. `plain_ops()` sends
CUDA tensors to the plain versions too, for comparisons only.
"""

from __future__ import annotations

import contextlib

import torch

_plain_on_cuda = False


def use_kernel(x: torch.Tensor) -> bool:
    """True when `x` must go through the hand-written kernel."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel or plain version for device {x.device}")
    return not _plain_on_cuda


def recompute_grads(plain, g, inputs, needs):
    """The backward of a kernel whose plain version is `plain`: autograd of
    `plain(*inputs)` recomputed from the saved inputs for the output's
    gradient g (the counterpart of a JAX `custom_vjp` whose backward is
    `jax.vjp` of its reference); a gradient for each input, None where
    `needs` is False. `plain` is the plain function itself, never a
    dispatching wrapper, so the backward launches no kernel."""
    part = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
    with torch.enable_grad():
        got = iter(torch.autograd.grad(plain(*part), [t for t in part if t.requires_grad], g))
    return [next(got) if n else None for n in needs]


@contextlib.contextmanager
def plain_ops():
    """Run the plain PyTorch versions on CUDA tensors inside the block
    (comparisons of the kernels against their plain versions)."""
    global _plain_on_cuda
    prev, _plain_on_cuda = _plain_on_cuda, True
    try:
        yield
    finally:
        _plain_on_cuda = prev
