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
