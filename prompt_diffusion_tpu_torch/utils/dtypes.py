"""Dtype policy and random initialisation for the PyTorch port.

Counterpart of `prompt_diffusion_tpu/utils/dtypes.py`. The JAX models keep
fp32 parameters and cast them to the compute dtype right before each
matmul/conv (Flax `dtype=` with `param_dtype=float32`). The port stores the
compute weights already cast (bf16 under the default policy) and keeps norm
affines in fp32, which gives the same numbers without a cast per call.
Training keeps what the cast would lose: the trainer holds an fp32 master
of every trainable tensor (`training/optimizer.py::TrainState`; the
tensor itself where it is fp32), updates the master, and writes it back
into the module in the policy's dtype after each update; a bf16 weight's
gradient is taken to fp32 before it is summed, clipped or averaged.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """Where each class of tensor lives.

    compute_dtype: dtype of conv/matmul weights and activations (a
    trainer's fp32 masters stand behind the trainable ones).
    Attention logits and softmax, normalisation statistics and affines
    are always fp32.
    quant: "none" | "int8". "int8" is the W8A8 serving mode
    (`ops/quant.py`): the hot convs and denses keep fp32 weights, quantize
    them per output channel once and multiply int8 by int8 into int32.
    Inference only.
    """

    compute_dtype: torch.dtype = torch.bfloat16
    quant: str = "none"


def default_policy() -> DTypePolicy:
    return DTypePolicy()


def int8_policy() -> DTypePolicy:
    """bf16 activations with int8 W8A8 convs and denses (the serving
    default of the JAX package); attention, norms and the layers that run
    once per request stay bf16/fp32."""
    return DTypePolicy(quant="int8")


def fp32_policy() -> DTypePolicy:
    """Full fp32: used by the tests for golden comparisons."""
    return DTypePolicy(compute_dtype=torch.float32)


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator,
                 std: float = 0.02) -> nn.Module:
    """Fill every parameter in place, like `fast_random_params_bf16`:
    N(0, std) for tensors of 2 or more dimensions (zero-initialised convs
    included, so the ControlNet taps carry signal), zeros for biases and
    ones for the other 1-D tensors (norm scales). Values are drawn in fp32
    on the generator's device, then cast to each parameter's dtype."""
    for name, p in module.named_parameters():
        if p.ndim >= 2:
            v = torch.randn(p.shape, generator=generator,
                            device=generator.device, dtype=torch.float32) * std
            p.copy_(v)
        elif name.rsplit(".", 1)[-1] == "bias":
            p.zero_()
        else:
            p.fill_(1.0)
    return module
