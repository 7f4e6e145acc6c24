"""The tensor-core work of a model's forward pass, counted from the shapes
on the meta device: PyTorch's `FlopCounterMode` over the plain reference
(every matrix product, convolution and attention product, 2 operations a
multiply-add), with the linears and convolutions that the port's int8
policy quantizes counted apart."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from pdbench.reference.common import Conv, Linear


def _ops(module, out: torch.Tensor) -> float:
    w = module.weight
    if isinstance(module, Linear):
        return 2.0 * out.numel() * w.shape[1]
    return 2.0 * out.numel() * w.shape[1] * w.shape[2] * w.shape[3]


def count(cls, cfg: dict, int8: bool, forward) -> dict:
    """{"int8_ops", "bf16_ops"} of `forward(model)` for the reference
    model `cls(cfg)` built on the meta device; with `int8` the quantized
    sites' linears and convolutions are the int8 part."""
    with torch.device("meta"):
        model = cls(cfg)
    sites = [0.0]

    def hook(module, args, out):
        if module.site:
            sites[0] += _ops(module, out)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (Linear, Conv))]
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            forward(model)
    finally:
        for h in handles:
            h.remove()
    total = float(counter.get_total_flops())
    site = sites[0] if int8 else 0.0
    return {"int8_ops": site, "bf16_ops": total - site}
