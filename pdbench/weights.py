"""Weights from the seed, the same for the program and the reference.

A model's parameters, taken in the order of their sorted names, draw from
one stream of N(0, 1) values made on the device by a `torch.Generator`
seeded from (seed, model tag), in bf16 (the type the weights are served
in) and in chunks of `CHUNK` values, so that a few large calls fill a
model. A tensor of two or more dimensions takes the next values of the
stream times `STD` (rounded to bf16); a bias is zero and every other 1-D
tensor (norm scales) one, as the port's `random_init_` sets them. The
reference draws the same stream for a module with the same names and
shapes, and gets the same values in fp32. A model whose published
initialisation keeps its activations in another range (T5's attention
takes no 1/sqrt(d) scale) passes its own scale per parameter.
"""

from __future__ import annotations

import torch
from torch import nn

from pdbench.seeds import sub_seed

STD = 0.02
CHUNK = 1 << 28


def plan(module: nn.Module):
    """[(name, shape)] of the parameters in the order they draw."""
    return [(n, tuple(p.shape)) for n, p in sorted(module.named_parameters())]


@torch.no_grad()
def fill_(module: nn.Module, seed: int, tag: str, device, std=None) -> nn.Module:
    """Fills `module`'s parameters from the stream of (seed, tag); `std`,
    where given, maps a parameter's name to the scale of its values in
    place of `STD`."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights", tag))
    chunk, pos = None, CHUNK
    for name, p in sorted(module.named_parameters()):
        if p.ndim < 2:
            p.fill_(0.0 if name.rsplit(".", 1)[-1] == "bias" else 1.0)
            continue
        flat, done = p.view(-1) if p.is_contiguous() else None, 0
        n = p.numel()
        parts = []
        while done < n:
            if pos == CHUNK:
                chunk = torch.randn(CHUNK, generator=gen, device=device, dtype=torch.bfloat16)
                chunk.mul_(STD)
                pos = 0
            take = min(n - done, CHUNK - pos)
            parts.append(chunk[pos:pos + take])
            pos += take
            done += take
        values = parts[0] if len(parts) == 1 else torch.cat(parts)
        scale = None if std is None else std(name)
        if scale is not None:
            values = (values.float() * (scale / STD)).bfloat16()
        if flat is not None:
            flat.copy_(values)
        else:
            p.copy_(values.view(p.shape))
    return module
