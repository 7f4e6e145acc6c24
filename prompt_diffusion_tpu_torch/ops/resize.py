"""Bilinear resize of NCHW activations.

Counterpart of `prompt_diffusion_tpu/ops/resize.py::resize_bilinear`. The
JAX function writes the separable interpolation as two matmuls so that the
TPU's matrix unit runs it; that is a layout choice of XLA, not a kernel,
and `F.interpolate` computes the same samples here (fp32 interpolation
weights and sums, the result in the input dtype), upsampling and
downsampling alike: both take two taps at the half-pixel (or corner-
aligned) source position, edges clamped. When downsampling neither equals
`jax.image.resize`'s antialiased linear resize (`annotators/util.py`
builds that one); UperNet's pyramid pools downsample this way below 192²
inputs, as the JAX package does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, new_h: int, new_w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, new_h, new_w), bilinear. `align_corners=True`
    is torch's corner-aligned grid (the DPT decoder's x2 upsample);
    False the half-pixel grid with clamped edges."""
    if tuple(x.shape[-2:]) == (new_h, new_w):
        return x
    return F.interpolate(x, size=(new_h, new_w), mode="bilinear", align_corners=align_corners)
