"""Batched Canny edge detection as plain tensor ops.

Counterpart of `prompt_diffusion_tpu/annotators/canny.py::canny`: optional
5x5 Gaussian, Sobel gradients, non-maximum suppression over four quantized
directions, double threshold, and hysteresis by a fixed number of 3x3
dilations. Every step is an elementwise op, a small convolution or a roll
over the whole batch; there is no kernel of its own.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_GAUSS5 = np.outer([1, 4, 6, 4, 1], [1, 4, 6, 4, 1]).astype(np.float32) / 256.0
_SOBEL_X = np.asarray([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
_SOBEL_Y = np.asarray([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], np.float32)


def _filter(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """(B, H, W) cross-correlated with `kernel`, zero "SAME" padding."""
    k = torch.from_numpy(kernel).to(x.device)[None, None]
    return F.conv2d(x[:, None], k, padding=kernel.shape[0] // 2)[:, 0]


@torch.no_grad()
def canny(images: torch.Tensor, low: float = 100.0, high: float = 200.0,
          hysteresis_iters: int = 16, l2_gradient: bool = False,
          blur: bool = False) -> torch.Tensor:
    """(B, H, W) or (B, H, W, 3) RGB in [0, 255] -> (B, H, W) float32 edge
    maps in {0, 255}. L1 gradient norm unless `l2_gradient`; `blur` adds
    the 5x5 Gaussian that cv2.Canny does not apply."""
    x = images.float()
    if x.ndim == 4:
        x = x @ torch.tensor([0.299, 0.587, 0.114], device=x.device)
    if blur:
        x = _filter(x, _GAUSS5)
    gx, gy = _filter(x, _SOBEL_X), _filter(x, _SOBEL_Y)
    mag = torch.sqrt(gx ** 2 + gy ** 2) if l2_gradient else gx.abs() + gy.abs()

    # non-maximum suppression along the direction quantized to 0/45/90/135
    deg = torch.remainder(torch.rad2deg(torch.atan2(gy, gx)), 180.0)
    sector = ((deg >= 22.5) & (deg < 67.5)) * 1 + ((deg >= 67.5) & (deg < 112.5)) * 2 \
        + ((deg >= 112.5) & (deg < 157.5)) * 3
    shift = lambda dy, dx: torch.roll(mag, (dy, dx), dims=(1, 2))
    pairs = ((shift(0, 1), shift(0, -1)), (shift(1, -1), shift(-1, 1)),
             (shift(1, 0), shift(-1, 0)), (shift(1, 1), shift(-1, -1)))
    na, nb = torch.zeros_like(mag), torch.zeros_like(mag)
    for s, (a, b) in enumerate(pairs):
        na = torch.where(sector == s, a, na)
        nb = torch.where(sector == s, b, nb)
    # strict > on one side breaks plateau ties (one-pixel edges, as cv2)
    mag = torch.where((mag > na) & (mag >= nb), mag, torch.zeros_like(mag))

    strong = mag >= high
    weak = (mag >= low) & ~strong
    edges = strong
    for _ in range(hysteresis_iters):
        grown = F.max_pool2d(edges.float()[:, None], 3, stride=1, padding=1)[:, 0] > 0
        edges = edges | (grown & weak)
    return edges.float() * 255.0
