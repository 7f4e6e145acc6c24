"""Mean SSIM over image batches (7×7 uniform window, standard constants).

A copy of `prompt_diffusion_tpu/evaluation/ssim.py`, so that the port
imports nothing of the JAX package: the int8 quality protocol
(`tools/int8_quality.py`) and its JAX counterpart take the same function.
Host-side numpy/scipy: it runs on a handful of decoded images, never in the
hot path.
"""

from __future__ import annotations

import numpy as np

_C1, _C2 = 0.01 ** 2, 0.03 ** 2


def batch_ssim(a, b) -> np.ndarray:
    """Per-image mean SSIM between two batches of (H, W, C) float images
    in [0, 1]. Returns shape (N,)."""
    from scipy.ndimage import uniform_filter

    out = []
    for x, y in zip(a, b):
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        mx = uniform_filter(x, size=(7, 7, 1))
        my = uniform_filter(y, size=(7, 7, 1))
        vx = uniform_filter(x * x, size=(7, 7, 1)) - mx * mx
        vy = uniform_filter(y * y, size=(7, 7, 1)) - my * my
        cxy = uniform_filter(x * y, size=(7, 7, 1)) - mx * my
        s = ((2 * mx * my + _C1) * (2 * cxy + _C2)) / (
            (mx * mx + my * my + _C1) * (vx + vy + _C2))
        out.append(float(s.mean()))
    return np.asarray(out)
