"""Image utilities for condition extraction.

Counterpart of `prompt_diffusion_tpu/annotators/util.py`: `hwc3` and
`resize_image` on the host (numpy in, numpy out), `batched_resize` on the
device, and the two input normalisations.

`jax.image.resize` has no PyTorch equivalent: torch has no lanczos3, and
`F.interpolate(antialias=True)` is not held to the same weights. So each
axis's weight matrix is built here in numpy as
`jax.image.scale_and_translate` defines it (float32, half-pixel centres,
the kernel stretched by the scale when downsampling with antialiasing,
each output's weights normalised, outputs whose centre lies outside the
input zeroed) and applied with two matmuls, the rows first.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_F32 = np.float32


def hwc3(x: np.ndarray) -> np.ndarray:
    """Coerce HxW / HxWx1 / HxWx3 / HxWx4 uint8 to HxWx3 (RGBA composited
    over white)."""
    if x.dtype != np.uint8:
        raise ValueError(f"hwc3 takes uint8, got {x.dtype}")
    if x.ndim == 2:
        x = x[:, :, None]
    h, w, c = x.shape
    if c not in (1, 3, 4):
        raise ValueError(f"hwc3 takes 1, 3 or 4 channels, got {c}")
    if c == 3:
        return x
    if c == 1:
        return np.concatenate([x] * 3, axis=2)
    color = x[:, :, :3].astype(np.float32)
    alpha = x[:, :, 3:].astype(np.float32) / 255.0
    y = color * alpha + 255.0 * (1.0 - alpha)
    return y.clip(0, 255).astype(np.uint8)


def _triangle(x):
    return np.maximum(_F32(0), _F32(1) - np.abs(x))


def _lanczos3(x):
    radius = _F32(3)
    y = radius * np.sin(_F32(np.pi) * x) * np.sin(_F32(np.pi) * x / radius)
    den = np.where(x != 0, _F32(np.pi ** 2) * x * x, _F32(1))
    out = np.where(x > _F32(1e-3), y / den, _F32(1))
    return np.where(x > radius, _F32(0), out).astype(_F32)


_KERNELS = {"linear": _triangle, "bilinear": _triangle, "lanczos3": _lanczos3}


@functools.lru_cache(maxsize=64)
def resize_weights(n_in: int, n_out: int, method: str = "linear",
                   antialias: bool = True) -> np.ndarray:
    """(n_out, n_in) float32 weights of one axis of `jax.image.resize`
    (`compute_weight_mat` with scale n_out / n_in and no translation)."""
    if method not in _KERNELS:
        raise ValueError(f"unknown resize method {method!r}; one of {sorted(_KERNELS)}")
    inv_scale = _F32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, _F32(1)) if antialias else _F32(1)
    sample = (np.arange(n_out, dtype=_F32) + _F32(0.5)) * inv_scale - _F32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=_F32)[:, None]) / kernel_scale
    w = _KERNELS[method](x).astype(_F32)
    total = w.sum(axis=0, keepdims=True, dtype=_F32)
    safe = np.where(total != 0, total, _F32(1))
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps, w / safe, _F32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = np.where(inside[None, :], w, _F32(0)).astype(_F32)
    return np.ascontiguousarray(w.T)


def _resize_hw(x: torch.Tensor, height: int, width: int, method: str) -> torch.Tensor:
    """(..., H, W, C) float -> (..., height, width, C); an axis whose size
    does not change is left alone, as `jax.image.resize` leaves it."""
    h, w = x.shape[-3], x.shape[-2]
    if h != height:
        wy = torch.from_numpy(resize_weights(h, height, method)).to(x.device, x.dtype)
        x = torch.einsum("oh,...hwc->...owc", wy, x)
    if w != width:
        wx = torch.from_numpy(resize_weights(w, width, method)).to(x.device, x.dtype)
        x = torch.einsum("ow,...hwc->...hoc", wx, x)
    return x


def resize_image(x: np.ndarray, resolution: int) -> np.ndarray:
    """Resize so that the short side is `resolution`, each side rounded to
    a multiple of 64: lanczos3 when upscaling, antialiased linear when
    downscaling, in fp32, then rounded and clipped to uint8."""
    h, w = x.shape[:2]
    k = float(resolution) / min(h, w)
    H = int(np.round(h * k / 64.0)) * 64
    W = int(np.round(w * k / 64.0)) * 64
    arr = torch.from_numpy(np.asarray(x, dtype=np.float32))
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[..., None]
    out = _resize_hw(arr, H, W, "lanczos3" if k > 1 else "linear")
    out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8).numpy()
    return out[..., 0] if squeeze else out


def batched_resize(x: torch.Tensor, height: int, width: int,
                   method: str = "linear") -> torch.Tensor:
    """(B, H, W, C) -> (B, height, width, C) on x's device (an integer
    input is taken to fp32)."""
    if not x.is_floating_point():
        x = x.float()
    return _resize_hw(x, height, width, method)


def normalize_m11(x: torch.Tensor) -> torch.Tensor:
    """uint8 / float [0, 255] -> [-1, 1] (the notebook's query
    normalisation)."""
    return x.float() / 127.5 - 1.0


def normalize_01(x: torch.Tensor) -> torch.Tensor:
    return x.float() / 255.0
