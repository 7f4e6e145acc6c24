"""InceptionV3 feature extractor for FID, for PyTorch and CUDA.

Counterpart of `prompt_diffusion_tpu/evaluation/inception.py`: the
FID-standard "pt_inception" network (TF-Slim InceptionV3 as pytorch-fid
ships it, loaded by the reference's eval/fid.py:34): stem → 3×A → B →
4×C (7×7 widths 128/160/160/192) → D → 2×E → global average pool →
2048-d pool3 features. It keeps the FID variant's quirks: the 3×3 average
pools of the A, C and first E blocks leave the padding out of the count
(`count_include_pad=False`), `Mixed_7c` pools with a max (pytorch-fid's
FIDInceptionE_2), and BatchNorm runs in inference mode from its running
statistics with eps 1e-3. Submodules are named as pytorch-fid names them
(`Mixed_5b.branch1x1.conv.weight`, `.bn.running_mean`, ...), so the
`pt_inception-2015-12-05-6726825d.pth` file loads with a strict key check
(`load_inception_params`); without it the weights are He-normal random
draws from a `torch.Generator` (`he_normal_init_`), as the JAX extractor's
are: a variance-preserving init keeps random features O(1) through the 94
ReLU layers, so rank-only FID comparisons stay meaningful.

Input: (B, H, W, 3) in [0, 1]; resized inside to 299² with
`F.interpolate(mode="bilinear", align_corners=False, antialias=False)`
(pytorch-fid's resize, equal to the JAX extractor's `jax.image.resize(...,
antialias=False)`), scaled to [-1, 1]. The convolutions run in fp32 with
TF32 off for the call (the caller's setting restored after it): PyTorch
lets cuDNN use TF32 by default, which would make every FID depend on the
caller's global flags. `tf32_convolutions()` turns it on inside a block,
to measure what TF32 would change.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
RES = 299


class FrozenBN(nn.Module):
    """BatchNorm in inference mode: `weight`, `bias` and the running
    statistics as buffers, named as torch's BatchNorm2d names them (no
    `num_batches_tracked`)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))


class ConvBN(nn.Module):
    """Conv (no bias) → inference BN → ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = FrozenBN(cout)

    def forward(self, x):
        bn = self.bn
        x = F.batch_norm(self.conv(x), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                         training=False, eps=BN_EPS)
        return F.relu(x, inplace=True)


def _avg_pool_nocountpad(x):
    """3×3 stride-1 average pool, count_include_pad=False (FID variant)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _max_pool(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = ConvBN(cin, 64, 1)
        self.branch5x5_1 = ConvBN(cin, 48, 1)
        self.branch5x5_2 = ConvBN(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = ConvBN(cin, 64, 1)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, padding=1)
        self.branch_pool = ConvBN(cin, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_nocountpad(x))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = ConvBN(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = ConvBN(cin, 64, 1)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = ConvBN(cin, 192, 1)
        self.branch7x7_1 = ConvBN(cin, c7, 1)
        self.branch7x7_2 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = ConvBN(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = ConvBN(cin, c7, 1)
        self.branch7x7dbl_2 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = ConvBN(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = ConvBN(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_nocountpad(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = ConvBN(cin, 192, 1)
        self.branch3x3_2 = ConvBN(192, 320, 3, stride=2)
        self.branch7x7x3_1 = ConvBN(cin, 192, 1)
        self.branch7x7x3_2 = ConvBN(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = ConvBN(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = ConvBN(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool(x)], 1)


class InceptionE(nn.Module):
    """last_pool: "avg" (FID E1, count_include_pad=False) or "max" (E2)."""

    def __init__(self, cin: int, last_pool: str):
        super().__init__()
        self.last_pool = last_pool
        self.branch1x1 = ConvBN(cin, 320, 1)
        self.branch3x3_1 = ConvBN(cin, 384, 1)
        self.branch3x3_2a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = ConvBN(cin, 448, 1)
        self.branch3x3dbl_2 = ConvBN(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = ConvBN(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.last_pool == "avg":
            bp = _avg_pool_nocountpad(x)
        else:
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


# cuDNN's TF32 setting of the forward's convolutions (`tf32_convolutions`)
_CONV_TF32 = False


@contextlib.contextmanager
def tf32_convolutions():
    """The forward's convolutions with cuDNN's TF32 on inside the block."""
    global _CONV_TF32
    _CONV_TF32 = True
    try:
        yield
    finally:
        _CONV_TF32 = False


@contextlib.contextmanager
def _cudnn_tf32(allow: bool):
    """cuDNN's TF32 switch set to `allow` for the block, restored after."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


class InceptionV3(nn.Module):
    """Images (B, H, W, 3) in [0, 1] → pool3 features (B, 2048), fp32."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = ConvBN(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = ConvBN(32, 32, 3)
        self.Conv2d_2b_3x3 = ConvBN(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = ConvBN(64, 80, 1)
        self.Conv2d_4a_3x3 = ConvBN(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x):
        x = x.float().permute(0, 3, 1, 2)
        if tuple(x.shape[-2:]) != (RES, RES):
            x = F.interpolate(x, size=(RES, RES), mode="bilinear", align_corners=False,
                              antialias=False)
        x = (x * 2.0 - 1.0).contiguous(memory_format=torch.channels_last)
        with _cudnn_tf32(_CONV_TF32):
            x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
            x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool(x)))
            x = _max_pool(x)
            for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                         "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
                x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


@torch.no_grad()
def he_normal_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Every conv kernel drawn as Flax's `he_normal` draws it: a normal
    truncated to ±2 standard deviations, scaled to variance 2 / fan_in
    (the truncation's 0.8796 correction included), in fp32 on the
    generator's device; the BN affines and statistics keep their identity
    values (the JAX extractor's init)."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
            u = torch.rand(m.weight.shape, generator=generator, device=generator.device)
            m.weight.copy_(torch.erfinv(u * (hi - lo) + lo) * (math.sqrt(2.0) * std))
    return model


def load_inception_params(path: str) -> Dict[str, torch.Tensor]:
    """The pt_inception-2015-12-05 `.pth` (pytorch-fid's FID weights) as a
    state dict of `InceptionV3`: its `fc.*` classifier and any
    `num_batches_tracked` counters are dropped by name; a missing or
    unknown key is refused."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v.float() for k, v in sd.items()
          if not k.startswith("fc.") and not k.endswith(".num_batches_tracked")}
    with torch.device("meta"):
        want = InceptionV3().state_dict()
    missing, unknown = sorted(set(want) - set(sd)), sorted(set(sd) - set(want))
    if missing or unknown:
        raise KeyError(f"{path}: not a pt_inception state dict: missing {missing[:6]}, "
                       f"unknown {unknown[:6]}")
    for k, v in want.items():
        if tuple(sd[k].shape) != tuple(v.shape):
            raise ValueError(f"{path}: {k} has shape {tuple(sd[k].shape)}, expected "
                             f"{tuple(v.shape)}")
    return sd


def create_inception(path: Optional[str] = None, seed: int = 0,
                     device: torch.device | str = "cuda") -> InceptionV3:
    """The extractor on `device` (the card unless the caller asks for the
    CPU), in eval mode with channels_last weights: the pt_inception file
    at `path`, else He-normal random weights from `seed`."""
    with torch.device(device):
        model = InceptionV3()
    if path is None:
        he_normal_init_(model, torch.Generator(device=device).manual_seed(seed))
    else:
        model.load_state_dict(load_inception_params(path), strict=True)
    return model.to(memory_format=torch.channels_last).eval().requires_grad_(False)
