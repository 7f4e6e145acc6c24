"""HED (holistically-nested edge detection) as a batched PyTorch module.

Counterpart of `prompt_diffusion_tpu/annotators/hed.py`, with its names: a
VGG16 trunk in 5 stages (max pools between them), one 1x1 score head per
stage, each score upsampled bilinearly to the input size in fp32, fused by
`combine` (the reference's 1x1 conv over the 5 scores, as a weighted sum)
and a sigmoid.

Input: (B, 3, H, W) RGB in [0, 255]. The caffe mean is subtracted in RGB
order; the reference's RGB -> BGR flip lives in `import_hed_checkpoint`,
which reverses the first conv's input channels. Output: (B, H, W) fp32
edge probability in [0, 1]. No kernel of the port runs here: convs, pools
and the resize are cuDNN and PyTorch calls.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from prompt_diffusion_tpu_torch.models.layers import Conv
from prompt_diffusion_tpu_torch.ops.resize import resize_bilinear
from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy, default_policy

_BGR_MEAN = (104.00698793, 116.66876762, 122.67891434)
# (width, convs) per VGG stage
_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class _Combine(nn.Conv2d):
    """The reference's netCombine: a 1x1 conv (5 -> 1, fp32 weight of
    shape (1, 5, 1, 1)) over the concatenated scores, computed as the JAX
    package computes it: bias + score_0 * w_0 + ... in that order, fp32."""

    def __init__(self, n: int):
        super().__init__(n, 1, 1, dtype=torch.float32)

    def forward(self, scores):
        out = self.bias[0]
        for s, sc in enumerate(scores):
            out = out + sc[:, 0].float() * self.weight[0, s, 0, 0]
        return out


class HEDNetwork(nn.Module):
    def __init__(self, policy: DTypePolicy = default_policy()):
        super().__init__()
        self.compute_dtype = dt = policy.compute_dtype
        cin = 3
        for s, (width, n_convs) in enumerate(_STAGES):
            for c in range(n_convs):
                self.add_module(f"vgg_{s}_conv_{c}", Conv(cin, width, 3, padding=1, dtype=dt))
                cin = width
            self.add_module(f"score_{s}", Conv(width, 1, 1, dtype=dt))
        self.combine = _Combine(len(_STAGES))

    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        mean = torch.tensor(_BGR_MEAN[::-1], dtype=torch.float32, device=rgb.device)
        x = (rgb.float() - mean[:, None, None]).to(self.compute_dtype)
        h, w = x.shape[-2:]
        scores = []
        for s, (_, n_convs) in enumerate(_STAGES):
            if s > 0:
                x = F.max_pool2d(x, 2, 2)
            for c in range(n_convs):
                x = F.relu(getattr(self, f"vgg_{s}_conv_{c}")(x))
            score = getattr(self, f"score_{s}")(x)
            scores.append(resize_bilinear(score.float(), h, w))
        return torch.sigmoid(self.combine(scores))


_TORCH_STAGE_NAMES = ("netVggOne", "netVggTwo", "netVggThr", "netVggFou", "netVggFiv")
_TORCH_SCORE_NAMES = ("netScoreOne", "netScoreTwo", "netScoreThr", "netScoreFou", "netScoreFiv")


def _hed_keys():
    """(port key, reference key) pairs: a stage after the first starts its
    torch Sequential with the pool, so its convs sit at 1, 3, 5."""
    pairs = []
    for s, (_, n_convs) in enumerate(_STAGES):
        for c in range(n_convs):
            ref = f"{_TORCH_STAGE_NAMES[s]}.{(s > 0) + 2 * c}"
            pairs += [(f"vgg_{s}_conv_{c}.{leaf}", f"{ref}.{leaf}") for leaf in ("weight", "bias")]
        pairs += [(f"score_{s}.{leaf}", f"{_TORCH_SCORE_NAMES[s]}.{leaf}")
                  for leaf in ("weight", "bias")]
    return pairs + [(f"combine.{leaf}", f"netCombine.0.{leaf}") for leaf in ("weight", "bias")]


def import_hed_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """network-bsds500.pth -> the state dict of `HEDNetwork` (torch
    layouts; keys with `module` read as `net`). The first conv's input
    channels are reversed, so that the network takes RGB."""
    sd = {k.replace("module", "net"): v for k, v in
          torch.load(path, map_location="cpu", weights_only=True).items()}
    out = {port: sd[ref] for port, ref in _hed_keys()}
    out["vgg_0_conv_0.weight"] = out["vgg_0_conv_0.weight"].flip(1)
    return out


def export_hed_checkpoint(model: HEDNetwork) -> Dict[str, torch.Tensor]:
    """The inverse of `import_hed_checkpoint`: the reference's
    network-bsds500 state dict (`net` names, fp32, on the CPU) of a
    `HEDNetwork`."""
    sd = {k: v.detach().float().cpu() for k, v in model.state_dict().items()}
    sd["vgg_0_conv_0.weight"] = sd["vgg_0_conv_0.weight"].flip(1)
    return {ref: sd[port] for port, ref in _hed_keys()}


def create_hed(path: str, device="cuda", policy: DTypePolicy = default_policy()) -> HEDNetwork:
    """`HEDNetwork` with the weights of `path`, in eval mode on `device`."""
    with torch.device(device):
        model = HEDNetwork(policy)
    model.load_state_dict(import_hed_checkpoint(path), strict=True)
    return model.eval().requires_grad_(False)


def _gaussian_kernel(sigma: float) -> np.ndarray:
    """The JAX package's blur kernel: radius max(1, int(3 sigma)), 2-D,
    normalised to sum 1."""
    radius = max(1, int(3 * sigma))
    g = np.exp(-0.5 * ((np.arange(2 * radius + 1) - radius) / sigma) ** 2)
    k2 = np.outer(g, g).astype(np.float32)
    return k2 / k2.sum()


# the four flat 3x3 line structuring elements of the reference's nms:
# horizontal, vertical and the two diagonals, as (dy, dx) taps
_LINES = (((1, 0), (1, 1), (1, 2)), ((0, 1), (1, 1), (2, 1)),
          ((0, 0), (1, 1), (2, 2)), ((0, 2), (1, 1), (2, 0)))


def _max_filter(img: torch.Tensor, taps) -> torch.Tensor:
    """Grayscale dilation of (B, H, W) with a flat 3x3 structuring element
    given as (dy, dx) taps; out-of-image taps are ignored, as cv2.dilate
    ignores them."""
    h, w = img.shape[-2:]
    padded = F.pad(img, (1, 1, 1, 1), value=float("-inf"))
    return torch.stack([padded[:, dy:dy + h, dx:dx + w] for dy, dx in taps]).amax(dim=0)


def nms_edges(x: torch.Tensor, threshold: float, sigma: float) -> torch.Tensor:
    """The reference's `nms` (annotator/hed): Gaussian blur, keep the pixels
    that are maxima along any of 4 lines, binarise to {0, 255}. x: (B, H, W)
    float in [0, 255]. The kernel is the JAX package's (radius 3 sigma);
    the borders follow the reference, not the JAX package: the blur
    reflects (cv2's BORDER_REFLECT_101) where JAX pads with zeros, and the
    line maxima ignore out-of-image taps where JAX wraps around through
    `jnp.roll`. Away from the borders both give the same map."""
    k2 = torch.from_numpy(_gaussian_kernel(sigma)).to(x.device)
    r = k2.shape[0] // 2
    xb = F.pad(x.float()[:, None], (r, r, r, r), mode="reflect")
    xb = F.conv2d(xb, k2[None, None])[:, 0]
    y = torch.zeros_like(xb)
    for taps in _LINES:
        y = torch.where(_max_filter(xb, taps) == xb, xb, y)
    return (y > threshold).float() * 255.0
