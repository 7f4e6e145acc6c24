"""M-LSD line segment detection (MobileV2_MLSD_Large) as PyTorch modules.

Counterpart of `prompt_diffusion_tpu/annotators/mlsd.py`, with its names:
a truncated MobileNetV2 on a 4-channel input (RGB and a plane of ones) with
taps at features (1, 3, 6, 10, 13), the type A/B/C fusion decoder, and the
9 maps the detector keeps (1 centre logit, 4 displacements, 4 auxiliary).
BatchNorms run in inference mode (`uniformer.InferenceBN`); ReLU6 in the
MobileNet, ReLU in the decoder. `decode_lines` is the JAX package's numpy
decode, copied (scipy's `maximum_filter`).

`MLSDdetector` resizes with `area_resize` (OpenCV's INTER_AREA) and draws
the segments with `draw_line` (OpenCV's clipped 8-connected `cv2.line` of
thickness 1), both written here in numpy: the port imports no OpenCV. No kernel of the port runs here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from prompt_diffusion_tpu_torch.annotators.uniformer import InferenceBN
from prompt_diffusion_tpu_torch.models.layers import Conv
from prompt_diffusion_tpu_torch.ops.resize import resize_bilinear
from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy, default_policy

# (expand t, out c, repeats n, stride s): the truncated MobileNetV2 table
_IR_SETTING = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1)]
_FPN_SELECTED = (1, 3, 6, 10, 13)


class ConvBNReLU6(nn.Module):
    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, policy: DTypePolicy = default_policy()):
        super().__init__()
        self.conv = Conv(cin, features, kernel, stride=stride, padding=(kernel - 1) // 2,
                         groups=groups, bias=False, dtype=policy.compute_dtype)
        self.bn = InferenceBN(features)

    def forward(self, x):
        return torch.clamp(self.bn(self.conv(x)), 0.0, 6.0)


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, out_channels: int, stride: int, expand: int,
                 policy: DTypePolicy = default_policy()):
        super().__init__()
        hidden = cin * expand
        self.layers = []
        if expand != 1:
            self.layer_0 = ConvBNReLU6(cin, hidden, 1, policy=policy)
            self.layers.append("layer_0")
        name = f"layer_{len(self.layers)}"
        self.add_module(name, ConvBNReLU6(hidden, hidden, 3, stride, groups=hidden,
                                          policy=policy))
        self.layers.append(name)
        self.project = Conv(hidden, out_channels, 1, bias=False, dtype=policy.compute_dtype)
        self.project_bn = InferenceBN(out_channels)
        self.residual = stride == 1 and cin == out_channels

    def forward(self, x):
        h = x
        for name in self.layers:
            h = getattr(self, name)(h)
        h = self.project_bn(self.project(h))
        return x + h if self.residual else h


class BlockA(nn.Module):
    """1x1 conv + BN + ReLU of both inputs; b upsampled x2 (corner-aligned)
    when `upscale`; concat [a, b]."""

    def __init__(self, in_a: int, in_b: int, out_c1: int, out_c2: int, upscale: bool = True,
                 policy: DTypePolicy = default_policy()):
        super().__init__()
        dt = policy.compute_dtype
        self.conv1 = Conv(in_b, out_c2, 1, dtype=dt)
        self.bn1 = InferenceBN(out_c2)
        self.conv2 = Conv(in_a, out_c1, 1, dtype=dt)
        self.bn2 = InferenceBN(out_c1)
        self.upscale = upscale

    def forward(self, a, b):
        b = F.relu(self.bn1(self.conv1(b)))
        a = F.relu(self.bn2(self.conv2(a)))
        if self.upscale:
            b = resize_bilinear(b, 2 * b.shape[-2], 2 * b.shape[-1], align_corners=True)
        return torch.cat([a, b], dim=1)


class BlockB(nn.Module):
    def __init__(self, in_c: int, out_c: int, policy: DTypePolicy = default_policy()):
        super().__init__()
        dt = policy.compute_dtype
        self.conv1 = Conv(in_c, in_c, 3, padding=1, dtype=dt)
        self.bn1 = InferenceBN(in_c)
        self.conv2 = Conv(in_c, out_c, 3, padding=1, dtype=dt)
        self.bn2 = InferenceBN(out_c)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x))) + x
        return F.relu(self.bn2(self.conv2(x)))


class BlockC(nn.Module):
    def __init__(self, in_c: int, out_c: int, policy: DTypePolicy = default_policy()):
        super().__init__()
        dt = policy.compute_dtype
        self.conv1 = Conv(in_c, in_c, 3, padding=5, dilation=5, dtype=dt)
        self.bn1 = InferenceBN(in_c)
        self.conv2 = Conv(in_c, in_c, 3, padding=1, dtype=dt)
        self.bn2 = InferenceBN(in_c)
        self.conv3 = Conv(in_c, out_c, 1, dtype=dt)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        return self.conv3(h)


class MLSDNet(nn.Module):
    """(B, 4, H, W) in [-1, 1] (RGB and ones) -> (B, 9, H/2, W/2) fp32: the
    centre logit [0], displacements [1:5], auxiliary maps [5:9] (the
    reference's `x[:, 7:]`)."""

    def __init__(self, policy: DTypePolicy = default_policy()):
        super().__init__()
        self.compute_dtype = policy.compute_dtype
        self.features_0 = ConvBNReLU6(4, 32, 3, 2, policy=policy)
        cin, fi, taps = 32, 1, []
        for t, c, n, s in _IR_SETTING:
            for i in range(n):
                self.add_module(f"features_{fi}", InvertedResidual(
                    cin, c, s if i == 0 else 1, t, policy=policy))
                if fi in _FPN_SELECTED:
                    taps.append(c)
                cin, fi = c, fi + 1
        self.depth = fi
        c1, c2, c3, c4, c5 = taps
        self.block15 = BlockA(c4, c5, 64, 64, upscale=False, policy=policy)
        self.block16 = BlockB(128, 64, policy)
        self.block17 = BlockA(c3, 64, 64, 64, policy=policy)
        self.block18 = BlockB(128, 64, policy)
        self.block19 = BlockA(c2, 64, 64, 64, policy=policy)
        self.block20 = BlockB(128, 64, policy)
        self.block21 = BlockA(c1, 64, 64, 64, policy=policy)
        self.block22 = BlockB(128, 64, policy)
        self.block23 = BlockC(64, 16, policy)

    def forward(self, x):
        h = self.features_0(x.to(self.compute_dtype).contiguous(memory_format=torch.channels_last))
        feats = []
        for fi in range(1, self.depth):
            h = getattr(self, f"features_{fi}")(h)
            if fi in _FPN_SELECTED:
                feats.append(h)
        c1, c2, c3, c4, c5 = feats
        h = self.block16(self.block15(c4, c5))
        h = self.block18(self.block17(c3, h))
        h = self.block20(self.block19(c2, h))
        h = self.block22(self.block21(c1, h))
        return self.block23(h)[:, 7:].float()


def decode_lines(out: np.ndarray, score_thr: float = 0.10, dist_thr: float = 20.0,
                 topk: int = 200, ksize: int = 3) -> np.ndarray:
    """The reference's `pred_lines` decode on one (H, W, 9) output -> (N, 4)
    segments (x0, y0, x1, y1) in the output map's frame x2 (the model halves
    the resolution). ksize 3: `pred_lines` passes 3, not the decode's own
    default of 5. A copy of the JAX package's."""
    center = out[..., 0]
    disp = out[..., 1:5]
    heat = 1.0 / (1.0 + np.exp(-center))
    from scipy.ndimage import maximum_filter

    keep = maximum_filter(heat, size=ksize, mode="constant") == heat
    heat = heat * keep
    flat = heat.ravel()
    idx = np.argpartition(flat, -topk)[-topk:]
    idx = idx[np.argsort(-flat[idx])]
    ys, xs = np.unravel_index(idx, heat.shape)
    segments = []
    for y, x in zip(ys, xs):
        score = heat[y, x]
        dx0, dy0, dx1, dy1 = disp[y, x]
        dist = np.hypot((dx0 - dx1), (dy0 - dy1))
        if score > score_thr and dist > dist_thr:
            segments.append([x + dx0, y + dy0, x + dx1, y + dy1])
    return 2 * np.asarray(segments) if segments else np.zeros((0, 4))


def area_resize(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """OpenCV's INTER_AREA resize of an (H, W, C) uint8 image.

    Shrinking both axes by whole factors: block means rounded half up, as
    OpenCV's fast path does. Shrinking otherwise: each output pixel the
    mean of the input area it covers, partial pixels weighted by their
    overlap, in fp32, rounded half to even. Enlarging an axis: OpenCV's
    area-mode two-tap interpolation on both axes (output d reads source s =
    floor(d / f) and s + 1 with weights (1 - t, t), t = frac((d + 1) - (s +
    1) / f) or 0 where that is <= 0; f the axis's scale), with OpenCV's
    11-bit fixed-point weights and the shifts of its vector code."""
    h, w = image.shape[:2]
    if h >= height and w >= width:
        if h % height == 0 and w % width == 0:
            fy, fx = h // height, w // width
            sums = image.reshape(height, fy, width, fx, -1).astype(np.int64).sum(axis=(1, 3))
            return ((2 * sums + fy * fx) // (2 * fy * fx)).astype(np.uint8)

        def overlap(n_in, n_out):
            wts = np.zeros((n_out, n_in), np.float64)
            scale = n_in / n_out
            for o in range(n_out):
                lo, hi = o * scale, (o + 1) * scale
                for i in range(int(np.floor(lo)), min(int(np.ceil(hi)), n_in)):
                    wts[o, i] = min(hi, i + 1) - max(lo, i)
            return (wts / wts.sum(axis=1, keepdims=True)).astype(np.float32)

        x = np.einsum("oh,hwc->owc", overlap(h, height), image.astype(np.float32))
        x = np.einsum("pw,hwc->hpc", overlap(w, width), x)
        return np.clip(np.rint(x), 0, 255).astype(np.uint8)

    def taps(n_in, n_out):
        idx, wts = np.zeros((n_out, 2), np.int64), np.zeros((n_out, 2), np.int64)
        scale = n_in / n_out
        for o in range(n_out):
            s = int(np.floor(o * scale))
            t = np.float32((o + 1) - (s + 1) / scale)
            t = 0.0 if t <= 0 else float(t - np.floor(t))
            w1 = int(np.rint(t * 2048))
            idx[o], wts[o] = (min(s, n_in - 1), min(s + 1, n_in - 1)), (2048 - w1, w1)
        return idx, wts

    (ix, wx), (iy, wy) = taps(w, width), taps(h, height)
    x = image.astype(np.int64)
    rows = x[:, ix[:, 0]] * wx[None, :, :1] + x[:, ix[:, 1]] * wx[None, :, 1:]
    # the vertical pass as OpenCV's vector code runs it: each row >> 4,
    # the high half of its 16-bit product with the weight, then (+2) >> 2
    s0, s1 = rows[iy[:, 0]] >> 4, rows[iy[:, 1]] >> 4
    y = ((s0 * wy[:, :1, None]) >> 16) + ((s1 * wy[:, 1:, None]) >> 16)
    return np.clip((y + 2) >> 2, 0, 255).astype(np.uint8)


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's clipLine on [0, w - 1] x [0, h - 1] (its integer
    arithmetic, truncating toward zero, and its order of updates); None
    when the segment misses the image."""
    right, bottom = w - 1, h - 1
    code = lambda x, y: (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8
    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1, c1 = a, (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2, c2 = a, (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return None if c1 | c2 else (x1, y1, x2, y2)


def draw_line(canvas: np.ndarray, p0, p1, color) -> None:
    """cv2.line(canvas, p0, p1, color, 1) in place: the segment clipped to
    the canvas as OpenCV clips it, then OpenCV's 8-connected line iterator
    from left to right (the major axis steps every pixel, the minor one
    where the error term is negative)."""
    h, w = canvas.shape[:2]
    clipped = _clip_line(w, h, int(p0[0]), int(p0[1]), int(p1[0]), int(p1[1]))
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err, x, y = dx - 2 * dy, x1, y1
    for _ in range(dx + 1):
        canvas[y, x] = color
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y += sy
            x += int(minor)
        else:
            x += 1
            y += sy * int(minor)


@dataclasses.dataclass
class MLSDdetector:
    """detector(image_u8 (H, W, 3)) -> (H, W) uint8 map of the line
    segments, white on black, as the reference's detector."""

    net: MLSDNet

    @torch.no_grad()
    def __call__(self, image_u8: np.ndarray, thr_v: float = 0.1, thr_d: float = 0.1):
        h, w = image_u8.shape[:2]
        resized = area_resize(image_u8, 512, 512)
        inp = np.concatenate([resized, np.ones((512, 512, 1))], axis=-1)
        inp = inp.astype(np.float32) / 127.5 - 1.0
        device = next(self.net.parameters()).device
        x = torch.from_numpy(inp).to(device).permute(2, 0, 1)[None]
        out = self.net(x)[0].permute(1, 2, 0).cpu().numpy()
        # thr_d passes through unchanged: `distance > dist_thr` in output
        # pixels, as the reference's pred_lines compares it
        lines = decode_lines(out, thr_v, thr_d)
        canvas = np.zeros((h, w, 3), np.uint8)
        for x0, y0, x1, y1 in lines:
            draw_line(canvas, (int(x0 * w / 512), int(y0 * h / 512)),
                      (int(x1 * w / 512), int(y1 * h / 512)), (255, 255, 255))
        return canvas[:, :, 0]


def import_mlsd_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """mlsd_large_512_fp32.pth -> the state dict of `MLSDNet` (torch
    layouts carry over)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    out: Dict[str, torch.Tensor] = {}

    def bn(port, ref):
        for a, b in (("weight", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                     ("var", "running_var")):
            out[f"{port}.{a}"] = sd[f"{ref}.{b}"]

    out["features_0.conv.weight"] = sd["backbone.features.0.0.weight"]
    bn("features_0.bn", "backbone.features.0.1")
    fi = 1
    for t, c, n, s in _IR_SETTING:
        for i in range(n):
            tp, blk = f"backbone.features.{fi}.conv", f"features_{fi}"
            off = 0
            if t != 1:
                out[f"{blk}.layer_0.conv.weight"] = sd[f"{tp}.0.0.weight"]
                bn(f"{blk}.layer_0.bn", f"{tp}.0.1")
                off = 1
            out[f"{blk}.layer_{off}.conv.weight"] = sd[f"{tp}.{off}.0.weight"]
            bn(f"{blk}.layer_{off}.bn", f"{tp}.{off}.1")
            out[f"{blk}.project.weight"] = sd[f"{tp}.{off + 1}.weight"]
            bn(f"{blk}.project_bn", f"{tp}.{off + 2}")
            fi += 1
    for blk in range(15, 24):
        for ci in (1, 2):
            out[f"block{blk}.conv{ci}.weight"] = sd[f"block{blk}.conv{ci}.0.weight"]
            out[f"block{blk}.conv{ci}.bias"] = sd[f"block{blk}.conv{ci}.0.bias"]
            bn(f"block{blk}.bn{ci}", f"block{blk}.conv{ci}.1")
    out["block23.conv3.weight"] = sd["block23.conv3.weight"]
    out["block23.conv3.bias"] = sd["block23.conv3.bias"]
    return out
