"""OpenPose body (and hand) skeleton annotator.

Counterpart of `prompt_diffusion_tpu/annotators/openpose.py`, with its
names: the two CPM networks as batched PyTorch modules (NCHW), and the
host-side numpy decode (peak finding, part-affinity scoring, greedy
assembly: copies of the JAX package's, with its COCO-18 tables).

Body net: a VGG trunk, then 6 stages of two branches (L1: 38 PAF maps, L2:
19 heat maps), each later stage reading cat(L1, L2, trunk). Hand net: a
deeper trunk, then 6 stages of 22 maps. The skeleton render draws what
OpenCV draws (`cv2.ellipse2Poly`, `fillConvexPoly`, `circle` of the
reference's `draw_bodypose`) with rasterisers written here in numpy: the
port imports no OpenCV. No kernel of the port runs here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from prompt_diffusion_tpu_torch.annotators.mlsd import draw_line
from prompt_diffusion_tpu_torch.models.layers import Conv
from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy, default_policy

# COCO-18 limb sequence (1-indexed joints) and each limb's PAF channel pair
LIMB_SEQ = [
    [2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9], [9, 10],
    [10, 11], [2, 12], [12, 13], [13, 14], [2, 1], [1, 15], [15, 17],
    [1, 16], [16, 18], [3, 17], [6, 18],
]
MAP_IDX = [
    [31, 32], [39, 40], [33, 34], [35, 36], [41, 42], [43, 44], [19, 20],
    [21, 22], [23, 24], [25, 26], [27, 28], [29, 30], [47, 48], [49, 50],
    [53, 54], [51, 52], [55, 56], [37, 38], [45, 46],
]
DRAW_COLORS = [
    [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0], [170, 255, 0],
    [85, 255, 0], [0, 255, 0], [0, 255, 85], [0, 255, 170], [0, 255, 255],
    [0, 170, 255], [0, 85, 255], [0, 0, 255], [85, 0, 255], [170, 0, 255],
    [255, 0, 255], [255, 0, 170], [255, 0, 85],
]

_BODY_TRUNK = [  # (name, out channels, kernel); "pool" is a 2x2 max pool
    ("conv1_1", 64, 3), ("conv1_2", 64, 3), ("pool", 0, 0),
    ("conv2_1", 128, 3), ("conv2_2", 128, 3), ("pool", 0, 0),
    ("conv3_1", 256, 3), ("conv3_2", 256, 3), ("conv3_3", 256, 3),
    ("conv3_4", 256, 3), ("pool", 0, 0),
    ("conv4_1", 512, 3), ("conv4_2", 512, 3),
    ("conv4_3_CPM", 256, 3), ("conv4_4_CPM", 128, 3),
]


class _Convs(nn.Module):
    """A conv stack with a ReLU after each conv (after the last only when
    `final_relu`)."""

    def __init__(self, spec, cin: int, policy: DTypePolicy, final_relu: bool = True):
        super().__init__()
        self.spec, self.final_relu = tuple(spec), final_relu
        for name, ch, k in self.spec:
            if name != "pool":
                self.add_module(name, Conv(cin, ch, k, padding=k // 2,
                                           dtype=policy.compute_dtype))
                cin = ch
        self.out_channels = cin

    def forward(self, x):
        convs = [s for s in self.spec if s[0] != "pool"]
        for name, _, _ in self.spec:
            if name == "pool":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = getattr(self, name)(x)
            if name != convs[-1][0] or self.final_relu:
                x = F.relu(x)
        return x


def _stage_spec(stage: int, branch: int, out_ch: int):
    return ([(f"Mconv{j}_stage{stage}_L{branch}", 128, 7) for j in range(1, 6)]
            + [(f"Mconv6_stage{stage}_L{branch}", 128, 1),
               (f"Mconv7_stage{stage}_L{branch}", out_ch, 1)])


class BodyPoseNet(nn.Module):
    """(B, 3, H, W) BGR in [-0.5, 0.5] -> (paf (B, 38, H/8, W/8), heat
    (B, 19, H/8, W/8)), fp32."""

    def __init__(self, policy: DTypePolicy = default_policy()):
        super().__init__()
        self.compute_dtype = policy.compute_dtype
        self.model0 = _Convs(_BODY_TRUNK, 3, policy)
        for branch, out in ((1, 38), (2, 19)):
            spec = [(f"conv5_{j}_CPM_L{branch}", 128, 3) for j in (1, 2, 3)] + [
                (f"conv5_4_CPM_L{branch}", 512, 1), (f"conv5_5_CPM_L{branch}", out, 1)]
            self.add_module(f"model1_{branch}", _Convs(spec, 128, policy, final_relu=False))
        for s in range(2, 7):
            for branch, out in ((1, 38), (2, 19)):
                self.add_module(f"model{s}_{branch}", _Convs(
                    _stage_spec(s, branch, out), 38 + 19 + 128, policy, final_relu=False))

    def forward(self, x):
        trunk = self.model0(x.to(self.compute_dtype))
        l1, l2 = self.model1_1(trunk), self.model1_2(trunk)
        for s in range(2, 7):
            cat = torch.cat([l1, l2, trunk], dim=1)
            l1, l2 = getattr(self, f"model{s}_1")(cat), getattr(self, f"model{s}_2")(cat)
        # the reference's no-ReLU list names Mconv7_stage6_L1 twice and never
        # Mconv7_stage6_L2, so the final heat maps pass through a ReLU
        return l1.float(), F.relu(l2).float()


class HandPoseNet(nn.Module):
    """(B, 3, H, W) BGR in [-0.5, 0.5] -> (B, 22, H/8, W/8) fp32 heat maps."""

    def __init__(self, policy: DTypePolicy = default_policy()):
        super().__init__()
        self.compute_dtype = policy.compute_dtype
        trunk = _BODY_TRUNK[:13] + [("conv4_3", 512, 3), ("conv4_4", 512, 3),
                                    ("conv5_1", 512, 3), ("conv5_2", 512, 3),
                                    ("conv5_3_CPM", 128, 3)]
        self.model1_0 = _Convs(trunk, 3, policy)
        self.model1_1 = _Convs((("conv6_1_CPM", 512, 1), ("conv6_2_CPM", 22, 1)), 128, policy,
                               final_relu=False)
        for s in range(2, 7):
            spec = ([(f"Mconv{j}_stage{s}", 128, 7) for j in range(1, 6)]
                    + [(f"Mconv6_stage{s}", 128, 1), (f"Mconv7_stage{s}", 22, 1)])
            self.add_module(f"model{s}", _Convs(spec, 22 + 128, policy, final_relu=False))

    def forward(self, x):
        trunk = self.model1_0(x.to(self.compute_dtype))
        out = self.model1_1(trunk)
        for s in range(2, 7):
            out = getattr(self, f"model{s}")(torch.cat([out, trunk], dim=1))
        return out.float()


def import_body_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """body_pose_model.pth (or hand_pose_model.pth) -> the state dict of
    `BodyPoseNet` (`HandPoseNet`): the reference's keys
    (`model0.conv1_1.weight`, `model2_1.Mconv1_stage2_L1.bias`, ...) are the
    port's, and its torch layouts carry over."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for k in sd:
        if len(k.split(".")) != 3 or k.rsplit(".", 1)[1] not in ("weight", "bias"):
            raise ValueError(f"not an OpenPose CPM key: {k!r}")
    return dict(sd)


import_hand_checkpoint = import_body_checkpoint  # the same key scheme


# ---------------------------------------------------------------------------
# host-side decode (numpy, copied from the JAX package)
# ---------------------------------------------------------------------------

def _gaussian_blur(x: np.ndarray, sigma: float = 3.0) -> np.ndarray:
    r = int(3 * sigma)
    g = np.exp(-0.5 * ((np.arange(2 * r + 1) - r) / sigma) ** 2)
    g /= g.sum()
    x = np.apply_along_axis(lambda m: np.convolve(m, g, mode="same"), 0, x)
    return np.apply_along_axis(lambda m: np.convolve(m, g, mode="same"), 1, x)


def find_peaks(heatmap: np.ndarray, thresh: float = 0.1) -> List[List[Tuple]]:
    """Per-joint peak lists [(x, y, score, global id), ...]: blur, 4-neighbour
    local maxima above the threshold."""
    all_peaks = []
    peak_counter = 0
    for part in range(18):
        m = _gaussian_blur(heatmap[:, :, part])
        up = np.zeros_like(m); up[1:] = m[:-1]
        down = np.zeros_like(m); down[:-1] = m[1:]
        left = np.zeros_like(m); left[:, 1:] = m[:, :-1]
        right = np.zeros_like(m); right[:, :-1] = m[:, 1:]
        is_peak = (m >= up) & (m >= down) & (m >= left) & (m >= right) & (m > thresh)
        ys, xs = np.nonzero(is_peak)
        peaks = [
            (int(x), int(y), float(heatmap[y, x, part]), peak_counter + i)
            for i, (x, y) in enumerate(zip(xs, ys))
        ]
        peak_counter += len(peaks)
        all_peaks.append(peaks)
    return all_peaks


def score_limbs(paf: np.ndarray, all_peaks, ori_h: int, mid_num: int = 10,
                paf_thresh: float = 0.05):
    """PAF line-integral scoring and per-limb greedy matching."""
    connection_all = []
    special_k = []
    for k, (limb, mi) in enumerate(zip(LIMB_SEQ, MAP_IDX)):
        score_mid = paf[:, :, [mi[0] - 19, mi[1] - 19]]
        candA = all_peaks[limb[0] - 1]
        candB = all_peaks[limb[1] - 1]
        if not candA or not candB:
            special_k.append(k)
            connection_all.append([])
            continue
        candidates = []
        for ia, a in enumerate(candA):
            for ib, b in enumerate(candB):
                vec = np.asarray([b[0] - a[0], b[1] - a[1]], np.float64)
                norm = max(math.hypot(*vec), 1e-8)
                vecn = vec / norm
                xs = np.linspace(a[0], b[0], mid_num)
                ys = np.linspace(a[1], b[1], mid_num)
                pts = score_mid[np.round(ys).astype(int).clip(0, paf.shape[0] - 1),
                                np.round(xs).astype(int).clip(0, paf.shape[1] - 1)]
                scores = pts @ vecn
                prior = scores.mean() + min(0.5 * ori_h / norm - 1, 0)
                if (scores > paf_thresh).sum() > 0.8 * mid_num and prior > 0:
                    candidates.append((ia, ib, prior, prior + a[2] + b[2]))
        candidates.sort(key=lambda c: -c[2])
        conn = []
        used_a, used_b = set(), set()
        for ia, ib, s, st in candidates:
            if ia not in used_a and ib not in used_b:
                conn.append([candA[ia][3], candB[ib][3], s, ia, ib])
                used_a.add(ia); used_b.add(ib)
                if len(conn) >= min(len(candA), len(candB)):
                    break
        connection_all.append(conn)
    return connection_all, special_k


def assemble_people(all_peaks, connection_all, special_k):
    """Greedy subset assembly over the limb connections. Returns
    (candidate (N, 4), subset (P, 20))."""
    candidate = np.asarray([p for peaks in all_peaks for p in peaks], np.float64)
    subset = -1 * np.ones((0, 20))
    for k, limb in enumerate(LIMB_SEQ):
        if k in special_k or not connection_all[k]:
            continue
        indexA, indexB = np.asarray(limb) - 1
        for i, (pa, pb, score, _, _) in enumerate(
            [(c[0], c[1], c[2], c[3], c[4]) for c in connection_all[k]]
        ):
            found = [
                j for j in range(len(subset))
                if subset[j][indexA] == pa or subset[j][indexB] == pb
            ]
            if len(found) == 1:
                j = found[0]
                if subset[j][indexB] != pb:
                    subset[j][indexB] = pb
                    subset[j][-1] += 1
                    subset[j][-2] += candidate[int(pb), 2] + score
            elif len(found) == 2:
                j1, j2 = found
                membership = ((subset[j1] >= 0).astype(int) + (subset[j2] >= 0).astype(int))[:-2]
                if (membership == 2).sum() == 0:  # disjoint: merge
                    subset[j1][:-2] += subset[j2][:-2] + 1
                    subset[j1][-2:] += subset[j2][-2:]
                    subset[j1][-2] += score
                    subset = np.delete(subset, j2, 0)
                else:
                    subset[j1][indexB] = pb
                    subset[j1][-1] += 1
                    subset[j1][-2] += candidate[int(pb), 2] + score
            elif not found and k < 17:
                row = -1 * np.ones(20)
                row[indexA], row[indexB] = pa, pb
                row[-1] = 2
                row[-2] = candidate[int(pa), 2] + candidate[int(pb), 2] + score
                subset = np.vstack([subset, row])
    # prune weak or small subsets: < 4 parts or a mean score < 0.4
    keep = [i for i in range(len(subset))
            if subset[i][-1] >= 4 and subset[i][-2] / subset[i][-1] >= 0.4]
    return candidate, subset[keep]


# ---------------------------------------------------------------------------
# the skeleton render: OpenCV's rasterisers, written in numpy
# ---------------------------------------------------------------------------

# OpenCV's table of sin(degrees), 0..450, as its float literals (7 decimals)
_SIN_TABLE = np.round(np.sin(np.radians(np.arange(451))), 7).astype(np.float32).astype(np.float64)


def ellipse2poly(center, axes, angle: int, arc_start: int, arc_end: int,
                 delta: int) -> np.ndarray:
    """cv2.ellipse2Poly: (N, 2) int points, consecutive duplicates dropped;
    two copies of the centre for a polygon of one point. Arcs within
    [0, 360] (what the render passes)."""
    angle %= 360
    alpha, beta = _SIN_TABLE[450 - angle], _SIN_TABLE[angle]  # cos, sin
    pts, prev = [], None
    for i in range(arc_start, arc_end + delta, delta):
        a = min(i, arc_end)
        x = axes[0] * _SIN_TABLE[450 - a]
        y = axes[1] * _SIN_TABLE[a]
        # cvRound: half to even
        pt = (int(np.rint(center[0] + x * alpha - y * beta)),
              int(np.rint(center[1] + x * beta + y * alpha)))
        if pt != prev:
            pts.append(pt)
            prev = pt
    if len(pts) == 1:
        pts = [tuple(center)] * 2
    return np.asarray(pts, np.int64)


def _hline(canvas, y, x1, x2, color):
    h, w = canvas.shape[:2]
    if 0 <= y < h and x2 >= 0 and x1 < w:
        canvas[y, max(x1, 0):min(x2, w - 1) + 1] = color


def fill_convex_poly(canvas: np.ndarray, pts: np.ndarray, color) -> None:
    """cv2.fillConvexPoly(canvas, pts, color) (8-connected, no shift) in
    place: the outline drawn as lines, then scanlines between the two
    edges walked down from the top vertex in 16-bit fixed point."""
    shift, one = 16, 1 << 16
    v = [(int(x), int(y)) for x, y in pts]
    n = len(v)
    for i in range(n):
        draw_line(canvas, v[i - 1], v[i], color)
    xs, ys = [p[0] for p in v], [p[1] for p in v]
    h, w = canvas.shape[:2]
    if n < 3 or max(xs) < 0 or max(ys) < 0 or min(xs) >= w or min(ys) >= h:
        return
    imin = int(np.argmin(ys))
    ymax = min(max(ys), h - 1)
    y = ys[imin]
    edge = [{"idx": imin, "di": 1, "x": -one, "dx": 0, "ye": y},
            {"idx": imin, "di": n - 1, "x": -one, "dx": 0, "ye": y}]
    edges = n
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % n
                while edges > 0:
                    edges -= 1
                    ty = v[idx][1]
                    if ty > y:
                        xs0, xe = v[idx0][0] << shift, v[idx][0] << shift
                        num, den = (xe - xs0) * 2 + (ty - y), 2 * (ty - y)
                        e.update(ye=ty, x=xs0, idx=idx,
                                 dx=int(num / den))  # C's division truncates
                        break
                    idx0, idx = idx, (idx + e["di"]) % n
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            _hline(canvas, y, (edge[left]["x"] + one // 2) >> shift,
                   (edge[right]["x"] + one // 2) >> shift, color)
        for e in edge:
            e["x"] += e["dx"]
        y += 1
        if y > ymax:
            break


def fill_circle(canvas: np.ndarray, center, radius: int, color) -> None:
    """cv2.circle(canvas, center, radius, color, thickness=-1) (8-connected,
    no shift) in place: the midpoint circle's scanlines."""
    cx, cy = center
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        for yy, half in ((cy - dy, dx), (cy + dy, dx), (cy - dx, dy), (cy + dx, dy)):
            _hline(canvas, yy, cx - half, cx + half, color)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def draw_bodypose(canvas: np.ndarray, candidate: np.ndarray, subset: np.ndarray) -> np.ndarray:
    """The reference's skeleton render: a filled ellipse per limb (stick
    width 4), the canvas scaled by 0.6, then a dot of radius 4 per joint."""
    stickwidth = 4
    for i in range(17):
        for person in subset:
            idx = person[np.asarray(LIMB_SEQ[i]) - 1]
            if -1 in idx:
                continue
            ys = candidate[idx.astype(int), 1]
            xs = candidate[idx.astype(int), 0]
            m_x, m_y = xs.mean(), ys.mean()
            length = math.hypot(xs[0] - xs[1], ys[0] - ys[1])
            angle = math.degrees(math.atan2(ys[0] - ys[1], xs[0] - xs[1]))
            poly = ellipse2poly((int(m_x), int(m_y)), (int(length / 2), stickwidth), int(angle),
                                0, 360, 1)
            fill_convex_poly(canvas, poly, DRAW_COLORS[i])
    canvas = (canvas * 0.6).astype(np.uint8)
    for i in range(18):
        for person in subset:
            idx = int(person[i])
            if idx == -1:
                continue
            x, y = candidate[idx][:2]
            fill_circle(canvas, (int(x), int(y)), 4, DRAW_COLORS[i])
    return canvas


@dataclasses.dataclass
class OpenposeDetector:
    """detector(image_u8 (H, W, 3)) -> (canvas uint8, {"candidate",
    "subset"}), as the reference's detector: the body net on the card, the
    maps upsampled to the image bilinearly (half-pixel, fp32), the decode
    and render on the host."""

    body: BodyPoseNet

    @torch.no_grad()
    def __call__(self, image_u8: np.ndarray):
        if image_u8.ndim != 3:
            raise ValueError(f"expected an (H, W, 3) image, got {image_u8.shape}")
        h, w = image_u8.shape[:2]
        # /256, not 255: the reference normalises with `/ 256 - 0.5`
        bgr = image_u8[:, :, ::-1].astype(np.float32) / 256.0 - 0.5
        device = next(self.body.parameters()).device
        x = torch.from_numpy(np.ascontiguousarray(bgr)).to(device).permute(2, 0, 1)[None]
        up = lambda t: F.interpolate(t, size=(h, w), mode="bilinear", align_corners=False)[0]
        paf, heat = (up(t).permute(1, 2, 0).cpu().numpy() for t in self.body(x))
        peaks = find_peaks(heat)
        conns, special = score_limbs(paf, peaks, h)
        candidate, subset = assemble_people(peaks, conns, special)
        canvas = draw_bodypose(np.zeros_like(image_u8), candidate, subset)
        return canvas, dict(candidate=candidate.tolist(), subset=subset.tolist())
