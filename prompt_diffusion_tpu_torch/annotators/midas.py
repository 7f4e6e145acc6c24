"""MiDaS DPT monocular depth and surface normals, as batched PyTorch modules.

Counterpart of `prompt_diffusion_tpu/annotators/midas.py`, with its names
and structure: a ViT backbone tapped at hooks, readout projection,
reassembly into a feature pyramid, four RefineNet-style fusion blocks and
a monotone depth head. Two variants share the decoder:

  * DPT-Large (`DPTDepth`): ViT-L/16, hooks (5, 11, 17, 23);
  * DPT-Hybrid (`DPTHybridDepth`), the reference's default: timm's
    `vit_base_resnet50_384`, a ResNetV2-50 stem and stages (3, 4, 9)
    (weight-standardised convs, GroupNorm(32) + ReLU) whose first two
    stages are pyramid levels 1-2, then ViT-B/16 with hooks (8, 11) as
    levels 3-4.

Modules take NCHW tensors; the ResNet's activations stay in channels_last
memory, which the GroupNorm kernel K3 reads without a copy. Attribute
names follow the Flax parameter paths, so the weight bridge
(`tools/jax_bridge.py::load_jax_model`) is mechanical.

Kernels on this path: K3 with its ReLU epilogue (every backbone norm), K4
(the ViT's pre-LNs) and K1 (the ViT's attention at N >= 512 tokens on the
card). Under `quant="int8"` the ViT's denses are `QuantDense`, its pre-LNs
hand them (int8, row scale) pairs from K6 and its attention is K9 - on the
card only, as the JAX package takes them off a CPU backend; the readouts,
the embedding projection and the decoder convs stay in the compute dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from prompt_diffusion_tpu_torch.models.layers import Conv, Dense, FusedLayerNorm
from prompt_diffusion_tpu_torch.ops.flash_attention import (
    _torch_attention,
    flash_attention_packed,
    flash_attention_packed_int8,
)
from prompt_diffusion_tpu_torch.ops.fused_group_norm import group_norm_auto
from prompt_diffusion_tpu_torch.ops.fused_layer_norm import fused_layer_norm_quant
from prompt_diffusion_tpu_torch.ops.quant import QuantDense
from prompt_diffusion_tpu_torch.ops.resize import resize_bilinear
from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy, default_policy

_KERNEL_MIN_TOKENS = 512  # the JAX package's rule for the packed attention kernels


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    patch_size: int = 16
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    hooks: Tuple[int, ...] = (5, 11, 17, 23)
    reassemble_dims: Tuple[int, ...] = (256, 512, 1024, 1024)
    features: int = 256
    pos_grid: int = 24  # 384/16 training grid


@dataclasses.dataclass(frozen=True)
class DPTHybridConfig:
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    hooks: Tuple[int, int] = (8, 11)  # ViT taps (levels 3-4); levels 1-2 are ResNet stages
    resnet_layers: Tuple[int, int, int] = (3, 4, 9)
    reassemble_dims: Tuple[int, ...] = (256, 512, 768, 768)
    features: int = 256
    pos_grid: int = 24


def _int8(policy: DTypePolicy) -> bool:
    return policy.quant == "int8"


def _vit_dense(policy: DTypePolicy):
    """Dense or its int8 W8A8 drop-in (the same state dict) per the policy."""
    if _int8(policy):
        return lambda i, o: QuantDense(i, o, out_dtype=policy.compute_dtype)
    return lambda i, o: Dense(i, o, dtype=policy.compute_dtype)


def _vit_attention(qkv: torch.Tensor, num_heads: int, quant: bool) -> torch.Tensor:
    """Self-attention on a packed (B, N, 3*H*D) qkv projection. At N >= 512
    the packed kernel reads the heads as column slices of the projection:
    K1 (plain on the CPU), or under int8 K9 on the card; below 512 tokens,
    and int8 on the CPU, the plain attention with fp32 softmax."""
    b, n, three_hd = qkv.shape
    q, k, v = qkv.chunk(3, dim=-1)
    if n >= _KERNEL_MIN_TOKENS and quant and qkv.is_cuda:
        return flash_attention_packed_int8(q, k, v, num_heads)
    if n >= _KERNEL_MIN_TOKENS and not quant:
        return flash_attention_packed(q, k, v, num_heads)
    d = three_hd // 3 // num_heads
    split = lambda t: t.unflatten(-1, (num_heads, d))
    return _torch_attention(split(q), split(k), split(v), d ** -0.5).reshape(b, n, -1)


class ViTBlock(nn.Module):
    """Pre-LN transformer block: LN -> qkv -> attention -> proj, LN -> fc1
    -> exact GELU -> fc2, each with a residual."""

    def __init__(self, cfg, policy: DTypePolicy):
        super().__init__()
        dim, dense = cfg.hidden_size, _vit_dense(policy)
        self.num_heads, self.quant = cfg.num_heads, _int8(policy)
        self.norm1 = FusedLayerNorm(dim, eps=1e-6)
        self.qkv = dense(dim, 3 * dim)
        self.proj = dense(dim, dim)
        self.norm2 = FusedLayerNorm(dim, eps=1e-6)
        self.fc1 = dense(dim, cfg.mlp_ratio * dim)
        self.fc2 = dense(cfg.mlp_ratio * dim, dim)

    def _norm(self, norm: FusedLayerNorm, x):
        # int8 on the card: K6 hands QuantDense (int8, row scale); elsewhere
        # the LN's float output, quantized per tensor by QuantDense
        if self.quant and x.is_cuda:
            return fused_layer_norm_quant(x, norm.weight, norm.bias, eps=norm.eps)
        return norm(x)

    def forward(self, x):
        attn = _vit_attention(self.qkv(self._norm(self.norm1, x)), self.num_heads, self.quant)
        x = x + self.proj(attn)
        h = F.gelu(self.fc1(self._norm(self.norm2, x)), approximate="none")
        return x + self.fc2(h)


class _Readout(nn.Module):
    """Readout "project": cat(tokens, cls) . W + b, as t . W[:D] + (cls .
    W[D:] + b) in that order in the compute dtype; the state dict of a
    Dense(2D -> D)."""

    def __init__(self, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.hidden = hidden
        self.weight = nn.Parameter(torch.zeros(hidden, 2 * hidden, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(hidden, dtype=dtype))

    def forward(self, tokens, cls_t):
        d, w = self.hidden, self.weight
        t, c = tokens.to(w.dtype), cls_t.to(w.dtype)
        return t @ w[:, :d].t() + (c @ w[:, d:].t() + self.bias)


class ConvTranspose(nn.ConvTranspose2d):
    """ConvTranspose2d that casts its input to the weight dtype first."""

    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int, policy: DTypePolicy):
        super().__init__()
        dt = policy.compute_dtype
        self.conv1 = Conv(features, features, 3, padding=1, dtype=dt)
        self.conv2 = Conv(features, features, 3, padding=1, dtype=dt)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


def _up2(x):
    return resize_bilinear(x, 2 * x.shape[-2], 2 * x.shape[-1], align_corners=True)


class FeatureFusion(nn.Module):
    """FeatureFusionBlock_custom: the skip input through RCU1 (a block built
    with `skip=False`, the deepest, has none), then RCU2, x2 corner-aligned
    upsample, 1x1 out conv."""

    def __init__(self, features: int, policy: DTypePolicy, skip: bool = True):
        super().__init__()
        if skip:
            self.rcu1 = ResidualConvUnit(features, policy)
        self.rcu2 = ResidualConvUnit(features, policy)
        self.out_conv = Conv(features, features, 1, dtype=policy.compute_dtype)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.rcu1(skip)
        return self.out_conv(_up2(self.rcu2(x)))


class _DPTBase(nn.Module):
    """What both variants share: cls token and position embedding, the ViT
    blocks, the readouts and the decoder from the pyramid to the depth."""

    def _init_vit(self, cfg, policy: DTypePolicy, vit_cfg):
        dim = cfg.hidden_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.pos_grid ** 2 + 1, dim))
        for i in range(cfg.num_layers):
            self.add_module(f"blocks_{i}", ViTBlock(vit_cfg, policy))

    def _init_decoder(self, cfg, policy: DTypePolicy, in_dims):
        dt, f = policy.compute_dtype, cfg.features
        for s, c in enumerate(in_dims):
            self.add_module(f"scratch_rn_{s}", Conv(c, f, 3, padding=1, bias=False, dtype=dt))
        for rn in range(1, 5):
            self.add_module(f"refinenet{rn}", FeatureFusion(f, policy, skip=rn < 4))
        self.head_conv1 = Conv(f, f // 2, 3, padding=1, dtype=dt)
        self.head_conv2 = Conv(f // 2, 32, 3, padding=1, dtype=dt)
        self.head_conv3 = Conv(32, 1, 1, dtype=dt)

    def _embed(self, t, gh, gw):
        """cls token first, then the position embedding with its grid
        resized to (gh, gw): bilinear on the half-pixel grid, no
        antialiasing (`jax.image.resize(..., antialias=False)`), in fp32."""
        cfg = self.config
        pos_cls, grid = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        grid = grid.reshape(1, cfg.pos_grid, cfg.pos_grid, -1).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(gh, gw), mode="bilinear", align_corners=False)
        grid = grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)
        cls = self.cls_token.expand(t.shape[0], 1, -1).to(t.dtype)
        return torch.cat([cls, t], dim=1) + torch.cat([pos_cls, grid], dim=1).to(t.dtype)

    def _vit(self, t):
        taps = []
        for i in range(self.config.num_layers):
            t = getattr(self, f"blocks_{i}")(t)
            if i in self.config.hooks:
                taps.append(t)
        return taps

    def _readout(self, s, tap, gh, gw):
        r = getattr(self, f"readout_{s}")(tap[:, 1:], tap[:, :1])
        r = F.gelu(r, approximate="none")
        # tokens -> an NCHW view of channels_last memory, no copy
        r = r.reshape(r.shape[0], gh, gw, -1).permute(0, 3, 1, 2)
        return getattr(self, f"reassemble_proj_{s}")(r)

    def _decode(self, pyramid):
        f4, f8, f16, f32 = (getattr(self, f"scratch_rn_{s}")(p) for s, p in enumerate(pyramid))
        h = self.refinenet4(f32)
        h = self.refinenet3(h, f16)
        h = self.refinenet2(h, f8)
        h = self.refinenet1(h, f4)
        h = _up2(self.head_conv1(h))
        h = F.relu(self.head_conv3(F.relu(self.head_conv2(h))))
        return h[:, 0].float()


class DPTDepth(_DPTBase):
    """DPT-Large: (B, 3, H, W) in [-1, 1] -> (B, H, W) fp32 relative inverse
    depth (>= 0)."""

    def __init__(self, config: DPTConfig = DPTConfig(), policy: DTypePolicy = default_policy()):
        super().__init__()
        cfg, dt = config, policy.compute_dtype
        self.config, self.compute_dtype = cfg, dt
        p, dim = cfg.patch_size, cfg.hidden_size
        self.patch_embed = Conv(3, dim, p, stride=p, dtype=dt)
        self._init_vit(cfg, policy, cfg)
        for s, c in enumerate(cfg.reassemble_dims):
            self.add_module(f"readout_{s}", _Readout(dim, dt))
            self.add_module(f"reassemble_proj_{s}", Conv(dim, c, 1, dtype=dt))
        # per-stage resample: 4x, 2x (transposed convs), 1x, 0.5x
        dims = cfg.reassemble_dims
        self.resample_0 = ConvTranspose(dims[0], dims[0], 4, stride=4, dtype=dt)
        self.resample_1 = ConvTranspose(dims[1], dims[1], 2, stride=2, dtype=dt)
        self.resample_3 = Conv(dims[3], dims[3], 3, stride=2, padding=1, dtype=dt)
        self._init_decoder(cfg, policy, dims)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, _, hh, ww = img.shape
        gh, gw = hh // cfg.patch_size, ww // cfg.patch_size
        x = self.patch_embed(img.to(self.compute_dtype))
        t = self._embed(x.permute(0, 2, 3, 1).reshape(b, gh * gw, -1), gh, gw)
        pyramid = []
        for s, tap in enumerate(self._vit(t)):
            r = self._readout(s, tap, gh, gw)
            if s in (0, 1, 3):
                r = getattr(self, f"resample_{s}")(r)
            pyramid.append(r)
        return self._decode(pyramid)


# --- DPT-Hybrid (timm vit_base_resnet50_384 backbone) -----------------------


def _same_pad(x, k: int, s: int, value: float = 0.0):
    """TF "SAME" padding of NCHW `x` for a k x k window at stride s: the
    odd pixel goes to the bottom and right."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    if not any(pads):
        return x
    return F.pad(x, pads, value=value).contiguous(memory_format=torch.channels_last)


class StdConv(nn.Module):
    """timm StdConv2dSame: weight standardised per output channel over
    (cin, kh, kw) in fp32 (mean, biased variance, eps 1e-6), cast to the
    activation dtype; TF-SAME padding; no bias."""

    def __init__(self, cin: int, features: int, kernel: int, stride: int = 1, eps: float = 1e-6):
        super().__init__()
        self.kernel, self.stride, self.eps = kernel, stride, eps
        self.weight = nn.Parameter(nn.init.kaiming_normal_(
            torch.empty(features, cin, kernel, kernel)))

    def forward(self, x):
        w = self.weight.float()
        m = w.mean(dim=(1, 2, 3), keepdim=True)
        v = (w - m).square().mean(dim=(1, 2, 3), keepdim=True)
        w = ((w - m) * torch.rsqrt(v + self.eps)).to(x.dtype)
        x = _same_pad(x, self.kernel, self.stride)
        y = F.conv2d(x, w.contiguous(memory_format=torch.channels_last), stride=self.stride)
        return y.contiguous(memory_format=torch.channels_last)


class GNReLU(nn.Module):
    """timm GroupNormAct(32): GroupNorm eps 1e-5 with fp32 statistics and
    affine, then ReLU when `act`; K3 on the card at the sizes
    `group_norm_auto` picks."""

    def __init__(self, channels: int, act: bool = True):
        super().__init__()
        self.act = act
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return group_norm_auto(x, 32, self.weight, self.bias, eps=1e-5, apply_relu=self.act)


def max_pool_same(x):
    """3x3 stride-2 max pool with TF-SAME padding by -inf."""
    return F.max_pool2d(_same_pad(x, 3, 2, value=float("-inf")), 3, 2)


class Bottleneck(nn.Module):
    """timm resnetv2.Bottleneck (preact=False): conv -> GN+ReLU twice, conv
    -> GN, add the shortcut, ReLU. The first block of a stage has the 1x1
    conv -> GN downsample."""

    def __init__(self, cin: int, out_ch: int, stride: int = 1, has_downsample: bool = False):
        super().__init__()
        mid = out_ch // 4
        self.has_downsample = has_downsample
        if has_downsample:
            self.downsample_conv = StdConv(cin, out_ch, 1, stride)
            self.downsample_norm = GNReLU(out_ch, act=False)
        self.conv1 = StdConv(cin, mid, 1)
        self.norm1 = GNReLU(mid)
        self.conv2 = StdConv(mid, mid, 3, stride)
        self.norm2 = GNReLU(mid)
        self.conv3 = StdConv(mid, out_ch, 1)
        self.norm3 = GNReLU(out_ch, act=False)

    def forward(self, x):
        sc = self.downsample_norm(self.downsample_conv(x)) if self.has_downsample else x
        h = self.norm1(self.conv1(x))
        h = self.norm2(self.conv2(h))
        h = self.norm3(self.conv3(h))
        return F.relu(h + sc)


class DPTHybridDepth(_DPTBase):
    """DPT-Hybrid: (B, 3, H, W) in [-1, 1] -> (B, H, W) fp32 relative
    inverse depth (>= 0). ResNetV2 stem (7x7/2 StdConv, GN+ReLU, 3x3/2 SAME
    max pool), stages at strides (1, 2, 2) whose first two outputs are
    pyramid levels 1-2, a 1x1 projection of the stride-16 map to ViT
    tokens, ViT-B blocks, hooks readout-projected to levels 3-4."""

    WIDTHS = (256, 512, 1024)

    def __init__(self, config: DPTHybridConfig = DPTHybridConfig(),
                 policy: DTypePolicy = default_policy()):
        super().__init__()
        cfg, dt = config, policy.compute_dtype
        self.config, self.compute_dtype = cfg, dt
        dim = cfg.hidden_size
        self.stem_conv = StdConv(3, 64, 7, 2)
        self.stem_norm = GNReLU(64)
        cin = 64
        for s, depth in enumerate(cfg.resnet_layers):
            for bi in range(depth):
                stride = (1 if s == 0 else 2) if bi == 0 else 1
                self.add_module(f"stage{s}_block{bi}", Bottleneck(
                    cin, self.WIDTHS[s], stride=stride, has_downsample=bi == 0))
                cin = self.WIDTHS[s]
        self.embed_proj = Conv(cin, dim, 1, dtype=dt)
        vit_cfg = DPTConfig(hidden_size=dim, num_layers=cfg.num_layers,
                            num_heads=cfg.num_heads, mlp_ratio=cfg.mlp_ratio)
        self._init_vit(cfg, policy, vit_cfg)
        for s in (2, 3):
            self.add_module(f"readout_{s}", _Readout(dim, dt))
            self.add_module(f"reassemble_proj_{s}", Conv(dim, cfg.reassemble_dims[s], 1, dtype=dt))
        self.resample_3 = Conv(cfg.reassemble_dims[3], cfg.reassemble_dims[3], 3, stride=2,
                               padding=1, dtype=dt)
        # levels 1-2 are the first two stages' outputs, whatever the config
        self._init_decoder(cfg, policy, self.WIDTHS[:2] + tuple(cfg.reassemble_dims[2:]))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, _, hh, ww = img.shape
        gh, gw = hh // cfg.patch_size, ww // cfg.patch_size
        x = img.to(self.compute_dtype).contiguous(memory_format=torch.channels_last)
        x = max_pool_same(self.stem_norm(self.stem_conv(x)))
        pyramid = []  # levels 1-2: the raw ResNet features
        for s, depth in enumerate(cfg.resnet_layers):
            for bi in range(depth):
                x = getattr(self, f"stage{s}_block{bi}")(x)
            if s < 2:
                pyramid.append(x)
        t = self.embed_proj(x)
        t = self._embed(t.permute(0, 2, 3, 1).reshape(b, gh * gw, -1), gh, gw)
        for s, tap in enumerate(self._vit(t), start=2):
            r = self._readout(s, tap, gh, gw)
            if s == 3:  # level 4: the extra 3x3 stride-2 conv
                r = self.resample_3(r)
            pyramid.append(r)
        return self._decode(pyramid)


def depth_to_normals(depth: torch.Tensor, a: float = 2 * np.pi, bg_th: float = 0.1):
    """MidasDetector's post-processing, batched. depth: (B, H, W) raw
    inverse depth. Returns (depth01 (B, H, W), normals01 (B, H, W, 3)),
    both in [0, 1]: Sobel gradients with zero padding, masked below
    `bg_th` of the normalised depth, z = a, unit length, mapped to [0, 1]."""
    depth = depth.float()
    dmin = depth.amin(dim=(1, 2), keepdim=True)
    dmax = depth.amax(dim=(1, 2), keepdim=True)
    depth01 = (depth - dmin) / torch.clamp_min(dmax - dmin, 1e-8)
    sobel_x = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=torch.float32,
                           device=depth.device)
    kernels = torch.stack([sobel_x, sobel_x.t()])[:, None]  # (2, 1, 3, 3): x, then y
    grads = F.conv2d(depth[:, None], kernels, padding=1) * (depth01 >= bg_th)[:, None]
    gx, gy = grads[:, 0], grads[:, 1]
    normal = torch.stack([gx, gy, torch.full_like(gx, a)], dim=-1)
    normal = normal / torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    return depth01, torch.clamp(normal * 0.5 + 0.5, 0.0, 1.0)


def convt_kernel(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d weight (in, out, kh, kw) -> Flax ConvTranspose
    kernel (kh, kw, in, out) with a spatial flip (Flax's transposed conv
    does not reverse the spatial axes; torch's does). Its inverse is
    `tools/jax_bridge.py`'s rule for transposed-conv kernels."""
    return np.ascontiguousarray(np.asarray(w).transpose(2, 3, 0, 1)[::-1, ::-1])


def _load(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)


def _vit_keys(sd, num_layers: int) -> Dict[str, torch.Tensor]:
    out = {"cls_token": sd["pretrained.model.cls_token"],
           "pos_embed": sd["pretrained.model.pos_embed"]}
    for i in range(num_layers):
        t = f"pretrained.model.blocks.{i}"
        for name, src in (("norm1", "norm1"), ("norm2", "norm2"), ("qkv", "attn.qkv"),
                          ("proj", "attn.proj"), ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            for leaf in ("weight", "bias"):
                out[f"blocks_{i}.{name}.{leaf}"] = sd[f"{t}.{src}.{leaf}"]
    return out


def _decoder_keys(sd) -> Dict[str, torch.Tensor]:
    out = {f"scratch_rn_{s}.weight": sd[f"scratch.layer{s + 1}_rn.weight"] for s in range(4)}
    for rn in range(1, 5):
        t = f"scratch.refinenet{rn}"
        # refinenet4 takes no skip input: its resConfUnit1 is never run
        units = (("rcu1", "resConfUnit1"),) * (rn < 4) + (("rcu2", "resConfUnit2"),)
        for unit, src in units:
            for conv in ("conv1", "conv2"):
                for leaf in ("weight", "bias"):
                    out[f"refinenet{rn}.{unit}.{conv}.{leaf}"] = sd[f"{t}.{src}.{conv}.{leaf}"]
        for leaf in ("weight", "bias"):
            out[f"refinenet{rn}.out_conv.{leaf}"] = sd[f"{t}.out_conv.{leaf}"]
    for i, src in ((1, 0), (2, 2), (3, 4)):
        for leaf in ("weight", "bias"):
            out[f"head_conv{i}.{leaf}"] = sd[f"scratch.output_conv.{src}.{leaf}"]
    return out


def _readout_keys(sd, stages) -> Dict[str, torch.Tensor]:
    out = {}
    for s in stages:
        act = f"pretrained.act_postprocess{s + 1}"
        for leaf in ("weight", "bias"):
            out[f"readout_{s}.{leaf}"] = sd[f"{act}.0.project.0.{leaf}"]
            out[f"reassemble_proj_{s}.{leaf}"] = sd[f"{act}.3.{leaf}"]
    return out


def import_dpt_checkpoint(path: str, cfg: DPTConfig = DPTConfig()) -> Dict[str, torch.Tensor]:
    """Official dpt_large-midas or dpt_hybrid-midas checkpoint -> the state
    dict of `DPTDepth(cfg)` or of `DPTHybridDepth()` (the variant sniffed
    from the backbone's key scheme). torch layouts carry over as they are,
    transposed-conv weights included."""
    sd = _load(path)
    if "pretrained.model.patch_embed.backbone.stem.conv.weight" in sd:
        return _import_dpt_hybrid(sd)
    out = {"patch_embed.weight": sd["pretrained.model.patch_embed.proj.weight"],
           "patch_embed.bias": sd["pretrained.model.patch_embed.proj.bias"],
           **_vit_keys(sd, cfg.num_layers), **_readout_keys(sd, range(4)), **_decoder_keys(sd)}
    for s in (0, 1, 3):
        for leaf in ("weight", "bias"):
            out[f"resample_{s}.{leaf}"] = sd[f"pretrained.act_postprocess{s + 1}.4.{leaf}"]
    return out


def _import_dpt_hybrid(sd, cfg: DPTHybridConfig = DPTHybridConfig()) -> Dict[str, torch.Tensor]:
    """dpt_hybrid-midas key scheme: the timm vit_base_resnet50_384 backbone
    under `pretrained.model.patch_embed.backbone.{stem,stages.S.blocks.B}`,
    ViT-B blocks, `act_postprocess{3,4}` and the `scratch` decoder."""
    bb = "pretrained.model.patch_embed.backbone"
    out = {"stem_conv.weight": sd[f"{bb}.stem.conv.weight"],
           "stem_norm.weight": sd[f"{bb}.stem.norm.weight"],
           "stem_norm.bias": sd[f"{bb}.stem.norm.bias"],
           "embed_proj.weight": sd["pretrained.model.patch_embed.proj.weight"],
           "embed_proj.bias": sd["pretrained.model.patch_embed.proj.bias"]}
    for s, depth in enumerate(cfg.resnet_layers):
        for bi in range(depth):
            t, blk = f"{bb}.stages.{s}.blocks.{bi}", f"stage{s}_block{bi}"
            names = [(f"conv{i}", f"conv{i}") for i in (1, 2, 3)]
            names += [(f"norm{i}", f"norm{i}") for i in (1, 2, 3)]
            if bi == 0:
                names += [("downsample_conv", "downsample.conv"),
                          ("downsample_norm", "downsample.norm")]
            for name, src in names:
                leaves = ("weight",) if "conv" in name else ("weight", "bias")
                for leaf in leaves:
                    out[f"{blk}.{name}.{leaf}"] = sd[f"{t}.{src}.{leaf}"]
    out.update(_vit_keys(sd, cfg.num_layers))
    out.update(_readout_keys(sd, (2, 3)))
    for leaf in ("weight", "bias"):
        out[f"resample_3.{leaf}"] = sd[f"pretrained.act_postprocess4.4.{leaf}"]
    out.update(_decoder_keys(sd))
    return out


def create_dpt(path: str, device="cuda", policy: DTypePolicy = default_policy()) -> nn.Module:
    """The model of a MiDaS checkpoint, weights loaded, in eval mode on
    `device`: `DPTHybridDepth` for the dpt_hybrid key scheme (the
    ecosystem's default file), `DPTDepth` for dpt_large."""
    sd = import_dpt_checkpoint(path)
    with torch.device(device):
        model = (DPTHybridDepth if "stem_conv.weight" in sd else DPTDepth)(policy=policy)
    model.load_state_dict(sd, strict=True)
    return model.eval().requires_grad_(False)
