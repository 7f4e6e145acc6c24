"""UniFormer-S + UperNet ADE20k semantic segmentation, as PyTorch modules.

Counterpart of `prompt_diffusion_tpu/annotators/uniformer.py`, with its
names (so the weight bridge is mechanical):

  * the UniFormer-S backbone: 4 stages, embed dims (64, 128, 320, 512),
    depths (3, 4, 8, 3), head dim 64; a patch-embed conv (4, 2, 2, 2) and
    LayerNorm (eps 1e-5) opens each stage; stages 1-2 are convolutional
    `CBlock`s (depthwise 3x3 position conv, BN -> 1x1 -> depthwise 5x5 ->
    1x1, BN -> conv MLP), stages 3-4 `SABlock`s (depthwise position conv,
    then a pre-LN transformer block on the tokens); each stage's output
    through a LayerNorm (eps 1e-6);
  * the UperNet head: pyramid pooling (1, 2, 3, 6) on the last stage, FPN
    lateral and top-down fusion, 3x3 FPN convs, concat -> bottleneck -> the
    150-class 1x1 classifier in fp32; a ConvModule is conv (no bias) + BN
    with inference statistics + ReLU;
  * the ADE20k palette render.

Modules take NCHW tensors in channels_last memory, so a stage's tokens are
a view of its activation. Kernels on this path: the SABlocks' pre-LNs
through K4 (`FusedLayerNorm`, at `layer_norm_auto`'s sizes) and their
attention through K1 at N >= 512 tokens (stage 3 at 512²: 1024 tokens, 5
heads of 64); under `quant="int8"` their denses are `QuantDense`, the
pre-LNs K6 and the attention K9 - on the card only, as the JAX package
takes them off a CPU backend. Stage 4 (256 tokens at 512²) runs the plain
attention. One decision differs from the JAX package: the logits are
upsampled to the input size in fp32 (JAX: in the compute dtype), so a
bf16 rounding of the logits moves no argmax.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from prompt_diffusion_tpu_torch.annotators.midas import (
    _same_pad,
    _vit_attention,
    _vit_dense,
    vit_norm,
)
from prompt_diffusion_tpu_torch.models.layers import Conv, FusedLayerNorm
from prompt_diffusion_tpu_torch.ops.resize import resize_bilinear
from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy, default_policy

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


@dataclasses.dataclass(frozen=True)
class UniFormerConfig:
    embed_dims: Tuple[int, ...] = (64, 128, 320, 512)
    depths: Tuple[int, ...] = (3, 4, 8, 3)
    head_dim: int = 64
    mlp_ratio: int = 4
    num_classes: int = 150
    decode_channels: int = 512
    pool_scales: Tuple[int, ...] = (1, 2, 3, 6)


class InferenceBN(nn.Module):
    """BatchNorm in inference mode: (x - mean) * rsqrt(var + 1e-5) * weight
    + bias in fp32, the result in x's dtype. The running statistics are
    buffers named `mean` and `var`."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x):
        col = lambda t: t.view(1, -1, 1, 1)
        y = (x.float() - col(self.mean)) * col(torch.rsqrt(self.var + 1e-5))
        return (y * col(self.weight) + col(self.bias)).to(x.dtype)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channels of an NCHW tensor (Flax `nn.LayerNorm`
    on NHWC), in fp32, the result in x's dtype."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        y = F.layer_norm(x.permute(0, 2, 3, 1).float(), (x.shape[1],), self.weight, self.bias,
                         self.eps)
        return y.to(x.dtype).permute(0, 3, 1, 2)


def _dwconv(dim: int, kernel: int, dtype: torch.dtype) -> Conv:
    return Conv(dim, dim, kernel, padding=kernel // 2, groups=dim, dtype=dtype)


class CBlock(nn.Module):
    """Convolutional block of stages 1-2."""

    def __init__(self, dim: int, policy: DTypePolicy):
        super().__init__()
        dt = policy.compute_dtype
        self.pos_embed = _dwconv(dim, 3, dt)
        self.norm1 = InferenceBN(dim)
        self.conv1 = Conv(dim, dim, 1, dtype=dt)
        self.attn = _dwconv(dim, 5, dt)
        self.conv2 = Conv(dim, dim, 1, dtype=dt)
        self.norm2 = InferenceBN(dim)
        self.mlp_fc1 = Conv(dim, 4 * dim, 1, dtype=dt)
        self.mlp_fc2 = Conv(4 * dim, dim, 1, dtype=dt)

    def forward(self, x):
        x = x + self.pos_embed(x)
        x = x + self.conv2(self.attn(self.conv1(self.norm1(x))))
        h = F.gelu(self.mlp_fc1(self.norm2(x)), approximate="none")
        return x + self.mlp_fc2(h)


class SABlock(nn.Module):
    """Self-attention block of stages 3-4: the depthwise position conv on
    the map, then a pre-LN transformer block on its H*W tokens."""

    def __init__(self, dim: int, num_heads: int, policy: DTypePolicy):
        super().__init__()
        dense = _vit_dense(policy)
        self.num_heads, self.quant = num_heads, policy.quant == "int8"
        self.pos_embed = _dwconv(dim, 3, policy.compute_dtype)
        self.norm1 = FusedLayerNorm(dim, eps=1e-6)
        self.qkv = dense(dim, 3 * dim)
        self.proj = dense(dim, dim)
        self.norm2 = FusedLayerNorm(dim, eps=1e-6)
        self.mlp_fc1 = dense(dim, 4 * dim)
        self.mlp_fc2 = dense(4 * dim, dim)

    def forward(self, x):
        x = x + self.pos_embed(x)
        b, c, h, w = x.shape
        t = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        attn = _vit_attention(self.qkv(vit_norm(self.norm1, t, self.quant)), self.num_heads,
                              self.quant)
        t = t + self.proj(attn)
        hn = F.gelu(self.mlp_fc1(vit_norm(self.norm2, t, self.quant)), approximate="none")
        t = t + self.mlp_fc2(hn)
        return t.reshape(b, h, w, c).permute(0, 3, 1, 2)


class UniFormerBackbone(nn.Module):
    def __init__(self, config: UniFormerConfig = UniFormerConfig(),
                 policy: DTypePolicy = default_policy()):
        super().__init__()
        cfg, dt = config, policy.compute_dtype
        self.config = cfg
        cin = 3
        for s, (dim, depth) in enumerate(zip(cfg.embed_dims, cfg.depths), start=1):
            p = 4 if s == 1 else 2
            self.add_module(f"patch_embed{s}", Conv(cin, dim, p, stride=p, dtype=dt))
            self.add_module(f"patch_norm{s}", ChannelLayerNorm(dim, 1e-5))
            for i in range(depth):
                blk = (CBlock(dim, policy) if s <= 2 else
                       SABlock(dim, dim // cfg.head_dim, policy))
                self.add_module(f"blocks{s}_{i}", blk)
            self.add_module(f"norm{s}", ChannelLayerNorm(dim, 1e-6))
            cin = dim

    def forward(self, x):
        outs = []
        for s, depth in enumerate(self.config.depths, start=1):
            p = 4 if s == 1 else 2
            # Flax's default SAME padding: nothing where p divides the size
            x = getattr(self, f"patch_embed{s}")(_same_pad(x, p, p))
            x = getattr(self, f"patch_norm{s}")(x)
            for i in range(depth):
                x = getattr(self, f"blocks{s}_{i}")(x)
            outs.append(getattr(self, f"norm{s}")(x))
        return outs


class ConvModule(nn.Module):
    """conv (no bias) -> BN (inference statistics) -> ReLU."""

    def __init__(self, cin: int, features: int, kernel: int, policy: DTypePolicy):
        super().__init__()
        self.conv = Conv(cin, features, kernel, padding=kernel // 2, bias=False,
                         dtype=policy.compute_dtype)
        self.bn = InferenceBN(features)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class UPerHead(nn.Module):
    def __init__(self, config: UniFormerConfig, policy: DTypePolicy):
        super().__init__()
        cfg, ch = config, config.decode_channels
        self.config = cfg
        c4 = cfg.embed_dims[-1]
        for si in range(len(cfg.pool_scales)):
            self.add_module(f"psp_{si}", ConvModule(c4, ch, 1, policy))
        self.psp_bottleneck = ConvModule(c4 + len(cfg.pool_scales) * ch, ch, 3, policy)
        for i in range(3):
            self.add_module(f"lateral_{i}", ConvModule(cfg.embed_dims[i], ch, 1, policy))
            self.add_module(f"fpn_{i}", ConvModule(ch, ch, 3, policy))
        self.fpn_bottleneck = ConvModule(4 * ch, ch, 3, policy)
        self.conv_seg = Conv(ch, cfg.num_classes, 1, dtype=torch.float32)

    def forward(self, feats):
        f4 = feats[-1]
        h4, w4 = f4.shape[-2:]
        psp = [f4]
        for si, scale in enumerate(self.config.pool_scales):
            pooled = getattr(self, f"psp_{si}")(F.adaptive_avg_pool2d(f4, scale))
            psp.append(resize_bilinear(pooled, h4, w4))
        laterals = [getattr(self, f"lateral_{i}")(feats[i]) for i in range(3)]
        laterals.append(self.psp_bottleneck(torch.cat(psp, dim=1)))
        for i in range(2, -1, -1):
            laterals[i] = laterals[i] + resize_bilinear(laterals[i + 1], *laterals[i].shape[-2:])
        outs = [getattr(self, f"fpn_{i}")(laterals[i]) for i in range(3)] + [laterals[3]]
        outs = [resize_bilinear(f, *outs[0].shape[-2:]) for f in outs]
        return self.conv_seg(self.fpn_bottleneck(torch.cat(outs, dim=1)))  # fp32, (B, K, H/4, W/4)


class UniFormerSeg(nn.Module):
    """(B, 3, H, W) RGB in [0, 255] -> (B, classes, H, W) fp32 logits."""

    def __init__(self, config: UniFormerConfig = UniFormerConfig(),
                 policy: DTypePolicy = default_policy()):
        super().__init__()
        self.config, self.compute_dtype = config, policy.compute_dtype
        self.backbone = UniFormerBackbone(config, policy)
        self.decode_head = UPerHead(config, policy)

    def head_logits(self, images: torch.Tensor) -> torch.Tensor:
        """The classifier's fp32 logits at a quarter of the input size."""
        mean = torch.tensor(IMAGENET_MEAN, device=images.device).view(1, 3, 1, 1)
        std = torch.tensor(IMAGENET_STD, device=images.device).view(1, 3, 1, 1)
        x = ((images.float() - mean) / std).to(self.compute_dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        return self.decode_head(self.backbone(x))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return resize_bilinear(self.head_logits(images), *images.shape[-2:])


def ade_palette() -> np.ndarray:
    """The standard ADE20K 150-class palette (a public dataset constant)."""
    return np.asarray([
        [120, 120, 120], [180, 120, 120], [6, 230, 230], [80, 50, 50],
        [4, 200, 3], [120, 120, 80], [140, 140, 140], [204, 5, 255],
        [230, 230, 230], [4, 250, 7], [224, 5, 255], [235, 255, 7],
        [150, 5, 61], [120, 120, 70], [8, 255, 51], [255, 6, 82],
        [143, 255, 140], [204, 255, 4], [255, 51, 7], [204, 70, 3],
        [0, 102, 200], [61, 230, 250], [255, 6, 51], [11, 102, 255],
        [255, 7, 71], [255, 9, 224], [9, 7, 230], [220, 220, 220],
        [255, 9, 92], [112, 9, 255], [8, 255, 214], [7, 255, 224],
        [255, 184, 6], [10, 255, 71], [255, 41, 10], [7, 255, 255],
        [224, 255, 8], [102, 8, 255], [255, 61, 6], [255, 194, 7],
        [255, 122, 8], [0, 255, 20], [255, 8, 41], [255, 5, 153],
        [6, 51, 255], [235, 12, 255], [160, 150, 20], [0, 163, 255],
        [140, 140, 140], [250, 10, 15], [20, 255, 0], [31, 255, 0],
        [255, 31, 0], [255, 224, 0], [153, 255, 0], [0, 0, 255],
        [255, 71, 0], [0, 235, 255], [0, 173, 255], [31, 0, 255],
        [11, 200, 200], [255, 82, 0], [0, 255, 245], [0, 61, 255],
        [0, 255, 112], [0, 255, 133], [255, 0, 0], [255, 163, 0],
        [255, 102, 0], [194, 255, 0], [0, 143, 255], [51, 255, 0],
        [0, 82, 255], [0, 255, 41], [0, 255, 173], [10, 0, 255],
        [173, 255, 0], [0, 255, 153], [255, 92, 0], [255, 0, 255],
        [255, 0, 245], [255, 0, 102], [255, 173, 0], [255, 0, 20],
        [255, 184, 184], [0, 31, 255], [0, 255, 61], [0, 71, 255],
        [255, 0, 204], [0, 255, 194], [0, 255, 82], [0, 10, 255],
        [0, 112, 255], [51, 0, 255], [0, 194, 255], [0, 122, 255],
        [0, 255, 163], [255, 153, 0], [0, 255, 10], [255, 112, 0],
        [143, 255, 0], [82, 0, 255], [163, 255, 0], [255, 235, 0],
        [8, 184, 170], [133, 0, 255], [0, 255, 92], [184, 0, 255],
        [255, 0, 31], [0, 184, 255], [0, 214, 255], [255, 0, 112],
        [92, 255, 0], [0, 224, 255], [112, 224, 255], [70, 184, 160],
        [163, 0, 255], [153, 0, 255], [71, 255, 0], [255, 0, 163],
        [255, 204, 0], [255, 0, 143], [0, 255, 235], [133, 255, 0],
        [255, 0, 235], [245, 0, 255], [255, 0, 122], [255, 245, 0],
        [10, 190, 212], [214, 255, 0], [0, 204, 255], [20, 0, 255],
        [255, 255, 0], [0, 153, 255], [0, 41, 255], [0, 255, 204],
        [41, 0, 255], [41, 255, 0], [173, 0, 255], [0, 245, 255],
        [71, 0, 255], [122, 0, 255], [0, 255, 184], [0, 92, 255],
        [184, 255, 0], [0, 133, 255], [255, 214, 0], [25, 194, 194],
        [102, 255, 0], [92, 0, 255],
    ], dtype=np.uint8)


def colorize_segmentation(class_map) -> np.ndarray:
    """(B, H, W) integer class ids (numpy or a tensor) -> (B, H, W, 3)
    uint8 ADE-palette render, the detector's conditioning image."""
    if torch.is_tensor(class_map):
        class_map = class_map.cpu().numpy()
    return ade_palette()[np.asarray(class_map)]


# (port module, mmseg module) of the BN, LayerNorm and conv leaves
_BN_LEAVES = (("weight", "weight"), ("bias", "bias"), ("mean", "running_mean"),
              ("var", "running_var"))
_WB = (("weight", "weight"), ("bias", "bias"))


def _backbone_keys(cfg: UniFormerConfig):
    """(port key, mmseg key) pairs of the backbone, without the port's and
    with mmseg's `backbone.` prefix."""
    pairs = []

    def add(port, ref, leaves=_WB):
        pairs.extend((f"{port}.{a}", f"backbone.{ref}.{b}") for a, b in leaves)

    for s in range(1, 5):
        add(f"patch_embed{s}", f"patch_embed{s}.proj")
        add(f"patch_norm{s}", f"patch_embed{s}.norm")
        add(f"norm{s}", f"norm{s}")
        for i in range(cfg.depths[s - 1]):
            t, blk = f"blocks{s}.{i}", f"blocks{s}_{i}"
            add(f"{blk}.pos_embed", f"{t}.pos_embed")
            norm_leaves = _BN_LEAVES if s <= 2 else _WB
            add(f"{blk}.norm1", f"{t}.norm1", norm_leaves)
            add(f"{blk}.norm2", f"{t}.norm2", norm_leaves)
            names = (("conv1", "conv1"), ("conv2", "conv2"), ("attn", "attn")) if s <= 2 else \
                (("qkv", "attn.qkv"), ("proj", "attn.proj"))
            for port, ref in names + (("mlp_fc1", "mlp.fc1"), ("mlp_fc2", "mlp.fc2")):
                add(f"{blk}.{port}", f"{t}.{ref}")
    return pairs


def _head_keys(cfg: UniFormerConfig):
    """(port key, mmseg key) pairs of the decode head, both prefixed."""
    pairs = []

    def convmodule(port, ref):
        pairs.append((f"decode_head.{port}.conv.weight", f"decode_head.{ref}.conv.weight"))
        pairs.extend((f"decode_head.{port}.bn.{a}", f"decode_head.{ref}.bn.{b}")
                     for a, b in _BN_LEAVES)

    for si in range(len(cfg.pool_scales)):
        convmodule(f"psp_{si}", f"psp_modules.{si}.1")
    convmodule("psp_bottleneck", "bottleneck")
    for i in range(3):
        convmodule(f"lateral_{i}", f"lateral_convs.{i}")
        convmodule(f"fpn_{i}", f"fpn_convs.{i}")
    convmodule("fpn_bottleneck", "fpn_bottleneck")
    pairs.extend((f"decode_head.conv_seg.{a}", f"decode_head.conv_seg.{a}")
                 for a in ("weight", "bias"))
    return pairs


def import_uniformer_backbone(sd: Dict[str, torch.Tensor],
                              cfg: UniFormerConfig = UniFormerConfig()
                              ) -> Dict[str, torch.Tensor]:
    """The backbone slice of an mmseg state dict (`backbone.` prefixes) ->
    the state dict of `UniFormerBackbone` (torch layouts carry over)."""
    return {port: sd[ref] for port, ref in _backbone_keys(cfg)}


def import_uniformer_checkpoint(path: str, cfg: UniFormerConfig = UniFormerConfig()
                                ) -> Dict[str, torch.Tensor]:
    """upernet_global_small.pth (mmseg format, a `state_dict` entry or the
    bare dict) -> the state dict of `UniFormerSeg(cfg)`."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    sd = raw.get("state_dict", raw)
    out = {f"backbone.{k}": v for k, v in import_uniformer_backbone(sd, cfg).items()}
    out.update({port: sd[ref] for port, ref in _head_keys(cfg)})
    return out


def export_uniformer_checkpoint(model: UniFormerSeg) -> Dict[str, dict]:
    """The inverse of `import_uniformer_checkpoint`: {"state_dict": mmseg
    keys -> fp32 CPU tensors} of a `UniFormerSeg`."""
    sd = {k: v.detach().float().cpu() for k, v in model.state_dict().items()}
    pairs = [(f"backbone.{p}", r) for p, r in _backbone_keys(model.config)]
    return {"state_dict": {ref: sd[port] for port, ref in pairs + _head_keys(model.config)}}


def create_uniformer(path: str, device="cuda", policy: DTypePolicy = default_policy(),
                     config: UniFormerConfig = UniFormerConfig()) -> UniFormerSeg:
    """`UniFormerSeg` with the weights of `path`, in eval mode on `device`."""
    with torch.device(device):
        model = UniFormerSeg(config, policy)
    model.load_state_dict(import_uniformer_checkpoint(path, config), strict=True)
    return model.eval().requires_grad_(False)
