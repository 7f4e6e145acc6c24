"""Plain fp32 SD1.5 UNet, ControlNet and hint encoders (models/cldm_v15.yaml),
with the parameter names of the port's modules, so that `weights.fill_`
gives both the same values.

NCHW tensors throughout. The sites that the port's int8 policy quantizes
are marked `site=True` (convs and denses of the ResBlocks, Down/Upsample
and transformers; the input conv) and the norms that feed them
`quant_out=True` (codes per sample after a ResBlock's or transformer's
GroupNorm, per row after a LayerNorm and the GEGLU); the time embedding,
the hint encoders, the zero convs and the output head stay float.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pdbench.reference.common import (
    Conv,
    GroupNorm,
    LayerNorm,
    Linear,
    attention,
    quant_rows,
    timestep_embedding,
)


class TimeEmbedMLP(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.fc1, self.fc2 = Linear(cin, dim), Linear(dim, dim)

    def forward(self, t):
        return self.fc2(F.silu(self.fc1(t)))


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, emb_dim: int):
        super().__init__()
        self.in_norm = GroupNorm(cin, silu=True, quant_out=True)
        self.in_conv = Conv(cin, cout, 3, padding=1, site=True)
        self.emb_proj = Linear(emb_dim, cout)
        self.out_norm = GroupNorm(cout, silu=True, quant_out=True)
        self.out_conv = Conv(cout, cout, 3, padding=1, site=True)
        self.skip = Conv(cin, cout, 1, site=True) if cin != cout else None

    def forward(self, x, emb):
        h = self.in_conv(self.in_norm(x))
        h = self.out_norm(h + self.emb_proj(F.silu(emb))[:, :, None, None])
        h = self.out_conv(h)
        return (x if self.skip is None else self.skip(x)) + h


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv(ch, ch, 3, stride=2, padding=1, site=True)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv(ch, ch, 3, padding=1, site=True)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(dim, inner, bias=False, site=True, pre_scale=dim_head ** -0.5)
        self.to_k = Linear(context_dim, inner, bias=False, site=True)
        self.to_v = Linear(context_dim, inner, bias=False, site=True)
        self.to_out = Linear(inner, dim, site=True)

    def forward(self, x, context=None):
        context = x if context is None else context
        split = lambda t: t.unflatten(-1, (self.heads, self.dim_head))
        out = attention(split(self.to_q(x)), split(self.to_k(context)),
                        split(self.to_v(context)), 1.0)
        return self.to_out(out.flatten(-2))


class GEGLUFeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.proj = Linear(dim, dim * mult * 2, site=True)
        self.out = Linear(dim * mult, dim, site=True)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return self.out(quant_rows(h * F.gelu(gate), self.out.mode.site_bits))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, quant_out=True)
        self.attn1 = CrossAttention(dim, dim, heads, dim_head)
        self.norm2 = LayerNorm(dim, quant_out=True)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm3 = LayerNorm(dim, quant_out=True)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context=context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    def __init__(self, ch: int, context_dim: int, heads: int, depth: int):
        super().__init__()
        self.depth = depth
        self.norm = GroupNorm(ch, eps=1e-6, quant_out=True)
        self.proj_in = Conv(ch, ch, 1, site=True)
        for d in range(depth):
            self.add_module(f"block_{d}", BasicTransformerBlock(ch, context_dim, heads,
                                                                ch // heads))
        self.proj_out = Conv(ch, ch, 1, site=True)

    def forward(self, x, context):
        b, c, h, w = x.shape
        t = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for d in range(self.depth):
            t = getattr(self, f"block_{d}")(t, context)
        return self.proj_out(t.reshape(b, h, w, c).permute(0, 3, 1, 2)) + x


def encoder_plan(cfg: dict):
    """('conv'|'res'|'down', out_ch, has_attn) per input block, the channel
    count after each, the bottleneck width and the final downsampling."""
    mc = cfg["model_channels"]
    plan, chans, ch, ds = [("conv", mc, False)], [mc], mc, 1
    for level, mult in enumerate(cfg["channel_mult"]):
        for _ in range(cfg["num_res_blocks"]):
            ch = mult * mc
            plan.append(("res", ch, ds in cfg["attention_resolutions"]))
            chans.append(ch)
        if level != len(cfg["channel_mult"]) - 1:
            plan.append(("down", ch, False))
            chans.append(ch)
            ds *= 2
    return plan, chans, ch, ds


def _transformer(cfg, ch):
    return SpatialTransformer(ch, cfg["context_dim"], cfg["num_heads"], cfg["transformer_depth"])


def build_encoder(m: nn.Module, cfg: dict):
    mc = cfg["model_channels"]
    m.time_embed = TimeEmbedMLP(mc, 4 * mc)
    plan, _, mid, _ = encoder_plan(cfg)
    cur = cfg["in_channels"]
    for i, (kind, out, attn) in enumerate(plan):
        if kind == "conv":
            m.add_module(f"input_blocks_{i}_conv", Conv(cur, out, 3, padding=1, site=True))
        elif kind == "res":
            m.add_module(f"input_blocks_{i}_res", ResBlock(cur, out, 4 * mc))
            if attn:
                m.add_module(f"input_blocks_{i}_attn", _transformer(cfg, out))
        else:
            m.add_module(f"input_blocks_{i}_down", Downsample(cur))
        cur = out
    m.middle_block_0 = ResBlock(mid, mid, 4 * mc)
    m.middle_block_1 = _transformer(cfg, mid)
    m.middle_block_2 = ResBlock(mid, mid, 4 * mc)
    return plan


def run_encoder_block(m, i, kind, attn, h, emb, ctx):
    if kind == "conv":
        return getattr(m, f"input_blocks_{i}_conv")(h)
    if kind == "res":
        h = getattr(m, f"input_blocks_{i}_res")(h, emb)
        return getattr(m, f"input_blocks_{i}_attn")(h, ctx) if attn else h
    return getattr(m, f"input_blocks_{i}_down")(h)


def run_middle(m, h, emb, ctx):
    return m.middle_block_2(m.middle_block_1(m.middle_block_0(h, emb), ctx), emb)


class UNet(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        mc = cfg["model_channels"]
        self.plan = build_encoder(self, cfg)
        _, skips, cur, ds = encoder_plan(cfg)
        skips = list(skips)
        self.dec = []
        for level, mult in reversed(list(enumerate(cfg["channel_mult"]))):
            for j in range(cfg["num_res_blocks"] + 1):
                up = level > 0 and j == cfg["num_res_blocks"]
                self.dec.append((mult * mc, ds in cfg["attention_resolutions"], up))
                if up:
                    ds //= 2
        for i, (out, attn, up) in enumerate(self.dec):
            self.add_module(f"output_blocks_{i}_res", ResBlock(cur + skips.pop(), out, 4 * mc))
            if attn:
                self.add_module(f"output_blocks_{i}_attn", _transformer(cfg, out))
            if up:
                self.add_module(f"output_blocks_{i}_up", Upsample(out))
            cur = out
        self.out_norm = GroupNorm(cur, silu=True)
        self.out_conv = Conv(cur, cfg["out_channels"], 3, padding=1)

    def forward(self, x, t, ctx, control):
        emb = self.time_embed(timestep_embedding(t, self.cfg["model_channels"]))
        hs, h = [], x
        for i, (kind, _, attn) in enumerate(self.plan):
            h = run_encoder_block(self, i, kind, attn, h, emb, ctx)
            hs.append(h)
        h = run_middle(self, h, emb, ctx)
        ctrl = list(control)
        h = h + ctrl.pop()
        for i, (_, attn, up) in enumerate(self.dec):
            h = getattr(self, f"output_blocks_{i}_res")(
                torch.cat([h, hs.pop() + ctrl.pop()], dim=1), emb)
            if attn:
                h = getattr(self, f"output_blocks_{i}_attn")(h, ctx)
            if up:
                h = getattr(self, f"output_blocks_{i}_up")(h)
        return self.out_conv(self.out_norm(h))


class HintEncoder(nn.Module):
    WIDTHS = ((16, 1), (16, 1), (32, 2), (32, 1), (96, 2), (96, 1), (256, 2))

    def __init__(self, cin: int, mc: int):
        super().__init__()
        cur = cin
        for i, (w, s) in enumerate(self.WIDTHS):
            self.add_module(f"conv_{i}", Conv(cur, w, 3, stride=s, padding=1))
            cur = w
        self.conv_out = Conv(cur, mc, 3, padding=1)

    def forward(self, x):
        for i in range(len(self.WIDTHS)):
            x = F.silu(getattr(self, f"conv_{i}")(x))
        return self.conv_out(x)


class ControlNet(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        mc = cfg["model_channels"]
        self.input_hint_block = HintEncoder(cfg["hint_channels"], mc)
        self.input_cond_block = HintEncoder(3, mc)
        self.plan = build_encoder(self, cfg)
        for i, (_, out, _) in enumerate(self.plan):
            self.add_module(f"zero_convs_{i}", Conv(out, out, 1))
        mid = encoder_plan(cfg)[2]
        self.middle_block_out = Conv(mid, mid, 1)

    def hint(self, pair, query):
        return self.input_hint_block(pair) + self.input_cond_block(query)

    def forward(self, x, t, ctx, hint, scale: float = 1.0):
        emb = self.time_embed(timestep_embedding(t, self.cfg["model_channels"]))
        outs, h = [], x
        for i, (kind, _, attn) in enumerate(self.plan):
            h = run_encoder_block(self, i, kind, attn, h, emb, ctx)
            if kind == "conv":
                h = h + hint
            outs.append(getattr(self, f"zero_convs_{i}")(h))
        outs.append(self.middle_block_out(run_middle(self, h, emb, ctx)))
        return [o * scale for o in outs]
