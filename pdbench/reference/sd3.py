"""Plain fp32 SD3 MMDiT, its Prompt-Diffusion ControlNet and the support
pair's down projection (diffusers' SD3Transformer2DModel and
JointTransformerBlock; stabilityai/stable-diffusion-3-medium-diffusers
transformer/config.json), with the parameter names of the port's modules.

The sites that the port's int8 policy quantizes are the JointBlocks' q, k,
v, output and feed-forward denses (`site=True`); their inputs come from the
AdaLN (per row), the tanh-GELU (per row) and the attention output (per row),
and the attention itself is the port's K9 (Q per row and head, K per
sample and head). The embedders, AdaLN projections, ControlNet taps and the
output head stay float.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pdbench.reference.common import (
    Conv,
    Linear,
    attention,
    int8_attention,
    layer_norm,
    quant_rows,
    timestep_embedding,
)


def _sincos(dim: int, pos: np.ndarray) -> np.ndarray:
    omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def pos_table(dim: int, grid: int, base: int, gh: int, gw: int) -> np.ndarray:
    """The (gh * gw, dim) centre crop of the fixed 2-D sin-cos table over a
    grid² of positions scaled by base / grid (diffusers'
    get_2d_sincos_pos_embed)."""
    coords = np.arange(grid, dtype=np.float64) / (grid / base)
    top, left = (grid - gh) // 2, (grid - gw) // 2
    gy, gx = np.meshgrid(coords[top:top + gh], coords[left:left + gw], indexing="ij")
    return np.concatenate([_sincos(dim // 2, gx), _sincos(dim // 2, gy)],
                          axis=1).astype(np.float32)


def hidden_size(cfg: dict) -> int:
    return cfg["num_attention_heads"] * cfg["attention_head_dim"]


class PatchEmbed(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        p = cfg["patch_size"]
        self.proj = Conv(cfg["in_channels"], hidden_size(cfg), p, stride=p)

    def forward(self, x):
        cfg = self.cfg
        x = self.proj(x)
        b, d, gh, gw = x.shape
        pos = pos_table(d, cfg["pos_embed_max_size"], cfg["sample_size"] // cfg["patch_size"],
                        gh, gw)
        return x.permute(0, 2, 3, 1).reshape(b, gh * gw, d) + torch.from_numpy(pos).to(x.device)


class TimestepTextEmbed(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d = hidden_size(cfg)
        self.timestep_fc1, self.timestep_fc2 = Linear(256, d), Linear(d, d)
        self.text_fc1, self.text_fc2 = Linear(cfg["pooled_projection_dim"], d), Linear(d, d)

    def forward(self, t, pooled):
        te = self.timestep_fc2(F.silu(self.timestep_fc1(timestep_embedding(t, 256))))
        return te + self.text_fc2(F.silu(self.text_fc1(pooled)))


class AdaLayerNormZero(nn.Module):
    def __init__(self, dim: int, n: int = 6):
        super().__init__()
        self.n = n
        self.proj = Linear(dim, n * dim)

    def forward(self, x, emb, bits):
        mods = self.proj(F.silu(emb))[:, None, :].chunk(self.n, dim=-1)
        if self.n == 6:
            shift, scale, gate, shift_mlp, scale_mlp, gate_mlp = mods
            return (modulate(x, scale, shift, bits), gate, shift_mlp, scale_mlp, gate_mlp)
        scale, shift = mods
        return modulate(x, scale, shift, bits)


def modulate(x, scale, shift, bits):
    """LN (no affine, eps 1e-6) * (1 + scale) + shift; the port's K13 site."""
    return quant_rows(layer_norm(x, eps=1e-6) * (1 + scale) + shift, bits)


class JointBlock(nn.Module):
    def __init__(self, cfg: dict, pre_only: bool):
        super().__init__()
        dim = hidden_size(cfg)
        self.heads, self.head_dim, self.pre_only = (cfg["num_attention_heads"],
                                                    cfg["attention_head_dim"], pre_only)
        self.norm1 = AdaLayerNormZero(dim)
        self.norm1_context = AdaLayerNormZero(dim, 2 if pre_only else 6)
        for name in ("to_q", "add_q_proj", "to_k", "add_k_proj", "to_v", "add_v_proj", "to_out"):
            self.add_module(name, Linear(dim, dim, site=True))
        self.ff_in = Linear(dim, 4 * dim, site=True)
        self.ff_out = Linear(4 * dim, dim, site=True)
        if not pre_only:
            self.to_add_out = Linear(dim, dim, site=True)
            self.ff_context_in = Linear(dim, 4 * dim, site=True)
            self.ff_context_out = Linear(4 * dim, dim, site=True)

    def forward(self, hidden, context, emb):
        bits = self.to_q.mode.site_bits
        h_mod, h_gate, h_shift, h_scale, h_gate_mlp = self.norm1(hidden, emb, bits)
        if self.pre_only:
            c_mod = self.norm1_context(context, emb, bits)
        else:
            c_mod, c_gate, c_shift, c_scale, c_gate_mlp = self.norm1_context(context, emb, bits)
        n_h = hidden.shape[1]
        q = torch.cat([self.to_q(h_mod), self.add_q_proj(c_mod)], dim=1)
        k = torch.cat([self.to_k(h_mod), self.add_k_proj(c_mod)], dim=1)
        v = torch.cat([self.to_v(h_mod), self.add_v_proj(c_mod)], dim=1)
        scale = self.head_dim ** -0.5
        if bits is not None:
            attn = int8_attention(q, k, v, self.heads, bits, scale)
        else:
            split = lambda t: t.unflatten(-1, (self.heads, self.head_dim))
            attn = attention(split(q), split(k), split(v), scale).flatten(-2)
        act = lambda t: quant_rows(F.gelu(t, approximate="tanh"), bits)
        hidden = hidden + h_gate * self.to_out(quant_rows(attn[:, :n_h], bits))
        hn = modulate(hidden, h_scale, h_shift, bits)
        hidden = hidden + h_gate_mlp * self.ff_out(act(self.ff_in(hn)))
        if self.pre_only:
            return hidden, None
        context = context + c_gate * self.to_add_out(quant_rows(attn[:, n_h:], bits))
        cn = modulate(context, c_scale, c_shift, bits)
        context = context + c_gate_mlp * self.ff_context_out(act(self.ff_context_in(cn)))
        return hidden, context


class MMDiT(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        d = hidden_size(cfg)
        self.pos_embed = PatchEmbed(cfg)
        self.time_text_embed = TimestepTextEmbed(cfg)
        self.context_embedder = Linear(cfg["joint_attention_dim"], cfg["caption_projection_dim"])
        for i in range(cfg["num_layers"]):
            self.add_module(f"blocks_{i}", JointBlock(cfg, i == cfg["num_layers"] - 1))
        self.norm_out_proj = Linear(d, 2 * d)
        self.proj_out = Linear(d, cfg["patch_size"] ** 2 * cfg["out_channels"])

    def forward(self, x, t, ctx, pooled, control):
        cfg, p = self.cfg, self.cfg["patch_size"]
        b, _, h, w = x.shape
        hidden = self.pos_embed(x)
        emb = self.time_text_embed(t, pooled)
        context = self.context_embedder(ctx)
        n = cfg["num_layers"]
        for i in range(n):
            hidden, context = getattr(self, f"blocks_{i}")(hidden, context, emb)
            if i != n - 1:
                hidden = hidden + control[int(i / (n / len(control)))]
        scale, shift = self.norm_out_proj(F.silu(emb))[:, None, :].chunk(2, dim=-1)
        out = self.proj_out(layer_norm(hidden, eps=1e-6) * (1 + scale) + shift)
        gh, gw, c = h // p, w // p, cfg["out_channels"]
        out = out.reshape(b, gh, gw, p, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
        return out.permute(0, 3, 1, 2)


class ControlNet(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        d = hidden_size(cfg)
        self.pos_embed = PatchEmbed(cfg)
        self.time_text_embed = TimestepTextEmbed(cfg)
        self.context_embedder = Linear(cfg["joint_attention_dim"], cfg["caption_projection_dim"])
        self.pos_embed_input = Conv(cfg["in_channels"], d, cfg["patch_size"],
                                    stride=cfg["patch_size"])
        for i in range(cfg["num_layers"]):
            self.add_module(f"blocks_{i}", JointBlock(cfg, False))
            self.add_module(f"controlnet_blocks_{i}", Linear(d, d))

    def forward(self, x, t, cond, pair, ctx, pooled, scale: float = 1.0):
        hidden = self.pos_embed(x)
        emb = self.time_text_embed(t, pooled)
        context = self.context_embedder(ctx)

        def patchify(z):
            out = self.pos_embed_input(z)
            return out.permute(0, 2, 3, 1).reshape(out.shape[0], -1, out.shape[1])

        hidden = hidden + patchify(cond) + patchify(pair)
        taps = []
        for i in range(self.cfg["num_layers"]):
            hidden, context = getattr(self, f"blocks_{i}")(hidden, context, emb)
            taps.append(getattr(self, f"controlnet_blocks_{i}")(hidden) * scale)
        return taps


class SupportPairDownProj(nn.Module):
    def __init__(self, cfg=None):
        super().__init__()
        self.down_proj = Conv(6, 3, 3, padding=1)

    def forward(self, cond, gt):
        return self.down_proj(torch.cat([cond, gt], dim=1))
