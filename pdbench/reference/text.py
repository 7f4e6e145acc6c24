"""Plain fp32 text encoders with the parameter names of the port's modules:
CLIP (ViT-L/14's, quick-GELU; OpenCLIP bigG's with exact GELU) and the
T5-v1.1 encoder stack (pre-RMSNorm, one relative-position bucket table,
gated tanh-GELU feed-forward, no biases, no 1/sqrt(d) scale)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from pdbench.reference.common import Linear, attention, layer_norm


class _Affine(nn.Module):
    """A LayerNorm's fp32 weight and bias."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (Linear(dim, dim)
                                                                for _ in range(4))

    def forward(self, x, mask):
        split = lambda t: t.unflatten(-1, (self.heads, -1))
        q = split(self.q_proj(x))
        out = attention(q, split(self.k_proj(x)), split(self.v_proj(x)),
                        q.shape[-1] ** -0.5, mask)
        return self.out_proj(out.flatten(-2))


class CLIPLayer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["hidden_size"]
        self.eps, self.act = cfg["layer_norm_eps"], cfg["activation"]
        self.layer_norm1 = _Affine(d)
        self.self_attn = CLIPAttention(d, cfg["num_heads"])
        self.layer_norm2 = _Affine(d)
        self.fc1 = Linear(d, cfg["intermediate_size"])
        self.fc2 = Linear(cfg["intermediate_size"], d)

    def forward(self, x, mask):
        ln = lambda m, t: layer_norm(t, m.weight, m.bias, self.eps)
        x = x + self.self_attn(ln(self.layer_norm1, x), mask)
        h = self.fc1(ln(self.layer_norm2, x))
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return x + self.fc2(h)


class CLIPText(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        d = cfg["hidden_size"]
        self.token_embedding = nn.Embedding(cfg["vocab_size"], d)
        self.position_embedding = nn.Parameter(torch.empty(cfg["max_positions"], d))
        for i in range(cfg["num_layers"]):
            self.add_module(f"layers_{i}", CLIPLayer(cfg))
        self.final_layer_norm = _Affine(d)

    def forward(self, ids, hidden_layer=None):
        """ids (B, L) -> (final states, pooled at the first EOT, the input
        of layer num_layers - hidden_layer or None)."""
        cfg = self.cfg
        b, n = ids.shape
        x = self.token_embedding(ids) + self.position_embedding[None, :n]
        mask = torch.ones(n, n, dtype=torch.bool, device=ids.device).tril()
        hidden = None
        for i in range(cfg["num_layers"]):
            if hidden_layer is not None and i == cfg["num_layers"] - hidden_layer:
                hidden = x
            x = getattr(self, f"layers_{i}")(x, mask)
        final = layer_norm(x, self.final_layer_norm.weight, self.final_layer_norm.bias,
                           cfg["layer_norm_eps"])
        eot = (ids == cfg["eot_token_id"]).int().argmax(dim=-1)
        return final, final[torch.arange(b, device=ids.device), eot], hidden


class _RMS(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.eps = eps

    def forward(self, x):
        return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + self.eps) * self.weight


def relative_buckets(n: int, num_buckets: int, max_distance: int) -> torch.Tensor:
    """T5's bidirectional buckets of key - query, (n, n) int64, with the
    port's fp32 log and truncating cast."""
    pos = torch.arange(n)
    rel = pos[None, :] - pos[:, None]
    half = num_buckets // 2
    ret = (rel > 0).to(torch.int32) * half
    a = rel.abs()
    exact = half // 2
    log_ratio = torch.log(a.float() / exact + 1e-6)
    denom = torch.full_like(log_ratio, math.log(max_distance / exact))
    large = exact + (log_ratio / denom * (half - exact)).to(torch.int32)
    large = torch.clamp_max(large, half - 1)
    return (ret + torch.where(a < exact, a.to(torch.int32), large)).long()


class T5Attention(nn.Module):
    def __init__(self, cfg: dict, has_bias: bool):
        super().__init__()
        inner = cfg["num_heads"] * cfg["d_kv"]
        self.cfg = cfg
        self.q = Linear(cfg["d_model"], inner, bias=False)
        self.k = Linear(cfg["d_model"], inner, bias=False)
        self.v = Linear(cfg["d_model"], inner, bias=False)
        self.o = Linear(inner, cfg["d_model"], bias=False)
        self.relative_attention_bias = (nn.Parameter(torch.empty(
            cfg["relative_attention_num_buckets"], cfg["num_heads"])) if has_bias else None)

    def forward(self, x, bias):
        b, n, _ = x.shape
        cfg = self.cfg
        split = lambda t: t.view(b, n, cfg["num_heads"], cfg["d_kv"]).transpose(1, 2)
        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        if self.relative_attention_bias is not None:
            idx = relative_buckets(n, cfg["relative_attention_num_buckets"],
                                   cfg["relative_attention_max_distance"])
            bias = self.relative_attention_bias[idx.to(x.device)].permute(2, 0, 1)[None]
        probs = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) + bias, dim=-1)
        return self.o(torch.matmul(probs, v).transpose(1, 2).reshape(b, n, -1)), bias


class T5Block(nn.Module):
    def __init__(self, cfg: dict, has_bias: bool):
        super().__init__()
        d, eps = cfg["d_model"], cfg["layer_norm_eps"]
        self.ln_attn = _RMS(d, eps)
        self.attn = T5Attention(cfg, has_bias)
        self.ln_ff = _RMS(d, eps)
        self.wi_0 = Linear(d, cfg["d_ff"], bias=False)
        self.wi_1 = Linear(d, cfg["d_ff"], bias=False)
        self.wo = Linear(cfg["d_ff"], d, bias=False)

    def forward(self, x, bias):
        a, bias = self.attn(self.ln_attn(x), bias)
        x = x + a
        h = self.ln_ff(x)
        return x + self.wo(F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h)), bias


class T5Encoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg["vocab_size"], cfg["d_model"])
        for i in range(cfg["num_layers"]):
            self.add_module(f"blocks_{i}", T5Block(cfg, i == 0))
        self.final_norm = _RMS(cfg["d_model"], cfg["layer_norm_eps"])

    def forward(self, ids):
        x, bias = self.token_embedding(ids), None
        for i in range(self.cfg["num_layers"]):
            x, bias = getattr(self, f"blocks_{i}")(x, bias)
        return self.final_norm(x)
