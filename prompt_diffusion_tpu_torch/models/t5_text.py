"""T5 encoder stack (SD3's third text encoder, T5-XXL), for the PyTorch port.

Counterpart of `prompt_diffusion_tpu/models/t5_text.py`: pre-RMSNorm
blocks, a relative position bias from one bucket table (layer 0's, reused
by every layer), attention without the 1/sqrt(d) scale (T5 folds it into
its weights), a gated tanh-GELU feed-forward, no biases anywhere, a final
RMSNorm. Attribute names follow the Flax parameter names
(`blocks_0.attn.relative_attention_bias`, `blocks_3.wi_0`, ...).

L = 256 tokens at most on the SD3 path; the JAX package computes the
attention with einsum, outside any Pallas kernel, and so does this module,
in plain PyTorch with fp32 logits and softmax.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from prompt_diffusion_tpu_torch.models.layers import Dense
from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy, default_policy


@dataclasses.dataclass(frozen=True)
class T5Config:
    """Defaults = T5-XXL (google/t5-v1_1-xxl) as used by SD3."""

    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * weight, in fp32, back in x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32))

    def forward(self, x):
        xf = x.float()
        normed = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        return (normed * self.weight).to(x.dtype)


def _relative_position_bucket(relative_position: torch.Tensor, num_buckets: int = 32,
                              max_distance: int = 128) -> torch.Tensor:
    """T5's bidirectional relative-position bucketing, in the JAX package's
    arithmetic: an fp32 log, fp32 scaling and a truncating int32 cast, so
    the integer buckets are the same."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int32) * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    log_ratio = torch.log(n.float() / max_exact + 1e-6)
    denom = torch.full_like(log_ratio, math.log(max_distance / max_exact))  # rounded to fp32
    val_if_large = max_exact + (log_ratio / denom * (num_buckets - max_exact)).to(torch.int32)
    val_if_large = torch.clamp_max(val_if_large, num_buckets - 1)
    return ret + torch.where(is_small, n.to(torch.int32), val_if_large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, policy: DTypePolicy, has_relative_bias: bool = False):
        super().__init__()
        dt = policy.compute_dtype
        inner = cfg.num_heads * cfg.d_kv
        self.cfg = cfg
        for name, (i, o) in (("q", (cfg.d_model, inner)), ("k", (cfg.d_model, inner)),
                             ("v", (cfg.d_model, inner)), ("o", (inner, cfg.d_model))):
            self.add_module(name, Dense(i, o, bias=False, dtype=dt))
        if has_relative_bias:
            self.relative_attention_bias = nn.Parameter(torch.zeros(
                cfg.relative_attention_num_buckets, cfg.num_heads, dtype=torch.float32))
        else:
            self.relative_attention_bias = None

    def position_bias(self, length: int) -> torch.Tensor:
        """(1, H, L, L) fp32 bias from the bucket table. The buckets are
        computed on the host, so they do not depend on the device's log."""
        cfg = self.cfg
        pos = torch.arange(length)
        buckets = _relative_position_bucket(pos[None, :] - pos[:, None],  # key - query
                                            cfg.relative_attention_num_buckets,
                                            cfg.relative_attention_max_distance)
        table = self.relative_attention_bias
        return table[buckets.long().to(table.device)].permute(2, 0, 1)[None]

    def forward(self, x, position_bias=None):
        b, n, _ = x.shape
        split = lambda t: t.view(b, n, self.cfg.num_heads, self.cfg.d_kv).transpose(1, 2)
        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        if self.relative_attention_bias is not None:
            position_bias = self.position_bias(n)
        # no 1/sqrt(d) scale
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + position_bias
        probs = torch.softmax(logits, dim=-1)
        out = torch.matmul(probs.to(v.dtype).float(), v.float()).to(v.dtype)
        return self.o(out.transpose(1, 2).reshape(b, n, -1)), position_bias


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, policy: DTypePolicy, has_relative_bias: bool = False):
        super().__init__()
        dt = policy.compute_dtype
        self.ln_attn = RMSNorm(cfg.d_model, cfg.layer_norm_eps)
        self.attn = T5Attention(cfg, policy, has_relative_bias)
        self.ln_ff = RMSNorm(cfg.d_model, cfg.layer_norm_eps)
        self.wi_0 = Dense(cfg.d_model, cfg.d_ff, bias=False, dtype=dt)
        self.wi_1 = Dense(cfg.d_model, cfg.d_ff, bias=False, dtype=dt)
        self.wo = Dense(cfg.d_ff, cfg.d_model, bias=False, dtype=dt)

    def forward(self, x, position_bias=None):
        attn_out, position_bias = self.attn(self.ln_attn(x), position_bias)
        x = x + attn_out
        h = self.ln_ff(x)
        ff = self.wo(F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h))
        return x + ff, position_bias


class T5Encoder(nn.Module):
    def __init__(self, config: T5Config = T5Config(), policy: DTypePolicy = default_policy()):
        super().__init__()
        self.config = config
        self.token_embedding = nn.Embedding(config.vocab_size, config.d_model,
                                            dtype=policy.compute_dtype)
        for i in range(config.num_layers):
            self.add_module(f"blocks_{i}", T5Block(config, policy, has_relative_bias=i == 0))
        self.final_norm = RMSNorm(config.d_model, config.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids (B, L) -> hidden states (B, L, d_model), fp32."""
        x = self.token_embedding(input_ids)
        position_bias = None
        for i in range(self.config.num_layers):
            x, position_bias = getattr(self, f"blocks_{i}")(x, position_bias)
        return self.final_norm(x).float()
