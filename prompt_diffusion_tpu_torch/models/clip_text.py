"""CLIP text encoders (SD1.5's conditioning, SD3's first two), for the
PyTorch port.

Counterpart of `prompt_diffusion_tpu/models/clip_text.py`: by default
CLIP ViT-L/14 (12 layers, hidden 768, 12 heads, quick-gelu MLP); with
`activation="gelu"` (exact erf) and its widths, SD3's OpenCLIP bigG.
Causal mask, 77 positions, final LayerNorm. `output_hidden_layer=k` also
returns the input of layer `num_layers - k` ("hidden", the penultimate
state SD3 reads at k = 2). 77 tokens are far below the flash kernel's
threshold, so attention is the plain fp32-softmax path and the LayerNorms
are the plain fp32 version, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from prompt_diffusion_tpu_torch.models.layers import Dense
from prompt_diffusion_tpu_torch.ops.attention import dot_product_attention
from prompt_diffusion_tpu_torch.ops.fused_layer_norm import _torch_layer_norm
from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy, default_policy


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_positions: int = 77
    layer_norm_eps: float = 1e-5
    # "quick_gelu" for CLIP-L (SD1.5); "gelu" (exact erf) for OpenCLIP bigG (SD3)
    activation: str = "quick_gelu"
    eot_token_id: int = 49407


class LayerNorm(nn.Module):
    """LayerNorm computed and returned in fp32 (Flax `nn.LayerNorm` with an
    fp32 `dtype`)."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32))

    def forward(self, x):
        return _torch_layer_norm(x.float(), self.weight, self.bias, self.eps)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, policy: DTypePolicy):
        super().__init__()
        dt = policy.compute_dtype
        self.heads = cfg.num_heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Dense(cfg.hidden_size, cfg.hidden_size, dtype=dt))

    def forward(self, x, causal_mask):
        split = lambda t: t.unflatten(-1, (self.heads, -1))
        out = dot_product_attention(split(self.q_proj(x)), split(self.k_proj(x)),
                                    split(self.v_proj(x)), mask=causal_mask, use_flash=False)
        return self.out_proj(out.flatten(-2))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, policy: DTypePolicy):
        super().__init__()
        dt = policy.compute_dtype
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg, policy)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.fc1 = Dense(cfg.hidden_size, cfg.intermediate_size, dtype=dt)
        self.fc2 = Dense(cfg.intermediate_size, cfg.hidden_size, dtype=dt)
        self.activation = cfg.activation

    def forward(self, x, causal_mask):
        x = x + self.self_attn(self.layer_norm1(x).to(x.dtype), causal_mask)
        h = self.fc1(self.layer_norm2(x).to(x.dtype))
        if self.activation == "quick_gelu":
            h = h * torch.sigmoid(1.702 * h)
        else:
            h = F.gelu(h)
        return x + self.fc2(h)


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig = CLIPTextConfig(),
                 policy: DTypePolicy = default_policy()):
        super().__init__()
        self.config = config
        dt = policy.compute_dtype
        self.token_embedding = nn.Embedding(config.vocab_size, config.hidden_size, dtype=dt)
        self.position_embedding = nn.Parameter(
            torch.zeros(config.max_positions, config.hidden_size, dtype=dt))
        for i in range(config.num_layers):
            self.add_module(f"layers_{i}", CLIPEncoderLayer(config, policy))
        self.final_layer_norm = LayerNorm(config.hidden_size, config.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor,
                output_hidden_layer: Optional[int] = None) -> dict:
        """input_ids (B, L) -> dict(last_hidden_state (B, L, D) fp32,
        pooled (B, D) fp32: the state at the first end-of-text token,
        hidden: the input of layer num_layers - output_hidden_layer, fp32,
        or None when `output_hidden_layer` is None)."""
        cfg = self.config
        b, n = input_ids.shape
        x = self.token_embedding(input_ids) + self.position_embedding[None, :n]
        causal = torch.ones(n, n, dtype=torch.bool, device=input_ids.device).tril()
        hidden = None
        for i in range(cfg.num_layers):
            if output_hidden_layer is not None and i == cfg.num_layers - output_hidden_layer:
                hidden = x.float()
            x = getattr(self, f"layers_{i}")(x, causal)
        final = self.final_layer_norm(x)
        eot_idx = (input_ids == cfg.eot_token_id).int().argmax(dim=-1)
        pooled = final[torch.arange(b, device=final.device), eot_idx]
        return {"last_hidden_state": final, "pooled": pooled, "hidden": hidden}
