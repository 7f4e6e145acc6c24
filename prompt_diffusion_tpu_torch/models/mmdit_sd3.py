"""SD3 MMDiT transformer (the flow-matching backbone), for the PyTorch port.

Counterpart of `prompt_diffusion_tpu/models/mmdit_sd3.py` (diffusers'
`SD3Transformer2DModel` + `JointTransformerBlock`):
  * PatchEmbed: 2x2 patchify conv + the fixed sin-cos position table,
    center-cropped from a `pos_embed_max_size` grid;
  * TimestepTextEmbed: sinusoidal t-embedding -> MLP, plus the pooled
    CLIP projection -> MLP, summed;
  * JointBlock: dual-stream (image tokens || context tokens) attention with
    AdaLayerNormZero modulation; the last block is context_pre_only;
  * AdaLayerNormContinuous + a linear head back to patches.
Latents cross the models' API as NCHW (channels_last memory, like the
SD1.5 slice); tokens are (B, N, C). Attribute names follow the Flax
parameter names.

Under a policy with `quant="int8"` (the W8A8 serving mode) the block's
projections and feed-forwards are `QuantDense`s, and every float input of
them arrives as an (int8, per-row scale) pair from a kernel: the AdaLN and
norm2 sites from K13 (`fused_adaln_quant`), `ff_out` from K10
(`fused_gelu_quant`), `to_out` and `to_add_out` from K11
(`fused_quant_rows`) on the split attention output. The AdaLN projections,
the embedders, the ControlNet taps and the output head stay in the compute
dtype, as in the JAX package. Under tensor parallelism
(`parallel/tensor_parallel.py::apply_tp`) `JointBlock.tp_group` is the
tensor group, which K10 and K11 take: the rows they quantize are the
rank's slices of rows whose scale spans the group.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from prompt_diffusion_tpu_torch.models.layers import Conv, Dense, _int8, timestep_embedding
from prompt_diffusion_tpu_torch.ops.attention import dot_product_attention
from prompt_diffusion_tpu_torch.ops.flash_attention import flash_attention_packed_int8
from prompt_diffusion_tpu_torch.ops.fused_act import fused_gelu_quant, fused_quant_rows
from prompt_diffusion_tpu_torch.ops.fused_adaln import fused_adaln_quant
from prompt_diffusion_tpu_torch.ops.quant import QuantDense
from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy, default_policy


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    """SD3-medium defaults (sample 128 -> 1024² pixels)."""

    sample_size: int = 128
    patch_size: int = 2
    in_channels: int = 16
    num_layers: int = 24
    attention_head_dim: int = 64
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096  # T5/CLIP joint text width
    caption_projection_dim: int = 1536  # = heads * head_dim
    pooled_projection_dim: int = 2048
    out_channels: int = 16
    pos_embed_max_size: int = 192

    @property
    def hidden_size(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


def _1d_sincos(dim: int, pos: np.ndarray) -> np.ndarray:
    omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def _cropped_pos_embed(dim: int, grid: int, base_size: int, gh: int, gw: int) -> np.ndarray:
    """The (gh * gw, dim) center crop of the fixed 2D sin-cos position
    table (grid², dim) that `prompt_diffusion_tpu/models/mmdit_sd3.py`'s
    `_2d_sincos_pos_embed` builds as diffusers' `get_2d_sincos_pos_embed`
    does (positions scaled by base_size / grid), computed for the cropped
    positions only with the same float64 arithmetic per entry, so the same
    fp32 values."""
    coords = np.arange(grid, dtype=np.float64) / (grid / base_size)
    top, left = (grid - gh) // 2, (grid - gw) // 2
    gy, gx = np.meshgrid(coords[top:top + gh], coords[left:left + gw], indexing="ij")
    emb = np.concatenate([_1d_sincos(dim // 2, gx), _1d_sincos(dim // 2, gy)], axis=1)
    return emb.astype(np.float32)


class PatchEmbed(nn.Module):
    """2x2 patchify conv + the center-cropped fixed sin-cos position table."""

    def __init__(self, cfg: MMDiTConfig, policy: DTypePolicy):
        super().__init__()
        p = cfg.patch_size
        self.cfg = cfg
        self.proj = Conv(cfg.in_channels, cfg.hidden_size, p, stride=p, dtype=policy.compute_dtype)
        self._pos = {}  # (gh, gw, device, dtype) -> (1, N, D) table, kept on the device

    def forward(self, x):  # (B, C, H, W) -> (B, N, D)
        cfg = self.cfg
        x = self.proj(x)
        b, d, gh, gw = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, gh * gw, d)
        key = (gh, gw, x.device, x.dtype)
        if key not in self._pos:
            pos = _cropped_pos_embed(d, cfg.pos_embed_max_size,
                                     cfg.sample_size // cfg.patch_size, gh, gw)
            self._pos[key] = torch.from_numpy(pos).to(device=x.device, dtype=x.dtype)[None]
        return x + self._pos[key]


class TimestepTextEmbed(nn.Module):
    """CombinedTimestepTextProjEmbeddings: sinusoidal(256) -> MLP, plus
    pooled -> MLP, summed."""

    def __init__(self, cfg: MMDiTConfig, policy: DTypePolicy):
        super().__init__()
        dt, d = policy.compute_dtype, cfg.hidden_size
        self.compute_dtype = dt
        self.timestep_fc1 = Dense(256, d, dtype=dt)
        self.timestep_fc2 = Dense(d, d, dtype=dt)
        self.text_fc1 = Dense(cfg.pooled_projection_dim, d, dtype=dt)
        self.text_fc2 = Dense(d, d, dtype=dt)

    def forward(self, timestep, pooled):
        t_emb = timestep_embedding(timestep, 256).to(self.compute_dtype)
        t = self.timestep_fc2(F.silu(self.timestep_fc1(t_emb)))
        c = self.text_fc2(F.silu(self.text_fc1(pooled.to(self.compute_dtype))))
        return t + c


def _layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without affine, fp32 statistics, back in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _modulate(x, scale, shift, quant: bool):
    """LN(no affine) * (1 + scale) + shift; under int8 the K13 pair."""
    if quant:
        return fused_adaln_quant(x, scale, shift)
    return _layer_norm(x) * (1 + scale) + shift


class AdaLayerNormZero(nn.Module):
    """LN (no affine) + n-way modulation from the conditioning embedding.
    Six ways: (shift, scale, gate, shift_mlp, scale_mlp, gate_mlp), the
    modulated x first; two ways (AdaLayerNormContinuous of the last
    block's context): (scale, shift)."""

    def __init__(self, dim: int, policy: DTypePolicy, n_mods: int = 6):
        super().__init__()
        self.n_mods, self.quant = n_mods, _int8(policy)
        self.proj = Dense(dim, n_mods * dim, dtype=policy.compute_dtype)

    def forward(self, x, emb):
        mods = self.proj(F.silu(emb))[:, None, :].chunk(self.n_mods, dim=-1)
        if self.n_mods == 6:
            shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mods
            return (_modulate(x, scale_msa, shift_msa, self.quant), gate_msa, shift_mlp,
                    scale_mlp, gate_mlp)
        scale, shift = mods
        return _modulate(x, scale, shift, self.quant)


class JointBlock(nn.Module):
    """Dual-stream joint attention block (diffusers JointTransformerBlock)."""

    def __init__(self, cfg: MMDiTConfig, policy: DTypePolicy, context_pre_only: bool = False):
        super().__init__()
        dim, dt = cfg.hidden_size, policy.compute_dtype
        self.heads, self.head_dim = cfg.num_attention_heads, cfg.attention_head_dim
        self.context_pre_only, self.quant = context_pre_only, _int8(policy)
        self.tp_group = None  # the tensor group, once `apply_tp` has split the block
        if self.quant:
            dense = lambda i, o: QuantDense(i, o, out_dtype=dt)
        else:
            dense = lambda i, o: Dense(i, o, dtype=dt)
        self.norm1 = AdaLayerNormZero(dim, policy)
        self.norm1_context = AdaLayerNormZero(dim, policy, 2 if context_pre_only else 6)
        for name in ("to_q", "add_q_proj", "to_k", "add_k_proj", "to_v", "add_v_proj", "to_out"):
            self.add_module(name, dense(dim, dim))
        self.ff_in = dense(dim, 4 * dim)
        self.ff_out = dense(4 * dim, dim)
        if not context_pre_only:
            self.to_add_out = dense(dim, dim)
            self.ff_context_in = dense(dim, 4 * dim)
            self.ff_context_out = dense(4 * dim, dim)

    def attention(self, q, k, v):
        """Joint attention over packed (B, N, H*D) tensors. int8 policy on
        the card: K9, as `mmdit_sd3.py:214` of the JAX package takes its
        int8 kernel off a CPU backend; on the CPU the exact attention, as
        the JAX package computes it there. That is the reference's own
        rule, not a fallback: a CUDA tensor always launches K9. The bf16
        policy takes `dot_product_attention` (K2 at these lengths)."""
        if self.quant and q.is_cuda:
            return flash_attention_packed_int8(q, k, v, self.heads)
        split = lambda t: t.unflatten(-1, (self.heads, self.head_dim))
        return dot_product_attention(split(q), split(k), split(v)).flatten(-2)

    def forward(self, hidden, context, emb):
        h_mod, h_gate, h_shift_mlp, h_scale_mlp, h_gate_mlp = self.norm1(hidden, emb)
        if self.context_pre_only:
            c_mod = self.norm1_context(context, emb)
        else:
            c_mod, c_gate, c_shift_mlp, c_scale_mlp, c_gate_mlp = self.norm1_context(context, emb)
        n_h = hidden.shape[1]
        # int8: h_mod / c_mod are K13 pairs, quantized once for q, k and v
        qp = torch.cat([self.to_q(h_mod), self.add_q_proj(c_mod)], dim=1)
        kp = torch.cat([self.to_k(h_mod), self.add_k_proj(c_mod)], dim=1)
        vp = torch.cat([self.to_v(h_mod), self.add_v_proj(c_mod)], dim=1)
        attn = self.attention(qp, kp, vp)
        attn_h, attn_c = attn[:, :n_h], attn[:, n_h:]
        if self.quant:  # the inputs of the row-sharded layers under tensor parallelism
            act = functools.partial(fused_gelu_quant, group=self.tp_group)
            rowq = functools.partial(fused_quant_rows, group=self.tp_group)
        else:
            act, rowq = (lambda x: F.gelu(x, approximate="tanh")), (lambda x: x)

        hidden = hidden + h_gate * self.to_out(rowq(attn_h))
        hn = _modulate(hidden, h_scale_mlp, h_shift_mlp, self.quant)
        hidden = hidden + h_gate_mlp * self.ff_out(act(self.ff_in(hn)))
        if self.context_pre_only:
            return hidden, None
        context = context + c_gate * self.to_add_out(rowq(attn_c))
        cn = _modulate(context, c_scale_mlp, c_shift_mlp, self.quant)
        context = context + c_gate_mlp * self.ff_context_out(act(self.ff_context_in(cn)))
        return hidden, context


class SD3Transformer(nn.Module):
    """The MMDiT velocity model. Takes optional per-block ControlNet
    residuals (token space), added after every block but the last at the
    float-interval index of diffusers' SD3Transformer2DModel."""

    def __init__(self, config: MMDiTConfig = MMDiTConfig(),
                 policy: DTypePolicy = default_policy()):
        super().__init__()
        cfg, dt = config, policy.compute_dtype
        self.config, self.compute_dtype = cfg, dt
        self.pos_embed = PatchEmbed(cfg, policy)
        self.time_text_embed = TimestepTextEmbed(cfg, policy)
        self.context_embedder = Dense(cfg.joint_attention_dim, cfg.caption_projection_dim,
                                      dtype=dt)
        for i in range(cfg.num_layers):
            self.add_module(f"blocks_{i}", JointBlock(cfg, policy,
                                                      context_pre_only=i == cfg.num_layers - 1))
        self.norm_out_proj = Dense(cfg.hidden_size, 2 * cfg.hidden_size, dtype=dt)
        self.proj_out = Dense(cfg.hidden_size, cfg.patch_size ** 2 * cfg.out_channels, dtype=dt)

    def forward(self, latents: torch.Tensor, timestep: torch.Tensor,
                encoder_hidden_states: torch.Tensor, pooled_projections: torch.Tensor,
                block_controlnet_hidden_states: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        """latents (B, C, H, W), timestep (B,) float, encoder_hidden_states
        (B, L, joint_attention_dim), pooled (B, pooled_projection_dim) ->
        velocity (B, C_out, H, W) fp32 in channels_last memory."""
        cfg, p = self.config, self.config.patch_size
        b, _, h, w = latents.shape
        hidden = self.pos_embed(latents.to(self.compute_dtype))
        emb = self.time_text_embed(timestep, pooled_projections)
        context = self.context_embedder(encoder_hidden_states.to(self.compute_dtype))
        control = block_controlnet_hidden_states
        for i in range(cfg.num_layers):
            pre_only = i == cfg.num_layers - 1
            hidden, context = getattr(self, f"blocks_{i}")(hidden, context, emb)
            if control is not None and not pre_only:
                # float interval and int() truncation, as diffusers does it
                interval = cfg.num_layers / len(control)
                hidden = hidden + control[int(i / interval)].to(hidden.dtype)
        # AdaLayerNormContinuous head, (scale, shift) chunk order
        scale, shift = self.norm_out_proj(F.silu(emb))[:, None, :].chunk(2, dim=-1)
        hidden = _layer_norm(hidden).to(self.compute_dtype) * (1 + scale) + shift
        out = self.proj_out(hidden)
        gh, gw = h // p, w // p
        out = out.reshape(b, gh, gw, p, p, cfg.out_channels).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(b, h, w, cfg.out_channels).float().permute(0, 3, 1, 2)
