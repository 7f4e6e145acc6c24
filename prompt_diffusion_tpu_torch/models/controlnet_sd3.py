"""SD3 Prompt-Diffusion ControlNet, for the PyTorch port.

Counterpart of `prompt_diffusion_tpu/models/controlnet_sd3.py` (the
reference's `SD3PromptDiffusionModel`):
  * `pos_embed` (patchify + sin-cos table) on the noisy latents;
  * `pos_embed_input` (a 2x2 patchify conv, zero-initialised, no table),
    one module applied to both the query condition latent and the support
    pair latent, summed into the stream;
  * 12 JointBlocks (none context_pre_only), each followed by a Dense tap
    (zero-initialised), the taps scaled by `conditioning_scale`;
  * `SupportPairDownProj`: the 3x3 conv mixing the 6-channel pixel-space
    support pair (condition || image) down to 3 channels before the VAE
    encodes it.
Latents are NCHW (channels_last memory); the taps are (B, N, C) tokens.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from prompt_diffusion_tpu_torch.models.layers import Conv, Dense
from prompt_diffusion_tpu_torch.models.mmdit_sd3 import (
    JointBlock,
    MMDiTConfig,
    PatchEmbed,
    TimestepTextEmbed,
)
from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy, default_policy


class SD3ControlNet(nn.Module):
    """Returns the tuple of per-block control residuals (token space)."""

    def __init__(self, config: MMDiTConfig = MMDiTConfig(num_layers=12),
                 policy: DTypePolicy = default_policy()):
        super().__init__()
        cfg, dt = config, policy.compute_dtype
        self.config, self.compute_dtype = cfg, dt
        self.pos_embed = PatchEmbed(cfg, policy)
        self.time_text_embed = TimestepTextEmbed(cfg, policy)
        self.context_embedder = Dense(cfg.joint_attention_dim, cfg.caption_projection_dim,
                                      dtype=dt)
        self.pos_embed_input = Conv(cfg.in_channels, cfg.hidden_size, cfg.patch_size,
                                    stride=cfg.patch_size, dtype=dt)
        for i in range(cfg.num_layers):
            self.add_module(f"blocks_{i}", JointBlock(cfg, policy, context_pre_only=False))
            self.add_module(f"controlnet_blocks_{i}",
                            Dense(cfg.hidden_size, cfg.hidden_size, dtype=dt))

    def forward(self, latents: torch.Tensor, timestep: torch.Tensor,
                cond_latents: torch.Tensor, pair_latents: torch.Tensor,
                encoder_hidden_states: torch.Tensor, pooled_projections: torch.Tensor,
                conditioning_scale: float = 1.0) -> Tuple[torch.Tensor, ...]:
        """latents, cond_latents, pair_latents (B, C, H, W); timestep (B,);
        encoder_hidden_states (B, L, joint_attention_dim); pooled (B, P)."""
        cfg, dt = self.config, self.compute_dtype
        hidden = self.pos_embed(latents.to(dt))
        emb = self.time_text_embed(timestep, pooled_projections)
        context = self.context_embedder(encoder_hidden_states.to(dt))

        def patchify(x):
            out = self.pos_embed_input(x.to(dt))
            b, d = out.shape[:2]
            return out.permute(0, 2, 3, 1).reshape(b, -1, d)

        hidden = hidden + patchify(cond_latents) + patchify(pair_latents)
        taps = []
        for i in range(cfg.num_layers):
            hidden, context = getattr(self, f"blocks_{i}")(hidden, context, emb)
            taps.append(getattr(self, f"controlnet_blocks_{i}")(hidden))
        return tuple(t * conditioning_scale for t in taps)


class SupportPairDownProj(nn.Module):
    """`down_proj`: the 6 -> 3 channel 3x3 pixel-space conv applied before
    the VAE encodes the support pair."""

    def __init__(self, policy: DTypePolicy = default_policy()):
        super().__init__()
        self.compute_dtype = policy.compute_dtype
        self.down_proj = Conv(6, 3, 3, padding=1, dtype=policy.compute_dtype)

    def forward(self, cond: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        """cond, gt (B, 3, H, W) -> (B, 3, H, W)."""
        return self.down_proj(torch.cat([cond, gt], dim=1).to(self.compute_dtype))
