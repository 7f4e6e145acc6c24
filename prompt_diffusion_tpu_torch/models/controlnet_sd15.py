"""Prompt-Diffusion ControlNet (SD1.5), NCHW in channels_last memory.

Counterpart of `prompt_diffusion_tpu/models/controlnet_sd15.py`: a copy of
the UNet encoder with two hint encoders (the 6-channel example pair and the
3-channel query), whose sum is added after the first conv, and a 1x1 conv
tap after each of the 12 input blocks and the middle block.

Under an int8 policy the encoder it shares with the UNet quantizes
(`unet_sd15.build_encoder`); the hint encoders and the 1x1 taps stay in the
compute dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from prompt_diffusion_tpu_torch.models.layers import conv1x1, conv3x3, timestep_embedding
from prompt_diffusion_tpu_torch.models.unet_sd15 import (
    UNetConfig,
    build_encoder,
    run_input_block,
    run_middle_block,
)
from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy, default_policy


class HintEncoder(nn.Module):
    """8x downsampling conv stack for hint images:
    C -> 16 -> 16 -> 32(s2) -> 32 -> 96(s2) -> 96 -> 256(s2) -> model_channels."""

    WIDTHS = ((16, 1), (16, 1), (32, 2), (32, 1), (96, 2), (96, 1), (256, 2))

    def __init__(self, in_ch: int, model_channels: int, policy: DTypePolicy):
        super().__init__()
        dt = policy.compute_dtype
        self.compute_dtype = dt
        cur = in_ch
        for i, (w, s) in enumerate(self.WIDTHS):
            self.add_module(f"conv_{i}", conv3x3(cur, w, dt, stride=s))
            cur = w
        self.conv_out = conv3x3(cur, model_channels, dt)

    def forward(self, hint):
        h = hint.to(self.compute_dtype)
        for i in range(len(self.WIDTHS)):
            h = F.silu(getattr(self, f"conv_{i}")(h))
        return self.conv_out(h)


class ControlNetSD15(nn.Module):
    """Returns the 13 control residuals (12 encoder taps, then the middle
    tap), each multiplied by `conditioning_scale`."""

    def __init__(self, config: UNetConfig = UNetConfig(), hint_channels: int = 6,
                 policy: DTypePolicy = default_policy()):
        super().__init__()
        self.config, self.policy = config, policy
        dt = policy.compute_dtype
        self.input_hint_block = HintEncoder(hint_channels, config.model_channels, policy)
        self.input_cond_block = HintEncoder(3, config.model_channels, policy)
        self._enc_plan = build_encoder(self, config, policy)
        for i, (_, out_ch, _) in enumerate(self._enc_plan):
            self.add_module(f"zero_convs_{i}", conv1x1(out_ch, out_ch, dt))
        mid_ch = config.encoder_plan()[2]
        self.middle_block_out = conv1x1(mid_ch, mid_ch, dt)

    def forward(
        self,
        x: Optional[torch.Tensor] = None,  # (B, 4, H, W) noisy latents
        timesteps: Optional[torch.Tensor] = None,  # (B,)
        example_pair: Optional[torch.Tensor] = None,  # (B, 6, 8H, 8W)
        query: Optional[torch.Tensor] = None,  # (B, 3, 8H, 8W)
        context: Optional[torch.Tensor] = None,  # (B, L, context_dim)
        conditioning_scale: Union[float, torch.Tensor, Sequence] = 1.0,
        guided_hint: Optional[torch.Tensor] = None,
        hint_only: bool = False,
    ) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """The control stack, or with `hint_only=True` just the summed hint
        embedding. The hint does not depend on x or t, so the sampler
        computes it once and passes it back as `guided_hint`.
        `conditioning_scale` is one number or tensor for every tap (a
        per-sample (B, 1, 1, 1) tensor too), or one per tap (a sequence or
        a 1-D tensor, e.g. guess mode's decay). A bf16 tap times an fp32
        tensor of more than 0 dimensions comes out fp32, as in JAX; the
        UNet casts it back."""
        if guided_hint is None:
            guided_hint = self.input_hint_block(example_pair) + self.input_cond_block(query)
        if hint_only:
            return guided_hint

        dt = self.policy.compute_dtype
        x, context = x.to(dt), context.to(dt)
        emb = self.time_embed(timestep_embedding(timesteps, self.config.model_channels).to(dt))
        outs = []
        h = x
        for i, (kind, _, has_attn) in enumerate(self._enc_plan):
            h = run_input_block(self, i, kind, has_attn, h, emb, context)
            if kind == "conv":
                h = h + guided_hint  # injected once, after conv_in
            outs.append(getattr(self, f"zero_convs_{i}")(h))
        h = run_middle_block(self, h, emb, context)
        outs.append(self.middle_block_out(h))

        if isinstance(conditioning_scale, (tuple, list)) or getattr(
                conditioning_scale, "ndim", None) == 1:
            return tuple(o * s for o, s in zip(outs, conditioning_scale))
        return tuple(o * conditioning_scale for o in outs)
