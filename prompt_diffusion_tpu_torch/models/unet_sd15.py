"""SD1.5 UNet (the epsilon predictor), NCHW in channels_last memory.

Counterpart of `prompt_diffusion_tpu/models/unet_sd15.py`: timestep
embedding -> MLP; 12 input blocks; middle (res, transformer, res); 12
output blocks with skip concatenation; GN + SiLU + conv head. Control
residuals from the ControlNet add to the bottleneck (the last one) and then
to the skips in reverse order (only the bottleneck's with
`only_mid_control`). FreeU (`UNetConfig.freeu`) rescales the backbone and
damps the skips' low frequencies at the two deepest decoder levels.

Under an int8 policy the input conv, the ResBlocks, Down/Upsample and the
transformers quantize (`models/layers.py`); the time embedding and the
GN + SiLU + conv head stay in the compute dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from prompt_diffusion_tpu_torch.models.layers import (
    Downsample,
    GroupNorm32,
    ResBlock,
    SpatialTransformer,
    TimeEmbedMLP,
    Upsample,
    conv3x3,
    timestep_embedding,
)
from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy, default_policy


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Mirrors models/cldm_v15.yaml:47-62."""

    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_heads: int = 8
    transformer_depth: int = 1
    context_dim: int = 768
    # FreeU: backbone/skip feature rescaling at the two deepest decoder
    # levels; None disables.
    freeu: Optional[Tuple[float, float, float, float]] = None  # (s1, s2, b1, b2)
    # recompute each ResBlock and SpatialTransformer in the backward pass
    # (gradient checkpointing, the JAX package's `nn.remat`)
    use_checkpoint: bool = False

    def encoder_plan(self):
        """('conv'|'res'|'down', out_ch, has_attn) per input block, the
        channel count after each block, the bottleneck width and the final
        downsampling factor."""
        plan = [("conv", self.model_channels, False)]
        chans = [self.model_channels]
        ch, ds = self.model_channels, 1
        for level, mult in enumerate(self.channel_mult):
            for _ in range(self.num_res_blocks):
                ch = mult * self.model_channels
                plan.append(("res", ch, ds in self.attention_resolutions))
                chans.append(ch)
            if level != len(self.channel_mult) - 1:
                plan.append(("down", ch, False))
                chans.append(ch)
                ds *= 2
        return plan, chans, ch, ds

    def decoder_plan(self, ds):
        """('res', out_ch, has_attn, has_up) per output block."""
        plan = []
        for level, mult in reversed(list(enumerate(self.channel_mult))):
            for i in range(self.num_res_blocks + 1):
                has_up = level > 0 and i == self.num_res_blocks
                plan.append(("res", self.model_channels * mult,
                             ds in self.attention_resolutions, has_up))
                if has_up:
                    ds //= 2
        return plan


def _freeu_filter(skip: torch.Tensor, scale: float, threshold: int = 1) -> torch.Tensor:
    """Fourier low-frequency damping of skip features (diffusers'
    fourier_filter, used by FreeU), in fp32 over the spatial axes."""
    x = skip.float()
    h, w = x.shape[-2:]
    freq = torch.fft.fftshift(torch.fft.fftn(x, dim=(-2, -1)), dim=(-2, -1))
    ch, cw = h // 2, w // 2
    yy = (torch.arange(h, device=x.device) - ch).abs()[:, None]
    xx = (torch.arange(w, device=x.device) - cw).abs()[None, :]
    mask = torch.where((yy <= threshold) & (xx <= threshold), scale, 1.0)
    freq = torch.fft.ifftshift(freq * mask, dim=(-2, -1))
    return torch.fft.ifftn(freq, dim=(-2, -1)).real.to(skip.dtype)


def build_encoder(module: nn.Module, cfg: UNetConfig, policy: DTypePolicy):
    """Adds the time embedding, the input blocks and the middle block that
    the UNet and the ControlNet share; returns the encoder plan."""
    emb_dim = cfg.model_channels * 4
    module.time_embed = TimeEmbedMLP(cfg.model_channels, emb_dim, policy)
    plan, _, mid_ch, _ = cfg.encoder_plan()
    cur = cfg.in_channels
    for i, (kind, out_ch, has_attn) in enumerate(plan):
        if kind == "conv":
            module.add_module(f"input_blocks_{i}_conv",
                              conv3x3(cur, out_ch, policy.compute_dtype, policy=policy))
        elif kind == "res":
            module.add_module(f"input_blocks_{i}_res",
                              ResBlock(cur, out_ch, emb_dim, policy))
            if has_attn:
                module.add_module(f"input_blocks_{i}_attn", _transformer(cfg, out_ch, policy))
        else:
            module.add_module(f"input_blocks_{i}_down", Downsample(cur, out_ch, policy))
        cur = out_ch
    module.middle_block_0 = ResBlock(mid_ch, mid_ch, emb_dim, policy)
    module.middle_block_1 = _transformer(cfg, mid_ch, policy)
    module.middle_block_2 = ResBlock(mid_ch, mid_ch, emb_dim, policy)
    return plan


def _transformer(cfg: UNetConfig, ch: int, policy: DTypePolicy) -> SpatialTransformer:
    return SpatialTransformer(ch, cfg.context_dim, cfg.num_heads, ch // cfg.num_heads,
                              cfg.transformer_depth, policy)


def run_block(owner: nn.Module, block: nn.Module, *args):
    """block(*args); a ResBlock or SpatialTransformer of a model whose
    config sets `use_checkpoint` runs, while gradients are recorded, under
    `torch.utils.checkpoint` (its activations recomputed in the backward
    pass, its kernels launched a second time there)."""
    if owner.config.use_checkpoint and torch.is_grad_enabled():
        return checkpoint(block, *args, use_reentrant=False)
    return block(*args)


def run_input_block(module: nn.Module, i: int, kind: str, has_attn: bool, h, emb, context):
    if kind == "conv":
        return getattr(module, f"input_blocks_{i}_conv")(h)
    if kind == "res":
        h = run_block(module, getattr(module, f"input_blocks_{i}_res"), h, emb)
        if has_attn:
            h = run_block(module, getattr(module, f"input_blocks_{i}_attn"), h, context)
        return h
    return getattr(module, f"input_blocks_{i}_down")(h)


def run_middle_block(module: nn.Module, h, emb, context):
    h = run_block(module, module.middle_block_0, h, emb)
    h = run_block(module, module.middle_block_1, h, context)
    return run_block(module, module.middle_block_2, h, emb)


class UNetSD15(nn.Module):
    def __init__(self, config: UNetConfig = UNetConfig(),
                 policy: DTypePolicy = default_policy()):
        super().__init__()
        self.config, self.policy = config, policy
        cfg, dt = config, policy.compute_dtype
        emb_dim = cfg.model_channels * 4
        self._enc_plan = build_encoder(self, cfg, policy)
        _, skip_chans, cur, ds = cfg.encoder_plan()
        skip_chans = list(skip_chans)
        self._dec_plan = cfg.decoder_plan(ds)
        for i, (_, out_ch, has_attn, has_up) in enumerate(self._dec_plan):
            self.add_module(f"output_blocks_{i}_res",
                            ResBlock(cur + skip_chans.pop(), out_ch, emb_dim, policy))
            if has_attn:
                self.add_module(f"output_blocks_{i}_attn", _transformer(cfg, out_ch, policy))
            if has_up:
                self.add_module(f"output_blocks_{i}_up", Upsample(out_ch, out_ch, policy))
            cur = out_ch
        self.out_norm = GroupNorm32(cur, apply_silu=True)
        self.out_conv = conv3x3(cur, cfg.out_channels, dt)

    def forward(
        self,
        x: torch.Tensor,  # (B, 4, H, W) latents
        timesteps: torch.Tensor,  # (B,)
        context: torch.Tensor,  # (B, L, context_dim)
        control: Optional[Sequence[torch.Tensor]] = None,  # 13 residuals, NCHW
        only_mid_control: bool = False,
    ) -> torch.Tensor:
        dt = self.policy.compute_dtype
        x, context = x.to(dt), context.to(dt)
        emb = self.time_embed(timestep_embedding(timesteps, self.config.model_channels).to(dt))

        hs = []
        h = x
        for i, (kind, _, has_attn) in enumerate(self._enc_plan):
            h = run_input_block(self, i, kind, has_attn, h, emb, context)
            hs.append(h)
        h = run_middle_block(self, h, emb, context)

        ctrl = list(control) if control is not None else None
        if ctrl is not None:
            h = h + ctrl.pop().to(h.dtype)
        for i, (_, _, has_attn, has_up) in enumerate(self._dec_plan):
            skip = hs.pop()
            if ctrl is not None and not only_mid_control:
                skip = skip + ctrl.pop().to(skip.dtype)
            if self.config.freeu is not None:
                h, skip = self._freeu(h, skip)
            h = run_block(self, getattr(self, f"output_blocks_{i}_res"),
                          torch.cat([h, skip], dim=1), emb)
            if has_attn:
                h = run_block(self, getattr(self, f"output_blocks_{i}_attn"), h, context)
            if has_up:
                h = getattr(self, f"output_blocks_{i}_up")(h)
        return self.out_conv(self.out_norm(h)).float()

    def _freeu(self, h, skip):
        """FreeU at the deepest (4 x model_channels) and the next (2 x)
        decoder levels: the first half of the backbone's channels times b1
        or b2, the skip's low frequencies times s1 or s2."""
        s1, s2, b1, b2 = self.config.freeu
        mc, c = self.config.model_channels, h.shape[1]
        if c not in (4 * mc, 2 * mc):
            return h, skip
        b, s = (b1, s1) if c == 4 * mc else (b2, s2)
        half = c // 2
        h = torch.cat([h[:, :half] * b, h[:, half:]], dim=1)
        return h, _freeu_filter(skip, s)
