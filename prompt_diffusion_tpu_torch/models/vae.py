"""KL-VAE first stage (AutoencoderKL), NCHW in channels_last memory.

Counterpart of `prompt_diffusion_tpu/models/vae.py`: ch=128, mult
(1,2,4,4), 2 res blocks, single-head attention at the bottleneck, z=4 with
double_z moments (SD3: `VAEConfig(z_channels=16, scale_factor=1.5305,
shift_factor=0.0609)`). The latent scale and shift are applied by the
pipeline; `sample_from_moments` draws a latent from the moments.

Under an int8 policy (the pipeline's `vae_int8=True`) the interior convs
and the attention's q/k/v/proj_out are `QuantConv`s, fed by the GroupNorm
int8 epilogue (K5) where a norm precedes them; the convs on the pixel and
latent boundaries (encoder conv_in and conv_out, decoder conv_out), the
encoder's downsampling convs and quant_conv/post_quant_conv stay bf16.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from prompt_diffusion_tpu_torch.models.layers import Conv, GroupNorm32, conv1x1, conv3x3
from prompt_diffusion_tpu_torch.ops.attention import dot_product_attention
from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy, default_policy


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Mirrors models/cldm_v15.yaml:64-85 ddconfig."""

    in_channels: int = 3
    out_channels: int = 3
    z_channels: int = 4
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    double_z: bool = True
    scale_factor: float = 0.18215
    shift_factor: float = 0.0


class VAEResnetBlock(nn.Module):
    """GN(eps 1e-6) -> SiLU -> conv, twice, + residual."""

    def __init__(self, in_ch: int, out_ch: int, policy: DTypePolicy):
        super().__init__()
        dt, q8 = policy.compute_dtype, policy.quant == "int8"
        self.norm1 = GroupNorm32(in_ch, eps=1e-6, apply_silu=True, quant_out=q8)
        self.conv1 = conv3x3(in_ch, out_ch, dt, policy=policy)
        self.norm2 = GroupNorm32(out_ch, eps=1e-6, apply_silu=True, quant_out=q8)
        self.conv2 = conv3x3(out_ch, out_ch, dt, policy=policy)
        self.nin_shortcut = (conv1x1(in_ch, out_ch, dt, policy=policy)
                             if in_ch != out_ch else None)

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class VAEAttnBlock(nn.Module):
    """Single-head spatial self-attention (the flash kernel K2 on the card
    at 512², through `dot_product_attention`'s rule). In int8 mode one
    GroupNorm int8 pair feeds q, k and v."""

    def __init__(self, channels: int, policy: DTypePolicy):
        super().__init__()
        dt = policy.compute_dtype
        self.norm = GroupNorm32(channels, eps=1e-6, quant_out=policy.quant == "int8")
        self.q = conv1x1(channels, channels, dt, policy=policy)
        self.k = conv1x1(channels, channels, dt, policy=policy)
        self.v = conv1x1(channels, channels, dt, policy=policy)
        self.proj_out = conv1x1(channels, channels, dt, policy=policy)

    def forward(self, x):
        b, c, h, w = x.shape
        hn = self.norm(x)
        tokens = lambda t: t.permute(0, 2, 3, 1).reshape(b, h * w, 1, c)
        out = dot_product_attention(tokens(self.q(hn)), tokens(self.k(hn)), tokens(self.v(hn)))
        out = out.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return x + self.proj_out(out)


class VAEEncoder(nn.Module):
    def __init__(self, cfg: VAEConfig, policy: DTypePolicy):
        super().__init__()
        dt = policy.compute_dtype
        self.cfg, self.compute_dtype = cfg, dt
        self.conv_in = conv3x3(cfg.in_channels, cfg.ch, dt)
        cur = cfg.ch
        for level, mult in enumerate(cfg.ch_mult):
            out_ch = cfg.ch * mult
            for i in range(cfg.num_res_blocks):
                self.add_module(f"down_{level}_block_{i}", VAEResnetBlock(cur, out_ch, policy))
                cur = out_ch
            if level != len(cfg.ch_mult) - 1:
                self.add_module(f"down_{level}_downsample",
                                Conv(out_ch, out_ch, 3, stride=2, dtype=dt))
        self.mid_block_1 = VAEResnetBlock(cur, cur, policy)
        self.mid_attn_1 = VAEAttnBlock(cur, policy)
        self.mid_block_2 = VAEResnetBlock(cur, cur, policy)
        self.norm_out = GroupNorm32(cur, eps=1e-6, apply_silu=True)
        out_c = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = conv3x3(cur, out_c, dt)

    def forward(self, x):
        cfg = self.cfg
        h = self.conv_in(x.to(self.compute_dtype))
        for level in range(len(cfg.ch_mult)):
            for i in range(cfg.num_res_blocks):
                h = getattr(self, f"down_{level}_block_{i}")(h)
            if level != len(cfg.ch_mult) - 1:
                # asymmetric (0, 1) pad + stride-2 valid conv
                h = getattr(self, f"down_{level}_downsample")(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        return self.conv_out(self.norm_out(h))


class VAEDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig, policy: DTypePolicy):
        super().__init__()
        dt = policy.compute_dtype
        self.cfg, self.compute_dtype = cfg, dt
        cur = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = conv3x3(cfg.z_channels, cur, dt, policy=policy)
        self.mid_block_1 = VAEResnetBlock(cur, cur, policy)
        self.mid_attn_1 = VAEAttnBlock(cur, policy)
        self.mid_block_2 = VAEResnetBlock(cur, cur, policy)
        for level in reversed(range(len(cfg.ch_mult))):
            out_ch = cfg.ch * cfg.ch_mult[level]
            for i in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_{level}_block_{i}", VAEResnetBlock(cur, out_ch, policy))
                cur = out_ch
            if level != 0:
                self.add_module(f"up_{level}_upsample", conv3x3(cur, cur, dt, policy=policy))
        self.norm_out = GroupNorm32(cur, eps=1e-6, apply_silu=True)
        self.conv_out = conv3x3(cur, cfg.out_channels, dt)

    def forward(self, z):
        cfg = self.cfg
        h = self.conv_in(z.to(self.compute_dtype))
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        for level in reversed(range(len(cfg.ch_mult))):
            for i in range(cfg.num_res_blocks + 1):
                h = getattr(self, f"up_{level}_block_{i}")(h)
            if level != 0:
                h = F.interpolate(h, scale_factor=2.0, mode="nearest")
                h = getattr(self, f"up_{level}_upsample")(h)
        return self.conv_out(self.norm_out(h))


class AutoencoderKL(nn.Module):
    """encode -> quant_conv -> moments; z -> post_quant_conv -> decode."""

    def __init__(self, config: VAEConfig = VAEConfig(),
                 policy: DTypePolicy = default_policy()):
        super().__init__()
        self.config, self.policy = config, policy
        dt = policy.compute_dtype
        zc = config.z_channels
        self.encoder = VAEEncoder(config, policy)
        self.decoder = VAEDecoder(config, policy)
        self.quant_conv = conv1x1(2 * zc if config.double_z else zc,
                                  2 * zc if config.double_z else zc, dt)
        self.post_quant_conv = conv1x1(zc, zc, dt)

    def encode_moments(self, x):
        """(B, 3, H, W) -> (B, 2z, H/8, W/8) [mean | logvar], fp32."""
        return self.quant_conv(self.encoder(x)).float()

    def decode(self, z):
        """(B, z, h, w) latents -> (B, 3, 8h, 8w) pixels in about [-1, 1], fp32."""
        return self.decoder(self.post_quant_conv(z)).float()


def sample_from_moments(moments: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DiagonalGaussianDistribution.sample: moments (B, 2z, h, w) [mean |
    logvar] -> mean + exp(0.5 * clip(logvar, -30, 20)) * N(0, 1), the noise
    given (a trainer's draw) or drawn from `generator` on the moments'
    device."""
    mean, logvar = moments.chunk(2, dim=1)
    logvar = torch.clamp(logvar, -30.0, 20.0)
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                            dtype=mean.dtype)
    return mean + torch.exp(0.5 * logvar) * noise
