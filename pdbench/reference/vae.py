"""Plain fp32 KL-VAE (AutoencoderKL, models/cldm_v15.yaml's ddconfig; SD3's
with 16 latent channels), with the parameter names of the port's module.
Every cell runs the VAE in bf16, so no site here is quantized; the
control rounds it to fp8."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pdbench.reference.common import Conv, GroupNorm, attention


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = GroupNorm(cin, eps=1e-6, silu=True)
        self.conv1 = Conv(cin, cout, 3, padding=1)
        self.norm2 = GroupNorm(cout, eps=1e-6, silu=True)
        self.conv2 = Conv(cout, cout, 3, padding=1)
        self.nin_shortcut = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        return (x if self.nin_shortcut is None else self.nin_shortcut(x)) + h


class AttnBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.norm = GroupNorm(ch, eps=1e-6)
        self.q, self.k, self.v, self.proj_out = (Conv(ch, ch, 1) for _ in range(4))

    def forward(self, x):
        b, c, h, w = x.shape
        hn = self.norm(x)
        tok = lambda t: t.permute(0, 2, 3, 1).reshape(b, h * w, 1, c)
        out = attention(tok(self.q(hn)), tok(self.k(hn)), tok(self.v(hn)), c ** -0.5)
        return x + self.proj_out(out.reshape(b, h, w, c).permute(0, 3, 1, 2))


class Encoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        ch, mult, nres = cfg["ch"], cfg["ch_mult"], cfg["num_res_blocks"]
        self.cfg = cfg
        self.conv_in = Conv(cfg["in_channels"], ch, 3, padding=1)
        cur = ch
        for level, m in enumerate(mult):
            for i in range(nres):
                self.add_module(f"down_{level}_block_{i}", ResnetBlock(cur, ch * m))
                cur = ch * m
            if level != len(mult) - 1:
                self.add_module(f"down_{level}_downsample", Conv(cur, cur, 3, stride=2))
        self.mid_block_1, self.mid_attn_1, self.mid_block_2 = (
            ResnetBlock(cur, cur), AttnBlock(cur), ResnetBlock(cur, cur))
        self.norm_out = GroupNorm(cur, eps=1e-6, silu=True)
        self.conv_out = Conv(cur, 2 * cfg["z_channels"], 3, padding=1)

    def forward(self, x):
        cfg = self.cfg
        h = self.conv_in(x)
        for level in range(len(cfg["ch_mult"])):
            for i in range(cfg["num_res_blocks"]):
                h = getattr(self, f"down_{level}_block_{i}")(h)
            if level != len(cfg["ch_mult"]) - 1:
                h = getattr(self, f"down_{level}_downsample")(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        return self.conv_out(self.norm_out(h))


class Decoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        ch, mult, nres = cfg["ch"], cfg["ch_mult"], cfg["num_res_blocks"]
        self.cfg = cfg
        cur = ch * mult[-1]
        self.conv_in = Conv(cfg["z_channels"], cur, 3, padding=1)
        self.mid_block_1, self.mid_attn_1, self.mid_block_2 = (
            ResnetBlock(cur, cur), AttnBlock(cur), ResnetBlock(cur, cur))
        for level in reversed(range(len(mult))):
            for i in range(nres + 1):
                self.add_module(f"up_{level}_block_{i}", ResnetBlock(cur, ch * mult[level]))
                cur = ch * mult[level]
            if level != 0:
                self.add_module(f"up_{level}_upsample", Conv(cur, cur, 3, padding=1))
        self.norm_out = GroupNorm(cur, eps=1e-6, silu=True)
        self.conv_out = Conv(cur, cfg["out_channels"], 3, padding=1)

    def forward(self, z):
        cfg = self.cfg
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(self.conv_in(z))))
        for level in reversed(range(len(cfg["ch_mult"]))):
            for i in range(cfg["num_res_blocks"] + 1):
                h = getattr(self, f"up_{level}_block_{i}")(h)
            if level != 0:
                h = getattr(self, f"up_{level}_upsample")(
                    F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return self.conv_out(self.norm_out(h))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        zc = cfg["z_channels"]
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Conv(2 * zc, 2 * zc, 1)
        self.post_quant_conv = Conv(zc, zc, 1)

    def encode(self, x, noise):
        """Pixels (B, 3, H, W) in [-1, 1] -> latents sampled with `noise`,
        shifted and scaled."""
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        z = mean + torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0)) * noise
        return (z - self.cfg["shift_factor"]) * self.cfg["scale_factor"]

    def decode(self, z):
        """Unscaled latents (B, z, h, w) -> images (B, 8h, 8w, 3) in [0, 1]."""
        img = self.decoder(self.post_quant_conv(z))
        return torch.clamp(img / 2 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)
