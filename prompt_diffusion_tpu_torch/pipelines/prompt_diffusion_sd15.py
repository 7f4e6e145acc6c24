"""SD1.5 Prompt-Diffusion inference pipeline for PyTorch and CUDA.

Counterpart of `prompt_diffusion_tpu/pipelines/prompt_diffusion_sd15.py`
(DDIM sampler; the exact-bf16 policy, or the int8 W8A8 serving mode with
`create(policy=int8_policy(), vae_int8=...)`): CLIP encodes the prompt and the negative
prompt; the ControlNet hint encoders run once; each DDIM step runs
ControlNet + UNet on the uncond || cond double batch (uncond first) and
applies classifier-free guidance; the VAE decodes the latents.

Images cross the API as NHWC tensors in [-1, 1] and come back NHWC in
[0, 1], as in the JAX package; inside, activations are NCHW in
channels_last memory. The modules hold their weights: load them with
`tools.jax_bridge.load_jax_params` or fill them with `random_init_`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from prompt_diffusion_tpu_torch.models.clip_text import CLIPTextModel
from prompt_diffusion_tpu_torch.models.controlnet_sd15 import ControlNetSD15
from prompt_diffusion_tpu_torch.models.unet_sd15 import UNetSD15
from prompt_diffusion_tpu_torch.models.vae import AutoencoderKL
from prompt_diffusion_tpu_torch.ops.int8_conv import VARIANTS
from prompt_diffusion_tpu_torch.ops.quant import QuantConv
from prompt_diffusion_tpu_torch.schedulers.ddim import DDIMTables, ddim_sample_loop
from prompt_diffusion_tpu_torch.schedulers.schedules import DiffusionSchedule
from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy, int8_policy

_NCHW = (0, 3, 1, 2)
_NHWC = (0, 2, 3, 1)


@dataclasses.dataclass
class PromptDiffusionSD15:
    """The four models and the noise schedule."""

    unet: UNetSD15
    controlnet: ControlNetSD15
    vae: AutoencoderKL
    text_encoder: CLIPTextModel
    schedule: DiffusionSchedule

    @classmethod
    def create(cls, unet=None, controlnet=None, vae=None, text_encoder=None,
               schedule=None, policy: Optional[DTypePolicy] = None,
               vae_int8: bool = False, device: torch.device | str = "cuda",
               conv_variant: str = "im2col"):
        """Builds the default SD1.5 models (or takes the given ones) on
        `device` (the card unless the caller asks for the CPU), in eval
        mode, with 4-D weights in channels_last memory.
        `policy=` sets the UNet/ControlNet dtype policy (`int8_policy()`
        for the quantized serving mode); the VAE and CLIP keep their
        defaults, except that `vae_int8=True` builds the VAE under
        `int8_policy()` (its interior convs quantize; the decode runs once
        per request). `conv_variant` ("im2col" or "xshift") sets the int8
        3x3 conv kernel's variant on every `QuantConv` of the models,
        built or given; both give the same bits (the JAX package's
        `PD_INT8_CONV_XSHIFT`)."""
        if conv_variant not in VARIANTS:
            raise ValueError(f"unknown conv_variant {conv_variant!r}; one of {VARIANTS}")
        with torch.device(device):
            if policy is not None:
                unet = unet or UNetSD15(policy=policy)
                controlnet = controlnet or ControlNetSD15(policy=policy)
            if vae_int8:
                vae = vae or AutoencoderKL(policy=int8_policy())
            models = dict(
                unet=unet or UNetSD15(),
                controlnet=controlnet or ControlNetSD15(),
                vae=vae or AutoencoderKL(),
                text_encoder=text_encoder or CLIPTextModel(),
            )
        for m in models.values():
            m.to(device=device, memory_format=torch.channels_last).eval().requires_grad_(False)
            for mod in m.modules():
                if isinstance(mod, QuantConv):
                    mod.conv_variant = conv_variant
        return cls(**models, schedule=schedule or DiffusionSchedule.create())

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    def jax_modules(self) -> dict:
        """{JAX parameter namespace: module}, for `tools.jax_bridge`."""
        return {"unet": self.unet, "controlnet": self.controlnet, "vae": self.vae,
                "clip": self.text_encoder}

    def encode_prompt(self, token_ids: torch.Tensor) -> torch.Tensor:
        return self.text_encoder(token_ids.to(self.device))["last_hidden_state"]

    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """latents (B, h, w, 4) -> images (B, 8h, 8w, 3) in [0, 1]."""
        cfg = self.vae.config
        z = latents.permute(_NCHW) / cfg.scale_factor + cfg.shift_factor
        img = self.vae.decode(z.contiguous(memory_format=torch.channels_last))
        return torch.clamp(img / 2 + 0.5, 0.0, 1.0).permute(_NHWC)

    def check_inputs(self, token_ids, neg_token_ids, example_pair, query):
        """Input validation with actionable messages."""
        b, h, w, c = query.shape
        if c != 3:
            raise ValueError(f"query must be (B,H,W,3) NHWC, got channels={c}")
        if tuple(example_pair.shape) != (b, h, w, 6):
            raise ValueError(
                "example_pair must be the 6-channel (condition‖image) stack "
                f"matching query: expected {(b, h, w, 6)}, got {tuple(example_pair.shape)}")
        if h % 8 or w % 8:
            raise ValueError(f"image size must be divisible by 8 (VAE downsampling), got {h}x{w}")
        for name, ids in (("token_ids", token_ids), ("neg_token_ids", neg_token_ids)):
            if ids.shape[0] != b:
                raise ValueError(f"{name} batch {ids.shape[0]} != image batch {b}")

    @torch.no_grad()
    def generate(
        self,
        token_ids: torch.Tensor,  # (B, 77) prompt ids
        neg_token_ids: torch.Tensor,  # (B, 77) negative/uncond ids
        example_pair: torch.Tensor,  # (B, H, W, 6) condition‖image, [-1, 1]
        query: torch.Tensor,  # (B, H, W, 3) query condition, [-1, 1]
        num_steps: int = 50,
        guidance_scale: float = 9.0,
        control_scale: float = 1.0,
        eta: float = 0.0,
        guess_mode: bool = False,
        init_noise: Optional[torch.Tensor] = None,  # (B, H/8, W/8, 4)
        sampler: str = "ddim",
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Returns images (B, H, W, 3) in [0, 1], fp32. The starting noise
        is `init_noise` when given, else drawn from `generator`, which
        also gives the per-step noise when eta > 0."""
        if sampler != "ddim":
            raise ValueError(f"sampler {sampler!r} is not ported yet (only 'ddim')")
        self.check_inputs(token_ids, neg_token_ids, example_pair, query)
        b, img_h, img_w, _ = query.shape
        tables = DDIMTables.create(self.schedule, num_steps, eta=eta)
        eps_fn = self.make_eps_fn(token_ids, neg_token_ids, example_pair, query,
                                  guidance_scale, control_scale, guess_mode)
        if init_noise is None:
            x = torch.randn((b, img_h // 8, img_w // 8, 4), generator=generator,
                            device=self.device, dtype=torch.float32)
        else:
            x = init_noise.to(device=self.device, dtype=torch.float32)
        x = x.permute(_NCHW)
        # every table entry runs: more than num_steps when 1000 % num_steps != 0
        x = ddim_sample_loop(eps_fn, x, tables, generator=generator if eta > 0.0 else None)
        return self.decode_latents(x.permute(_NHWC))

    @torch.no_grad()
    def make_eps_fn(self, token_ids, neg_token_ids, example_pair, query,
                    guidance_scale: float = 9.0, control_scale: float = 1.0,
                    guess_mode: bool = False):
        """Encodes the prompts and the hint once and returns
        `eps_fn(x, t)`: ControlNet + UNet on the uncond || cond double
        batch and the classifier-free guidance, for NCHW latents x."""
        dev = self.device
        b = query.shape[0]
        # uncond first, cond second
        context2 = torch.cat([self.encode_prompt(neg_token_ids), self.encode_prompt(token_ids)])
        to_nchw = lambda t: t.to(dev).permute(_NCHW).contiguous(memory_format=torch.channels_last)
        pair2 = to_nchw(torch.cat([example_pair] * 2))
        query2 = to_nchw(torch.cat([query] * 2))
        if guess_mode:
            # strength * 0.825^(12 - i) over the 13 taps, fp32 as in JAX
            decay = np.float32(0.825) ** np.arange(12, -1, -1, dtype=np.float32)
            ctrl_scale = tuple(float(np.float32(control_scale) * d) for d in decay)
            # the uncond half of the double batch gets no control at all
            branch_mask = torch.cat([torch.zeros(b, 1, 1, 1), torch.ones(b, 1, 1, 1)]).to(dev)
        else:
            ctrl_scale, branch_mask = control_scale, None

        hint2 = self.controlnet(example_pair=pair2, query=query2, hint_only=True)

        def eps_fn(x, t_b):
            x2 = torch.cat([x, x])
            t2 = torch.cat([t_b, t_b])
            control = self.controlnet(x2, t2, context=context2, conditioning_scale=ctrl_scale,
                                      guided_hint=hint2)
            if branch_mask is not None:
                control = tuple(c * branch_mask.to(c.dtype) for c in control)
            eps_uncond, eps_cond = self.unet(x2, t2, context2, control=control).chunk(2)
            return eps_uncond + guidance_scale * (eps_cond - eps_uncond)

        return eps_fn
