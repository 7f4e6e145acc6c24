"""SD1.5 Prompt-Diffusion inference pipeline for PyTorch and CUDA.

Counterpart of `prompt_diffusion_tpu/pipelines/prompt_diffusion_sd15.py`
(the exact-bf16 policy, or the int8 W8A8 serving mode with
`create(policy=int8_policy(), vae_int8=...)`): CLIP encodes the prompt and
the negative prompt; the ControlNet hint encoders run once; each sampler
step (DDIM, PLMS, UniPC, DPM-Solver++ or DPM-Solver) runs ControlNet + UNet
on the uncond || cond double batch (uncond first) and applies
classifier-free guidance; the VAE decodes the latents. Guidance and
control scales are numbers or per-sample (B, 1, 1, 1) tensors (the
serving batcher mixes requests); `control_guidance_start/end` restrict
the ControlNet to a window of the trajectory.

Images cross the API as NHWC tensors in [-1, 1] and come back NHWC in
[0, 1], as in the JAX package; inside, activations are NCHW in
channels_last memory. The modules hold their weights: build the pipeline
from a reference checkpoint (`from_single_file`, `from_diffusers_folder`),
load a JAX tree (`tools.jax_bridge.load_jax_params`) or fill them with
`random_init_`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from prompt_diffusion_tpu_torch.models.clip_text import CLIPTextModel
from prompt_diffusion_tpu_torch.models.controlnet_sd15 import ControlNetSD15
from prompt_diffusion_tpu_torch.models.layers import CrossAttention, GEGLUFeedForward
from prompt_diffusion_tpu_torch.models.unet_sd15 import UNetSD15
from prompt_diffusion_tpu_torch.models.vae import AutoencoderKL
from prompt_diffusion_tpu_torch.ops.int8_conv import VARIANTS
from prompt_diffusion_tpu_torch.data.tokenizer import EOT, SOT
from prompt_diffusion_tpu_torch.models.vae import sample_from_moments
from prompt_diffusion_tpu_torch.ops.quant import QuantConv
from prompt_diffusion_tpu_torch.parallel.mesh import batch_shard
from prompt_diffusion_tpu_torch.pipelines.control_window import (
    is_default_window,
    keep_by_timestep,
    validate_window,
)
from prompt_diffusion_tpu_torch.schedulers.ddim import DDIMTables, ddim_sample_loop
from prompt_diffusion_tpu_torch.schedulers.dpm_solver import (
    DPMTables,
    dpm_solver_multistep_loop,
)
from prompt_diffusion_tpu_torch.schedulers.plms import plms_sample_loop
from prompt_diffusion_tpu_torch.schedulers.schedules import DiffusionSchedule
from prompt_diffusion_tpu_torch.schedulers.unipc import UniPCTables, unipc_sample_loop
from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy, int8_policy

_NCHW = (0, 3, 1, 2)
_NHWC = (0, 2, 3, 1)
SAMPLERS = ("ddim", "plms", "unipc", "dpm++", "dpm")
Scale = Union[float, torch.Tensor]


def set_serving_options(model: torch.nn.Module, conv_variant: Optional[str] = None,
                        int8_attention: Optional[bool] = None,
                        fused_geglu: Optional[bool] = None) -> None:
    """Sets the int8 serving options on every module of `model` that has
    them (None leaves one as it is): K8's variant on each `QuantConv`,
    `int8_attention` on each `CrossAttention`, `fused_geglu` on each
    `GEGLUFeedForward`."""
    for mod in model.modules():
        if isinstance(mod, QuantConv) and conv_variant is not None:
            mod.conv_variant = conv_variant
        elif isinstance(mod, CrossAttention) and int8_attention is not None:
            mod.int8_attention = int8_attention
        elif isinstance(mod, GEGLUFeedForward) and fused_geglu is not None:
            mod.fused_geglu = fused_geglu


def _int8_modules(model: torch.nn.Module) -> bool:
    """Whether `model` runs the int8 policy's attention and feed-forward."""
    return any(isinstance(m, (CrossAttention, GEGLUFeedForward)) and m.quant
               for m in model.modules())


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
               conv_variant: str = "im2col", int8_attention: bool = False,
               fused_geglu: bool = True):
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
        `PD_INT8_CONV_XSHIFT`). Two options of the int8 UNet and ControlNet
        are set on every module of both, built or given, as the JAX
        package's switches set them: `int8_attention=True`
        (`PD_SD15_INT8_ATTN`) runs their kernel-eligible self-attention
        (the 64² and 32² latents) through K9 instead of K1;
        `fused_geglu=False` (`PD_SD15_FUSED_GEGLU=0`) replaces K7 by the
        GEGLU in the compute dtype and the dynamic per-tensor quantization
        of the feed-forward's `out`. With neither model under an int8
        policy, either option raises ValueError: it would not run."""
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
        options = (int8_attention, fused_geglu) != (False, True)
        if options and not any(_int8_modules(models[n]) for n in ("unet", "controlnet")):
            raise ValueError("int8_attention and fused_geglu=False are options of the int8 "
                             "policy, and neither the UNet nor the ControlNet is under it")
        for name, m in models.items():
            m.to(device=device, memory_format=torch.channels_last).eval().requires_grad_(False)
            denoiser = name in ("unet", "controlnet")
            set_serving_options(m, conv_variant, int8_attention if denoiser else None,
                                fused_geglu if denoiser else None)
        return cls(**models, schedule=schedule or DiffusionSchedule.create())

    # ---- loaders (the reference pipeline's mixins,
    # pipeline_prompt_diffusion.py:145,155-156; `tools/loaders.py`) ---------

    @classmethod
    def from_single_file(cls, path: str, policy: Optional[DTypePolicy] = None,
                         vae_int8: bool = False, device: torch.device | str = "cuda",
                         conv_variant: str = "im2col", int8_attention: bool = False,
                         fused_geglu: bool = True, **create_kwargs):
        """The pipeline from a reference `.ckpt` or `.safetensors`
        (FromSingleFileMixin): built through `create` on the meta device,
        so nothing is initialised, then loaded onto `device` with the
        dtypes and memory formats `create` gives, with `create`'s serving
        options. `create_kwargs` are models built on the meta device (other
        widths) or a `schedule`."""
        from prompt_diffusion_tpu_torch.tools.loaders import from_single_file

        return from_single_file(path, policy=policy, vae_int8=vae_int8, device=device,
                                conv_variant=conv_variant, int8_attention=int8_attention,
                                fused_geglu=fused_geglu, **create_kwargs)

    @classmethod
    def from_diffusers_folder(cls, root: str, policy: Optional[DTypePolicy] = None,
                              vae_int8: bool = False, device: torch.device | str = "cuda",
                              conv_variant: str = "im2col", int8_attention: bool = False,
                              fused_geglu: bool = True, **create_kwargs):
        """The pipeline from a prompt-diffusion-diffusers folder, built as
        `from_single_file` builds it (a folder without text_encoder/ needs
        a loaded `text_encoder=`)."""
        from prompt_diffusion_tpu_torch.tools.loaders import from_diffusers_folder

        return from_diffusers_folder(root, policy=policy, vae_int8=vae_int8, device=device,
                                     conv_variant=conv_variant, int8_attention=int8_attention,
                                     fused_geglu=fused_geglu, **create_kwargs)

    def load_lora_weights(self, path_or_sd, scale: float = 1.0) -> dict:
        """Folds a diffusers-format LoRA into the UNet and CLIP in place
        (LoraLoaderMixin + fuse_lora); returns {namespace: keys folded}."""
        from prompt_diffusion_tpu_torch.tools.loaders import load_lora_weights

        return load_lora_weights(self, path_or_sd, scale=scale)

    def load_textual_inversion(self, tokenizer, path_or_sd, token: Optional[str] = None):
        """Appends learned embeddings to CLIP's token table and registers
        the placeholder with `tokenizer` (TextualInversionLoaderMixin);
        returns (token, ids)."""
        from prompt_diffusion_tpu_torch.tools.loaders import load_textual_inversion

        return load_textual_inversion(self.text_encoder, tokenizer, path_or_sd, token=token)

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    def jax_modules(self) -> dict:
        """{JAX parameter namespace: module}, for `tools.jax_bridge`."""
        return {"unet": self.unet, "controlnet": self.controlnet, "vae": self.vae,
                "clip": self.text_encoder}

    def state_dicts(self) -> dict:
        """{namespace: state dict}, what `tools.torch_import.
        export_ldm_checkpoint` writes."""
        return {name: m.state_dict() for name, m in self.jax_modules().items()}

    def encode_prompt(self, token_ids: torch.Tensor) -> torch.Tensor:
        return self.text_encoder(token_ids.to(self.device))["last_hidden_state"]

    def encode_long_prompt(self, token_ids: torch.Tensor, windows: int = 3,
                           clip_skip: int = 0) -> torch.Tensor:
        """Long-prompt encoding by 77-token windows: the caller's SOT and
        EOT stripped, the content cut (or EOT-padded) to windows x 75
        tokens, each chunk wrapped in SOT/EOT and encoded alone, the hidden
        states concatenated along the sequence: (B, windows * 77, D).
        `clip_skip` k > 0 takes CLIP's hidden state `k + 1` layers from the
        end in place of the final one."""
        ids = token_ids.to(self.device)
        b = ids.shape[0]
        content = ids[:, 1:-1]
        per = 75
        need = windows * per
        pad = torch.full((b, max(0, need - content.shape[1])), EOT, dtype=ids.dtype,
                         device=ids.device)
        content = torch.cat([content[:, :need], pad], dim=1)[:, :need]
        layer = None if clip_skip == 0 else clip_skip + 1
        sot = torch.full((b, 1), SOT, dtype=ids.dtype, device=ids.device)
        eot = torch.full((b, 1), EOT, dtype=ids.dtype, device=ids.device)
        outs = []
        for w in range(windows):
            chunk = torch.cat([sot, content[:, w * per:(w + 1) * per], eot], dim=1)
            enc = self.text_encoder(chunk, output_hidden_layer=layer)
            outs.append(enc["last_hidden_state"] if layer is None else enc["hidden"])
        return torch.cat(outs, dim=1)

    @torch.no_grad()
    def encode_image(self, images: torch.Tensor,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """images (B, H, W, 3) in [-1, 1] -> sampled, shifted and scaled
        latents (B, H/8, W/8, 4); the sampling noise is drawn from
        `generator`."""
        cfg = self.vae.config
        x = images.to(self.device).permute(_NCHW).contiguous(memory_format=torch.channels_last)
        z = sample_from_moments(self.vae.encode_moments(x), generator)
        return ((z - cfg.shift_factor) * cfg.scale_factor).permute(_NHWC)

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

    def sampler_tables(self, sampler: str, num_steps: int, eta: float = 0.0):
        """The step tables of `sampler`: UniPC's, DPM-Solver's (both
        variants) or DDIM's (DDIM and PLMS)."""
        if sampler == "unipc":
            return UniPCTables.create(self.schedule, num_steps)
        if sampler in ("dpm++", "dpm"):
            return DPMTables.create(self.schedule, num_steps)
        return DDIMTables.create(self.schedule, num_steps, eta=eta)

    def draw_noise(self, query: torch.Tensor, generator: Optional[torch.Generator] = None,
                   init_noise: Optional[torch.Tensor] = None, **_) -> dict:
        """What `generate` draws from `generator` before its loop, for the
        whole batch of `query`: x_T (B, H/8, W/8, 4) fp32 as `init_noise`,
        unless it is given. Takes `generate`'s keyword arguments (the rest
        ignored); `pipelines/sharded.py` draws through it."""
        if init_noise is None:
            b, img_h, img_w = query.shape[:3]
            init_noise = torch.randn((b, img_h // 8, img_w // 8, 4), generator=generator,
                                     device=self.device, dtype=torch.float32)
        return {"init_noise": init_noise.to(device=self.device, dtype=torch.float32)}

    @torch.no_grad()
    def generate(
        self,
        token_ids: torch.Tensor,  # (B, 77) prompt ids
        neg_token_ids: torch.Tensor,  # (B, 77) negative/uncond ids
        example_pair: torch.Tensor,  # (B, H, W, 6) condition‖image, [-1, 1]
        query: torch.Tensor,  # (B, H, W, 3) query condition, [-1, 1]
        num_steps: int = 50,
        guidance_scale: Scale = 9.0,  # a number or (B, 1, 1, 1)
        control_scale: Scale = 1.0,  # a number or (B, 1, 1, 1)
        eta: float = 0.0,
        guess_mode: bool = False,
        init_noise: Optional[torch.Tensor] = None,  # (B, H/8, W/8, 4)
        sampler: str = "ddim",
        control_guidance_start: float = 0.0,
        control_guidance_end: float = 1.0,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Returns images (B, H, W, 3) in [0, 1], fp32. The starting noise
        is `init_noise` when given, else drawn from `generator`, which
        also gives the per-step noise when eta > 0 (DDIM only).
        `sampler` is one of `SAMPLERS`: "ddim" (the reference's default),
        "plms", "unipc" (the reference's diffusers scripts), "dpm++" or
        "dpm" (DPM-Solver multistep order 2, data or noise prediction).
        `control_guidance_start/end` keep the ControlNet on the steps whose
        fraction [i/N, (i+1)/N) of the table lies inside the window."""
        if sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r}; one of {SAMPLERS}")
        if sampler != "ddim" and eta != 0.0:
            raise ValueError(f"eta>0 is DDIM-only (got sampler={sampler!r})")
        validate_window(control_guidance_start, control_guidance_end)
        self.check_inputs(token_ids, neg_token_ids, example_pair, query)
        tables = self.sampler_tables(sampler, num_steps, eta)
        keep = None
        if not is_default_window(control_guidance_start, control_guidance_end):
            keep = keep_by_timestep(tables.timesteps, self.schedule.num_timesteps,
                                    control_guidance_start, control_guidance_end)
        eps_fn = self.make_eps_fn(token_ids, neg_token_ids, example_pair, query,
                                  guidance_scale, control_scale, guess_mode, control_keep=keep)
        x = self.draw_noise(query, generator, init_noise)["init_noise"].permute(_NCHW)
        if sampler == "unipc":
            x = unipc_sample_loop(eps_fn, x, tables)
        elif sampler in ("dpm++", "dpm"):
            x = dpm_solver_multistep_loop(eps_fn, x, tables, predict_x0=(sampler == "dpm++"))
        elif sampler == "plms":
            x = plms_sample_loop(eps_fn, x, tables)
        else:
            # every table entry runs: more than num_steps when 1000 % num_steps != 0; one
            # rank of a sharded call takes its rows of the whole batch's step noise
            shard = batch_shard()
            x = ddim_sample_loop(eps_fn, x, tables, generator=generator if eta > 0.0 else None,
                                 noise_rows=None if shard is None else (shard.batch, shard.rows))
        return self.decode_latents(x.permute(_NHWC))

    @torch.no_grad()
    def make_eps_fn(self, token_ids, neg_token_ids, example_pair, query,
                    guidance_scale: Scale = 9.0, control_scale: Scale = 1.0,
                    guess_mode: bool = False, control_keep: Optional[np.ndarray] = None):
        """Encodes the prompts and the hint once and returns
        `eps_fn(x, t)`: ControlNet + UNet on the uncond || cond double
        batch and the classifier-free guidance, for NCHW latents x.
        `control_keep`, a (T,) table of 0/1 per DDPM timestep
        (`control_window.keep_by_timestep`), scales the control at each
        step; the factor is gathered on the device, so the loop never
        waits for it."""
        dev = self.device
        b = query.shape[0]
        # uncond first, cond second
        context2 = torch.cat([self.encode_prompt(neg_token_ids), self.encode_prompt(token_ids)])
        to_nchw = lambda t: t.to(dev).permute(_NCHW).contiguous(memory_format=torch.channels_last)
        pair2 = to_nchw(torch.cat([example_pair] * 2))
        query2 = to_nchw(torch.cat([query] * 2))
        if isinstance(guidance_scale, torch.Tensor):
            guidance_scale = guidance_scale.to(device=dev, dtype=torch.float32)
        # a per-sample (B, 1, 1, 1) control scale covers both halves of the double batch
        if isinstance(control_scale, torch.Tensor):
            control_scale = control_scale.to(device=dev, dtype=torch.float32)
            if control_scale.ndim >= 2:
                control_scale = torch.cat([control_scale] * 2)
        if guess_mode:
            # strength * 0.825^(12 - i) over the 13 taps, fp32 as in JAX
            decay = np.float32(0.825) ** np.arange(12, -1, -1, dtype=np.float32)
            if isinstance(control_scale, torch.Tensor):
                ctrl_scale = tuple(control_scale * float(d) for d in decay)
            else:
                ctrl_scale = tuple(float(np.float32(control_scale) * d) for d in decay)
            # the uncond half of the double batch gets no control at all
            branch_mask = torch.cat([torch.zeros(b, 1, 1, 1), torch.ones(b, 1, 1, 1)]).to(dev)
        else:
            ctrl_scale, branch_mask = control_scale, None
        keep = None if control_keep is None else torch.from_numpy(control_keep).to(dev)

        hint2 = self.controlnet(example_pair=pair2, query=query2, hint_only=True)

        def eps_fn(x, t_b):
            x2 = torch.cat([x, x])
            t2 = torch.cat([t_b, t_b])
            scale = ctrl_scale
            if keep is not None:
                k = keep[t_b[0].long()]
                scale = (tuple(c * k for c in ctrl_scale) if isinstance(ctrl_scale, tuple)
                         else ctrl_scale * k)
            control = self.controlnet(x2, t2, context=context2, conditioning_scale=scale,
                                      guided_hint=hint2)
            if branch_mask is not None:
                control = tuple(c * branch_mask.to(c.dtype) for c in control)
            eps_uncond, eps_cond = self.unet(x2, t2, context2, control=control).chunk(2)
            return eps_uncond + guidance_scale * (eps_cond - eps_uncond)

        return eps_fn
