"""SD3 Prompt-Diffusion inference pipeline for PyTorch and CUDA.

Counterpart of `prompt_diffusion_tpu/pipelines/prompt_diffusion_sd3.py`
(the reference's `SD3PromptDiffusionPipeLine`):
  * triple text encoding: CLIP-L and CLIP-bigG penultimate states joined
    along the width and zero-padded to the T5 width, the T5 sequence
    appended after them; pooled = CLIP-L pooled || CLIP-bigG pooled;
  * the support pair goes through `down_proj` (6 -> 3 channels) and the
    VAE encoder, the query condition through the VAE encoder, each sampled
    from its moments and shifted and scaled into latent space;
  * a flow-match Euler loop; each step runs ControlNet + MMDiT on the
    uncond || cond double batch (uncond first) and applies classifier-free
    guidance; the ControlNet window scales its taps per step;
  * the VAE decodes with SD3's shift and scale.
`create(policy=int8_policy())` is the int8 W8A8 serving mode of
`bench.py --config sd3`. T5-XXL may run staged: `encode_t5` once per
prompt, free the encoder, and hand the sequences to `generate` as
`t5_seq` / `neg_t5_seq`, which take precedence over T5 token ids.

Images cross the API as NHWC tensors in [-1, 1] and come back NHWC in
[0, 1], as in the JAX package; inside, latents are NCHW in channels_last
memory. Random numbers (the VAE sampling noise of the two encodes, then
x_T) come from one `torch.Generator`, in that order.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from prompt_diffusion_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from prompt_diffusion_tpu_torch.models.controlnet_sd3 import SD3ControlNet, SupportPairDownProj
from prompt_diffusion_tpu_torch.models.mmdit_sd3 import SD3Transformer
from prompt_diffusion_tpu_torch.models.t5_text import T5Encoder
from prompt_diffusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig, sample_from_moments
from prompt_diffusion_tpu_torch.pipelines.control_window import (
    control_keep,
    is_default_window,
    validate_window,
)
from prompt_diffusion_tpu_torch.schedulers.flow_match import flow_match_step, make_inference_sigmas
from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy, int8_policy

_NCHW = (0, 3, 1, 2)
_NHWC = (0, 2, 3, 1)

SD3_VAE = VAEConfig(z_channels=16, scale_factor=1.5305, shift_factor=0.0609)
CLIP_G = CLIPTextConfig(hidden_size=1280, num_layers=32, num_heads=20, intermediate_size=5120,
                        activation="gelu")


def _nchw(images: torch.Tensor, device) -> torch.Tensor:
    return images.to(device).permute(_NCHW).contiguous(memory_format=torch.channels_last)


@dataclasses.dataclass
class PromptDiffusionSD3:
    """The seven models; `t5` None runs the zero-padded T5 slots unless a
    staged T5 sequence is given."""

    transformer: SD3Transformer
    controlnet: SD3ControlNet
    down_proj: SupportPairDownProj
    vae: AutoencoderKL
    clip_l: CLIPTextModel
    clip_g: CLIPTextModel
    t5: Optional[T5Encoder] = None

    @classmethod
    def create(cls, transformer=None, controlnet=None, down_proj=None, vae=None, clip_l=None,
               clip_g=None, t5=None, policy: Optional[DTypePolicy] = None,
               vae_int8: bool = False, device: torch.device | str = "cuda"):
        """Builds the default SD3 models (or takes the given ones) on
        `device` (the card unless the caller asks for the CPU), in eval
        mode. `policy=` sets the transformer/ControlNet policy
        (`int8_policy()` for the serving mode); the VAE and the text
        encoders keep their defaults, except that `vae_int8=True` builds
        the VAE under `int8_policy()`. No T5 is built: pass one, or run it
        staged (`encode_t5`)."""
        with torch.device(device):
            if policy is not None:
                transformer = transformer or SD3Transformer(policy=policy)
                controlnet = controlnet or SD3ControlNet(policy=policy)
            if vae_int8:
                vae = vae or AutoencoderKL(SD3_VAE, int8_policy())
            models = dict(
                transformer=transformer or SD3Transformer(),
                controlnet=controlnet or SD3ControlNet(),
                down_proj=down_proj or SupportPairDownProj(),
                vae=vae or AutoencoderKL(SD3_VAE),
                clip_l=clip_l or CLIPTextModel(),
                clip_g=clip_g or CLIPTextModel(CLIP_G),
            )
        if t5 is not None:
            models["t5"] = t5
        for m in models.values():
            m.to(device=device, memory_format=torch.channels_last).eval().requires_grad_(False)
        return cls(**models)

    @classmethod
    def from_folder(cls, root: str, policy: Optional[DTypePolicy] = None,
                    vae_int8: bool = False, device: torch.device | str = "cuda",
                    t5=False, **create_kwargs):
        """The pipeline from an SD3 diffusers folder
        (`tools.diffusers_import.import_sd3_folder`), built through `create`
        on the meta device, so nothing is initialised, then loaded onto
        `device`. `t5=True` also builds T5-XXL's widths with the folder's
        text_encoder_3/ depth (a T5Encoder built on the meta device may be
        given instead) and requires that folder; run it staged with
        `stage_t5`. Every other model comes from its folder, or loaded in
        `create_kwargs` (kept as given), else this raises."""
        from prompt_diffusion_tpu_torch.models.t5_text import T5Config
        from prompt_diffusion_tpu_torch.tools.diffusers_import import import_sd3_folder
        from prompt_diffusion_tpu_torch.tools.jax_bridge import (
            check_materialized,
            load_state_dicts,
        )
        from prompt_diffusion_tpu_torch.tools.loaders import build_on_meta

        pipe, todo = build_on_meta(cls, device, create_kwargs, policy=policy, vae_int8=vae_int8)
        sds = import_sd3_folder(root, num_layers=pipe.transformer.config.num_layers,
                                controlnet_layers=pipe.controlnet.config.num_layers)
        if t5 is not False and "t5" not in sds:
            raise ValueError(f"{root} has no text_encoder_3/: T5 weights are required for "
                             "the T5 branch")
        if t5 is True:
            layers = 1 + max(int(k.split(".")[0][len("blocks_"):]) for k in sds["t5"]
                             if k.startswith("blocks_"))
            with torch.device("meta"):
                t5 = T5Encoder(T5Config(num_layers=layers))
        if t5 is not False:
            pipe.t5 = t5.eval().requires_grad_(False)
            todo.add("t5")
        sds = {n: sd for n, sd in sds.items() if n in todo}
        load_state_dicts(pipe, sds, namespaces=set(sds), device=device)
        check_materialized(pipe)
        return pipe

    def stage_t5(self, *ids_t5: torch.Tensor) -> list:
        """The staged T5 path of `bench.py --config sd3`: encodes each (B, L)
        id tensor with the pipeline's T5, then frees the encoder. Pass the
        sequences to `generate` as `t5_seq` / `neg_t5_seq`."""
        seqs = [self.encode_t5(self.t5, ids) for ids in ids_t5]
        self.t5 = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return seqs

    @property
    def device(self) -> torch.device:
        return next(self.transformer.parameters()).device

    def jax_modules(self) -> dict:
        """{JAX parameter namespace: module}, for `tools.jax_bridge`; "t5"
        only when the pipeline holds a T5 encoder."""
        mods = {"transformer": self.transformer, "controlnet": self.controlnet,
                "down_proj": self.down_proj, "vae": self.vae, "clip_l": self.clip_l,
                "clip_g": self.clip_g}
        if self.t5 is not None:
            mods["t5"] = self.t5
        return mods

    # ---- text encoding ---------------------------------------------------

    @torch.no_grad()
    def encode_prompt(self, ids_l: torch.Tensor, ids_g: torch.Tensor,
                      ids_t5: Optional[torch.Tensor] = None, t5_len: int = 256,
                      t5_seq: Optional[torch.Tensor] = None):
        """-> (joint sequence (B, 77 + L_t5, joint_dim) fp32, pooled (B,
        2048) fp32). `t5_seq` (B, L, joint_dim), a staged T5 encoding,
        takes precedence over `ids_t5`; with neither, the T5 slots are
        zeros."""
        dev = self.device
        joint_dim = self.transformer.config.joint_attention_dim
        out_l = self.clip_l(ids_l.to(dev), output_hidden_layer=2)
        out_g = self.clip_g(ids_g.to(dev), output_hidden_layer=2)
        clip_seq = torch.cat([out_l["hidden"], out_g["hidden"]], dim=-1)
        clip_seq = torch.nn.functional.pad(clip_seq, (0, joint_dim - clip_seq.shape[-1]))
        pooled = torch.cat([out_l["pooled"], out_g["pooled"]], dim=-1)
        if t5_seq is not None:
            t5_seq = t5_seq.to(device=dev, dtype=torch.float32)
        elif self.t5 is not None and ids_t5 is not None:
            t5_seq = self.t5(ids_t5.to(dev))
        else:
            t5_seq = torch.zeros((ids_l.shape[0], t5_len, joint_dim), device=dev)
        return torch.cat([clip_seq, t5_seq], dim=1), pooled

    @staticmethod
    @torch.no_grad()
    def encode_t5(t5: T5Encoder, ids_t5: torch.Tensor) -> torch.Tensor:
        """The staged T5 path: one T5 forward, (B, L) ids -> (B, L, d_model)
        fp32, on the encoder's device. The caller may free the encoder and
        pass the result to `generate` as `t5_seq`."""
        return t5(ids_t5.to(next(t5.parameters()).device))

    # ---- VAE helpers -----------------------------------------------------

    def _encode_vae(self, images: torch.Tensor, generator, noise=None) -> torch.Tensor:
        """NCHW images -> sampled latents, shifted and scaled, fp32; the
        sampling noise given or drawn from `generator`."""
        cfg = self.vae.config
        z = sample_from_moments(self.vae.encode_moments(images), generator, noise)
        return (z - cfg.shift_factor) * cfg.scale_factor

    def support_pair_latents(self, cond: torch.Tensor, gt: torch.Tensor,
                             generator: Optional[torch.Generator] = None,
                             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """cond, gt (B, H, W, 3) NHWC in [-1, 1] -> pair latents (B, z,
        H/8, W/8) NCHW: down_proj, then the VAE encode, recording gradients
        where they are on (the trainer's path to `down_proj`, through the
        VAE encoder); the sampling noise given or drawn from `generator`."""
        dev = self.device
        mixed = self.down_proj(_nchw(cond, dev), _nchw(gt, dev))
        return self._encode_vae(mixed, generator, noise)

    @torch.no_grad()
    def encode_support_pair(self, cond: torch.Tensor, gt: torch.Tensor,
                            generator: Optional[torch.Generator] = None,
                            noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`support_pair_latents` without gradients (inference)."""
        return self.support_pair_latents(cond, gt, generator, noise)

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """latents (B, z, h, w) NCHW -> images (B, 8h, 8w, 3) NHWC in [0, 1]."""
        cfg = self.vae.config
        z = latents / cfg.scale_factor + cfg.shift_factor
        img = self.vae.decode(z.contiguous(memory_format=torch.channels_last))
        return torch.clamp(img / 2 + 0.5, 0.0, 1.0).permute(_NHWC)

    # ---- generation ------------------------------------------------------

    def check_inputs(self, prompt_ids, neg_prompt_ids, control_image, support_cond,
                     support_image):
        """Input validation with actionable messages."""
        b, h, w, c = control_image.shape
        if c != 3:
            raise ValueError(f"control_image must be (B,H,W,3) NHWC, got channels={c}")
        for name, img in (("support_cond", support_cond), ("support_image", support_image)):
            if tuple(img.shape) != (b, h, w, 3):
                raise ValueError(f"{name} must match control_image: expected {(b, h, w, 3)}, "
                                 f"got {tuple(img.shape)}")
        step = 8 * self.transformer.config.patch_size
        if h % step or w % step:
            raise ValueError(f"image size must be divisible by {step} (VAE downsampling and "
                             f"patchify), got {h}x{w}")
        for name, ids in (("prompt_ids", prompt_ids), ("neg_prompt_ids", neg_prompt_ids)):
            for key in ("l", "g"):
                if ids[key].shape[0] != b:
                    raise ValueError(f"{name}[{key!r}] batch {ids[key].shape[0]} != image "
                                     f"batch {b}")

    def draw_noise(self, control_image: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   pair_noise: Optional[torch.Tensor] = None,
                   cond_noise: Optional[torch.Tensor] = None,
                   init_noise: Optional[torch.Tensor] = None, **_) -> dict:
        """What `generate` draws from `generator`, in its order, for the
        whole batch of `control_image`: the VAE sampling noise of the
        support pair, then of the query condition ((B, z, H/8, W/8) NCHW
        fp32, as the moments are), then x_T as `init_noise` ((B, H/8, W/8,
        z) NHWC), each unless given. Takes `generate`'s keyword arguments
        (the rest ignored); `pipelines/sharded.py` draws through it."""
        b, img_h, img_w = control_image.shape[:3]
        shape = (b, self.vae.config.z_channels, img_h // 8, img_w // 8)
        draw = lambda given: (torch.randn(shape, generator=generator, device=self.device)
                              if given is None else given)
        pair_noise = draw(pair_noise)
        cond_noise = draw(cond_noise)
        if init_noise is None:
            init_noise = draw(None).permute(_NHWC)
        return {"pair_noise": pair_noise, "cond_noise": cond_noise, "init_noise": init_noise}

    @torch.no_grad()
    def generate(
        self,
        prompt_ids: Mapping[str, torch.Tensor],  # l=(B,77), g=(B,77), t5=(B,L) optional
        neg_prompt_ids: Mapping[str, torch.Tensor],
        control_image: torch.Tensor,  # (B, H, W, 3) query condition, [-1, 1]
        support_cond: torch.Tensor,  # (B, H, W, 3) support condition, [-1, 1]
        support_image: torch.Tensor,  # (B, H, W, 3) support image, [-1, 1]
        num_steps: int = 28,
        guidance_scale: float = 7.0,
        controlnet_conditioning_scale: float = 1.0,
        shift: float = 3.0,
        control_guidance_start: float = 0.0,
        control_guidance_end: float = 1.0,
        init_noise: Optional[torch.Tensor] = None,  # (B, H/8, W/8, z) NHWC
        t5_seq: Optional[torch.Tensor] = None,  # staged T5 states of the prompt
        neg_t5_seq: Optional[torch.Tensor] = None,  # ... and of the negative prompt
        generator: Optional[torch.Generator] = None,
        pair_noise: Optional[torch.Tensor] = None,  # (B, z, H/8, W/8) NCHW
        cond_noise: Optional[torch.Tensor] = None,  # (B, z, H/8, W/8) NCHW
    ) -> torch.Tensor:
        """Returns images (B, H, W, 3) in [0, 1], fp32. What is not given of
        the VAE sampling noise and x_T is drawn from `generator` first
        (`draw_noise`)."""
        validate_window(control_guidance_start, control_guidance_end)
        windowed = not is_default_window(control_guidance_start, control_guidance_end)
        self.check_inputs(prompt_ids, neg_prompt_ids, control_image, support_cond, support_image)
        b = control_image.shape[0]
        noise = self.draw_noise(control_image, generator, pair_noise, cond_noise, init_noise)
        velocity_fn = self.make_velocity_fn(prompt_ids, neg_prompt_ids, control_image,
                                            support_cond, support_image, guidance_scale,
                                            t5_seq=t5_seq, neg_t5_seq=neg_t5_seq,
                                            pair_noise=noise["pair_noise"],
                                            cond_noise=noise["cond_noise"])
        timesteps, sigmas = make_inference_sigmas(num_steps, shift=shift)
        x = noise["init_noise"].to(device=self.device, dtype=torch.float32).permute(_NCHW)
        for i in range(num_steps):
            t_b = torch.full((b,), float(np.float32(timesteps[i])), device=self.device)
            cond_scale = controlnet_conditioning_scale
            if windowed:
                cond_scale = cond_scale * control_keep(i, num_steps, control_guidance_start,
                                                       control_guidance_end)
            x = flow_match_step(x, velocity_fn(x, t_b, cond_scale), sigmas[i], sigmas[i + 1])
        return self.decode_latents(x)

    @torch.no_grad()
    def make_velocity_fn(self, prompt_ids, neg_prompt_ids, control_image, support_cond,
                         support_image, guidance_scale: float = 7.0, t5_seq=None,
                         neg_t5_seq=None, generator: Optional[torch.Generator] = None,
                         pair_noise=None, cond_noise=None):
        """Encodes the prompts, the support pair and the query condition once
        (the VAE sampling noise given, or from `generator`, pair first) and returns
        `velocity_fn(x, t_b, conditioning_scale=1.0)`: ControlNet + MMDiT on
        the uncond || cond double batch and the classifier-free guidance,
        for NCHW latents x and (B,) fp32 timesteps."""
        dev = self.device
        ctx_c, pool_c = self.encode_prompt(prompt_ids["l"], prompt_ids["g"],
                                           prompt_ids.get("t5"), t5_seq=t5_seq)
        ctx_u, pool_u = self.encode_prompt(neg_prompt_ids["l"], neg_prompt_ids["g"],
                                           neg_prompt_ids.get("t5"), t5_seq=neg_t5_seq)
        context2 = torch.cat([ctx_u, ctx_c])  # uncond first
        pooled2 = torch.cat([pool_u, pool_c])
        pair_lat = self.encode_support_pair(support_cond, support_image, generator, pair_noise)
        cond_lat = self._encode_vae(_nchw(control_image, dev), generator, cond_noise)
        pair2, cond2 = torch.cat([pair_lat] * 2), torch.cat([cond_lat] * 2)

        def velocity_fn(x, t_b, conditioning_scale=1.0):
            x2, t2 = torch.cat([x, x]), torch.cat([t_b, t_b])
            control = self.controlnet(x2, t2, cond2, pair2, context2, pooled2,
                                      conditioning_scale=conditioning_scale)
            v_u, v_c = self.transformer(x2, t2, context2, pooled2,
                                        block_controlnet_hidden_states=control).chunk(2)
            return v_u + guidance_scale * (v_c - v_u)

        return velocity_fn
