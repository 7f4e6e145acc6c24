"""SD3 Prompt-Diffusion (flow-matching ControlNet) training step.

Counterpart of `prompt_diffusion_tpu/training/sd3.py`
(train_promptdiffusion_sd3.py:1180-1317 of the reference):
  * the target image VAE-encoded with SD3's shift and scale (:1199-1201);
  * logit-normal timestep sampling and the sigma lookup (:1207-1216);
  * noisy = (1 - sigma) * z + sigma * noise (:1217);
  * the query condition VAE-encoded, the support pair through down_proj
    and the VAE encoder (:1240-1257), with gradients to down_proj;
  * the ControlNet's block residuals into the frozen transformer
    (:1260-1279);
  * optional EDM preconditioning and the sigma-weighted flow-matching MSE
    (:1284-1309).
The ControlNet and down_proj train; the transformer, the VAE and the text
encoders are frozen (the text embeddings come precomputed in the batch).
Optimizer, masters, EMA, draws and the sharded step as in
`training/sd15.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, NamedTuple, Optional

import torch

from prompt_diffusion_tpu_torch.parallel.mesh import batch_slice, mean_over_ranks, world_size
from prompt_diffusion_tpu_torch.schedulers.flow_match import (
    FlowMatchSchedule,
    logit_normal_timestep_density,
)
from prompt_diffusion_tpu_torch.training.optimizer import (
    AdamW,
    TrainState,
    finish_step,
    step_generator,
)

_NCHW = (0, 3, 1, 2)
WEIGHTING_SCHEMES = ("logit_normal", "uniform", "sigma_sqrt")


@dataclasses.dataclass(frozen=True)
class SD3TrainConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 1e-4
    max_grad_norm: float = 1.0
    logit_mean: float = 0.0
    logit_std: float = 1.0
    weighting_scheme: str = "logit_normal"  # sampling density; loss weight below
    precondition_outputs: bool = False
    use_ema: bool = False
    ema_decay: float = 0.9999
    accum_steps: int = 1
    shift: float = 3.0


class SD3Draws(NamedTuple):
    """One micro-step's random numbers (the JAX step's five keys): the
    VAE's sampling noise of the target (B, z, h, w), the standard normals
    of the logit-normal density (B,), the noise (B, z, h, w), and the
    sampling noise of the query condition's and the support pair's
    encodes; NCHW, fp32, on the pipeline's device."""

    enc: torch.Tensor
    normals: torch.Tensor
    noise: torch.Tensor
    cond: torch.Tensor
    pair: torch.Tensor


def make_sd3_draws(gen: torch.Generator, latent_shape) -> SD3Draws:
    dev = gen.device
    randn = lambda shape: torch.randn(shape, generator=gen, device=dev)
    return SD3Draws(randn(latent_shape), randn((latent_shape[0],)), randn(latent_shape),
                    randn(latent_shape), randn(latent_shape))


def make_sd3_optimizer(cfg: SD3TrainConfig) -> AdamW:
    return AdamW(lambda _: cfg.learning_rate, cfg.weight_decay, cfg.max_grad_norm,
                 cfg.accum_steps)


def init_sd3_train_state(cfg: SD3TrainConfig, pipe, seed: int = 0, mesh=None) -> TrainState:
    """The state at step 0 over the ControlNet and down_proj, the only
    tensors that then record gradients (this rank's chunks with a `mesh`)."""
    for m in pipe.jax_modules().values():
        m.requires_grad_(False)
    named = {f"{ns}.{n}": p for ns in ("controlnet", "down_proj")
             for n, p in getattr(pipe, ns).named_parameters()}
    return TrainState(named, cfg.accum_steps, cfg.use_ema, seed, mesh)


def sd3_device_batch(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    """The step's tensors on `device`: NHWC images stay NHWC (the
    pipeline's encodes take them), the text embeddings as they are."""
    return {k: torch.as_tensor(batch[k]).to(device)
            for k in ("image", "control", "support_cond", "support_image", "context", "pooled")}


def sd3_loss(pipe, cfg: SD3TrainConfig, sched: FlowMatchSchedule,
             batch: Mapping[str, torch.Tensor], draws: SD3Draws) -> torch.Tensor:
    """The step's loss on an `sd3_device_batch`, in the JAX loss's order."""
    nchw = lambda x: x.permute(_NCHW).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        z = pipe._encode_vae(nchw(batch["image"]), None, draws.enc)
    b, T = z.shape[0], sched.num_train_timesteps
    u = logit_normal_timestep_density(b, cfg.logit_mean, cfg.logit_std, normals=draws.normals)
    idx = torch.clamp((u * T).to(torch.int32), 0, T - 1).long()
    sigmas, timesteps = sched.sigmas[idx], sched.timesteps[idx]
    noisy = sched.add_noise(z, sigmas, draws.noise)
    with torch.no_grad():
        cond_lat = pipe._encode_vae(nchw(batch["control"]), None, draws.cond)
    pair_lat = pipe.support_pair_latents(batch["support_cond"], batch["support_image"],
                                         noise=draws.pair)
    control = pipe.controlnet(noisy, timesteps, cond_lat, pair_lat, batch["context"],
                              batch["pooled"])
    pred = pipe.transformer(noisy, timesteps, batch["context"], batch["pooled"],
                            block_controlnet_hidden_states=control)
    s = sigmas.reshape(b, 1, 1, 1)
    if cfg.precondition_outputs:
        pred, target = pred * (-s) + noisy, z
    else:
        target = draws.noise - z
    # "logit_normal" and "uniform" weigh every sample alike: their density
    # shaped the timestep sampling (diffusers' compute_loss_weighting_for_sd3)
    err = (pred.float() - target.float()) ** 2
    if cfg.weighting_scheme == "sigma_sqrt":
        err = (1.0 / torch.clamp(s ** 2, min=1e-8)) * err
    return torch.mean(err)


def make_sd3_train_step(pipe, cfg: SD3TrainConfig, opt: Optional[AdamW] = None):
    """step(state, batch, draws=None) -> metrics (loss, grad_norm, step):
    one micro-step in place on `state` and the pipeline's trainable
    tensors.

    batch (NHWC, pixels in [-1, 1]):
      image         (B, H, W, 3) target image
      control       (B, H, W, 3) query condition
      support_cond  (B, H, W, 3) support condition
      support_image (B, H, W, 3) support image
      context       (B, L, joint_dim) precomputed joint text embedding
      pooled        (B, pooled_dim) precomputed pooled embedding
    With a mesh on the state, `batch` is this rank's rows and `draws`
    (given or made) cover the global batch."""
    if cfg.weighting_scheme not in WEIGHTING_SCHEMES:
        raise ValueError(f"weighting_scheme {cfg.weighting_scheme!r}: one of "
                         f"{WEIGHTING_SCHEMES}")
    opt = opt or make_sd3_optimizer(cfg)
    sched = FlowMatchSchedule.create(shift=cfg.shift, device=pipe.device)

    def train_step(state: TrainState, batch: Mapping, draws: Optional[SD3Draws] = None) -> dict:
        dev = pipe.device
        b = sd3_device_batch(batch, dev)
        if draws is None:
            n, h, w, _ = b["image"].shape
            shape = (n * world_size(state.mesh), pipe.vae.config.z_channels, h // 8, w // 8)
            draws = make_sd3_draws(step_generator(state.seed, state.step, dev), shape)
        loss = sd3_loss(pipe, cfg, sched, b, batch_slice(draws, state.mesh))
        loss.backward()
        step = state.step
        grad_norm = finish_step(state, opt, cfg.ema_decay)
        return {"loss": mean_over_ranks(loss.detach(), state.mesh), "grad_norm": grad_norm,
                "step": step}

    return train_step
