"""SD1.5 Prompt-Diffusion (ControlNet) training step.

Counterpart of `prompt_diffusion_tpu/training/sd15.py`, the reference's
training semantics:
  * VAE encode, sampled, shifted and scaled (ddpm.py:767-817, 655-662);
  * CFG conditioning dropout, 5% / 5% / 5% (cldm/cldm.py:338-367);
  * q_sample noise (ddpm.py:356-361);
  * ControlNet, then the UNet with the control residuals
    (cldm/cldm.py:369-382);
  * the epsilon or v target and a plain fp32 MSE (ddpm.py:885-920);
  * AdamW on the ControlNet, and with `sd_locked=False` on the UNet
    decoder and head too (cldm/cldm.py:457-464); the UNet encoder is then
    in no optimizer at all, and gets no gradient;
  * the EMA (ldm/modules/ema.py), on optimizer steps only.

The step runs eagerly on the modules' own tensors: the trainable ones
hold the compute dtype and an fp32 master in the `TrainState`
(`training/optimizer.py`). Each micro-step draws the VAE's sampling noise,
t, the noise and the dropout uniforms from a generator seeded by (seed,
step) (`step_generator`), or takes them from `draws=`.

With a mesh on the state (`init_train_state(..., mesh=)`), each rank's
batch is its rows of the global batch; the draws are made (or given) for
the global batch and each rank takes its rows (`parallel.mesh.batch_slice`),
so a sharded step computes the one-rank step on the same global batch. The
loss and grad_norm reported are global.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, NamedTuple, Optional

import torch

from prompt_diffusion_tpu_torch.models.vae import sample_from_moments
from prompt_diffusion_tpu_torch.parallel.mesh import batch_slice, mean_over_ranks, world_size
from prompt_diffusion_tpu_torch.training.lr_schedules import lambda_linear
from prompt_diffusion_tpu_torch.training.optimizer import (
    AdamW,
    TrainState,
    finish_step,
    step_generator,
)

_NCHW = (0, 3, 1, 2)


@dataclasses.dataclass(frozen=True)
class SD15TrainConfig:
    learning_rate: float = 1e-4
    drop_rate: float = 0.05
    parameterization: str = "eps"  # or "v"
    sd_locked: bool = True
    use_ema: bool = False
    ema_decay: float = 0.9999
    accum_steps: int = 1
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0  # diffusers trainer clips at 1.0 (:1116-1118)
    # LambdaLinear warmup (ldm/lr_scheduler.py:81-97 via models/cldm_v15.yaml:21-28:
    # warm_up_steps [10000], f_start 1e-6, f_max 1.0, f_min 1.0)
    warm_up_steps: int = 10_000
    lr_f_start: float = 1e-6
    lr_f_max: float = 1.0
    lr_f_min: float = 1.0


class Draws(NamedTuple):
    """One micro-step's random numbers: the VAE's sampling noise (B, z, h,
    w), t (B,) int64 in [0, T), the noise (B, z, h, w) and the dropout
    uniforms (B,) in [0, 1); NCHW, fp32, on the pipeline's device."""

    enc: torch.Tensor
    t: torch.Tensor
    noise: torch.Tensor
    r: torch.Tensor


def make_draws(gen: torch.Generator, latent_shape, num_timesteps: int) -> Draws:
    b, dev = latent_shape[0], gen.device
    enc = torch.randn(latent_shape, generator=gen, device=dev)
    t = torch.randint(0, num_timesteps, (b,), generator=gen, device=dev)
    noise = torch.randn(latent_shape, generator=gen, device=dev)
    return Draws(enc, t, noise, torch.rand((b,), generator=gen, device=dev))


def is_unet_decoder(name: str) -> bool:
    """The UNet tensors `sd_locked=False` trains: output blocks and the
    head (cldm/cldm.py:459-461)."""
    top = name.split(".", 1)[0]
    return top.startswith("output_blocks_") or top in ("out_norm", "out_conv")


def trainable_params(pipe, cfg: SD15TrainConfig) -> Dict[str, torch.nn.Parameter]:
    """{"controlnet.<name>" | "unet.<name>": tensor} of the trainable set."""
    named = {f"controlnet.{n}": p for n, p in pipe.controlnet.named_parameters()}
    if not cfg.sd_locked:
        named.update({f"unet.{n}": p for n, p in pipe.unet.named_parameters()
                      if is_unet_decoder(n)})
    return named


def lr_schedule(cfg: SD15TrainConfig):
    """The reference's LambdaLinear warmup (unity after the warmup in the PD
    config, where f_min == f_max == 1)."""
    return lambda_linear(cfg.learning_rate, warm_up_steps=cfg.warm_up_steps,
                         f_start=cfg.lr_f_start, f_max=cfg.lr_f_max, f_min=cfg.lr_f_min)


def make_optimizer(cfg: SD15TrainConfig) -> AdamW:
    return AdamW(lr_schedule(cfg), cfg.weight_decay, cfg.max_grad_norm, cfg.accum_steps)


def init_train_state(cfg: SD15TrainConfig, pipe, seed: int = 0, mesh=None) -> TrainState:
    """The state of a run at step 0: the trainable set of `pipe` (the only
    tensors that then record gradients), its masters, zero moments and the
    EMA's copy (this rank's chunks of them with a `mesh`); draws seeded
    from `seed`."""
    for m in pipe.jax_modules().values():
        m.requires_grad_(False)
    return TrainState(trainable_params(pipe, cfg), cfg.accum_steps, cfg.use_ema, seed, mesh)


def device_batch(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    """The step's arrays on `device`: images NCHW in channels_last memory."""
    out = {}
    for key in ("image", "query", "example_pair", "token_ids", "null_ids"):
        v = torch.as_tensor(batch[key]).to(device)
        if v.ndim == 4:
            v = v.permute(_NCHW).contiguous(memory_format=torch.channels_last)
        out[key] = v
    return out


def sd15_pred_target(pipe, cfg: SD15TrainConfig, batch: Mapping[str, torch.Tensor],
                     draws: Draws):
    """(the UNet's prediction, the target) of the step's loss on a
    `device_batch`, in the JAX loss's order."""
    sched, d = pipe.schedule, cfg.drop_rate
    vcfg = pipe.vae.config
    with torch.no_grad():
        z = sample_from_moments(pipe.vae.encode_moments(batch["image"]), noise=draws.enc)
        z = (z - vcfg.shift_factor) * vcfg.scale_factor
        x_t = sched.q_sample(z, draws.t, draws.noise)
        ctx = pipe.encode_prompt(batch["token_ids"])
        null_ctx = pipe.encode_prompt(batch["null_ids"])
    # CFG dropout (cldm/cldm.py:354-365): r < 2d drops the text, d <= r < 3d
    # zeroes the example pair (both in [d, 2d))
    r = draws.r
    ctx = torch.where((r < 2 * d)[:, None, None], null_ctx.to(ctx.dtype), ctx)
    pair = batch["example_pair"]
    pair = pair * (1.0 - ((r >= d) & (r < 3 * d)).to(pair.dtype))[:, None, None, None]
    control = pipe.controlnet(x_t, draws.t, pair, batch["query"], ctx)
    pred = pipe.unet(x_t, draws.t, ctx, control=control)
    target = sched.get_v(z, draws.noise, draws.t) if cfg.parameterization == "v" else draws.noise
    return pred, target


def sd15_loss(pipe, cfg: SD15TrainConfig, batch: Mapping[str, torch.Tensor],
              draws: Draws) -> torch.Tensor:
    """The step's loss: the fp32 MSE of `sd15_pred_target`."""
    pred, target = sd15_pred_target(pipe, cfg, batch, draws)
    return torch.mean((pred.float() - target.float()) ** 2)


def make_train_step(pipe, cfg: SD15TrainConfig, opt: Optional[AdamW] = None):
    """step(state, batch, draws=None) -> metrics: one micro-step in place
    on `state` and the pipeline's trainable tensors.

    batch: NHWC arrays with the JAX trainer's keys and ranges
    (edit_dataset.py:54-63, laion_meta_dataset.py:57-63):
      image        (B, H, W, 3) target image, [-1, 1]
      query        (B, H, W, 3) query condition, [0, 1]
      example_pair (B, H, W, 6) condition [0, 1] || image [-1, 1]
      token_ids    (B, 77) prompt ids
      null_ids     (1, 77) ids of the empty prompt
    With a mesh on the state, `batch` is this rank's rows and `draws`
    (given or made) cover the global batch.
    metrics: loss, grad_norm (the micro-step gradient before clipping,
    over the trainable set; JAX's metric also counts the frozen UNet
    encoder's gradient under `sd_locked=False`, which the port does not
    compute), lr (the rate of this step's optimizer update), step."""
    opt = opt or make_optimizer(cfg)
    schedule = lr_schedule(cfg)

    def train_step(state: TrainState, batch: Mapping, draws: Optional[Draws] = None) -> dict:
        dev = pipe.device
        b = device_batch(batch, dev)
        if draws is None:
            n, _, h, w = b["image"].shape
            shape = (n * world_size(state.mesh), pipe.vae.config.z_channels, h // 8, w // 8)
            draws = make_draws(step_generator(state.seed, state.step, dev), shape,
                               pipe.schedule.num_timesteps)
        loss = sd15_loss(pipe, cfg, b, batch_slice(draws, state.mesh))
        loss.backward()
        metrics = {"lr": schedule(state.step // cfg.accum_steps), "step": state.step}
        grad_norm = finish_step(state, opt, cfg.ema_decay)
        return {"loss": mean_over_ranks(loss.detach(), state.mesh), "grad_norm": grad_norm,
                **metrics}

    return train_step
