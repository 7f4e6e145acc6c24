"""SD1.5 Prompt-Diffusion ControlNet trainer, on the card by default.

    python -m prompt_diffusion_tpu_torch.train_sd15 --data-root DIR
        [--logdir ./logs/run] [--batch-size 8] [--accum-steps 4]
        [--max-steps 10000] [--init-ckpt sd15.ckpt] [--resume]
        [--use-checkpoint] [--use-ema] [--device cuda] [--tiny]

The counterpart of the root `train_sd15.py` (the reference's `train.py`
and `train_promptdiffusion_sd15.py`): `EditDataset` batches
(`data/edit_dataset.py`), the ControlNet step of `training/sd15.py`,
checkpoints with resume (`training/checkpoint.py`), the EMA, image and
metric logs. Reference recipe (train.py:204,259-260): lr 1e-4, batch 64,
grad-accum 4, 10k steps, ControlNet only (sd_locked). `--use-checkpoint`
recomputes the UNet's and ControlNet's blocks in the backward pass
(BASELINE config 5: batch 8 at 512², grad-accum 1, checkpointing on).
`--init-ckpt` takes a reference `.ckpt` or `.safetensors`; one without
ControlNet weights gets the UNet encoder's (`tool_add_control.py`).
Without it the weights are random (`random_init_`, from `--seed`).
`--tiny` builds the root driver's tiny widths (a CPU-sized run).

Under `torchrun` the run is sharded over every rank (`parallel/mesh.py`):

    torchrun --standalone --nproc-per-node=4 -m prompt_diffusion_tpu_torch.train_sd15 \
        --data-root DIR --num-fsdp 2 ...

builds a (world / num_fsdp) x num_fsdp (data, fsdp) mesh, one card a rank;
`--batch-size` stays global and each rank's loader reads its shard of the
data set, batch / world samples a step; the trainable state is ZeRO-
sharded over `fsdp`; only rank 0 logs and writes checkpoints (the one-card
format, restorable at any world size). Without `torchrun` the run is the
one-device run, and a `--num-fsdp` other than 1 is refused. `--loader
native` decodes the batches with the C++ decoder (`native/`; a failed
build raises), `--loader pil` with PIL; the default `auto` takes native
where it builds on this host, else PIL, and prints which and why.
"""

from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data-root", required=True)
    p.add_argument("--logdir", default="./logs/run")
    p.add_argument("--tasks", nargs="+", default=["canny", "depth", "hed", "normal"])
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=8, help="global batch size")
    p.add_argument("--max-steps", type=int, default=10000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--accum-steps", type=int, default=4)
    p.add_argument("--sd-locked", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--use-ema", action="store_true")
    p.add_argument("--parameterization", choices=["eps", "v"], default="eps")
    p.add_argument("--init-ckpt", default=None,
                   help="reference .ckpt/.safetensors to import (tool_add_control applied)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--ckpt-every", type=int, default=1000)
    p.add_argument("--ckpt-keep", type=int, default=None)
    p.add_argument("--image-log-every", type=int, default=500)
    p.add_argument("--num-fsdp", type=int, default=1,
                   help="fsdp width of the mesh under torchrun (must divide the world)")
    p.add_argument("--loader", choices=["auto", "native", "pil"], default="auto",
                   help="image decoder of the batch loader (auto: native where it builds)")
    p.add_argument("--tokenizer-assets", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true",
                   help="debug: tiny model configs (CPU-runnable smoke)")
    p.add_argument("--use-checkpoint", action="store_true",
                   help="gradient checkpointing of the UNet's and ControlNet's blocks")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def distributed(num_fsdp: int, batch_size: int, device: str):
    """(mesh, device) of the run: under `torchrun` the (data, fsdp) mesh
    over every rank and this rank's device; else (None, device). Refuses a
    `--num-fsdp` that does not divide the world and a global batch the
    world does not divide."""
    from prompt_diffusion_tpu_torch.parallel.mesh import launched, make_mesh, mesh_device

    if not launched():
        if num_fsdp != 1:
            raise SystemExit(f"--num-fsdp {num_fsdp} does not divide the world size 1 "
                             "(launch the entry under torchrun to shard it)")
        return None, device
    try:
        mesh = make_mesh(num_fsdp=num_fsdp, device=device)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if batch_size % mesh.size():
        raise SystemExit(f"--batch-size {batch_size} must be divisible by the mesh's "
                         f"{mesh.size()} data-parallel ranks")
    return mesh, str(mesh_device(mesh))


def build_pipe(tiny: bool, device: str, use_checkpoint: bool = False):
    """The SD1.5 pipeline the trainer builds: default widths, or the root
    driver's tiny ones; bf16 compute; weights not yet initialised."""
    import dataclasses

    from prompt_diffusion_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from prompt_diffusion_tpu_torch.models.controlnet_sd15 import ControlNetSD15
    from prompt_diffusion_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15
    from prompt_diffusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15

    import torch

    ucfg = UNetConfig()
    if tiny:
        ucfg = UNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                          attention_resolutions=(1,), num_heads=4, context_dim=64)
    ucfg = dataclasses.replace(ucfg, use_checkpoint=use_checkpoint)
    with torch.device(device):
        models = dict(unet=UNetSD15(ucfg), controlnet=ControlNetSD15(ucfg))
        if tiny:
            models.update(
                vae=AutoencoderKL(VAEConfig(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1)),
                text_encoder=CLIPTextModel(CLIPTextConfig(hidden_size=64, num_layers=2,
                                                          num_heads=4, intermediate_size=128)))
    return PromptDiffusionSD15.create(**models, device=device)


def init_weights(pipe, seed: int, init_ckpt=None) -> None:
    """Random weights from `seed`, then, with `init_ckpt`, the checkpoint's
    (its UNet encoder into the ControlNet where it has no ControlNet)."""
    import torch

    from prompt_diffusion_tpu_torch.tools.jax_bridge import load_state_dicts
    from prompt_diffusion_tpu_torch.utils.dtypes import random_init_

    gen = torch.Generator(device=pipe.device).manual_seed(seed)
    for m in pipe.jax_modules().values():
        random_init_(m, gen)
    if init_ckpt:
        from prompt_diffusion_tpu_torch.tools.torch_import import (
            controlnet_init_from_unet,
            import_ldm_checkpoint,
        )

        vcfg = pipe.vae.config
        sds = import_ldm_checkpoint(init_ckpt, unet_cfg=pipe.unet.config,
                                    vae_ch_mult=vcfg.ch_mult,
                                    vae_num_res_blocks=vcfg.num_res_blocks,
                                    clip_layers=pipe.text_encoder.config.num_layers)
        if not sds["controlnet"]:
            sds["controlnet"] = controlnet_init_from_unet(sds["unet"],
                                                          pipe.controlnet.state_dict())
        load_state_dicts(pipe, sds, namespaces=set(sds), device=pipe.device)


def main(argv=None) -> dict:
    """Runs the trainer; returns {"pipe", "state", "metrics" and "step_s"
    (each step's metrics, and its seconds from the batch's host work to the
    update's end, the checkpoint save left out), "start_step", "mesh"
    (None without torchrun)}."""
    args = parse_args(argv)
    mesh, device = distributed(args.num_fsdp, args.batch_size, args.device)
    import torch

    from prompt_diffusion_tpu_torch.data.edit_dataset import BatchLoader, EditDataset
    from prompt_diffusion_tpu_torch.data.tokenizer import load_tokenizer
    from prompt_diffusion_tpu_torch.native import choose_decoder
    from prompt_diffusion_tpu_torch.parallel.mesh import batch_rank, is_rank0, world_size
    from prompt_diffusion_tpu_torch.training import checkpoint as ckpt
    from prompt_diffusion_tpu_torch.training.image_logger import ImageLogger, MetricLogger
    from prompt_diffusion_tpu_torch.training.sd15 import (
        SD15TrainConfig,
        init_train_state,
        make_train_step,
    )

    lead = is_rank0(mesh)  # logs, prints and writes checkpoints
    pipe = build_pipe(args.tiny, device, args.use_checkpoint)
    init_weights(pipe, args.seed, args.init_ckpt)
    cfg = SD15TrainConfig(learning_rate=args.lr, sd_locked=args.sd_locked,
                          use_ema=args.use_ema, accum_steps=args.accum_steps,
                          parameterization=args.parameterization)
    state = init_train_state(cfg, pipe, seed=args.seed + 1, mesh=mesh)

    manager = ckpt.make_manager(f"{args.logdir}/checkpoints", save_every=args.ckpt_every,
                                keep=args.ckpt_keep)
    start_step = ckpt.resume(manager, state) if args.resume else 0
    if start_step and lead:
        print(f"resumed from step {start_step}")

    tokenizer = load_tokenizer(args.tokenizer_assets)
    dataset = EditDataset(args.data_root, task_list=args.tasks, resolution=args.resolution)
    loader = BatchLoader(dataset, batch_size=args.batch_size // world_size(mesh),
                         seed=args.seed, tokenizer=tokenizer, shard_id=batch_rank(mesh),
                         num_shards=world_size(mesh),
                         decoder=choose_decoder(args.loader, print if lead else lambda m: None))
    step_fn = make_train_step(pipe, cfg)
    imlog = ImageLogger(args.logdir, freq=args.image_log_every)  # both write on rank 0 only
    mlog = MetricLogger(args.logdir)

    history, step_s = [], []
    it = loader.iterate(start_step)
    t0 = time.perf_counter()
    for step in range(start_step, args.max_steps):
        t = time.perf_counter()
        batch = next(it)
        metrics = {k: float(v) for k, v in step_fn(state, batch).items()}
        history.append(metrics)
        if pipe.device.type == "cuda":
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        if step % 50 == 0:
            dt = time.perf_counter() - t0
            t0 = time.perf_counter()
            if lead:
                print(f"step {step} loss {metrics['loss']:.4f} ({dt:.2f}s/50 steps)")
            mlog.log(step, metrics)
        ckpt.save_state(manager, step, state)  # at multiples of --ckpt-every
        if args.image_log_every > 0 and step % args.image_log_every == 0:
            with torch.no_grad():
                imlog.maybe_log(pipe, batch, step,
                                torch.Generator(device=pipe.device).manual_seed(0))
    it.close()
    ckpt.save_final(manager, args.max_steps - 1, state)
    manager.close()
    if lead:
        print("done")
    return {"pipe": pipe, "state": state, "metrics": history, "step_s": step_s,
            "start_step": start_step, "mesh": mesh}


if __name__ == "__main__":
    main()
