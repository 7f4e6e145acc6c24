"""SD3 Prompt-Diffusion flow-matching ControlNet trainer, on the card by
default.

    python -m prompt_diffusion_tpu_torch.train_sd3 --data-root DIR
        [--logdir logs/sd3] [--batch-size 4] [--resolution 1024]
        [--weighting-scheme logit_normal|uniform|sigma_sqrt]
        [--precondition-outputs] [--t5-assets DIR] [--resume]
        [--device cuda] [--tiny]

The counterpart of the root `train_sd3.py` (the reference's
`train_promptdiffusion_sd3.py`): logit-normal timestep
sampling, the sigma-weighted flow-matching MSE, the ControlNet and
down_proj trained, the transformer, the VAE and the text encoders frozen
(`training/sd3.py`). Weights are random, from `--seed` (as in the root
driver). The text of each batch goes through CLIP-L and CLIP-bigG; with
`--t5-assets` (a T5 tokenizer) T5-XXL runs staged once over every prompt
of the data set before training and is freed (the reference precomputes
and frees its encoders, :1058-1080), else its slots are zeros as in the
root driver. Conditions come from the loader in [0, 1] and are mapped to
[-1, 1] for the VAE, the root driver's recorded choice. Under `torchrun`
the run is sharded as `train_sd15`'s (`--num-fsdp`, global `--batch-size`,
each rank's loader on its shard, rank 0 logging and writing checkpoints);
`--loader auto|native|pil` picks the batch decoder as there.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data-root", required=True)
    p.add_argument("--logdir", default="./logs/sd3")
    p.add_argument("--tasks", nargs="+", default=["canny", "depth", "hed", "normal"])
    p.add_argument("--resolution", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--max-steps", type=int, default=10000)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--accum-steps", type=int, default=1)
    p.add_argument("--weighting-scheme", default="logit_normal",
                   choices=["logit_normal", "uniform", "sigma_sqrt"])
    p.add_argument("--precondition-outputs", action="store_true")
    p.add_argument("--use-ema", action="store_true")
    p.add_argument("--ckpt-every", type=int, default=1000)
    p.add_argument("--ckpt-keep", type=int, default=3)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--num-fsdp", type=int, default=1,
                   help="fsdp width of the mesh under torchrun (must divide the world)")
    p.add_argument("--loader", choices=["auto", "native", "pil"], default="auto",
                   help="image decoder of the batch loader (auto: native where it builds)")
    p.add_argument("--tokenizer-assets", default=None)
    p.add_argument("--t5-assets", default=None,
                   help="dir with tokenizer.json or spiece.model: T5-XXL runs staged over "
                        "the data set's prompts")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def build_pipe(tiny: bool, device: str, with_t5: bool = False):
    """The SD3 pipeline the trainer builds (default widths, or the root
    driver's tiny ones; a T5 encoder with `with_t5`); weights not yet
    initialised."""
    import torch

    from prompt_diffusion_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from prompt_diffusion_tpu_torch.models.controlnet_sd3 import SD3ControlNet, SupportPairDownProj
    from prompt_diffusion_tpu_torch.models.mmdit_sd3 import MMDiTConfig, SD3Transformer
    from prompt_diffusion_tpu_torch.models.t5_text import T5Config, T5Encoder
    from prompt_diffusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd3 import PromptDiffusionSD3

    models = {}
    with torch.device(device):
        if tiny:
            cfg = MMDiTConfig(sample_size=8, patch_size=2, in_channels=4, num_layers=2,
                              attention_head_dim=16, num_attention_heads=4,
                              joint_attention_dim=64, caption_projection_dim=64,
                              pooled_projection_dim=64, out_channels=4, pos_embed_max_size=16)
            clip = lambda: CLIPTextModel(CLIPTextConfig(hidden_size=32, num_layers=2,
                                                        num_heads=4, intermediate_size=64))
            models = dict(transformer=SD3Transformer(cfg), controlnet=SD3ControlNet(cfg),
                          down_proj=SupportPairDownProj(),
                          vae=AutoencoderKL(VAEConfig(ch=32, ch_mult=(1, 1, 2, 2),
                                                      num_res_blocks=1, z_channels=4,
                                                      scale_factor=1.5305,
                                                      shift_factor=0.0609)),
                          clip_l=clip(), clip_g=clip())
        if with_t5:
            models["t5"] = T5Encoder(T5Config(vocab_size=32128, d_model=64, d_kv=8, d_ff=96,
                                              num_layers=2, num_heads=4) if tiny else T5Config())
    return PromptDiffusionSD3.create(**models, device=device)


def stage_t5_prompts(pipe, t5_tok, prompts, chunk: int = 8) -> dict:
    """{prompt: T5 sequence (L, d_model) fp32 on the host}: each distinct
    prompt through the pipeline's T5 once (`stage_t5`, which frees it)."""
    import torch

    prompts = sorted(set(prompts))
    ids = [torch.from_numpy(np.asarray(t5_tok(prompts[i:i + chunk])))
           for i in range(0, len(prompts), chunk)]
    seqs = torch.cat([s.cpu() for s in pipe.stage_t5(*ids)])
    return dict(zip(prompts, seqs))


def dataset_prompts(dataset) -> list:
    out = []
    for files in dataset.file_mapping.values():
        for rec in files:
            with open(rec.txt_path) as f:
                out.append(f.read().strip())
    return out


def main(argv=None) -> dict:
    """Runs the trainer; returns {"pipe", "state", "metrics", "step_s",
    "start_step", "mesh"} (as `train_sd15.main`)."""
    args = parse_args(argv)
    from prompt_diffusion_tpu_torch.train_sd15 import distributed

    mesh, device = distributed(args.num_fsdp, args.batch_size, args.device)
    import torch

    from prompt_diffusion_tpu_torch.data.edit_dataset import BatchLoader, EditDataset
    from prompt_diffusion_tpu_torch.data.t5_tokenizer import load_t5_tokenizer
    from prompt_diffusion_tpu_torch.data.tokenizer import load_tokenizer
    from prompt_diffusion_tpu_torch.native import choose_decoder
    from prompt_diffusion_tpu_torch.parallel.mesh import batch_rank, is_rank0, world_size
    from prompt_diffusion_tpu_torch.training import checkpoint as ckpt
    from prompt_diffusion_tpu_torch.training.image_logger import MetricLogger
    from prompt_diffusion_tpu_torch.training.sd3 import (
        SD3TrainConfig,
        init_sd3_train_state,
        make_sd3_train_step,
    )
    from prompt_diffusion_tpu_torch.utils.dtypes import random_init_

    t5_tok = load_t5_tokenizer(args.t5_assets)
    pipe = build_pipe(args.tiny, device, with_t5=t5_tok is not None)
    gen = torch.Generator(device=pipe.device).manual_seed(args.seed)
    for m in pipe.jax_modules().values():
        random_init_(m, gen)
    dataset = EditDataset(args.data_root, task_list=args.tasks, resolution=args.resolution)
    t5_seqs = (stage_t5_prompts(pipe, t5_tok, dataset_prompts(dataset))
               if t5_tok is not None else None)

    cfg = SD3TrainConfig(learning_rate=args.lr, use_ema=args.use_ema,
                         accum_steps=args.accum_steps, weighting_scheme=args.weighting_scheme,
                         precondition_outputs=args.precondition_outputs)
    state = init_sd3_train_state(cfg, pipe, seed=args.seed + 1, mesh=mesh)
    manager = ckpt.make_manager(f"{args.logdir}/checkpoints", save_every=args.ckpt_every,
                                keep=args.ckpt_keep)
    start_step = ckpt.resume(manager, state) if args.resume else 0
    if start_step and is_rank0(mesh):
        print(f"resumed from step {start_step}")

    tokenizer = load_tokenizer(args.tokenizer_assets)
    loader = BatchLoader(dataset, batch_size=args.batch_size // world_size(mesh),
                         seed=args.seed, tokenizer=tokenizer, shard_id=batch_rank(mesh),
                         num_shards=world_size(mesh),
                         decoder=choose_decoder(args.loader,
                                                print if is_rank0(mesh) else lambda m: None))
    step_fn = make_sd3_train_step(pipe, cfg)
    mlog = MetricLogger(args.logdir)

    history, step_s = [], []
    it = loader.iterate(start_step)
    t0 = time.perf_counter()
    for step in range(start_step, args.max_steps):
        t = time.perf_counter()
        hb = next(it)
        ids = torch.from_numpy(np.asarray(hb["token_ids"]))
        t5_seq = (torch.stack([t5_seqs[p] for p in hb["prompt"]])
                  if t5_seqs is not None else None)
        context, pooled = pipe.encode_prompt(ids, ids, t5_seq=t5_seq)
        batch = {
            "image": hb["image"],
            "control": hb["query"] * 2 - 1,
            "support_cond": hb["example_pair"][..., :3] * 2 - 1,
            "support_image": hb["example_pair"][..., 3:],
            "context": context,
            "pooled": pooled,
        }
        metrics = {k: float(v) for k, v in step_fn(state, batch).items()}
        history.append(metrics)
        if pipe.device.type == "cuda":
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        if step % 50 == 0:
            if is_rank0(mesh):
                print(f"step {step} loss {metrics['loss']:.4f} "
                      f"({time.perf_counter() - t0:.1f}s)")
            t0 = time.perf_counter()
            mlog.log(step, metrics)
        ckpt.save_state(manager, step, state)
    it.close()
    ckpt.save_final(manager, args.max_steps - 1, state)
    manager.close()
    if is_rank0(mesh):
        print("done")
    return {"pipe": pipe, "state": state, "metrics": history, "step_s": step_s,
            "start_step": start_step, "mesh": mesh}


if __name__ == "__main__":
    main()
