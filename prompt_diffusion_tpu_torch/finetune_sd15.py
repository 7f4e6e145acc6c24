"""Few-shot finetune of the SD1.5 ControlNet on a new task, on the card by
default.

    python -m prompt_diffusion_tpu_torch.finetune_sd15 --data-root DIR --task mlsd
        [--init-ckpt trained.ckpt] [--num-supports 15] [--max-steps 400]
        [--device cuda] [--tiny]

The counterpart of the root `finetune_sd15.py`
(finetune_promptdiffusion_sd15.py): the training step of `train_sd15`
with the meta-dataset's tuning loader (`data/laion_meta.py`), whose
supports come from a fixed set of `--num-supports` file groups (shots=1,
finetune_promptdiffusion_sd15.py:739-753), so the ControlNet adapts to
one unseen task from a handful of examples. Weights as in `train_sd15`.
Under `torchrun` the step is sharded as `train_sd15`'s (`--num-fsdp`,
`--batch-size` global); every rank draws the tuning loader's global batch,
seeded alike, and takes its rows. The meta dataset decodes with PIL, as
the JAX package's does.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data-root", required=True)
    p.add_argument("--task", required=True, help="the new task's condition dir name")
    p.add_argument("--kind", choices=["human", "nonhuman"], default="nonhuman")
    p.add_argument("--logdir", default="./logs/finetune")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--max-steps", type=int, default=400)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--num-supports", type=int, default=15)
    p.add_argument("--init-ckpt", default=None)
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--num-fsdp", type=int, default=1,
                   help="fsdp width of the mesh under torchrun (must divide the world)")
    p.add_argument("--tokenizer-assets", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def meta_batch(mb: dict, tokenizer) -> dict:
    """A tuning-loader batch as a train-step batch: the query group is
    index 0, the support group index 1 (a single task)."""
    images = mb["images"]  # (B, 2, H, W, 3) in [-1, 1]
    conds = mb["conditions"][:, 0]  # (B, 2, H, W, 3) in [0, 1]
    return {
        "image": images[:, 0],
        "query": conds[:, 0],
        "example_pair": np.concatenate([conds[:, 1], images[:, 1]], axis=-1),
        "token_ids": tokenizer([p[0] for p in mb["prompts"]]),
        "null_ids": tokenizer([""]),
    }


def main(argv=None) -> dict:
    """Runs the finetune; returns {"pipe", "state", "metrics"}."""
    args = parse_args(argv)
    from prompt_diffusion_tpu_torch.data.laion_meta import ControlDataModule
    from prompt_diffusion_tpu_torch.data.tokenizer import load_tokenizer
    from prompt_diffusion_tpu_torch.parallel.mesh import batch_slice, is_rank0
    from prompt_diffusion_tpu_torch.train_sd15 import build_pipe, distributed, init_weights
    from prompt_diffusion_tpu_torch.training import checkpoint as ckpt
    from prompt_diffusion_tpu_torch.training.image_logger import MetricLogger
    from prompt_diffusion_tpu_torch.training.sd15 import (
        SD15TrainConfig,
        init_train_state,
        make_train_step,
    )

    mesh, device = distributed(args.num_fsdp, args.batch_size, args.device)
    pipe = build_pipe(args.tiny, device)
    init_weights(pipe, args.seed, args.init_ckpt)
    cfg = SD15TrainConfig(learning_rate=args.lr, sd_locked=True)
    state = init_train_state(cfg, pipe, seed=args.seed + 1, mesh=mesh)
    manager = ckpt.make_manager(f"{args.logdir}/checkpoints", save_every=args.ckpt_every)
    tokenizer = load_tokenizer(args.tokenizer_assets)

    kind_tasks = {"human_tasks": (), "nonhuman_tasks": ()}
    kind_tasks[f"{args.kind}_tasks"] = (args.task,)
    dm = ControlDataModule(args.data_root, res=args.resolution, shots=1, **kind_tasks)
    loader = dm.tuning_loader("train", args.batch_size, num_supports=args.num_supports,
                              seed=args.seed)
    step_fn = make_train_step(pipe, cfg)
    mlog = MetricLogger(args.logdir)

    history = []
    it = iter(loader)
    t0 = time.perf_counter()
    for step in range(args.max_steps):
        batch = meta_batch(next(it), tokenizer)
        batch = {k: v if k == "null_ids" else batch_slice(v, mesh) for k, v in batch.items()}
        metrics = {k: float(v) for k, v in step_fn(state, batch).items()}
        history.append(metrics)
        if step % 20 == 0:
            if is_rank0(mesh):
                print(f"step {step} loss {metrics['loss']:.4f} ({time.perf_counter() - t0:.1f}s)")
            t0 = time.perf_counter()
            mlog.log(step, metrics)
        ckpt.save_state(manager, step, state)
    ckpt.save_final(manager, args.max_steps - 1, state)
    manager.close()
    if is_rank0(mesh):
        print("done")
    return {"pipe": pipe, "state": state, "metrics": history}


if __name__ == "__main__":
    main()
