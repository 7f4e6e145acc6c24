"""Batch generation entry of the PyTorch port, for both stacks, on the card.

    python -m prompt_diffusion_tpu_torch.generate --stack sd15 --ckpt ckpt.ckpt \\
        --data-root DIR --dataset laion --tasks hed --out-dir gen/ [--black-support]

The counterpart of the root `generate.py` (the reference's generate_sd15.py,
generate_train.py and generate_test.py), with its flags, its iteration of
the COCO-2017-val (`--dataset coco`) and LAION-meta (`--dataset laion`)
data, its choice of support (COCO: the batch's first item; LAION: the
sampled support pair) and its output layout: one subdirectory per task
(`meta` for LAION batches), one PNG per image, named as the data names it
(`b{batch:05d}_{j}` for LAION). PNGs are written by `serve.write_png`
(rounded to 8 bits). `--ckpt`: for sd15 a directory is a diffusers folder
and a file an ldm `.ckpt`/`.safetensors`; for sd3 a diffusers folder.
`--random-init` uses random weights (seed `--seed`) instead. The
pipelines run exact bf16, as the root generate.py's do. Decoding the data root
needs PIL, as the root generate.py does. `--compute-fid` also writes each
image to `<out-dir>/fid/<task>/<name>.png`, the flat per-task directories
that `python -m prompt_diffusion_tpu_torch.evaluation.fid calc --images`
reads against a `ref` of the real images.

Ranks: with `torch.distributed` initialized, rank r of w takes batches
r, r + w, ...; otherwise one process takes all.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np

from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import SAMPLERS
from prompt_diffusion_tpu_torch.serve import write_png


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--stack", choices=["sd15", "sd3"], default="sd15")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--random-init", action="store_true",
                   help="random weights instead of --ckpt (mechanics testing without model "
                        "assets)")
    p.add_argument("--data-root", required=True)
    p.add_argument("--dataset", choices=["laion", "coco"], default="laion")
    p.add_argument("--tasks", nargs="+", default=["hed"])
    p.add_argument("--out-dir", default="generated_images")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--steps", type=int, default=24)
    p.add_argument("--cfg", type=float, default=5.0)
    p.add_argument("--control-scale", type=float, default=1.0)
    p.add_argument("--sampler", choices=SAMPLERS, default="ddim",
                   help="sd15 denoise loop (sd3 is flow-match Euler only)")
    p.add_argument("--black-support", action="store_true",
                   help="zero the support pair (generate_train.py ablation)")
    p.add_argument("--compute-fid", action="store_true",
                   help="also write each image to <out-dir>/fid/<task>/ for evaluation.fid")
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--tokenizer-assets", default=None)
    p.add_argument("--t5-assets", default=None,
                   help="dir with tokenizer.json or spiece.model; enables the T5 branch of "
                        "the SD3 triple text encoding")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def rank_world() -> Tuple[int, int]:
    """(rank, world) of an initialized `torch.distributed` group, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _random_init(pipe, seed: int, device: str) -> None:
    import torch

    from prompt_diffusion_tpu_torch.utils.dtypes import random_init_

    gen = torch.Generator(device=device).manual_seed(seed)
    for m in pipe.jax_modules().values():
        random_init_(m, gen)


def build_sd15(args, **models) -> Callable:
    """The SD1.5 pipeline of `args` and its batch function
    gen(ids, neg, pair, query, generator, prompts) -> images. `models`
    (with `--random-init`) are models of other widths for `create`."""
    import torch

    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15

    if args.random_init:
        pipe = PromptDiffusionSD15.create(**models, device=args.device)
        _random_init(pipe, args.seed, args.device)
    elif os.path.isdir(args.ckpt):
        pipe = PromptDiffusionSD15.from_diffusers_folder(args.ckpt, device=args.device)
    else:
        pipe = PromptDiffusionSD15.from_single_file(args.ckpt, device=args.device)

    def gen(ids, neg, pair, query, generator, prompts):
        t = torch.from_numpy
        return pipe.generate(t(ids), t(neg), t(pair), t(query), num_steps=args.steps,
                             guidance_scale=args.cfg, control_scale=args.control_scale,
                             sampler=args.sampler, generator=generator)

    return gen


def build_sd3(args) -> Callable:
    """The SD3 pipeline of `args` (with T5 when `--t5-assets` names a T5
    tokenizer) and its batch function."""
    import torch

    from prompt_diffusion_tpu_torch.data.t5_tokenizer import load_t5_tokenizer
    from prompt_diffusion_tpu_torch.models.t5_text import T5Encoder
    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd3 import PromptDiffusionSD3

    t5_tok = load_t5_tokenizer(args.t5_assets)
    if args.random_init:
        t5 = None
        if t5_tok is not None:
            with torch.device(args.device):
                t5 = T5Encoder()
        pipe = PromptDiffusionSD3.create(t5=t5, device=args.device)
        _random_init(pipe, args.seed, args.device)
    else:
        if t5_tok is not None and not os.path.isdir(os.path.join(args.ckpt, "text_encoder_3")):
            raise SystemExit("--t5-assets given but the checkpoint folder has no "
                             "text_encoder_3/ — T5 weights are required for the T5 branch")
        pipe = PromptDiffusionSD3.from_folder(args.ckpt, device=args.device,
                                              t5=t5_tok is not None)

    def gen(ids, neg, pair, query, generator, prompts):
        t = torch.from_numpy
        pd, nd = {"l": t(ids), "g": t(ids)}, {"l": t(neg), "g": t(neg)}
        if t5_tok is not None:
            pd["t5"] = t(np.asarray(t5_tok(prompts)))
            nd["t5"] = t(np.asarray(t5_tok([""] * len(prompts))))
        return pipe.generate(pd, nd, t(query), t(pair[..., :3]), t(pair[..., 3:]),
                             num_steps=args.steps, guidance_scale=args.cfg,
                             controlnet_conditioning_scale=args.control_scale,
                             generator=generator)

    return gen


def batch_iters(args) -> list:
    """[(task, batches)]: COCO one iterator per task; LAION one "meta"
    iterator (its val split, `--max-batches` set to one pass when unset)."""
    if args.dataset == "coco":
        from prompt_diffusion_tpu_torch.data.coco_val import COCOValDataset

        ds = COCOValDataset(args.data_root, tasks=args.tasks, res=args.resolution)
        return [(t, ds.batches(args.batch_size, t)) for t in args.tasks]
    from prompt_diffusion_tpu_torch.data.laion_meta import ControlDataModule

    # tasks partitioned by dataset kind (the reference gates laion_human on
    # pose/densepose membership)
    human = tuple(t for t in args.tasks if t in ("pose", "densepose"))
    nonhuman = tuple(t for t in args.tasks if t not in ("pose", "densepose"))
    dm = ControlDataModule(args.data_root, res=args.resolution, human_tasks=human,
                           nonhuman_tasks=nonhuman)
    if args.max_batches is None:
        # the meta loader is an infinite round-robin sampler: one val pass
        total = sum(len(d["val"]) for d in dm.datasets.values())
        args.max_batches = max(1, total // args.batch_size)
        print(f"--max-batches not set; defaulting to one val epoch ({args.max_batches} batches)")
    return [("meta", iter(dm.loader("val", args.batch_size, seed=args.seed)))]


def generate_batches(gen: Callable, tok: Callable, iters: Iterable, dataset: str, out_dir: str,
                     generator, black_support: bool = False, max_batches: Optional[int] = None,
                     rank: int = 0, world: int = 1, log: Callable = print,
                     compute_fid: bool = False) -> int:
    """The entry's batch loop over decoded batches: the support and query
    of each batch, `gen` on its prompts, one PNG per image under
    `out_dir/<task>/` (and with `compute_fid` under `out_dir/fid/<task>/`
    too). Conditions stay in [0, 1] and support images in
    [-1, 1], the convention of both reference trainers and the diffusers
    generate flow. Returns the images written."""
    os.makedirs(out_dir, exist_ok=True)
    n_done = 0
    for task, it in iters:
        for bi, batch in enumerate(it):
            if max_batches is not None and bi >= max_batches:
                break
            if bi % world != rank:
                continue
            if dataset == "coco":
                # unseen-task eval: the batch's first item is the support of all
                query = batch["condition"]
                n = len(batch["image"])
                sup_img = batch["image"][:1].repeat(n, 0)
                sup_cond = batch["condition"][:1].repeat(n, 0)
                prompts, names = batch["prompt"], batch["name"]
            else:
                # meta batch: images (B, 2*shots, H, W, 3); conditions (B, T, 2*shots, ...)
                conds = batch["conditions"][:, 0]
                query, sup_cond, sup_img = conds[:, 0], conds[:, 1], batch["images"][:, 1]
                prompts = [p[0] for p in batch["prompts"]]
                names = [f"b{bi:05d}_{j}" for j in range(len(prompts))]
            pair = np.concatenate([sup_cond, sup_img], axis=-1).astype(np.float32)
            if black_support:
                pair = np.zeros_like(pair)
            imgs = gen(np.asarray(tok(prompts)), np.asarray(tok([""] * len(prompts))), pair,
                       np.asarray(query, np.float32), generator, list(prompts))
            arr = imgs.float().cpu().numpy()
            dirs = [os.path.join(out_dir, task)]
            if compute_fid:
                dirs.append(os.path.join(out_dir, "fid", task))
            for d in dirs:
                os.makedirs(d, exist_ok=True)
            for name, im in zip(names, arr):
                for d in dirs:
                    write_png(os.path.join(d, f"{name}.png"), im)
            n_done += len(arr)
            log(f"[{rank}/{world}] {task} batch {bi}: {n_done} images")
    log(f"rank {rank}: wrote {n_done} images -> {out_dir}")
    return n_done


def main(argv: Optional[Sequence[str]] = None, tokenizer: Optional[Callable] = None,
         **models) -> int:
    """The entry. A caller may pass the `tokenizer` (else
    `--tokenizer-assets`') and, with `--random-init --stack sd15`, models
    of other widths for `PromptDiffusionSD15.create`."""
    args = parse_args(argv)
    if args.stack == "sd3" and args.sampler != "ddim":
        print("--sampler applies to sd15 only; SD3 uses flow-match Euler", file=sys.stderr)
        return 2
    if not args.random_init and args.ckpt is None:
        print("--ckpt is required (or pass --random-init)", file=sys.stderr)
        return 2
    import torch

    from prompt_diffusion_tpu_torch.data.tokenizer import load_tokenizer

    tok = tokenizer or load_tokenizer(args.tokenizer_assets)
    gen = build_sd15(args, **models) if args.stack == "sd15" else build_sd3(args)
    iters = batch_iters(args)
    rank, world = rank_world()
    generator = torch.Generator(device=args.device).manual_seed(args.seed + rank)
    generate_batches(gen, tok, iters, args.dataset, args.out_dir, generator,
                     black_support=args.black_support, max_batches=args.max_batches,
                     rank=rank, world=world, compute_fid=args.compute_fid)
    return 0


if __name__ == "__main__":
    sys.exit(main())
