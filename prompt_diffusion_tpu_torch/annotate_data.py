"""Batched offline condition extraction with the PyTorch port.

Counterpart of the repository's `annotate_data.py` (the JAX entry), with
its flags and output files: images of a data set are resized, batched and
annotated on the card, and each annotation is written beside its image as
`<name>_<task>.jpg`. The depth and normal tasks share one MiDaS forward and
write both files, as the JAX entry does; the HED map is clipped to [0, 255]
and truncated to uint8, the segmentation rendered with the ADE palette.

  python -m prompt_diffusion_tpu_torch.annotate_data --path DIR \\
      [--tasks canny hed depth normal seg] [--hed-ckpt network-bsds500.pth] \\
      [--midas-ckpt dpt_hybrid.pt] [--seg-ckpt upernet_global_small.pth] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
from glob import glob
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from prompt_diffusion_tpu_torch.annotators.canny import canny
from prompt_diffusion_tpu_torch.annotators.hed import create_hed
from prompt_diffusion_tpu_torch.annotators.midas import create_dpt, depth_to_normals
from prompt_diffusion_tpu_torch.annotators.uniformer import colorize_segmentation, create_uniformer

TASKS = ("canny", "hed", "depth", "normal", "seg")


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--path", required=True, help="root with seeds.json (InstructPix2Pix layout)")
    p.add_argument("--i-start", type=int, default=0)
    p.add_argument("--i-end", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--tasks", nargs="+", default=["canny"], choices=TASKS)
    p.add_argument("--hed-ckpt", default=None)
    p.add_argument("--midas-ckpt", default=None)
    p.add_argument("--seg-ckpt", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if "hed" in args.tasks and not args.hed_ckpt:
        p.error("--tasks hed needs --hed-ckpt (network-bsds500.pth)")
    if ("depth" in args.tasks or "normal" in args.tasks) and not args.midas_ckpt:
        p.error("--tasks depth/normal need --midas-ckpt (dpt_hybrid or dpt_large)")
    if "seg" in args.tasks and not args.seg_ckpt:
        p.error("--tasks seg needs --seg-ckpt (upernet_global_small.pth)")
    return args


def list_images(path: str, i_start: int = 0, i_end: Optional[int] = None) -> List[str]:
    """The image paths of a data set: `seeds.json`'s entries when present,
    else every jpg under `path`, sorted; sliced to [i_start:i_end]."""
    seeds_path = os.path.join(path, "seeds.json")
    if os.path.exists(seeds_path):
        with open(seeds_path) as f:
            seeds = json.load(f)
        entries = [os.path.join(path, name, f"{seed}.jpg")
                   for name, image_seeds in seeds for seed in image_seeds]
    else:
        entries = sorted(glob(os.path.join(path, "**", "*.jpg"), recursive=True))
    return entries[i_start:i_end]


def build_annotators(tasks: Sequence[str], midas_ckpt: Optional[str] = None,
                     device="cuda", dpt: Optional[torch.nn.Module] = None,
                     hed_ckpt: Optional[str] = None, hed: Optional[torch.nn.Module] = None,
                     seg_ckpt: Optional[str] = None, seg: Optional[torch.nn.Module] = None
                     ) -> Dict[str, Callable]:
    """{name: fn} of the annotators `tasks` need, each mapping (B, H, W, 3)
    images in [0, 255]: "canny" to edges, "hed" to the edge probability
    scaled to [0, 255], "midas" to (depth, normals) scaled to [0, 255],
    "seg" to (B, H, W) ADE class ids. A model is the one given (`hed`,
    `dpt`, `seg`), else the one its checkpoint builds on `device`."""
    fns: Dict[str, Callable] = {}
    nchw = lambda x: x.permute(0, 3, 1, 2)
    if "canny" in tasks:
        fns["canny"] = canny
    if "hed" in tasks:
        hed_model = hed if hed is not None else create_hed(hed_ckpt, device=device)
        fns["hed"] = lambda x: hed_model(nchw(x)) * 255.0
    if "depth" in tasks or "normal" in tasks:
        model = dpt if dpt is not None else create_dpt(midas_ckpt, device=device)

        def midas(x):
            depth = model(nchw(x) / 127.5 - 1.0)
            d01, normals = depth_to_normals(depth)
            return d01 * 255.0, normals * 255.0

        fns["midas"] = midas
    if "seg" in tasks:
        seg_model = seg if seg is not None else create_uniformer(seg_ckpt, device=device)
        fns["seg"] = lambda x: seg_model(nchw(x)).argmax(dim=1)
    return fns


def _save(path_in: str, suffix: str, arr_u8: np.ndarray) -> str:
    from PIL import Image

    out = path_in.replace(".jpg", f"_{suffix}.jpg")
    Image.fromarray(arr_u8).save(out)
    return out


@torch.no_grad()
def annotate_batch(fns: Dict[str, Callable], paths: Sequence[str],
                   images: torch.Tensor) -> List[str]:
    """Runs every annotator on one batch of (B, H, W, 3) float images in
    [0, 255] (on the annotators' device) and writes each result beside its
    source path. Returns the paths written."""
    written = []
    as_u8 = lambda t: t.float().cpu().numpy().astype(np.uint8)
    if "canny" in fns:
        for p, e in zip(paths, as_u8(fns["canny"](images))):
            written.append(_save(p, "canny", np.repeat(e[..., None], 3, -1)))
    if "hed" in fns:
        edges = np.clip(fns["hed"](images).float().cpu().numpy(), 0, 255).astype(np.uint8)
        for p, e in zip(paths, edges):
            written.append(_save(p, "hed", np.repeat(e[..., None], 3, -1)))
    if "midas" in fns:
        d, n = fns["midas"](images)
        for p, di, ni in zip(paths, as_u8(d), as_u8(n)):
            written.append(_save(p, "depth", np.repeat(di[..., None], 3, -1)))
            written.append(_save(p, "normal", ni))
    if "seg" in fns:
        for p, ci in zip(paths, fns["seg"](images).cpu().numpy()):
            written.append(_save(p, "seg", colorize_segmentation(ci)))
    return written


def load_batch(paths: Sequence[str], resolution: int) -> np.ndarray:
    from PIL import Image

    return np.stack([
        np.asarray(Image.open(p).convert("RGB").resize((resolution, resolution),
                                                       Image.BILINEAR), np.float32)
        for p in paths])


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    entries = list_images(args.path, args.i_start, args.i_end)
    print(f"{len(entries)} images, tasks={args.tasks}")
    fns = build_annotators(args.tasks, args.midas_ckpt, args.device, hed_ckpt=args.hed_ckpt,
                           seg_ckpt=args.seg_ckpt)
    for s in range(0, len(entries), args.batch_size):
        paths = [p for p in entries[s: s + args.batch_size] if os.path.exists(p)]
        if not paths:
            continue
        images = torch.from_numpy(load_batch(paths, args.resolution)).to(args.device)
        annotate_batch(fns, paths, images)
        print(f"annotated {s + len(paths)}/{len(entries)}")


if __name__ == "__main__":
    main()
