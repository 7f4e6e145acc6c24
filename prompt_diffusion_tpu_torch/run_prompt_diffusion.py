"""Single-example Prompt-Diffusion inference (the notebook flow) on the card.

Counterpart of `examples/run_prompt_diffusion.py`, with its flags: given an
(example condition, example image) pair, a query condition and a prompt,
generate the query's image. The example's condition comes from the live
annotators (`--task hed|seg|depth|normal|canny`) unless `--example-cond`
names it; an inverse task (`inv_*`) swaps condition and image in the pair.
Images are resized with `annotators.util.resize_image`, the query
normalised to [-1, 1], the pair is channel-concat(condition, image);
sampling is DDIM with CFG `--cfg` and control scale `--strength` (or guess
mode). The weights come from a reference `.ckpt`/`.safetensors` through
`PromptDiffusionSD15.from_single_file`, the tokenizer from
`--tokenizer-assets` (hash ids without them), the starting noise from a
`torch.Generator` seeded with `--seed`, and the PNG is written by
`serve.write_png`, which rounds (the JAX script truncates).

  python -m prompt_diffusion_tpu_torch.run_prompt_diffusion \\
      --ckpt network-step=04999.ckpt --tokenizer-assets ./clip_assets \\
      --example-image house.png --query-image house_line.png \\
      --task hed --hed-ckpt network-bsds500.pth --prompt "a beautiful house" --out out.png
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

A_PROMPT = "best quality, extremely detailed"
N_PROMPT = ("longbody, lowres, bad anatomy, bad hands, missing fingers, extra digit, fewer "
            "digits, cropped, worst quality, low quality")

TASKS = ("hed", "seg", "depth", "normal", "canny",
         "inv_hed", "inv_seg", "inv_depth", "inv_normal", "inv_canny")


@torch.no_grad()
def extract_condition(image_u8: np.ndarray, task: str, ckpts: dict,
                      device="cuda") -> np.ndarray:
    """uint8 (H, W, 3) -> the condition, uint8 (H, W, 3), of a forward task
    (the notebook's annotator dispatch); a weighted annotator needs its
    checkpoint in `ckpts` ({"hed": ..., "midas": ..., "seg": ...})."""
    x = torch.from_numpy(image_u8.astype(np.float32)).to(device)[None]
    nchw = x.permute(0, 3, 1, 2)
    if task == "canny":
        from prompt_diffusion_tpu_torch.annotators.canny import canny

        edge = canny(x)[0].cpu().numpy()
        return np.repeat(edge[..., None].astype(np.uint8), 3, axis=-1)

    def need(key, flag):
        if not ckpts.get(key):
            raise SystemExit(f"--task {task} needs annotator weights: pass {flag}")
        return ckpts[key]

    if task == "hed":
        from prompt_diffusion_tpu_torch.annotators.hed import create_hed

        net = create_hed(need("hed", "--hed-ckpt"), device=device)
        e = np.clip(net(nchw)[0].float().cpu().numpy() * 255.0, 0, 255)
        return np.repeat(e[..., None].astype(np.uint8), 3, axis=-1)
    if task in ("depth", "normal"):
        from prompt_diffusion_tpu_torch.annotators.midas import create_dpt, depth_to_normals

        # dpt_hybrid (the ecosystem's default) or dpt_large, sniffed from the file
        dpt = create_dpt(need("midas", "--midas-ckpt"), device=device)
        d01, normals = depth_to_normals(dpt(nchw / 127.5 - 1.0))
        out = (d01 if task == "depth" else normals)[0].cpu().numpy() * 255.0
        out = np.clip(out, 0, 255).astype(np.uint8)
        return np.repeat(out[..., None], 3, -1) if out.ndim == 2 else out
    if task == "seg":
        from prompt_diffusion_tpu_torch.annotators.uniformer import (
            colorize_segmentation,
            create_uniformer,
        )

        seg = create_uniformer(need("seg", "--seg-ckpt"), device=device)
        return colorize_segmentation(seg(nchw).argmax(dim=1))[0]
    raise SystemExit(f"unknown forward task '{task}'")


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True)
    p.add_argument("--tokenizer-assets", default=None)
    p.add_argument("--example-image", required=True, help="support ground-truth image")
    p.add_argument("--example-cond", default=None,
                   help="precomputed support condition (else run the annotator)")
    p.add_argument("--query-image", required=True,
                   help="query condition image (forward task) or image (inverse task)")
    p.add_argument("--task", choices=TASKS, default="hed")
    p.add_argument("--hed-ckpt", default=None, help="network-bsds500.pth")
    p.add_argument("--midas-ckpt", default=None, help="dpt_hybrid/dpt_large .pt")
    p.add_argument("--seg-ckpt", default=None, help="upernet_global_small.pth")
    p.add_argument("--prompt", required=True)
    p.add_argument("--a-prompt", default=A_PROMPT)
    p.add_argument("--n-prompt", default=N_PROMPT)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--cfg", type=float, default=9.0)
    p.add_argument("--strength", type=float, default=1.0)
    p.add_argument("--guess-mode", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="out.png")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def prepare_inputs(args) -> tuple:
    """(pair (H, W, 6), query (H, W, 3)), float32 in [-1, 1], as the notebook
    prepares them."""
    from PIL import Image

    from prompt_diffusion_tpu_torch.annotators.util import hwc3, resize_image

    res = args.resolution

    def load(path):
        return resize_image(hwc3(np.asarray(Image.open(path).convert("RGB"))), res)

    example_img = load(args.example_image)
    query = load(args.query_image)
    if args.example_cond:
        example_cond = load(args.example_cond)
    else:
        example_cond = extract_condition(
            example_img, args.task.removeprefix("inv_"),
            {"hed": args.hed_ckpt, "midas": args.midas_ckpt, "seg": args.seg_ckpt},
            device=args.device)
    if args.task.startswith("inv_"):
        # an inverse task: the condition is the target; pair = (image, condition)
        example_cond, example_img = example_img, example_cond
    pair = np.concatenate([example_cond.astype(np.float32) / 127.5 - 1.0,
                           example_img.astype(np.float32) / 127.5 - 1.0], axis=-1)
    return pair, query.astype(np.float32) / 127.5 - 1.0


def main(argv: Optional[Sequence[str]] = None, tokenizer=None,
         init_noise: Optional[torch.Tensor] = None, **models_on_meta) -> str:
    """The entry; returns the PNG's path. A caller may pass the `tokenizer`
    (else `--tokenizer-assets`'), the starting noise (else the seeded
    generator's) and models of other widths built on the meta device
    (`from_single_file`'s `create_kwargs`)."""
    from prompt_diffusion_tpu_torch.data.tokenizer import load_tokenizer
    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
    from prompt_diffusion_tpu_torch.serve import write_png

    args = parse_args(argv)
    pair, query = prepare_inputs(args)
    pipe = PromptDiffusionSD15.from_single_file(args.ckpt, device=args.device, **models_on_meta)
    tok = tokenizer or load_tokenizer(args.tokenizer_assets)
    ids = torch.as_tensor(np.asarray(tok([args.prompt + ", " + args.a_prompt])))
    neg = torch.as_tensor(np.asarray(tok([args.n_prompt])))
    to_dev = lambda a: torch.from_numpy(a[None]).to(args.device)
    img = pipe.generate(ids.to(args.device), neg.to(args.device), to_dev(pair), to_dev(query),
                        num_steps=args.steps, guidance_scale=args.cfg,
                        control_scale=args.strength, guess_mode=args.guess_mode,
                        init_noise=init_noise,
                        generator=torch.Generator(device=args.device).manual_seed(args.seed))
    write_png(args.out, img[0].cpu().numpy())
    print(f"saved {args.out}")
    return args.out


if __name__ == "__main__":
    main()
