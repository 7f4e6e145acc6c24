"""Serving entry point: build SD1.5, warm the buckets, serve concurrent
Prompt-Diffusion requests through the micro-batching server.

    python -m prompt_diffusion_tpu_torch.serve --demo [--ckpt FILE]
        [--policy bf16|int8 [--int8-attention] [--unfused-geglu]] [--max-batch 4]
        [--steps 50] [--resolution 512] [--sampler ddim] [--vocab DIR]
        [--out-dir served_images] [--device cuda]

`--ckpt` names a reference `.ckpt` or `.safetensors` (an ldm checkpoint in
the four reference namespaces), loaded under `--policy` through
`PromptDiffusionSD15.from_single_file`; without it the weights are random
(`random_init_`, seed 0), a mechanics demo. Under `--policy int8`,
`--int8-attention` runs the UNet's and ControlNet's 64² and 32²
self-attention through K9 (int8 Q.K^T) and `--unfused-geglu` their GEGLU
without K7 (`create(int8_attention=True, fused_geglu=False)`). `--demo` submits 4 concurrent
requests with different prompts, seeds and guidance scales (they share one
batched run) and writes each image as a PNG (the standard library's zlib;
no imaging package needed). The counterpart of `examples/serve.py`.
"""

from __future__ import annotations

import argparse
import os
import struct
import sys
import time
import zlib

import numpy as np

from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import SAMPLERS

DEMO_PROMPTS = ("a modern house", "a red sports car", "a snowy mountain",
                "a lighthouse at dusk")
NEGATIVE = "lowres, worst quality"


def write_png(path: str, image: np.ndarray) -> None:
    """(H, W, 3) floats in [0, 1] -> an 8-bit RGB PNG."""
    img = np.clip(np.rint(np.asarray(image) * 255.0), 0, 255).astype(np.uint8)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))  # filter 0 per row

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def build_pipeline(policy: str, device: str, seed: int = 0, ckpt=None, **create_kwargs):
    """SD1.5, exact bf16 or the int8 serving mode with the int8 VAE: from
    the checkpoint `ckpt` (`create_kwargs`: models built on the meta
    device, for other widths, and `create`'s int8 options), else at the
    default widths with random weights from `seed`."""
    import torch

    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
    from prompt_diffusion_tpu_torch.utils.dtypes import int8_policy, random_init_

    kw = dict(policy=int8_policy(), vae_int8=True) if policy == "int8" else {}
    if ckpt:
        return PromptDiffusionSD15.from_single_file(ckpt, device=device, **kw, **create_kwargs)
    pipe = PromptDiffusionSD15.create(device=device, **kw, **create_kwargs)
    gen = torch.Generator(device=device).manual_seed(seed)
    for m in pipe.jax_modules().values():
        random_init_(m, gen)
    return pipe


def make_request(tok, prompt: str, seed: int, resolution: int, steps: int, sampler: str,
                 guidance: float = 9.0):
    """A request with a blank example pair and query condition."""
    from prompt_diffusion_tpu_torch.serving import GenerationRequest

    blank = np.zeros((resolution, resolution, 3), np.float32)
    return GenerationRequest(
        token_ids=np.asarray(tok([prompt]))[0],
        neg_token_ids=np.asarray(tok([NEGATIVE]))[0],
        example_pair=np.concatenate([blank, blank], axis=-1),
        query=blank, num_steps=steps, guidance_scale=guidance, sampler=sampler, seed=seed)


def run_demo(server, tok, resolution: int, steps: int, sampler: str, out_dir: str) -> list:
    """Submits the demo prompts at once, writes `req{i}.png` for each;
    returns the paths. Every request is built before the first is
    submitted: a request built while the server's flush window runs could
    miss it and land in a batch of its own, which changes the int8 images
    (the per-tensor activation scale spans the batch)."""
    reqs = [make_request(tok, p, i, resolution, steps, sampler, 7.0 + i)
            for i, p in enumerate(DEMO_PROMPTS)]
    runs_before = server.stats["batches"]  # the warm-up's runs are not the demo's
    futs = [server.submit(r) for r in reqs]
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    paths = []
    for i, fut in enumerate(futs):
        paths.append(os.path.join(out_dir, f"req{i}.png"))
        write_png(paths[-1], fut.result())
    print(f"served {len(futs)} requests in {time.perf_counter() - t0:.1f}s "
          f"({server.stats['batches'] - runs_before} batched runs) -> {out_dir}/")
    return paths


def main(argv=None, tokenizer=None, **create_kwargs) -> int:
    """The entry. A caller may pass the `tokenizer` (else `--vocab`'s) and
    `create_kwargs` for `build_pipeline` (models of other widths, built on
    the meta device for `--ckpt`)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", default=None,
                   help="reference .ckpt/.safetensors (omit for random weights)")
    p.add_argument("--vocab", default=None, help="CLIP BPE vocab dir (else hash ids)")
    p.add_argument("--policy", choices=("bf16", "int8"), default="int8")
    p.add_argument("--int8-attention", action="store_true",
                   help="int8: the 64² and 32² self-attention through K9 (int8 Q.K^T)")
    p.add_argument("--unfused-geglu", action="store_true",
                   help="int8: the GEGLU without K7, then a per-tensor quantization")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--sampler", choices=SAMPLERS, default="ddim")
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--out-dir", default="served_images")
    p.add_argument("--device", default="cuda")
    p.add_argument("--demo", action="store_true")
    args = p.parse_args(argv)
    if (args.int8_attention or args.unfused_geglu) and args.policy != "int8":
        p.error("--int8-attention and --unfused-geglu take --policy int8")
    if args.int8_attention:
        create_kwargs["int8_attention"] = True
    if args.unfused_geglu:
        create_kwargs["fused_geglu"] = False

    from prompt_diffusion_tpu_torch.data.tokenizer import load_tokenizer
    from prompt_diffusion_tpu_torch.serving import GenerationServer, ServerConfig

    t0 = time.perf_counter()
    pipe = build_pipeline(args.policy, args.device, ckpt=args.ckpt, **create_kwargs)
    if args.ckpt:
        print(f"loaded {args.ckpt} ({args.policy} policy) on {pipe.device} in "
              f"{time.perf_counter() - t0:.1f}s")
    else:
        print(f"random weights ({args.policy} policy) on {pipe.device}: mechanics demo only")
    tok = tokenizer or load_tokenizer(args.vocab)
    server = GenerationServer(pipe, ServerConfig(max_batch=args.max_batch, flush_ms=25.0))
    with server:
        t0 = time.perf_counter()
        server.warmup(make_request(tok, "warmup", 0, args.resolution, args.steps, args.sampler))
        print(f"warm in {time.perf_counter() - t0:.1f}s; accepting requests")
        if args.demo:
            run_demo(server, tok, args.resolution, args.steps, args.sampler, args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
