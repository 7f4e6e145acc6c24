"""Training-time image and metric logging.

Counterpart of `prompt_diffusion_tpu/training/image_logger.py` (the
reference's `cldm/logger.py:11-88` ImageLogger callback and the diffusers
trainers' validation images): every `freq` steps the pipeline's `generate`
runs on the first images of the batch and writes a PNG grid, the query
grid and a prompt sidecar under `<logdir>/image_log/<split>/`. PNGs go
through `serve.write_png`, which rounds to the nearest 8-bit value (the
JAX `_to_uint8` truncates; ROADMAP queue 3 records the decision). Both
loggers write on rank 0 of a `torch.distributed` group only.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from prompt_diffusion_tpu_torch.generate import rank_world
from prompt_diffusion_tpu_torch.serve import write_png


def save_grid(images01: np.ndarray, path: str, ncol: Optional[int] = None) -> None:
    """images01 (N, H, W, 3) in [0, 1] -> one PNG grid, `ncol` wide (at
    most 4 by default)."""
    n, h, w, c = images01.shape
    ncol = ncol or min(4, n)
    nrow = (n + ncol - 1) // ncol
    grid = np.zeros((nrow * h, ncol * w, c), np.float32)
    for i in range(n):
        r, cc = divmod(i, ncol)
        grid[r * h:(r + 1) * h, cc * w:(cc + 1) * w] = images01[i]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_png(path, grid)


class ImageLogger:
    def __init__(self, logdir: str, freq: int = 500, max_images: int = 4,
                 guidance_scale: float = 9.0, num_steps: int = 50):
        self.dir = os.path.join(logdir, "image_log")
        self.freq, self.max_images = freq, max_images
        self.guidance_scale, self.num_steps = guidance_scale, num_steps

    def maybe_log(self, pipe, batch, step: int, generator: torch.Generator,
                  split: str = "train") -> bool:
        """At a step that is a nonzero multiple of `freq`: samples for the
        batch's first `max_images` examples (its prompts, the empty prompt
        as the negative); returns whether it wrote."""
        if step == 0 or step % self.freq or rank_world()[0] != 0:
            return False
        n = min(self.max_images, len(batch["image"]))
        t = lambda a: torch.as_tensor(np.asarray(a))
        imgs = pipe.generate(t(batch["token_ids"][:n]),
                             t(np.repeat(batch["null_ids"], n, axis=0)),
                             t(batch["example_pair"][:n]), t(batch["query"][:n]),
                             num_steps=self.num_steps, guidance_scale=self.guidance_scale,
                             generator=generator)
        out = os.path.join(self.dir, split)
        save_grid(imgs.float().cpu().numpy(), os.path.join(out, f"samples_step{step:06d}.png"))
        save_grid(np.asarray(batch["query"][:n]), os.path.join(out, f"query_step{step:06d}.png"))
        with open(os.path.join(out, f"prompts_step{step:06d}.json"), "w") as f:
            json.dump(list(batch["prompt"][:n]), f)
        return True


class MetricLogger:
    """Scalar metrics as JSON lines in `<logdir>/metrics.jsonl` (the
    reference's TensorBoard / W&B logging, train.py:251-257, as one
    append-only stream)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.jsonl")

    def log(self, step: int, metrics: dict) -> None:
        if rank_world()[0] != 0:
            return
        rec = {"step": int(step)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                pass
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
