"""RMSE between two image directories, for the inverse tasks.

    python -m prompt_diffusion_tpu_torch.evaluation.mse \\
        --original original_images --generated generated_images

A copy of `prompt_diffusion_tpu/evaluation/mse.py` (the reference's
eval/evaluate_mse.py): images are matched by file name, each generated
image is resized with PIL to its original's size, and RMSE is taken over
the uint8 pixel values; per image and the mean. Host-side only.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np


def rmse_between_dirs(original_dir: str, generated_dir: str) -> Tuple[float, Dict[str, float]]:
    from PIL import Image

    names = sorted(
        f for f in os.listdir(original_dir) if f.lower().endswith((".png", ".jpg", ".jpeg"))
    )
    per_image = {}
    for name in names:
        gen_path = os.path.join(generated_dir, name)
        if not os.path.exists(gen_path):
            continue
        a = np.asarray(Image.open(os.path.join(original_dir, name)).convert("RGB"), np.float64)
        b = np.asarray(Image.open(gen_path).convert("RGB").resize(
            (a.shape[1], a.shape[0])), np.float64)
        per_image[name] = float(np.sqrt(np.mean((a - b) ** 2)))
    mean = float(np.mean(list(per_image.values()))) if per_image else float("nan")
    return mean, per_image


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--original", default="original_images")
    p.add_argument("--generated", default="generated_images")
    args = p.parse_args(argv)
    mean, per = rmse_between_dirs(args.original, args.generated)
    print(f"RMSE over {len(per)} images: {mean:.4f}")
    return mean


if __name__ == "__main__":
    main()
