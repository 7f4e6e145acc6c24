"""COCO-2017-val test datamodule (coco2017val.py port), for the PyTorch
port: a copy of `prompt_diffusion_tpu/data/coco_val.py`, used by the
`generate` entry (`tests/test_torch_generate_entry.py` holds the two
against each other). Images decode with PIL.

Re-expression of `COCOValDataset`/`TestDatamodule` (coco2017val.py:10-106):
per-image all-task conditions (`<root>/<task>/<name>.jpg`) plus prompt
files (`<root>/prompts/<name>.txt`), used for unseen-task evaluation by
generate_test.py. Emits flat batches (the reference's list-flattening
collate_fn :88-97 becomes plain stacking here)."""

from __future__ import annotations

import os
from glob import glob
from typing import List, Sequence

import numpy as np


class COCOValDataset:
    def __init__(self, root: str, tasks: Sequence[str], res: int = 512,
                 image_dir: str = "images"):
        self.root = root
        self.tasks = list(tasks)
        self.res = res
        self.files = sorted(glob(os.path.join(root, image_dir, "*.jpg")))

    def __len__(self):
        return len(self.files)

    def _load(self, path, to_m11: bool):
        from PIL import Image

        img = Image.open(path).convert("RGB").resize((self.res, self.res), Image.BILINEAR)
        arr = np.asarray(img, np.float32) / 255.0
        return arr * 2 - 1 if to_m11 else arr

    def __getitem__(self, i: int) -> dict:
        f = self.files[i]
        name = os.path.splitext(os.path.basename(f))[0]
        image = self._load(f, to_m11=True)
        conditions = {
            t: self._load(os.path.join(self.root, t, f"{name}.jpg"), to_m11=False)
            for t in self.tasks
            if os.path.exists(os.path.join(self.root, t, f"{name}.jpg"))
        }
        prompt_path = os.path.join(self.root, "prompts", f"{name}.txt")
        prompt = open(prompt_path).read().strip() if os.path.exists(prompt_path) else ""
        return dict(name=name, image=image, conditions=conditions, prompt=prompt)

    def batches(self, batch_size: int, task: str):
        """Flat batches for one task (generate_test.py consumption)."""
        idxs = [i for i in range(len(self))]
        for s in range(0, len(idxs), batch_size):
            items = [self[i] for i in idxs[s : s + batch_size]]
            items = [it for it in items if task in it["conditions"]]
            if not items:
                continue
            yield {
                "name": [it["name"] for it in items],
                "image": np.stack([it["image"] for it in items]),
                "condition": np.stack([it["conditions"][task] for it in items]),
                "prompt": [it["prompt"] for it in items],
            }
