"""LAION meta-learning dataset (laion_meta_dataset.py port), for the
PyTorch port: a copy of `prompt_diffusion_tpu/data/laion_meta.py`, used by
the `generate` entry (`tests/test_torch_generate_entry.py` holds the two
against each other). Images decode with PIL.

Re-expression of `LaionBaseDataset`/`CombineDatasets`/`ControlDataModule`
(laion_meta_dataset.py:24-326) for the Diffusers-style trainers: shot-
grouped filegroups with a random support group per query; per-sample
output mirrors the reference —
    images       (2·shots, H, W, 3)  in [-1, 1]
    conditions   (T, 2·shots, H, W, 3) in [0, 1]
    prompts      list[str] (2·shots)
    task_indices (T,) int32 from the TASKS registry (:14-21)
(NHWC instead of NCHW — the only layout change.)

The human/nonhuman split + seeded index split (seed 1505,
laion_meta_dataset.py:213) and the fixed-support `tuning_loader`
(few-shot finetune, :302-326) are preserved.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Dict, List, Optional, Sequence

import numpy as np

TASKS = {
    "canny": 0,
    "depth": 1,
    "hed": 2,
    "normal": 3,
    "pose": 4,  # segmentation slot in the reference registry
    "densepose": 5,
}

SPLIT_SEED = 1505  # laion_meta_dataset.py:213


def _load(path: str, res: int, to_m11: bool) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((res, res), Image.BILINEAR)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return arr * 2.0 - 1.0 if to_m11 else arr


class LaionMetaDataset:
    """Shot-grouped meta dataset over one laion_{human,nonhuman} root."""

    def __init__(
        self,
        path: str,
        tasks: Sequence[str],
        tasks_per_batch: int = 1,
        res: int = 512,
        shots: int = 1,
        indices: Optional[Sequence[int]] = None,
        train: bool = True,
        task_map: Optional[Dict[str, int]] = None,
    ):
        self.path = path
        self.tasks = list(tasks)
        self.tasks_per_batch = tasks_per_batch
        self.res = res
        self.shots = shots
        self.train = train
        # auto-extend the registry for unseen tasks (few-shot finetune on a
        # NEW task gets the next free index)
        self.task_map = dict(task_map or TASKS)
        for t in self.tasks:
            if t not in self.task_map:
                self.task_map[t] = max(self.task_map.values(), default=-1) + 1

        filenames = sorted(
            f for d in glob(os.path.join(path, "*/")) for f in glob(os.path.join(d, "*.jpg"))
        )
        if indices is not None:
            filenames = [filenames[i] for i in indices]
        self.filenames = filenames
        self.num_filegroups = len(filenames) // shots
        # FIXED grouping (deterministic permutation): `support_idx` must
        # address the SAME files every draw — the few-shot tuning_loader's
        # whole protocol is a fixed ≤15-example support set
        # (finetune_promptdiffusion_sd15.py:739-753). A per-sample
        # reshuffle here silently widened supports to the full split.
        # Query/support PAIRING stays random via the caller's rng.
        self._groups = self._filegroups(np.random.default_rng(0))

    def __len__(self) -> int:
        return self.num_filegroups

    def _filegroups(self, rng: np.random.Generator) -> List[List[str]]:
        order = rng.permutation(len(self.filenames))
        groups = [
            [self.filenames[j] for j in order[i : i + self.shots]]
            for i in range(0, len(order) - self.shots + 1, self.shots)
        ]
        return groups

    def sample(self, rng: np.random.Generator, i: int, support_idx: Optional[int] = None) -> dict:
        groups = self._groups
        i = i % len(groups)
        if support_idx is None:
            sp = rng.integers(len(groups))
            while sp == i and len(groups) > 1:
                sp = rng.integers(len(groups))
        else:
            sp = support_idx % len(groups)
        files = groups[i] + groups[sp]

        images = np.stack([_load(f, self.res, to_m11=True) for f in files])

        if self.train:
            replace = self.tasks_per_batch > len(self.tasks)
            tasks = list(rng.choice(self.tasks, self.tasks_per_batch, replace=replace))
        else:
            tasks = self.tasks
        task_indices = np.asarray([self.task_map[t] for t in tasks], np.int32)

        conditions = np.stack(
            [
                np.stack(
                    [
                        _load(
                            os.path.join(
                                self.path,
                                os.path.basename(os.path.dirname(f)),
                                task,
                                os.path.basename(f),
                            ),
                            self.res,
                            to_m11=False,
                        )
                        for f in files
                    ]
                )
                for task in tasks
            ]
        )

        prompts = []
        for f in files:
            txt = f[:-4] + ".txt"
            if os.path.exists(txt):
                with open(txt) as fp:
                    prompts.append(fp.read().strip())
            else:
                prompts.append("")
        return dict(images=images, conditions=conditions, prompts=prompts,
                    task_indices=task_indices)


def make_split_indices(total: int, val_fraction: float = 0.05, seed: int = SPLIT_SEED):
    """Seeded train/val index split (ControlDataModule, :213-282)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(total)
    n_val = int(total * val_fraction)
    return np.sort(order[n_val:]), np.sort(order[:n_val])


class ControlDataModule:
    """Human + nonhuman LaionMetaDataset pair with train/val splits and
    batch iterators (Lightning-DataModule equivalent, :181-326)."""

    def __init__(
        self,
        root: str,
        human_tasks: Sequence[str] = ("pose", "densepose"),
        nonhuman_tasks: Sequence[str] = ("canny", "depth", "hed", "normal"),
        res: int = 512,
        shots: int = 1,
        tasks_per_batch: int = 1,
        val_fraction: float = 0.05,
    ):
        self.root = root
        self.datasets = {}
        for kind, tasks in (("human", human_tasks), ("nonhuman", nonhuman_tasks)):
            path = os.path.join(root, f"laion_{kind}")
            # skip kinds with NO requested tasks (reference gates the human
            # datasets on pose/densepose being in train_tasks,
            # laion_meta_dataset.py:215-218) — a zero-task dataset would
            # crash at rng.choice([]) the first time round-robin draws it
            if not tasks or not os.path.isdir(path):
                continue
            probe = LaionMetaDataset(path, tasks, tasks_per_batch, res, shots)
            train_idx, val_idx = make_split_indices(len(probe.filenames), val_fraction)
            self.datasets[kind] = {
                "train": LaionMetaDataset(path, tasks, tasks_per_batch, res, shots,
                                          indices=train_idx, train=True),
                "val": LaionMetaDataset(path, tasks, tasks_per_batch, res, shots,
                                        indices=val_idx, train=False),
            }

    def loader(self, split: str, batch_size: int, seed: int = 0,
               fixed_supports=None):
        sets = [d[split] for d in self.datasets.values()]
        return _CombinedLoader(sets, batch_size, seed,
                               fixed_supports=fixed_supports)

    def tuning_loader(self, split: str, batch_size: int, num_supports: int = 15,
                      seed: int = 0):
        """Few-shot finetune loader: supports drawn from a FIXED index set
        (finetune_promptdiffusion_sd15.py:739-753)."""
        sets = [d[split] for d in self.datasets.values()]
        return _CombinedLoader(sets, batch_size, seed, fixed_supports=num_supports)


class _CombinedLoader:
    """Round-robin batch iterator over multiple LaionMetaDatasets."""

    def __init__(self, datasets, batch_size, seed=0, fixed_supports=None):
        self.datasets = [d for d in datasets if len(d) > 0]
        if not self.datasets:
            raise ValueError(
                "no non-empty datasets for this split — check the data "
                "root layout (laion_human/ laion_nonhuman/), the task "
                "lists, and that the split has ≥1 sample (a tiny dataset "
                "can round the 5% val split down to zero files)")
        self.batch_size = batch_size
        self.seed = seed
        self.fixed_supports = fixed_supports

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        while True:
            ds = self.datasets[rng.integers(len(self.datasets))]
            samples = []
            for _ in range(self.batch_size):
                i = int(rng.integers(len(ds)))
                sp = int(rng.integers(self.fixed_supports)) if self.fixed_supports else None
                samples.append(ds.sample(rng, i, support_idx=sp))
            yield {
                "images": np.stack([s["images"] for s in samples]),
                "conditions": np.stack([s["conditions"] for s in samples]),
                "prompts": [s["prompts"] for s in samples],
                "task_indices": np.stack([s["task_indices"] for s in samples]),
            }
