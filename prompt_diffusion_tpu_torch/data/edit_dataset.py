"""Multi-task in-context dataset (EditDataset), torch-free: a copy.

A copy of `prompt_diffusion_tpu/data/edit_dataset.py` (the port imports
nothing of the JAX package; `tests/test_torch_train_sd15.py` holds the copy
against its original): per-task file scans of
`<path>/laion_{human|nonhuman}/<dir>/*.jpg` with conditions at
`<dir>/<task>/<file>` and captions in sibling `.txt` files; each sample
draws a random task and a same-folder support example
(`edit_dataset.py:26-163` of the reference).

Two reference bugs fixed, as in the original: the sampled support image is
used (the reference reuses the query image, edit_dataset.py:140), and
`example_pair` is an NHWC channel concat (the reference concatenates CHW
tensors on the width, against hint_channels=6).

The index is built once, sampling is NumPy-Generator-seeded, and
`BatchLoader` prefetches decoded batches on a thread pool. With
`decoder="native"` (the default, the JAX package's path wherever its
library builds) one call of the C++ decoder (`native/`) decodes a whole
batch's images; `decoder="pil"` decodes each sample through PIL. A native
decoder that does not build raises; it does not switch to PIL.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from glob import glob
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

TASK_MAPPING = {
    "pose": "human",
    "densepose": "human",
    "canny": "nonhuman",
    "depth": "nonhuman",
    "hed": "nonhuman",
    "normal": "nonhuman",
    "seg": "nonhuman",
}

DEFAULT_TASKS = ("canny", "depth", "hed", "normal")


@dataclasses.dataclass
class Record:
    gt_path: str
    control_path: str
    txt_path: str
    dir_name: str


def _load_image(path: str, res: int, to_m11: bool) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((res, res), Image.BILINEAR)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return arr * 2.0 - 1.0 if to_m11 else arr


class EditDataset:
    """Index + sampler. `sample(rng, i)` → dict of NHWC float arrays:
    image [-1,1], query [0,1], example_pair (6ch: condition[0,1] ‖
    image[-1,1]), prompt str, task str."""

    def __init__(
        self,
        path: str,
        task_list: Sequence[str] = DEFAULT_TASKS,
        split: str = "train",
        splits: tuple = (0.9, 0.1),
        resolution: int = 512,
        max_samples_per_task: int = 150_000,
    ):
        assert split in ("train", "val")
        self.path = path
        self.task_list = list(task_list)
        self.resolution = resolution
        self.file_mapping: Dict[str, List[Record]] = {}
        # same-folder support lookup: task → dir_name → [indices]
        self.dir_index: Dict[str, Dict[str, List[int]]] = {}

        train_ratio = splits[0]
        for task in self.task_list:
            base = os.path.join(path, f"laion_{TASK_MAPPING[task]}")
            files = []
            for img_file in sorted(glob(os.path.join(base, "*", "*.jpg"))):
                dir_name = os.path.basename(os.path.dirname(img_file))
                filename = os.path.basename(img_file)
                files.append(
                    Record(
                        gt_path=img_file,
                        control_path=os.path.join(base, dir_name, task, filename),
                        txt_path=img_file[:-4] + ".txt",
                        dir_name=dir_name,
                    )
                )
            files = files[:max_samples_per_task]
            cut = int(np.floor(train_ratio * len(files)))
            files = files[:cut] if split == "train" else files[cut:]
            self.file_mapping[task] = files
            dmap: Dict[str, List[int]] = {}
            for idx, r in enumerate(files):
                dmap.setdefault(r.dir_name, []).append(idx)
            self.dir_index[task] = dmap

        self.max_task_size = max((len(v) for v in self.file_mapping.values()), default=0)

    def __len__(self) -> int:
        return self.max_task_size

    def sample_paths(self, rng: np.random.Generator, i: int) -> dict:
        """Pick (query, support) records without decoding — lets the batch
        loader hand all image paths to the native C++ decoder at once."""
        task = self.task_list[rng.integers(len(self.task_list))]
        files = self.file_mapping[task]
        rec = files[i % len(files)]
        siblings = [j for j in self.dir_index[task][rec.dir_name] if files[j] is not rec]
        sup = files[siblings[rng.integers(len(siblings))]] if siblings else rec
        with open(rec.txt_path) as f:
            prompt = f.read().strip()
        return dict(
            image_path=rec.gt_path,
            query_path=rec.control_path,
            support_cond_path=sup.control_path,
            support_image_path=sup.gt_path,
            prompt=prompt,
            task=task,
        )

    def sample(self, rng: np.random.Generator, i: int) -> dict:
        rec = self.sample_paths(rng, i)
        res = self.resolution
        image = _load_image(rec["image_path"], res, to_m11=True)
        query = _load_image(rec["query_path"], res, to_m11=False)
        control_sp = _load_image(rec["support_cond_path"], res, to_m11=False)
        image_sp = _load_image(rec["support_image_path"], res, to_m11=True)
        return dict(
            image=image,
            query=query,
            example_pair=np.concatenate([control_sp, image_sp], axis=-1),
            prompt=rec["prompt"],
            task=rec["task"],
        )


def shard_order(n: int, seed: int, epoch: int, shard_id: int,
                num_shards: int) -> np.ndarray:
    """This shard's sample order for one epoch. The permutation is seeded
    by (seed, epoch) ONLY — identical across shards — so the
    [shard_id::num_shards] slices partition the dataset exactly (torch
    DistributedSampler semantics, the reference's DDP loader). A
    shard-dependent permutation seed would silently duplicate ~1-1/k of
    the samples across hosts and skip as many."""
    order = np.random.default_rng((seed, epoch)).permutation(n)
    return order[shard_id::num_shards]


class BatchLoader:
    """Threaded prefetching batch iterator over an EditDataset-like sampler.

    Yields dicts of stacked numpy arrays (+ list of prompts). Shard-aware:
    pass (shard_id, num_shards) so multi-host training reads disjoint data
    (replaces DDP's DistributedSampler). `decoder` is "native" (the C++
    batch decoder; needs a `sample_paths()` dataset) or "pil"."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        seed: int = 0,
        num_threads: int = 8,
        prefetch: int = 4,
        shard_id: int = 0,
        num_shards: int = 1,
        tokenizer=None,
        max_tokens: int = 77,
        decoder: str = "native",
    ):
        if decoder not in ("native", "pil"):
            raise ValueError(f"decoder {decoder!r}: 'native' or 'pil'")
        if decoder == "native" and not hasattr(dataset, "sample_paths"):
            raise ValueError("decoder='native' needs a dataset with sample_paths(); "
                             "pass decoder='pil'")
        self.decoder = decoder
        self.ds = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.tokenizer = tokenizer
        self.max_tokens = max_tokens

    def _make_batch(self, rng: np.random.Generator, indices) -> dict:
        seeds = rng.integers(0, 2**31, size=len(indices))
        if self.decoder == "native":
            batch = self._make_batch_native(seeds, indices)
        else:
            batch = self._make_batch_pil(seeds, indices)
        if self.tokenizer is not None:
            batch["token_ids"] = self.tokenizer(batch["prompt"], self.max_tokens)
            batch["null_ids"] = self.tokenizer([""], self.max_tokens)
        return batch

    def _make_batch_native(self, seeds, indices):
        """One C++ call decodes the whole batch's images
        (prompt_diffusion_tpu_torch.native)."""
        from prompt_diffusion_tpu_torch.native import load_batch

        recs = [
            self.ds.sample_paths(np.random.default_rng(s), i)
            for s, i in zip(seeds, indices)
        ]
        res = self.ds.resolution
        n = len(recs)
        m11 = load_batch(
            [r["image_path"] for r in recs] + [r["support_image_path"] for r in recs],
            res, to_m11=True, n_threads=self.num_threads,
        )
        p01 = load_batch(
            [r["query_path"] for r in recs] + [r["support_cond_path"] for r in recs],
            res, to_m11=False, n_threads=self.num_threads,
        )
        return {
            "image": m11[:n],
            "query": p01[:n],
            "example_pair": np.concatenate([p01[n:], m11[n:]], axis=-1),
            "prompt": [r["prompt"] for r in recs],
            "task": [r["task"] for r in recs],
        }

    def _make_batch_pil(self, seeds, indices):
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(self.num_threads) as ex:
            samples = list(
                ex.map(
                    lambda si: self.ds.sample(np.random.default_rng(si[0]), si[1]),
                    zip(seeds, indices),
                )
            )
        batch = {
            k: np.stack([s[k] for s in samples])
            for k in samples[0]
            if isinstance(samples[0][k], np.ndarray)
        }
        batch["prompt"] = [s["prompt"] for s in samples]
        batch["task"] = [s["task"] for s in samples]
        return batch

    def __iter__(self) -> Iterator[dict]:
        return self.iterate()

    def iterate(self, start: int = 0) -> Iterator[dict]:
        """The batches from the `start`-th on (0: all of them), each the
        batch an iteration from the first would give there: a resumed run
        reads on where the interrupted one stopped. (The JAX trainers start
        a resumed run's data again from the first batch.)"""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that gives up once the consumer is gone — a
            # blocking q.put would leave the thread (and a full queue of
            # decoded batches) alive after the iterator is closed
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            skip = start
            try:
                epoch = 0
                while not stop.is_set():
                    order = shard_order(len(self.ds), self.seed, epoch,
                                        self.shard_id, self.num_shards)
                    rng = np.random.default_rng(
                        (self.seed, epoch, self.shard_id))
                    for s in range(0, len(order) - self.batch_size + 1, self.batch_size):
                        if stop.is_set():
                            return
                        if skip:  # consumed before a resume: only its seeds are drawn
                            rng.integers(0, 2**31, size=self.batch_size)
                            skip -= 1
                            continue
                        if not put(self._make_batch(rng, order[s : s + self.batch_size])):
                            return
                    epoch += 1
            except BaseException as e:
                # surface the error in the consumer instead of dying
                # silently and hanging its q.get() forever
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
