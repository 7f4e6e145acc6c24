"""FID for the PyTorch port, on the card.

    python -m prompt_diffusion_tpu_torch.evaluation.fid ref  --images DIR --out ref.npz
    python -m prompt_diffusion_tpu_torch.evaluation.fid calc --images DIR --ref ref.npz
        [--batch 32] [--device cuda]

Counterpart of `prompt_diffusion_tpu/evaluation/fid.py` (the reference's
eval/fid.py):

  * features come from any torch callable `feature_fn(images01) -> (B, D)`
    on the device's tensors; `inception.InceptionV3` is the parity
    extractor (the CLI runs it on He-normal random weights from a seed, as
    the JAX CLI does; `inception.create_inception(path)` loads the
    pt_inception file), and any embedding model works for relative
    comparisons;
  * the statistics are `FeatureStats`, streaming float64 (Σx, Σxxᵀ, n) on
    the host, and the Fréchet distance uses the symmetric-PSD form
    tr(Σ1) + tr(Σ2) − 2·tr(sqrtm(Σ1^½ Σ2 Σ1^½)) through `eigh` in numpy
    float64: copies of the JAX package's, so that the port imports nothing
    of it;
  * image directories are read with PIL and resized to 299² with
    `Image.BILINEAR`, as the JAX CLI reads them (PIL's filter antialiases
    when it shrinks).

The feature pass sharded over several ranks (`--sharded` under
`torchrun`, `mesh=`): each rank computes the features of its rows of every
full multiple of the world size, and the float64 (Σx, Σxxᵀ, n) are summed
over the ranks once, at the end (the reference's per-rank feature pass and
NCCL all_reduce, eval/fid.py:53-77). A batch's remainder is counted once,
on rank 0, as the JAX package counts it on one device. On one rank the
statistics are the single-process ones bit for bit.

    torchrun --standalone --nproc-per-node=4 -m prompt_diffusion_tpu_torch.evaluation.fid \
        ref --images DIR --out ref.npz --sharded
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterator, Tuple

import numpy as np

@dataclasses.dataclass
class FeatureStats:
    """Streaming (Σx, Σxxᵀ, n) — merge-able across shards/hosts."""

    raw_sum: np.ndarray  # (D,)
    raw_outer: np.ndarray  # (D, D)
    count: int

    @classmethod
    def zero(cls, dim: int) -> "FeatureStats":
        return cls(np.zeros(dim, np.float64), np.zeros((dim, dim), np.float64), 0)

    def update(self, feats: np.ndarray) -> "FeatureStats":
        f = feats.astype(np.float64)
        return FeatureStats(
            self.raw_sum + f.sum(0), self.raw_outer + f.T @ f, self.count + len(f)
        )

    def merge(self, other: "FeatureStats") -> "FeatureStats":
        return FeatureStats(
            self.raw_sum + other.raw_sum,
            self.raw_outer + other.raw_outer,
            self.count + other.count,
        )

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        mu = self.raw_sum / self.count
        sigma = self.raw_outer / self.count - np.outer(mu, mu)
        # unbiased (matches np.cov / reference eval/fid.py:70-75)
        sigma = sigma * (self.count / max(self.count - 1, 1))
        return mu, sigma

    def save(self, path: str):
        np.savez(path, raw_sum=self.raw_sum, raw_outer=self.raw_outer, count=self.count)

    @classmethod
    def load(cls, path: str) -> "FeatureStats":
        z = np.load(path)
        return cls(z["raw_sum"], z["raw_outer"], int(z["count"]))


def _sqrtm_psd(a: np.ndarray) -> np.ndarray:
    vals, vecs = np.linalg.eigh(a)
    vals = np.clip(vals, 0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """FID between two Gaussians (eval/fid.py:82-86 semantics)."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    s1, s2 = np.asarray(sigma1, np.float64), np.asarray(sigma2, np.float64)
    diff = mu1 - mu2
    s1_half = _sqrtm_psd(s1)
    covmean = _sqrtm_psd(s1_half @ s2 @ s1_half)
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2.0 * np.trace(covmean))


def self_distance_bound(sigma) -> float:
    """The most `frechet_distance` of a Gaussian against itself can read,
    in absolute value, from rounding: with fewer samples than dimensions
    eigh leaves each null eigenvalue of Σ^½ Σ Σ^½ at about ε·λmax², and the
    square roots add up to D·√ε·λmax (float64 ε; λmax the largest
    eigenvalue of Σ)."""
    sigma = np.asarray(sigma, np.float64)
    lmax = float(np.linalg.eigvalsh(sigma)[-1])
    return len(sigma) * float(np.sqrt(np.finfo(np.float64).eps)) * max(lmax, 0.0)


def compute_stats_from_iterator(feature_fn: Callable, batches: Iterator[np.ndarray],
                                feature_dim: int, device="cuda") -> FeatureStats:
    """Streams batches (B, H, W, 3) in [0, 1] through `feature_fn` on
    `device` (the card unless the caller asks for the CPU) -> stats."""
    return compute_stats_from_iterator_sharded(feature_fn, batches, feature_dim, None, device)


def compute_stats_from_iterator_sharded(feature_fn: Callable, batches: Iterator[np.ndarray],
                                        feature_dim: int, mesh, device="cuda") -> FeatureStats:
    """`compute_stats_from_iterator` over every rank of `mesh` (each rank
    iterates the same batches; None is one process): each rank takes its
    rows of the largest multiple of the world size in each batch, rank 0
    the remainder too; the statistics are summed over the ranks at the
    end."""
    import torch

    from prompt_diffusion_tpu_torch.parallel.mesh import batch_slice, is_rank0, world_size

    w = world_size(mesh)
    stats = FeatureStats.zero(feature_dim)
    with torch.inference_mode():
        for batch in batches:
            batch = np.asarray(batch, np.float32)
            n_full = len(batch) // w * w
            parts = [batch_slice(batch[:n_full], mesh)] if n_full else []
            if n_full < len(batch) and is_rank0(mesh):
                parts.append(batch[n_full:])
            for part in parts:
                x = torch.as_tensor(part).to(device)
                stats = stats.update(feature_fn(x).float().cpu().numpy())
    return _all_reduce_stats(stats, mesh, device)


def _all_reduce_stats(stats: FeatureStats, mesh, device) -> FeatureStats:
    """The sum of every rank's statistics, in float64 (one all-reduce)."""
    import torch

    from prompt_diffusion_tpu_torch.parallel.mesh import sum_over_ranks, world_size

    if world_size(mesh) == 1:
        return stats
    d = len(stats.raw_sum)
    flat = np.concatenate([stats.raw_sum, stats.raw_outer.ravel(), [float(stats.count)]])
    total = sum_over_ranks(torch.from_numpy(flat).to(device), mesh).cpu().numpy()
    return FeatureStats(total[:d], total[d:d + d * d].reshape(d, d), int(total[-1]))


def compute_stats_sharded(feature_fn: Callable, images: np.ndarray, mesh,
                          device="cuda") -> FeatureStats:
    """The statistics of `images` (N, H, W, 3) in [0, 1] with the feature
    pass sharded over every rank of `mesh`; N must divide by the world
    size."""
    import torch

    from prompt_diffusion_tpu_torch.parallel.mesh import batch_slice, world_size

    if len(images) % world_size(mesh):
        raise ValueError(f"batch {len(images)} not divisible by {world_size(mesh)} ranks")
    with torch.inference_mode():
        x = torch.as_tensor(np.asarray(batch_slice(images, mesh), np.float32)).to(device)
        feats = feature_fn(x).float().cpu().numpy()
    return _all_reduce_stats(FeatureStats.zero(feats.shape[1]).update(feats), mesh, device)


def fid_between_dirs(feature_fn, feature_dim: int, dir_gen: str, ref_stats_path: str,
                     batch_size: int = 32, mesh=None, device="cuda") -> float:
    """FID between an image directory and saved reference stats — the
    library form of the CLI's `calc` mode (which calls this); with a
    `mesh`, the feature pass sharded over its ranks."""
    stats = compute_stats_from_iterator_sharded(
        feature_fn, _image_dir_batches(dir_gen, batch_size), feature_dim, mesh, device)
    mu_g, sig_g = stats.finalize()
    mu_r, sig_r = FeatureStats.load(ref_stats_path).finalize()
    return frechet_distance(mu_g, sig_g, mu_r, sig_r)


def _image_dir_batches(directory: str, batch_size: int, res: int = 299):
    from PIL import Image

    files = sorted(
        os.path.join(directory, f)
        for f in os.listdir(directory)
        if f.lower().endswith((".png", ".jpg", ".jpeg"))
    )
    for i in range(0, len(files), batch_size):
        imgs = [
            np.asarray(
                Image.open(f).convert("RGB").resize((res, res), Image.BILINEAR),
                dtype=np.float32,
            )
            / 255.0
            for f in files[i : i + batch_size]
        ]
        yield np.stack(imgs)


def default_feature_fn(device="cuda"):
    """(InceptionV3 features on `device`, 2048), He-normal random weights
    from seed 0 (rank-only comparisons), as the JAX CLI's."""
    from prompt_diffusion_tpu_torch.evaluation.inception import create_inception

    return create_inception(device=device), 2048


def main(argv=None):
    """The CLI. Returns the reference stats (`ref`) or the FID (`calc`)."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=["calc", "ref"])
    p.add_argument("--images", required=True)
    p.add_argument("--ref", default=None)
    p.add_argument("--out", default="fid_ref.npz")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--sharded", action="store_true",
                   help="under torchrun: shard the feature pass over every rank")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.mode == "calc" and not args.ref:
        p.error("calc mode requires --ref (run `ref` mode first)")

    from prompt_diffusion_tpu_torch.parallel.mesh import (
        is_rank0,
        launched,
        make_mesh,
        mesh_device,
    )

    mesh, device = None, args.device
    if args.sharded and launched():  # one process: the single-device pass, as JAX's
        mesh = make_mesh(device=args.device)
        device = mesh_device(mesh)
    feature_fn, dim = default_feature_fn(device)
    if args.mode == "ref":
        stats = compute_stats_from_iterator_sharded(
            feature_fn, _image_dir_batches(args.images, args.batch), dim, mesh, device)
        if is_rank0(mesh):
            stats.save(args.out)
            print(f"saved reference stats ({stats.count} images) → {args.out}")
        return stats
    fid = fid_between_dirs(feature_fn, dim, args.images, args.ref, args.batch, mesh=mesh,
                           device=device)
    if is_rank0(mesh):
        print(f"FID: {fid:.4f}")
    return fid


if __name__ == "__main__":
    main()
