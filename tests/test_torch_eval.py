"""PyTorch port, evaluation: the copies of SSIM, RMSE, `FeatureStats`,
`frechet_distance` and `_image_dir_batches` against the JAX package's
(bit for bit), `compute_stats_from_iterator` with one fixed linear feature
map in both frameworks (1e-6 relative), and the FID CLI: `ref` then
`calc` on a PNG directory (a set against itself reads 0 within the eigh
form's rounding floor, `fid.self_distance_bound`), and `--sharded`
without torchrun: the single-process pass, its statistics the plain CLI's
bit for bit (the sharded pass over several ranks, with `mesh=`, is held by
tests/test_torch_parallel.py)."""

import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from prompt_diffusion_tpu.evaluation import fid as jfid
from prompt_diffusion_tpu.evaluation import mse as jmse
from prompt_diffusion_tpu.evaluation import ssim as jssim
from prompt_diffusion_tpu_torch.evaluation import fid, mse, ssim

torch.set_num_threads(2)


def _images(seed, n=5, size=24):
    return np.random.default_rng(seed).uniform(0, 1, (n, size, size, 3)).astype(np.float32)


def _write_dir(directory, seed, n=4, size=40, ext="png"):
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (size, size + 8 * i, 3), dtype=np.uint8)).save(
            os.path.join(directory, f"img{i}.{ext}"))
    return directory


@pytest.mark.parametrize("seed", [0, 1])
def test_ssim_copy_matches_jax(seed):
    a, b = _images(seed), _images(seed + 10)
    b[0] = a[0]  # one identical pair
    got = ssim.batch_ssim(a, b)
    np.testing.assert_array_equal(got, jssim.batch_ssim(a, b))
    assert got[0] == pytest.approx(1.0) and got.shape == (5,)


def test_rmse_copy_matches_jax(tmp_path, capsys):
    """Matched by name; a generated image of another size is resized to
    its original's; a name missing from the generated directory is left
    out; a directory against itself reads 0."""
    orig = _write_dir(str(tmp_path / "orig"), 0)
    gen = _write_dir(str(tmp_path / "gen"), 1, n=3, size=32)
    got, want = mse.rmse_between_dirs(orig, gen), jmse.rmse_between_dirs(orig, gen)
    assert got == want and len(got[1]) == 3 and got[0] > 0
    assert mse.main(["--original", orig, "--generated", orig]) == 0.0
    assert "RMSE over 4 images: 0.0000" in capsys.readouterr().out


def test_feature_stats_copy_matches_jax(tmp_path):
    """update, merge and the unbiased finalize equal JAX's; an .npz saved
    by either package loads in the other."""
    rng = np.random.default_rng(2)
    f1, f2 = rng.normal(size=(7, 6)).astype(np.float32), rng.normal(size=(5, 6))
    p = fid.FeatureStats.zero(6).update(f1).merge(fid.FeatureStats.zero(6).update(f2))
    j = jfid.FeatureStats.zero(6).update(f1).merge(jfid.FeatureStats.zero(6).update(f2))
    for got, want in zip(p.finalize(), j.finalize()):
        np.testing.assert_array_equal(got, want)
    assert p.count == j.count == 12
    p.save(str(tmp_path / "p.npz"))
    j.save(str(tmp_path / "j.npz"))
    for a, b in ((jfid.FeatureStats.load(str(tmp_path / "p.npz")), p),
                 (fid.FeatureStats.load(str(tmp_path / "j.npz")), j)):
        np.testing.assert_array_equal(a.raw_sum, b.raw_sum)
        np.testing.assert_array_equal(a.raw_outer, b.raw_outer)
        assert a.count == b.count


@pytest.mark.parametrize("dim,shift", [(8, 0.0), (64, 0.5)])
def test_frechet_distance_copy_matches_jax(dim, shift):
    rng = np.random.default_rng(dim)
    x, y = rng.normal(size=(3 * dim, dim)), rng.normal(size=(3 * dim, dim)) + shift
    args = (x.mean(0), np.cov(x, rowvar=False), y.mean(0), np.cov(y, rowvar=False))
    got = fid.frechet_distance(*args)
    assert got == jfid.frechet_distance(*args)
    assert abs(fid.frechet_distance(*args[:2], *args[:2])) < 1e-9 * np.trace(args[1])


def test_image_dir_batches_copy_matches_jax(tmp_path):
    """PNG and JPEG files of several sizes, PIL's bilinear resize to 299²."""
    d = _write_dir(str(tmp_path / "imgs"), 3, n=3)
    _write_dir(d, 4, n=2, ext="jpg")
    got, want = list(fid._image_dir_batches(d, 3)), list(jfid._image_dir_batches(d, 3))
    assert [g.shape for g in got] == [(3, 299, 299, 3), (2, 299, 299, 3)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_stats_from_iterator_matches_jax():
    """One fixed linear feature map in both frameworks: the statistics
    agree within 1e-6 relative."""
    w = np.random.default_rng(5).normal(size=(24 * 24 * 3, 16)).astype(np.float32)
    batches = [_images(6, n=4), _images(7, n=3)]
    wt = torch.from_numpy(w)
    got = fid.compute_stats_from_iterator(lambda x: x.reshape(len(x), -1) @ wt, iter(batches),
                                          16, device="cpu")
    want = jfid.compute_stats_from_iterator(lambda x: x.reshape(x.shape[0], -1) @ jnp.asarray(w),
                                            iter(batches), 16)
    assert got.count == want.count == 7
    for g, r in ((got.raw_sum, want.raw_sum), (got.raw_outer, want.raw_outer)):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6 * np.abs(r).max())


def test_fid_cli_ref_then_calc(tmp_path, capsys):
    """`ref` saves the directory's statistics; `calc` of the same directory
    against them reads 0 within `fid.self_distance_bound` (the eigh
    form's rounding floor when n < D)."""
    d = _write_dir(str(tmp_path / "imgs"), 8, n=5)
    ref = str(tmp_path / "ref.npz")
    stats = fid.main(["ref", "--images", d, "--out", ref, "--batch", "2", "--device", "cpu"])
    assert stats.count == 5 and os.path.exists(ref)
    assert "saved reference stats (5 images)" in capsys.readouterr().out
    value = fid.main(["calc", "--images", d, "--ref", ref, "--batch", "3", "--device", "cpu"])
    sigma = fid.FeatureStats.load(ref).finalize()[1]
    assert np.trace(sigma) > 0 and abs(value) <= fid.self_distance_bound(sigma)
    assert "FID: " in capsys.readouterr().out


def test_self_distance_bound_holds_at_the_floor():
    """A covariance of rank n - 1 in D = 2048 dimensions against itself:
    eigh leaves the D - n + 1 null eigenvalues of Σ^½ Σ Σ^½ at about
    ε·λmax², whose square roots add up to D·√ε·λmax at most; the bound is
    that, and a distance of 1e-3 of the trace lies far outside it."""
    x = np.random.default_rng(9).normal(size=(16, 2048))
    mu, sigma = x.mean(0), np.cov(x, rowvar=False)
    bound = fid.self_distance_bound(sigma)
    assert abs(fid.frechet_distance(mu, sigma, mu, sigma)) <= bound < 1e-3 * np.trace(sigma)


def test_fid_sharded_is_refused(tmp_path, monkeypatch):
    """What was refused runs: `--sharded` without torchrun is the
    single-process pass (JAX's on one device), so its statistics equal the
    plain CLI's bit for bit (a small feature function stands in for the
    Inception); the sharded pass over several ranks is held by
    tests/test_torch_parallel.py."""
    from PIL import Image

    rng = np.random.default_rng(2)
    for i in range(5):
        Image.fromarray(rng.integers(0, 255, (20, 24, 3), dtype=np.uint8)).save(
            tmp_path / f"{i}.png")
    w = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    monkeypatch.setattr(fid, "default_feature_fn",
                        lambda device: (lambda x: x.mean(dim=(1, 2)) @ w, 8))
    for var in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    plain = fid.main(["ref", "--images", str(tmp_path), "--out", str(tmp_path / "a.npz"),
                      "--batch", "2", "--device", "cpu"])
    sharded = fid.main(["ref", "--images", str(tmp_path), "--out", str(tmp_path / "b.npz"),
                        "--batch", "2", "--device", "cpu", "--sharded"])
    assert plain.count == sharded.count == 5
    assert np.array_equal(plain.raw_sum, sharded.raw_sum)
    assert np.array_equal(plain.raw_outer, sharded.raw_outer)


def test_fid_defaults_to_the_card():
    for fn in (fid.compute_stats_from_iterator, fid.fid_between_dirs, fid.default_feature_fn):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
