"""PyTorch port, the native C++ batch decoder (`native/`): the source a
byte-for-byte copy of the JAX package's, `load_batch` bit-equal to JAX's
on JPEGs (whole and DCT-scaled) and PNGs in both ranges, the per-file PIL
path of a file the decoder cannot read, the native `BatchLoader` batches
bit-equal to JAX's native ones, a failed build raised with the
compiler's output (no switch to PIL), and the entries' `--loader auto`
choosing PIL, and saying so, only where the decoder does not build."""

import os

import numpy as np
import pytest
from PIL import Image

from prompt_diffusion_tpu import native as jnative
from prompt_diffusion_tpu.data import edit_dataset as jed
from prompt_diffusion_tpu_torch import native
from prompt_diffusion_tpu_torch.data import edit_dataset as ped
from tests.torch_port_util import make_edit_root


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate([(384, 512), (1024, 1024), (100, 80)]):
        p = str(d / f"{i}.jpg")
        Image.fromarray(rng.integers(0, 255, (h, w, 3)).astype(np.uint8)).save(p, quality=92)
        paths.append(p)
    png = str(d / "x.png")
    Image.fromarray(rng.integers(0, 255, (64, 48, 3)).astype(np.uint8)).save(png)
    mislabeled = str(d / "bmp.jpg")  # BMP bytes behind a .jpg name
    Image.fromarray(rng.integers(0, 255, (96, 80, 3)).astype(np.uint8)).save(mislabeled,
                                                                            format="BMP")
    return paths, png, mislabeled


def test_loader_source_is_a_copy():
    with open(native.SRC, "rb") as a, open(os.path.join(
            os.path.dirname(jnative.__file__), "loader.cpp"), "rb") as b:
        assert a.read() == b.read()
    assert native.FLAGS == ("-O3", "-funroll-loops", "-shared", "-fPIC", "-std=c++17")
    assert native.SO.endswith(os.path.join("build", "native", "libpdloader.so"))


@pytest.mark.parametrize("to_m11", [False, True])
@pytest.mark.parametrize("dct_scale", [True, False])
def test_load_batch_matches_jax(images, to_m11, dct_scale):
    """JPEGs (one decoded at a reduced DCT scale when allowed), a PNG and a
    BMP behind a .jpg name (PIL's, in both packages) at 256²."""
    paths, png, mislabeled = images
    batch = paths + [png, mislabeled]
    got = native.load_batch(batch, 256, to_m11=to_m11, dct_scale=dct_scale)
    want = jnative.load_batch(batch, 256, to_m11=to_m11, dct_scale=dct_scale)
    assert got.shape == (5, 256, 256, 3) and got.dtype == np.float32
    assert np.array_equal(got, want)
    np.testing.assert_array_equal(got[4], native.load_batch_pil([mislabeled], 256, to_m11)[0])


def test_load_batch_pil_matches_jax(images):
    paths, png, _ = images
    assert np.array_equal(native.load_batch_pil(paths + [png], 64, True),
                          jnative._load_batch_pil(paths + [png], 64, True))


def test_missing_file_raises(images):
    with pytest.raises(IOError):
        native.load_batch([images[0][0], "/nonexistent/file.jpg"], 64)


def test_native_batch_loader_matches_jax(tmp_path):
    """The native BatchLoader's batches (three epochs' worth) equal the JAX
    package's native ones bit for bit."""
    root = make_edit_root(str(tmp_path))
    pd, jd = ped.EditDataset(root, resolution=32), jed.EditDataset(root, resolution=32)

    def batches(loader):
        it = iter(loader)
        out = [next(it) for _ in range(9)]
        it.close()
        return out

    mine = batches(ped.BatchLoader(pd, batch_size=3, seed=7))
    assert jnative.native_available()
    for pb, jb in zip(mine, batches(jed.BatchLoader(jd, batch_size=3, seed=7))):
        assert pb.keys() == jb.keys()
        for k in pb:
            assert np.array_equal(pb[k], jb[k]) if isinstance(pb[k], np.ndarray) else pb[k] == jb[k]


def test_batch_loader_decoder_choices(tmp_path):
    root = make_edit_root(str(tmp_path))
    ds = ped.EditDataset(root, resolution=32)
    assert ped.BatchLoader(ds, 2).decoder == "native"
    with pytest.raises(ValueError, match="'native' or 'pil'"):
        ped.BatchLoader(ds, 2, decoder="cv2")

    class NoPaths:
        resolution = 32

    with pytest.raises(ValueError, match="sample_paths"):
        ped.BatchLoader(NoPaths(), 2)
    assert ped.BatchLoader(NoPaths(), 2, decoder="pil").decoder == "pil"


@pytest.mark.parametrize("builds", [True, False])
def test_auto_decoder_is_native_where_it_builds_else_pil(builds, monkeypatch):
    """The entries' default `--loader auto` takes the native decoder where
    it builds here and PIL where it does not, and says which and why; an
    explicit choice is kept without a build."""
    if not builds:
        def fail():
            raise native.NativeBuildError("g++ ... exited 1:\nfatal error: jpeglib.h: No such file")
        monkeypatch.setattr(native, "get_lib", fail)
    said = []
    assert native.choose_decoder("auto", said.append) == ("native" if builds else "pil")
    assert len(said) == 1 and ("native decoder" in said[0])
    if not builds:
        assert "PIL" in said[0] and "jpeglib.h" in said[0]
    monkeypatch.setattr(native, "get_lib", lambda: pytest.fail("an explicit choice built"))
    assert [native.choose_decoder(c, said.append) for c in ("native", "pil")] == ["native", "pil"]
    assert len(said) == 1


def test_failed_build_raises_with_the_compiler_output(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( {\n")
    so = str(tmp_path / "out" / "lib.so")
    with pytest.raises(native.NativeBuildError, match="bad.cpp") as e:
        native.build(str(bad), so)
    assert "error" in str(e.value)
    assert not os.path.exists(so) and os.listdir(tmp_path / "out") == []


def test_build_is_skipped_when_the_library_is_newer(tmp_path):
    src = tmp_path / "ok.cpp"
    src.write_text('extern "C" int pd_loader_version() { return 2; }\n')
    so = str(tmp_path / "lib.so")
    assert native.build(str(src), so) == so
    mtime = os.path.getmtime(so)
    assert native.build(str(src), so) == so and os.path.getmtime(so) == mtime


def test_a_library_that_does_not_load_is_built_again(tmp_path, monkeypatch):
    """A newer library that fails to load (built on a machine with other
    libraries) is rebuilt from the source before it is given up on."""
    so = tmp_path / "libpdloader.so"
    so.write_bytes(b"not an ELF file")
    os.utime(so, (os.path.getmtime(native.SRC) + 10,) * 2)
    monkeypatch.setattr(native, "SO", str(so))
    monkeypatch.setattr(native, "_lib", None)
    calls = []
    real = native.build
    monkeypatch.setattr(native, "build", lambda src=native.SRC, so=str(so), force=False: (
        calls.append(force), real(src, so, force))[1])
    lib = native.get_lib()
    assert calls == [False, True] and lib.pd_loader_version() == 2
