"""PyTorch port, the annotation entry (`prompt_diffusion_tpu_torch.annotate_data`)
against the JAX entry (`annotate_data.py`) on a directory of small jpgs: the
same files written for canny, for depth + normal through tiny DPT models
(the checkpoint loaders monkeypatched to return them, same weights in both),
for hed through one network-bsds500-format `.pth` both entries read (the
nets at fp32), and for seg through one mmseg-format `.pth` of a tiny
UniFormer; each hed and seg file decodes to the JAX entry's image; a task
without its checkpoint is refused."""

import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import annotate_data as jax_entry
from prompt_diffusion_tpu.annotators import hed as jh
from prompt_diffusion_tpu.annotators import midas as jm
from prompt_diffusion_tpu.annotators import uniformer as ju
from prompt_diffusion_tpu.utils.dtypes import fp32_policy as j_fp32_policy
from prompt_diffusion_tpu_torch import annotate_data as port_entry
from prompt_diffusion_tpu_torch.annotators import hed as ph
from prompt_diffusion_tpu_torch.annotators import midas as pm
from prompt_diffusion_tpu_torch.annotators import uniformer as pu
from prompt_diffusion_tpu_torch.tools.jax_bridge import load_jax_model
from prompt_diffusion_tpu_torch.utils.dtypes import fp32_policy
from tests.torch_port_util import randomize

torch.set_num_threads(2)

TINY = dict(hidden_size=64, num_layers=4, num_heads=4, hooks=(0, 1, 2, 3),
            reassemble_dims=(32, 64, 64, 64), features=32, pos_grid=4)
RES = 64


def _dataset(root):
    """Three small jpgs in two subfolders, no seeds.json."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for i, sub in enumerate(("a", "a", "b")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        img = rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)
        img[10:30, 8:24] = 255 - 40 * i  # an edge canny keeps
        Image.fromarray(img).save(os.path.join(root, sub, f"{i}.jpg"))
    return root


def _written(root, before):
    now = {os.path.relpath(os.path.join(d, f), root)
           for d, _, files in os.walk(root) for f in files}
    return now - before


def _run_both(tmp_path, monkeypatch, tasks, ckpts={}):
    """Runs both entries on copies of one data set; returns the names each
    wrote."""
    src = _dataset(str(tmp_path / "src"))
    before = {os.path.relpath(os.path.join(d, f), src) for d, _, fs in os.walk(src) for f in fs}
    jdir, pdir = (shutil.copytree(src, str(tmp_path / n)) for n in ("jax", "port"))
    flags = ["--tasks", *tasks, "--resolution", str(RES), "--batch-size", "2"]
    if "depth" in tasks or "normal" in tasks:
        flags += ["--midas-ckpt", "tiny.pt"]
    for task, path in ckpts.items():
        flags += [f"--{task}-ckpt", path]
    monkeypatch.setattr(sys, "argv", ["annotate_data.py", "--path", jdir, *flags])
    jax_entry.main()
    port_entry.main(["--path", pdir, "--device", "cpu", *flags])
    return _written(jdir, before), _written(pdir, before)


def test_canny_entry_writes_the_jax_entry_files(tmp_path, monkeypatch):
    jax_files, port_files = _run_both(tmp_path, monkeypatch, ["canny"])
    assert port_files == jax_files == {"a/0_canny.jpg", "a/1_canny.jpg", "b/2_canny.jpg"}


def test_depth_normal_entry_writes_the_jax_entry_files(tmp_path, monkeypatch):
    jmod = jm.DPTDepth(jm.DPTConfig(**TINY), j_fp32_policy())
    params = randomize(jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                      jnp.zeros((1, RES, RES, 3))), 1)
    port = pm.DPTDepth(pm.DPTConfig(**TINY), fp32_policy())
    load_jax_model(port, params)
    monkeypatch.setattr(jm, "create_dpt", lambda path: (jmod, params))
    monkeypatch.setattr(port_entry, "create_dpt", lambda path, device: port.to(device).eval())
    jax_files, port_files = _run_both(tmp_path, monkeypatch, ["depth", "normal"])
    expected = {f"{p}_{t}.jpg" for p in ("a/0", "a/1", "b/2") for t in ("depth", "normal")}
    assert port_files == jax_files == expected


def _decoded(root, names):
    from PIL import Image

    return {n: np.asarray(Image.open(os.path.join(root, n)), np.int16) for n in sorted(names)}


def _hed_file(tmp_path):
    """A network-bsds500-format `.pth` (the reference's `module` names) of
    random weights, fan-in scaled."""
    from tests.test_torch_annotators import _params, _port

    params = _params(jh.HEDNetwork(policy=j_fp32_policy()), np.zeros((1, 32, 32, 3), np.float32))
    port = _port(ph.HEDNetwork(fp32_policy()), params)
    path = str(tmp_path / "network-bsds500.pth")
    torch.save({k.replace("net", "module", 1): v
                for k, v in ph.export_hed_checkpoint(port).items()}, path)
    return path


def test_hed_entry_writes_the_jax_entry_files(tmp_path, monkeypatch):
    """Both entries read one `.pth` (each through its own importer) and run
    HED at fp32: the same files, each decoding to the JAX entry's image
    within JPEG's rounding of a one-level difference."""
    path = _hed_file(tmp_path)
    net = jh.HEDNetwork
    monkeypatch.setattr(jh, "HEDNetwork", lambda: net(policy=j_fp32_policy()))
    monkeypatch.setattr(port_entry, "create_hed", lambda p, device: ph.create_hed(
        p, device=device, policy=fp32_policy()))
    jax_files, port_files = _run_both(tmp_path, monkeypatch, ["hed"], {"hed": path})
    assert port_files == jax_files == {"a/0_hed.jpg", "a/1_hed.jpg", "b/2_hed.jpg"}
    got, want = _decoded(str(tmp_path / "port"), port_files), \
        _decoded(str(tmp_path / "jax"), jax_files)
    for name in want:
        diff = np.abs(got[name] - want[name])
        assert diff.mean() <= 0.05 and diff.max() <= 8, (name, diff.mean(), diff.max())


def test_seg_entry_writes_the_jax_entry_files(tmp_path, monkeypatch):
    """Both entries read one mmseg-format `.pth` of a tiny UniFormer (fp32):
    the same files, the same palette images."""
    from tests.test_torch_annotators import TINY, _mmseg_file, _params, _port

    jcfg, pcfg = ju.UniFormerConfig(**TINY), pu.UniFormerConfig(**TINY)
    params = _params(ju.UniFormerSeg(jcfg, j_fp32_policy()), np.zeros((1, RES, RES, 3),
                                                                     np.float32), seed=3)
    path = str(tmp_path / "upernet_global_small.pth")
    _mmseg_file(path, _port(pu.UniFormerSeg(pcfg, fp32_policy()), params))
    importer, net = ju.import_uniformer_checkpoint, ju.UniFormerSeg
    monkeypatch.setattr(ju, "UniFormerSeg", lambda: net(jcfg, j_fp32_policy()))
    monkeypatch.setattr(ju, "import_uniformer_checkpoint", lambda p: importer(p, jcfg))
    monkeypatch.setattr(port_entry, "create_uniformer", lambda p, device: pu.create_uniformer(
        p, device=device, policy=fp32_policy(), config=pcfg))
    jax_files, port_files = _run_both(tmp_path, monkeypatch, ["seg"], {"seg": path})
    assert port_files == jax_files == {"a/0_seg.jpg", "a/1_seg.jpg", "b/2_seg.jpg"}
    got, want = _decoded(str(tmp_path / "port"), port_files), \
        _decoded(str(tmp_path / "jax"), jax_files)
    for name in want:
        assert (got[name] == want[name]).mean() >= 0.99, name


@pytest.mark.parametrize("task", ["hed", "seg"])
def test_task_needs_its_checkpoint(task, tmp_path, capsys):
    with pytest.raises(SystemExit):
        port_entry.parse_args(["--path", str(tmp_path), "--tasks", "canny", task])
    assert f"--{task}-ckpt" in capsys.readouterr().err


def test_depth_needs_a_checkpoint(tmp_path, capsys):
    with pytest.raises(SystemExit):
        port_entry.parse_args(["--path", str(tmp_path), "--tasks", "depth"])
    assert "--midas-ckpt" in capsys.readouterr().err


def test_annotate_batch_writes_hed_and_seg(tmp_path):
    """hed and seg through given modules: the hed map clipped and truncated
    to uint8, the seg map's classes rendered with the ADE palette; each file
    holds the bytes PIL writes for that array."""
    import io

    from PIL import Image

    from tests.test_torch_annotators import TINY

    torch.manual_seed(0)
    hed = ph.HEDNetwork(fp32_policy()).eval()
    seg = pu.UniFormerSeg(pu.UniFormerConfig(**TINY), fp32_policy()).eval()
    imgs = torch.from_numpy(np.random.default_rng(2).uniform(0, 255, (2, 32, 32, 3))
                            .astype(np.float32))
    fns = port_entry.build_annotators(["hed", "seg"], device="cpu", hed=hed, seg=seg)
    paths = [str(tmp_path / f"{i}.jpg") for i in range(2)]
    written = port_entry.annotate_batch(fns, paths, imgs)
    assert written == [str(tmp_path / f"{i}_{t}.jpg") for t in ("hed", "seg") for i in range(2)]
    with torch.no_grad():
        edges = np.clip(hed(imgs.permute(0, 3, 1, 2)).numpy() * 255.0, 0, 255).astype(np.uint8)
        classes = seg(imgs.permute(0, 3, 1, 2)).argmax(dim=1).numpy()
    want = [np.repeat(e[..., None], 3, -1) for e in edges] + list(
        pu.colorize_segmentation(classes))
    for path, arr in zip(written, want):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG")
        with open(path, "rb") as f:
            assert f.read() == buf.getvalue(), path


def test_annotate_batch_matches_the_annotators(tmp_path):
    """The batch function writes what the annotators compute: the canny
    jpg decodes to the edge map it was given (up to JPEG's rounding)."""
    from PIL import Image

    imgs = torch.from_numpy(np.random.default_rng(1).uniform(0, 255, (2, 32, 32, 3))
                            .astype(np.float32))
    fns = port_entry.build_annotators(["canny"], device="cpu")
    paths = [str(tmp_path / f"{i}.jpg") for i in range(2)]
    written = port_entry.annotate_batch(fns, paths, imgs)
    assert written == [str(tmp_path / f"{i}_canny.jpg") for i in range(2)]
    edges = fns["canny"](imgs).numpy()
    for path, e in zip(written, edges):
        decoded = np.asarray(Image.open(path).convert("L"), np.float32)
        assert np.abs(decoded - e).mean() < 20
