"""PyTorch port, the annotation entry (`prompt_diffusion_tpu_torch.annotate_data`)
against the JAX entry (`annotate_data.py`) on a directory of small jpgs: the
same files written for canny, and for depth + normal through tiny DPT models
(the checkpoint loaders monkeypatched to return them, same weights in both);
the tasks not ported yet are refused."""

import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import annotate_data as jax_entry
from prompt_diffusion_tpu.annotators import midas as jm
from prompt_diffusion_tpu.utils.dtypes import fp32_policy as j_fp32_policy
from prompt_diffusion_tpu_torch import annotate_data as port_entry
from prompt_diffusion_tpu_torch.annotators import midas as pm
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


def _run_both(tmp_path, monkeypatch, tasks):
    """Runs both entries on copies of one data set; returns the names each
    wrote."""
    src = _dataset(str(tmp_path / "src"))
    before = {os.path.relpath(os.path.join(d, f), src) for d, _, fs in os.walk(src) for f in fs}
    jdir, pdir = (shutil.copytree(src, str(tmp_path / n)) for n in ("jax", "port"))
    flags = ["--tasks", *tasks, "--resolution", str(RES), "--batch-size", "2"]
    if "depth" in tasks or "normal" in tasks:
        flags += ["--midas-ckpt", "tiny.pt"]
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


@pytest.mark.parametrize("task", ["hed", "seg"])
def test_unported_tasks_are_refused(task, tmp_path, capsys):
    with pytest.raises(SystemExit):
        port_entry.parse_args(["--path", str(tmp_path), "--tasks", "canny", task])
    assert "queue 1, item 4" in capsys.readouterr().err


def test_depth_needs_a_checkpoint(tmp_path, capsys):
    with pytest.raises(SystemExit):
        port_entry.parse_args(["--path", str(tmp_path), "--tasks", "depth"])
    assert "--midas-ckpt" in capsys.readouterr().err


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
