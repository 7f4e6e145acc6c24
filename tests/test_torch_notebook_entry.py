"""PyTorch port, the notebook entry (`prompt_diffusion_tpu_torch.run_prompt_diffusion`)
against `examples/run_prompt_diffusion.py`: `extract_condition` for canny,
hed, seg and depth on one small image (the weighted annotators at fp32,
from files or tiny models both sides read), the inputs `main` builds
(resize, the pair, the inverse tasks' swap), and `main` whole on a tiny
SD1.5 checkpoint with injected starting noise, its PNG against the JAX
pipeline's image on the same weights, inputs and noise."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from prompt_diffusion_tpu.annotators import hed as jh
from prompt_diffusion_tpu.annotators import midas as jm
from prompt_diffusion_tpu.annotators import uniformer as ju
from prompt_diffusion_tpu.annotators import util as jutil
from prompt_diffusion_tpu.utils.dtypes import fp32_policy as j_fp32_policy
from prompt_diffusion_tpu_torch import run_prompt_diffusion as entry
from prompt_diffusion_tpu_torch.annotators import hed as ph
from prompt_diffusion_tpu_torch.annotators import midas as pm
from prompt_diffusion_tpu_torch.annotators import uniformer as pu
from prompt_diffusion_tpu_torch.data.tokenizer import HashTokenizer
from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
from prompt_diffusion_tpu_torch.tools import torch_import as pti
from prompt_diffusion_tpu_torch.tools.jax_bridge import load_jax_params
from prompt_diffusion_tpu_torch.utils.dtypes import fp32_policy
from tests.test_torch_annotators import TINY, _mmseg_file, _params, _port
from tests.test_torch_ckpt_import import RULE_KW, tiny_models
from tests.test_torch_serving import _read_png
from tests.torch_port_util import TINY_UNET

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 64
DPT_TINY = dict(hidden_size=64, num_layers=4, num_heads=4, hooks=(0, 1, 2, 3),
                reassemble_dims=(32, 64, 64, 64), features=32, pos_grid=4)


@pytest.fixture(scope="module")
def jax_example():
    """examples/run_prompt_diffusion.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "jax_run_prompt_diffusion", os.path.join(REPO, "examples", "run_prompt_diffusion.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _image(seed, shape=(RES, RES, 3)):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    base = 255.0 * ((np.hypot(yy - 30, xx - 26) < 14) ^ (xx > 48))
    img = np.clip(base[..., None] + rng.normal(0, 30, shape), 0, 255)
    return img.astype(np.uint8)


@pytest.fixture(scope="module")
def annotator_files(tmp_path_factory):
    """A network-bsds500-format HED file and an mmseg-format tiny UniFormer
    file of random weights."""
    root = tmp_path_factory.mktemp("annotators")
    hed_params = _params(jh.HEDNetwork(policy=j_fp32_policy()), np.zeros((1, 32, 32, 3),
                                                                          np.float32), seed=2)
    hed = _port(ph.HEDNetwork(fp32_policy()), hed_params)
    hed_path = str(root / "network-bsds500.pth")
    torch.save({k.replace("net", "module", 1): v
                for k, v in ph.export_hed_checkpoint(hed).items()}, hed_path)
    seg_params = _params(ju.UniFormerSeg(ju.UniFormerConfig(**TINY), j_fp32_policy()),
                         np.zeros((1, RES, RES, 3), np.float32), seed=3)
    seg_path = str(root / "upernet_global_small.pth")
    _mmseg_file(seg_path, _port(pu.UniFormerSeg(pu.UniFormerConfig(**TINY), fp32_policy()),
                                seg_params))
    return {"hed": hed_path, "seg": seg_path, "midas": "tiny.pt"}


@pytest.fixture
def fp32_annotators(monkeypatch):
    """Both packages' annotators at fp32, UniFormer at the tiny config, and
    MiDaS as one tiny DPT-Large with the same weights on both sides."""
    hed_net, seg_net, seg_import = jh.HEDNetwork, ju.UniFormerSeg, ju.import_uniformer_checkpoint
    jcfg, pcfg = ju.UniFormerConfig(**TINY), pu.UniFormerConfig(**TINY)
    monkeypatch.setattr(jh, "HEDNetwork", lambda: hed_net(policy=j_fp32_policy()))
    monkeypatch.setattr(ju, "UniFormerSeg", lambda: seg_net(jcfg, j_fp32_policy()))
    monkeypatch.setattr(ju, "import_uniformer_checkpoint", lambda p: seg_import(p, jcfg))
    real_hed, real_seg = ph.create_hed, pu.create_uniformer
    monkeypatch.setattr(ph, "create_hed", lambda p, device: real_hed(p, device, fp32_policy()))
    monkeypatch.setattr(pu, "create_uniformer", lambda p, device: real_seg(
        p, device, fp32_policy(), pcfg))
    jdpt = jm.DPTDepth(jm.DPTConfig(**DPT_TINY), j_fp32_policy())
    dpt_params = _params(jdpt, np.zeros((1, RES, RES, 3), np.float32), seed=4)
    port_dpt = _port(pm.DPTDepth(pm.DPTConfig(**DPT_TINY), fp32_policy()), dpt_params)
    monkeypatch.setattr(jm, "create_dpt", lambda p: (jdpt, dpt_params))
    monkeypatch.setattr(pm, "create_dpt", lambda p, device: port_dpt.to(device))


# (task, at most this share of values off, by at most this many levels):
# canny's maps are equal; HED's and the depth's truncation to uint8 may
# move a value by one; seg's argmax may flip at a near-tie
@pytest.mark.parametrize("task,share,levels", [("canny", 0.0, 0), ("hed", 0.01, 1),
                                               ("seg", 0.01, 255), ("depth", 0.01, 1),
                                               ("normal", 0.01, 1)])
def test_extract_condition_matches_jax(jax_example, annotator_files, fp32_annotators,
                                       task, share, levels):
    img = _image(5)
    got = entry.extract_condition(img, task, annotator_files, device="cpu")
    want = jax_example.extract_condition(img, task, annotator_files)
    assert got.shape == want.shape == (RES, RES, 3) and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert (diff > 0).mean() <= share and diff.max() <= levels, ((diff > 0).mean(), diff.max())
    assert got.any()


def test_extract_condition_needs_weights():
    with pytest.raises(SystemExit, match="--hed-ckpt"):
        entry.extract_condition(_image(6), "hed", {}, device="cpu")
    with pytest.raises(SystemExit, match="unknown forward task"):
        entry.extract_condition(_image(6), "mlsd", {}, device="cpu")


def _write(path, arr):
    Image.fromarray(arr).save(path)
    return str(path)


def _jax_inputs(jax_example, args, ckpts):
    """The pair and query the JAX script builds (its main's lines)."""
    load = lambda p: jutil.resize_image(jutil.hwc3(np.asarray(Image.open(p).convert("RGB"))),
                                        args.resolution)
    example_img, query = load(args.example_image), load(args.query_image)
    example_cond = load(args.example_cond) if args.example_cond else \
        jax_example.extract_condition(example_img, args.task.removeprefix("inv_"), ckpts)
    if args.task.startswith("inv_"):
        example_cond, example_img = example_img, example_cond
    pair = np.concatenate([example_cond.astype(np.float32) / 127.5 - 1.0,
                           example_img.astype(np.float32) / 127.5 - 1.0], axis=-1)
    return pair, query.astype(np.float32) / 127.5 - 1.0


@pytest.mark.parametrize("task,cond", [("canny", False), ("inv_canny", False), ("hed", True),
                                       ("inv_seg", False)])
def test_prepare_inputs_match_jax(jax_example, annotator_files, fp32_annotators, tmp_path,
                                  task, cond):
    """Images of other sizes resized as the JAX script resizes them (the
    short side to --resolution, sides rounded to 64), the condition from
    the annotator or from --example-cond, the inverse tasks' swap."""
    ex = _write(tmp_path / "example.png", _image(7, (80, 70, 3)))
    q = _write(tmp_path / "query.png", _image(8, (50, 60, 3)))
    argv = ["--ckpt", "x", "--example-image", ex, "--query-image", q, "--task", task,
            "--prompt", "a house", "--resolution", str(RES), "--device", "cpu",
            "--hed-ckpt", annotator_files["hed"], "--seg-ckpt", annotator_files["seg"]]
    if cond:
        argv += ["--example-cond", _write(tmp_path / "cond.png", _image(9, (90, 64, 3)))]
    args = entry.parse_args(argv)
    pair, query = entry.prepare_inputs(args)
    want_pair, want_query = _jax_inputs(jax_example, args, annotator_files)
    assert pair.shape == want_pair.shape and query.shape == want_query.shape
    assert pair.shape[-1] == 6 and pair.shape[0] % 64 == 0 and pair.shape[1] % 64 == 0
    # resize_image may round one value in 10^4 the other way
    assert (np.abs(query - want_query) > 1e-6).mean() <= 1e-4
    off = np.abs(pair - want_pair) > 1e-6
    assert off.mean() <= (0.01 if "seg" in task else 1e-3), off.mean()


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """A tiny SD1.5 `.ckpt` of random weights (fan-in scaled), the JAX
    pipeline and its parameters with the same weights."""
    from prompt_diffusion_tpu.models import clip_text as jclip
    from prompt_diffusion_tpu.models import controlnet_sd15 as jcn
    from prompt_diffusion_tpu.models import unet_sd15 as junet
    from prompt_diffusion_tpu.models import vae as jvae
    from prompt_diffusion_tpu.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15 as JPipe
    from prompt_diffusion_tpu.schedulers.schedules import DiffusionSchedule as JSchedule
    from tests.torch_port_util import TINY_CLIP, TINY_VAE, randomize

    jpol, ucfg = j_fp32_policy(), junet.UNetConfig(**TINY_UNET)
    jpipe = JPipe(unet=junet.UNetSD15(config=ucfg, policy=jpol),
                  controlnet=jcn.ControlNetSD15(config=ucfg, hint_channels=6, policy=jpol),
                  vae=jvae.AutoencoderKL(config=jvae.VAEConfig(**TINY_VAE), policy=jpol),
                  text_encoder=jclip.CLIPTextModel(config=jclip.CLIPTextConfig(**TINY_CLIP),
                                                   policy=jpol),
                  schedule=JSchedule.create())
    params = randomize(jax.eval_shape(lambda r: jpipe.init_params(r, image_size=RES),
                                      jax.random.PRNGKey(0)), 21)
    pipe = PromptDiffusionSD15.create(**tiny_models(), device="cpu")
    load_jax_params(pipe, params)
    path = str(tmp_path_factory.mktemp("sd15") / "tiny.ckpt")
    from prompt_diffusion_tpu_torch.models.unet_sd15 import UNetConfig

    pti.export_ldm_checkpoint(pipe.state_dicts(), path, unet_cfg=UNetConfig(**TINY_UNET),
                              **RULE_KW)
    return path, jpipe, params


def tiny_tok(texts):
    return HashTokenizer()(texts) % 100  # the tiny CLIP's vocabulary


@pytest.mark.parametrize("task,guess", [("canny", False), ("inv_canny", True)])
def test_main_matches_the_jax_pipeline(jax_example, tiny_ckpt, tmp_path, task, guess):
    """`main` on the tiny checkpoint (`from_single_file` with tiny models on
    the meta device) with injected noise: its PNG is the JAX pipeline's
    image on the same weights, the JAX script's inputs and the same noise,
    rounded (within one level: the frameworks' fp32 sums differ)."""
    path, jpipe, params = tiny_ckpt
    ex = _write(tmp_path / "example.png", _image(10))
    q = _write(tmp_path / "query.png", _image(11))
    out = str(tmp_path / "out.png")
    argv = ["--ckpt", path, "--example-image", ex, "--query-image", q, "--task", task,
            "--prompt", "a house", "--resolution", str(RES), "--steps", "2", "--cfg", "7.5",
            "--strength", "0.8", "--out", out, "--device", "cpu"] + (
        ["--guess-mode"] if guess else [])
    noise = np.random.default_rng(12).normal(size=(1, RES // 8, RES // 8, 4)).astype(np.float32)
    assert entry.main(argv, tokenizer=tiny_tok, init_noise=torch.from_numpy(noise),
                      **tiny_models("meta")) == out
    args = entry.parse_args(argv)
    pair, query = _jax_inputs(jax_example, args, {})
    ids = tiny_tok(["a house, " + entry.A_PROMPT])
    neg = tiny_tok([entry.N_PROMPT])
    ref = jpipe.jit_generate()(params, jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(neg),
                               jnp.asarray(pair[None]), jnp.asarray(query[None]), num_steps=2,
                               guidance_scale=7.5, control_scale=0.8, guess_mode=guess,
                               init_noise=jnp.asarray(noise))
    want = np.clip(np.rint(np.asarray(ref[0]) * 255), 0, 255).astype(int)
    got = _read_png(out).astype(int)
    assert got.shape == (RES, RES, 3)
    assert np.abs(got - want).max() <= 1 and (got != want).mean() <= 0.01
    assert got.std() > 1  # not a constant image


def test_main_seeds_its_noise(tiny_ckpt, tmp_path):
    """Without injected noise the starting noise is the seeded generator's:
    the same --seed gives the same PNG, another seed another."""
    path, _, _ = tiny_ckpt
    ex = _write(tmp_path / "example.png", _image(13))
    argv = lambda seed, out: ["--ckpt", path, "--example-image", ex, "--query-image", ex,
                              "--task", "canny", "--prompt", "p", "--resolution", str(RES),
                              "--steps", "2", "--seed", str(seed), "--out", str(tmp_path / out),
                              "--device", "cpu"]
    pngs = [_read_png(entry.main(argv(s, f"{i}.png"), tokenizer=tiny_tok, **tiny_models("meta")))
            for i, s in enumerate((3, 3, 4))]
    np.testing.assert_array_equal(pngs[0], pngs[1])
    assert not np.array_equal(pngs[0], pngs[2])
