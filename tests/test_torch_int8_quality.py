"""PyTorch port, the int8 quality protocol (`tools/int8_quality.py`)
against the JAX script `scripts/int8_quality.py` (loaded by path, not
changed): `main(argv, bf16=, int8=)` on tiny SD1.5 pipelines (fp32 compute,
and the int8 twin built from the fp32 one by `int8_twin`) prints the JAX
script's metric lines with the same keys, and a bf16 batch repeats bit for
bit; the ε stage against the JAX script's `eps_relerr_sd15` on one set of
weights (the same fp32 ε at every t, the same formula, int8 evaluations at
JAX's noise level, so the same error within that noise); the `--dump` /
`--from-dump` round trip gives the same lines; the SSIM and FID stages on
fixed image sets equal the JAX script's `ssim` and `fid_of` given one fixed
linear feature map in both frameworks (a pixel selection, exact in fp32,
so the statistics are bit-equal); the per-image starting noise; the SD3
twin's weights."""

import importlib.util
import inspect
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prompt_diffusion_tpu.models import controlnet_sd15 as jcn
from prompt_diffusion_tpu.models import unet_sd15 as junet
from prompt_diffusion_tpu.utils.dtypes import DTypePolicy as JPolicy
from prompt_diffusion_tpu.utils.dtypes import fp32_policy as j_fp32_policy
from prompt_diffusion_tpu_torch.models.controlnet_sd15 import ControlNetSD15
from prompt_diffusion_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15
from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
from prompt_diffusion_tpu_torch.tools import int8_quality as q
from prompt_diffusion_tpu_torch.tools.jax_bridge import load_jax_params
from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy, fp32_policy, random_init_
from prompt_diffusion_tpu_torch.utils.profiling import StepTimer
from tests.test_torch_ckpt_import import tiny_models
from tests.test_torch_sd3 import _port_pipe as _sd3_pipe
from tests.torch_port_util import TINY_UNET, nhwc, randomize

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INT8_F32 = DTypePolicy(compute_dtype=torch.float32, quant="int8")
ARGV = ["--stack", "sd15", "--n", "4", "--batch", "2", "--size", "32", "--steps", "2",
        "--device", "cpu"]


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_int8_quality", os.path.join(REPO, "scripts", "int8_quality.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pipes():
    bf = PromptDiffusionSD15.create(**tiny_models(), device="cpu")
    gen = torch.Generator().manual_seed(0)
    for m in bf.jax_modules().values():
        random_init_(m, gen, std=0.1)
    return bf, q.int8_twin("sd15", bf, policy=INT8_F32)


def _select(dim=16, seed=0):
    """A linear feature map that picks `dim` pixel values of a 32² image:
    exact in fp32 in both frameworks."""
    idx = np.random.default_rng(seed).choice(32 * 32 * 3, dim, replace=False)
    w = np.zeros((32 * 32 * 3, dim), np.float32)
    w[idx, np.arange(dim)] = 1.0
    return w


def _features(w):
    """(feature_fn, dim): `w` applied to the top-left 32² crop."""
    wt = torch.from_numpy(w)
    return (lambda x: x[:, :32, :32].reshape(len(x), -1) @ wt), w.shape[1]


def _jax_metric_keys(script):
    """The metric names and keys the JAX script prints, read from its
    source: {metric prefix: keys of its JSON object}."""
    with open(script.__file__) as f:
        src = f.read()
    assert '"metric": "sd15 eps rel-err by t", "value": errs' in src
    keys = {"sd15 eps rel-err by t": {"metric", "value"},
            "SSIM(bf16_i, int8_i)": {"metric", "p05", "p50", "mean"},
            "FID drift (random-init relative features)": {
                "metric", "fid_bf16_split_floor", "fid_bf16_vs_int8",
                "fid_bf16_vs_int8_same_seeds_half", "acceptance", "verdict"}}
    for name, ks in keys.items():
        assert name in src and all(f'"{k}"' in src for k in ks), name
    return keys


def test_main_prints_the_jax_scripts_lines(pipes, jax_script, capsys):
    bf, i8 = pipes
    out = q.main(ARGV, bf16=bf, int8=i8, features=_features(_select()))
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines == out["lines"] and len(lines) == 3
    keys = _jax_metric_keys(jax_script)
    want = [("sd15 eps rel-err by t", keys["sd15 eps rel-err by t"]),
            ("sd15 SSIM(bf16_i, int8_i)", keys["SSIM(bf16_i, int8_i)"]),
            ("sd15 FID drift (random-init relative features)",
             keys["FID drift (random-init relative features)"])]
    for line, (metric, ks) in zip(lines, want):
        assert line["metric"] == metric and set(line) == ks
    assert set(lines[0]["value"]) == {str(t) for t in (1, 250, 500, 750, 999)}
    assert all(0 < v < 1 for v in lines[0]["value"].values())
    assert lines[2]["verdict"] in ("PASS", "FAIL")
    imgs = out["images"]
    assert imgs["bf16"].shape == imgs["int8"].shape == (4, 32, 32, 3)
    assert np.isfinite(imgs["bf16"]).all() and 0 <= imgs["bf16"].min() <= imgs["bf16"].max() <= 1
    assert not np.array_equal(imgs["bf16"], imgs["int8"])
    assert out["timing"]["bf16"]["steps"] == 1  # two batches, the first skipped
    again = q.generate_set("sd15", bf, 2, 2, 32, 2, "again", StepTimer())
    np.testing.assert_array_equal(again, imgs["bf16"][:2])


# The ε stage at tiny widths with SD1.5's 768-wide context, which the JAX
# script hard-codes
EPS_UNET = dict(TINY_UNET, context_dim=768)
EPS_SIZE = 64
# the port's fp32 ControlNet + UNet against JAX's (tests/test_torch_config.py)
EPS_FP32_ATOL = 2e-4


class _Recorded:
    """A Flax module whose `apply` also hands its output to `store`, from
    inside the JAX script's jit."""

    def __init__(self, module, store):
        self.module, self.store = module, store

    def apply(self, *args, **kwargs):
        out = self.module.apply(*args, **kwargs)
        jax.debug.callback(lambda o: self.store.append(np.asarray(o, np.float64)), out)
        return out


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_eps_stage_matches_the_jax_script(jax_script):
    """Both `eps_relerr_sd15`s on one tree (fp32, and int8 with fp32
    compute), each recording its UNet outputs: the fp32 ε agree at every t
    (the inputs, timesteps and context are the script's), each returned
    value is the norm ratio of its own recorded ε, and the port's int8 ε is
    an evaluation at JAX's noise level (tests/test_torch_int8.py's rule for
    whole int8 networks: as far from JAX fp32 as JAX int8 is, ratio in
    [0.5, 1.5], and no farther from JAX int8 than 1.5 times that). An fp32
    ulp becomes a code step at int8 sites, so the two int8 evaluations
    differ at the level of the quantization error itself: the returned
    errors are held to that same ratio."""
    cfg = junet.UNetConfig(**EPS_UNET)
    stores = {mode: [] for mode in ("jax_fp32", "jax_int8", "port_fp32", "port_int8")}
    jpipes = {mode: SimpleNamespace(
        unet=_Recorded(junet.UNetSD15(config=cfg, policy=pol), stores[f"jax_{mode}"]),
        controlnet=jcn.ControlNetSD15(config=cfg, hint_channels=6, policy=pol))
        for mode, pol in (("fp32", j_fp32_policy()),
                          ("int8", JPolicy(compute_dtype=jnp.float32, quant="int8")))}
    key, lat, z = jax.random.PRNGKey(0), EPS_SIZE // 8, jnp.zeros
    ctx = z((1, 77, EPS_UNET["context_dim"]))
    m = jpipes["fp32"]
    shapes = {"unet": jax.eval_shape(m.unet.module.init, key, z((1, lat, lat, 4)),
                                     z((1,), jnp.int32), ctx),
              "controlnet": jax.eval_shape(m.controlnet.init, key, z((1, lat, lat, 4)),
                                           z((1,), jnp.int32), z((1, EPS_SIZE, EPS_SIZE, 6)),
                                           z((1, EPS_SIZE, EPS_SIZE, 3)), ctx)}
    tree = {name: randomize(s, 30 + i) for i, (name, s) in enumerate(sorted(shapes.items()))}
    ref = jax_script.eps_relerr_sd15(jpipes["fp32"], jpipes["int8"], tree, EPS_SIZE)
    jax.effects_barrier()

    models = tiny_models()
    models.update(unet=UNetSD15(UNetConfig(**EPS_UNET), fp32_policy()),
                  controlnet=ControlNetSD15(UNetConfig(**EPS_UNET), 6, fp32_policy()))
    bf = PromptDiffusionSD15.create(**models, device="cpu")
    load_jax_params(bf, tree, namespaces=("unet", "controlnet"))
    i8 = q.int8_twin("sd15", bf, policy=INT8_F32)
    for pipe, mode in ((bf, "port_fp32"), (i8, "port_int8")):
        pipe.unet.register_forward_hook(lambda _m, _a, out, s=stores[mode]: s.append(
            nhwc(out).astype(np.float64)))
    got = q.eps_relerr_sd15(bf, i8, EPS_SIZE)

    steps = list(q.EPS_TIMESTEPS)
    assert list(ref) == list(got) == steps
    assert all(len(s) == len(steps) for s in stores.values())
    for i, t in enumerate(steps):
        a_j, c_j = stores["jax_fp32"][i], stores["jax_int8"][i]
        a_p, c_p = stores["port_fp32"][i], stores["port_int8"][i]
        assert np.abs(a_j).max() > 0.1
        np.testing.assert_allclose(a_p, a_j, atol=EPS_FP32_ATOL, err_msg=f"t={t}")
        np.testing.assert_allclose(ref[t], _rel(c_j, a_j), rtol=1e-12)
        np.testing.assert_allclose(got[t], _rel(c_p, a_p), rtol=1e-12)
        quant_err = _rel(c_j, a_j)
        assert quant_err > 1e-3, (t, quant_err)
        ratio32, ratio8 = _rel(c_p, a_j) / quant_err, _rel(c_p, c_j) / quant_err
        assert 0.5 <= ratio32 <= 1.5 and ratio8 <= 1.5, (t, quant_err, ratio32, ratio8)
        assert 0.5 <= got[t] / ref[t] <= 1.5, (t, got[t], ref[t])


def test_dump_round_trip_gives_the_same_lines(pipes, tmp_path, capsys):
    bf, i8 = pipes
    feats = _features(_select(seed=1))
    first = q.main(ARGV + ["--dump", str(tmp_path)], bf16=bf, int8=i8, features=feats)
    assert sorted(os.listdir(tmp_path)) == ["sd15_bf16.npy", "sd15_int8.npy"]
    again = q.main(ARGV + ["--from-dump", str(tmp_path)], features=feats)
    assert again["lines"] == first["lines"][1:]  # no generation, no eps line
    half = q.main(ARGV + ["--bf16-from-dump", str(tmp_path)], bf16=bf, int8=i8, features=feats)
    assert half["lines"] == first["lines"]
    # the default features: the port's Inception (random He weights, seed 0)
    fid_line = q.main(ARGV + ["--from-dump", str(tmp_path)])["lines"][-1]
    assert fid_line["fid_bf16_split_floor"] > 0 and np.isfinite(fid_line["fid_bf16_vs_int8"])
    capsys.readouterr()


@pytest.mark.parametrize("seed", [0, 1])
def test_ssim_and_fid_stages_equal_the_jax_script(jax_script, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (20, 32, 32, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    np.testing.assert_array_equal(q.ssim(a, b), jax_script.ssim(a, b))
    w = _select(dim=24, seed=seed)
    fn, dim = _features(w)
    jfn = lambda x: x.reshape(x.shape[0], -1) @ jnp.asarray(w)
    for x, y in ((a[:10], a[10:]), (a, b), (a[:10], b[:10])):
        assert q.fid_of(fn, x, y, dim, device="cpu") == jax_script.fid_of(jfn, x, y, dim)


def test_start_noise_is_per_image():
    """Image i's x_T does not depend on the batch it is drawn in."""
    whole = q.start_noise(0, 4, (2, 2, 4), "cpu")
    np.testing.assert_array_equal(q.start_noise(2, 2, (2, 2, 4), "cpu"), whole[2:])
    assert not torch.equal(whole[0], whole[1])


def test_sd3_twin_and_lines(capsys):
    """SD3: the int8 twin's transformer and ControlNet rebuilt from the
    bf16 pipeline's state dicts (the VAE, down-projection and text
    encoders shared); `main --stack sd3` without T5 prints the SSIM and FID
    lines of the JAX script."""
    bf = _sd3_pipe(with_t5=False)
    gen = torch.Generator().manual_seed(1)
    for m in bf.jax_modules().values():
        random_init_(m, gen, std=0.1)
    i8 = q.int8_twin("sd3", bf, policy=INT8_F32)
    for name in ("transformer", "controlnet"):
        got, want = getattr(i8, name).state_dict(), getattr(bf, name).state_dict()
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert i8.transformer.config.num_layers == bf.transformer.config.num_layers == 3
    assert all(getattr(i8, n) is getattr(bf, n) for n in ("vae", "down_proj", "clip_l", "clip_g"))
    out = q.main(["--stack", "sd3", "--n", "2", "--batch", "1", "--size", "64", "--steps", "2",
                  "--device", "cpu"], bf16=bf, int8=i8, features=_features(_select(dim=8)))
    assert [line["metric"] for line in out["lines"]] == [
        "sd3 SSIM(bf16_i, int8_i)", "sd3 FID drift (random-init relative features)"]
    assert out["images"]["bf16"].shape == (2, 64, 64, 3)
    assert np.isfinite(out["images"]["int8"]).all()
    capsys.readouterr()


def test_defaults_are_the_cards():
    assert q.parse_args([]).device == "cuda"
    for fn in (q.fid_of,):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
