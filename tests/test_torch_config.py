"""PyTorch port, `utils/config.py`: the YAML fallback parser (what runs on
the card's machine, which has no pyyaml) against the JAX package's on the
same texts with `yaml` hidden in both, and against pyyaml on the
reference layout; the one repair (a block list at its key's own indent,
which the JAX fallback drops); `create_model` on a tiny cldm_v15-format
YAML against the JAX package's `create_model` (configurations and noise
schedule), and with the weights carried across the same ε within the
port's fp32 bound (2e-4); `create_model` defaults to the card."""

import contextlib
import dataclasses
import inspect
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import prompt_diffusion_tpu.pipelines.prompt_diffusion_sd15  # noqa: F401 (flax imports yaml)
from prompt_diffusion_tpu.utils import config as jconfig
from prompt_diffusion_tpu.utils.dtypes import fp32_policy as j_fp32_policy
from prompt_diffusion_tpu_torch.tools.jax_bridge import load_jax_params
from prompt_diffusion_tpu_torch.utils import config
from prompt_diffusion_tpu_torch.utils.dtypes import fp32_policy
from tests.torch_port_util import TINY_UNET, TINY_VAE, nchw, nhwc, randomize

torch.set_num_threads(2)

ATOL = 2e-4
TINY = dict(model_channels=TINY_UNET["model_channels"], channel_mult=TINY_UNET["channel_mult"],
            num_res_blocks=TINY_UNET["num_res_blocks"],
            attention_resolutions=TINY_UNET["attention_resolutions"],
            num_heads=TINY_UNET["num_heads"], context_dim=TINY_UNET["context_dim"],
            vae_ch=TINY_VAE["ch"], vae_ch_mult=TINY_VAE["ch_mult"],
            vae_res_blocks=TINY_VAE["num_res_blocks"])

TEXTS = {
    "test_config": """
model:
  target: some.Target
  params:
    lr: 1.5e-4
    steps: 1000
    flag: True
    mult: [ 1, 2, 4 ]
    nested:
      a: "x"
""",
    "comments_and_lists": """# a comment line
trainer:
  name: 'run one'   # inline comment
  gpus: 8
  empty: []
  tags:
    - alpha
    - 2
    - 0.5
  deep:
    deeper:
      deepest: false

data:
  root: /data/laion
""",
    # lists indented under their keys: the subset both fallbacks agree on
    "cldm_indented_lists": chip_smoke.cldm_v15_yaml().replace(
        "          - ", "            - "),
}


@contextlib.contextmanager
def no_yaml():
    """`import yaml` raises ImportError inside the block, in both packages
    (only that entry of sys.modules changes: modules first imported inside
    the block stay imported)."""
    saved = sys.modules.get("yaml")
    sys.modules["yaml"] = None
    try:
        yield
    finally:
        if saved is None:
            del sys.modules["yaml"]
        else:
            sys.modules["yaml"] = saved


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_fallback_parser_matches_jax(name):
    with no_yaml():
        got, want = config._minimal_yaml(TEXTS[name]), jconfig._minimal_yaml(TEXTS[name])
    assert got == want and got


@pytest.mark.parametrize("name", sorted(TEXTS) + ["cldm_v15"])
def test_fallback_parser_matches_pyyaml(name):
    """What the card parses equals what pyyaml gives here, the reference
    layout (block lists at their key's indent) included."""
    yaml = pytest.importorskip("yaml")
    text = TEXTS.get(name) or chip_smoke.cldm_v15_yaml()
    with no_yaml():
        got = config._minimal_yaml(text)
    assert got == yaml.safe_load(text)


def test_fallback_keeps_a_list_at_its_keys_indent():
    """The reference's cldm_v15.yaml writes the VAE's `ch_mult` as a block
    list at the key's own indent: the JAX fallback drops its items (an
    empty `ch_mult`); the port's keeps them."""
    text = chip_smoke.cldm_v15_yaml()
    with no_yaml():
        got, want = config._minimal_yaml(text), jconfig._minimal_yaml(text)
    dd = lambda c: c["model"]["params"]["first_stage_config"]["params"]["ddconfig"]
    assert dd(got)["ch_mult"] == [1, 2, 4, 4] and dd(want)["ch_mult"] == []
    dd(want)["ch_mult"] = [1, 2, 4, 4]
    assert got == want


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The port's and JAX's `create_model` on one tiny cldm_v15-format
    file, read by the fallback parsers."""
    path = str(tmp_path_factory.mktemp("cfg") / "cldm_tiny.yaml")
    with open(path, "w") as f:
        f.write(chip_smoke.cldm_v15_yaml(**TINY).replace("          - ", "            - "))
    with no_yaml():
        pipe = config.create_model(path, policy=fp32_policy(), device="cpu")
        jpipe = jconfig.create_model(path, policy=j_fp32_policy())
    return pipe, jpipe


def test_create_model_configs_match_jax(models):
    pipe, jpipe = models
    for mine, theirs in ((pipe.unet.config, jpipe.unet.config),
                         (pipe.controlnet.config, jpipe.controlnet.config),
                         (pipe.vae.config, jpipe.vae.config),
                         (pipe.text_encoder.config, jpipe.text_encoder.config)):
        names = [f.name for f in dataclasses.fields(mine)]
        assert {n: getattr(mine, n) for n in names} == {n: getattr(theirs, n) for n in names}
    assert pipe.unet.config.model_channels == 32 and pipe.vae.config.ch_mult == (1, 1, 2, 2)
    assert pipe.controlnet.input_hint_block.conv_0.in_channels == jpipe.controlnet.hint_channels
    for f in dataclasses.fields(pipe.schedule):
        np.testing.assert_array_equal(getattr(pipe.schedule, f.name),
                                      np.asarray(getattr(jpipe.schedule, f.name)), f.name)
    assert all(p.dtype == torch.float32 for p in pipe.unet.parameters())
    assert pipe.device == torch.device("cpu")


def test_create_model_eps_matches_jax(models):
    """ControlNet + UNet of the YAML's pipeline, with JAX's tree carried
    across, give JAX's ε (fp32)."""
    pipe, jpipe = models
    b, lat, img, ctx_len = 2, 8, 64, 7
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    x, ctx = f(b, lat, lat, 4), f(b, ctx_len, TINY["context_dim"])
    pair, query, t = f(b, img, img, 6), f(b, img, img, 3), np.array([999, 31], np.int32)
    key = jax.random.PRNGKey(0)
    shapes = {
        "unet": jax.eval_shape(jpipe.unet.init, key, jnp.zeros((1, lat, lat, 4)),
                               jnp.zeros((1,), jnp.int32), jnp.zeros((1, ctx_len, 64))),
        "controlnet": jax.eval_shape(
            jpipe.controlnet.init, key, jnp.zeros((1, lat, lat, 4)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, img, img, 6)), jnp.zeros((1, img, img, 3)),
            jnp.zeros((1, ctx_len, 64)))}
    tree = {name: randomize(s, 20 + i) for i, (name, s) in enumerate(sorted(shapes.items()))}
    control = jpipe.controlnet.apply(tree["controlnet"], *map(jnp.asarray, (x, t, pair, query,
                                                                          ctx)))
    ref = jpipe.unet.apply(tree["unet"], jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                           control=control)
    load_jax_params(pipe, tree, namespaces=("unet", "controlnet"))
    with torch.no_grad():
        tt, c = torch.from_numpy(t), torch.from_numpy(ctx)
        got = pipe.unet(nchw(x), tt, c, control=pipe.controlnet(nchw(x), tt, nchw(pair),
                                                                nchw(query), c))
    assert np.abs(np.asarray(ref)).max() > 0.1
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=ATOL)


def test_create_model_defaults_to_the_card():
    assert inspect.signature(config.create_model).parameters["device"].default == "cuda"
