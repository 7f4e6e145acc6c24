"""PyTorch port, the FID InceptionV3: features against the JAX extractor
with a random tree of JAX's layout carried across by `tools/jax_bridge.py`
(the bounds of tests/test_inception_parity.py: 1e-3 at 299², 2e-3 through
the up- and down-sampling resize), the bridge's inverse, the pt_inception
`.pth` importer against the JAX importer on a pytorch-fid-layout file
written here (with its `fc.*` and `num_batches_tracked` keys), the refusal
of a file with a key missing, the He-normal random init, and TF32 off for
the forward only."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prompt_diffusion_tpu.evaluation.inception import InceptionV3 as JInceptionV3
from prompt_diffusion_tpu.evaluation.inception import load_inception_params as j_load
from prompt_diffusion_tpu_torch.evaluation.inception import (
    InceptionV3,
    create_inception,
    load_inception_params,
    tf32_convolutions,
)
from prompt_diffusion_tpu_torch.tools.jax_bridge import (
    jax_params_from_module,
    load_jax_model,
    state_dict_from_jax,
)
from tests.test_inception_parity import PtInceptionFixture, _randomize

torch.set_num_threads(2)


def _randomize_tree(shapes, seed):
    """A tree of JAX's layout, every leaf drawn with numpy: kernels He-scaled
    (so the features stay O(1) through the 94 ReLU layers), BN affines and
    running statistics around their identity values."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = getattr(path[-1], "key", ""), leaf.shape
        if name == "kernel":
            v = rng.normal(0.0, (2.0 / np.prod(shape[:-1])) ** 0.5, shape)
        elif name == "bn_scale":
            v = 1.0 + rng.normal(0.0, 0.1, shape)
        elif name == "bn_var":
            v = 0.5 + rng.uniform(0.0, 1.0, shape)
        else:
            v = rng.normal(0.0, 0.1, shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def pair():
    shapes = jax.eval_shape(JInceptionV3().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 299, 299, 3)))
    tree = _randomize_tree(shapes, 0)
    port = create_inception(device="cpu")
    load_jax_model(port, tree)
    return tree, port


@pytest.mark.parametrize("shape,bound", [((2, 299, 299, 3), 1e-3), ((1, 75, 75, 3), 2e-3),
                                         ((1, 384, 384, 3), 2e-3)],
                         ids=["299", "upsample", "downsample"])
def test_features_match_jax(pair, shape, bound):
    """Images in [0, 1] at 299², below it (bilinear upsample inside) and
    above it (downsample without antialiasing, as pytorch-fid)."""
    tree, port = pair
    x = np.random.default_rng(sum(shape)).uniform(0, 1, shape).astype(np.float32)
    ref = np.asarray(jax.jit(JInceptionV3().apply)(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (shape[0], 2048) and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=bound, rtol=bound)


def test_bridge_inverse_gives_the_tree_back(pair):
    """jax_params_from_module folds the `bn` submodules back into the
    `bn_*` leaves: the same tree, leaf for leaf."""
    tree, port = pair
    back = jax_params_from_module(port)
    want = jax.tree_util.tree_map(np.asarray, tree)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    """A pytorch-fid-layout file: the fixture network's state dict (torch
    BatchNorm2d, so `num_batches_tracked` too) and the 1008-class `fc`."""
    fix = PtInceptionFixture().eval()
    _randomize(fix, seed=3)
    sd = dict(fix.state_dict())
    g = torch.Generator().manual_seed(4)
    sd["fc.weight"], sd["fc.bias"] = torch.randn(1008, 2048, generator=g), torch.zeros(1008)
    path = str(tmp_path_factory.mktemp("incep") / "pt_inception_random.pth")
    torch.save(sd, path)
    return path, sd


def test_pth_importer_matches_jax_importer(pth):
    path, sd = pth
    got = load_inception_params(path)
    want = state_dict_from_jax(j_load(path))
    assert set(got) == set(want)
    assert not any(k.startswith("fc.") or "num_batches_tracked" in k for k in got)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    model = create_inception(path, device="cpu")
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, got[k], rtol=0, atol=0)


def test_pth_importer_refuses_a_missing_key(pth, tmp_path):
    path, sd = pth
    sd = dict(sd)
    del sd["Mixed_6c.branch7x7dbl_3.bn.running_var"]
    bad = str(tmp_path / "bad.pth")
    torch.save(sd, bad)
    with pytest.raises(KeyError, match="Mixed_6c.branch7x7dbl_3.bn.running_var"):
        load_inception_params(bad)


def test_random_init_is_he_normal_and_seeded():
    """Kernels N(0, 2 / fan_in) truncated at ±2 standard deviations of the
    underlying normal, from the seed; BN at its identity values; the
    features O(1) and finite."""
    a, b, c = (create_inception(seed=s, device="cpu") for s in (0, 0, 1))
    w = a.Mixed_7c.branch3x3dbl_2.conv.weight
    for k, v in a.state_dict().items():
        torch.testing.assert_close(v, b.state_dict()[k], rtol=0, atol=0)
    assert not torch.equal(w, c.Mixed_7c.branch3x3dbl_2.conv.weight)
    fan_in = w[0].numel()
    assert w.std().item() == pytest.approx((2.0 / fan_in) ** 0.5, rel=0.02)
    assert w.abs().max().item() <= 2.0 * (2.0 / fan_in) ** 0.5 / 0.87962566103423978 + 1e-6
    assert torch.equal(a.Mixed_5b.branch1x1.bn.running_var, torch.ones(64))
    with torch.no_grad():
        f = a(torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0)))
    assert torch.isfinite(f).all() and 0.01 < f.abs().mean().item() < 100


def test_forward_turns_tf32_off_for_its_convs_only(pair):
    """The convolutions run with cuDNN's TF32 off (on inside
    `tf32_convolutions()`); the caller's setting is back after the call."""
    _, port = pair
    seen = []
    hook = port.Mixed_6b.branch1x1.conv.register_forward_hook(
        lambda *_: seen.append(torch.backends.cudnn.allow_tf32))
    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        with torch.no_grad():
            port(torch.rand(1, 64, 64, 3))
            assert torch.backends.cudnn.allow_tf32 is True
            torch.backends.cudnn.allow_tf32 = False
            with tf32_convolutions():
                port(torch.rand(1, 64, 64, 3))
            assert torch.backends.cudnn.allow_tf32 is False
            port(torch.rand(1, 64, 64, 3))
    finally:
        torch.backends.cudnn.allow_tf32 = saved
        hook.remove()
    assert seen == [False, True, False]


def test_create_inception_defaults_to_the_card():
    assert inspect.signature(create_inception).parameters["device"].default == "cuda"
    assert isinstance(InceptionV3(), torch.nn.Module)
