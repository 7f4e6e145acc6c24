"""PyTorch port, MiDaS DPT annotator and canny: each module against its Flax
counterpart on the same weights (carried over by the weight bridge), the
tiny DPT-Hybrid and DPT-Large at two input sizes (the position grid up- and
downsampled), the int8 ViT block, both checkpoint importers against the JAX
importers, and canny against the JAX canny. Inputs come from numpy seeds;
JAX runs at fp32 with 'highest' matmul precision (tests/conftest.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from prompt_diffusion_tpu.annotators.canny import canny as j_canny
from prompt_diffusion_tpu.annotators import midas as jm
from prompt_diffusion_tpu.utils.dtypes import DTypePolicy as JPolicy
from prompt_diffusion_tpu.utils.dtypes import fp32_policy as j_fp32_policy
from prompt_diffusion_tpu_torch.annotators import midas as pm
from prompt_diffusion_tpu_torch.annotators.canny import canny
from prompt_diffusion_tpu_torch.tools.jax_bridge import load_jax_model, state_dict_from_jax
from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy, fp32_policy
from tests.torch_port_util import nchw, nhwc, randomize

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
MODULE_RTOL = 1e-5  # of the largest reference value, per module
MODEL_RTOL = 1e-4   # of the largest reference value, whole models
TINY = dict(hidden_size=64, num_layers=4, num_heads=4, hooks=(0, 1, 2, 3),
            reassemble_dims=(32, 64, 64, 64), features=32, pos_grid=4)  # tests/test_midas.py
TINY_HYBRID = dict(hidden_size=64, num_layers=3, num_heads=4, hooks=(1, 2),
                   resnet_layers=(1, 1, 1), reassemble_dims=(256, 512, 64, 64), features=32,
                   pos_grid=3)


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _params(jmodule, *args, seed=1):
    return randomize(jax.eval_shape(jmodule.init, KEY, *(jnp.asarray(a) for a in args)), seed)


def _port(module, params):
    load_jax_model(module, params)
    return module.eval().requires_grad_(False)


def _assert_close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = np.abs(ref).max()
    assert scale > 0
    err = np.abs(got - ref).max()
    assert err <= rtol * scale, (err, scale)


# ---- modules -------------------------------------------------------------


@pytest.mark.parametrize("cin,cout,k,stride,hw", [
    (3, 16, 7, 2, 16),   # the stem: SAME pads 2 top/left, 3 bottom/right
    (8, 16, 3, 2, 9),    # stage 1-2's strided 3x3, odd input
    (8, 16, 3, 1, 8),
    (8, 16, 1, 2, 8),    # the strided downsample
])
def test_std_conv_matches_flax(cin, cout, k, stride, hw):
    x = _normal(np.random.default_rng(0), (2, hw, hw, cin))
    jmod = jm.StdConv(cout, (k, k), (stride, stride))
    params = _params(jmod, x)
    port = _port(pm.StdConv(cin, cout, k, stride), params)
    with torch.no_grad():
        got = nhwc(port(nchw(x)))
    _assert_close(got, jmod.apply(params, jnp.asarray(x)), MODULE_RTOL)


@pytest.mark.parametrize("hw", [16, 9])
def test_max_pool_same_matches_flax(hw):
    import flax.linen as fnn

    x = _normal(np.random.default_rng(1), (2, hw, hw, 8))
    ref = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME")
    np.testing.assert_array_equal(nhwc(pm.max_pool_same(nchw(x))), np.asarray(ref))


@pytest.mark.parametrize("act", [True, False])
def test_gn_relu_matches_flax(act):
    x = _normal(np.random.default_rng(2), (2, 8, 8, 64)) + 1.0
    jmod = jm.GNReLU(act=act)
    params = _params(jmod, x)
    port = _port(pm.GNReLU(64, act=act), params)
    got = nhwc(port(nchw(x)))
    _assert_close(got, jmod.apply(params, jnp.asarray(x)), MODULE_RTOL)
    assert (got >= 0).all() == act


@pytest.mark.parametrize("cin,cout,stride,down", [
    (64, 256, 1, True), (256, 256, 1, False), (256, 512, 2, True)])
def test_bottleneck_matches_flax(cin, cout, stride, down):
    x = _normal(np.random.default_rng(3), (2, 8, 8, cin))
    jmod = jm.Bottleneck(cout, stride=stride, has_downsample=down)
    params = _params(jmod, x)
    port = _port(pm.Bottleneck(cin, cout, stride, down), params)
    with torch.no_grad():
        got = nhwc(port(nchw(x)))
    _assert_close(got, jmod.apply(params, jnp.asarray(x)), MODULE_RTOL)


@pytest.mark.parametrize("n", [17, 520])  # 520 takes K1's route (its plain version here)
def test_vit_block_matches_flax(n):
    x = _normal(np.random.default_rng(4), (2, n, 64))
    jmod = jm.ViTBlock(jm.DPTConfig(hidden_size=64, num_heads=4), j_fp32_policy())
    params = _params(jmod, x)
    port = _port(pm.ViTBlock(pm.DPTConfig(hidden_size=64, num_heads=4), fp32_policy()), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    _assert_close(got, jmod.apply(params, jnp.asarray(x)), MODULE_RTOL)


def test_readout_matches_flax():
    rng = np.random.default_rng(5)
    tokens, cls = _normal(rng, (2, 16, 64)), _normal(rng, (2, 1, 64))
    jmod = jm._Readout(64, jnp.float32)
    params = _params(jmod, tokens, cls)
    port = _port(pm._Readout(64, torch.float32), params)
    with torch.no_grad():
        got = port(torch.from_numpy(tokens), torch.from_numpy(cls)).numpy()
    _assert_close(got, jmod.apply(params, jnp.asarray(tokens), jnp.asarray(cls)), MODULE_RTOL)


@pytest.mark.parametrize("skip", [True, False])
def test_feature_fusion_matches_flax(skip):
    rng = np.random.default_rng(6)
    xs = [_normal(rng, (2, 5, 7, 32)) for _ in range(1 + skip)]
    jmod = jm.FeatureFusion(32, j_fp32_policy())
    params = _params(jmod, *xs)
    port = _port(pm.FeatureFusion(32, fp32_policy(), skip=skip), params)
    with torch.no_grad():
        got = nhwc(port(*(nchw(a) for a in xs)))
    _assert_close(got, jmod.apply(params, *(jnp.asarray(a) for a in xs)), MODULE_RTOL)


def test_resize_is_upsample_only():
    from prompt_diffusion_tpu_torch.ops.resize import resize_bilinear

    x = torch.zeros(1, 2, 6, 6)
    assert resize_bilinear(x, 6, 6) is x
    with pytest.raises(ValueError, match="upsamples only"):
        resize_bilinear(x, 3, 12)


# ---- whole models ----------------------------------------------------------


def _models(kind):
    if kind == "hybrid":
        return (jm.DPTHybridDepth(jm.DPTHybridConfig(**TINY_HYBRID), j_fp32_policy()),
                pm.DPTHybridDepth(pm.DPTHybridConfig(**TINY_HYBRID), fp32_policy()))
    return (jm.DPTDepth(jm.DPTConfig(**TINY), j_fp32_policy()),
            pm.DPTDepth(pm.DPTConfig(**TINY), fp32_policy()))


# DPT-Hybrid's grid is 3² (64²: 4², upsampled; 32²: 2², downsampled);
# DPT-Large's 4² (96²: 6², upsampled; 32²: 2², downsampled)
@pytest.mark.parametrize("kind,size", [("hybrid", 64), ("hybrid", 32), ("large", 96),
                                       ("large", 32)])
def test_dpt_matches_jax(kind, size):
    x = np.random.default_rng(7).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    jmod, port = _models(kind)
    params = _params(jmod, x, seed=8)
    ref = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(port, params)(nchw(x)).numpy()
    assert got.shape == (2, size, size) and (got >= 0).all()
    _assert_close(got, ref, MODEL_RTOL)


def test_dpt_large_bridge_needs_the_flip():
    """The transposed convs' kernels go through the flip: without it the
    tiny DPT-Large's resample_0 disagrees with Flax's."""
    x = np.random.default_rng(9).uniform(-1, 1, (1, 4, 4, 32)).astype(np.float32)
    import flax.linen as fnn

    jmod = fnn.ConvTranspose(32, (4, 4), strides=(4, 4))
    params = _params(jmod, x)
    port = pm.ConvTranspose(32, 32, 4, stride=4)
    ref = np.asarray(jmod.apply(params, jnp.asarray(x)))
    load_jax_model(port, params)
    with torch.no_grad():
        _assert_close(nhwc(port(nchw(x))), ref, MODULE_RTOL)
        port.load_state_dict(state_dict_from_jax(params))  # no flip, plain HWIO rule
        assert np.abs(nhwc(port(nchw(x))) - ref).max() > 1e-2
    # the bridge's rule inverts the importers' torch -> Flax conversion
    w = np.random.default_rng(10).normal(size=(6, 5, 4, 4)).astype(np.float32)
    back = state_dict_from_jax({"params": {"m": {"kernel": pm.convt_kernel(w)}}}, {"m"})
    np.testing.assert_array_equal(back["m.weight"].numpy(), w)


def test_depth_to_normals_matches_jax():
    depth = np.random.default_rng(10).uniform(1, 10, (2, 16, 24)).astype(np.float32)
    ref = jm.depth_to_normals(jnp.asarray(depth))
    got = pm.depth_to_normals(torch.from_numpy(depth))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)
    assert got[1].shape == (2, 16, 24, 3)


def test_depth_normals_composition_matches_jax():
    """images [0, 255] -> x / 127.5 - 1 -> depth -> normals, x255, as the
    annotate entries run it, on the tiny DPT-Hybrid."""
    imgs = np.random.default_rng(11).uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    jmod, port = _models("hybrid")
    params = _params(jmod, imgs, seed=12)

    def jfn(x):
        d01, n = jm.depth_to_normals(jmod.apply(params, x / 127.5 - 1.0))
        return d01 * 255.0, n * 255.0

    ref = jax.jit(jfn)(jnp.asarray(imgs))
    _port(port, params)
    with torch.no_grad():
        d01, n = pm.depth_to_normals(port(nchw(imgs) / 127.5 - 1.0))
    for g, r in zip((d01 * 255.0, n * 255.0), ref):
        _assert_close(g.numpy(), r, MODEL_RTOL)


def test_int8_vit_block_matches_jax():
    """The int8 ViT block (fp32 compute) on the JAX block's input: relative
    L2 from JAX int8 at most a fifth of JAX int8's own distance from JAX
    fp32 (the bound of test_int8_block_matches_jax)."""
    rel = lambda a, b: np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64)) \
        / np.linalg.norm(np.asarray(b, np.float64))
    x = _normal(np.random.default_rng(13), (2, 17, 64))
    cfg = jm.DPTConfig(hidden_size=64, num_heads=4)
    jint8 = jm.ViTBlock(cfg, JPolicy(compute_dtype=jnp.float32, quant="int8"))
    params = _params(jint8, x, seed=14)
    ref8 = jint8.apply(params, jnp.asarray(x))
    ref32 = jm.ViTBlock(cfg, j_fp32_policy()).apply(params, jnp.asarray(x))
    port = _port(pm.ViTBlock(pm.DPTConfig(hidden_size=64, num_heads=4),
                             DTypePolicy(compute_dtype=torch.float32, quant="int8")), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    quant_err, port_err = rel(ref8, ref32), rel(got, ref8)
    assert quant_err > 1e-3, quant_err
    assert port_err <= quant_err / 5, (port_err, quant_err)


# ---- checkpoint importers --------------------------------------------------


def _official_large(cfg, rng):
    """A dpt_large-midas state dict (the official key scheme, torch
    layouts) at the size of `cfg`, random values."""
    d, f, dims = cfg["hidden_size"], cfg["features"], cfg["reassemble_dims"]
    r = lambda *s: torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32))
    sd = {"pretrained.model.patch_embed.proj.weight": r(d, 3, 16, 16),
          "pretrained.model.patch_embed.proj.bias": r(d),
          "pretrained.model.cls_token": r(1, 1, d),
          "pretrained.model.pos_embed": r(1, cfg["pos_grid"] ** 2 + 1, d)}
    for i in range(cfg["num_layers"]):
        t = f"pretrained.model.blocks.{i}"
        for name, o, n in (("norm1", d, None), ("norm2", d, None), ("attn.qkv", 3 * d, d),
                           ("attn.proj", d, d), ("mlp.fc1", 4 * d, d), ("mlp.fc2", d, 4 * d)):
            sd[f"{t}.{name}.weight"] = r(o) if n is None else r(o, n)
            sd[f"{t}.{name}.bias"] = r(o)
    for s in range(4):
        act = f"pretrained.act_postprocess{s + 1}"
        sd.update({f"{act}.0.project.0.weight": r(d, 2 * d), f"{act}.0.project.0.bias": r(d),
                   f"{act}.3.weight": r(dims[s], d, 1, 1), f"{act}.3.bias": r(dims[s])})
        shapes = {0: (dims[0], dims[0], 4, 4), 1: (dims[1], dims[1], 2, 2),
                  3: (dims[3], dims[3], 3, 3)}
        if s in shapes:
            sd[f"{act}.4.weight"], sd[f"{act}.4.bias"] = r(*shapes[s]), r(dims[s])
        sd[f"scratch.layer{s + 1}_rn.weight"] = r(f, dims[s], 3, 3)
    for rn in range(1, 5):
        t = f"scratch.refinenet{rn}"
        for unit in ("resConfUnit1", "resConfUnit2"):
            for conv in ("conv1", "conv2"):
                sd[f"{t}.{unit}.{conv}.weight"], sd[f"{t}.{unit}.{conv}.bias"] = r(f, f, 3, 3), r(f)
        sd[f"{t}.out_conv.weight"], sd[f"{t}.out_conv.bias"] = r(f, f, 1, 1), r(f)
    for i, (o, n, k) in ((0, (f // 2, f, 3)), (2, (32, f // 2, 3)), (4, (1, 32, 1))):
        sd[f"scratch.output_conv.{i}.weight"], sd[f"scratch.output_conv.{i}.bias"] = \
            r(o, n, k, k), r(o)
    return sd


def _assert_import_matches_jax(got, jax_params, model):
    """The port's state dict against the JAX importer's tree through the
    bridge, bit for bit. The JAX tree also carries refinenet4's
    resConfUnit1, which no forward runs and the port does not build."""
    convt = {n for n, m in model.named_modules() if isinstance(m, nn.ConvTranspose2d)}
    ref = state_dict_from_jax(jax_params, convt)
    extra = set(ref) - set(got)
    assert set(got) <= set(ref) and extra and all(k.startswith("refinenet4.rcu1.")
                                                  for k in extra), extra
    for k, v in got.items():
        assert torch.equal(v, ref[k]), k
    model.load_state_dict(got, strict=True)


def test_import_dpt_large_matches_jax(tmp_path):
    path = str(tmp_path / "dpt_large_tiny.pt")
    torch.save(_official_large(TINY, np.random.default_rng(15)), path)
    got = pm.import_dpt_checkpoint(path, pm.DPTConfig(**TINY))
    _assert_import_matches_jax(got, jm.import_dpt_checkpoint(path, jm.DPTConfig(**TINY)),
                               pm.DPTDepth(pm.DPTConfig(**TINY)))
    assert {"resample_0.weight", "resample_1.weight"} <= set(got)


def test_import_dpt_hybrid_matches_jax(tmp_path):
    """The official dpt_hybrid key scheme at full size (the JAX importer
    knows only that config), written by test_midas_hybrid's fixture."""
    from tests.test_midas_hybrid import DPTHybridFixture, _randomize

    fix = DPTHybridFixture()
    _randomize(fix)
    path = str(tmp_path / "dpt_hybrid_random.pt")
    torch.save(fix.state_dict(), path)
    del fix
    got = pm.import_dpt_checkpoint(path)
    assert "stem_conv.weight" in got
    model = pm.create_dpt(path, device="cpu", policy=fp32_policy())
    assert isinstance(model, pm.DPTHybridDepth)
    _assert_import_matches_jax(got, jm.import_dpt_checkpoint(path), model)


# ---- canny -----------------------------------------------------------------


def _canny_images(channels):
    rng = np.random.default_rng(16)
    yy, xx = np.mgrid[:96, :128]
    base = 255.0 * ((np.hypot(yy - 48, xx - 60) < 30) ^ (xx > 90))
    imgs = np.stack([base + rng.normal(0, 25, base.shape),
                     np.roll(base, 7, axis=1) * 0.6 + rng.normal(0, 40, base.shape)])
    imgs = np.clip(imgs, 0, 255).astype(np.float32)
    return imgs if channels == 1 else np.stack(
        [imgs, np.roll(imgs, 2, axis=1), 255 - imgs], axis=-1)


@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("blur", [False, True])
@pytest.mark.parametrize("channels", [1, 3])
def test_canny_matches_jax(channels, blur, l2):
    """Equal edge maps, up to pixels where an fp32 ulp (in the gray
    conversion or arctan2) moves a value across a threshold or sector
    boundary: at most 1e-4 of the pixels."""
    imgs = _canny_images(channels)
    ref = np.asarray(j_canny(jnp.asarray(imgs), l2_gradient=l2, blur=blur))
    got = canny(torch.from_numpy(imgs), l2_gradient=l2, blur=blur).numpy()
    assert got.shape == imgs.shape[:3] and set(np.unique(got)) <= {0.0, 255.0}
    assert 0.01 < (ref > 0).mean() < 0.5
    flips = (got != ref).sum()
    assert flips <= 1e-4 * got.size, flips
