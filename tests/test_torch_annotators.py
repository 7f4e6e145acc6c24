"""PyTorch port, the image utilities, HED and UniFormer-S/UperNet against the
JAX package: each module and each whole net at fp32 on numpy inputs from a
seed with the same weights (carried over by the weight bridge), UniFormer's
SABlock on the packed attention route (N >= 512) and under int8, UperNet on
inputs where its pyramid pools downsample, the palette and its render, the
importers bit for bit against the JAX importers on `.pth` files the tests
write, `nms_edges` against JAX away from the borders and against OpenCV
everywhere, and `resize_image` against `jax.image.resize`. JAX runs at fp32
with 'highest' matmul precision (tests/conftest.py)."""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prompt_diffusion_tpu.annotators import hed as jh
from prompt_diffusion_tpu.annotators import uniformer as ju
from prompt_diffusion_tpu.annotators import util as jutil
from prompt_diffusion_tpu.utils.dtypes import DTypePolicy as JPolicy
from prompt_diffusion_tpu.utils.dtypes import fp32_policy as j_fp32_policy
from prompt_diffusion_tpu_torch.annotators import hed as ph
from prompt_diffusion_tpu_torch.annotators import uniformer as pu
from prompt_diffusion_tpu_torch.annotators import util as putil
from prompt_diffusion_tpu_torch.tools.jax_bridge import (
    jax_params_from_module,
    load_jax_model,
    state_dict_from_jax,
)
from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy, fp32_policy
from tests.torch_port_util import nchw, nhwc, randomize

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
MODULE_RTOL = 1e-5  # of the largest reference value, per module
MODEL_RTOL = 1e-4   # of the largest reference value, whole nets
TINY = dict(embed_dims=(8, 16, 32, 64), depths=(1, 1, 2, 1), head_dim=16,
            decode_channels=32)  # tests/test_uniformer.py
PORT_ROOT = os.path.join(os.path.dirname(os.path.dirname(__file__)), "prompt_diffusion_tpu_torch")


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _bn_safe(params):
    """Running variances drawn N(0, 0.5) made positive (|v| + 0.5)."""
    def fix(path, leaf):
        return np.abs(leaf) + 0.5 if getattr(path[-1], "key", "") == "var" else leaf
    return jax.tree_util.tree_map_with_path(fix, params)


def _jnp(a):
    return [jnp.asarray(t) for t in a] if isinstance(a, list) else jnp.asarray(a)


def _params(jmodule, *args, seed=1):
    shapes = jax.eval_shape(jmodule.init, KEY, *(_jnp(a) for a in args))
    return _bn_safe(randomize(shapes, seed))


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


def _bit_equal(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:8]
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


# ---- util ------------------------------------------------------------------


@pytest.mark.parametrize("channels", [None, 1, 3, 4])
def test_hwc3_matches_jax(channels):
    rng = np.random.default_rng(0)
    shape = (9, 7) if channels is None else (9, 7, channels)
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(putil.hwc3(x), jutil.hwc3(x))


# (shape, resolution): upscaled (lanczos3), downscaled (antialiased linear),
# one side kept, and one side enlarged while the other shrinks (lanczos3
# with the kernel stretched on the shrunk side); at most DIFFER_SHARE of the
# values differ, by one level (float32 sin and summation order)
DIFFER_SHARE = 1e-4


@pytest.mark.parametrize("shape,res", [((100, 75, 3), 256), ((97, 61, 3), 512),
                                       ((300, 400, 3), 128), ((64, 96, 3), 64),
                                       ((130, 200, 3), 192), ((70, 33), 64)])
def test_resize_image_matches_jax(shape, res):
    img = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    got, want = putil.resize_image(img, res), jutil.resize_image(img, res)
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= DIFFER_SHARE, (diff.max(), (diff > 0).sum())


@pytest.mark.parametrize("n_in,n_out,method", [(10, 25, "lanczos3"), (25, 10, "linear"),
                                               (7, 3, "linear"), (6, 13, "linear"),
                                               (40, 17, "lanczos3")])
def test_resize_weights_match_jax(n_in, n_out, method):
    from jax._src.image import scale as jscale

    kernel = {"linear": jscale._fill_triangle_kernel,
              "lanczos3": lambda x: jscale._fill_lanczos_kernel(3, x)}[method]
    ref = np.asarray(jscale.compute_weight_mat(n_in, n_out, n_out / n_in, 0.0, kernel, True)).T
    np.testing.assert_allclose(putil.resize_weights(n_in, n_out, method), ref, rtol=0, atol=1e-7)


@pytest.mark.parametrize("size,method", [((20, 30), "linear"), ((5, 40), "linear"),
                                         ((16, 12), "lanczos3")])
def test_batched_resize_matches_jax(size, method):
    x = np.random.default_rng(2).uniform(0, 255, (2, 12, 16, 3)).astype(np.float32)
    got = putil.batched_resize(torch.from_numpy(x), *size, method=method).numpy()
    _assert_close(got, jutil.batched_resize(jnp.asarray(x), *size, method=method), MODULE_RTOL)


def test_normalize_matches_jax():
    x = np.random.default_rng(3).integers(0, 256, (2, 4, 4, 3), dtype=np.uint8)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(putil.normalize_m11(t).numpy(), jutil.normalize_m11(x))
    np.testing.assert_array_equal(putil.normalize_01(t).numpy(), jutil.normalize_01(x))


def test_no_port_module_imports_cv2():
    """The card has no OpenCV: no module of the port imports cv2 (parsed,
    not imported, so a lazy import inside a function counts too)."""
    offenders = []
    for root, _, files in os.walk(PORT_ROOT):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            tree = ast.parse(open(path).read(), path)
            for node in ast.walk(tree):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                        [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                if any(m.split(".")[0] == "cv2" for m in mods):
                    offenders.append(os.path.relpath(path, PORT_ROOT))
    assert not offenders, offenders


# ---- HED ---------------------------------------------------------------------


def test_hed_combine_matches_flax():
    rng = np.random.default_rng(4)
    scores = [_normal(rng, (2, 8, 6, 1)) for _ in range(5)]
    jmod = jh._Combine()
    params = _params(jmod, scores)
    port = _port(ph._Combine(5), params)
    got = port([nchw(s) for s in scores]).detach().numpy()
    _assert_close(got, jmod.apply(params, [jnp.asarray(s) for s in scores]), MODULE_RTOL)


@pytest.fixture(scope="module")
def hed_pair():
    """The Flax HED and the port's at fp32 with one set of random weights."""
    x = np.zeros((1, 32, 32, 3), np.float32)
    jmod = jh.HEDNetwork(policy=j_fp32_policy())
    params = _params(jmod, x, seed=5)
    return jmod, params, _port(ph.HEDNetwork(fp32_policy()), params)


@pytest.mark.parametrize("size", [(32, 32), (48, 40)])
def test_hed_matches_jax(hed_pair, size):
    jmod, params, port = hed_pair
    x = np.random.default_rng(6).uniform(0, 255, (2, *size, 3)).astype(np.float32)
    with torch.no_grad():
        got = port(nchw(x)).numpy()
    ref = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(x)))
    assert got.shape == (2, *size) and ((got >= 0) & (got <= 1)).all()
    _assert_close(got, ref, MODEL_RTOL)


def _hed_reference_file(path, port, prefix="module"):
    """The network-bsds500 key scheme (`module...` names) of the port's
    weights, written with torch.save."""
    sd = {k.replace("net", prefix, 1): v for k, v in ph.export_hed_checkpoint(port).items()}
    torch.save(sd, path)
    return sd


@pytest.mark.parametrize("prefix", ["module", "net"])
def test_import_hed_matches_jax(hed_pair, tmp_path, prefix):
    """The importer against the JAX importer through the bridge, bit for
    bit, on a file with the reference's `module` names (and with `net`
    names); the first conv's input channels reversed, so that the file's
    BGR net takes RGB; export and import are inverse."""
    _, _, port = hed_pair
    path = str(tmp_path / "hed.pth")
    sd = _hed_reference_file(path, port, prefix)
    got = ph.import_hed_checkpoint(path)
    _bit_equal(got, state_dict_from_jax(jh.import_hed_checkpoint(path)))
    _bit_equal(got, port.state_dict())
    assert torch.equal(got["vgg_0_conv_0.weight"],
                       sd[f"{prefix}VggOne.0.weight"].flip(1))
    model = ph.create_hed(path, device="cpu", policy=fp32_policy())
    assert not model.training and not any(p.requires_grad for p in model.parameters())


def test_hed_bridge_round_trip(hed_pair):
    """jax_params_from_module gives back the Flax tree (the combine's kernel
    of shape (1, 1, 5, 1) included)."""
    _, params, port = hed_pair
    back = jax_params_from_module(port)
    flat = lambda t: {"/".join(str(getattr(k, "key", k)) for k in p): v
                      for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    want, got = flat(params), flat(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _edge_map(seed, shape=(2, 40, 52)):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:shape[1], :shape[2]]
    base = 255.0 * ((np.hypot(yy - 18, xx - 25) < 12) ^ (xx > 40))
    return np.clip(base + rng.normal(0, 30, shape), 0, 255).astype(np.float32)


@pytest.mark.parametrize("sigma,threshold", [(2.0, 40.0), (1.0, 100.0), (0.3, 60.0)])
def test_nms_edges_interior_matches_jax(sigma, threshold):
    """Away from the borders (the blur's radius plus the line maxima's one
    pixel) the port's map is the JAX package's; at the borders the two
    differ by design (reflected blur and ignored out-of-image taps against
    JAX's zero padding and wrap-around)."""
    x = _edge_map(7)
    got = ph.nms_edges(torch.from_numpy(x), threshold, sigma).numpy()
    want = np.asarray(jh.nms_edges(jnp.asarray(x), threshold, sigma))
    m = max(1, int(3 * sigma)) + 1
    np.testing.assert_array_equal(got[:, m:-m, m:-m], want[:, m:-m, m:-m])
    assert set(np.unique(got)) <= {0.0, 255.0} and got.any()


@pytest.mark.parametrize("sigma", [2.0, 1.0])
def test_nms_edges_borders_follow_opencv(sigma):
    """The reference's nms on the JAX package's kernel: cv2.filter2D with
    BORDER_REFLECT_101 and cv2.dilate with each line element, everywhere."""
    cv2 = pytest.importorskip("cv2")
    x = _edge_map(8)
    got = ph.nms_edges(torch.from_numpy(x), 50.0, sigma).numpy()
    k2 = ph._gaussian_kernel(sigma)
    for img, g in zip(x, got):
        blurred = cv2.filter2D(img, -1, k2, borderType=cv2.BORDER_REFLECT_101)
        y = np.zeros_like(blurred)
        for taps in ph._LINES:
            se = np.zeros((3, 3), np.uint8)
            for dy, dx in taps:
                se[dy, dx] = 1
            np.putmask(y, cv2.dilate(blurred, kernel=se) == blurred, blurred)
        want = np.where(y > 50.0, 255.0, 0.0)
        # the blur's sums in another order can move a value across the
        # threshold or a tie: at most 0.2% of the pixels
        assert (g != want).mean() <= 2e-3, (g != want).sum()


# ---- UniFormer ------------------------------------------------------------------


def test_inference_bn_matches_flax():
    x = _normal(np.random.default_rng(9), (2, 5, 6, 8))
    jmod = ju.InferenceBN()
    params = _params(jmod, x)
    port = _port(pu.InferenceBN(8), params)
    assert {"mean", "var"} <= {n for n, _ in port.named_buffers()}
    _assert_close(nhwc(port(nchw(x)).detach()), jmod.apply(params, jnp.asarray(x)), MODULE_RTOL)


def test_cblock_matches_flax():
    x = _normal(np.random.default_rng(10), (2, 9, 7, 16))
    jmod = ju.CBlock(16, j_fp32_policy())
    params = _params(jmod, x)
    port = _port(pu.CBlock(16, fp32_policy()), params)
    with torch.no_grad():
        got = nhwc(port(nchw(x)))
    _assert_close(got, jmod.apply(params, jnp.asarray(x)), MODULE_RTOL)


# 8 x 6 = 48 tokens: the plain attention; 32 x 24 = 768: the packed route
# (K1's plain version on the CPU), as stage 3 at 512² takes it
@pytest.mark.parametrize("hw", [(8, 6), (32, 24)])
def test_sablock_matches_flax(hw):
    x = _normal(np.random.default_rng(11), (2, *hw, 32))
    jmod = ju.SABlock(32, 2, j_fp32_policy())
    params = _params(jmod, x)
    port = _port(pu.SABlock(32, 2, fp32_policy()), params)
    with torch.no_grad():
        got = nhwc(port(nchw(x).contiguous(memory_format=torch.channels_last)))
    _assert_close(got, jmod.apply(params, jnp.asarray(x)), MODULE_RTOL)


def test_sablock_takes_the_packed_route_at_512_tokens(monkeypatch):
    """At N >= 512 tokens the block's attention goes through
    `flash_attention_packed` (K1 on the card), below it does not."""
    from prompt_diffusion_tpu_torch.annotators import midas as pm

    calls = []
    real = pm.flash_attention_packed
    monkeypatch.setattr(pm, "flash_attention_packed",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    blk = pu.SABlock(32, 2, fp32_policy()).eval()
    with torch.no_grad():
        blk(torch.randn(1, 32, 16, 31))  # 496 tokens
        assert calls == []
        blk(torch.randn(1, 32, 16, 32))  # 512 tokens
    assert calls == [(1, 512, 32)]


def test_int8_sablock_matches_jax():
    """The int8 SABlock (fp32 compute) on the JAX block's input: relative L2
    from JAX int8 at most a fifth of JAX int8's own distance from JAX fp32
    (the bound of the int8 ViT block's test)."""
    rel = lambda a, b: np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64)) \
        / np.linalg.norm(np.asarray(b, np.float64))
    x = _normal(np.random.default_rng(12), (2, 8, 6, 32))
    jint8 = ju.SABlock(32, 2, JPolicy(compute_dtype=jnp.float32, quant="int8"))
    params = _params(jint8, x, seed=13)
    ref8 = jint8.apply(params, jnp.asarray(x))
    ref32 = ju.SABlock(32, 2, j_fp32_policy()).apply(params, jnp.asarray(x))
    port = _port(pu.SABlock(32, 2, DTypePolicy(compute_dtype=torch.float32, quant="int8")),
                 params)
    with torch.no_grad():
        got = nhwc(port(nchw(x)))
    quant_err, port_err = rel(ref8, ref32), rel(got, ref8)
    assert quant_err > 1e-3, quant_err
    assert port_err <= quant_err / 5, (port_err, quant_err)


@pytest.mark.parametrize("kernel", [1, 3])
def test_conv_module_matches_flax(kernel):
    x = _normal(np.random.default_rng(14), (2, 6, 5, 8))
    jmod = ju.ConvModule(12, kernel, j_fp32_policy())
    params = _params(jmod, x)
    port = _port(pu.ConvModule(8, 12, kernel, fp32_policy()), params)
    with torch.no_grad():
        got = nhwc(port(nchw(x)))
    _assert_close(got, jmod.apply(params, jnp.asarray(x)), MODULE_RTOL)


@pytest.mark.parametrize("hw,scale", [((7, 9), 3), ((2, 2), 6), ((16, 16), 6), ((5, 3), 2)])
def test_adaptive_avg_pool_matches_jax(hw, scale):
    import torch.nn.functional as F

    x = _normal(np.random.default_rng(15), (2, *hw, 4))
    got = nhwc(F.adaptive_avg_pool2d(nchw(x), scale))
    _assert_close(got, ju._adaptive_avg_pool(jnp.asarray(x), scale), MODULE_RTOL)


def _feats(rng, base):
    """The backbone's 4 stage maps at strides 4-32 of a base x base input."""
    return [_normal(rng, (2, base // s, base // s, d))
            for s, d in zip((4, 8, 16, 32), TINY["embed_dims"])]


# the last stage at 2² and 3² (64² and 96² inputs): the 3- and 6-pools
# upsampled to it are downsampled; at 8² (256²) every pool upsamples
@pytest.mark.parametrize("base", [64, 96, 256])
def test_uper_head_matches_flax(base):
    feats = _feats(np.random.default_rng(16), base)
    cfg = ju.UniFormerConfig(**TINY)
    jmod = ju.UPerHead(cfg, j_fp32_policy())
    params = _params(jmod, feats)
    port = _port(pu.UPerHead(pu.UniFormerConfig(**TINY), fp32_policy()), params)
    with torch.no_grad():
        got = nhwc(port([nchw(f) for f in feats]))
    _assert_close(got, jmod.apply(params, [jnp.asarray(f) for f in feats]), MODEL_RTOL)


def test_backbone_matches_flax():
    x = _normal(np.random.default_rng(17), (2, 64, 64, 3))
    jmod = ju.UniFormerBackbone(ju.UniFormerConfig(**TINY), j_fp32_policy())
    params = _params(jmod, x)
    port = _port(pu.UniFormerBackbone(pu.UniFormerConfig(**TINY), fp32_policy()), params)
    with torch.no_grad():
        got = port(nchw(x).contiguous(memory_format=torch.channels_last))
    for g, r in zip(got, jmod.apply(params, jnp.asarray(x))):
        _assert_close(nhwc(g), r, MODEL_RTOL)


@pytest.fixture(scope="module")
def seg_pair():
    x = np.zeros((1, 64, 64, 3), np.float32)
    jmod = ju.UniFormerSeg(ju.UniFormerConfig(**TINY), j_fp32_policy())
    params = _params(jmod, x, seed=18)
    return jmod, params, _port(pu.UniFormerSeg(pu.UniFormerConfig(**TINY), fp32_policy()), params)


# 64² and 96²: the last stage at 2² and 3², its pools downsampled; 80²: the
# patch embeds' SAME padding (80 / 32 is not whole)
@pytest.mark.parametrize("size", [64, 96, 80])
def test_uniformer_seg_matches_jax(seg_pair, size):
    """Whole logits at the input size (the port upsamples them in fp32, as
    the JAX net under the fp32 policy does), and the argmax classes."""
    jmod, params, port = seg_pair
    x = np.random.default_rng(19).uniform(0, 255, (2, size, size, 3)).astype(np.float32)
    with torch.no_grad():
        got = port(nchw(x))
    ref = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(x)))
    assert got.dtype == torch.float32
    _assert_close(nhwc(got), ref, MODEL_RTOL)
    same = (got.argmax(dim=1).numpy() == ref.argmax(-1)).mean()
    assert same >= 0.999, same


def test_seg_head_logits_are_the_quarter_size_logits(seg_pair):
    _, _, port = seg_pair
    x = torch.from_numpy(np.random.default_rng(20).uniform(0, 255, (1, 3, 64, 64))
                         .astype(np.float32))
    with torch.no_grad():
        head = port.head_logits(x)
        full = port(x)
    assert head.shape == (1, 150, 16, 16) and head.dtype == torch.float32
    torch.testing.assert_close(full, torch.nn.functional.interpolate(
        head, size=(64, 64), mode="bilinear", align_corners=False), rtol=0, atol=0)


def test_palette_and_colorize_match_jax():
    np.testing.assert_array_equal(pu.ade_palette(), ju.ade_palette())
    cm = np.random.default_rng(21).integers(0, 150, (2, 5, 7))
    want = ju.colorize_segmentation(cm)
    np.testing.assert_array_equal(pu.colorize_segmentation(cm), want)
    np.testing.assert_array_equal(pu.colorize_segmentation(torch.from_numpy(cm)), want)
    assert pu.IMAGENET_MEAN == ju.IMAGENET_MEAN and pu.IMAGENET_STD == ju.IMAGENET_STD


def _mmseg_file(path, port, bare=False):
    """upernet_global_small's mmseg key scheme of the port's weights, with
    the BN counters mmseg also saves, written with torch.save."""
    sd = pu.export_uniformer_checkpoint(port)["state_dict"]
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    torch.save(sd if bare else {"state_dict": sd, "meta": {}}, path)
    return sd


@pytest.mark.parametrize("bare", [False, True])
def test_import_uniformer_matches_jax(seg_pair, tmp_path, bare):
    """The port's importers against the JAX importers through the bridge,
    bit for bit: the whole checkpoint (a `state_dict` entry or the bare
    dict) and the backbone slice; export and import are inverse."""
    _, _, port = seg_pair
    path = str(tmp_path / "upernet.pth")
    sd = _mmseg_file(path, port, bare)
    jcfg, pcfg = ju.UniFormerConfig(**TINY), pu.UniFormerConfig(**TINY)
    got = pu.import_uniformer_checkpoint(path, pcfg)
    _bit_equal(got, state_dict_from_jax(ju.import_uniformer_checkpoint(path, jcfg)))
    _bit_equal(got, port.state_dict())
    np_sd = {k: v.numpy() for k, v in sd.items()}
    _bit_equal(pu.import_uniformer_backbone(sd, pcfg),
               state_dict_from_jax({"params": ju.import_uniformer_backbone(np_sd, jcfg)}))
    model = pu.create_uniformer(path, device="cpu", policy=fp32_policy(), config=pcfg)
    assert not model.training


def test_seg_launch_sites_match_chip_smoke(monkeypatch):
    """UniFormer-S at full width, batch 16 at 512², on the meta device: the
    packed attention (K1 on the card) and the LayerNorm kernel (K4) are
    called as often as chip_smoke.py's SEG_PER_FORWARD says, and int8 puts
    K9 and K6 at the same sites (8 blocks at N >= 512, every SABlock
    pre-LN)."""
    import chip_smoke
    from prompt_diffusion_tpu_torch.annotators import midas as pm
    from prompt_diffusion_tpu_torch.ops import fused_layer_norm as fln
    from prompt_diffusion_tpu_torch.utils.dtypes import default_policy

    calls = {"flash_attention_packed": [], "fused_layer_norm": []}
    monkeypatch.setattr(pm, "flash_attention_packed", lambda q, k, v, h, **kw: calls[
        "flash_attention_packed"].append((tuple(q.shape), h)) or torch.empty_like(q))
    monkeypatch.setattr(fln, "fused_layer_norm", lambda x, w, b, eps: calls[
        "fused_layer_norm"].append((tuple(x.shape), eps)) or torch.empty_like(x))
    with torch.device("meta"):
        model = pu.UniFormerSeg(policy=default_policy())
        model(torch.empty(16, 3, 512, 512))
    per = chip_smoke.SEG_PER_FORWARD
    assert len(calls["flash_attention_packed"]) == per["seg"]["flash_attention_packed"] == 8
    assert set(calls["flash_attention_packed"]) == {((16, 1024, 320), 5)}
    assert len(calls["fused_layer_norm"]) == per["seg"]["fused_layer_norm"] == 22
    assert sorted(set(calls["fused_layer_norm"])) == [((16, 256, 512), 1e-6),
                                                      ((16, 1024, 320), 1e-6)]
    int8 = per["seg_int8"]
    assert (int8["flash_attention_packed_int8"], int8["quant_k_int8"],
            int8["fused_layer_norm_quant"]) == (8, 8, 22)
    assert int8["flash_attention_packed"] == int8["fused_layer_norm"] == 0
