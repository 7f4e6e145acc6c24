"""PyTorch port, M-LSD and OpenPose against the JAX package: the nets at fp32
on numpy inputs from a seed with the same weights (the weight bridge), the
importers bit for bit against the JAX importers on `.pth` files the tests
write, the numpy decodes equal, the detectors' renders against the JAX
detectors (which draw with OpenCV), and the port's own rasterisers and area
resize against OpenCV. JAX runs at fp32 with 'highest' matmul precision
(tests/conftest.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prompt_diffusion_tpu.annotators import mlsd as jm
from prompt_diffusion_tpu.annotators import openpose as jo
from prompt_diffusion_tpu.utils.dtypes import fp32_policy as j_fp32_policy
from prompt_diffusion_tpu_torch.annotators import mlsd as pm
from prompt_diffusion_tpu_torch.annotators import openpose as po
from prompt_diffusion_tpu_torch.tools.jax_bridge import state_dict_from_jax
from prompt_diffusion_tpu_torch.utils.dtypes import fp32_policy
from tests.test_torch_annotators import _assert_close, _bit_equal, _normal, _params, _port
from tests.torch_port_util import nchw, nhwc

torch.set_num_threads(2)

MODULE_RTOL = 1e-5  # of the largest reference value, per module
MODEL_RTOL = 1e-4   # of the largest reference value, whole nets


class _KeyEcho(dict):
    """A state dict whose value for a key is the key: an importer run on it
    returns {port key: reference key}."""

    def __getitem__(self, key):
        return key


def _reference_sd(importer, port_sd, monkeypatch):
    """The reference-format state dict of `port_sd` under `importer`'s key
    map (read back from the importer itself)."""
    monkeypatch.setattr(torch, "load", lambda *a, **k: _KeyEcho())
    names = importer("unused.pth")
    monkeypatch.undo()
    assert set(names) == set(port_sd), sorted(set(names) ^ set(port_sd))[:8]
    return {ref: port_sd[port] for port, ref in names.items()}


# ---- M-LSD -------------------------------------------------------------------


@pytest.mark.parametrize("cin,cout,stride,expand", [(16, 16, 1, 6), (16, 24, 2, 6),
                                                    (32, 16, 1, 1)])
def test_inverted_residual_matches_flax(cin, cout, stride, expand):
    x = _normal(np.random.default_rng(0), (2, 9, 8, cin))
    jmod = jm.InvertedResidual(cout, stride, expand, policy=j_fp32_policy())
    params = _params(jmod, x)
    port = _port(pm.InvertedResidual(cin, cout, stride, expand, fp32_policy()), params)
    with torch.no_grad():
        got = nhwc(port(nchw(x)))
    _assert_close(got, jmod.apply(params, jnp.asarray(x)), MODULE_RTOL)


@pytest.mark.parametrize("block", ["A", "A-no-upscale", "B", "C"])
def test_mlsd_blocks_match_flax(block):
    rng = np.random.default_rng(1)
    a, b = _normal(rng, (2, 8, 10, 24)), _normal(rng, (2, 4, 5, 32))
    if block.startswith("A"):
        up = block == "A"
        b = b if up else _normal(rng, (2, 8, 10, 32))
        jmod = jm.BlockA(64, 64, upscale=up, policy=j_fp32_policy())
        params = _params(jmod, a, b)
        port = _port(pm.BlockA(24, 32, 64, 64, upscale=up, policy=fp32_policy()), params)
        args, jargs = (nchw(a), nchw(b)), (jnp.asarray(a), jnp.asarray(b))
    else:
        jmod = (jm.BlockB if block == "B" else jm.BlockC)(16, policy=j_fp32_policy())
        params = _params(jmod, a)
        port = _port((pm.BlockB if block == "B" else pm.BlockC)(24, 16, fp32_policy()), params)
        args, jargs = (nchw(a),), (jnp.asarray(a),)
    with torch.no_grad():
        got = nhwc(port(*args))
    _assert_close(got, jmod.apply(params, *jargs), MODULE_RTOL)


@pytest.fixture(scope="module")
def mlsd_pair():
    x = np.zeros((1, 64, 64, 4), np.float32)
    jmod = jm.MLSDNet(policy=j_fp32_policy())
    params = _params(jmod, x, seed=2)
    return jmod, params, _port(pm.MLSDNet(fp32_policy()), params)


@pytest.mark.parametrize("size", [(64, 64), (96, 64)])
def test_mlsd_net_matches_jax(mlsd_pair, size):
    jmod, params, port = mlsd_pair
    x = np.random.default_rng(3).uniform(-1, 1, (2, *size, 4)).astype(np.float32)
    with torch.no_grad():
        got = port(nchw(x))
    assert got.shape == (2, 9, size[0] // 2, size[1] // 2) and got.dtype == torch.float32
    _assert_close(nhwc(got), jax.jit(jmod.apply)(params, jnp.asarray(x)), MODEL_RTOL)


def test_import_mlsd_matches_jax(mlsd_pair, tmp_path, monkeypatch):
    _, _, port = mlsd_pair
    ref = _reference_sd(pm.import_mlsd_checkpoint, port.state_dict(), monkeypatch)
    assert "backbone.features.0.0.weight" in ref and "block23.conv3.bias" in ref
    path = str(tmp_path / "mlsd_large_512_fp32.pth")
    torch.save(ref, path)
    got = pm.import_mlsd_checkpoint(path)
    _bit_equal(got, state_dict_from_jax(jm.import_mlsd_checkpoint(path)))
    _bit_equal(got, port.state_dict())


@pytest.mark.parametrize("seed", [4, 5])
def test_decode_lines_matches_jax(seed):
    rng = np.random.default_rng(seed)
    out = rng.normal(0, 3, (32, 40, 9)).astype(np.float32)
    out[..., 1:5] *= 8
    for thr_v, thr_d in ((0.1, 0.1), (0.5, 20.0)):
        np.testing.assert_array_equal(pm.decode_lines(out, thr_v, thr_d),
                                      jm.decode_lines(out, thr_v, thr_d))


def test_decode_lines_synthetic_segment():
    out = np.zeros((64, 64, 9), np.float32)
    out[..., 0] = -10.0
    out[30, 30, 0] = 10.0
    out[30, 30, 1:5] = [-15, 0, 15, 0]  # a 30 px horizontal segment
    np.testing.assert_allclose(pm.decode_lines(out, 0.1, 20.0), [[30, 60, 90, 60]])


@pytest.mark.parametrize("shape", [(1024, 1024, 3), (700, 900, 3), (300, 400, 3),
                                   (256, 256, 3), (600, 300, 3)])
def test_area_resize_matches_opencv(shape):
    """cv2.resize(INTER_AREA) to 512²: equal, except where OpenCV's
    fractional shrink sums in another order (at most 1e-5 of the values,
    by one level)."""
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(6).integers(0, 256, shape, dtype=np.uint8)
    want = cv2.resize(img, (512, 512), interpolation=cv2.INTER_AREA)
    diff = np.abs(pm.area_resize(img, 512, 512).astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-5, (diff.max(), (diff > 0).sum())


def test_draw_line_matches_opencv():
    """cv2.line of thickness 1, pixel for pixel, on segments inside the
    canvas, crossing it and outside it."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(7)
    for lo, hi in ((0, 120), (-60, 180)):
        for _ in range(150):
            p0, p1 = (tuple(int(v) for v in rng.integers(lo, hi, 2)) for _ in range(2))
            want = np.zeros((100, 130, 3), np.uint8)
            got = want.copy()
            cv2.line(want, p0, p1, (255, 255, 255), 1)
            pm.draw_line(got, p0, p1, (255, 255, 255))
            np.testing.assert_array_equal(got, want, err_msg=f"{p0} {p1}")


def _jax_fp32(monkeypatch, module, name):
    """The JAX detector's net class, built under the fp32 policy."""
    cls = getattr(module, name)
    monkeypatch.setattr(module, name, lambda: cls(policy=j_fp32_policy()))


@pytest.mark.parametrize("shape", [(640, 576, 3), (384, 448, 3)])
def test_mlsd_detector_matches_jax(mlsd_pair, monkeypatch, shape):
    """The detector's render against the JAX detector's (fp32 nets, the same
    weights): the JAX one resizes and draws with OpenCV. The segments come
    from a top-200 of the centre map, so a near-tie at the cut may swap
    one segment: at most 1% of the pixels differ."""
    pytest.importorskip("cv2")
    _, params, port = mlsd_pair
    _jax_fp32(monkeypatch, jm, "MLSDNet")
    img = np.random.default_rng(8).integers(0, 256, shape, dtype=np.uint8)
    want = jm.MLSDdetector(params)(img, 0.1, 0.1)
    got = pm.MLSDdetector(port)(img, 0.1, 0.1)
    assert got.shape == want.shape == shape[:2] and got.dtype == np.uint8
    assert want.any()
    assert (got != want).mean() <= 0.01, (got != want).mean()


# ---- OpenPose ------------------------------------------------------------------


@pytest.fixture(scope="module")
def body_pair():
    x = np.zeros((1, 32, 32, 3), np.float32)
    jmod = jo.BodyPoseNet(policy=j_fp32_policy())
    params = _params(jmod, x, seed=9)
    return jmod, params, _port(po.BodyPoseNet(fp32_policy()), params)


def test_body_net_matches_jax(body_pair):
    jmod, params, port = body_pair
    x = np.random.default_rng(10).uniform(-0.5, 0.5, (2, 32, 40, 3)).astype(np.float32)
    with torch.no_grad():
        paf, heat = port(nchw(x))
    jpaf, jheat = jax.jit(jmod.apply)(params, jnp.asarray(x))
    assert paf.shape == (2, 38, 4, 5) and heat.shape == (2, 19, 4, 5)
    assert (heat >= 0).all()  # the final-ReLU quirk
    _assert_close(nhwc(paf), jpaf, MODEL_RTOL)
    _assert_close(nhwc(heat), jheat, MODEL_RTOL)


def test_hand_net_matches_jax():
    x = np.random.default_rng(11).uniform(-0.5, 0.5, (1, 32, 32, 3)).astype(np.float32)
    jmod = jo.HandPoseNet(policy=j_fp32_policy())
    params = _params(jmod, x, seed=12)
    port = _port(po.HandPoseNet(fp32_policy()), params)
    with torch.no_grad():
        got = port(nchw(x))
    assert got.shape == (1, 22, 4, 4)
    _assert_close(nhwc(got), jax.jit(jmod.apply)(params, jnp.asarray(x)), MODEL_RTOL)


@pytest.mark.parametrize("kind", ["body", "hand"])
def test_import_pose_matches_jax(body_pair, tmp_path, kind):
    """The CPM key scheme is the port's: the importers give the JAX
    importers' weights bit for bit."""
    if kind == "body":
        port, importer, jimporter = body_pair[2], po.import_body_checkpoint, \
            jo.import_body_checkpoint
    else:
        port, importer, jimporter = po.HandPoseNet(fp32_policy()), po.import_hand_checkpoint, \
            jo.import_hand_checkpoint
    path = str(tmp_path / f"{kind}_pose_model.pth")
    torch.save(port.state_dict(), path)
    got = importer(path)
    _bit_equal(got, state_dict_from_jax(jimporter(path)))
    _bit_equal(got, port.state_dict())


def _pose_maps(seed, h=64, w=64):
    """Heat maps with Gaussian blobs per joint for two people, PAFs along
    their limbs, and noise."""
    rng = np.random.default_rng(seed)
    heat = rng.uniform(0, 0.05, (h, w, 19)).astype(np.float32)
    paf = rng.normal(0, 0.02, (h, w, 38)).astype(np.float32)
    yy, xx = np.mgrid[:h, :w]
    for shift in (0, 30):
        joints = {j: (8 + 3 * (j % 6) + shift // 3, 6 + 2 * j + shift // 6) for j in range(18)}
        for j, (y, x) in joints.items():
            heat[:, :, j] += np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / 6.0)
        for (a, b), (c0, c1) in zip(jo.LIMB_SEQ, jo.MAP_IDX):
            (ya, xa), (yb, xb) = joints[a - 1], joints[b - 1]
            v = np.asarray([xb - xa, yb - ya], np.float32)
            v /= max(np.linalg.norm(v), 1e-6)
            for t in np.linspace(0, 1, 20):
                y, x = int(round(ya + t * (yb - ya))), int(round(xa + t * (xb - xa)))
                paf[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2, c0 - 19] = v[0]
                paf[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2, c1 - 19] = v[1]
    return heat, paf


@pytest.mark.parametrize("seed", [13, 14])
def test_pose_decode_matches_jax(seed):
    heat, paf = _pose_maps(seed)
    peaks = po.find_peaks(heat)
    assert peaks == jo.find_peaks(heat) and any(peaks)
    conns, special = po.score_limbs(paf, peaks, heat.shape[0])
    jconns, jspecial = jo.score_limbs(paf, peaks, heat.shape[0])
    assert special == jspecial and conns == jconns
    cand, subset = po.assemble_people(peaks, conns, special)
    jcand, jsubset = jo.assemble_people(peaks, jconns, jspecial)
    np.testing.assert_array_equal(cand, jcand)
    np.testing.assert_array_equal(subset, jsubset)


@pytest.mark.parametrize("seed", [13, 14])
def test_draw_bodypose_matches_jax(seed):
    """The render (the JAX one draws with OpenCV) pixel for pixel, on the
    people the decode assembles and on a hand-made skeleton."""
    pytest.importorskip("cv2")
    heat, paf = _pose_maps(seed)
    peaks = jo.find_peaks(heat)
    cand, subset = jo.assemble_people(peaks, *jo.score_limbs(paf, peaks, 64))
    rng = np.random.default_rng(seed)
    hand_cand = np.concatenate([rng.uniform(-5, 70, (18, 2)), rng.uniform(0, 1, (18, 1)),
                                np.arange(18)[:, None]], axis=1)
    hand_subset = np.concatenate([np.arange(18), [10.0, 18.0]])[None]
    hand_subset[0, [4, 9]] = -1
    for c, s in ((cand, subset), (hand_cand, hand_subset)):
        want = jo.draw_bodypose(np.zeros((64, 72, 3), np.uint8), c, s)
        got = po.draw_bodypose(np.zeros((64, 72, 3), np.uint8), c, s)
        np.testing.assert_array_equal(got, want)
    assert got.any()


def test_opencv_shapes_match_opencv():
    """ellipse2Poly, fillConvexPoly and a filled circle, pixel for pixel."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(15)
    for _ in range(150):
        c = tuple(int(v) for v in rng.integers(-20, 110, 2))
        axes, ang = (int(rng.integers(0, 60)), 4), int(rng.integers(-180, 181))
        poly = cv2.ellipse2Poly(c, axes, ang, 0, 360, 1)
        np.testing.assert_array_equal(po.ellipse2poly(c, axes, ang, 0, 360, 1), poly)
        for draw, mine in ((lambda a: cv2.fillConvexPoly(a, poly, [255, 85, 0]),
                            lambda a: po.fill_convex_poly(a, poly, [255, 85, 0])),
                           (lambda a: cv2.circle(a, c, 4, [0, 255, 85], thickness=-1),
                            lambda a: po.fill_circle(a, c, 4, [0, 255, 85]))):
            want = np.zeros((90, 100, 3), np.uint8)
            got = want.copy()
            draw(want)
            mine(got)
            np.testing.assert_array_equal(got, want)


def test_openpose_detector_matches_jax(body_pair, monkeypatch):
    """The detector (fp32 nets, the same weights) against the JAX one: the
    same candidates and people, the same render."""
    pytest.importorskip("cv2")
    _, params, port = body_pair
    _jax_fp32(monkeypatch, jo, "BodyPoseNet")
    img = np.random.default_rng(16).integers(0, 256, (48, 40, 3), dtype=np.uint8)
    want_canvas, want = jo.OpenposeDetector(params)(img)
    canvas, got = po.OpenposeDetector(port)(img)
    np.testing.assert_allclose(np.asarray(got["candidate"]).reshape(-1, 4),
                               np.asarray(want["candidate"]).reshape(-1, 4), rtol=1e-5)
    assert np.asarray(got["subset"]).shape == np.asarray(want["subset"]).shape
    np.testing.assert_array_equal(canvas, want_canvas)
