"""PyTorch port, int8 W8A8 serving mode: the quantization helpers, QuantDense
and QuantConv, the plain versions of kernels K5-K8, the int8 UNet and the
int8 `generate` against the JAX package on the CPU, and the weight bridge
into an int8 pipeline. Inputs come from numpy seeds; each test states its
bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prompt_diffusion_tpu.models import clip_text as jclip
from prompt_diffusion_tpu.models import controlnet_sd15 as jcn
from prompt_diffusion_tpu.models import unet_sd15 as junet
from prompt_diffusion_tpu.models import vae as jvae
from prompt_diffusion_tpu.ops import fused_act as jfa
from prompt_diffusion_tpu.ops import quant as jquant
from prompt_diffusion_tpu.ops.fused_group_norm import fused_group_norm_quant as j_gn_quant
from prompt_diffusion_tpu.ops.fused_layer_norm import fused_layer_norm_quant as j_ln_quant
from prompt_diffusion_tpu.ops.fused_layer_norm import rowquant as j_rowquant
from prompt_diffusion_tpu.ops.int8_conv import conv3x3_int8 as j_conv3x3_int8
from prompt_diffusion_tpu.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15 as JPipe
from prompt_diffusion_tpu.schedulers.schedules import DiffusionSchedule as JSchedule
from prompt_diffusion_tpu.utils.dtypes import DTypePolicy as JPolicy
from prompt_diffusion_tpu.utils.dtypes import fp32_policy as j_fp32_policy
from prompt_diffusion_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from prompt_diffusion_tpu_torch.models.controlnet_sd15 import ControlNetSD15
from prompt_diffusion_tpu_torch.models.layers import Conv, Dense
from prompt_diffusion_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15
from prompt_diffusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from prompt_diffusion_tpu_torch.ops.fused_act import fused_geglu_quant
from prompt_diffusion_tpu_torch.ops.fused_group_norm import fused_group_norm_quant
from prompt_diffusion_tpu_torch.ops.fused_layer_norm import fused_layer_norm_quant, rowquant
from prompt_diffusion_tpu_torch.ops.int8_conv import conv3x3_int8, int8_matmul
from prompt_diffusion_tpu_torch.ops.quant import QuantConv, QuantDense, quant_act, quant_weight
from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
from prompt_diffusion_tpu_torch.tools.jax_bridge import load_jax_params, state_dict_from_jax
from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy, int8_policy
from tests.torch_port_util import TINY_CLIP, TINY_UNET, TINY_VAE, nchw, nhwc, randomize

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
J_INT8_F32 = JPolicy(compute_dtype=jnp.float32, quant="int8")
INT8_F32 = DTypePolicy(compute_dtype=torch.float32, quant="int8")


def _normal(rng, shape, mean=0.0):
    return (rng.normal(size=shape) + mean).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _assert_codes(got_q, got_s, ref_q, ref_s):
    """The kernels' bound: scales within rtol 1e-6; codes at most 1 apart,
    at least 99.9% equal (an fp32 ulp can move a value across a .5)."""
    np.testing.assert_allclose(got_s, ref_s, rtol=1e-6)
    diff = np.abs(got_q.astype(np.int32) - np.asarray(ref_q).astype(np.int32))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, (diff.max(), (diff == 0).mean())


# ---- quantization helpers: bit-equal -----------------------------------


@pytest.mark.parametrize("kind", ["conv", "dense", "dense_pre_scale"])
def test_quant_weight_bit_equal(kind):
    rng = np.random.default_rng(0)
    if kind == "conv":  # HWIO in JAX, OIHW in the port
        w = _normal(rng, (3, 3, 16, 24)) * 0.1
        wq, s = jquant._quant_weight(jnp.asarray(w), reduce_axes=(0, 1, 2))
        pq, ps = quant_weight(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), dims=(1, 2, 3))
        pq, ps = pq.permute(2, 3, 1, 0), ps.reshape(1, 1, 1, -1)
    else:
        w = _normal(rng, (64, 48))
        scale = 40 ** -0.5 if kind == "dense_pre_scale" else 1.0
        wq, s = jquant._quant_weight(jnp.asarray(w) * scale, reduce_axes=(0,))
        pq, ps = quant_weight(torch.from_numpy(w.T.copy()) * scale, dims=1)
        pq, ps = pq.T, ps.T
    np.testing.assert_array_equal(pq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(s))


def test_quant_act_and_rowquant_bit_equal():
    rng = np.random.default_rng(1)
    x = _normal(rng, (2, 37, 96)) * 3
    xq, s = jquant._quant_act(jnp.asarray(x))
    pq, ps = quant_act(torch.from_numpy(x))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(xq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(s))
    rq, rs = j_rowquant(jnp.asarray(x))
    pq, ps = rowquant(torch.from_numpy(x))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    # ties go to even, as jnp.round does
    q, _ = rowquant(torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]]))
    assert q.tolist() == [[127, 0, 2, 2, 0, -2]]


def test_int8_matmul_pads_to_cuda_shapes():
    """M <= 16 and K, N not multiples of 8 (what `torch._int_mm` on CUDA
    refuses) give the exact integer product."""
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.integers(-127, 128, (5, 36)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (13, 36)).astype(np.int8))
    got = int8_matmul(a, w)
    assert got.dtype == torch.int32 and got.shape == (5, 13)
    np.testing.assert_array_equal(got.numpy(), a.numpy().astype(np.int64) @ w.numpy().T)


# ---- QuantDense / QuantConv against JAX apply (fp32 out) ----------------


def _port_module(module, params):
    module.load_state_dict(state_dict_from_jax(params), strict=True)
    return module.eval()


@pytest.mark.parametrize("form", ["float", "row_pair", "pre_scale"])
def test_quant_dense_matches_jax(form):
    """Bound rtol 1e-6 (the int32 products are exact; only the dequant's
    fp32 rounding order could differ)."""
    rng = np.random.default_rng(3)
    x = _normal(rng, (2, 20, 64))
    pre = 40 ** -0.5 if form == "pre_scale" else 1.0
    m = jquant.QuantDense(48, use_bias=form != "pre_scale", pre_scale=pre, out_dtype=jnp.float32)
    params = randomize(jax.eval_shape(m.init, KEY, jnp.zeros((1, 20, 64))), 4)
    port = _port_module(QuantDense(64, 48, bias=form != "pre_scale", pre_scale=pre,
                                   out_dtype=torch.float32), params)
    if form == "row_pair":
        jq, js = j_rowquant(jnp.asarray(x))
        ref = m.apply(params, (jq, js))
        got = port(rowquant(torch.from_numpy(x)))
    else:
        ref = m.apply(params, jnp.asarray(x))
        got = port(torch.from_numpy(x))
    assert port.weight.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("form", ["1x1", "3x3", "3x3_stride2", "3x3_sample_pair"])
def test_quant_conv_matches_jax(form):
    rng = np.random.default_rng(5)
    x = _normal(rng, (2, 8, 8, 16))
    k, stride = (1, 1) if form == "1x1" else ((3, 2) if form == "3x3_stride2" else (3, 1))
    m = jquant.QuantConv(24, kernel_size=(k, k), strides=(stride, stride),
                         padding=0 if k == 1 else 1, out_dtype=jnp.float32)
    params = randomize(jax.eval_shape(m.init, KEY, jnp.zeros((1, 8, 8, 16))), 6)
    port = _port_module(QuantConv(16, 24, k, stride=stride, padding=0 if k == 1 else 1,
                                  out_dtype=torch.float32), params)
    if form == "3x3_sample_pair":
        s = np.abs(x).max(axis=(1, 2, 3)) / 127.0
        xq = np.clip(np.round(x / s[:, None, None, None]), -127, 127).astype(np.int8)
        ref = m.apply(params, (jnp.asarray(xq), jnp.asarray(s, jnp.float32)))
        got = port((nchw(xq), torch.from_numpy(s.astype(np.float32))))
    else:
        ref = m.apply(params, jnp.asarray(x))
        got = port(nchw(x))
    assert got.shape == (2, 24) + np.asarray(ref).shape[1:3]
    np.testing.assert_allclose(nhwc(got.detach()), np.asarray(ref), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["dense", "conv1x1", "conv3x3"])
def test_zero_weights_give_exact_zero(kind):
    """Zero-initialised weights stay exactly zero through the quantization
    (the JAX package's contract, tests/test_quant.py)."""
    x = torch.ones(1, 16, 8, 8)
    if kind == "dense":
        m, x = QuantDense(16, 8, out_dtype=torch.float32), x.flatten(2).transpose(1, 2)
    else:
        m = QuantConv(16, 8, 1 if kind == "conv1x1" else 3, padding=0 if kind == "conv1x1" else 1,
                      out_dtype=torch.float32)
    with torch.no_grad():
        m.weight.zero_()
        m.bias.zero_()
    assert torch.equal(m(x), torch.zeros_like(m(x)))


# ---- plain kernels against the JAX kernels -------------------------------


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("cin", [4, 16])
def test_conv3x3_int8_plain_bit_equal_to_pallas(cin, with_bias, out_dtype):
    """Plain K8 against the Pallas kernel in interpret mode: bit-equal."""
    rng = np.random.default_rng(cin)
    xq = rng.integers(-127, 128, (2, 8, 8, cin)).astype(np.int8)
    wq = rng.integers(-127, 128, (3, 3, cin, 16)).astype(np.int8)
    s_a = rng.uniform(0.01, 0.1, (2,)).astype(np.float32)
    s_w = rng.uniform(0.001, 0.01, (16,)).astype(np.float32)
    bias = rng.normal(size=(16,)).astype(np.float32) if with_bias else None
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    ref = j_conv3x3_int8(jnp.asarray(xq), jnp.asarray(s_a), jnp.asarray(wq), jnp.asarray(s_w),
                         None if bias is None else jnp.asarray(bias), out_dtype=jdt,
                         interpret=True)
    got = conv3x3_int8(torch.from_numpy(xq), torch.from_numpy(s_a),
                       torch.from_numpy(wq.transpose(3, 0, 1, 2).copy()), torch.from_numpy(s_w),
                       None if bias is None else torch.from_numpy(bias), out_dtype=out_dtype)
    assert got.dtype == out_dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("silu,eps,mean", [(True, 1e-5, 0.0), (False, 1e-6, 0.0),
                                           (True, 1e-6, 3.0)])
def test_group_norm_quant_plain_matches_jax(silu, eps, mean):
    rng = np.random.default_rng(7)
    x = _normal(rng, (2, 16, 16, 64), mean)
    s, b = 1 + 0.1 * _normal(rng, (64,)), 0.1 * _normal(rng, (64,))
    rq, rs = j_gn_quant(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 32, eps, silu)
    q, sa = fused_group_norm_quant(nchw(x), torch.from_numpy(s), torch.from_numpy(b), 32,
                                   eps, silu)
    assert q.dtype == torch.int8 and sa.shape == (2,)
    _assert_codes(q.permute(0, 2, 3, 1).numpy(), sa.numpy(), rq, rs)


@pytest.mark.parametrize("shape", [(2, 64, 320), (3, 37, 128)])
def test_layer_norm_quant_plain_matches_jax(shape):
    rng = np.random.default_rng(8)
    x = _normal(rng, shape)
    c = shape[-1]
    s, b = 1 + 0.1 * _normal(rng, (c,)), 0.1 * _normal(rng, (c,))
    rq, rs = j_ln_quant(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    q, sa = fused_layer_norm_quant(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b))
    assert q.shape == shape and sa.shape == shape[:-1] + (1,)
    _assert_codes(q.numpy(), sa.numpy(), rq, rs)


def test_geglu_quant_plain_matches_jax(monkeypatch):
    """Against the JAX CPU path (exact erf), then against the Pallas body in
    interpret mode, whose A&S erf moves a code by at most 1."""
    rng = np.random.default_rng(9)
    proj = _normal(rng, (2, 37, 256))
    q, sa = fused_geglu_quant(torch.from_numpy(proj))
    assert q.shape == (2, 37, 128) and sa.shape == (2, 37, 1)
    rq, rs = jfa.fused_geglu_quant(jnp.asarray(proj))
    _assert_codes(q.numpy(), sa.numpy(), rq, rs)
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)
    iq, i_s = jfa.fused_geglu_quant(jnp.asarray(proj))
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(iq).astype(np.int32))
    assert diff.max() <= 1, diff.max()
    np.testing.assert_allclose(sa.numpy(), np.asarray(i_s), rtol=1e-5)


def test_cpu_tensors_take_the_plain_int8_versions():
    """On the CPU the four int8 wrappers run their plain versions and count
    no launch."""
    counted = (fused_group_norm_quant, fused_layer_norm_quant, fused_geglu_quant, conv3x3_int8)
    before = [f.launches for f in counted]
    x = torch.randn(2, 32, 8, 8)
    fused_group_norm_quant(x, torch.ones(32), torch.zeros(32), 8)
    fused_layer_norm_quant(torch.randn(4, 64), torch.ones(64), torch.zeros(64))
    fused_geglu_quant(torch.randn(4, 64))
    conv3x3_int8(torch.zeros(1, 4, 4, 16, dtype=torch.int8), torch.ones(1),
                 torch.zeros(8, 3, 3, 16, dtype=torch.int8), torch.ones(8))
    assert [f.launches for f in counted] == before


# ---- the int8 models and pipeline against JAX ----------------------------


def test_int8_policy_routes_the_sites():
    """The sites that quantize and the ones that stay in the compute dtype
    (`models/layers.py` of the JAX package); the state dict is the bf16
    model's."""
    cfg = UNetConfig(**TINY_UNET)
    unet, cn = UNetSD15(cfg, int8_policy()), ControlNetSD15(cfg, 6, int8_policy())
    vae = AutoencoderKL(VAEConfig(**TINY_VAE), int8_policy())
    quant = {n for m in (unet, cn, vae) for n, mod in m.named_modules()
             if isinstance(mod, (QuantConv, QuantDense))}
    attn = "input_blocks_1_attn."
    for m, names in ((unet, ["input_blocks_0_conv", "input_blocks_1_res.in_conv",
                             attn + "proj_in", attn + "block_0.attn1.to_q",
                             attn + "block_0.ff.out", "input_blocks_2_down.conv",
                             "output_blocks_1_up.conv", "output_blocks_0_res.skip"]),
                     (cn, ["input_blocks_0_conv", "middle_block_1.block_0.attn2.to_k"]),
                     (vae, ["decoder.conv_in", "decoder.mid_attn_1.q", "decoder.up_1_upsample",
                            "decoder.up_0_block_0.conv1"])):
        for name in names:
            assert isinstance(m.get_submodule(name), (QuantConv, QuantDense)), name
    for m, names in ((unet, ["out_conv", "time_embed.fc1", "input_blocks_1_res.emb_proj"]),
                     (cn, ["zero_convs_0", "middle_block_out", "input_hint_block.conv_0"]),
                     (vae, ["decoder.conv_out", "encoder.conv_in", "encoder.conv_out",
                            "post_quant_conv", "encoder.down_0_downsample"])):
        for name in names:
            assert isinstance(m.get_submodule(name), (Conv, Dense)), name
    assert len(quant) > 50
    bf16 = UNetSD15(cfg)
    sd8, sd16 = unet.state_dict(), bf16.state_dict()
    assert list(sd8) == list(sd16)
    assert all(sd8[k].shape == sd16[k].shape for k in sd8)


@pytest.fixture(scope="module")
def unet_case():
    cfg = junet.UNetConfig(**TINY_UNET)
    m = junet.UNetSD15(config=cfg, policy=j_fp32_policy())
    lat, ctx_len = 8, 7
    shapes = jax.eval_shape(m.init, KEY, jnp.zeros((1, lat, lat, 4)), jnp.zeros((1,), jnp.int32),
                            jnp.zeros((1, ctx_len, 64)))
    params = randomize(shapes, 10)
    rng = np.random.default_rng(11)
    plan, chans, mid, _ = cfg.encoder_plan()
    shapes, res = [], lat
    for (kind, _, _), ch in zip(plan, chans):
        res = res // 2 if kind == "down" else res
        shapes.append((2, res, res, ch))
    control = [_normal(rng, s) for s in shapes + [(2, res, res, mid)]]
    inp = dict(x=_normal(rng, (2, lat, lat, 4)), t=np.array([999, 31], np.int32),
               ctx=_normal(rng, (2, ctx_len, 64)))
    return cfg, params, inp, control


def _junet(cfg, params, inp, control, policy):
    return np.asarray(jax.jit(junet.UNetSD15(config=cfg, policy=policy).apply)(
        params, jnp.asarray(inp["x"]), jnp.asarray(inp["t"]), jnp.asarray(inp["ctx"]),
        control=[jnp.asarray(c) for c in control]))


# Whole-network comparisons. The port and JAX differ at the level of fp32
# rounding (reduction order, erf/exp/rsqrt implementations, where XLA fuses a
# multiply-add). An int8 site turns such a difference into a whole code step
# wherever a value sits near a rounding boundary, so the gap grows layer by
# layer: in the tiny UNet below the first gap (6.5e-4 rel L2 after a GEGLU
# site) reaches 3.4% at the output, near the quantization noise itself.
# Reproducing the quantization is therefore held site by site, with the
# same inputs (`test_int8_block_matches_jax`, within a fifth of each
# block's own quantization error); the whole networks are held to be int8
# evaluations at JAX's noise level: as far from JAX fp32 as JAX int8 is
# (ratio within [0.5, 1.5]), and no farther from JAX int8 than 1.5 times
# that distance (two independent evaluations at one noise level would sit
# sqrt(2) apart).


def _assert_int8_noise_level(got, ref8, ref32):
    quant_err = _rel(ref8, ref32)
    ratio32, ratio8 = _rel(got, ref32) / quant_err, _rel(got, ref8) / quant_err
    assert quant_err > 1e-3, quant_err
    assert 0.5 <= ratio32 <= 1.5 and ratio8 <= 1.5, (quant_err, ratio32, ratio8)


def test_int8_unet_with_control_matches_jax(unet_case):
    """The port's int8 UNet with control (fp32 compute) against JAX's."""
    cfg, params, inp, control = unet_case
    ref8 = _junet(cfg, params, inp, control, J_INT8_F32)
    ref32 = _junet(cfg, params, inp, control, j_fp32_policy())
    port = _port_module(UNetSD15(UNetConfig(**TINY_UNET), INT8_F32), params)
    with torch.no_grad():
        got = nhwc(port(nchw(inp["x"]), torch.from_numpy(inp["t"]),
                        torch.from_numpy(inp["ctx"]), control=[nchw(c) for c in control]))
    _assert_int8_noise_level(got, ref8, ref32)


def _jblock(kind, policy):
    from prompt_diffusion_tpu.models import layers as jl

    return {"resblock": lambda: jl.ResBlock(out_channels=64, policy=policy),
            "resblock_same_width": lambda: jl.ResBlock(out_channels=32, policy=policy),
            "spatial_transformer": lambda: jl.SpatialTransformer(heads=4, dim_head=8, depth=1,
                                                                 policy=policy),
            "downsample": lambda: jl.Downsample(out_channels=32, policy=policy),
            "upsample": lambda: jl.Upsample(out_channels=32, policy=policy),
            "input_conv": lambda: jl.conv3x3(32, dtype=jnp.float32, policy=policy),
            "vae_resblock": lambda: jvae.VAEResnetBlock(out_channels=64, policy=policy),
            "vae_attention": lambda: jvae.VAEAttnBlock(policy=policy)}[kind]()


def _pblock(kind):
    from prompt_diffusion_tpu_torch.models import layers as pl
    from prompt_diffusion_tpu_torch.models import vae as pv

    f32 = torch.float32
    return {"resblock": lambda: pl.ResBlock(32, 64, 128, INT8_F32),
            "resblock_same_width": lambda: pl.ResBlock(32, 32, 128, INT8_F32),
            "spatial_transformer": lambda: pl.SpatialTransformer(32, 64, 4, 8, 1, INT8_F32),
            "downsample": lambda: pl.Downsample(32, 32, INT8_F32),
            "upsample": lambda: pl.Upsample(32, 32, INT8_F32),
            "input_conv": lambda: pl.conv3x3(4, 32, f32, policy=INT8_F32),
            "vae_resblock": lambda: pv.VAEResnetBlock(32, 64, INT8_F32),
            "vae_attention": lambda: pv.VAEAttnBlock(32, INT8_F32)}[kind]()


@pytest.mark.parametrize("kind", ["resblock", "resblock_same_width", "spatial_transformer",
                                  "downsample", "upsample", "input_conv", "vae_resblock",
                                  "vae_attention"])
def test_int8_block_matches_jax(kind):
    """Each quantized block of the UNet, ControlNet and VAE (fp32 compute),
    fed the same input as JAX's: relative L2 from JAX int8 at most a fifth
    of JAX int8's own distance from JAX fp32, so the port reproduces the
    quantization, not merely something near fp32."""
    rng = np.random.default_rng(30)
    x = _normal(rng, (2, 8, 8, 4 if kind == "input_conv" else 32))
    extra = {"resblock": (128,), "resblock_same_width": (128,), "spatial_transformer": (7, 64)}
    extra = [_normal(rng, (2,) + extra[kind])] if kind in extra else []
    jm = _jblock(kind, J_INT8_F32)
    params = randomize(jax.eval_shape(jm.init, KEY, *(jnp.asarray(a) for a in [x] + extra)), 31)
    run = lambda m: np.asarray(m.apply(params, *(jnp.asarray(a) for a in [x] + extra)))
    ref8, ref32 = run(jm), run(_jblock(kind, j_fp32_policy()))
    port = _port_module(_pblock(kind), params)
    with torch.no_grad():
        got = nhwc(port(nchw(x), *(torch.from_numpy(a) for a in extra)))
    quant_err, port_err = _rel(ref8, ref32), _rel(got, ref8)
    assert quant_err > 1e-3, quant_err
    assert port_err <= quant_err / 5, (port_err, quant_err)


B, IMG = 2, 64


def _jpipe(vae_int8, jpol):
    ucfg = junet.UNetConfig(**TINY_UNET)
    return JPipe(
        unet=junet.UNetSD15(config=ucfg, policy=jpol),
        controlnet=jcn.ControlNetSD15(config=ucfg, hint_channels=6, policy=jpol),
        vae=jvae.AutoencoderKL(config=jvae.VAEConfig(**TINY_VAE),
                               policy=J_INT8_F32 if vae_int8 else j_fp32_policy()),
        text_encoder=jclip.CLIPTextModel(config=jclip.CLIPTextConfig(**TINY_CLIP),
                                         policy=j_fp32_policy()),
        schedule=JSchedule.create())


def _port_pipe(vae_int8, pol=INT8_F32):
    return PromptDiffusionSD15.create(
        unet=UNetSD15(UNetConfig(**TINY_UNET), pol),
        controlnet=ControlNetSD15(UNetConfig(**TINY_UNET), 6, pol),
        vae=AutoencoderKL(VAEConfig(**TINY_VAE), INT8_F32 if vae_int8 else DTypePolicy(
            compute_dtype=torch.float32)),
        text_encoder=CLIPTextModel(CLIPTextConfig(**TINY_CLIP),
                                   DTypePolicy(compute_dtype=torch.float32)),
        device="cpu")


@pytest.fixture(scope="module")
def generate_case():
    jfp32 = _jpipe(False, j_fp32_policy())
    shapes = jax.eval_shape(lambda r: jfp32.init_params(r, image_size=IMG), KEY)
    params = randomize(shapes, 20)
    rng = np.random.default_rng(21)
    r = dict(ids=rng.integers(0, 100, (B, 77)).astype(np.int32), neg=np.zeros((B, 77), np.int32),
             pair=rng.uniform(-1, 1, (B, IMG, IMG, 6)).astype(np.float32),
             query=rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32),
             noise=rng.normal(size=(B, IMG // 8, IMG // 8, 4)).astype(np.float32))
    return params, r, _jgenerate(jfp32, params, r)


def _jgenerate(jpipe, params, r):
    return np.asarray(jpipe.jit_generate()(
        params, KEY, jnp.asarray(r["ids"]), jnp.asarray(r["neg"]), jnp.asarray(r["pair"]),
        jnp.asarray(r["query"]), num_steps=3, guidance_scale=9.0,
        init_noise=jnp.asarray(r["noise"])))


@pytest.mark.parametrize("vae_int8", [False, True])
def test_int8_generate_matches_jax(generate_case, vae_int8):
    """Tiny int8 `generate` (batch 2, 64², 3 DDIM steps, CFG 9, injected
    noise) against JAX's, with the int8 or the fp32 VAE."""
    params, r, ref32 = generate_case
    ref8 = _jgenerate(_jpipe(vae_int8, J_INT8_F32), params, r)
    pipe = _port_pipe(vae_int8)
    load_jax_params(pipe, params)
    got = pipe.generate(torch.from_numpy(r["ids"]), torch.from_numpy(r["neg"]),
                        torch.from_numpy(r["pair"]), torch.from_numpy(r["query"]), num_steps=3,
                        guidance_scale=9.0, init_noise=torch.from_numpy(r["noise"])).numpy()
    assert got.shape == (B, IMG, IMG, 3) and np.isfinite(got).all()
    _assert_int8_noise_level(got, ref8, ref32)


def test_bridge_loads_into_bf16_and_int8_pipelines(generate_case):
    """One JAX tree loads strictly into a bf16 and an int8 pipeline; the
    quantized modules keep fp32 weights; a second load with other values
    re-quantizes (the output equals a fresh pipeline's with those values)."""
    params, _, _ = generate_case
    tiny = lambda pol, vae_int8: PromptDiffusionSD15.create(
        unet=UNetSD15(UNetConfig(**TINY_UNET), pol),
        controlnet=ControlNetSD15(UNetConfig(**TINY_UNET), 6, pol),
        vae=AutoencoderKL(VAEConfig(**TINY_VAE), int8_policy() if vae_int8 else pol),
        text_encoder=CLIPTextModel(CLIPTextConfig(**TINY_CLIP)), device="cpu")
    load_jax_params(tiny(DTypePolicy(), False), params)
    pipe8 = tiny(int8_policy(), True)
    load_jax_params(pipe8, params)
    for m in (pipe8.unet, pipe8.controlnet, pipe8.vae):
        qmods = [mod for mod in m.modules() if isinstance(mod, (QuantConv, QuantDense))]
        assert qmods and all(mod.weight.dtype == torch.float32 for mod in qmods)
    rng = np.random.default_rng(22)
    x, ctx = nchw(_normal(rng, (B, 8, 8, 4))), torch.from_numpy(_normal(rng, (B, 77, 64)))
    t = torch.tensor([999, 31])
    run = lambda p: (p.unet(x, t, ctx), p.vae.decode(x))
    with torch.no_grad():
        first = run(pipe8)
        other = randomize(params, 23)
        load_jax_params(pipe8, other)
        second = run(pipe8)
        fresh = tiny(int8_policy(), True)
        load_jax_params(fresh, other)
        want = run(fresh)
    for a, b, c in zip(first, second, want):
        assert not torch.equal(a, b)
        assert torch.equal(b, c)
