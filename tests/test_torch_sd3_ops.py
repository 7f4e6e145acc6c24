"""PyTorch port, SD3 slice, the parts below the models: the plain versions of
kernels K9 (int8-QK^T attention), K10 (tanh-GELU -> int8), K11 (row ->
int8) and K13 (AdaLN -> int8) against the JAX package's Pallas kernels in
interpret mode and its CPU paths; the T5 buckets and encoder, the gelu
CLIP, the flow-matching tables and step, and the control window. Inputs
come from numpy seeds; each test states its bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prompt_diffusion_tpu.models import clip_text as jclip
from prompt_diffusion_tpu.models import t5_text as jt5
from prompt_diffusion_tpu.ops import flash_attention as jflash
from prompt_diffusion_tpu.ops import fused_act as jfa
from prompt_diffusion_tpu.ops import fused_adaln as jadaln
from prompt_diffusion_tpu.pipelines import control_window as jwin
from prompt_diffusion_tpu.schedulers import flow_match as jfm
from prompt_diffusion_tpu.utils.dtypes import fp32_policy as j_fp32_policy
from prompt_diffusion_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from prompt_diffusion_tpu_torch.models.t5_text import T5Config, T5Encoder, _relative_position_bucket
from prompt_diffusion_tpu_torch.ops import flash_attention as fa
from prompt_diffusion_tpu_torch.ops.flash_attention import _packed_ref, flash_attention_packed_int8
from prompt_diffusion_tpu_torch.ops.fused_act import fused_gelu_quant, fused_quant_rows
from prompt_diffusion_tpu_torch.ops.fused_adaln import fused_adaln_quant
from prompt_diffusion_tpu_torch.pipelines import control_window as win
from prompt_diffusion_tpu_torch.schedulers import flow_match as fm
from prompt_diffusion_tpu_torch.tools.jax_bridge import state_dict_from_jax
from prompt_diffusion_tpu_torch.utils.dtypes import fp32_policy
from tests.torch_port_util import jax_int8_attention as _jax_int8_attention
from tests.torch_port_util import randomize

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
TINY_T5 = dict(vocab_size=50, d_model=64, d_kv=8, d_ff=96, num_layers=2, num_heads=4)
TINY_CLIP_G = dict(vocab_size=100, hidden_size=24, num_layers=3, num_heads=4,
                   intermediate_size=48, activation="gelu", eot_token_id=99)


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _assert_codes(got, ref):
    """The int8 kernels' bound: scales within rtol 1e-6; codes at most 1
    apart and at least 99.9% equal (tanh and rsqrt differ by an ulp
    between the frameworks, which can move a value across a .5)."""
    (q, s), (rq, rs) = got, ref
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-6)
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(rq).astype(np.int32))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, (diff.max(), (diff == 0).mean())


# ---- K13 AdaLN -> int8 -------------------------------------------------


@pytest.mark.parametrize("n", [154, 333])  # SD3 context lengths: 77+77, 77+256
def test_adaln_quant_plain_matches_jax(n, monkeypatch):
    """Plain K13 against the JAX CPU path, then against the Pallas kernel
    (`_adaln_quant_kernel`, rows padded to 8) in interpret mode."""
    rng = np.random.default_rng(n)
    x = _normal(rng, (2, n, 128), 2.0) + 0.5
    s, t = _normal(rng, (2, 1, 128), 0.2), _normal(rng, (2, 128), 0.2)  # (B,1,C) and (B,C)
    got = fused_adaln_quant(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(t))
    assert got[0].shape == (2, n, 128) and got[0].dtype == torch.int8
    assert got[1].shape == (2, n, 1)
    _assert_codes(got, jadaln.fused_adaln_quant(jnp.asarray(x), jnp.asarray(s), jnp.asarray(t)))
    monkeypatch.setattr(jadaln, "_FORCE_INTERPRET", True)
    _assert_codes(got, jadaln.fused_adaln_quant(jnp.asarray(x), jnp.asarray(s), jnp.asarray(t)))


# ---- K10 tanh-GELU -> int8, K11 row -> int8 ----------------------------


@pytest.mark.parametrize("n", [154, 333])
@pytest.mark.parametrize("gelu", [True, False])
def test_act_quant_plain_matches_jax(n, gelu, monkeypatch):
    """Plain K10 / K11 against the JAX CPU path (`_jnp_fallback`) and the
    Pallas kernels through `fused_act._run` in interpret mode."""
    rng = np.random.default_rng(10 * n + gelu)
    x = _normal(rng, (2, n, 192), 2.0)
    port, jfn = ((fused_gelu_quant, jfa.fused_gelu_quant) if gelu
                 else (fused_quant_rows, jfa.fused_quant_rows))
    got = port(torch.from_numpy(x))
    assert got[0].shape == (2, n, 192) and got[1].shape == (2, n, 1)
    _assert_codes(got, jfn(jnp.asarray(x)))
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)
    _assert_codes(got, jfn(jnp.asarray(x)))


def test_cpu_tensors_take_the_plain_sd3_versions():
    """On the CPU the four SD3 wrappers run their plain versions and count
    no launch."""
    counted = (flash_attention_packed_int8, fused_gelu_quant, fused_quant_rows, fused_adaln_quant)
    before = [f.launches for f in counted]
    x = torch.randn(2, 20, 64)
    flash_attention_packed_int8(x, x, x, 4)
    fused_gelu_quant(x)
    fused_quant_rows(x)
    fused_adaln_quant(x, torch.zeros(2, 64), torch.zeros(2, 64))
    assert [f.launches for f in counted] == before


# ---- K9 int8-QK^T attention --------------------------------------------


@pytest.mark.parametrize("dtype,atol", [(np.float32, 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("n", [200, 77])
def test_int8_attention_plain_matches_pallas(n, dtype, atol):
    """Plain K9 against the TPU kernel in interpret mode: fp32 V within
    1e-5, bf16 within 2e-2 (one bf16 step of the output and of P)."""
    rng = np.random.default_rng(n)
    heads, scale = 4, 16 ** -0.5
    qkv = [_normal(rng, (2, n, 64)) for _ in range(3)]
    jdt = jnp.float32 if dtype == np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    ref = _jax_int8_attention(*(jnp.asarray(a, jdt) for a in qkv), heads, scale)
    got = flash_attention_packed_int8(*(torch.from_numpy(a).to(tdt) for a in qkv), heads)
    assert got.dtype == tdt and got.shape == (2, n, 64)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=atol)


def _jax_quant_k_per_head(k, num_heads):
    """The JAX package's host-side K quantization
    (`flash_attention.py:391-394`), as `_jax_int8_attention` writes it."""
    b, n, hd = k.shape
    kf = k.astype(jnp.float32).reshape(b, n, num_heads, hd // num_heads)
    skh = jnp.maximum(jnp.max(jnp.abs(kf), axis=(1, 3)) / 127.0, 1e-8)
    ki = jnp.clip(jnp.round(kf / skh[:, None, :, None]), -127, 127).astype(jnp.int8)
    return ki.reshape(b, n, hd), skh


@pytest.mark.parametrize("case", ["ragged", "zero head", "ties", "bf16"])
def test_quant_k_per_head_bit_equals_jax(case):
    """`_quant_k_per_head`, the plain version of K9's prologue, bit-equal in
    codes and scales to the JAX host-side quantization: at a ragged Nk, with
    one all-zero head (the 1e-8 clamp), on values placed exactly on .5 code
    ties (each head's amax 127, so skh = 1 and ties go to even), and on bf16
    input."""
    rng = np.random.default_rng(7)
    b, n, heads, d = 2, 77, 4, 32
    k = _normal(rng, (b, n, heads * d), 2.0)
    if case == "zero head":
        k[1, :, 2 * d:3 * d] = 0.0
    if case == "ties":
        k = (rng.integers(-60, 60, size=k.shape) + 0.5).astype(np.float32)
        k[:, 5, ::d] = 127.0
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    kt = torch.from_numpy(k).to(dtype)
    codes, scales = fa._quant_k_per_head(kt, heads)
    ref_codes, ref_scales = _jax_quant_k_per_head(jnp.asarray(kt.float().numpy()).astype(
        jnp.bfloat16 if case == "bf16" else jnp.float32), heads)
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(ref_scales))
    if case == "zero head":
        assert scales[1, 2].item() == np.float32(1e-8) and not codes[1, :, 2 * d:3 * d].any()
    if case == "ties":
        tie_codes = codes.numpy()[np.abs(k) != 127.0]
        assert (tie_codes % 2 == 0).all(), "ties must round to even"
    # on the CPU the prologue's wrapper is its plain version, and counts nothing
    before = fa.quant_k_int8.launches
    got_codes, got_scales = fa.quant_k_int8(kt, heads)
    assert torch.equal(got_codes, codes) and torch.equal(got_scales, scales)
    assert fa.quant_k_int8.launches == before


@pytest.mark.parametrize("nq,block_q", [(4429, 128), (1025, 64), (1100, 128), (4250, 128),
                                        (4096, 128), (64, 64)])
def test_int8_block_q_per_shape(nq, block_q):
    """K9's query tile: 128 rows, or 64 where 128-row blocks would leave
    more than a tenth of their rows idle (the ViT-B's N = 1025); the SD3
    joint length and the lab's 4250 take 128. Both are instantiated."""
    assert fa.int8_block_q(nq) == block_q
    assert block_q in fa.INT8_BLOCK_Q


def _int8_refused(case):
    """(q, k, v, heads, scale, block_q) for each input K9 or its prologue
    refuses."""
    bf16 = lambda n, hd: torch.zeros(1, n, hd, dtype=torch.bfloat16)
    x = bf16(64, 256)  # 4 heads of 64
    misaligned = torch.zeros(64 * 256 + 1, dtype=torch.bfloat16)[1:].view(1, 64, 256)
    cases = {
        # the parent kernel takes D 32, 64, 128; the sm90 kernel 40 and 80 too
        "head dim 40": (bf16(64, 160),) * 3 + (4, 0.125, 64),
        "head dim 48": (bf16(64, 192),) * 3 + (4, 0.125, None),
        "q fp32": (x.float(), x, x, 4, 0.125, None),
        "k fp32 (the prologue reads bf16)": (x, x.float(), x, 4, 0.125, None),
        "k row stride not a multiple of 8": (x, bf16(64, 260)[..., :256], x, 4, 0.125, None),
        "k base not 16-byte aligned": (x, misaligned, x, 4, 0.125, None),
        "v keys disagree": (x, x, bf16(32, 256), 4, 0.125, None),
        "non-positive scale": (x, x, x, 4, 0.0, None),
        "block_q not instantiated": (x, x, x, 4, 0.125, 256),
    }
    return cases[case]


@pytest.mark.parametrize("case", [
    "head dim 40", "head dim 48", "q fp32",
    "k fp32 (the prologue reads bf16)",
    "k row stride not a multiple of 8", "k base not 16-byte aligned", "v keys disagree",
    "non-positive scale", "block_q not instantiated"])
def test_int8_attention_refuses_before_build(case, monkeypatch):
    """What K9 and its prologue refuse raises ValueError in the wrapper,
    before the extension is built or a launch is queued: no fallback."""
    from prompt_diffusion_tpu_torch.ops import _build

    def built():
        raise AssertionError("the extension was built")

    monkeypatch.setattr(_build, "cuda_ext", built)
    q, k, v, heads, scale, block_q = _int8_refused(case)
    with pytest.raises(ValueError):
        if block_q is None:
            fa._int8_launch(q, k, v, heads, scale)
        else:  # the parent `int8_attn_kernel`, through its own launch
            fa._int8_parent_launch(q, k, v, heads, scale, False, block_q)


def test_int8_attention_scheme_error_with_k_outlier():
    """The scheme's own error against exact attention stays below 2e-2
    relative L2 with a K outlier row, which inflates the per-head scale
    (tests/test_flash_padding.py bounds the JAX scheme the same way)."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(_normal(rng, (1, 96, 64), 0.5)) for _ in range(3))
    k[0, 7] *= 4.0
    got = flash_attention_packed_int8(q, k, v, 2)
    exact = _packed_ref(q, k, v, 2, 32 ** -0.5)
    rel = ((got - exact).norm() / exact.norm()).item()
    assert 1e-4 < rel < 2e-2, rel


# ---- T5 ------------------------------------------------------------------


@pytest.mark.parametrize("length", [1, 7, 77, 256, 300])
def test_relative_position_bucket_equals_jax(length):
    pos = np.arange(length)
    rel = pos[None, :] - pos[:, None]
    ref = np.asarray(jt5._relative_position_bucket(jnp.asarray(rel, jnp.int32), 32, 128))
    got = _relative_position_bucket(torch.from_numpy(rel), 32, 128)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_t5_encoder_matches_jax():
    """A tiny T5 encoder at fp32 within 1e-5 of JAX."""
    jm = jt5.T5Encoder(config=jt5.T5Config(**TINY_T5), policy=j_fp32_policy())
    ids = np.random.default_rng(3).integers(0, 50, (2, 11)).astype(np.int32)
    params = randomize(jax.eval_shape(jm.init, KEY, jnp.asarray(ids)), 4)
    ref = np.asarray(jm.apply(params, jnp.asarray(ids)))
    port = T5Encoder(T5Config(**TINY_T5), fp32_policy())
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    assert port.blocks_0.attn.relative_attention_bias is not None
    assert port.blocks_1.attn.relative_attention_bias is None
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


# ---- CLIP-bigG (gelu) and the penultimate layer -------------------------


def test_gelu_clip_hidden_layer_matches_jax():
    jm = jclip.CLIPTextModel(config=jclip.CLIPTextConfig(**TINY_CLIP_G), policy=j_fp32_policy())
    ids = np.random.default_rng(5).integers(0, 99, (2, 77)).astype(np.int32)
    ids[:, 9] = 99  # end-of-text
    params = randomize(jax.eval_shape(jm.init, KEY, jnp.asarray(ids)), 6)
    ref = jm.apply(params, jnp.asarray(ids), output_hidden_layer=2)
    port = CLIPTextModel(CLIPTextConfig(**TINY_CLIP_G), fp32_policy())
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(ids), output_hidden_layer=2)
        assert port(torch.from_numpy(ids))["hidden"] is None
    for name in ("hidden", "pooled", "last_hidden_state"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), atol=1e-5)


# ---- flow matching and the control window --------------------------------


@pytest.mark.parametrize("steps,shift", [(28, 3.0), (8, 3.0), (3, 1.0), (50, 2.5)])
def test_inference_sigmas_equal_jax(steps, shift):
    ts, sig = fm.make_inference_sigmas(steps, shift=shift)
    jts, jsig = jfm.make_inference_sigmas(steps, shift=shift)
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_array_equal(sig, jsig)
    assert len(sig) == steps + 1 and sig[-1] == 0.0


def test_flow_match_step_and_loop_exact():
    rng = np.random.default_rng(7)
    x, v = _normal(rng, (2, 4, 8, 8)), _normal(rng, (2, 4, 8, 8))
    _, sig = jfm.make_inference_sigmas(8)
    s32 = jnp.asarray(sig, jnp.float32)
    for i in range(8):
        ref = jfm.flow_match_step(jnp.asarray(x), jnp.asarray(v), s32[i], s32[i + 1])
        got = fm.flow_match_step(torch.from_numpy(x), torch.from_numpy(v), sig[i], sig[i + 1])
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # a linear velocity field: the loop is the steps in order
    vel = lambda x, t: x * 0.5 + t[:, None, None, None] / 1000
    ref = jfm.flow_match_sample_loop(vel, jnp.asarray(x), 4)
    got = fm.flow_match_sample_loop(vel, torch.from_numpy(x), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_control_window_equals_jax():
    for n, start, end in ((28, 0.0, 1.0), (28, 0.1, 0.7), (10, 0.3, 0.6), (7, 1 / 7, 6 / 7)):
        for i in range(n):
            assert win.control_keep(i, n, start, end) == float(jwin.control_keep(i, n, start, end))
    assert win.is_default_window(0, 1.0) and not win.is_default_window(0.0, 0.9)
    for start, end in ((0.5, 0.5), (-0.1, 0.5), (0.2, 1.5)):
        with pytest.raises(ValueError):
            win.validate_window(start, end)
