"""PyTorch port, ops: each kernel's plain version against the JAX package's
kernel (Pallas in interpret mode on the CPU), the dispatch rules, and the
DDIM tables. Inputs come from numpy seeds; tolerances are fp32 ones."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from prompt_diffusion_tpu.ops import flash_attention as jfa
from prompt_diffusion_tpu.ops.fused_group_norm import fused_group_norm as j_fused_gn
from prompt_diffusion_tpu.ops.fused_layer_norm import fused_layer_norm as j_fused_ln
from prompt_diffusion_tpu.schedulers.ddim import DDIMTables as JDDIMTables
from prompt_diffusion_tpu.schedulers.schedules import DiffusionSchedule as JSchedule
from prompt_diffusion_tpu_torch.ops import dispatch
from prompt_diffusion_tpu_torch.ops import flash_attention as fa
from prompt_diffusion_tpu_torch.ops.attention import _flash_eligible, dot_product_attention
from prompt_diffusion_tpu_torch.ops.flash_attention import flash_attention, flash_attention_packed
from prompt_diffusion_tpu_torch.ops.fused_group_norm import fused_group_norm, group_norm_auto
from prompt_diffusion_tpu_torch.ops.fused_layer_norm import fused_layer_norm, layer_norm_auto
from prompt_diffusion_tpu_torch.schedulers.ddim import DDIMTables
from prompt_diffusion_tpu_torch.schedulers.schedules import DiffusionSchedule

torch.set_num_threads(2)


def _normal(rng, shape, mean=0.0):
    return (rng.normal(size=shape) + mean).astype(np.float32)


def test_flash_attention_packed_plain_matches_pallas():
    rng = np.random.default_rng(0)
    b, n, h, d = 2, 1024, 4, 40
    q, k, v = (_normal(rng, (b, n, h * d)) for _ in range(3))
    ref = jfa.flash_attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h)
    got = flash_attention_packed(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), h)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-3)


@pytest.mark.parametrize("shape", [(2, 1024, 2, 64), (1, 1100, 1, 128)])
def test_flash_attention_plain_matches_pallas(shape):
    """(B, N, H, D) kernel K2; N=1100 takes the JAX kernel's Nq padding."""
    rng = np.random.default_rng(1)
    q, k, v = (_normal(rng, shape) for _ in range(3))
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-3)


@pytest.mark.parametrize("d,tile", [(40, (128, 64)), (80, (128, 64)), (512, (64, 32))])
def test_kernel_tile_per_head_dim(d, tile):
    """K1's tile at the SD1.5 heads (64² and 32² latents) and K2's at the
    VAE's D = 512, each one the kernel instantiates."""
    assert fa.kernel_tile(d) == tile
    assert tile in (fa.LAB_TILES if d <= fa.NARROW_D else (fa.WIDE_TILE,))


def _refused(case):
    """(q, scale, mode, tile) for each input the attention kernel refuses."""
    bf16 = lambda d: torch.zeros(1, 64, 1, d, dtype=torch.bfloat16)
    cases = {
        "head dim not a multiple of 8": (bf16(36), "online", None),
        "head dim above 512": (bf16(520), "online", None),
        "fp32": (torch.zeros(1, 64, 1, 40), "online", None),
        "row stride not a multiple of 8": (bf16(44)[..., :40], "online", None),
        "base not 16-byte aligned": (
            torch.zeros(64 * 40 + 1, dtype=torch.bfloat16)[1:].view(1, 64, 1, 40), "online", None),
        "lab mode above D = 128": (bf16(256), "two_pass", (64, 64)),
        "wide tile other than (64, 32)": (bf16(512), "online", (64, 64)),
        "narrow tile not instantiated": (bf16(40), "online", (256, 64)),
    }
    if case == "non-positive scale":
        return bf16(40), 0.0, "online", None
    q, mode, tile = cases[case]
    return q, 1.0, mode, tile


@pytest.mark.parametrize("case", [
    "head dim not a multiple of 8", "head dim above 512", "fp32", "row stride not a multiple of 8",
    "base not 16-byte aligned", "lab mode above D = 128", "wide tile other than (64, 32)",
    "narrow tile not instantiated", "non-positive scale"])
def test_attention_kernel_refuses_before_build(case, monkeypatch):
    """What the CUDA kernel refuses raises ValueError in the wrapper, before
    the extension is built or a launch is queued."""
    from prompt_diffusion_tpu_torch.ops import _build

    def built():
        raise AssertionError("the extension was built")

    monkeypatch.setattr(_build, "cuda_ext", built)
    q, scale, mode, tile = _refused(case)
    with pytest.raises(ValueError):
        if tile is None:
            fa._launch(q, q, q, scale)
        else:
            fa._parent_launch(q, q, q, scale, mode, tile)


# the epilogue: False none, True SiLU, "relu" ReLU (the MiDaS backbone's)
@pytest.mark.parametrize("act", [False, True, "relu"])
@pytest.mark.parametrize("shape,eps,mean", [
    ((2, 16, 16, 32), 1e-5, 0.0),     # one-pass Pallas kernel
    ((1, 1024, 64, 32), 1e-5, 0.0),   # 8.4 MB row: two-pass Pallas kernel
    ((2, 16, 16, 32), 1e-6, 3.0),     # VAE eps, large-mean activation
])
def test_group_norm_plain_matches_pallas(shape, eps, mean, act):
    rng = np.random.default_rng(2)
    x = _normal(rng, shape, mean)
    s, bias = _normal(rng, (shape[-1],)), _normal(rng, (shape[-1],))
    silu, relu = act is True, act == "relu"
    ref = j_fused_gn(jnp.asarray(x), jnp.asarray(s), jnp.asarray(bias), 8, eps, silu, relu)
    got = fused_group_norm(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(s),
                           torch.from_numpy(bias), 8, eps, silu, relu)
    if relu:
        assert (got >= 0).all() and (got == 0).float().mean() > 0.3
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=2e-5)


def test_layer_norm_plain_matches_pallas():
    rng = np.random.default_rng(5)
    x = _normal(rng, (2, 1024, 320))
    s, b = _normal(rng, (320,)), _normal(rng, (320,))
    ref = j_fused_ln(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 1e-5)
    got = fused_layer_norm(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("steps", [50, 30])
def test_ddim_tables_bit_equal(steps):
    """S=30 does not divide 1000: the table has 34 entries in both."""
    ref = JDDIMTables.create(JSchedule.create(), steps)
    got = DDIMTables.create(DiffusionSchedule.create(), steps)
    for name in ("timesteps", "alphas", "alphas_prev", "sqrt_one_minus_alphas", "sigmas"):
        r, g = np.asarray(getattr(ref, name)), getattr(got, name)
        assert r.dtype == g.dtype and r.shape == g.shape, name
        np.testing.assert_array_equal(g, r, err_msg=name)
    np.testing.assert_array_equal(DiffusionSchedule.create().alphas_cumprod,
                                  np.asarray(JSchedule.create().alphas_cumprod))


def test_eta_tables_match():
    ref = JDDIMTables.create(JSchedule.create(), 20, eta=0.5)
    got = DDIMTables.create(DiffusionSchedule.create(), 20, eta=0.5)
    np.testing.assert_array_equal(got.sigmas, np.asarray(ref.sigmas))


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU every wrapper runs its plain version and counts no launch."""
    rng = np.random.default_rng(6)
    before = (flash_attention.launches, flash_attention_packed.launches,
              fused_group_norm.launches, fused_layer_norm.launches)
    x = torch.from_numpy(_normal(rng, (1, 64, 64, 64))).permute(0, 3, 1, 2)
    w = torch.ones(64)
    group_norm_auto(x, 32, w, torch.zeros(64))  # 2^18 elements: the kernel rule holds
    layer_norm_auto(torch.from_numpy(_normal(rng, (1, 1024, 128))), torch.ones(128),
                    torch.zeros(128))
    q = torch.from_numpy(_normal(rng, (1, 1024, 1, 16)))
    dot_product_attention(q, q, q)
    flash_attention_packed(q.flatten(-2), q.flatten(-2), q.flatten(-2), 1)
    after = (flash_attention.launches, flash_attention_packed.launches,
             fused_group_norm.launches, fused_layer_norm.launches)
    assert after == before


def test_flash_eligibility_rule():
    q = torch.zeros(1, 1024, 1, 8)
    short = torch.zeros(1, 77, 1, 8)
    assert _flash_eligible(q, q, None)
    assert not _flash_eligible(q, short, None)  # cross-attention to 77 tokens
    assert not _flash_eligible(short, q, None)
    assert not _flash_eligible(q, q, torch.ones(1, 1, 1024, 1024, dtype=torch.bool))
    with pytest.raises(ValueError, match="mask"):
        dot_product_attention(q, q, q, mask=torch.ones(1024, 1024, dtype=torch.bool),
                              use_flash=True)


def test_masked_attention_matches_jax():
    from prompt_diffusion_tpu.ops.attention import dot_product_attention as j_dpa

    rng = np.random.default_rng(7)
    q, k, v = (_normal(rng, (2, 9, 3, 8)) for _ in range(3))
    mask = np.tril(np.ones((9, 9), bool))
    ref = j_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask))
    got = dot_product_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_plain_ops_context_and_unknown_device():
    assert not dispatch._plain_on_cuda
    with dispatch.plain_ops():
        assert dispatch._plain_on_cuda
    assert not dispatch._plain_on_cuda
    with pytest.raises(ValueError, match="device"):
        dispatch.use_kernel(torch.empty(1, device="meta"))
