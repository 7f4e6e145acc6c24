"""K8's tile and split-K plan (`ops/int8_conv.py::conv_plan`), a plain
emulation of the split sums against the TPU kernel, the wrapper's refusals
before any build, and the launch counters on the CPU.

The kernels themselves run only on the card (`chip_smoke.py`,
`tools/conv_tune.py --part check`); these tests hold what surrounds them:
the plan each SD1.5 site gets, that its K ranges add up to the whole
reduction, and that summing int32 partials over those ranges and then
applying the epilogue gives the JAX kernel's bits.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prompt_diffusion_tpu.ops.int8_conv import conv3x3_int8 as j_conv3x3_int8
from prompt_diffusion_tpu_torch.ops import _build
from prompt_diffusion_tpu_torch.ops import int8_conv as ic

# The 3x3 stride-1 int8 conv sites of one SD1.5 denoise step (UNet and
# ControlNet encoder at the 64x64 latent of 512² images) as (H, Cin, Cout)
# with their count, 69 in all, and the int8 VAE decoder's at 512²
# (conv_in, mid and up blocks, conv_out).
UNET_SITES = {(64, 4, 320): 2, (64, 320, 320): 11, (64, 640, 320): 2, (64, 960, 320): 1,
              (64, 640, 640): 1, (32, 320, 640): 2, (32, 640, 640): 9, (32, 960, 640): 1,
              (32, 1280, 640): 1, (32, 1920, 640): 1, (32, 1280, 1280): 1,
              (16, 640, 1280): 2, (16, 1280, 1280): 10, (16, 1920, 1280): 1,
              (16, 2560, 1280): 2, (8, 1280, 1280): 19, (8, 2560, 1280): 3}
VAE_SITES = ((64, 4, 512), (64, 512, 512), (128, 512, 512), (256, 512, 256), (256, 256, 256),
             (512, 256, 128), (512, 128, 128), (512, 128, 3))
# CFG batch 4 and 8 (requests of batch 2 and 4), and one image
BATCHES = (1, 4, 8)
SITES = [(b, h, h, cin, cout) for b in BATCHES for (h, cin, cout) in UNET_SITES] + [
    (2, h, h, cin, cout) for (h, cin, cout) in VAE_SITES]


def test_sd15_step_has_69_sites_of_1_97_tera_ops():
    """The site list above: 69 convs per step, 1.97 T int8 operations at CFG
    batch 4 (2 * M * Cout * 9 * Cin each)."""
    assert sum(UNET_SITES.values()) == 69
    ops = sum(n * 2 * 4 * h * h * cout * 9 * cin for (h, cin, cout), n in UNET_SITES.items())
    assert 1.96e12 < ops < 1.98e12, ops


@pytest.mark.parametrize("variant", ic.VARIANTS)
@pytest.mark.parametrize("shape", SITES, ids=lambda s: "x".join(map(str, s)))
def test_every_sd15_site_has_a_plan_covering_k(shape, variant):
    """Each site gets a plan whose splits' K ranges cover 9 * Cin in whole
    16-byte chunks, in order, with no gap or overlap; no split is empty and
    the grid fits the launch limits."""
    b, h, w, cin, cout = shape
    plan = ic.conv_plan(*shape, variant=variant)
    assert 1 <= plan.splits <= ic.MAX_SPLITS
    assert plan.n_tiles == math.ceil(cout / ic.BLOCK_N) <= 65535
    assert plan.block_m in ic.BLOCK_MS and plan.m_tiles * plan.block_m >= b * h * w
    assert (plan.splits - 1) * plan.per_split < plan.stages <= plan.splits * plan.per_split
    ranges = sorted(r for split in plan.k_ranges() for r in split)
    assert all(lo < hi for lo, hi in ranges)
    assert ranges[0][0] == 0 and ranges[-1][1] == 9 * cin
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    if cin % 16 == 0:
        assert all(lo % 16 == 0 and hi % 16 == 0 for lo, hi in ranges)
    else:
        assert plan.splits == 1


@pytest.mark.parametrize("shape,variant,splits", [
    ((8, 8, 8, 1280, 1280), "im2col", 6), ((8, 8, 8, 1280, 1280), "xshift", 3),
    ((8, 8, 8, 2560, 1280), "im2col", 6), ((8, 8, 8, 2560, 1280), "xshift", 3),
    ((4, 8, 8, 1280, 1280), "im2col", 8), ((4, 16, 16, 1280, 1280), "im2col", 3),
    ((4, 16, 16, 1280, 1280), "xshift", 1), ((8, 16, 16, 1280, 1280), "im2col", 1),
    ((8, 64, 64, 320, 320), "im2col", 1), ((8, 64, 64, 4, 320), "im2col", 1),
    ((2, 512, 512, 128, 128), "xshift", 1)])
def test_split_only_where_tiles_fill_half_a_wave(shape, variant, splits):
    """Split-K where the output tiles fill at most half of the blocks the
    card holds at once (the 8x8 latents, 16x16 at CFG batch 4 under
    im2col), and not where they fill more."""
    plan = ic.conv_plan(*shape, variant=variant)
    assert plan.splits == splits
    if splits > 1:
        assert plan.per_split >= ic.MIN_STAGES_PER_SPLIT


@pytest.mark.parametrize("shape,variant,block_m", [
    ((8, 64, 64, 320, 320), "im2col", 128), ((8, 64, 64, 320, 320), "xshift", 256),
    ((8, 32, 32, 640, 640), "xshift", 256), ((8, 16, 16, 1280, 1280), "xshift", 128),
    ((8, 8, 8, 2560, 1280), "xshift", 128), ((8, 64, 64, 4, 320), "xshift", 128),
    ((2, 512, 512, 128, 128), "im2col", 128), ((2, 512, 512, 128, 128), "xshift", 128),
    ((4, 64, 64, 320, 320), "xshift", 256), ((1, 64, 64, 320, 320), "xshift", 128)])
def test_tall_tiles_where_they_fill_every_sm(shape, variant, block_m):
    """xshift takes 256-pixel tiles where they still fill all 132 SMs (not
    its 512-wide rows, not Cin % 16 != 0), 128 elsewhere; im2col always
    128."""
    assert ic.conv_plan(*shape, variant=variant).block_m == block_m


def test_forced_splits_are_cut_to_whole_stages():
    plan = ic.conv_plan(2, 8, 8, 48, 16, "xshift", splits=5)  # Cin 48: two 32-channel stages
    assert (plan.stages, plan.splits, plan.per_split) == (2, 2, 1)
    plan = ic.conv_plan(2, 8, 8, 64, 16, "im2col", splits=3)  # K 576: five 128-byte stages
    assert (plan.stages, plan.splits, plan.per_split) == (5, 3, 2)
    assert plan.k_ranges() == [[(0, 256)], [(256, 512)], [(512, 576)]]
    with pytest.raises(ValueError, match="splits"):
        ic.conv_plan(2, 8, 8, 64, 16, "im2col", splits=0)
    with pytest.raises(ValueError, match="variant"):
        ic.conv_plan(2, 8, 8, 64, 16, "winograd")


def _inputs(seed, b, h, w, cin, cout, with_bias):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8)
    wq = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)  # HWIO, as JAX takes it
    s_a = rng.uniform(0.01, 0.1, (b,)).astype(np.float32)
    s_w = rng.uniform(0.001, 0.01, (cout,)).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32) if with_bias else None
    return xq, s_a, wq, s_w, bias


@pytest.mark.parametrize("variant", ic.VARIANTS)
@pytest.mark.parametrize("shape,splits,with_bias,out_dtype", [
    ((2, 8, 8, 64, 32), 3, True, torch.bfloat16),
    ((3, 5, 8, 48, 72), 2, False, torch.float32),  # ragged: M, Cout and the last K stage
])
def test_split_sums_bit_equal_to_pallas(shape, splits, with_bias, out_dtype, variant):
    """The split-K data flow, emulated with plain ops: per split, the int32
    partial over its K ranges (`int8_matmul` of im2col column slices); the
    partials summed; the epilogue. Bit-equal to the JAX kernel in interpret
    mode, in the variant the plan is for."""
    b, h, w, cin, cout = shape
    xq, s_a, wq, s_w, bias = _inputs(sum(shape), *shape, with_bias)
    plan = ic.conv_plan(*shape, variant=variant, splits=splits)
    assert plan.splits > 1  # cut to whole stages: 2 for xshift's two 32-channel stages
    cols = ic.im2col3x3(torch.from_numpy(xq), 1)
    w2d = torch.from_numpy(wq.transpose(3, 0, 1, 2).reshape(cout, 9 * cin).copy())
    partials = [sum(ic.int8_matmul(cols[:, lo:hi].contiguous(), w2d[:, lo:hi].contiguous())
                    for lo, hi in split) for split in plan.k_ranges()]
    acc = torch.stack(partials).sum(0, dtype=torch.int32).view(b, h, w, cout)
    got = ic._epilogue(acc, torch.from_numpy(s_a), torch.from_numpy(s_w),
                       None if bias is None else torch.from_numpy(bias), out_dtype)
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    ref = j_conv3x3_int8(jnp.asarray(xq), jnp.asarray(s_a), jnp.asarray(wq), jnp.asarray(s_w),
                         None if bias is None else jnp.asarray(bias), out_dtype=jdt,
                         interpret=True, variant=variant)
    assert got.dtype == out_dtype and got.shape == (b, h, w, cout)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


def _refused(case):
    """(xq, s_a, wq, s_w, bias, out_dtype) for each call K8 refuses; the
    activation on the meta device stands in for a CUDA tensor."""
    meta = lambda *s, dt=torch.int8: torch.empty(s, dtype=dt, device="meta")
    xq, wq = meta(2, 8, 8, 32), meta(16, 3, 3, 32)
    s_a, s_w, bias = meta(2, dt=torch.float32), meta(16, dt=torch.float32), meta(16, dt=torch.float32)
    cases = {
        "int32 activation": (meta(2, 8, 8, 32, dt=torch.int32), s_a, wq, s_w, bias, torch.bfloat16),
        "float weight": (xq, s_a, meta(16, 3, 3, 32, dt=torch.float32), s_w, bias, torch.bfloat16),
        "weight Cin differs": (xq, s_a, meta(16, 3, 3, 16), s_w, bias, torch.bfloat16),
        "1x1 weight": (xq, s_a, meta(16, 1, 1, 32), s_w, bias, torch.bfloat16),
        "activation not NHWC 4-d": (meta(2, 64, 32), s_a, wq, s_w, bias, torch.bfloat16),
        "fp16 output": (xq, s_a, wq, s_w, bias, torch.float16),
        "Cout past the grid": (xq, s_a, meta(65535 * 128 + 1, 3, 3, 32),
                               meta(65535 * 128 + 1, dt=torch.float32), None, torch.bfloat16),
        "s_a on the CPU": (xq, torch.ones(2), wq, s_w, bias, torch.bfloat16),
        "s_a per pixel": (xq, meta(2, 8, 8, dt=torch.float32), wq, s_w, bias, torch.bfloat16),
        "s_w of another length": (xq, s_a, wq, meta(8, dt=torch.float32), bias, torch.bfloat16),
        "bf16 bias": (xq, s_a, wq, s_w, meta(16, dt=torch.bfloat16), torch.bfloat16),
        "weight on the CPU": (xq, s_a, torch.zeros(16, 3, 3, 32, dtype=torch.int8), s_w, bias,
                              torch.bfloat16),
    }
    return cases[case]


@pytest.mark.parametrize("xshift", [False, True])
@pytest.mark.parametrize("case", [
    "int32 activation", "float weight", "weight Cin differs", "1x1 weight",
    "activation not NHWC 4-d", "fp16 output", "Cout past the grid", "s_a on the CPU",
    "s_a per pixel", "s_w of another length", "bf16 bias", "weight on the CPU"])
def test_wrapper_refuses_before_build(case, xshift, monkeypatch):
    """What K8 does not take raises ValueError in the wrapper, before the
    extension is built or a launch is queued: no fallback."""

    def built():
        raise AssertionError("the extension was built")

    monkeypatch.setattr(_build, "cuda_ext", built)
    with pytest.raises(ValueError):
        ic._launch(*_refused(case), xshift=xshift)


@pytest.mark.parametrize("variant", ic.VARIANTS)
def test_cpu_calls_count_no_launch(variant):
    """On the CPU both wrappers run the plain versions and count no launch,
    also at a shape whose plan splits K."""
    shape = (2, 8, 8, 256, 136)
    assert ic.conv_plan(*shape, variant=variant).splits > 1
    xq, s_a, wq, s_w, bias = (None if a is None else torch.from_numpy(a)
                              for a in _inputs(5, *shape, True))
    wq = wq.permute(3, 0, 1, 2).contiguous()
    before = (ic.conv3x3_int8.launches, ic.conv3x3_int8_xshift.launches)
    out = ic.conv3x3_int8(xq, s_a, wq, s_w, bias, variant=variant)
    assert out.shape == (2, 8, 8, 136)
    assert (ic.conv3x3_int8.launches, ic.conv3x3_int8_xshift.launches) == before


def test_profile_records_each_k8_site_once():
    """`profile_sd15.k8_calls` sees one K8 call per 3x3 stride-1 QuantConv of
    a tiny int8 UNet forward, with the activation's shape and Cout."""
    from prompt_diffusion_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15
    from prompt_diffusion_tpu_torch.ops.quant import QuantConv
    from prompt_diffusion_tpu_torch.tools.profile_sd15 import k8_calls
    from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy
    from tests.torch_port_util import TINY_UNET

    torch.manual_seed(0)
    unet = UNetSD15(UNetConfig(**TINY_UNET), DTypePolicy(compute_dtype=torch.float32, quant="int8"))
    sites = [m for m in unet.modules() if isinstance(m, QuantConv)
             and m.kernel_size == (3, 3) and m.stride == (1, 1)]
    x = torch.randn(2, 4, 16, 16).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        calls = k8_calls(lambda: unet(x, torch.tensor([10, 500]), torch.randn(2, 7, 64)))
    assert sum(calls.values()) == len(sites) > 0
    assert {(2, 16, 16, 4, TINY_UNET["model_channels"])} <= set(calls)
    assert all(k[0] == 2 and k[4] in {m.out_channels for m in sites} for k in calls)
