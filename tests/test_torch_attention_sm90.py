"""PyTorch port, the warpgroup attention kernels of
`ops/csrc/attention_sm90.cuh` (K1, K2 at D <= 128, K9, and the lab modes
L1, L2, L3 and L4 of `attention_sm90_lab.cu`, `_lab_two_pass.cu`) on the
CPU: the route
`attention_route` states by mode, head dimension and dtype, the plans
(tiles, warpgroups, shared memory, the zero pads at D = 40 and 80) and the
TMA tensor maps at the paths' shapes, the refusals before any build, the
arguments the lab wrappers hand the extension, and a torch emulation of
the kernel's order of work (64-, 112- or 128-key tiles, P rounded to bf16
against the running maximum, O rescaled when a row maximum of a warp's 16
rows moved, one division at the end; the two-pass mode's exact row maximum
first and no rescale; the no-softmax mode's scaled logits rounded to bf16
and summed tile by tile; the per-row-K mode's key scale in each logit
before the row maximum) held against the JAX package's
`flash_attention_packed`, `flash_attention` and
`flash_attention_packed_int8` kernels and the JAX labs' `_online_kernel`,
`_fullk_kernel` and `attn_int8_v2` in interpret mode. The kernels themselves run only on
the card (`chip_smoke.py`, `tools/attn_tune.py --part sm90|lab`)."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prompt_diffusion_tpu.ops import flash_attention as jflash
from prompt_diffusion_tpu_torch.ops import _build
from prompt_diffusion_tpu_torch.ops import flash_attention as fa
from tests.torch_port_util import jax_int8_attention as _jax_int8_attention
from tests.torch_port_util import jax_lab, jax_lab_bhnd

torch.set_num_threads(2)

LOG2E = 1.4426950408889634


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _f32(x):
    return np.float32(x)


# ---- the route -------------------------------------------------------------


@pytest.mark.parametrize("mode,d,route", [
    ("online", 40, "sm90"), ("online", 64, "sm90"), ("online", 80, "sm90"),
    ("online", 128, "sm90"),
    # head dims the sm90 kernel does not instantiate stay on the parent
    ("online", 32, "narrow"), ("online", 8, "narrow"), ("online", 48, "narrow"),
    ("online", 96, "narrow"),
    # above 128 the wide kernel; the VAE's 512 its wide sm90 successor
    ("online", 160, "wide"), ("online", 512, "wide_sm90"),
    # L1, L2 and L3 run the sm90 kernel at the head dims it instantiates for
    # them; elsewhere only the parent has them (`_parent_launch`)
    ("tiled", 40, "sm90"), ("tiled", 64, "narrow"), ("tiled", 80, "narrow"),
    ("tiled", 128, "narrow"), ("no_softmax", 40, "sm90"), ("no_softmax", 64, "narrow"),
    ("no_softmax", 128, "narrow"), ("two_pass", 40, "sm90"), ("two_pass", 64, "sm90"),
    ("two_pass", 80, "narrow"), ("two_pass", 128, "sm90"),
    ("int8", 32, "int8_sm90"), ("int8", 64, "int8_sm90"), ("int8", 128, "int8_sm90"),
    # SD1.5's heads under `int8_attention`: 64² and 32² self-attention
    ("int8", 40, "int8_sm90"), ("int8", 80, "int8_sm90"),
    # L4 on the sm90 int8 kernel at D = 64; elsewhere only the parent
    # (`_int8_parent_launch`)
    ("int8_rowk", 64, "int8_sm90"), ("int8_rowk", 32, "int8_parent"),
    ("int8_rowk", 128, "int8_parent"),
])
def test_attention_route(mode, d, route):
    """One function states which kernel a call on the card runs."""
    assert fa.attention_route(mode, d, torch.bfloat16) == route


@pytest.mark.parametrize("mode,d,dtype", [
    ("online", 40, torch.float32), ("online", 64, torch.float16), ("int8", 64, torch.float32),
    ("int8", 48, torch.bfloat16), ("int8", 96, torch.bfloat16), ("packed", 64, torch.bfloat16),
    ("int8", 160, torch.bfloat16),  # SD1.5's 16² and 8² heads stay on the plain path
])
def test_attention_route_refuses(mode, d, dtype):
    """The kernels read bf16; K9 takes D 32, 40, 64, 80, 128; modes are
    named."""
    with pytest.raises(ValueError):
        fa.attention_route(mode, d, dtype)


def _no_build(monkeypatch):
    def built():
        raise AssertionError("the extension was built")

    monkeypatch.setattr(_build, "cuda_ext", built)


def _as_if_on_the_card(monkeypatch):
    """The launches' device context without a card: a CPU tensor then
    reaches the point where the kernel's extension is asked for."""
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())


def _record_sm90(monkeypatch):
    calls = []

    def fake(q, k, v, scale, sk=None):
        calls.append((tuple(q.shape), sk is not None))
        return torch.zeros(q.shape, dtype=torch.bfloat16)

    monkeypatch.setattr(fa, "_sm90_launch", fake)
    return calls


@pytest.mark.parametrize("d,sm90", [(40, True), (64, True), (80, True), (128, True),
                                    (32, False), (512, "wide")])
def test_launch_takes_the_route(d, sm90, monkeypatch):
    """K1's and K2's launch goes to the sm90 kernel at its head dims, to
    the wide sm90 kernel at D = 512 and to `flash_attention.cu` elsewhere;
    the parent's explicit launch (a mode and a tile) always to
    `flash_attention.cu`."""
    _no_build(monkeypatch)
    _as_if_on_the_card(monkeypatch)
    calls = _record_sm90(monkeypatch)
    wide = []
    monkeypatch.setattr(fa, "_wide_launch", lambda q, k, v, scale: wide.append(
        tuple(q.shape)) or torch.zeros(q.shape, dtype=torch.bfloat16))
    q = torch.zeros(1, 64, 2, d, dtype=torch.bfloat16)
    if sm90 == "wide":
        fa._launch(q, q, q, 0.125)
        assert wide == [(1, 64, 2, d)] and calls == []
        with pytest.raises(AssertionError, match="extension was built"):
            fa._parent_launch(q, q, q, 0.125, "online", fa.WIDE_TILE)
        assert len(wide) == 1
    elif sm90:
        fa._launch(q, q, q, 0.125)
        assert calls == [((1, 64, 2, d), False)]
    else:
        with pytest.raises(AssertionError, match="extension was built"):
            fa._launch(q, q, q, 0.125)
        assert calls == []
    if d <= fa.NARROW_D:
        with pytest.raises(AssertionError, match="extension was built"):
            fa._parent_launch(q, q, q, 0.125, "online", fa.NARROW_TILE)
        assert len(calls) == (1 if sm90 else 0)


@pytest.mark.parametrize("hd,h", [(256, 4), (320, 8), (640, 8)])
def test_int8_launch_takes_the_route(hd, h, monkeypatch):
    """K9 (per-head K) goes to the sm90 kernel after K9p
    (`_int8_sm90_launch`), at SD1.5's D = 40 and 80 too; per-row K (L4) to
    the sm90 kernel's per-row-K mode (`_int8_rowk_sm90_launch`), at D = 64
    only; the parent `int8_attn_kernel` only through its own launch
    (`_int8_parent_launch`, which takes neither 40 nor 80)."""
    _no_build(monkeypatch)
    _as_if_on_the_card(monkeypatch)
    calls, rowk = [], []
    monkeypatch.setattr(fa, "_int8_sm90_launch", lambda q, k, v, heads, scale: calls.append(
        (tuple(q.shape), heads)) or torch.zeros(q.shape, dtype=torch.bfloat16))
    x = torch.zeros(1, 64, hd, dtype=torch.bfloat16)
    out = fa._int8_launch(x, x, x, h, 0.125)
    assert out.shape == (1, 64, hd) and calls == [((1, 64, hd), h)]
    with pytest.raises(AssertionError if hd == 256 else ValueError,
                       match="extension was built" if hd == 256 else "head dim"):
        fa._int8_launch(x, x, x, h, 0.125, row_k=True)
    monkeypatch.setattr(fa, "_int8_rowk_sm90_launch", lambda q, k, v, heads, scale: rowk.append(
        (tuple(q.shape), heads)) or torch.zeros(q.shape, dtype=torch.bfloat16))
    fa._int8_launch(x, x, x, h, 0.125, row_k=True)
    assert rowk == [((1, 64, hd), h)]
    for row_k in (False, True):
        with pytest.raises(AssertionError if hd == 256 else ValueError,
                           match="extension was built" if hd == 256 else "head dim"):
            fa._int8_parent_launch(x, x, x, h, 0.125, row_k, 64)
    assert len(calls) == 1


@pytest.mark.parametrize("hd,h", [(320, 8), (640, 8), (1536, 24), (120, 3)])
def test_int8_sm90_launch_reaches_the_build(hd, h, monkeypatch):
    """K9's inputs at SD1.5's 64² and 32² heads, the SD3 joint attention
    and three heads of 40 pass every check of `_int8_sm90_launch` and
    reach the build (its refusals are not vacuous)."""
    _no_build(monkeypatch)
    x = torch.zeros(2, 64, hd, dtype=torch.bfloat16)
    with pytest.raises(AssertionError, match="extension was built"):
        fa._int8_sm90_launch(x, x, x, h, 0.125)


class _FakeExt:
    """The extension's lab and parent attention entries and the per-row
    prologue, recording the arguments each call hands them."""

    def __init__(self):
        self.calls = []

    def attention_sm90_lab_fwd(self, *args):
        self.calls.append(("lab", args))

    def flash_attention_fwd(self, *args):
        self.calls.append(("parent", args))

    def int8_quant_k_rows(self, *args):
        self.calls.append(("rows", args))

    def int8_attention_fwd(self, *args):
        self.calls.append(("int8 parent", args))


def _fake_card(monkeypatch):
    """CPU tensors taken as on the card by the wrappers, with the extension
    replaced by a `_FakeExt` and the current stream by stream 0."""
    _as_if_on_the_card(monkeypatch)
    ext = _FakeExt()
    monkeypatch.setattr(_build, "cuda_ext", lambda: ext)
    monkeypatch.setattr(fa, "use_kernel", lambda t: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: type("Stream", (), {"cuda_stream": 0})())
    return ext


LAB_LAUNCHES = [  # (wrapper, mode code, D, tiles): every instantiation of the bf16 lab modes
    *(("tiled", 0, 40, tile) for tile in fa.SM90_LAB_TILES),
    *(("no_softmax", 1, 40, tile) for tile in fa.SM90_LAB_TILES),
    *(("two_pass", 2, d, tile) for d in (40, 64) for tile in fa.SM90_LAB_TILES),
    ("two_pass", 2, 128, (128, 64)), ("two_pass", 2, 128, (128, 128)),
]
LAB_WRAPPERS = {"tiled": fa.flash_attention_tiled, "no_softmax": fa.attention_no_softmax,
                "two_pass": fa.flash_attention_two_pass}


@pytest.mark.parametrize("mode,code,d,tile", LAB_LAUNCHES)
def test_lab_wrappers_reach_the_sm90_launch(mode, code, d, tile, monkeypatch):
    """On the card L1, L2 and L3 hand the lab entry of the sm90 kernel
    their views (strides of (B, N, H, D) views of (B, H, N, D) memory, as
    the lab's BHND inputs), no key scales, the mode, and the plan's
    consumers and key tile; each call counts one launch; the parent is not
    called."""
    ext = _fake_card(monkeypatch)
    wrapper = LAB_WRAPPERS[mode]
    b, n, h = 2, 96, 3
    q, k, v = (torch.zeros(b, h, n, d, dtype=torch.bfloat16).transpose(1, 2) for _ in range(3))
    before = wrapper.launches
    out = wrapper(q, k, v, 0.2, *tile)
    assert out.shape == (b, n, h, d) and wrapper.launches == before + 1
    ((kind, args),) = ext.calls
    plan = fa.sm90_lab_plan(d, mode, tile)
    assert kind == "lab" and (plan.block_q, plan.block_k) == tile
    assert args[2:4] == (0, 0)
    assert args[6:11] == (b, h, n, n, d)
    assert args[11:14] == q.stride()[:3] == (h * n * d, d, n * d)
    assert args[23:] == (pytest.approx(0.2), code, plan.consumers, plan.block_k, 0)


@pytest.mark.parametrize("mode,d", [("tiled", 40), ("no_softmax", 40), ("two_pass", 40),
                                    ("two_pass", 64), ("two_pass", 128)])
def test_lab_wrappers_default_to_k1s_tile(mode, d, monkeypatch):
    """Without a tile L1, L2 and L3 run K1's plan at their D: three
    consumers at D <= 64, two above, 128-key tiles."""
    ext = _fake_card(monkeypatch)
    wrapper = LAB_WRAPPERS[mode]
    q = torch.zeros(1, 64, 2, d, dtype=torch.bfloat16)
    wrapper(q, q, q, 0.2)
    k1 = fa.sm90_plan(d)
    assert ext.calls[0][1][-3:-1] == (k1.consumers, k1.block_k) == (
        fa.sm90_consumers(d, False), 128)


def _lab_refused(case):
    """(wrapper, q, k, v, tile) for each input the lab modes refuse on the
    card."""
    bf16 = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)
    x40, x128 = bf16(2, 64, 2, 40), bf16(2, 64, 2, 128)
    tiled, two_pass = fa.flash_attention_tiled, fa.flash_attention_two_pass
    no_softmax = fa.attention_no_softmax
    return {
        "L2 at D = 64": (no_softmax, bf16(2, 64, 2, 64), None, None, None),
        "L2 at D = 128": (no_softmax, x128, None, None, None),
        "L2 at a parent tile": (no_softmax, x40, None, None, (64, 64)),
        "L2 fp32": (no_softmax, x40.float(), None, None, None),
        "L1 at D = 64": (tiled, bf16(2, 64, 2, 64), None, None, None),
        "L1 at D = 80": (tiled, bf16(2, 64, 2, 80), None, None, None),
        "L3 at D = 80": (two_pass, bf16(2, 64, 2, 80), None, None, None),
        "L3 at D = 32": (two_pass, bf16(2, 64, 2, 32), None, None, None),
        "L3 on three consumers at D = 128": (two_pass, x128, None, None, (192, 128)),
        "L3 on three consumers at D = 128, 64 keys": (two_pass, x128, None, None, (192, 64)),
        "L1 at a parent tile": (tiled, x40, None, None, (64, 64)),
        "L3 at a parent tile": (two_pass, x40, None, None, (128, 32)),
        "L3 fp32": (two_pass, x40.float(), None, None, None),
        "L1 k batch broadcast": (tiled, x40, bf16(1, 64, 2, 40).expand(2, 64, 2, 40), None, None),
        "L3 v row stride not 16 bytes": (two_pass, x40, None, bf16(2, 64, 2, 44)[..., :40], None),
        "L3 q base misaligned": (two_pass, torch.zeros(2 * 64 * 80 + 1, dtype=torch.bfloat16)[1:]
                                 .view(2, 64, 2, 40), None, None, None),
    }[case]


LAB_REFUSALS = ["L2 at D = 64", "L2 at D = 128", "L2 at a parent tile", "L2 fp32",
                "L1 at D = 64", "L1 at D = 80", "L3 at D = 80", "L3 at D = 32",
                "L3 on three consumers at D = 128", "L3 on three consumers at D = 128, 64 keys",
                "L1 at a parent tile", "L3 at a parent tile", "L3 fp32", "L1 k batch broadcast",
                "L3 v row stride not 16 bytes", "L3 q base misaligned"]


@pytest.mark.parametrize("case", LAB_REFUSALS)
def test_lab_refuses_before_build(case, monkeypatch):
    """What the lab modes' sm90 instantiations do not take raises
    ValueError on the card before the extension is built: no fallback to
    the parent or to the plain version, and no launch counted."""
    _as_if_on_the_card(monkeypatch)
    _no_build(monkeypatch)
    monkeypatch.setattr(fa, "use_kernel", lambda t: True)
    monkeypatch.setattr(fa, "_parent_launch", lambda *a: pytest.fail("the parent ran"))
    monkeypatch.setattr(fa, "_torch_attention", lambda *a: pytest.fail("the plain version ran"))
    monkeypatch.setattr(fa, "_torch_attention_no_softmax",
                        lambda *a: pytest.fail("the plain version ran"))
    wrapper, q, k, v, tile = _lab_refused(case)
    before = wrapper.launches
    with pytest.raises(ValueError):
        wrapper(q, q if k is None else k, q if v is None else v, 0.2,
                *(tile if tile else (None, None)))
    assert wrapper.launches == before


@pytest.mark.parametrize("mode,code,tile", [("online", 0, (128, 64)), ("two_pass", 2, (64, 64)),
                                            ("two_pass", 2, (128, 128)),
                                            ("no_softmax", 1, (64, 64))])
def test_parent_reachable_through_its_launch(mode, code, tile, monkeypatch):
    """The parent design's explicit launch: `flash_attention.cu` in any of
    its modes at a tile of LAB_TILES (the lab's `[parent]` rows,
    chip_smoke's parent times), counted in `_parent_launch.launches`; a
    tile of SM90_LAB_TILES only is refused before any build."""
    ext = _fake_card(monkeypatch)
    q = torch.zeros(2, 64, 2, 40, dtype=torch.bfloat16)
    before = fa._parent_launch.launches
    fa._parent_launch(q, q, q, 0.2, mode, tile)
    ((kind, args),) = ext.calls
    assert kind == "parent" and args[-4:] == (code, *tile, 0)
    assert fa._parent_launch.launches == before + 1
    _no_build(monkeypatch)
    with pytest.raises(ValueError, match="not instantiated"):
        fa._parent_launch(q, q, q, 0.2, mode, (192, 128))


# ---- the plan --------------------------------------------------------------


@pytest.mark.parametrize("d,int8,consumers,block_k,qk_depth,row_pad,qv_blocks,k_blocks,smem", [
    (40, False, 3, 128, 48, 24, 1, 1, 91136),    # SD1.5 64²: Q.K^T over 48, 40..63 zeros
    (64, False, 3, 128, 64, 0, 1, 1, 91136),     # ViT-B, UniFormer, MMDiT joint
    (80, False, 2, 128, 80, 48, 2, 2, 164864),   # SD1.5 32²: two column blocks, 80..127 zeros
    (128, False, 2, 128, 128, 0, 2, 2, 164864),
    (32, True, 3, 112, 32, 32, 1, 1, 82944),
    (64, True, 3, 112, 64, 0, 1, 1, 82944),      # K9 on the paths: codes' rows 64..127 zeros
    (128, True, 2, 128, 128, 0, 2, 1, 132096),
    (40, True, 3, 112, 64, 24, 1, 1, 82944),     # K9 at SD1.5 64²: Q.K^T over 64, two k32 steps
    (80, True, 2, 128, 96, 48, 2, 1, 132096),    # K9 at SD1.5 32²: three k32 steps
])
def test_sm90_plan(d, int8, consumers, block_k, qk_depth, row_pad, qv_blocks, k_blocks, smem):
    """A producer warpgroup and consumer warpgroups of 64 query rows each
    (three at D <= 64), 128-key tiles (112 for K9 on three consumers) in
    rings of 2 stages, tile rows of one 128-byte swizzle span, shared
    memory within the H100's 227 KB."""
    plan = fa.sm90_plan(d, int8)
    assert plan.consumers == consumers == fa.sm90_consumers(d, int8)
    assert (plan.block_q, plan.threads) == (64 * consumers, 128 * (1 + consumers))
    assert (plan.block_k, plan.stages) == (block_k, 2) and block_k % 16 == 0
    assert (plan.qk_depth, plan.row_pad, plan.qv_blocks, plan.k_blocks) == (
        qk_depth, row_pad, qv_blocks, k_blocks)
    assert plan.qk_depth % (32 if int8 else 16) == 0 and plan.pv_n == d and d % 8 == 0
    assert plan.smem == smem <= fa.SMEM_PER_BLOCK


@pytest.mark.parametrize("b,n,h,int8,grid", [
    (4, 4096, 8, False, (22, 32)),     # the paths' CFG batch 4 at 64²: 704 blocks of 192 rows
    (2, 4429, 24, False, (24, 48)),    # the MMDiT joint attention: 1,152
    (16, 1024, 5, False, (6, 80)),     # UniFormer stage 3: 480
    (16, 1025, 12, True, (6, 192)),    # the ViT-B under int8: 1,152 rows for 1,025
    (2, 4429, 24, True, (24, 48)),     # K9 at the SD3 joint attention
])
def test_sm90_grid(b, n, h, int8, grid):
    plan = fa.sm90_plan(64, int8)
    assert plan.grid(b, h, n) == grid


@pytest.mark.parametrize("d,int8,nq,consumers", [
    (64, True, 4429, 3),   # the SD3 joint attention: 4608 x 4480 padded on three, 4480² on two
    (64, True, 1025, 3),   # the DPT ViT-B: 1152 x 1120 on three, 1152² on two
    (64, True, 1024, 2),   # UniFormer: whole 128-tiles on two, 1152 x 1120 on three
    (64, True, 1100, 3),
    (32, True, 1024, 2),
    (128, True, 4429, 2),  # two above D = 64
    (64, False, 1024, 3),  # bf16 runs three at D <= 64 whatever the shape
    (40, False, 4096, 3),
    (80, False, 1024, 2),
    (40, True, 4096, 3),   # SD1.5 64²: 4224 x 4144 on three, 4096² on two (1.04x)
    (40, True, 1024, 2),   # 1152 x 1120 against 1024² (1.23x)
    (80, True, 1024, 2),   # two above D = 64
])
def test_sm90_consumers_per_shape(d, int8, nq, consumers):
    """K9 keeps two consumers where three would pad its work by more than
    SM90_INT8_THREE_CONSUMER_GAIN; the plan at two has 128-key tiles."""
    assert fa.sm90_consumers(d, int8, nq, nq) == consumers
    plan = fa.sm90_plan(d, int8, consumers)
    assert plan.block_q == 64 * consumers
    assert plan.block_k == (112 if int8 and consumers == 3 else 128)
    assert plan.smem <= fa.SMEM_PER_BLOCK


@pytest.mark.parametrize("d,int8,consumers", [(48, False, None), (96, False, None),
                                              (512, False, None), (48, True, None),
                                              (96, True, None), (64, False, 2), (128, True, 3),
                                              (64, True, 4), (80, True, 3), (160, True, None)])
def test_sm90_plan_refuses(d, int8, consumers):
    with pytest.raises(ValueError):
        fa.sm90_plan(d, int8, consumers)


@pytest.mark.parametrize("mode,d,tile,consumers,smem", [
    ("tiled", 40, (128, 64), 2, 50176), ("tiled", 40, (128, 128), 2, 82944),
    ("tiled", 40, (192, 64), 3, 58368), ("tiled", 40, (192, 128), 3, 91136),
    ("two_pass", 40, (128, 64), 2, 50176), ("two_pass", 40, (192, 128), 3, 91136),
    ("two_pass", 64, (128, 64), 2, 50176), ("two_pass", 64, (128, 128), 2, 82944),
    ("two_pass", 64, (192, 64), 3, 58368), ("two_pass", 64, (192, 128), 3, 91136),
    ("two_pass", 128, (128, 64), 2, 99328), ("two_pass", 128, (128, 128), 2, 164864),
    ("no_softmax", 40, (128, 64), 2, 50176), ("no_softmax", 40, (128, 128), 2, 82944),
    ("no_softmax", 40, (192, 64), 3, 58368), ("no_softmax", 40, (192, 128), 3, 91136),
])
def test_sm90_lab_plan(mode, d, tile, consumers, smem):
    """A lab tile of SM90_LAB_TILES is 64 query rows per consumer and 64 or
    128 keys; three consumers only at D <= 64; every plan within the H100's
    227 KB; at K1's tile the plan is K1's."""
    plan = fa.sm90_lab_plan(d, mode, tile)
    assert tile in fa.SM90_LAB_TILES
    assert (plan.block_q, plan.block_k, plan.consumers) == (*tile, consumers)
    assert plan.threads == 128 * (1 + consumers) and plan.stages == 2 and not plan.int8
    assert plan.smem == smem <= fa.SMEM_PER_BLOCK
    assert (consumers == 3) <= (d <= fa.SM90_WIDE_CONSUMERS_D)
    if tile == fa.sm90_lab_tile(d):
        k1 = fa.sm90_plan(d)
        assert (plan.block_q, plan.block_k, plan.smem) == (k1.block_q, k1.block_k, k1.smem)
        assert fa.sm90_lab_plan(d, mode) == plan


def test_sm90_lab_tiles_and_head_dims():
    """SM90_LAB_TILES: two or three consumers by 64 or 128 keys; L1 and L2
    at the lab's D = 40, L3 also at lab3's heads padded to 64 and 128; L4
    at the int8 lab's D = 64."""
    assert sorted(fa.SM90_LAB_TILES) == [(128, 64), (128, 128), (192, 64), (192, 128)]
    assert fa.SM90_LAB_HEAD_DIMS == {"tiled": (40,), "no_softmax": (40,),
                                     "two_pass": (40, 64, 128)}
    assert fa.SM90_ROWK_HEAD_DIMS == (64,) and fa.SM90_ROWK_MODE not in fa._MODES.values()
    assert set(fa.SM90_LAB_HEAD_DIMS["two_pass"]) <= set(fa.SM90_HEAD_DIMS)
    for tile in fa.SM90_LAB_TILES:
        assert fa.lab_parent_tile(tile) in fa.LAB_TILES
        assert fa.lab_parent_tile(tile)[1] == tile[1]


@pytest.mark.parametrize("mode,d,tile", [
    ("tiled", 64, None), ("tiled", 80, None), ("tiled", 128, None), ("two_pass", 80, None),
    ("two_pass", 32, None), ("two_pass", 128, (192, 64)), ("two_pass", 128, (192, 128)),
    ("tiled", 40, (64, 64)), ("two_pass", 40, (128, 32)), ("two_pass", 40, (256, 128)),
    ("no_softmax", 64, None), ("no_softmax", 40, (64, 64)), ("online", 40, None),
    ("int8_rowk", 64, None),
])
def test_sm90_lab_plan_refuses(mode, d, tile):
    with pytest.raises(ValueError):
        fa.sm90_lab_plan(d, mode, tile)


def _views(b, n, h, d, layout):
    """(B, N, H, D) bf16 views of q, k, v as the paths pass them: packed
    projections, column slices of one qkv projection, or the MMDiT's
    (B, N, H*D) viewed as (B, N, H, D)."""
    if layout == "qkv slices":
        return tuple(t.unflatten(-1, (h, d)) for t in
                     torch.zeros(b, n, 3 * h * d, dtype=torch.bfloat16).chunk(3, dim=-1))
    return tuple(torch.zeros(b, n, h * d, dtype=torch.bfloat16).unflatten(-1, (h, d))
                 for _ in range(3))


@pytest.mark.parametrize("b,n,h,d,layout,int8", [
    (8, 4096, 8, 40, "packed", False),
    (4, 1024, 8, 80, "packed", False),
    (2, 1100, 2, 40, "packed", False),
    (16, 1024, 5, 64, "qkv slices", False),
    (16, 1025, 12, 64, "qkv slices", False),
    (2, 4429, 24, 64, "packed", False),
    (2, 4429, 24, 64, "packed", True),
    (16, 1025, 12, 64, "qkv slices", True),
    (2, 77, 3, 32, "packed", True),
    (2, 77, 3, 128, "qkv slices", True),
    (8, 1024, 8, 80, "packed", True),     # K9 at SD1.5 32²: 80-byte head stride of the codes
    (4, 1024, 8, 80, "qkv slices", True),
])
def test_sm90_tensor_maps_legal(b, n, h, d, layout, int8):
    """Every map at the paths' shapes: 4-D over (D, N, H, B), strides
    multiples of 16 bytes, a box of one 128-byte swizzle span (64 bf16 or
    128 int8 codes) by 128 rows; D past its extent arrives as TMA's zeros.
    K9's K is K9p's contiguous codes."""
    plan = fa.sm90_plan(d, int8)
    q, k, v = _views(b, n, h, d, layout)
    if int8:
        k = torch.zeros(b, n, h * d, dtype=torch.int8).unflatten(-1, (h, d))
    maps = fa.sm90_tensor_maps(plan, q, k, v)
    assert [m[0] for m in maps] == ["q", "k", "v"]
    for name, es, dims, strides, box in maps:
        assert dims == (d, n, h, b)
        assert all(st > 0 and st % 16 == 0 for st in strides)
        assert box[0] * es == fa.SWIZZLE_SPAN  # the inner box bytes: one swizzle span
        blocks = plan.k_blocks if name == "k" else plan.qv_blocks
        assert (blocks - 1) * box[0] < d <= blocks * box[0]  # the column blocks cover D
        assert box[1] == (plan.block_q if name == "q" else plan.block_k) <= 256
        assert box[2:] == (1, 1)
        assert es == (1 if int8 and name == "k" else 2)
    width = (3 if layout == "qkv slices" else 1) * h * d * 2
    assert maps[0][3] == (width, d * 2, n * width)


@pytest.mark.parametrize("b,n,h,layout", [(8, 4096, 8, "packed"), (4, 4096, 8, "qkv slices"),
                                           (2, 1100, 3, "packed")])
def test_sm90_k_map_at_d40(b, n, h, layout):
    """K9 at D = 40 (SD1.5 64²): dense codes would have a 40-byte head
    stride, which no map takes, so K9p writes the heads 48 bytes apart
    (`Sm90Plan.k_head_bytes`) and the map over their (B, N, H, D) view
    keeps the extent D: TMA reads zeros past it, as in Q's and V's boxes,
    which make Q's codes there 0. Any head count works (120-byte rows at
    three heads of dense codes would not)."""
    plan = fa.sm90_plan(40, True)
    assert (plan.k_head_bytes, plan.qk_depth) == (48, 64)
    assert [fa.sm90_plan(d, True).k_head_bytes for d in (32, 64, 80, 128)] == [32, 64, 80, 128]
    q, _, v = _views(b, n, h, 40, layout)
    dense = torch.zeros(b, n, h * 40, dtype=torch.int8).unflatten(-1, (h, 40))
    with pytest.raises(ValueError):
        fa.sm90_tensor_map("k", dense, plan.block_k)
    codes = torch.zeros(b, n, h, plan.k_head_bytes, dtype=torch.int8)[..., :40]
    maps = fa.sm90_tensor_maps(plan, q, codes, v)
    name, es, dims, strides, box = maps[1]
    assert (name, es, dims, box) == ("k", 1, (40, n, h, b), (128, plan.block_k, 1, 1))
    assert strides == (h * 48, 48, n * h * 48) and all(st % 16 == 0 for st in strides)
    for _, es, dims, _, box in (maps[0], maps[2]):
        assert dims == (40, n, h, b) and box[0] * es == fa.SWIZZLE_SPAN
    assert plan.qk_depth <= box[0]  # Q.K^T's depth within one box of Q


@pytest.mark.parametrize("case", ["packed", "qkv slice", "batch broadcast", "row stride 644",
                                  "misaligned base", "one sample broadcast"])
def test_sm90_check_view_of_packed_rows(case):
    """`sm90_check_view(name, t, heads)` on a packed (B, N, H*D) tensor
    accepts and refuses what it does on the (B, N, H, D) view of it, which
    K9's wrapper no longer builds."""
    bf16 = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)
    t = {"packed": bf16(2, 64, 320), "qkv slice": bf16(2, 64, 960)[..., 320:640],
         "batch broadcast": bf16(1, 64, 320).expand(2, 64, 320),
         "row stride 644": bf16(2, 64, 644)[..., :320],
         "misaligned base": bf16(2 * 64 * 320 + 1)[1:].view(2, 64, 320),
         "one sample broadcast": bf16(1, 64, 320).expand(1, 64, 320)}[case]

    def refused(*args):
        try:
            fa.sm90_check_view("q", *args)
        except ValueError:
            return True
        return False

    assert refused(t, 8) == refused(t.unflatten(-1, (8, 40)))
    assert refused(t, 8) == (case in ("batch broadcast", "row stride 644", "misaligned base"))


def _refused(case):
    """(q, k, v, scale) for each input the sm90 route refuses."""
    bf16 = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)
    x = bf16(2, 64, 2, 64)
    cases = {
        "fp32": (x.float(), x.float(), x.float(), 0.125),
        "k batch broadcast (stride 0)": (x, bf16(1, 64, 2, 64).expand(2, 64, 2, 64), x, 0.125),
        "v row stride not a multiple of 8": (x, x, bf16(2, 64, 2, 68)[..., :64], 0.125),
        "q base not 16-byte aligned": (
            torch.zeros(2 * 64 * 128 + 1, dtype=torch.bfloat16)[1:].view(2, 64, 2, 64), x, x,
            0.125),
        "non-positive scale": (x, x, x, -1.0),
        "keys disagree": (x, bf16(2, 32, 2, 64), x, 0.125),
    }
    return cases[case]


@pytest.mark.parametrize("case", ["fp32", "k batch broadcast (stride 0)",
                                  "v row stride not a multiple of 8", "q base not 16-byte aligned",
                                  "non-positive scale", "keys disagree"])
def test_sm90_refuses_before_build(case, monkeypatch):
    """What the sm90 kernel or its tensor maps refuse raises ValueError in
    the wrapper before the extension is built: no fallback."""
    _no_build(monkeypatch)
    q, k, v, scale = _refused(case)
    with pytest.raises(ValueError):
        fa._launch(q, k, v, scale)


def test_int8_sm90_refuses_before_the_prologue(monkeypatch):
    """K9's tensor maps of Q and V are checked before K9p runs (before the
    extension is built)."""
    _no_build(monkeypatch)
    monkeypatch.setattr(fa, "quant_k_int8", lambda *a, **k: pytest.fail("K9p ran"))
    x = torch.zeros(2, 64, 256, dtype=torch.bfloat16)
    v = torch.zeros(1, 64, 256, dtype=torch.bfloat16).expand(2, 64, 256)
    with pytest.raises(ValueError):
        fa._int8_launch(x, x, v, 4, 0.125)


@pytest.mark.parametrize("case", ["k row stride 324", "D = 48", "D = 160", "q row stride 644",
                                  "v batch broadcast", "q base misaligned"])
def test_int8_sm90_refuses_sd15_shapes_before_build(case, monkeypatch):
    """What K9 refuses at SD1.5's widths raises ValueError before any
    build: K rows K9p cannot load in 16-byte vectors, head dims it does
    not instantiate (the 16² and 8² heads, 160, stay on the plain path), Q
    and V strides TMA refuses."""
    _no_build(monkeypatch)
    bf16 = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)
    x, heads = bf16(2, 64, 320), 8
    q = k = v = x
    if case == "k row stride 324":
        k = bf16(2, 64, 324)[..., :320]
    elif case == "D = 48":
        q = k = v = bf16(2, 64, 384)
    elif case == "D = 160":
        heads = 2
    elif case == "q row stride 644":
        q = bf16(2, 64, 644)[..., :320]
    elif case == "v batch broadcast":
        v = bf16(1, 64, 320).expand(2, 64, 320)
    else:
        q = torch.zeros(2 * 64 * 320 + 1, dtype=torch.bfloat16)[1:].view(2, 64, 320)
    with pytest.raises(ValueError):
        fa._int8_launch(q, k, v, heads, 0.125)


# ---- the order of work -------------------------------------------------------


def _emulate(q, k, v, scale, *, int8=False, block_k=None, warp_rows=16, two_pass=False,
             row_k=False):
    """The sm90 kernel's order of work on (B, N, H, D) float tensors holding
    the inputs' values, in fp32: per key tile (the plan's) the logits (bf16: fp32
    products; int8: exact integer sums of the per-row Q codes and K9p's
    per-head K codes), only the tile's real keys (the kernel's -inf tail),
    the running row maximum in log2 units over the unscaled logits times c
    (bf16: scale * log2(e); int8: sq * (skh * scale) * log2(e)), p =
    2^(s * c - m) with one rounding of s * c - m (FFMA), the sum over the
    fp32 p, p rounded to bf16 when `v` is bf16, O *= corr where a row
    maximum of the warp's `warp_rows` rows moved, then O += p.V in fp32,
    and O / l once, in v's dtype. With `two_pass` (L3) a first pass over
    the key tiles takes the exact row maximum (each tile's maximum times
    c), and the second sums p and p.V against it with no correction. With
    `row_k` (L4, int8) K's codes and scales are per key row and each key's
    scale enters its logit first, x = f32(s32) * sk_j rounded to fp32, c =
    sq * scale * log2(e), and P is rounded to bf16 whatever V's dtype.
    Returns (O, the Q codes or None)."""
    b, nq, h, d = q.shape
    nk = k.shape[1]
    block_k = block_k or fa.sm90_plan(d, int8, fa.sm90_consumers(d, int8, nq, nk)).block_k
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))  # (B, H, N, D)
    codes = None
    if int8:
        sq = fa._int8_scale(qf.abs().amax(dim=-1, keepdim=True))
        codes = torch.clamp(torch.round(qf / sq), -127, 127)
        if row_k:
            kc, skr = fa._quant_k_per_row(k.reshape(b, nk, h * d), h)  # skr (B, H, Nk)
            c = (sq * _f32(scale)) * _f32(LOG2E)
        else:
            kc, skh = fa._quant_k_per_head(k.reshape(b, nk, h * d), h)
            c = (sq * (skh * _f32(scale)).view(b, h, 1, 1)) * _f32(LOG2E)
        kf = kc.float().view(b, nk, h, d).permute(0, 2, 1, 3)
        qf = codes
    else:
        c = torch.full((b, h, nq, 1), _f32(scale) * _f32(LOG2E))
    m = torch.full((b, h, nq, 1), -np.inf)
    l = torch.zeros(b, h, nq, 1)
    o = torch.zeros(b, h, nq, d)
    pad = -nq % warp_rows
    logits = lambda kt: ((qf.double() @ kt.double().transpose(-1, -2)).float() if int8
                         else qf @ kt.transpose(-1, -2))
    if two_pass:  # pass 1: the exact row maximum, tile by tile
        for j0 in range(0, nk, block_k):
            m = torch.maximum(m, logits(kf[:, :, j0:j0 + block_k]).amax(dim=-1, keepdim=True) * c)
    for j0 in range(0, nk, block_k):
        kt, vt = kf[:, :, j0:j0 + block_k], vf[:, :, j0:j0 + block_k]
        s = logits(kt)
        if row_k:
            s = s * skr[:, :, None, j0:j0 + block_k]
        if not two_pass:
            mx = torch.maximum(m, s.amax(dim=-1, keepdim=True) * c)
            corr = torch.exp2(m - mx)
            m = mx
        p = torch.exp2((s.double() * c.double() - m.double()).float())
        if two_pass:
            l = l + p.sum(dim=-1, keepdim=True)
        else:
            l = l * corr + p.sum(dim=-1, keepdim=True)
            moved = torch.nn.functional.pad(corr != 1, (0, 0, 0, pad))
            moved = moved.view(b, h, -1, warp_rows).any(dim=-1).repeat_interleave(warp_rows, dim=2)
            o = torch.where(moved[:, :, :nq, None], o * corr, o)
        o = o + p.to(torch.bfloat16 if row_k else v.dtype).float() @ vt
    return (o / l).to(v.dtype).permute(0, 2, 1, 3), codes


def _emulate_no_softmax(q, k, v, scale, block_k):
    """L2's order of work on (B, N, H, D) float tensors holding the inputs'
    values: per key tile of `block_k` keys the fp32 logits of the tile's
    real keys (rows past N arrive as zeros and add nothing), times the
    scale in fp32 (one FMUL), rounded to v's dtype, then O += P.V in fp32;
    O in v's dtype. No maximum, exponential, sum or division."""
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))  # (B, H, N, D)
    o = torch.zeros(qf.shape[:3] + (v.shape[-1],))
    for j0 in range(0, k.shape[1], block_k):
        s = qf @ kf[:, :, j0:j0 + block_k].transpose(-1, -2)
        p = (s * _f32(scale)).to(v.dtype).float()
        o = o + p @ vf[:, :, j0:j0 + block_k]
    return o.to(v.dtype).permute(0, 2, 1, 3)


def _as(x, dtype):
    return torch.from_numpy(np.array(x)).to(dtype)


def _packed_case(rng, b, nq, nk, h, d, slices):
    """bf16-valued q (B, Nq, H*D), k, v (B, Nk, H*D) as numpy, q, k and v
    as column slices of one qkv projection with `slices` (Nq = Nk)."""
    if slices:
        qkv = _normal(rng, (b, nq, 3 * h * d))
        return np.split(qkv, 3, axis=-1)
    return _normal(rng, (b, nq, h * d)), _normal(rng, (b, nk, h * d)), _normal(rng, (b, nk, h * d))


def _bf16_values(*xs):
    return [np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)) for x in xs]


# bf16 against the JAX kernel (P rounded against the row's final maximum)
# differs by one bf16 step of each P (2^-8 relative between the two
# roundings) and one of each output: 2^-8 (max|V| + max|O|), and fp32's
# order of sums below that
def _bf16_bound(v, ref):
    return 2.0 ** -8 * (np.abs(v).max() + np.abs(ref).max())


PACKED = [  # (B, Nq, Nk, H, D, qkv slices)
    (2, 200, 200, 3, 40, False),   # two key tiles, the second ragged
    (1, 130, 300, 2, 80, False),   # a ragged query tail, three key tiles
    (2, 160, 160, 2, 64, True),    # column slices of one qkv projection
    (1, 77, 77, 2, 40, True),      # one short tile
]


@pytest.mark.parametrize("b,nq,nk,h,d,slices", PACKED)
def test_emulation_matches_jax_packed_fp32(b, nq, nk, h, d, slices):
    """In fp32 (no P rounding) the order of work is K1's function: within
    1e-5 of `flash_attention_packed` (the full-K TPU kernel in interpret
    mode); fp32's own order of sums is all that differs."""
    rng = np.random.default_rng(nq + d)
    q, k, v = _packed_case(rng, b, nq, nk, h, d, slices)
    scale = d ** -0.5
    ref = np.asarray(jflash.flash_attention_packed(jnp.asarray(q), jnp.asarray(k),
                                                   jnp.asarray(v), h, scale))
    heads = lambda x: torch.from_numpy(np.ascontiguousarray(x)).unflatten(-1, (h, d))
    got, _ = _emulate(heads(q), heads(k), heads(v), scale)
    np.testing.assert_allclose(got.reshape(b, nq, h * d).numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("b,nq,nk,h,d,slices", PACKED)
def test_emulation_matches_jax_packed_bf16(b, nq, nk, h, d, slices):
    """On bf16 inputs, P rounded to bf16 against the running maximum:
    within one bf16 step of P and of the output of the JAX kernel."""
    rng = np.random.default_rng(nq + d + 1)
    q, k, v = _bf16_values(*_packed_case(rng, b, nq, nk, h, d, slices))
    scale = d ** -0.5
    ref = np.asarray(jflash.flash_attention_packed(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), h, scale).astype(jnp.float32))
    heads = lambda x: _as(np.ascontiguousarray(x), torch.bfloat16).unflatten(-1, (h, d))
    got, _ = _emulate(heads(q), heads(k), heads(v), scale)
    err = np.abs(got.float().reshape(b, nq, h * d).numpy() - ref).max()
    assert err <= _bf16_bound(v, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,nq,nk,h,d", [(2, 200, 200, 2, 64), (1, 77, 260, 3, 40)])
def test_emulation_matches_jax_flash_attention(b, nq, nk, h, d, dtype):
    """K2's (B, N, H, D) layout against `flash_attention` (the online TPU
    kernel in interpret mode): fp32 within 1e-5, bf16 within one bf16 step
    of P and of the output."""
    rng = np.random.default_rng(nk + d)
    q, k, v = _normal(rng, (b, nq, h, d)), _normal(rng, (b, nk, h, d)), _normal(rng, (b, nk, h, d))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    if dtype == "bfloat16":
        q, k, v = _bf16_values(q, k, v)
    ref = np.asarray(jflash.flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)))
                     .astype(jnp.float32))
    got, _ = _emulate(_as(q, tdt), _as(k, tdt), _as(v, tdt), d ** -0.5)
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= (1e-5 if dtype == "float32" else _bf16_bound(v, ref))


INT8 = [  # (B, Nq, Nk, H, D, qkv slices)
    (2, 200, 200, 2, 64, False),
    (1, 130, 300, 2, 32, False),
    (2, 160, 160, 2, 64, True),
    (1, 77, 77, 1, 128, True),
    (2, 200, 260, 2, 40, False),   # SD1.5's heads under `int8_attention`
    (1, 150, 150, 2, 80, True),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,nq,nk,h,d,slices", INT8)
def test_emulation_matches_jax_int8(b, nq, nk, h, d, slices, dtype):
    """K9's order of work against the TPU int8 kernel in interpret mode:
    its Q codes bit-equal to the TPU kernel's and to the plain version's
    quantization; the output with fp32 V within 1e-5 (the logits' scaling
    folds log2(e) into one factor: fp32 rounding of the exponent only),
    with bf16 inputs within one bf16 step of P and of the output."""
    rng = np.random.default_rng(nk + d + 7)
    q, k, v = _packed_case(rng, b, nq, nk, h, d, slices)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    if dtype == "bfloat16":
        q, k, v = _bf16_values(q, k, v)
    q, k, v = (np.ascontiguousarray(x) for x in (q, k, v))
    scale = d ** -0.5
    ref = np.asarray(_jax_int8_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)), h, scale)
                     .astype(jnp.float32))
    heads = lambda x: _as(x, tdt).unflatten(-1, (h, d))
    got, codes = _emulate(heads(q), heads(k), heads(v), scale, int8=True)
    # the Q codes: the TPU kernel's (`_fa_packed_fullk_int8_kernel`) and the
    # plain version's quantization, per (row, head)
    qh = jnp.asarray(q, jdt).astype(jnp.float32).reshape(b, nq, h, d)
    sq = jnp.maximum(jnp.max(jnp.abs(qh), axis=-1, keepdims=True) / 127.0, 1e-8)
    jcodes = np.asarray(jnp.clip(jnp.round(qh / sq), -127, 127)).transpose(0, 2, 1, 3)
    assert np.array_equal(codes.numpy(), jcodes)
    qt = heads(q).float()
    pcodes = torch.clamp(torch.round(qt / fa._int8_scale(qt.abs().amax(-1, keepdim=True))),
                         -127, 127).permute(0, 2, 1, 3)
    assert torch.equal(codes, pcodes)
    err = np.abs(got.float().reshape(b, nq, h * d).numpy() - ref).max()
    assert err <= (1e-5 if dtype == "float32" else _bf16_bound(v, ref))


def test_emulation_rescale_rule_is_exact():
    """O is rescaled only where a row maximum of the warp's 16 rows moved,
    which is exact: elsewhere corr is 2^0 = 1. An emulation that always
    rescales gives the same bits."""
    rng = np.random.default_rng(3)
    q, k, v = (_as(_normal(rng, (1, 64, 2, 40)), torch.bfloat16) for _ in range(3))
    k[:, 130:] = 0  # later tiles' maxima below the first's for some rows
    got, _ = _emulate(q, k, v, 40 ** -0.5, block_k=32)
    always, _ = _emulate(q, k, v, 40 ** -0.5, block_k=32, warp_rows=1)
    assert torch.equal(got, always)


variants = jax_lab("attn_variants")

LAB_EMULATION = [  # (B, H, N, D, block_k): N whole tiles of the JAX lab's 32 query rows and keys
    (2, 2, 256, 40, 64), (1, 2, 256, 40, 128), (2, 1, 192, 64, 64), (1, 2, 256, 64, 128),
    (1, 1, 256, 128, 64), (1, 2, 128, 128, 128),
]


def _lab_inputs(rng, b, h, n, d, dtype):
    """numpy (B, H, N, D) q, k, v (bf16 values for bf16), the JAX lab's
    arrays and the port's (B, N, H, D) views of the same values."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    qkv = [_normal(rng, (b, h, n, d)) for _ in range(3)]
    if dtype == "bfloat16":
        qkv = _bf16_values(*qkv)
    return qkv, [jnp.asarray(a, jdt) for a in qkv], [_as(a, tdt).transpose(1, 2) for a in qkv]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,n,d,block_k", LAB_EMULATION)
def test_two_pass_emulation_matches_jax_fullk(b, h, n, d, block_k, dtype):
    """L3's order of work (the exact row maximum from a first pass over
    64- or 128-key tiles, then p, its sum and P.V with no rescale) against
    the JAX lab's `_fullk_kernel` (a whole logits row, one softmax) in
    interpret mode: fp32 within 1e-5, bf16 within one bf16 step of P and of
    the output (the lab rounds P against the same exact maximum)."""
    rng = np.random.default_rng(n + d + block_k)
    qkv, jqkv, views = _lab_inputs(rng, b, h, n, d, dtype)
    scale = d ** -0.5
    ref = np.asarray(jax_lab_bhnd(variants._fullk_kernel, jqkv, 32, scale=scale)
                     .astype(jnp.float32))
    got, _ = _emulate(*views, scale, block_k=block_k, two_pass=True)
    err = np.abs(got.float().transpose(1, 2).numpy() - ref).max()
    assert err <= (1e-5 if dtype == "float32" else _bf16_bound(qkv[2], ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,n,d,block_k", [c for c in LAB_EMULATION if c[3] == 40])
def test_online_emulation_matches_jax_lab(b, h, n, d, block_k, dtype):
    """L1's order of work (K1's, at 64- or 128-key tiles) against the JAX
    lab's `_online_kernel` at the same key tile in interpret mode: fp32
    within 1e-5, bf16 within one bf16 step of P and of the output."""
    rng = np.random.default_rng(n + d + block_k + 1)
    qkv, jqkv, views = _lab_inputs(rng, b, h, n, d, dtype)
    scale = d ** -0.5
    ref = np.asarray(jax_lab_bhnd(variants._online_kernel, jqkv, 64, scale=scale,
                                  block_k=block_k).astype(jnp.float32))
    got, _ = _emulate(*views, scale, block_k=block_k)
    err = np.abs(got.float().transpose(1, 2).numpy() - ref).max()
    assert err <= (1e-5 if dtype == "float32" else _bf16_bound(qkv[2], ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,nq,nk,h,d,block_k", [(1, 77, 260, 3, 40, 64), (2, 130, 200, 2, 64, 128),
                                                 (1, 100, 70, 2, 128, 64)])
def test_two_pass_emulation_ragged_matches_jax(b, nq, nk, h, d, block_k, dtype):
    """L3 with a ragged key tail (masked to -inf in both passes) and query
    tail against `flash_attention` (the online TPU kernel in interpret
    mode; the labs take whole tiles only): fp32 within 1e-5, bf16 within
    one bf16 step of P and of the output."""
    rng = np.random.default_rng(nq + nk + d)
    q, k, v = _normal(rng, (b, nq, h, d)), _normal(rng, (b, nk, h, d)), _normal(rng, (b, nk, h, d))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    if dtype == "bfloat16":
        q, k, v = _bf16_values(q, k, v)
    ref = np.asarray(jflash.flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)))
                     .astype(jnp.float32))
    got, _ = _emulate(_as(q, tdt), _as(k, tdt), _as(v, tdt), d ** -0.5, block_k=block_k,
                      two_pass=True)
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= (1e-5 if dtype == "float32" else _bf16_bound(v, ref))


@pytest.mark.parametrize("d,nq", [(32, 380), (32, 250), (64, 380), (64, 250), (128, 250),
                                  (40, 380), (40, 250), (80, 250)])
def test_k9_code_probe_reads_every_code(d, nq):
    """chip_smoke.py's `k9_code_probe`: on its inputs K9's output reads each
    query row's Q code at the probed dimension, so the check on the card
    holds the kernel's codes, which never leave its registers, to the plain
    quantizer's. Here the kernel's order of work (`_emulate`, at the plan's
    key tile) and the plain version read exactly the plain codes, every
    bit column within 2^-7 of a bit (the winning key's P rounded to bf16
    against the fp32 sum, 2^-8, and the output's bf16 rounding). The TPU
    int8 kernel in interpret mode reads them too, but where a quotient
    q / sq lies within 1e-4 of a rounding tie without being one: XLA's
    compiled CPU division is not the IEEE quotient (-63.499996 comes out
    -63.500004), the reason the port divides per IEEE. The codes cover
    -127..127; half the rows sit at exact rounding ties, where rounding
    half away from zero gives other codes; the cases take every int8
    instantiation of the sm90 kernel."""
    import chip_smoke

    assert (d, nq) in chip_smoke.K9_PROBE_CASES
    (q, k, v, h, scale), want = chip_smoke.k9_code_probe(d, nq)
    nk = k.shape[1]
    assert {(dd, fa.sm90_consumers(dd, True, n, nk)) for dd, n in chip_smoke.K9_PROBE_CASES} == {
        (32, 3), (32, 2), (40, 3), (40, 2), (64, 3), (64, 2), (80, 2), (128, 2)}
    assert want.shape == (d // h, nq, h) and set(want.unique().tolist()) == set(range(-127, 128))
    outs = {"plain": fa.flash_attention_packed_int8(q, k, v, h, scale)}
    heads = lambda t: t.unflatten(-1, (h, d))
    outs["emulation"] = _emulate(heads(q), heads(k), heads(v), scale, int8=True)[0].flatten(2)
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v))
    outs["TPU kernel"] = torch.from_numpy(np.asarray(
        _jax_int8_attention(jq, jk, jv, h, scale).astype(jnp.float32)))
    qf = q.float().view(d // h, nq, h, d)
    x = qf / fa._int8_scale(qf.abs().amax(-1, keepdim=True))
    probed = x.gather(-1, torch.arange(d).view(d // h, 1, h, 1).expand(d // h, nq, h, 1))[..., 0]
    frac = probed - probed.floor()
    assert (frac == 0.5)[:, ::2].all()
    near_tie = ((frac - 0.5).abs() < 1e-4) & (frac != 0.5)
    for name, out in outs.items():
        got, off = chip_smoke.k9_probe_read(out, h)
        same = got == want
        assert (same | near_tie).all() if name == "TPU kernel" else same.all(), name
        assert off <= 2.0 ** -7, name
    away = torch.clamp(torch.trunc(probed + 0.5 * probed.sign()), -127, 127).to(torch.int64)
    assert (away != want).sum() > want.numel() // 8


def test_chip_smoke_checks_the_new_kernels_and_not_the_parents():
    """chip_smoke.py counts one launch of the sm90 kernels per K1, K2 and K9
    call on the paths (K1 and K2 together, with the wide sm90 kernel at
    D = 512) and fails a path that launches a parent; the names it matches
    by substring do not contain each other."""
    import chip_smoke

    one = chip_smoke.PATH_ONE_LAUNCH
    assert one["flash_attention_packed"] == one["flash_attention"] == (
        "attn_sm90_bf16_kernel", "attn_sm90_wide_kernel")
    assert one["flash_attention_packed_int8"] == ("attn_sm90_int8_kernel",)
    assert {"fa_narrow_kernel", "int8_attn_kernel", "fa_wide_kernel"} <= set(
        chip_smoke.PARENT_FUNCTIONS)
    new = {f for fs in one.values() for f in fs}
    for parent in chip_smoke.PARENT_FUNCTIONS:
        assert not any(parent in f or f in parent for f in new), parent
    assert chip_smoke.DEVICE_FUNCTIONS["flash_attention_packed_int8"] == (
        "k_head_quant_kernel", "attn_sm90_int8_kernel")
    assert chip_smoke.KERNELS["flash_attention_packed"][1].endswith("attention_sm90.cuh")
    assert chip_smoke.KERNELS["flash_attention"][1].endswith("attention_sm90_wide.cuh")
    assert any(src.endswith("attention_sm90_wide.cu")
               for src in chip_smoke.SOURCES_ALSO["flash_attention"])
    assert chip_smoke.DEVICE_FUNCTIONS["flash_attention"][1] == "attn_sm90_wide_kernel"
    # L1, L2 and L3: one launch of the bf16 lab instantiations per call,
    # none of the parent, counted in `[kernels]` and on the `[labs]` path;
    # L4: one of its prologue and one of the per-row-K instantiation
    for name in ("flash_attention_tiled", "attention_no_softmax", "flash_attention_two_pass"):
        assert one[name] == ("attn_sm90_lab_kernel",) and name in chip_smoke.ONE_LAUNCH
        assert chip_smoke.KERNELS[name][1].endswith("attention_sm90.cuh")
        assert any(src.endswith("attention_sm90_lab.cu") for src in chip_smoke.SOURCES_ALSO[name])
        assert name in chip_smoke.PATH_KERNELS["labs"] and name in chip_smoke.LAB_MODES
    assert any(src.endswith("attention_sm90_lab_two_pass.cu")
               for src in chip_smoke.SOURCES_ALSO["flash_attention_two_pass"])
    rowk = "flash_attention_packed_int8_rowk"
    assert one[rowk] == ("attn_sm90_rowk_kernel",) and rowk in chip_smoke.EACH_ONCE
    assert chip_smoke.DEVICE_FUNCTIONS[rowk] == ("k_row_codes_kernel", "attn_sm90_rowk_kernel")
    assert chip_smoke.KERNELS[rowk][1].endswith("attention_sm90.cuh")
    assert any(src.endswith("attention_sm90_lab.cu") for src in chip_smoke.SOURCES_ALSO[rowk])
    new_lab = ("attn_sm90_lab_kernel", "attn_sm90_rowk_kernel")
    for f in new_lab:
        assert not any(f in g or g in f for g in chip_smoke.PARENT_FUNCTIONS + (
            "attn_sm90_bf16_kernel", "attn_sm90_int8_kernel") + tuple(set(new_lab) - {f}))


@pytest.mark.parametrize("name,args,parent", [
    ("attention_no_softmax", ("q", "k", "v", 0.2, 192, 128), ("no_softmax", (128, 128))),
    ("attention_no_softmax", ("q", "k", "v", 0.2, 192, 64), ("no_softmax", (128, 64))),
    ("flash_attention_tiled", ("q", "k", "v", 0.2, 192, 128), ("online", (128, 128))),
    ("flash_attention_packed_int8_rowk", ("q", "k", "v", 4), ("int8 per row", None)),
])
def test_chip_smoke_times_the_parents_beside_the_lab_modes(name, args, parent, monkeypatch):
    """chip_smoke.py's `[kernels]` times each lab mode's parent through its
    own launch: the bf16 modes `fa_narrow_kernel` in their mode at
    `lab_parent_tile`, L4 `int8_attn_kernel` with per-row K; and its cases
    hold L2 at K1's tile and at 64-key tiles and L4 at the SD3 joint
    shape."""
    import chip_smoke

    calls = []
    monkeypatch.setattr(fa, "_parent_launch", lambda q, k, v, scale, mode, tile: calls.append(
        (mode, tile)))
    monkeypatch.setattr(fa, "_int8_parent_launch", lambda q, k, v, h, scale, row_k: calls.append(
        ("int8 per row" if row_k else "int8", None)))
    x = torch.zeros(1, 64, 256)
    chip_smoke.parent_call(name, tuple(x if a in ("q", "k", "v") else a for a in args))()
    assert calls == [parent]


# ---- L2 and L4 on the sm90 kernel --------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,n,block_k,jax_block", [(2, 2, 256, 64, 64), (1, 2, 256, 128, 128),
                                                     (1, 2, 200, 64, 40), (2, 1, 200, 128, 50),
                                                     (1, 3, 77, 64, 77)])
def test_no_softmax_emulation_matches_jax_lab(b, h, n, block_k, jax_block, dtype):
    """L2's order of work (the tile's fp32 logits times the scale, rounded
    to bf16, O summed tile by tile in fp32 at 64- or 128-key tiles; ragged
    N with its tail unmasked: K's and V's rows past N are zeros) against
    the JAX lab's `_online_kernel(do_softmax=False)` in interpret mode
    (whole tiles of `jax_block` keys): fp32 within 1e-5 of the largest
    output (the order of the fp32 sums), bf16 within one bf16 step of a P
    and of the output (a logit that the sums' order moves across a
    rounding of P)."""
    rng = np.random.default_rng(n + block_k + h)
    qkv, jqkv, views = _lab_inputs(rng, b, h, n, 40, dtype)
    qkv[2] = qkv[2] / 8
    jqkv[2] = jqkv[2] / 8
    views[2] = views[2] / 8
    scale = 40 ** -0.5
    ref = np.asarray(jax_lab_bhnd(variants._online_kernel, jqkv, jax_block, scale=scale,
                                  block_k=jax_block, do_softmax=False).astype(jnp.float32))
    got = _emulate_no_softmax(*views, scale, block_k).float().transpose(1, 2).numpy()
    err = np.abs(got - ref).max()
    if dtype == "float32":
        assert err <= 1e-5 * np.abs(ref).max()
    else:
        p = np.abs(np.einsum("bhqd,bhkd->bhqk", qkv[0], qkv[1]) * scale).max()
        assert err <= 2.0 ** -8 * (p * np.abs(qkv[2]).max() + np.abs(ref).max())


int8_lab = jax_lab("attn_int8_lab")

ROWK = [  # (B, N, H, block_k): K9's plans' key tiles, ragged N
    (1, 200, 2, 112), (2, 300, 2, 112), (1, 224, 3, 112), (1, 260, 2, 128), (2, 77, 2, 112)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,h,block_k", ROWK)
def test_rowk_emulation_matches_jax_lab(b, n, h, block_k, dtype):
    """L4's order of work (each key's scale in its logit before the row
    maximum, x = f32(s32) * sk_j, then p = 2^(x * sq * scale * log2(e) - m)
    in one rounding, the online rescale at 112- or 128-key tiles, P in
    bf16, ragged N masked) against the int8 lab's `attn_int8_v2` in
    interpret mode, which rounds (f32(s32) * (sq * sk_j)) * scale: its Q
    codes the plain quantizer's, the output within one bf16 step of P and
    of the output, with fp32 V too (both round P to bf16)."""
    rng = np.random.default_rng(n + h + block_k)
    q, k, v = (_normal(rng, (b, n, h * 64), 0.5) for _ in range(3))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    if dtype == "bfloat16":
        q, k, v = _bf16_values(q, k, v)
    scale = 64 ** -0.5
    ref = np.asarray(int8_lab.attn_int8_v2(*(jnp.asarray(x, jdt) for x in (q, k, v)), h, scale,
                                           interpret=True).astype(jnp.float32))
    heads = lambda x: _as(x, tdt).unflatten(-1, (h, 64))
    got, codes = _emulate(heads(q), heads(k), heads(v), scale, int8=True, row_k=True,
                          block_k=block_k)
    qt = heads(q).float()
    pcodes = torch.clamp(torch.round(qt / fa._int8_scale(qt.abs().amax(-1, keepdim=True))),
                         -127, 127).permute(0, 2, 1, 3)
    assert torch.equal(codes, pcodes)
    err = np.abs(got.float().reshape(b, n, h * 64).numpy() - ref).max()
    assert err <= _bf16_bound(v, ref)


def test_rowk_emulation_scales_each_key():
    """The key scale is in the logit before the maximum: with one key row
    scaled up 8x (its codes unchanged, its scale 8x) the per-row emulation
    follows the exact attention, where folding one scale a head (K9) would
    not; default tiles are K9's plan's (112 keys on three consumers)."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(_normal(rng, (1, 150, 2, 64), 0.5)) for _ in range(3))
    k[0, 7] *= 8.0
    exact = fa._torch_attention(q, k, v, 64 ** -0.5)
    rowk, _ = _emulate(q, k, v, 64 ** -0.5, int8=True, row_k=True)
    head, _ = _emulate(q, k, v, 64 ** -0.5, int8=True)
    rel = lambda a: ((a - exact).norm() / exact.norm()).item()
    assert rel(rowk) < rel(head)
    assert fa.sm90_rowk_plan(64, 150, 150).block_k == 112


@pytest.mark.parametrize("nq,consumers,block_k", [(4250, 3, 112), (4429, 3, 112), (1024, 2, 128),
                                                   (1025, 3, 112), (77, 2, 128)])
def test_sm90_rowk_plan(nq, consumers, block_k):
    """L4 runs K9's plan at D = 64 (three consumers at 112-key tiles, two
    at 128 where three pad the work) with a two-stage ring of the key
    scales, a tile's fp32 scales 128-byte aligned (512 bytes at both
    tiles); its rows of scales a pitch of whole 16 bytes apart."""
    plan = fa.sm90_rowk_plan(64, nq, nq)
    k9 = fa.sm90_plan(64, True, consumers)
    assert (plan.consumers, plan.block_k, plan.block_q) == (consumers, block_k, 64 * consumers)
    assert plan.int8 and plan.row_k and plan.scale_stage == 512
    assert plan.smem == k9.smem + 2 * 512 == 83968 <= fa.SMEM_PER_BLOCK
    assert (k9.row_k, k9.scale_stage) == (False, 0)
    pitch = plan.scale_pitch(nq)
    assert pitch >= nq and 4 * pitch % 16 == 0 and pitch - nq < 4
    # the lab's dense rows, 17,000 bytes apart, are no stride a map takes
    assert (4 * 4250 % 16, fa.sm90_rowk_plan(64, 4250, 4250).scale_pitch(4250)) == (8, 4252)


@pytest.mark.parametrize("d", [32, 40, 80, 128])
def test_sm90_rowk_plan_refuses(d):
    with pytest.raises(ValueError, match="per-row-K"):
        fa.sm90_rowk_plan(d, 256, 256)


def _k_row_codes(k, heads, pitch):
    """`k_row_codes_kernel`'s writes, emulated chunk by chunk: thread i
    holds 8 values of key row n of sample b (its lane c of the row), the
    row's amax over its head's D / 8 lanes (a shuffle butterfly: a
    maximum, exact in any order), its scale at sk[(b * H + h) * pitch +
    n], its codes at i * 8. Returns (codes (B, N, H*D), the scale memory
    (B, H, pitch), NaN where nothing was written)."""
    b, n, hd = k.shape
    d = hd // heads
    chunks = k.float().reshape(b * n * hd // 8, 8)
    lanes = chunks.abs().amax(-1).view(b, n, heads, d // 8)
    amax = lanes.amax(-1)  # (B, N, H)
    s = fa._int8_scale(amax)
    mem = torch.full((b * heads * pitch,), float("nan"))
    bi, ni, hi = torch.meshgrid(torch.arange(b), torch.arange(n), torch.arange(heads),
                                indexing="ij")
    mem[((bi * heads + hi) * pitch + ni).flatten()] = s.flatten()
    codes = torch.clamp(torch.round(chunks.view(b, n, heads, d) / s[..., None]), -127, 127)
    return codes.to(torch.int8).view(b, n, hd), mem.view(b, heads, pitch)


@pytest.mark.parametrize("b,n,h,d", [(2, 4250, 24, 64), (1, 77, 3, 64), (2, 130, 2, 32),
                                     (1, 33, 2, 128)])
def test_k_row_codes_pitch_keeps_the_plain_values(b, n, h, d):
    """The per-row prologue at the sm90 kernel's pitch writes the plain
    version's codes and scales bit for bit (`_quant_k_per_row`); the
    floats past N of each row stay unwritten and lie outside the map; at
    pitch N (the parent's) the rows are dense."""
    rng = np.random.default_rng(n + d)
    k = _as(_normal(rng, (b, n, h * d)), torch.bfloat16)
    plain_codes, plain_sk = fa._quant_k_per_row(k, h)
    for pitch in (n, fa.Sm90Plan(d=64, int8=True, consumers=3, row_k=True).scale_pitch(n)):
        codes, mem = _k_row_codes(k, h, pitch)
        assert torch.equal(codes, plain_codes) and torch.equal(mem[..., :n], plain_sk)
        assert torch.isnan(mem[..., n:]).all()


def _rowk_x(b, n, h, d=64):
    return torch.zeros(b, n, h * d, dtype=torch.bfloat16)


def test_rowk_launch_hands_the_prologue_and_the_kernel_their_arguments(monkeypatch):
    """On the card L4 runs the per-row prologue into scales `scale_pitch(N)`
    floats a row (counted in `quant_k_int8.launches`), then the lab entry
    in mode SM90_ROWK_MODE on the codes (dense (B, N, H*D) bytes), those
    scales and their pitch, Q and V as packed rows, K9's plan; each call
    counts one launch of the wrapper; no parent runs."""
    ext = _fake_card(monkeypatch)
    monkeypatch.setattr(fa, "_int8_parent_launch", lambda *a: pytest.fail("the parent ran"))
    b, n, h = 2, 300, 3
    q, k, v = _rowk_x(b, n, h), _rowk_x(b, n, h), _rowk_x(b, n, h)
    before = (fa.flash_attention_packed_int8_rowk.launches, fa.quant_k_int8.launches)
    out = fa.flash_attention_packed_int8_rowk(q, k, v, h, 0.125)
    assert out.shape == (b, n, h * 64) and out.dtype == torch.bfloat16
    assert (fa.flash_attention_packed_int8_rowk.launches, fa.quant_k_int8.launches) == (
        before[0] + 1, before[1] + 1)
    (rows_kind, rows), (lab_kind, lab) = ext.calls
    plan = fa.sm90_rowk_plan(64, n, n)
    pitch = plan.scale_pitch(n)
    assert (rows_kind, lab_kind) == ("rows", "lab")
    assert rows[:7] == (k.data_ptr(), n * h * 64, h * 64, b, h, n, 64) and rows[8] == pitch
    assert lab[1] == rows[9] and lab[2] == rows[7] and lab[3] == pitch  # codes, scales, pitch
    assert lab[4:11] == (v.data_ptr(), lab[5], b, h, n, n, 64)
    assert lab[11:20] == (n * h * 64, h * 64, 64, n * h * 64, h * 64, 64, n * h * 64, h * 64, 64)
    assert lab[23:] == (pytest.approx(0.125), fa.SM90_ROWK_MODE, plan.consumers, plan.block_k, 0)


ROWK_REFUSALS = {
    "D = 32": lambda: (_rowk_x(2, 64, 2, 32),) * 3 + (2,),
    "D = 128": lambda: (_rowk_x(2, 64, 2, 128),) * 3 + (2,),
    "D = 40": lambda: (_rowk_x(2, 64, 8, 40),) * 3 + (8,),
    "q fp32": lambda: (_rowk_x(2, 64, 3).float(), _rowk_x(2, 64, 3), _rowk_x(2, 64, 3), 3),
    "v batch broadcast": lambda: (_rowk_x(2, 64, 3), _rowk_x(2, 64, 3),
                                  _rowk_x(1, 64, 3).expand(2, 64, 192), 3),
    "k row stride 196": lambda: (_rowk_x(2, 64, 3), torch.zeros(2, 64, 196, dtype=torch.bfloat16)
                                 [..., :192], _rowk_x(2, 64, 3), 3),
    "heads do not divide": lambda: (_rowk_x(2, 64, 3),) * 3 + (5,),
}


@pytest.mark.parametrize("case", sorted(ROWK_REFUSALS))
def test_rowk_refuses_before_build(case, monkeypatch):
    """What L4's instantiation does not take raises ValueError on the card
    before the extension is built or the prologue runs: no fallback to
    the parent or to the plain version, and no launch counted."""
    _as_if_on_the_card(monkeypatch)
    _no_build(monkeypatch)
    monkeypatch.setattr(fa, "use_kernel", lambda t: True)
    monkeypatch.setattr(fa, "_int8_parent_launch", lambda *a: pytest.fail("the parent ran"))
    monkeypatch.setattr(fa, "_torch_int8_attention", lambda *a: pytest.fail("the plain ran"))
    monkeypatch.setattr(fa, "quant_k_int8", lambda *a, **kw: pytest.fail("the prologue ran"))
    q, k, v, h = ROWK_REFUSALS[case]()
    before = fa.flash_attention_packed_int8_rowk.launches
    with pytest.raises(ValueError):
        fa.flash_attention_packed_int8_rowk(q, k, v, h, 0.125)
    assert fa.flash_attention_packed_int8_rowk.launches == before


@pytest.mark.parametrize("block_q", [None, 64])
def test_int8_parent_reachable_through_its_launch(block_q, monkeypatch):
    """The sm90 int8 kernel's parent, `int8_attn_kernel`, through its own
    launch with per-row K: the prologue at dense rows of scales (pitch N),
    then the parent at `int8_block_q` or the given query rows, counted in
    `_int8_parent_launch.launches`; a block_q not instantiated is refused
    before any build."""
    ext = _fake_card(monkeypatch)
    b, n, h = 2, 300, 3
    x = _rowk_x(b, n, h)
    before = fa._int8_parent_launch.launches
    fa._int8_parent_launch(x, x, x, h, 0.125, True, block_q)
    (rows_kind, rows), (kind, args) = ext.calls
    assert (rows_kind, kind) == ("rows", "int8 parent") and rows[8] == n
    assert args[1:4] == (rows[9], rows[7], True)
    assert args[-2:] == (block_q or fa.int8_block_q(n), 0)
    assert fa._int8_parent_launch.launches == before + 1
    _no_build(monkeypatch)
    with pytest.raises(ValueError, match="not instantiated"):
        fa._int8_parent_launch(x, x, x, h, 0.125, True, 256)


@pytest.mark.parametrize("case", ["not per row", "pitch below N", "pitch not whole 16 bytes"])
def test_quant_k_scale_pitch_refuses(case):
    """`quant_k_int8`'s `scale_pitch` lays out per-row scales only, at
    least N floats and a multiple of SM90_SCALE_PITCH apart."""
    k = torch.zeros(1, 77, 128, dtype=torch.bfloat16)
    kwargs = {"not per row": {"scale_pitch": 80}, "pitch below N": {"per_row": True,
                                                                   "scale_pitch": 76},
              "pitch not whole 16 bytes": {"per_row": True, "scale_pitch": 78}}[case]
    with pytest.raises(ValueError, match="scale_pitch"):
        fa.quant_k_int8(k, 2, **kwargs)
