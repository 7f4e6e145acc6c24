"""PyTorch port, K10 (tanh-GELU -> int8) and K13 (AdaLN -> int8) on the card:
the launch plan of `ops/csrc/row_quant.cu` (`row_plan`), the refusals of
its launchers before any build, and the plain K13 on the modulation views
the MMDiT passes, against the JAX package. The kernels themselves run only
on the card (`chip_smoke.py`, `tools/quant_tune.py --part check`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prompt_diffusion_tpu.ops import fused_adaln as jadaln
from prompt_diffusion_tpu_torch.ops import row_quant as rq
from prompt_diffusion_tpu_torch.ops.fused_adaln import fused_adaln, fused_adaln_quant
from tests.test_torch_sd3_ops import _assert_codes

torch.set_num_threads(2)

# (rows, C, dtype, samples, groups): the SD3 step's K10 (image and context
# streams' FF rows at 4C) and K13 (both streams at C, two samples), ragged
# row counts and vectors, rows of several warps, 32 KB rows, fp32, and the
# pipelined plans the tune tool sweeps
PLANS = [
    (8192, 6144, torch.bfloat16, 1, 1), (666, 6144, torch.bfloat16, 1, 1),
    (8192, 1536, torch.bfloat16, 2, 1), (666, 1536, torch.bfloat16, 2, 1),
    (8192, 6144, torch.bfloat16, 1, 4), (666, 1536, torch.bfloat16, 2, 8),
    (1001, 6144, torch.bfloat16, 1, 3), (231, 4096, torch.bfloat16, 3, 1),
    (37, 2056, torch.bfloat16, 1, 1), (5, 16384, torch.bfloat16, 1, 1),
    (36, 8, torch.float32, 4, 2), (50, 6144, torch.float32, 1, 1),
    (70, 8192, torch.float32, 1, 1), (333, 1544, torch.float32, 1, 1),
]


def _plan_id(case):
    rows, c, dtype, samples, groups = case
    return f"{rows}x{c}-{str(dtype)[6:]}-s{samples}-g{groups}"


@pytest.mark.parametrize("case", PLANS, ids=_plan_id)
def test_row_plan_covers_every_column_and_row_once(case):
    """The kernel's maps (`RowPlan.columns`, `RowPlan.row`): the threads of
    a row cover every column once in 16-byte aligned vectors, within
    MAX_VECTORS each, and the grid's blocks cover every row of every
    sample once."""
    rows, c, dtype, samples, groups = case
    plan = rq.row_plan(rows, c, dtype, samples=samples, groups=groups)
    size = torch.empty((), dtype=dtype).element_size()
    assert plan.vec_elems * size == rq.VEC_BYTES
    assert plan.threads * plan.rows_per_group == rq.BLOCK_THREADS
    assert plan.threads % rq.WARP == 0 and plan.vectors <= rq.MAX_VECTORS
    cols = []
    for t in range(plan.threads):
        firsts = plan.columns(t)
        assert len(firsts) <= plan.vectors
        assert all(f * size % rq.VEC_BYTES == 0 for f in firsts)
        cols += [f + j for f in firsts for j in range(plan.vec_elems)]
    assert sorted(cols) == list(range(c))
    assert plan.grid[1] == samples and plan.rows * samples == rows
    covered = [plan.row(blk, g, slot) for blk in range(plan.grid[0])
               for g in range(plan.groups) for slot in range(plan.rows_per_group)]
    assert sorted(r for r in covered if r is not None) == list(range(plan.rows))
    # no block is idle: the last one holds a row
    assert any(plan.row(plan.grid[0] - 1, g, s) is not None
               for g in range(plan.groups) for s in range(plan.rows_per_group))


@pytest.mark.parametrize("c,dtype,threads,vectors", [
    (6144, torch.bfloat16, 256, 3),   # K10 on the SD3 path: a block per row
    (1536, torch.bfloat16, 32, 6),    # K13 on the SD3 path: a warp per row
    (2048, torch.bfloat16, 32, 8),    # the widest warp row
    (2056, torch.bfloat16, 128, 3),   # one vector past it
    (4096, torch.bfloat16, 128, 4),
    (16384, torch.bfloat16, 256, 8),  # 32 KB, the widest row
    (6144, torch.float32, 256, 6),
    (8, torch.bfloat16, 32, 1),
])
def test_row_plan_threads_per_row(c, dtype, threads, vectors):
    """A warp per row while a lane holds at most 8 vectors; else the fewest
    threads that hold at most 4 each; else 256 threads of up to 8."""
    plan = rq.row_plan(64, c, dtype)
    assert (plan.threads, plan.vectors) == (threads, vectors)


@pytest.mark.parametrize("rows,c,samples,groups", [
    (8192, 6144, 1, 4),  # K10, image stream: 2048 blocks of 4 rows
    (666, 6144, 1, 2),   # K10, context stream: 333 blocks of 2 rows
    (8192, 1536, 2, 4),  # K13, image stream: 256 blocks of 4 groups of 8 rows
    (666, 1536, 2, 1),   # K13, context stream: 84 blocks, none pipelined
])
def test_row_plan_groups_at_the_sd3_shapes(rows, c, samples, groups):
    """A block walks 4, or 2, row groups where the grid keeps MIN_BLOCKS
    blocks, else 1 (the sweep of `tools/quant_tune.py --part time`)."""
    plan = rq.row_plan(rows, c, torch.bfloat16, samples=samples)
    assert plan.groups == groups
    assert plan.grid[0] * plan.grid[1] >= rq.MIN_BLOCKS or groups == 1


@pytest.mark.parametrize("args,match", [
    ((64, 1536, torch.float16), "bf16 or fp32"),
    ((64, 100, torch.bfloat16), "multiple of 8"),
    ((64, 16392, torch.bfloat16), "exceeds"),
    ((64, 8200, torch.float32), "exceeds"),
    ((0, 1536, torch.bfloat16), "samples"),
    ((9, 1536, torch.bfloat16, 2), "samples"),
])
def test_row_plan_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        rq.row_plan(*args)


def test_row_plan_refuses_a_thread_count_that_cannot_hold_the_row():
    with pytest.raises(ValueError, match="cannot hold"):
        rq.row_plan(64, 6144, torch.bfloat16, threads=64)
    with pytest.raises(ValueError, match="threads per row"):
        rq.row_plan(64, 1536, torch.bfloat16, threads=96)


def _refused(case):
    """(launcher, arguments) for each input K10 or K13 refuses."""
    x = torch.zeros(2, 64, 1536, dtype=torch.bfloat16)
    mod = torch.zeros(2, 1, 1536, dtype=torch.bfloat16)
    wide = torch.zeros(4, 16392, dtype=torch.bfloat16)
    misaligned = torch.zeros(4 * 1536 + 1, dtype=torch.bfloat16)[1:].view(4, 1536)
    adaln = lambda x=x, s=mod, t=mod: (rq.adaln_quant, (x, s, t, 1e-6))
    gelu = lambda x: (rq.gelu_quant, (x,))
    cases = {
        "K10 fp16": gelu(x.half()),
        "K10 int8": gelu(x.to(torch.int8)),
        "K10 C not a multiple of 8": gelu(torch.zeros(4, 1540, dtype=torch.bfloat16)),
        "K10 C above 16384 bf16": gelu(wide),
        "K10 C above 8192 fp32": gelu(torch.zeros(4, 8200)),
        "K10 columns strided": gelu(torch.zeros(4, 3072, dtype=torch.bfloat16)[:, ::2]),
        "K10 rows not contiguous": gelu(torch.zeros(1536, 4, dtype=torch.bfloat16).t()),
        "K10 rows not 16-byte aligned": gelu(misaligned),
        "K13 fp16 x": adaln(x=x.half()),
        "K13 x not (B, N, C)": adaln(x=x[0]),
        "K13 C not a multiple of 8": adaln(x=torch.zeros(2, 64, 100, dtype=torch.bfloat16),
                                           s=torch.zeros(2, 100), t=torch.zeros(2, 100)),
        "K13 rows not contiguous": adaln(x=torch.zeros(2, 1536, 64, dtype=torch.bfloat16)
                                         .transpose(1, 2)),
        "K13 scale batch 3 for x batch 2": adaln(s=torch.zeros(3, 1, 1536)),
        "K13 shift batch 1 for x batch 2": adaln(t=torch.zeros(1, 1536)),
        "K13 shift width 1544": adaln(t=torch.zeros(2, 1, 1544)),
        "K13 scale fp16": adaln(s=mod.half()),
    }
    return cases[case]


REFUSALS = ["K10 fp16", "K10 int8", "K10 C not a multiple of 8", "K10 C above 16384 bf16",
            "K10 C above 8192 fp32", "K10 columns strided", "K10 rows not contiguous",
            "K10 rows not 16-byte aligned", "K13 fp16 x", "K13 x not (B, N, C)",
            "K13 C not a multiple of 8", "K13 rows not contiguous",
            "K13 scale batch 3 for x batch 2", "K13 shift batch 1 for x batch 2",
            "K13 shift width 1544", "K13 scale fp16"]


def _no_build(monkeypatch):
    from prompt_diffusion_tpu_torch.ops import _build

    def built():
        raise AssertionError("the extension was built")

    monkeypatch.setattr(_build, "cuda_ext", built)


@pytest.mark.parametrize("case", REFUSALS)
def test_row_quant_refuses_before_build(case, monkeypatch):
    """What K10 and K13 refuse raises ValueError in the launcher, before
    the extension is built or a launch is queued: no fallback."""
    _no_build(monkeypatch)
    fn, args = _refused(case)
    with pytest.raises(ValueError):
        fn(*args)


@pytest.mark.parametrize("which", ["K10", "K13 (B,1,6C) chunks", "K13 (B,C)"])
def test_row_quant_accepts_the_model_inputs_without_a_copy(which, monkeypatch):
    """The model's inputs pass every check and reach the build (the
    refusals above are not vacuous): K10's (B, N, 4C) rows, K13's (B, N, C)
    rows with scale and shift as strided chunks of one (B, 1, 6C)
    projection, or (B, C) views."""
    _no_build(monkeypatch)
    x = torch.zeros(2, 64, 1536, dtype=torch.bfloat16)
    if which == "K10":
        call = lambda: rq.gelu_quant(torch.zeros(2, 64, 6144, dtype=torch.bfloat16))
    else:
        proj = torch.zeros(2, 1, 6 * 1536, dtype=torch.bfloat16)
        if which.endswith("(B,C)"):
            proj = proj[:, 0]
        shift, scale = proj.chunk(6, dim=-1)[:2]
        call = lambda: rq.adaln_quant(x, scale, shift, 1e-6)
    with pytest.raises(AssertionError, match="was built"):
        call()


@pytest.mark.parametrize("form", ["(B,1,6C) chunks", "(B,6C) chunks"])
def test_adaln_quant_plain_matches_jax_on_model_views(form, monkeypatch):
    """Plain K13 on bf16 activations with scale and shift as the MMDiT
    passes them (strided chunks of one bf16 projection, (B, 1, 6C) or
    (B, 6C)) against the JAX function on the CPU and its Pallas kernel in
    interpret mode, with the bound of `test_adaln_quant_plain_matches_jax`."""
    rng = np.random.default_rng(6)
    b, n, c = 2, 333, 128
    x = torch.from_numpy((rng.normal(size=(b, n, c)) * 2 + 0.5).astype(np.float32))
    proj = torch.from_numpy((rng.normal(size=(b, 1, 6 * c)) * 0.2).astype(np.float32))
    x, proj = x.bfloat16(), proj.bfloat16()
    if form.startswith("(B,6C)"):
        proj = proj[:, 0]
    shift, scale = proj.chunk(6, dim=-1)[:2]
    assert not scale.is_contiguous()
    got = fused_adaln_quant(x, scale, shift)
    assert got[0].shape == (b, n, c) and got[0].dtype == torch.int8 and got[1].shape == (b, n, 1)
    j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    _assert_codes(got, jadaln.fused_adaln_quant(j(x), j(scale), j(shift)))
    monkeypatch.setattr(jadaln, "_FORCE_INTERPRET", True)
    _assert_codes(got, jadaln.fused_adaln_quant(j(x), j(scale), j(shift)))


@pytest.mark.parametrize("fn", [fused_adaln_quant, fused_adaln])
def test_adaln_refuses_a_modulation_batch_other_than_x(fn):
    """A scale or shift whose batch or width is not x's raises ValueError
    on every device (a reshape could otherwise spread one sample's
    modulation over two)."""
    x = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="scale"):
        fn(x, torch.zeros(1, 32), torch.zeros(2, 16))
    with pytest.raises(ValueError, match="shift"):
        fn(x, torch.zeros(2, 16), torch.zeros(2, 1, 8))


@pytest.mark.parametrize("rows,inner,dtype,threads,vectors", [
    (32768, 1280, torch.bfloat16, 64, 3),   # K7 at 64²: 160 vectors of h and of gate
    (8192, 2560, torch.bfloat16, 128, 3),   # 32²
    (2048, 5120, torch.bfloat16, 256, 3),   # 16² (and 512 rows at 8²)
    (512, 5120, torch.bfloat16, 256, 3),
    (77, 1024, torch.bfloat16, 32, 4),      # a warp holds 4 + 4 vectors
    (5, 1032, torch.bfloat16, 64, 3),       # one vector past a warp row
    (5, 3080, torch.bfloat16, 256, 2),      # past 3 + 3 vectors of 128 threads
    (5, 1544, torch.bfloat16, 128, 2),      # past 3 + 3 vectors of 64 threads
    (9, 4096, torch.float32, 256, 4),       # the widest fp32 K7 row (32 KB)
    (3, 8, torch.bfloat16, 32, 1),
])
def test_row_plan_with_two_inputs_covers_every_output_column_once(rows, inner, dtype, threads,
                                                                  vectors):
    """K7's plan (`inputs=2`: vector v of h and vector v of gate in one
    thread): the threads of a row cover every output column once, both
    halves count against MAX_VECTORS, and the blocks cover every row once."""
    plan = rq.row_plan(rows, inner, dtype, inputs=2)
    assert (plan.threads, plan.vectors, plan.inputs) == (threads, vectors, 2)
    assert 2 * plan.vectors <= rq.MAX_VECTORS
    cols = [f + j for t in range(plan.threads) for f in plan.columns(t)
            for j in range(plan.vec_elems)]
    assert sorted(cols) == list(range(inner))
    covered = [plan.row(blk, g, slot) for blk in range(plan.grid[0])
               for g in range(plan.groups) for slot in range(plan.rows_per_group)]
    assert sorted(r for r in covered if r is not None) == list(range(rows))


@pytest.mark.parametrize("args,kwargs,match", [
    ((64, 1280, torch.bfloat16), dict(inputs=3), "1 or 2 inputs"),
    ((64, 8200, torch.bfloat16), dict(inputs=2), "exceeds"),
    ((64, 4104, torch.float32), dict(inputs=2), "exceeds"),
    ((64, 5120, torch.bfloat16), dict(inputs=2, threads=128), "cannot hold"),
    ((64, 1284, torch.bfloat16), dict(inputs=2), "multiple of 8"),
])
def test_row_plan_with_two_inputs_refuses(args, kwargs, match):
    with pytest.raises(ValueError, match=match):
        rq.row_plan(*args, **kwargs)
