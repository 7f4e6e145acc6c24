"""PyTorch port, K12's backward (`fused_adaln_bwd`): the plain backward
against `jax.vjp` of the JAX `fused_adaln` (its `custom_vjp` `_bwd`), the
CPU dispatch of `_AdaLN`, the backward kernel's launch plan
(`row_quant.adaln_bwd_plan`) and an emulation of its order of sums, and the
refusals of K12's two launchers before any build. The kernels themselves
run only on the card (`chip_smoke.py`, `tools/quant_tune.py`). Inputs come
from numpy seeds; each test states its bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prompt_diffusion_tpu.ops import fused_adaln as jadaln
from prompt_diffusion_tpu_torch.ops import fused_adaln as ada
from prompt_diffusion_tpu_torch.ops import row_quant as rq

torch.set_num_threads(2)

EPS = 1e-6
FP32_REL_BOUND = 1e-5  # fp32 sums in another order, relative to the largest gradient
BF16_STEP = 2.0 ** -7  # one bf16 step, relative: two roundings of nearly equal fp32 values


def _inputs(seed, n, form, c=64, b=2):
    rng = np.random.default_rng(seed)
    mod = (b, 1, c) if form == "B1C" else (b, c)
    x = (rng.normal(size=(b, n, c)) * 2 + 0.5).astype(np.float32)
    scale, shift = ((rng.normal(size=mod) * 0.3).astype(np.float32) for _ in range(2))
    g = rng.normal(size=(b, n, c)).astype(np.float32)
    return x, scale, shift, g


def _jax_grads(x, scale, shift, g):
    """`jax.vjp` of the JAX `fused_adaln` (its `_bwd`) at the cotangent g."""
    args = [jnp.asarray(a) for a in (x, scale, shift)]
    _, vjp = jax.vjp(jadaln.fused_adaln, *args)
    return [np.asarray(a, np.float32) for a in vjp(jnp.asarray(g))]


def _torch_grads(x, scale, shift, g, dtype=torch.float32):
    t = lambda a: torch.from_numpy(a).to(dtype)
    return ada._torch_adaln_bwd(t(x), t(scale), t(g), EPS, t(shift))


@pytest.mark.parametrize("form", ["B1C", "BC"])
@pytest.mark.parametrize("n", [32, 154, 333])  # a multiple of 8, the SD3 context lengths
def test_plain_backward_matches_jax_vjp(n, form):
    """fp32: dx, dscale and dshift of `_torch_adaln_bwd` within
    FP32_REL_BOUND of the largest of each JAX gradient, in the inputs'
    shapes and dtypes."""
    x, scale, shift, g = _inputs(n, n, form)
    got = _torch_grads(x, scale, shift, g)
    want = _jax_grads(x, scale, shift, g)
    for a, ref, like in zip(got, want, (x, scale, shift)):
        assert a.dtype == torch.float32 and tuple(a.shape) == like.shape == ref.shape
        np.testing.assert_allclose(a.numpy(), ref, rtol=0,
                                   atol=FP32_REL_BOUND * np.abs(ref).max())


@pytest.mark.parametrize("form", ["B1C", "BC"])
@pytest.mark.parametrize("n", [32, 333])
def test_plain_backward_matches_jax_vjp_bf16(n, form):
    """bf16 x, scale, shift and g: both frameworks compute in fp32 and round
    each gradient once to bf16, so they agree within one bf16 step of each
    value (BF16_STEP relative) plus the fp32 term (FP32_REL_BOUND of the
    largest gradient)."""
    x, scale, shift, g = (np.asarray(torch.from_numpy(a).bfloat16().float())
                          for a in _inputs(n + 1, n, form))
    got = _torch_grads(x, scale, shift, g, torch.bfloat16)
    assert all(a.dtype == torch.bfloat16 for a in got)
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    _, vjp = jax.vjp(jadaln.fused_adaln, jb(x), jb(scale), jb(shift))
    want = [np.asarray(a.astype(jnp.float32)) for a in vjp(jb(g))]
    for a, ref in zip(got, want):
        np.testing.assert_allclose(a.float().numpy(), ref, rtol=BF16_STEP,
                                   atol=FP32_REL_BOUND * np.abs(ref).max())


def _no_kernels(monkeypatch):
    def launched(*_args, **_kwargs):
        raise AssertionError("a kernel launcher was called")

    for name in ("adaln", "adaln_bwd"):
        monkeypatch.setattr(ada, name, launched)


@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16, torch.float32)])
def test_cpu_adaln_takes_the_plain_forward_and_backward(dtypes, monkeypatch):
    """On CPU tensors `_AdaLN` runs `_torch_adaln` forward and
    `_torch_adaln_bwd` backward (bit for bit), never a launcher, counts no
    launch, and returns each gradient in its input's shape and dtype."""
    _no_kernels(monkeypatch)
    xd, sd, td = dtypes
    x, scale, shift, g = _inputs(7, 40, "BC")
    x, g = torch.from_numpy(x).to(xd), torch.from_numpy(g).to(xd)
    scale = torch.from_numpy(scale).to(sd).requires_grad_()
    shift = torch.from_numpy(shift).reshape(2, 1, 64).to(td).requires_grad_()
    x.requires_grad_()
    before = (ada.fused_adaln.launches, ada.fused_adaln.backward_launches)
    out = ada.fused_adaln(x, scale, shift)
    out.backward(g)
    assert out.dtype == xd
    assert torch.equal(out, ada._torch_adaln(x, scale.reshape(2, 1, 64), shift, EPS).to(xd))
    want = ada._torch_adaln_bwd(x.detach(), scale.detach(), g, EPS, shift.detach())
    for t, ref in zip((x, scale, shift), want):
        assert t.grad.shape == t.shape and t.grad.dtype == t.dtype
        assert torch.equal(t.grad, ref)
    assert (ada.fused_adaln.launches, ada.fused_adaln.backward_launches) == before


# (samples, rows, C, dtype, occupancy, SMs, threads, blocks per SM cap): the
# SD3 image and context streams at bf16 and fp32, ragged rows and vectors,
# a batch that takes a block per sample, rows of several warps, 32 KB rows,
# and the sweep's forced plans
BWD_PLANS = [
    (2, 4096, 1536, torch.bfloat16, 2, 132, None, None),
    (2, 4096, 1536, torch.float32, 2, 132, None, None),
    (2, 333, 1536, torch.bfloat16, 2, 132, None, None),
    (2, 154, 1536, torch.float32, 1, 132, None, None),
    (3, 77, 4096, torch.bfloat16, 2, 132, None, None),
    (2, 5, 16384, torch.bfloat16, 1, 132, None, None),
    (1, 9, 8, torch.float32, 3, 132, None, None),
    (4, 1000, 8192, torch.float32, 1, 132, None, None),
    (264, 20, 1536, torch.bfloat16, 2, 132, None, None),
    (2, 4096, 1536, torch.bfloat16, 4, 132, 32, None),
    (2, 4096, 1536, torch.bfloat16, 4, 132, 128, 1),
    (2, 333, 1536, torch.float32, 2, 132, 256, None),
    (5, 1001, 2056, torch.bfloat16, 2, 7, None, None),
]


def _bwd_plan(case):
    samples, rows, c, dtype, occ, sms, threads, per_sm = case
    return rq.adaln_bwd_plan(samples, rows, c, dtype, occupancy=lambda v: occ, sms=sms,
                             threads=threads, per_sm=per_sm)


def _bwd_id(case):
    samples, rows, c, dtype, occ, sms, threads, per_sm = case
    return f"{samples}x{rows}x{c}-{str(dtype)[6:]}-occ{occ}-sms{sms}-t{threads}-cap{per_sm}"


@pytest.mark.parametrize("case", BWD_PLANS, ids=_bwd_id)
def test_backward_plan_covers_every_row_and_column_once(case):
    """The backward's maps: a row's threads cover every column once in
    16-byte vectors; the blocks of every sample cover each of its rows
    once; the grid (blocks per sample x samples) fits the card at once;
    the blocks' merges cover each of a sample's 2C sums once, and a sum's
    lanes each block's partial once; the workspace holds a (2, C) fp32
    partial per block."""
    samples, rows, c, dtype, occ, sms, threads, per_sm = case
    plan = _bwd_plan(case)
    row = plan.row
    size = torch.empty((), dtype=dtype).element_size()
    assert row.vec_elems * size == rq.VEC_BYTES and row.c == c and row.rows == rows
    assert row.threads in rq.BWD_THREADS and row.vectors <= rq.MAX_VECTORS
    cols = [f + j for t in range(row.threads) for f in row.columns(t)
            for j in range(row.vec_elems)]
    assert sorted(cols) == list(range(c))
    covered = [row.row(blk, g, slot) for blk in range(plan.bps) for g in range(row.groups)
               for slot in range(row.rows_per_group)]
    assert sorted(r for r in covered if r is not None) == list(range(rows))
    assert plan.samples == samples
    assert plan.samples * plan.bps <= min(occ, per_sm or occ) * sms
    sums = [q for blk in range(plan.bps) for q in plan.merge_sums(blk)]
    assert sums == list(range(2 * c))
    assert 1 <= plan.merge_lanes <= plan.bps and plan.merge_lanes & (plan.merge_lanes - 1) == 0
    assert rq.BLOCK_THREADS % plan.merge_lanes == 0
    lanes = [j for lane in range(plan.merge_lanes) for j in plan.merge_blocks(lane)]
    assert sorted(lanes) == list(range(plan.bps))
    assert plan.workspace == samples * plan.bps * 2 * c


@pytest.mark.parametrize("c,dtype,threads,vectors", [
    (1536, torch.bfloat16, 64, 3),    # the SD3 streams: 24 columns a thread
    (1536, torch.float32, 128, 3),    # 12 columns
    (768, torch.bfloat16, 32, 3),
    (4096, torch.bfloat16, 256, 2),   # 128 threads would hold 4 vectors
    (3080, torch.bfloat16, 256, 2),   # one vector past 128 threads of 3
    (16384, torch.bfloat16, 256, 8),  # the widest row: 64 columns a thread
    (8, torch.float32, 32, 1),
])
def test_backward_plan_threads_per_row(c, dtype, threads, vectors):
    """The fewest of BWD_THREADS whose threads hold at most BWD_VECTORS
    vectors each, else 256."""
    plan = rq.adaln_bwd_plan(2, 64, c, dtype)
    assert (plan.row.threads, plan.row.vectors) == (threads, vectors)


def test_backward_plan_at_the_sd3_image_stream():
    """(2, 4096, 1536) bf16 at 2 blocks per SM on 132 SMs: 132 blocks per
    sample at most, so 8 row groups of 4 rows a block and 128 blocks a
    sample; a block merges 24 of the sample's 3072 sums, 8 lanes each."""
    plan = rq.adaln_bwd_plan(2, 4096, 1536, torch.bfloat16, occupancy=lambda v: 2, sms=132)
    assert (plan.row.rows_per_group, plan.row.groups, plan.bps) == (4, 8, 128)
    assert len(plan.merge_sums(0)) == 24 and plan.merge_lanes == 8
    assert plan.workspace == 2 * 128 * 3072


@pytest.mark.parametrize("kwargs,match", [
    (dict(samples=265, occupancy=lambda v: 2), "exceeds"),
    (dict(samples=2, occupancy=lambda v: 0), "no block"),
    (dict(samples=2, threads=16), "threads per row"),
    (dict(samples=2, threads=32, c=4096), "cannot hold"),
    (dict(samples=2, dtype=torch.float16), "bf16 or fp32"),
    (dict(samples=2, c=100), "multiple of 8"),
    (dict(samples=2, c=16392), "exceeds"),
])
def test_backward_plan_refuses(kwargs, match):
    args = dict(samples=2, rows=64, c=1536, dtype=torch.bfloat16, sms=132)
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        rq.adaln_bwd_plan(**args)


def _emulated_sums(x, scale, g, plan):
    """dscale and dshift in the kernel's order of fp32 sums: per thread over
    its rows (a row slot's row groups in order), the block's row slots in
    slot order, then per sum each lane over its blocks in order and the
    lanes in lane order."""
    row = plan.row
    xf, gf = x.float(), g.float()
    mean = xf.mean(-1, keepdim=True)
    d = xf - mean
    xh = d * torch.rsqrt(d.square().mean(-1, keepdim=True) + EPS)
    sums = torch.zeros(plan.samples, 2 * row.c)
    for b in range(plan.samples):
        parts = []
        for blk in range(plan.bps):
            block = torch.zeros(2 * row.c)
            for slot in range(row.rows_per_group):
                acc = torch.zeros(2 * row.c)
                for grp in range(row.groups):
                    r = row.row(blk, grp, slot)
                    if r is not None:
                        acc = acc + torch.cat([gf[b, r], gf[b, r] * xh[b, r]])
                block = block + acc
            parts.append(block)
        lanes = []
        for lane in range(plan.merge_lanes):
            acc = torch.zeros(2 * row.c)
            for j in plan.merge_blocks(lane):
                acc = acc + parts[j]
            lanes.append(acc)
        total = lanes[0]
        for acc in lanes[1:]:
            total = total + acc
        sums[b] = total
    return sums[:, row.c:], sums[:, :row.c]


@pytest.mark.parametrize("b,n,c,occ,sms", [(2, 333, 256, 2, 13), (3, 700, 128, 1, 40)])
def test_emulated_kernel_order_within_the_fp32_sum_order_bound(b, n, c, occ, sms):
    """dscale and dshift summed in the kernel's order (`_emulated_sums`)
    within FP32_REL_BOUND of the plain backward's, relative to the largest
    of each."""
    x, scale, _, g = (torch.from_numpy(a) for a in _inputs(b + n, n, "BC", c=c, b=b))
    plan = rq.adaln_bwd_plan(b, n, c, torch.float32, occupancy=lambda v: occ, sms=sms)
    assert plan.bps > 1 and plan.row.groups > 1 and plan.merge_lanes > 1
    dscale, dshift = _emulated_sums(x, scale, g, plan)
    _, want_scale, want_shift = ada._torch_adaln_bwd(x, scale, g, EPS)
    for got, want in ((dscale, want_scale), (dshift, want_shift)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=FP32_REL_BOUND * want.abs().max().item())


def _no_build(monkeypatch):
    from prompt_diffusion_tpu_torch.ops import _build

    def built():
        raise AssertionError("the extension was built")

    monkeypatch.setattr(_build, "cuda_ext", built)


def _refused(case):
    """(launcher, arguments) for each input K12's forward or backward
    refuses."""
    x = torch.zeros(2, 64, 1536, dtype=torch.bfloat16)
    mod = torch.zeros(2, 1, 1536, dtype=torch.bfloat16)
    fwd = lambda x=x, s=mod, t=mod: (rq.adaln, (x, s, t, EPS))
    bwd = lambda x=x, s=mod, g=x, t=None: (rq.adaln_bwd, (x, s, g, EPS, t))
    cases = {
        "fwd fp16 x": fwd(x=x.half()),
        "fwd x not (B, N, C)": fwd(x=x[0]),
        "fwd C not a multiple of 8": fwd(x=torch.zeros(2, 64, 100, dtype=torch.bfloat16),
                                         s=torch.zeros(2, 100), t=torch.zeros(2, 100)),
        "fwd C above 16384 bf16": fwd(x=torch.zeros(2, 4, 16392, dtype=torch.bfloat16),
                                      s=torch.zeros(2, 16392), t=torch.zeros(2, 16392)),
        "fwd rows not contiguous": fwd(x=torch.zeros(2, 1536, 64, dtype=torch.bfloat16)
                                       .transpose(1, 2)),
        "fwd scale batch 3 for x batch 2": fwd(s=torch.zeros(3, 1, 1536)),
        "fwd shift width 1544": fwd(t=torch.zeros(2, 1, 1544)),
        "fwd scale fp16": fwd(s=mod.half()),
        "bwd fp16 x": bwd(x=x.half(), g=x.half()),
        "bwd x not (B, N, C)": bwd(x=x[0], g=x[0]),
        "bwd C above 8192 fp32": bwd(x=torch.zeros(2, 4, 8200), s=torch.zeros(2, 8200),
                                     g=torch.zeros(2, 4, 8200)),
        "bwd g of another shape": bwd(g=x[:, :32]),
        "bwd g of another dtype": bwd(g=x.float()),
        "bwd g columns strided": bwd(g=torch.zeros(2, 64, 3072, dtype=torch.bfloat16)[..., ::2]),
        "bwd x rows not contiguous": bwd(x=torch.zeros(2, 1536, 64, dtype=torch.bfloat16)
                                         .transpose(1, 2)),
        "bwd scale batch 1 for x batch 2": bwd(s=torch.zeros(1, 1536)),
        "bwd scale fp16": bwd(s=mod.half()),
        "bwd shift width 1544": bwd(t=torch.zeros(2, 1544)),
    }
    return cases[case]


REFUSALS = ["fwd fp16 x", "fwd x not (B, N, C)", "fwd C not a multiple of 8",
            "fwd C above 16384 bf16", "fwd rows not contiguous",
            "fwd scale batch 3 for x batch 2", "fwd shift width 1544", "fwd scale fp16",
            "bwd fp16 x", "bwd x not (B, N, C)", "bwd C above 8192 fp32",
            "bwd g of another shape", "bwd g of another dtype", "bwd g columns strided",
            "bwd x rows not contiguous", "bwd scale batch 1 for x batch 2", "bwd scale fp16",
            "bwd shift width 1544"]


@pytest.mark.parametrize("case", REFUSALS)
def test_adaln_launchers_refuse_before_build(case, monkeypatch):
    """What K12's forward and backward refuse raises ValueError in the
    launcher, before the extension is built or a launch is queued: no
    fallback."""
    _no_build(monkeypatch)
    fn, args = _refused(case)
    with pytest.raises(ValueError):
        fn(*args)


@pytest.mark.parametrize("which", ["fwd", "bwd (B,1,6C) chunks", "bwd strided g"])
def test_adaln_launchers_accept_the_path_inputs(which, monkeypatch):
    """The `[adaln]` path's inputs pass every check and reach the build (the
    refusals above are not vacuous): K12's rows with scale and shift as
    (B, C) or strided (B, 1, C) chunks of one projection; the backward's g
    as a slice with its own row stride."""
    _no_build(monkeypatch)
    x = torch.zeros(2, 333, 1536, dtype=torch.bfloat16)
    shift, scale = torch.zeros(2, 1, 6 * 1536, dtype=torch.bfloat16).chunk(6, dim=-1)[:2]
    if which == "fwd":
        call = lambda: rq.adaln(x, scale[:, 0], shift[:, 0], EPS)
    elif which.endswith("chunks"):
        call = lambda: rq.adaln_bwd(x, scale, x, EPS, shift)
    else:
        g = torch.zeros(2, 400, 1536, dtype=torch.bfloat16)[:, :333]
        call = lambda: rq.adaln_bwd(x, scale, g, EPS)
    with pytest.raises(AssertionError, match="was built"):
        call()
