"""PyTorch port, K6 (LayerNorm -> int8) and K11 (row -> int8) on the card,
ops LN and ROWS of `ops/csrc/row_quant.cu`: K6's sites derived from the
port's SD1.5 models, `row_plan` at both kernels' shapes (rows of 8 and 16
threads included), the launchers' refusals before any build, what they
hand the extension for the model inputs (an extension stand-in reads the
rows through the pointers and strides it is given, walks the plan's blocks
and computes the plain function), a numpy emulation of K6's order of work,
and the plain K6 and K11 against the JAX package. The kernels themselves
run only on the card (`chip_smoke.py`, `tools/quant_tune.py --kernels
K6,K11 --part check`)."""

import contextlib
import ctypes
import importlib
import pkgutil
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prompt_diffusion_tpu.ops import fused_act as jfa
from prompt_diffusion_tpu.ops import fused_layer_norm as jln
from prompt_diffusion_tpu_torch import ops as port_ops
from prompt_diffusion_tpu_torch.ops import row_quant as rq
from prompt_diffusion_tpu_torch.ops.fused_act import fused_quant_rows
from prompt_diffusion_tpu_torch.ops.fused_layer_norm import (
    _layer_norm_f32,
    fused_layer_norm_quant,
    rowquant,
)
from tests.test_torch_sd3_ops import _assert_codes

torch.set_num_threads(2)

BATCH = 8  # CFG batch of a request of 4
# K6's calls of one SD1.5 int8 denoise step at CFG batch 8: three pre-LNs
# in each of the 16 UNet and 7 ControlNet transformer blocks, (rows, C, eps)
SD15_K6 = {(32768, 320, 1e-5): 21, (8192, 640, 1e-5): 21, (2048, 1280, 1e-5): 21,
           (512, 1280, 1e-5): 6}
VIT_K6 = (16 * 1025, 768, 1e-6)  # DPT-Hybrid ViT-B, batch 16 at 512², 24 calls a forward
# K11's: the MMDiT's attention output (B, N_h + N_c, C) at CFG batch 2
SD3_K11 = (2, 4096, 333, 1536)


@pytest.fixture(scope="module")
def sd15_k6_sites():
    """The K6 calls of one SD1.5 int8 CFG denoise step, recorded by
    `profile_sd15.k6_calls` from the port's models at their default widths
    on the meta device (shapes only; every wrapper takes its plain version
    there)."""
    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
    from prompt_diffusion_tpu_torch.tools.profile_sd15 import k6_calls
    from prompt_diffusion_tpu_torch.utils.dtypes import int8_policy

    patch = pytest.MonkeyPatch()
    for info in pkgutil.iter_modules(port_ops.__path__):
        if info.name.startswith("_triton"):
            continue  # import triton at their top; they hold no wrapper
        mod = importlib.import_module(f"{port_ops.__name__}.{info.name}")
        if hasattr(mod, "use_kernel"):
            patch.setattr(mod, "use_kernel", lambda x: False)
    try:
        pipe = PromptDiffusionSD15.create(policy=int8_policy(), device="meta")
        meta = lambda *s: torch.zeros(s, device="meta")
        b = BATCH // 2
        ids = torch.zeros((b, 77), dtype=torch.long, device="meta")
        eps_fn = pipe.make_eps_fn(token_ids=ids, neg_token_ids=ids,
                                  example_pair=meta(b, 512, 512, 6), query=meta(b, 512, 512, 3),
                                  guidance_scale=9.0)
        x = meta(b, 4, 64, 64).contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            return k6_calls(lambda: eps_fn(
                x, torch.full((b,), 999, dtype=torch.int32, device="meta")))
    finally:
        patch.undo()


def test_sd15_int8_step_k6_sites_from_the_port_models(sd15_k6_sites):
    """69 K6 calls per SD1.5 int8 denoise step at the rows listed above
    (the shapes the plan tests below and `chip_smoke.py` cover)."""
    assert sd15_k6_sites == SD15_K6


def _covers(plan, c, dtype):
    """The kernel's maps: the row's threads cover every column once in
    16-byte vectors, within MAX_VECTORS each; a block's rows are whole
    multiples of its threads (sub-warp rows sit on aligned lanes of one
    warp); the grid's blocks cover every row of every sample once."""
    size = torch.empty((), dtype=dtype).element_size()
    assert plan.vec_elems * size == rq.VEC_BYTES and plan.c == c
    assert plan.threads in rq.ROW_THREADS and plan.vectors <= rq.MAX_VECTORS
    assert plan.threads * plan.rows_per_group == rq.BLOCK_THREADS
    assert rq.WARP % plan.threads == 0 or plan.threads % rq.WARP == 0
    cols = [f + j for t in range(plan.threads) for f in plan.columns(t)
            for j in range(plan.vec_elems)]
    assert sorted(cols) == list(range(c))
    covered = [plan.row(blk, g, slot) for blk in range(plan.grid[0])
               for g in range(plan.groups) for slot in range(plan.rows_per_group)]
    assert sorted(r for r in covered if r is not None) == list(range(plan.rows))
    assert any(plan.row(plan.grid[0] - 1, g, s) is not None
               for g in range(plan.groups) for s in range(plan.rows_per_group))


# (rows, C, dtype, samples, threads, groups): K6 at the SD1.5 rows (CFG
# batch 8 and 4), the ViT-B's, ragged, fp32, 32 KB rows and the plans of 8
# to 64 threads that `quant_tune --part time` sweeps; K11 per sample on the
# MMDiT's slices, on contiguous rows, fp32 and ragged
PLANS = [
    *[(r, c, torch.bfloat16, 1, None, None) for r, c, _ in SD15_K6],
    (16384, 320, torch.bfloat16, 1, None, None), (256, 1280, torch.bfloat16, 1, None, None),
    (VIT_K6[0], 768, torch.bfloat16, 1, None, None), (1000, 640, torch.float32, 1, None, None),
    (37, 328, torch.bfloat16, 1, None, None), (3, 16384, torch.bfloat16, 1, None, None),
    (32768, 320, torch.bfloat16, 1, 8, None), (32768, 320, torch.bfloat16, 1, 16, 2),
    (8192, 640, torch.bfloat16, 1, 16, None), (8192, 640, torch.bfloat16, 1, 16, 4),
    (2048, 1280, torch.bfloat16, 1, 64, 1), (77, 320, torch.float32, 1, 16, 1),
    (2 * 4096, 1536, torch.bfloat16, 2, None, None), (2 * 333, 1536, torch.bfloat16, 2, None, None),
    (2 * 4096, 1536, torch.bfloat16, 2, 64, 2), (2 * 333, 1536, torch.bfloat16, 2, 128, 4),
    (8192, 1536, torch.bfloat16, 1, None, None), (2 * 154, 1536, torch.float32, 2, None, None),
    (3 * 37, 2056, torch.bfloat16, 3, None, None),
]


@pytest.mark.parametrize("case", PLANS, ids=lambda c: f"{c[0]}x{c[1]}-{str(c[2])[6:]}-s{c[3]}"
                         f"-t{c[4]}-g{c[5]}")
def test_row_plan_covers_k6_and_k11_rows(case):
    rows, c, dtype, samples, threads, groups = case
    _covers(rq.row_plan(rows, c, dtype, samples=samples, threads=threads, groups=groups), c,
            dtype)


@pytest.mark.parametrize("c,dtype,inputs,threads,vectors", [
    (320, torch.bfloat16, 1, 8, 5),     # K6 at 64²: 40 vectors, no lane idle
    (640, torch.bfloat16, 1, 16, 5),    # K6 at 32²: 80
    (1280, torch.bfloat16, 1, 32, 5),   # K6 at 16² and 8²: a warp
    (768, torch.bfloat16, 1, 32, 3),    # the ViT-B: 16 threads would hold 6
    (1536, torch.bfloat16, 1, 32, 6),   # K11 and K13: a warp
    (328, torch.bfloat16, 1, 32, 2),    # 41 vectors: no narrow plan leaves no lane idle
    (320, torch.float32, 1, 16, 5),     # 80 fp32 vectors
    (640, torch.float32, 1, 32, 5),     # 160
    (8, torch.bfloat16, 1, 32, 1),
    (320, torch.bfloat16, 2, 32, 2),    # K7's two inputs stay a warp
])
def test_row_plan_narrows_one_input_rows(c, dtype, inputs, threads, vectors):
    """8 or 16 aligned lanes of a warp per row where they hold a one-input
    row with no lane idle and at most NARROW_VECTORS vectors each; a warp
    otherwise (the sweep behind the rule: `quant_tune --part time`)."""
    plan = rq.row_plan(4096, c, dtype, inputs=inputs)
    assert (plan.threads, plan.vectors) == (threads, vectors)


@pytest.mark.parametrize("args,match", [
    ((64, 320, torch.bfloat16, 1, 4), "threads per row"),
    ((64, 320, torch.bfloat16, 1, 24), "threads per row"),
    ((64, 1536, torch.bfloat16, 1, 16), "cannot hold"),   # 192 vectors, 12 a thread
    ((64, 768, torch.bfloat16, 1, 8), "cannot hold"),     # 96 vectors, 12 a thread
    ((70000, 1536, torch.bfloat16, 70000), "samples exceed"),
])
def test_row_plan_refuses_narrow_rows_it_cannot_hold(args, match):
    rows, c, dtype, samples, *threads = args
    with pytest.raises(ValueError, match=match):
        rq.row_plan(rows, c, dtype, samples=samples, threads=threads[0] if threads else None)


def _no_build(monkeypatch):
    from prompt_diffusion_tpu_torch.ops import _build

    def built():
        raise AssertionError("the extension was built")

    monkeypatch.setattr(_build, "cuda_ext", built)


def _misaligned(shape, dtype=torch.bfloat16, offset=1):
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


def _refused(case):
    """(launcher, arguments) for each input K6 or K11 refuses."""
    x = torch.zeros(4, 64, 320, dtype=torch.bfloat16)
    w, b = torch.ones(320), torch.zeros(320)
    ln = lambda x=x, w=w, b=b: (rq.ln_quant, (x, w, b, 1e-5))
    attn = torch.zeros(2, 77, 1536, dtype=torch.bfloat16)
    rows = lambda x: (rq.quant_rows, (x,))
    cases = {
        "K6 fp16": ln(x=x.half()),
        "K6 int8": ln(x=x.to(torch.int8)),
        "K6 C not a multiple of 8": ln(x=torch.zeros(4, 324), w=torch.ones(324),
                                       b=torch.zeros(324)),
        "K6 C above 16384 bf16": ln(x=torch.zeros(4, 16392, dtype=torch.bfloat16),
                                    w=torch.ones(16392), b=torch.zeros(16392)),
        "K6 columns strided": ln(x=torch.zeros(4, 640, dtype=torch.bfloat16)[:, ::2]),
        "K6 rows not contiguous": ln(x=torch.zeros(320, 4, dtype=torch.bfloat16).t()),
        "K6 rows that do not flatten": ln(x=torch.zeros(4, 80, 320, dtype=torch.bfloat16)[:, :64]),
        "K6 rows not 16-byte aligned": ln(x=_misaligned((4, 64, 320))),
        "K6 weight width 328": ln(w=torch.ones(328)),
        "K6 bias (1, C)": ln(b=torch.zeros(1, 320)),
        "K6 weight fp16": ln(w=torch.ones(320, dtype=torch.float16)),
        "K6 bias int": ln(b=torch.zeros(320, dtype=torch.int32)),
        "K6 plan for other rows": (rq.ln_quant, (x, w, b, 1e-5,
                                                 rq.row_plan(255, 320, torch.bfloat16))),
        "K6 plan for fp32 rows": (rq.ln_quant, (x, w, b, 1e-5,
                                                rq.row_plan(256, 320, torch.float32))),
        "K11 fp16": rows(attn.half()),
        "K11 C not a multiple of 8": rows(torch.zeros(2, 77, 1540, dtype=torch.bfloat16)),
        "K11 columns strided": rows(torch.zeros(2, 77, 3072, dtype=torch.bfloat16)[..., ::2]),
        "K11 rows overlapping": rows(torch.zeros(2, 77, 1536, dtype=torch.bfloat16)
                                     .as_strided((2, 77, 1536), (77 * 1536, 8, 1))),
        "K11 slice not 16-byte aligned": rows(_misaligned((2, 77, 1536), offset=3)[:, 5:]),
        "K11 row stride not 16-byte aligned": rows(
            torch.zeros(2, 77, 1540, dtype=torch.bfloat16)[..., :1536]),
        "K11 fp32 rows at an odd element": rows(_misaligned((2, 77, 64), torch.float32)),
        "K11 plan for one sample": (rq.quant_rows, (attn[:, :40], rq.row_plan(80, 1536,
                                                                              torch.bfloat16))),
    }
    return cases[case]


REFUSALS = ["K6 fp16", "K6 int8", "K6 C not a multiple of 8", "K6 C above 16384 bf16",
            "K6 columns strided", "K6 rows not contiguous", "K6 rows that do not flatten",
            "K6 rows not 16-byte aligned", "K6 weight width 328", "K6 bias (1, C)",
            "K6 weight fp16", "K6 bias int", "K6 plan for other rows", "K6 plan for fp32 rows",
            "K11 fp16", "K11 C not a multiple of 8", "K11 columns strided",
            "K11 rows overlapping", "K11 slice not 16-byte aligned",
            "K11 row stride not 16-byte aligned", "K11 fp32 rows at an odd element",
            "K11 plan for one sample"]


@pytest.mark.parametrize("case", REFUSALS)
def test_ln_and_rows_quant_refuse_before_build(case, monkeypatch):
    """What K6 and K11 refuse raises ValueError in the launcher, before the
    extension is built or a launch is queued: no fallback."""
    _no_build(monkeypatch)
    fn, args = _refused(case)
    with pytest.raises(ValueError):
        fn(*args)


# ---- the launchers against an extension stand-in --------------------------


def _host(ptr, dtype, offsets):
    """The values at element `offsets` from host address `ptr`, as fp32."""
    n = int(offsets.max()) + 1
    ctype = {torch.bfloat16: ctypes.c_uint16, torch.float32: ctypes.c_float}[dtype]
    raw = np.frombuffer((ctype * n).from_address(ptr), dtype=np.dtype(ctype))[offsets]
    return raw.astype(np.uint32) << 16 if dtype == torch.bfloat16 else raw


def _f32(bits):
    return bits.view(np.float32) if bits.dtype == np.uint32 else bits


class _Ext:
    """Stands in for the extension: records each `row_quant` call and does
    its work on host memory through the pointers and element strides it is
    given, walking the plan's blocks, groups and row slots as the kernel
    does (each row of each sample written once), with the plain function
    of the op in fp32."""

    def __init__(self):
        self.calls = []

    def row_quant(self, op, x, x_bf16, x_sb, x_sn, batch, n, c, sc, sc_bf16, sc_sb, sc_sc, sh,
                  sh_bf16, sh_sb, sh_sc, eps, tpr, vpt, groups, grid_x, codes, scales, stream):
        self.calls.append(dict(op=op, x=x, x_sb=x_sb, x_sn=x_sn, batch=batch, n=n, c=c, sc=sc,
                               sc_sb=sc_sb, sc_sc=sc_sc, sh=sh, sh_sb=sh_sb, sh_sc=sh_sc,
                               eps=eps, tpr=tpr))
        dt = torch.bfloat16 if x_bf16 else torch.float32
        assert tpr * vpt * rq.VEC_BYTES // dt.itemsize >= c
        rpb = rq.BLOCK_THREADS // tpr
        slots = [(blk * groups + g) * rpb + s for blk in range(grid_x) for g in range(groups)
                 for s in range(rpb)]
        rows = np.array([r for r in slots if r < n])
        assert sorted(rows) == list(range(n))
        written = np.zeros(batch * n, dtype=np.int64)
        out_q = np.frombuffer((ctypes.c_int8 * (batch * n * c)).from_address(codes),
                              dtype=np.int8).reshape(batch * n, c)
        out_s = np.frombuffer((ctypes.c_float * (batch * n)).from_address(scales),
                              dtype=np.float32)
        for b in range(batch):
            offs = b * x_sb + rows[:, None] * x_sn + np.arange(c)[None, :]
            y = torch.from_numpy(_f32(_host(x, dt, offs)).copy())
            if op == rq.LN:
                cols = np.arange(c)
                w = torch.from_numpy(_f32(_host(sc, torch.bfloat16 if sc_bf16 else torch.float32,
                                                b * sc_sb + cols * sc_sc)).copy())
                bias = torch.from_numpy(_f32(_host(sh, torch.bfloat16 if sh_bf16
                                                   else torch.float32,
                                                   b * sh_sb + cols * sh_sc)).copy())
                y = _layer_norm_f32(y, w, bias, eps)
            else:
                assert op == rq.ROWS
            q, s = rowquant(y)
            out_q[b * n + rows] = q.numpy()
            out_s[b * n + rows] = s[:, 0].numpy()
            np.add.at(written, b * n + rows, 1)
        assert (written == 1).all()


@pytest.fixture
def ext(monkeypatch):
    """The stand-in extension, and CUDA's device and stream context as
    no-ops, so that the launchers run on CPU tensors."""
    from prompt_diffusion_tpu_torch.ops import _build

    stand_in = _Ext()
    monkeypatch.setattr(_build, "cuda_ext", lambda: stand_in)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return stand_in


def _attn(rng, b, n_h, n_c, c, dtype=torch.bfloat16):
    attn = torch.from_numpy((rng.normal(size=(b, n_h + n_c, c)) * 2).astype(np.float32))
    return attn.to(dtype)


@pytest.mark.parametrize("b,dtype", [(2, torch.bfloat16), (1, torch.bfloat16),
                                     (3, torch.float32)])
@pytest.mark.parametrize("part", ["image", "context"])
def test_quant_rows_reads_the_mmdit_slices_in_place(part, b, dtype, ext):
    """K11 on `attn[:, :n_h]` and `attn[:, n_h:]` of one packed
    (B, N_h + N_c, C) output: one call of the extension with the slice's own
    pointer, its sample stride (N_h + N_c) C and row stride C, B samples of
    the slice's rows; no copy (the slice is not contiguous for B > 1), and
    the result the plain version's."""
    rng = np.random.default_rng(11 + b)
    n_h, n_c, c = 40, 13, 64
    attn = _attn(rng, b, n_h, n_c, c, dtype)
    x = attn[:, :n_h] if part == "image" else attn[:, n_h:]
    assert x.is_contiguous() == (b == 1)
    q, s = rq.quant_rows(x)
    (call,) = ext.calls
    assert call["x"] == x.data_ptr() and call["op"] == rq.ROWS
    assert (call["batch"], call["n"], call["c"]) == (b, x.shape[1], c)
    assert (call["x_sb"], call["x_sn"]) == ((n_h + n_c) * c, c)
    ref = fused_quant_rows(x)  # the plain version: a CPU tensor
    assert q.shape == x.shape and s.shape == x.shape[:-1] + (1,)
    assert torch.equal(q, ref[0]) and torch.equal(s, ref[1])


@pytest.mark.parametrize("shape,eps", [((4, 64, 320), 1e-5), ((2, 37, 768), 1e-6),
                                       ((3, 16, 1280), 1e-5), ((5, 640), 1e-5)],
                         ids=["SD1.5 64² rows", "ViT-B rows", "SD1.5 8² rows", "2-D rows"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ln_quant_reads_the_model_rows_in_place(shape, eps, dtype, ext):
    """K6 on the transformer blocks' (B, N, C) rows: one call with x's own
    pointer as one sample of B·N rows, the module's fp32 (C,) weight and
    bias by pointer with sample stride 0, eps, and the plain version's
    result."""
    rng = np.random.default_rng(6)
    c = shape[-1]
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    w = torch.from_numpy((1 + 0.1 * rng.normal(size=c)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.normal(size=c)).astype(np.float32))
    q, s = rq.ln_quant(x, w, b, eps)
    (call,) = ext.calls
    rows = x.numel() // c
    assert call["x"] == x.data_ptr() and call["op"] == rq.LN and call["eps"] == eps
    assert (call["batch"], call["n"], call["c"], call["x_sn"]) == (1, rows, c, c)
    assert (call["sc"], call["sc_sb"], call["sc_sc"]) == (w.data_ptr(), 0, 1)
    assert (call["sh"], call["sh_sb"], call["sh_sc"]) == (b.data_ptr(), 0, 1)
    ref = fused_layer_norm_quant(x, w, b, eps)
    assert torch.equal(q, ref[0]) and torch.equal(s, ref[1])


def test_ln_quant_reads_a_strided_bf16_affine(ext):
    """A bf16 affine with column stride 2 reaches the extension as such and
    gives the plain version's result."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(50, 320)).astype(np.float32)).bfloat16()
    wb = torch.from_numpy((1 + 0.1 * rng.normal(size=(320, 2))).astype(np.float32)).bfloat16()
    w, b = wb[:, 0], wb[:, 1] - 1
    q, s = rq.ln_quant(x, w, b, 1e-5)
    (call,) = ext.calls
    assert (call["sc_sc"], call["sc"]) == (2, w.data_ptr())
    ref = fused_layer_norm_quant(x, w, b, 1e-5)
    assert torch.equal(q, ref[0]) and torch.equal(s, ref[1])


# ---- K6's order of work ---------------------------------------------------


def _fma(a, b, c):
    """fp32 fma to within a double rounding (the product is exact in fp64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _emulate_k6(x, w, b, eps, plan):
    """K6's arithmetic as `row_quant.cu` orders it, in fp32: each thread's
    sum over its vectors in order, the xor butterfly over the row's lanes,
    the mean by IEEE division, the deviations' squares by FMA, the variance
    likewise, rstd, (d * rstd) * w + b rounded step by step, the amax, the
    IEEE scale and the IEEE quotient rounded half to even."""
    rows, c = x.shape
    f32 = np.float32
    lanes = [[f + j for f in plan.columns(t) for j in range(plan.vec_elems)]
             for t in range(plan.threads)]

    def reduce(parts):
        """The butterfly within each warp's lanes of the row, then the warp
        partials added in warp order."""
        for off in (16, 8, 4, 2, 1):
            if off < plan.threads:
                parts = parts + parts[:, np.arange(plan.threads) ^ off]
        total = parts[:, 0]
        for w in range(1, plan.threads // rq.WARP):
            total = total + parts[:, rq.WARP * w]
        return total

    sums = np.zeros((rows, plan.threads), f32)
    for t, cols in enumerate(lanes):
        for col in cols:
            sums[:, t] = sums[:, t] + x[:, col]
    mean = (reduce(sums) / f32(c)).astype(f32)
    d = (x - mean[:, None]).astype(f32)
    sq = np.zeros((rows, plan.threads), f32)
    for t, cols in enumerate(lanes):
        for col in cols:
            sq[:, t] = _fma(d[:, col], d[:, col], sq[:, t])
    var = (reduce(sq) / f32(c)).astype(f32)
    rstd = (f32(1) / np.sqrt(var + f32(eps))).astype(f32)
    y = ((d * rstd[:, None]).astype(f32) * w).astype(f32) + b
    s = np.maximum((np.abs(y).max(axis=1) / f32(127)).astype(f32), f32(1e-8))
    q = np.clip(np.rint((y / s[:, None]).astype(f32)), -127, 127).astype(np.int8)
    return torch.from_numpy(q), torch.from_numpy(s[:, None])


@pytest.mark.parametrize("c,threads", [(320, 8), (320, 16), (320, 32), (640, 16), (640, 32),
                                       (1280, 32), (768, 32), (1280, 64)])
def test_k6_order_of_work_matches_the_plain_version(c, threads):
    """The kernel's order of work (per-thread sums, butterflies within the
    row's lanes, IEEE divisions, the affine unfused) against the plain
    version, with `_assert_codes`' bound, at every row width and thread
    count `quant_tune` sweeps."""
    rng = np.random.default_rng(c + threads)
    x = (rng.normal(size=(512, c)) * 1.5 + 0.3).astype(np.float32)
    x = torch.from_numpy(x).bfloat16().float().numpy()  # bf16 inputs
    w = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    b = (0.1 * rng.normal(size=c)).astype(np.float32)
    plan = rq.row_plan(512, c, torch.bfloat16, threads=threads)
    got = _emulate_k6(x, w, b, 1e-5, plan)
    ref = rowquant(_layer_norm_f32(*map(torch.from_numpy, (x, w, b)), 1e-5))
    _assert_codes(got, (ref[0].numpy(), ref[1].numpy()))


# ---- the plain versions against the JAX package ---------------------------


@pytest.mark.parametrize("c,eps", [(320, 1e-5), (640, 1e-5), (1280, 1e-5), (768, 1e-6)])
def test_ln_quant_plain_matches_jax_at_the_model_widths(c, eps):
    """Plain K6 at the SD1.5 widths and the ViT-B's against the JAX
    function's CPU path on the same numpy inputs."""
    rng = np.random.default_rng(c)
    x = (rng.normal(size=(2, 37, c)) * 2 + 0.5).astype(np.float32)
    s, b = (1 + 0.1 * rng.normal(size=c)).astype(np.float32), (0.1 * rng.normal(size=c)).astype(
        np.float32)
    got = fused_layer_norm_quant(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b),
                                 eps)
    assert got[0].shape == x.shape and got[1].shape == (2, 37, 1)
    _assert_codes(got, jln.fused_layer_norm_quant(jnp.asarray(x), jnp.asarray(s),
                                                  jnp.asarray(b), eps))


@pytest.mark.parametrize("part", ["image", "context"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quant_rows_plain_matches_jax_on_the_mmdit_slices(part, dtype, monkeypatch):
    """Plain K11 on the MMDiT's slices of one packed attention output
    against the JAX function's CPU path and its Pallas kernel in interpret
    mode, on the same values."""
    rng = np.random.default_rng(3)
    n_h, n_c, c = 77, 40, 192
    attn = _attn(rng, 2, n_h, n_c, c, dtype)
    x = attn[:, :n_h] if part == "image" else attn[:, n_h:]
    got = fused_quant_rows(x)
    assert got[0].shape == x.shape and got[1].shape == x.shape[:-1] + (1,)
    jx = jnp.asarray(x.float().numpy())
    if dtype == torch.bfloat16:
        jx = jx.astype(jnp.bfloat16)
    _assert_codes(got, jfa.fused_quant_rows(jx))
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)
    _assert_codes(got, jfa.fused_quant_rows(jx))
