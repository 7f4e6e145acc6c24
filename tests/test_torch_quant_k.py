"""PyTorch port, K9p (K9's per-head K quantization, `quant_k_int8`) on the
card: its plan (`ops/flash_attention.py::quant_k_plan`) at the SD3 joint
shape and on the DPT-Hybrid ViT-B's K column slice, the workspace, an
emulation of `csrc/int8_attention.cu`'s order of work against the plain
version bit for bit, the refusals before any build, and the CPU routing.
The kernel itself runs only on the card (`chip_smoke.py`,
`tools/quant_tune.py --kernels K9p`)."""

import numpy as np
import pytest
import torch

from prompt_diffusion_tpu_torch.ops import _build
from prompt_diffusion_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

# (B, N, H * D, H) of the SD3 joint attention (CFG batch 2, 4096 + 333
# tokens), of the DPT-Hybrid ViT-B (batch 16, 1025 tokens) and of the SD1.5
# self-attention under `int8_attention` (CFG batch 8 at 64² and 32², D = 40
# and 80), and ragged ones at the other head dimensions
SHAPES = [(2, 4429, 1536, 24), (16, 1025, 768, 12), (3, 77, 256, 2), (2, 100, 512, 16),
          (1, 5, 4096, 32), (8, 4096, 320, 8), (8, 1024, 640, 8), (2, 77, 120, 3)]


def _covers(plan: fa.QuantKPlan, capacity: int):
    """The grid is resident at once; within a sample the blocks' row ranges
    cover every key row once in order, none empty, and a row's threads
    every one of its H*D values."""
    assert plan.grid == plan.batch * plan.bps <= capacity
    assert plan.cv * plan.rows <= plan.threads <= fa.QK_MAX_THREADS and plan.threads % 32 == 0
    assert plan.threads - plan.cv * plan.rows < 32
    ranges = [plan.block_rows(j) for j in range(plan.bps)]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.nk
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    rows = sorted(n for lo, hi in ranges for r in range(plan.rows)
                  for n in range(lo + r, hi, plan.rows))
    assert rows == list(range(plan.nk))
    assert sorted(8 * v + e for v in range(plan.cv) for e in range(8)) == list(
        range(plan.heads * plan.d))


@pytest.mark.parametrize("occ", [1, 2, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_quant_k_plan_covers_every_value_once(shape, occ):
    """At the paths' shapes (and ragged ones): the plan covers each key row
    and value once, its grid is resident at once, and the workspace holds
    an amax per block and head."""
    b, n, hd, h = shape
    plan = fa.quant_k_plan(b, n, h, hd // h, occupancy=lambda t: occ)
    _covers(plan, min(occ, fa.QK_BLOCKS_PER_SM) * fa.SMS)
    assert plan.workspace == plan.grid * h


@pytest.mark.parametrize("shape,rows,threads,bps", [
    ((2, 4429, 1536, 24), 1, 192, 264),   # SD3: 192 vectors a key row, 528 blocks
    ((16, 1025, 768, 12), 2, 192, 33),    # the ViT-B K slice: two rows of 96 vectors
    ((8, 4096, 320, 8), 6, 256, 66),      # SD1.5 64²: six rows of 40 vectors (5 a head)
    ((8, 1024, 640, 8), 3, 256, 66),      # SD1.5 32²: three rows of 80 vectors (10 a head)
])
def test_quant_k_plan_at_the_main_shapes(shape, rows, threads, bps):
    """The plan at the assumed occupancy: QK_BLOCKS_PER_SM blocks an SM
    over the samples, each a contiguous range of key rows."""
    b, n, hd, h = shape
    plan = fa.quant_k_plan(b, n, h, hd // h)
    assert (plan.rows, plan.threads, plan.bps) == (rows, threads, bps)
    assert plan.blocks_per_sm == min(fa.QK_ASSUMED_OCCUPANCY, fa.QK_BLOCKS_PER_SM)


@pytest.mark.parametrize("args,err,match", [
    ((2, 100, 24, 48), ValueError, "head dim"),
    ((2, 100, 64, 128), ValueError, "exceed"),
    ((0, 100, 24, 64), ValueError, "empty"),
    ((600, 100, 24, 64), RuntimeError, r"quant_k_int8 of K \(600, 100, 1536\)"),
])
def test_quant_k_plan_refuses(args, err, match):
    """A shape the kernel does not take raises ValueError; a grid that
    cannot be resident (more samples than the card holds blocks) raises a
    RuntimeError that names the shape."""
    with pytest.raises(err, match=match):
        fa.quant_k_plan(*args, occupancy=lambda t: 1)


def test_quant_k_plan_refuses_when_no_block_fits():
    with pytest.raises(RuntimeError, match=r"\(2, 4429, 1536\) with 24 heads"):
        fa.quant_k_plan(2, 4429, 24, 64, occupancy=lambda t: 0)


def _no_build(monkeypatch):
    def built():
        raise AssertionError("the extension was built")

    monkeypatch.setattr(_build, "cuda_ext", built)


@pytest.mark.parametrize("case", ["fp32", "head dim 48", "rows not dense", "misaligned",
                                  "another shape's plan", "per row at head dim 40",
                                  "head_bytes 44", "head_bytes below D", "head_bytes per row"])
def test_quant_k_int8_refuses_before_build(case, monkeypatch):
    """What K9p refuses raises ValueError in the wrapper (a plan of another
    shape in the launch that takes one), before the extension is built or
    a launch is queued (the CUDA tensor is stood in for by making the
    wrapper take the kernel's route): no fallback."""
    _no_build(monkeypatch)
    monkeypatch.setattr(fa, "use_kernel", lambda t: True)
    k = torch.zeros(2, 64, 1536, dtype=torch.bfloat16)
    heads, plan = 24, None
    if case == "fp32":
        k = k.float()
    elif case == "head dim 48":
        heads = 32
    elif case == "rows not dense":
        k = torch.zeros(2, 64, 3072, dtype=torch.bfloat16)[..., ::2]
    elif case == "misaligned":
        k = torch.zeros(2, 64, 1540, dtype=torch.bfloat16)[..., 4:]
    elif case == "per row at head dim 40":  # the per-row prologue takes D 32, 64, 128
        k = torch.zeros(2, 64, 320, dtype=torch.bfloat16)
        heads = 8
    elif case == "another shape's plan":
        plan = fa.quant_k_plan(2, 65, 24, 64)
    head_bytes = {"head_bytes 44": 44, "head_bytes below D": 56,
                  "head_bytes per row": 64}.get(case)
    with pytest.raises(ValueError):
        if plan is None:
            fa.quant_k_int8(k, heads, case in ("per row at head dim 40", "head_bytes per row"),
                            head_bytes)
        else:  # the launch that takes a given plan (`tools/quant_tune.py`'s sweep)
            fa._quant_k_head(k, plan)


@pytest.mark.parametrize("shape", [(2, 4429, 1536, 24), (16, 1025, 768, 12),
                                   (8, 4096, 320, 8), (8, 1024, 640, 8)],
                         ids=["SD3", "ViT-B", "SD1.5 64²", "SD1.5 32²"])
def test_quant_k_int8_accepts_the_model_inputs(shape, monkeypatch):
    """The paths' K (the ViT-B's as a column slice of its qkv projection)
    passes every check and reaches the build (the refusals above are not
    vacuous)."""
    _no_build(monkeypatch)
    monkeypatch.setattr(fa, "use_kernel", lambda t: True)
    b, n, hd, h = shape
    k = torch.zeros(b, n, 3 * hd, dtype=torch.bfloat16)[..., hd:2 * hd] if hd == 768 else \
        torch.zeros(b, n, hd, dtype=torch.bfloat16)
    with pytest.raises(AssertionError, match="was built"):
        fa.quant_k_int8(k, h)


def _emulate(k, heads, plan):
    """K9p's order of work in float32 numpy: each block's |k| amax per head
    over its rows and its threads' vectors, then per sample the max over
    its blocks' slots, the scale by IEEE division (numpy's float32
    division is), the codes rint(k / s) clipped to +-127."""
    f32 = np.float32
    b_, n_, hd = k.shape
    d = hd // heads
    kf = k.float().numpy()
    ws = np.zeros((plan.grid, heads), f32)
    for blk in range(plan.grid):
        b, j = divmod(blk, plan.bps)
        lo, hi = plan.block_rows(j)
        per_thread = np.zeros((plan.rows, plan.cv), f32)
        for r in range(plan.rows):
            rows = kf[b, lo + r:hi:plan.rows]
            if len(rows):
                per_thread[r] = np.abs(rows).reshape(len(rows), plan.cv, 8).max(axis=(0, 2))
        ws[blk] = per_thread.reshape(plan.rows, heads, d // 8).max(axis=(0, 2))
    amax = ws.reshape(b_, plan.bps, heads).max(axis=1)
    s = np.maximum(amax / f32(127), f32(1e-8)).astype(f32)
    q = np.clip(np.rint(kf.reshape(b_, n_, heads, d) / s[:, None, :, None]), -127, 127)
    return torch.from_numpy(q.astype(np.int8).reshape(b_, n_, hd)), torch.from_numpy(s)


@pytest.mark.parametrize("case", ["SD3-like", "ViT-like slice", "D 128 ragged", "D 32", "D 40",
                                  "D 80 slice"])
def test_quant_k_emulation_matches_the_plain_version(case):
    """K9p's order of work, emulated at a plan of many blocks per sample
    (sms=3) against `_quant_k_per_head`: codes and scales bit-equal (a max
    is exact in any order, and both divide in IEEE fp32)."""
    rng = np.random.default_rng(12)
    b, n, hd, h, row = {"SD3-like": (2, 300, 384, 6, 384), "ViT-like slice": (3, 65, 192, 3, 576),
                        "D 128 ragged": (2, 77, 256, 2, 256), "D 32": (2, 200, 128, 4, 128),
                        "D 40": (2, 300, 320, 8, 320), "D 80 slice": (3, 90, 160, 2, 480)}[case]
    full = torch.from_numpy((2 * rng.normal(size=(b, n, row))).astype(np.float32)).bfloat16()
    k = full[..., hd:2 * hd] if row != hd else full
    plan = fa.quant_k_plan(b, n, h, hd // h, occupancy=lambda t: 2, sms=3)
    assert plan.bps > 1 and plan.bps * plan.rows < n
    q, s = _emulate(k, h, plan)
    rq, rs = fa._quant_k_per_head(k, h)
    assert torch.equal(s, rs) and torch.equal(q, rq)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU quant_k_int8 runs its plain versions and counts no
    launch."""
    before = fa.quant_k_int8.launches
    k = torch.randn(2, 33, 128).bfloat16()
    for per_row in (False, True):
        q, s = fa.quant_k_int8(k, 2, per_row)
        plain = (fa._quant_k_per_row if per_row else fa._quant_k_per_head)(k, 2)
        assert torch.equal(q, plain[0]) and torch.equal(s, plain[1])
    assert fa.quant_k_int8.launches == before


@pytest.mark.parametrize("d,head_bytes", [(40, 48), (80, 80), (64, None)])
def test_quant_k_int8_head_bytes_on_the_cpu(d, head_bytes):
    """K9p's per-head codes laid out for the sm90 kernel (heads
    `head_bytes` apart: 48 at D = 40): on the CPU the plain codes as a
    (B, N, H, D) view, the same values; without it dense (B, N, H*D)."""
    k = torch.randn(2, 33, 4 * d).bfloat16()
    codes, scales = fa.quant_k_int8(k, 4, head_bytes=head_bytes)
    plain, plain_scales = fa._quant_k_per_head(k, 4)
    want = plain if head_bytes is None else plain.unflatten(-1, (4, d))
    assert codes.shape == want.shape and torch.equal(codes, want)
    assert torch.equal(scales, plain_scales)
