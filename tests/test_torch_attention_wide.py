"""PyTorch port, K2 at the VAE's D = 512 on Hopper's warpgroups
(`ops/csrc/attention_sm90_wide.cuh`) on the CPU: the route and the plan
(`wide_plan`: warpgroups, rows, key tile, stages, column blocks, shared
memory, registers, the grid), the TMA tensor maps at D = 512, the refusals
before any build, and a torch emulation of the kernel's order of work (32-key tiles, the logits
summed from two half-depth partials, P rounded to bf16 against the running
maximum, O rescaled where a row maximum of a warp's 16 rows moved, one
division at the end) held against the JAX package's `flash_attention` (the
Pallas kernel in interpret mode). The kernel itself runs only on the card
(`chip_smoke.py`, `tools/attn_tune.py --part wide`)."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prompt_diffusion_tpu.ops import flash_attention as jflash
from prompt_diffusion_tpu_torch.ops import _build
from prompt_diffusion_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

LOG2E = 1.4426950408889634
D = 512


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _as(x, dtype):
    return torch.from_numpy(np.array(x)).to(dtype)


# ---- the route and the plan ------------------------------------------------


@pytest.mark.parametrize("mode,d,route", [
    ("online", 512, "wide_sm90"),
    # other head dims above 128 and a chosen tile (the parent's) stay on
    # flash_attention.cu's wide kernel
    ("online", 160, "wide"), ("online", 256, "wide"), ("tiled", 512, "wide"),
])
def test_wide_route(mode, d, route):
    assert fa.attention_route(mode, d, torch.bfloat16) == route


def test_wide_plan():
    """One producer and two consumer warpgroups over 64 query rows, each
    consumer 256 of O's columns and half of Q.K^T's depth; 32-key tiles in
    two stages; rows of eight 128-byte column blocks; shared memory within
    the H100's 227 KB and registers within its 65,536 a SM."""
    plan = fa.wide_plan(D)
    assert (plan.d, plan.consumers, plan.rows) == (D, 2, 64)
    assert (plan.block_k, plan.stages, plan.threads) == (32, 2, 384)
    assert (plan.column_blocks, plan.consumer_cols) == (8, 256)
    # Q 64 KB, two stages of 32-key K and V (64 KB a stage), two buffers of
    # both consumers' fp32 partial logits (8 KB each), the alignment slack
    assert plan.smem == 65536 + 2 * 65536 + 4 * 8192 + 1024 == 230400
    assert plan.smem <= fa.SMEM_PER_BLOCK == 232448
    # the producer's 40 and the consumers' 232 registers a thread
    assert plan.registers == 128 * (40 + 2 * 232) == 64512 <= fa.REGISTERS_PER_SM
    # O of a consumer: 64 x 256 fp32 over 128 threads, within its registers
    assert plan.rows * plan.consumer_cols // 128 == 128 < plan.regs[1]


@pytest.mark.parametrize("b,n,h,grid", [
    (4, 4096, 1, (64, 4)),     # SD1.5 512² at the paths' batch 4
    (1, 16384, 1, (256, 1)),   # SD3 1024²
    (1, 1100, 1, (18, 1)),     # ragged: 18 blocks for 1100 rows
    (2, 77, 2, (2, 4)), (3, 33, 1, (1, 3)), (1, 64, 1, (1, 1)), (1, 65, 3, (2, 3)),
])
def test_wide_grid(b, n, h, grid):
    """The grid is the query blocks, one row of it per (batch, head); only
    the last block holds rows past N."""
    plan = fa.wide_plan(D)
    gx, gy = plan.grid(b, h, n)
    assert (gx, gy) == grid
    assert (gx - 1) * plan.rows < n <= gx * plan.rows


@pytest.mark.parametrize("d", [256, 160, 128, 64, 1024, 0])
def test_wide_plan_refuses(d):
    with pytest.raises(ValueError):
        fa.wide_plan(d)


def _views(b, n, layout):
    """(B, N, 1, 512) bf16 q, k, v as the VAE passes them (tokens of its
    1x1 convolutions), or as column slices of one packed projection."""
    if layout == "slices":
        return tuple(t.unflatten(-1, (1, D)) for t in
                     torch.zeros(b, n, 3 * D, dtype=torch.bfloat16).chunk(3, dim=-1))
    return tuple(torch.zeros(b, n, 1, D, dtype=torch.bfloat16) for _ in range(3))


@pytest.mark.parametrize("b,n,layout", [(4, 4096, "tokens"), (1, 16384, "tokens"),
                                        (1, 1100, "tokens"), (2, 77, "slices")])
def test_wide_tensor_maps_legal(b, n, layout):
    """Every map at D = 512: 4-D over (D, N, H, B), strides multiples of 16
    bytes, a box of one 128-byte swizzle span (64 bf16) by the CTA's 64 rows
    (Q) or the 32-key tile (K, V); eight boxes cover a row."""
    plan = fa.wide_plan(D)
    maps = fa.wide_tensor_maps(plan, *_views(b, n, layout))
    assert [m[0] for m in maps] == ["q", "k", "v"]
    for name, es, dims, strides, box in maps:
        assert es == 2 and dims == (D, n, 1, b)
        assert all(st > 0 and st % 16 == 0 for st in strides)
        assert box == (64, plan.rows if name == "q" else plan.block_k, 1, 1)
        assert plan.column_blocks * box[0] == D


def _no_build(monkeypatch):
    def built():
        raise AssertionError("the extension was built")

    monkeypatch.setattr(_build, "cuda_ext", built)


def test_wide_launch_takes_the_plan(monkeypatch):
    """K2's launch at D = 512, the head dim `wide_plan` takes, goes to the
    wide sm90 kernel; D = 160 to the parent in flash_attention.cu."""
    _no_build(monkeypatch)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    calls = []

    def fake(q, k, v, scale):
        calls.append((tuple(q.shape), scale))
        return torch.zeros(q.shape, dtype=torch.bfloat16)

    monkeypatch.setattr(fa, "_wide_launch", fake)
    q = torch.zeros(2, 96, 1, D, dtype=torch.bfloat16)
    assert fa._launch(q, q, q, D ** -0.5).shape == q.shape
    assert calls == [((2, 96, 1, D), D ** -0.5)]
    x = torch.zeros(1, 64, 1, 160, dtype=torch.bfloat16)
    with pytest.raises(AssertionError, match="extension was built"):
        fa._launch(x, x, x, 160 ** -0.5)
    assert len(calls) == 1


def _refused(case):
    bf16 = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)
    x = bf16(2, 64, 1, D)
    return {
        "fp32": (x.float(), x.float(), x.float(), 0.05),
        "k batch broadcast (stride 0)": (x, bf16(1, 64, 1, D).expand(2, 64, 1, D), x, 0.05),
        "v row stride not a multiple of 8": (x, x, bf16(2, 64, 1, D + 4)[..., :D], 0.05),
        "q base not 16-byte aligned": (
            torch.zeros(2 * 64 * D + 1, dtype=torch.bfloat16)[1:].view(2, 64, 1, D), x, x, 0.05),
        "non-positive scale": (x, x, x, 0.0),
        "keys disagree": (x, bf16(2, 32, 1, D), x, 0.05),
    }[case]


@pytest.mark.parametrize("case", ["fp32", "k batch broadcast (stride 0)",
                                  "v row stride not a multiple of 8", "q base not 16-byte aligned",
                                  "non-positive scale", "keys disagree"])
def test_wide_refuses_before_build(case, monkeypatch):
    """What the wide kernel or its tensor maps refuse raises ValueError in
    the wrapper before the extension is built: no fallback."""
    _no_build(monkeypatch)
    monkeypatch.setattr(fa, "_wide_launch", lambda *a: pytest.fail("launched"))
    q, k, v, scale = _refused(case)
    with pytest.raises(ValueError):
        fa._launch(q, k, v, scale)


# ---- the order of work -------------------------------------------------------


def _emulate_wide(q, k, v, scale, *, block_k=fa.WIDE_BLOCK_K, splits=fa.WIDE_CONSUMERS,
                  warp_rows=16):
    """The wide kernel's order of work on (B, N, H, D) tensors holding the
    inputs' values, in fp32: per key tile the partial logits of each
    consumer's share of the depth (fp32 products), summed in consumer
    order; only the tile's real keys (the kernel's -inf tail); the running
    row maximum in log2 units over the unscaled logits times c = scale *
    log2(e); p = 2^(s * c - m) with one rounding of s * c - m (FFMA); the
    sum over the fp32 p; p rounded to bf16 when `v` is bf16; O *= corr where
    a row maximum of the warp's `warp_rows` rows moved, then O += p.V in
    fp32 (each consumer's columns alike); O / l once, in v's dtype."""
    b, nq, h, d = q.shape
    nk = k.shape[1]
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))  # (B, H, N, D)
    part = d // splits
    c = np.float32(scale) * np.float32(LOG2E)
    m = torch.full((b, h, nq, 1), -np.inf)
    l = torch.zeros(b, h, nq, 1)
    o = torch.zeros(b, h, nq, d)
    pad = -nq % warp_rows
    for j0 in range(0, nk, block_k):
        kt, vt = kf[:, :, j0:j0 + block_k], vf[:, :, j0:j0 + block_k]
        s = qf[..., :part] @ kt[..., :part].transpose(-1, -2)
        for i in range(1, splits):
            s = s + qf[..., i * part:(i + 1) * part] @ kt[..., i * part:(i + 1) * part].transpose(
                -1, -2)
        mx = torch.maximum(m, s.amax(dim=-1, keepdim=True) * c)
        corr = torch.exp2(m - mx)
        m = mx
        p = torch.exp2((s.double() * float(c) - m.double()).float())
        l = l * corr + p.sum(dim=-1, keepdim=True)
        moved = torch.nn.functional.pad(corr != 1, (0, 0, 0, pad))
        moved = moved.view(b, h, -1, warp_rows).any(dim=-1).repeat_interleave(warp_rows, dim=2)
        o = torch.where(moved[:, :, :nq, None], o * corr, o)
        o = o + p.to(v.dtype).float() @ vt
    return (o / l).to(v.dtype).permute(0, 2, 1, 3)


def _bf16_values(*xs):
    return [np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)) for x in xs]


# bf16 against the JAX kernel (P rounded against the row's final maximum)
# differs by one bf16 step of each P (2^-8 relative between the two
# roundings) and one of each output: 2^-8 (max|V| + max|O|), and fp32's
# order of sums below that
def _bf16_bound(v, ref):
    return 2.0 ** -8 * (np.abs(v).max() + np.abs(ref).max())


WIDE = [  # (B, Nq, Nk, H): one short ragged tile; batch 2 over five tiles; more keys than queries
    (1, 77, 77, 1), (2, 130, 130, 1), (1, 200, 300, 1),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,nq,nk,h", WIDE)
def test_wide_emulation_matches_jax(b, nq, nk, h, dtype):
    """The order of work against `flash_attention` (the online TPU kernel
    in interpret mode) at D = 512: fp32 within 1e-5 (the two half-depth
    partials and fp32's own order of sums are all that differ), bf16 within
    one bf16 step of P and of the output."""
    rng = np.random.default_rng(nq + nk)
    q, k, v = _normal(rng, (b, nq, h, D)), _normal(rng, (b, nk, h, D)), _normal(rng, (b, nk, h, D))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    if dtype == "bfloat16":
        q, k, v = _bf16_values(q, k, v)
    ref = np.asarray(jflash.flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)))
                     .astype(jnp.float32))
    got = _emulate_wide(_as(q, tdt), _as(k, tdt), _as(v, tdt), D ** -0.5)
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= (1e-5 if dtype == "float32" else _bf16_bound(v, ref))


def test_wide_emulation_rescale_rule_is_exact():
    """O is rescaled only where a row maximum of the warp's 16 rows moved,
    which is exact: elsewhere corr is 2^0 = 1."""
    rng = np.random.default_rng(5)
    q, k, v = (_as(_normal(rng, (1, 48, 1, D)), torch.bfloat16) for _ in range(3))
    k[:, 40:] = 0  # the last tiles' maxima below the first's for some rows
    got = _emulate_wide(q, k, v, D ** -0.5)
    always = _emulate_wide(q, k, v, D ** -0.5, warp_rows=1)
    assert torch.equal(got, always)


def test_wide_wrapper_on_the_cpu_matches_jax():
    """On CPU tensors the wrapper takes the plain version: at the VAE's D =
    512 it matches `flash_attention` of the JAX package within 1e-5."""
    rng = np.random.default_rng(11)
    q, k, v = (_normal(rng, (1, 70, 1, D)) for _ in range(3))
    ref = np.asarray(jflash.flash_attention(*(jnp.asarray(x) for x in (q, k, v))))
    got = fa.flash_attention(*(_as(x, torch.float32) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
