"""PyTorch port, the attention lab kernels: the plain version of every lab
mode against the JAX labs' own kernel bodies (`tools/attn_variants.py`,
`attn_lab2.py`, `attn_lab3.py`, `attn_int8_lab.py`) run through a local
`pl.pallas_call` in interpret mode, the tile set, and the dispatch of CPU
tensors. The labs live in `tools/`, which is no package, so they are loaded
by file path. Inputs come from numpy seeds; fp32 V within 1e-5, bf16 within
2e-2 (one bf16 step of the output and of P)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from prompt_diffusion_tpu_torch.ops.flash_attention import (
    LAB_TILES,
    SM90_LAB_TILES,
    attention_no_softmax,
    flash_attention_packed_int8,
    flash_attention_packed_int8_rowk,
    flash_attention_tiled,
    flash_attention_two_pass,
)
from tests.torch_port_util import jax_lab, jax_lab_bhnd

torch.set_num_threads(2)

DTYPES = [(np.float32, 1e-5), ("bfloat16", 2e-2)]

variants, lab2, lab3, int8_lab = (jax_lab(n) for n in ("attn_variants", "attn_lab2", "attn_lab3",
                                                       "attn_int8_lab"))


def _dtypes(dtype):
    return ((jnp.float32, torch.float32) if dtype == np.float32
            else (jnp.bfloat16, torch.bfloat16))


def _qkv(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=shape) * scale).astype(np.float32) for _ in range(3)]


def _close(got, ref, atol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=atol)


def _packed_call(kernel, qkv, block_q, **kw):
    """A packed (B, N, H*D) lab kernel, as `make_fullk_packed` and
    `attn_lab2.make_packed` build it."""
    b, n, hd = qkv[0].shape
    kv = pl.BlockSpec((1, n, hd), lambda i, qb: (i, 0, 0))
    return pl.pallas_call(
        functools.partial(kernel, **kw),
        out_shape=jax.ShapeDtypeStruct((b, n, hd), qkv[0].dtype),
        grid=(b, n // block_q),
        in_specs=[pl.BlockSpec((1, block_q, hd), lambda i, qb: (i, qb, 0)), kv, kv],
        out_specs=pl.BlockSpec((1, block_q, hd), lambda i, qb: (i, qb, 0)),
        interpret=True,
    )(*qkv)


def _bnhd(a, tdt):
    """numpy (B, H, N, D) -> a torch (B, N, H, D) view, as the lab reads it."""
    return torch.from_numpy(a).to(tdt).transpose(1, 2)


# ---- tools/attn_variants.py ------------------------------------------------


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("block_q,block_k", [(32, 32), (64, 16)])
def test_online_plain_matches_lab(block_q, block_k, dtype, atol):
    """`flash_attention_tiled` against `_online_kernel` (do_softmax=True)
    at two block sizes."""
    jdt, tdt = _dtypes(dtype)
    qkv = _qkv(block_q + block_k, (2, 2, 128, 40))
    scale = 40 ** -0.5
    ref = jax_lab_bhnd(variants._online_kernel, [jnp.asarray(a, jdt) for a in qkv], block_q,
                     scale=scale, block_k=block_k)
    got = flash_attention_tiled(*(_bnhd(a, tdt) for a in qkv), scale)
    assert got.dtype == tdt and got.shape == (2, 128, 2, 40)
    _close(got.transpose(1, 2), ref, atol)


@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_no_softmax_plain_matches_lab(dtype, atol):
    """`attention_no_softmax` against `_online_kernel` with do_softmax=False:
    O = sum_j (s_ij * scale cast to V's dtype) V_j. V is scaled by 1/8 so
    that the 64-key sums stay near 1."""
    jdt, tdt = _dtypes(dtype)
    q, k, v = _qkv(5, (1, 2, 64, 40))
    v = v / 8
    scale = 40 ** -0.5
    ref = jax_lab_bhnd(variants._online_kernel, [jnp.asarray(a, jdt) for a in (q, k, v)], 32,
                     scale=scale, block_k=32, do_softmax=False)
    got = attention_no_softmax(*(_bnhd(a, tdt) for a in (q, k, v)), scale)
    assert got.dtype == tdt
    _close(got.transpose(1, 2), ref, atol)


@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_two_pass_plain_matches_fullk_bhnd(dtype, atol):
    """`flash_attention_two_pass` against `_fullk_kernel` (the whole logits
    row, one softmax) over (B, H, N, D)."""
    jdt, tdt = _dtypes(dtype)
    qkv = _qkv(6, (2, 2, 96, 40))
    scale = 40 ** -0.5
    ref = jax_lab_bhnd(variants._fullk_kernel, [jnp.asarray(a, jdt) for a in qkv], 32, scale=scale)
    got = flash_attention_two_pass(*(_bnhd(a, tdt) for a in qkv), scale)
    _close(got.transpose(1, 2), ref, atol)


@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_two_pass_plain_matches_fullk_packed(dtype, atol):
    """The two-pass mode on (B, N, H, D) views of packed tensors against
    `_fullk_packed_kernel` (heads as column slices)."""
    jdt, tdt = _dtypes(dtype)
    qkv = _qkv(7, (2, 64, 3 * 40))
    scale = 40 ** -0.5
    ref = _packed_call(variants._fullk_packed_kernel, [jnp.asarray(a, jdt) for a in qkv], 32,
                       scale=scale, num_heads=3)
    heads = lambda a: torch.from_numpy(a).to(tdt).view(2, 64, 3, 40)
    got = flash_attention_two_pass(*(heads(a) for a in qkv), scale)
    _close(got.reshape(2, 64, 120), ref, atol)


# ---- tools/attn_lab2.py ----------------------------------------------------


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("prescaled", [False, True])
def test_two_pass_plain_matches_lab2_fullk_packed(prescaled, dtype, atol):
    """Lab 2's A (scale in the kernel) and B (q pre-scaled in the working
    dtype outside, the kernel at scale 1)."""
    jdt, tdt = _dtypes(dtype)
    q, k, v = _qkv(8, (2, 64, 2 * 40))
    scale = 40 ** -0.5
    jq = jnp.asarray(q, jdt)
    if prescaled:
        jq = jq * jnp.asarray(scale, jdt)
    ref = _packed_call(lab2._fullk_packed, [jq, jnp.asarray(k, jdt), jnp.asarray(v, jdt)], 32,
                       scale=scale, num_heads=2, prescaled=prescaled)
    heads = lambda t: t.view(2, 64, 2, 40)
    tq = torch.from_numpy(q).to(tdt)
    if prescaled:
        tq = tq * torch.tensor(scale, dtype=tdt)
    got = flash_attention_two_pass(heads(tq), *(heads(torch.from_numpy(a).to(tdt))
                                                for a in (k, v)), 1.0 if prescaled else scale)
    _close(got.reshape(2, 64, 80), ref, atol)


@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_two_pass_plain_matches_lab2_batched_heads(dtype, atol):
    """Lab 2's D, the heads as a batch dimension of one dot, on pre-scaled
    q: on the card the kernel's (batch, head) grid."""
    jdt, tdt = _dtypes(dtype)
    qkv = _qkv(9, (1, 64, 4 * 40), scale=1.0)
    qkv[0] = qkv[0] * 40 ** -0.5
    ref = _packed_call(lab2._fullk_batched_heads, [jnp.asarray(a, jdt) for a in qkv], 32,
                       num_heads=4)
    got = flash_attention_two_pass(*(torch.from_numpy(a).to(tdt).view(1, 64, 4, 40)
                                     for a in qkv), 1.0)
    _close(got.reshape(1, 64, 160), ref, atol)


# ---- tools/attn_lab3.py ----------------------------------------------------


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("d_pad", [64, 128])
def test_two_pass_plain_matches_lab3_head_padding(d_pad, dtype, atol):
    """Lab 3's heads zero-padded from 40 to D' on pre-scaled q: the port's
    two-pass mode on the padded heads against the lab's kernel on them, and
    its first 40 columns against the unpadded problem (the zero columns add
    nothing to the logits and give zero outputs)."""
    jdt, tdt = _dtypes(dtype)
    q, k, v = _qkv(10 + d_pad, (1, 64, 2, 40))
    q = q * 40 ** -0.5
    pad = lambda a: np.pad(a, ((0, 0), (0, 0), (0, 0), (0, d_pad - 40)))
    padded = [pad(a) for a in (q, k, v)]
    ref = _packed_call(lab3._fullk_packed, [jnp.asarray(a.reshape(1, 64, -1), jdt)
                                           for a in padded], 32, num_heads=2)
    got = flash_attention_two_pass(*(torch.from_numpy(a).to(tdt) for a in padded), 1.0)
    _close(got.reshape(1, 64, -1), ref, atol)
    assert not got[..., 40:].any()
    unpadded = flash_attention_two_pass(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), 1.0)
    assert torch.equal(got[..., :40], unpadded)


# ---- tools/attn_int8_lab.py ------------------------------------------------


@pytest.mark.parametrize("version,dtype,atol", [
    # the lab's kernels cast P to bf16 whatever V's dtype (attn_int8_lab.py:
    # 62, 122). v2's plain version does too, and with fp32 V an fp32 ulp of
    # exp between the frameworks now and then moves one P across a bf16
    # rounding step (26 of 51,200 outputs here, by up to 2.3e-5; on some
    # runs past 1e-4), so v2 in fp32 is held to one bf16 rounding of P, as
    # v3 is.
    # K9 and its TPU kernel cast P to V's dtype, so v3 differs from it in
    # fp32 by one bf16 rounding of P (3.1e-4 here, on outputs of ~0.05)
    ("v2", np.float32, 5e-4), ("v2", "bfloat16", 2e-2), ("v3", np.float32, 5e-4),
    ("v3", "bfloat16", 2e-2)])
def test_int8_lab_plain_matches_lab(version, dtype, atol):
    """v2 (per-row K scales, bf16 P.V, `_kernel_v2`) against
    `flash_attention_packed_int8_rowk`, v3 (per-head, `_kernel_v3`) against
    K9, each through the lab's own wrapper in interpret mode."""
    jdt, tdt = _dtypes(dtype)
    qkv = _qkv(11, (2, 200, 2 * 64), scale=0.5)
    scale = 64 ** -0.5
    jfn = int8_lab.attn_int8_v2 if version == "v2" else int8_lab.attn_int8_v3
    ref = jfn(*(jnp.asarray(a, jdt) for a in qkv), 2, scale, interpret=True)
    port = flash_attention_packed_int8_rowk if version == "v2" else flash_attention_packed_int8
    got = port(*(torch.from_numpy(a).to(tdt) for a in qkv), 2, scale)
    assert got.dtype == tdt and got.shape == (2, 200, 128)
    _close(got, ref, atol)


def test_int8_row_scales_change_the_result():
    """Per-row K scales are another quantization than per-head ones: with a
    K outlier row the two differ, and per-row sits closer to exact."""
    from prompt_diffusion_tpu_torch.ops.flash_attention import _packed_ref

    q, k, v = (torch.from_numpy(a) for a in _qkv(12, (1, 96, 64), scale=0.5))
    k[0, 7] *= 8.0
    exact = _packed_ref(q, k, v, 2, 32 ** -0.5)
    rel = lambda a: ((a - exact).norm() / exact.norm()).item()
    rowk = flash_attention_packed_int8_rowk(q, k, v, 2)
    per_head = flash_attention_packed_int8(q, k, v, 2)
    assert not torch.equal(rowk, per_head)
    assert rel(rowk) < rel(per_head) < 2e-2


# ---- tiles and dispatch ----------------------------------------------------


def test_lab_tiles_outside_the_instantiated_set_raise():
    """Each wrapper against its own tile set, on the CPU as on the card: L1,
    L2 and L3 take SM90_LAB_TILES (the sm90 kernel's); a tile of the
    parent's narrow kernel (LAB_TILES) is refused."""
    q = torch.zeros(1, 64, 1, 40)
    for fn, tiles in ((flash_attention_tiled, SM90_LAB_TILES),
                      (attention_no_softmax, SM90_LAB_TILES),
                      (flash_attention_two_pass, SM90_LAB_TILES)):
        for block_q, block_k in tiles:
            assert fn(q, q, q, 1.0, block_q, block_k).shape == q.shape
        for other in sorted(set(LAB_TILES + SM90_LAB_TILES) - set(tiles)) + [(256, 64), (64, 16)]:
            with pytest.raises(ValueError, match="not instantiated"):
                fn(q, q, q, 1.0, *other)


def test_cpu_tensors_take_the_plain_lab_versions():
    """On the CPU the four lab wrappers run their plain versions and count
    no launch."""
    counted = (flash_attention_tiled, attention_no_softmax, flash_attention_two_pass,
               flash_attention_packed_int8_rowk)
    before = [f.launches for f in counted]
    x = torch.randn(2, 20, 2, 32)
    for fn in counted[:3]:
        fn(x, x, x, 0.2)
    flash_attention_packed_int8_rowk(x.flatten(2), x.flatten(2), x.flatten(2), 2)
    assert [f.launches for f in counted] == before


def test_lab_entry_runs_every_tile_beside_its_parent(monkeypatch):
    """The lab entry's bf16 labs (`tools/attn_lab.py`) at a tiny size on
    the CPU, the timer and the parent's launch replaced by stand-ins: L1,
    L2 and L3 run every tile the sm90 kernel instantiates at their D
    (`sm90_lab_tiles`), each row beside the parent in its mode at
    `lab_parent_tile`, and every row, the parent's too, lies within 2e-2
    of its largest plain output (bf16 against fp32)."""
    from prompt_diffusion_tpu_torch.ops import flash_attention as fa
    from prompt_diffusion_tpu_torch.tools import attn_lab

    parents = []

    def parent(q, k, v, scale, mode, tile):
        assert tile in LAB_TILES and mode in ("online", "no_softmax", "two_pass")
        parents.append((mode, tile, q.shape[-1]))
        plain = fa._torch_attention_no_softmax if mode == "no_softmax" else fa._torch_attention
        return plain(q, k, v, scale)

    monkeypatch.setattr(attn_lab, "_parent_launch", parent)
    monkeypatch.setattr(attn_lab, "time_ms", lambda fn, iters=10: (fn(), 1.0)[1])
    monkeypatch.setattr(attn_lab, "B", 1)
    monkeypatch.setattr(attn_lab, "N", 96)
    monkeypatch.setattr(attn_lab, "H", 2)
    rows = attn_lab.run(labs=("variants", "lab2", "lab3"), iters=1, device="cpu")
    tiles = lambda d: [fa.lab_parent_tile(t) for t in fa.sm90_lab_tiles(d, "two_pass")]
    online = [fa.lab_parent_tile(t) for t in fa.sm90_lab_tiles(40, "tiled")]
    no_softmax = [fa.lab_parent_tile(t) for t in fa.sm90_lab_tiles(40, "no_softmax")]
    assert [r.get("parent_tile") for r in rows["variants"]] == (
        online + no_softmax + tiles(40) + [(64, 64), (128, 64)] + [None])
    assert [r["parent_tile"] for r in rows["lab2"]] == [(64, 64), (64, 64), (128, 64), (64, 64),
                                                        (128, 64)]
    assert [r["parent_tile"] for r in rows["lab3"]] == tiles(64) + tiles(128)
    assert parents[::2] == parents[1::2]  # the error's call, then the timed one
    assert [(m, d) for m, _, d in parents[::2]] == (
        [("online", 40)] * 4 + [("no_softmax", 40)] * 4 + [("two_pass", 40)] * 11
        + [("two_pass", 64)] * 4 + [("two_pass", 128)] * 2)
    for row in (r for lab in rows.values() for r in lab):
        assert row["err_over_max"] <= 2e-2 and row.get("parent_err_over_max", 0.0) <= 2e-2


def test_lab_entry_runs_l4_beside_its_parent(monkeypatch):
    """The lab entry's int8 lab at a tiny size on the CPU, the timer and
    the int8 parent's launch replaced by stand-ins: v2 (L4) runs beside
    its parent `int8_attn_kernel` with per-row K at `int8_block_q` rows
    and its 64-key tiles, K9's v1 and v3 and K1 beside none; every row
    within 2e-2 of its largest plain output."""
    from prompt_diffusion_tpu_torch.ops import flash_attention as fa
    from prompt_diffusion_tpu_torch.tools import attn_lab

    parents = []

    def parent(q, k, v, heads, scale, row_k):
        parents.append((tuple(q.shape), heads, row_k))
        return fa._torch_int8_attention(q, k, v, heads, scale, row_k)

    monkeypatch.setattr(attn_lab, "_int8_parent_launch", parent)
    monkeypatch.setattr(attn_lab, "time_ms", lambda fn, iters=10: (fn(), 1.0)[1])
    for name, value in (("INT8_B", 1), ("INT8_N", 96), ("INT8_H", 2), ("INT8_CHECK_N", 40)):
        monkeypatch.setattr(attn_lab, name, value)
    rows = attn_lab.run(labs=("int8",), iters=1, device="cpu")["int8"]
    assert [r.get("parent_tile") for r in rows] == [None, (fa.int8_block_q(96), 64), None, None]
    assert parents == [((1, 96, 128), 2, True)] * 2  # the error's call, then the timed one
    for row in rows:
        assert row["err_over_max"] <= 2e-2 and row.get("parent_err_over_max", 0.0) <= 2e-2
