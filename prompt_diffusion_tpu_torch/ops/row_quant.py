"""The launch plans and launchers of K10 (tanh-GELU -> int8), K13 (AdaLN
-> int8), K7 (GEGLU -> int8), K6 (LayerNorm -> int8), K11 (row -> int8)
and K12 (AdaLN in x's dtype) with K12's backward, the CUDA C++ kernels of
`csrc/row_quant.cu`.

`fused_act.fused_gelu_quant`, `fused_act.fused_geglu_quant`,
`fused_act.fused_quant_rows`, `fused_adaln.fused_adaln_quant`,
`fused_adaln.fused_adaln` (and its backward) and
`fused_layer_norm.fused_layer_norm_quant` send a CUDA tensor here, and
`fused_act.act_amax` and `fused_act.act_codes`, the two passes of K10 and
K11 split over a tensor group (`row_amax`, `codes_from_amax`). Rows
are read in place: a (B, N, C) tensor of K13, K12 or K11 as B samples with its
own sample and row strides (K11's are the MMDiT's slices of one packed
(B, N_h + N_c, C) attention output), any other as x.view(-1, C). `row_plan` cuts a
row of C output values into 16-byte vectors (8 bf16 or 4 fp32) and gives
them to the row's threads, vector t + k * TPR to thread t; a thread holds
that vector of each of the row's `inputs` (K7: h and gate, 2 inputs), and
all of them count against the 8 vectors a thread may hold: one warp per
row while a lane holds at most 8 vectors (C <= 2048 in bf16: the row's
reductions are shuffles, with no barrier), narrowed to 8 or 16 aligned
lanes of a warp where they hold a one-input row with no lane idle and at
most 5 vectors each (K6's C = 320 and 640 in bf16), else the fewest threads (64,
128 or 256) that hold at most 4 vectors each (K10's C = 6144 in bf16: 256
threads of 3 vectors), else 256 threads of up to 8; for K7 at most 3 + 3
(C = 1280, 2560 and 5120: 64, 128 and 256 threads of 3 + 3).
Blocks are 256 threads, so a block holds 256 / TPR rows at a time (a row
group); it walks `groups` row groups of one sample (the K13 modulation is
per sample), loading the next group while it quantizes the current one
when `groups` > 1: 4, or 2, where the grid still keeps MIN_BLOCKS blocks,
else 1. Rows are at most 32 KB (`MAX_ROW_BYTES`): C <= 16384 in bf16, 8192
in fp32 (K7: 2C values, C <= 8192 and 4096).

K12's backward (`adaln_bwd_plan`) is one cooperative launch of a grid
whose blocks are all resident: the same row plan (a row's threads hold
the same columns in every row, so each keeps the column sums of g and
g * xhat of its columns in registers, BWD_VECTORS of each at most where
the row allows it), as many blocks per sample as the card holds at once
over the samples (the occupancy query), each walking `groups` row groups;
then every block merges a slice of its sample's 2C column sums over the
sample's per-block partials, `merge_lanes` lanes a sum.

Every refusal is a `ValueError` raised before the extension is built or a
launch is queued; a CUDA tensor never falls back to the plain version.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import torch

# the H100's SMs, and the blocks per SM a plan assumes where no card answers
# the occupancy query (the launchers read the card's)
from prompt_diffusion_tpu_torch.ops.gn_quant import ASSUMED_OCCUPANCY, SMS

VEC_BYTES = 16  # one load per thread and vector
BLOCK_THREADS = 256
WARP = 32
MAX_VECTORS = 8  # 16-byte vectors a thread holds of one row
WIDE_VECTORS = 4  # per thread, where a row takes more than one warp
# K7 (two inputs), where a row takes more than one warp: the fewest threads
# that hold at most 3 vectors of each input (the sweep of
# `tools/quant_tune.py --part time` on the H100: 64 threads of 3 + 3 beat
# 128 of 2 + 2 by 21% at I = 1280, 128 of 3 + 3 beat 256 by 18% at I = 2560)
TWO_INPUT_VECTORS = 3
# a one-input row narrower than a warp can fill: 8 or 16 aligned lanes of
# one warp, where they hold it with no lane idle and at most NARROW_VECTORS
# vectors each (the sweep of `tools/quant_tune.py --part time` on the H100:
# 8 threads of 5 vectors beat a warp of 2 by 38% at K6's C = 320 in bf16,
# 16 of 5 beat a warp of 3 by 11% at 640; at 768, 16 threads of 6 came
# within 5% of a warp of 3, which stays)
NARROW_THREADS, NARROW_VECTORS = (8, 16), 5
MAX_ROW_BYTES = BLOCK_THREADS * MAX_VECTORS * VEC_BYTES  # 32 KB
DTYPES = (torch.bfloat16, torch.float32)
GELU, ADALN, GEGLU, LN, ROWS, ADALN_F = 0, 1, 2, 3, 4, 5  # the `op` of `csrc/row_quant.cu`
# the split K10 / K11 (`row_split_kernel`): the row amax of GELU(x) or of x,
# then the codes from a given row amax
GELU_AMAX, ROWS_AMAX, GELU_CODES, ROWS_CODES = 6, 7, 8, 9
_AMAX_OPS = (GELU_AMAX, ROWS_AMAX)
ROW_THREADS = (8, 16, 32, 64, 128, 256)  # threads per row the kernel takes
MAX_SAMPLES = 65535  # the grid's y dimension
# row groups a block walks, pipelined, while the grid keeps MIN_BLOCKS blocks
# (~2 per SM of the H100's 132): the best of 1, 2, 4 and 8 groups at each
# SD3 shape, or within 1% of it (`tools/quant_tune.py --part time`)
MAX_GROUPS, MIN_BLOCKS = 4, 256
# K12's backward: threads per row it takes, and the vectors of x and of g a
# thread holds at most where the row allows it (each column also takes two
# fp32 sums in registers). `tools/quant_tune.py` on the H100 at (2, 4096,
# 1536), L2-cold: bf16, 64 threads of 3 vectors (128 registers, 12 bytes
# of spill) 0.0364 ms, 128 of 2 0.0426, a warp of 6 (~1 KB of spill)
# 0.1054; fp32, 128 threads of 3 (127 registers) 0.0599, 64 of 6 (316
# bytes of spill) 0.0840, 256 of 2 0.0739
BWD_THREADS = (32, 64, 128, 256)
BWD_VECTORS = 3


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """How `csrc/row_quant.cu` covers `samples` x `rows` rows of `c` output
    values: `threads` per row, each holding up to `vectors` 16-byte vectors
    of `vec_elems` values of each of the row's `inputs`; a block of BLOCK_THREADS threads holds
    `rows_per_group` rows at once and walks `groups` row groups of one
    sample; `grid` = (blocks per sample, samples)."""

    rows: int  # per sample
    c: int
    vec_elems: int
    threads: int
    vectors: int
    rows_per_group: int
    groups: int
    grid: Tuple[int, int]
    inputs: int = 1

    def columns(self, t: int):
        """First columns of the vectors thread t of a row holds (the
        kernel's `t + k * tpr` map)."""
        nvec = self.c // self.vec_elems
        return [v * self.vec_elems for v in range(t, nvec, self.threads)][:self.vectors]

    def row(self, block: int, group: int, slot: int) -> Optional[int]:
        """The row of its sample that row slot `slot` of block `block`
        holds in group `group`, or None past the sample's rows."""
        r = (block * self.groups + group) * self.rows_per_group + slot
        return r if r < self.rows else None


@functools.lru_cache(maxsize=None)
def row_plan(rows: int, c: int, dtype: torch.dtype, samples: int = 1,
             threads: Optional[int] = None, groups: Optional[int] = None,
             inputs: int = 1) -> RowPlan:
    """The plan for `rows` rows of `c` output values in all, `samples`
    samples of rows // samples each, each value read from `inputs` values
    of the row (1, or 2 for K7's [h | gate]); `threads` (per row) and
    `groups` override the rules above (`tools/quant_tune.py` sweeps
    both)."""
    if dtype not in DTYPES:
        raise ValueError(f"rows of {dtype} are not supported: bf16 or fp32")
    size = dtype.itemsize
    if c <= 0 or c % 8:
        raise ValueError(f"row width {c} must be a positive multiple of 8")
    if inputs not in (1, 2):
        raise ValueError(f"a value is read from 1 or 2 inputs, got {inputs}")
    if inputs * c * size > MAX_ROW_BYTES:
        raise ValueError(f"row width {inputs} x {c} exceeds the plan's "
                         f"{MAX_ROW_BYTES // size} {dtype} values ({MAX_ROW_BYTES} bytes)")
    if rows < 1 or samples < 1 or rows % samples:
        raise ValueError(f"{rows} rows do not split into {samples} samples")
    if samples > MAX_SAMPLES:
        raise ValueError(f"{samples} samples exceed the grid's {MAX_SAMPLES}")
    if groups is not None and groups < 1:
        raise ValueError(f"groups must be >= 1, got {groups}")
    e = VEC_BYTES // size
    nvec = c // e
    if threads is None:
        threads = WARP
        if inputs * -(-nvec // WARP) > MAX_VECTORS:
            wide = WIDE_VECTORS if inputs == 1 else TWO_INPUT_VECTORS
            threads = next((t for t in (64, 128, 256) if -(-nvec // t) <= wide),
                           BLOCK_THREADS)
        elif inputs == 1:
            threads = next((t for t in NARROW_THREADS
                            if nvec % t == 0 and nvec // t <= NARROW_VECTORS), WARP)
    if threads not in ROW_THREADS:
        raise ValueError(f"threads per row must be one of {ROW_THREADS}, got {threads}")
    vectors = -(-nvec // threads)
    if inputs * vectors > MAX_VECTORS:
        raise ValueError(f"{threads} threads cannot hold a row of {c} values")
    per_sample = rows // samples
    rpg = BLOCK_THREADS // threads
    blocks = lambda g: -(-per_sample // (rpg * g)) * samples
    if groups is None:
        groups = next((g for g in (MAX_GROUPS, 2) if blocks(g) >= MIN_BLOCKS), 1)
    return RowPlan(rows=per_sample, c=c, vec_elems=e, threads=threads, vectors=vectors,
                   rows_per_group=rpg, groups=groups,
                   grid=(-(-per_sample // (rpg * groups)), samples), inputs=inputs)


def _check_float(name: str, t: torch.Tensor) -> None:
    if t.dtype not in DTYPES:
        raise ValueError(f"{name} must be bf16 or fp32, got {t.dtype}")


def _rows(x: torch.Tensor, samples: bool = False):
    """(samples, rows per sample, sample stride, row stride) of x's dense,
    16-byte aligned rows, read in place, never a copy: with `samples`, x
    (B, N, C) as B samples of N rows with x's own strides; else x (..., C)
    as one sample, the rows of x.view(-1, C)."""
    _check_float("x", x)
    c = x.shape[-1]
    if c <= 0 or c % 8:
        raise ValueError(f"row width {c} must be a positive multiple of 8")
    if c * x.element_size() > MAX_ROW_BYTES:
        raise ValueError(f"row width {c} exceeds the plan's "
                         f"{MAX_ROW_BYTES // x.element_size()} {x.dtype} values")
    if samples:
        b, n, _ = x.shape
        layout = (b, n, x.stride(0), x.stride(1))
    else:
        try:
            x2 = x.view(-1, c)
        except RuntimeError:
            x2 = None
        layout = None if x2 is None else (1, x2.shape[0], x2.shape[0] * x2.stride(0),
                                          x2.stride(0))
    if layout is None or x.stride(-1) != 1 or (layout[1] > 1 and layout[3] < c):
        raise ValueError(f"rows must be contiguous: shape {tuple(x.shape)}, strides {x.stride()}")
    if x.data_ptr() % VEC_BYTES or any(s * x.element_size() % VEC_BYTES for s in layout[2:]):
        raise ValueError(f"rows must be 16-byte aligned: strides {x.stride()}")
    return layout


def _modulation(name: str, t: torch.Tensor, b: int, c: int, device):
    """A (B, 1, C) or (B, C) scale or shift as (pointer, bf16, sample
    stride, column stride) of its (B, C) view."""
    _check_float(name, t)
    if t.shape not in ((b, 1, c), (b, c)):
        raise ValueError(f"{name} must be ({b}, 1, {c}) or ({b}, {c}) for x's batch {b}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    t = t.reshape(b, c)
    return t.data_ptr(), t.dtype == torch.bfloat16, t.stride(0), t.stride(1)


def _affine(name: str, t: torch.Tensor, c: int, device):
    """K6's (C,) weight or bias as (pointer, bf16, sample stride 0,
    column stride)."""
    _check_float(name, t)
    if t.shape != (c,):
        raise ValueError(f"{name} must be ({c},), got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    return t.data_ptr(), t.dtype == torch.bfloat16, 0, t.stride(0)


def _launch(op, x, layout, plan, sc=None, sh=None, eps=0.0):
    """Codes (rows, plan.c) and scales (rows,) of the rows of x that
    `layout` (`_rows`) describes, each plan.inputs x plan.c wide; sc and sh
    as `_modulation` or `_affine` give them. K12 (ADALN_F): y (rows,
    plan.c) in x's dtype, and no scales. The split's pass 1 (GELU_AMAX,
    ROWS_AMAX): no codes, and the row amax (rows,) in place of the scales."""
    b, n, x_sb, x_sn = layout
    if ((plan.grid[1], plan.rows, plan.inputs * plan.c) != (b, n, x.shape[-1])
            or plan.vec_elems * x.element_size() != VEC_BYTES):
        raise ValueError(f"the plan covers {plan.grid[1]} x {plan.rows} rows of {plan.inputs} x "
                         f"{plan.c} {plan.vec_elems}-value vectors, not {b} x {n} rows of "
                         f"{x.shape[-1]} {x.dtype}")
    from prompt_diffusion_tpu_torch.ops._build import cuda_ext

    ext = cuda_ext()
    out = None if op in _AMAX_OPS else torch.empty(
        (b * n, plan.c), dtype=x.dtype if op == ADALN_F else torch.int8, device=x.device)
    scales = None if op == ADALN_F else torch.empty((b * n,), dtype=torch.float32,
                                                    device=x.device)
    mod = [a for t in (sc, sh) for a in (t or (0, False, 0, 0))]
    with torch.cuda.device(x.device):
        ext.row_quant(op, x.data_ptr(), x.dtype == torch.bfloat16, x_sb, x_sn, b, n, plan.c,
                      *mod, float(eps), plan.threads, plan.vectors, plan.groups, plan.grid[0],
                      0 if out is None else out.data_ptr(),
                      0 if scales is None else scales.data_ptr(),
                      torch.cuda.current_stream().cuda_stream)
    return out, scales


def gelu_quant(x: torch.Tensor, plan: Optional[RowPlan] = None):
    """K10 on the card: x (..., C) -> (int8 codes (..., C), fp32 row scales
    (..., 1)); `plan` overrides `row_plan`'s."""
    layout = _rows(x)
    plan = plan or row_plan(layout[1], x.shape[-1], x.dtype)
    codes, scales = _launch(GELU, x, layout, plan)
    return codes.view(x.shape), scales.view(*x.shape[:-1], 1)


def geglu_quant(proj: torch.Tensor, plan: Optional[RowPlan] = None):
    """K7 on the card: proj (..., 2I), rows [h | gate] -> (int8 codes of
    h * gelu_erf(gate) (..., I), fp32 row scales (..., 1)); one launch, no
    copy of proj; `plan` overrides `row_plan`'s."""
    layout = _rows(proj)
    if proj.shape[-1] % 16:
        raise ValueError(f"fused_geglu_quant takes (..., 2I) rows with I a multiple of 8, got "
                         f"width {proj.shape[-1]}")
    inner = proj.shape[-1] // 2
    plan = plan or row_plan(layout[1], inner, proj.dtype, inputs=2)
    if plan.inputs != 2 or plan.c != inner:
        raise ValueError(f"the plan covers {plan.inputs} x {plan.c}, not 2 x {inner}")
    codes, scales = _launch(GEGLU, proj, layout, plan)
    lead = proj.shape[:-1]
    return codes.view(*lead, inner), scales.view(*lead, 1)


def adaln_quant(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, eps: float,
                plan: Optional[RowPlan] = None):
    """K13 on the card: x (B, N, C), scale and shift (B, 1, C) or (B, C)
    views in bf16 or fp32 (read in place, any batch and column strides) ->
    (int8 codes (B, N, C), fp32 row scales (B, N, 1)); x's rows are read in
    place with its sample and row strides; one launch."""
    if x.ndim != 3:
        raise ValueError(f"fused_adaln_quant expects (B, N, C), got {tuple(x.shape)}")
    b, n, c = x.shape
    layout = _rows(x, samples=True)
    sc = _modulation("scale", scale, b, c, x.device)
    sh = _modulation("shift", shift, b, c, x.device)
    plan = plan or row_plan(b * n, c, x.dtype, samples=b)
    codes, scales = _launch(ADALN, x, layout, plan, sc, sh, eps)
    return codes.view(b, n, c), scales.view(b, n, 1)


def ln_quant(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
             plan: Optional[RowPlan] = None):
    """K6 on the card: x (..., C), the LayerNorm's (C,) weight and bias in
    fp32 or bf16 -> (int8 codes (..., C), fp32 row scales (..., 1)); one
    launch, no copy of x; `plan` overrides `row_plan`'s."""
    layout = _rows(x)
    c = x.shape[-1]
    w = _affine("weight", weight, c, x.device)
    b = _affine("bias", bias, c, x.device)
    plan = plan or row_plan(layout[1], c, x.dtype)
    codes, scales = _launch(LN, x, layout, plan, w, b, eps)
    return codes.view(x.shape), scales.view(*x.shape[:-1], 1)


def quant_rows(x: torch.Tensor, plan: Optional[RowPlan] = None):
    """K11 on the card: x (..., C) -> (int8 codes (..., C), fp32 row scales
    (..., 1)); a (B, N, C) x is read in place as B samples with its own
    strides (the MMDiT's `attn[:, :n_h]` and `attn[:, n_h:]`), one launch,
    no copy; `plan` overrides `row_plan`'s."""
    layout = _rows(x, samples=x.ndim == 3)
    plan = plan or row_plan(layout[0] * layout[1], x.shape[-1], x.dtype, samples=layout[0])
    codes, scales = _launch(ROWS, x, layout, plan)
    return codes.view(x.shape), scales.view(*x.shape[:-1], 1)


def _split_layout(x: torch.Tensor):
    """The split passes' layout and plan: x's rows read in place as `_rows`
    reads them (a (B, N, C) x as B samples with its own strides, K11's
    MMDiT slices), one row group a block (`row_plan(..., groups=1)`)."""
    layout = _rows(x, samples=x.ndim == 3)
    return layout, row_plan(layout[0] * layout[1], x.shape[-1], x.dtype, samples=layout[0],
                            groups=1)


def row_amax(x: torch.Tensor, gelu: bool) -> torch.Tensor:
    """Pass 1 of the split K10 (`gelu`) or K11 on the card: x (..., C), the
    rank's columns of each row, bf16 or fp32 (K10's and K11's checks) ->
    fp32 (..., 1), each row's max |GELU(x)| or max |x| over those columns;
    one launch, no copy of x."""
    layout, plan = _split_layout(x)
    _, amax = _launch(GELU_AMAX if gelu else ROWS_AMAX, x, layout, plan)
    return amax.view(*x.shape[:-1], 1)


def codes_from_amax(x: torch.Tensor, amax: torch.Tensor, gelu: bool):
    """Pass 2 of the split K10 (`gelu`) or K11 on the card: x as
    `row_amax` takes it and each row's amax over the whole row (fp32,
    (..., 1) or (rows,), dense) -> (int8 codes (..., C), fp32 row scales
    (..., 1)), s = max(amax / 127, 1e-8); one launch, no copy of x."""
    layout, plan = _split_layout(x)
    rows = layout[0] * layout[1]
    if (amax.dtype != torch.float32 or amax.numel() != rows or amax.device != x.device
            or not amax.is_contiguous()):
        raise ValueError(f"amax must be {rows} dense fp32 values on {x.device}, one a row of x, "
                         f"got {tuple(amax.shape)} {amax.dtype} on {amax.device}")
    codes, scales = _launch(GELU_CODES if gelu else ROWS_CODES, x, layout, plan,
                            (amax.data_ptr(), False, 0, 0))
    return codes.view(x.shape), scales.view(*x.shape[:-1], 1)


@dataclasses.dataclass(frozen=True)
class AdaLNBwdPlan:
    """How K12's backward covers `samples` x `row.rows` rows of `row.c`
    values: the row plan `row` (threads per row, vectors, row groups per
    block; `row.grid` = (blocks per sample, samples)), `blocks_per_sm` the
    occupancy it was sized by, `merge_lanes` lanes per merged sum."""

    row: RowPlan
    blocks_per_sm: int
    merge_lanes: int

    @property
    def samples(self) -> int:
        return self.row.grid[1]

    @property
    def bps(self) -> int:
        """Blocks per sample."""
        return self.row.grid[0]

    @property
    def workspace(self) -> int:
        """fp32 slots of the workspace: a (2, C) partial per block."""
        return self.samples * self.bps * 2 * self.row.c

    def merge_sums(self, block: int) -> range:
        """The sums of its sample's 2C (C sums of g, then C of g * xhat)
        that block `block` merges."""
        per = -(-2 * self.row.c // self.bps)
        return range(block * per, min((block + 1) * per, 2 * self.row.c))

    def merge_blocks(self, lane: int) -> range:
        """The blocks whose partials lane `lane` of a merged sum adds, in
        order (the lanes' sums are then added in lane order)."""
        return range(lane, self.bps, self.merge_lanes)


def adaln_bwd_plan(samples: int, rows: int, c: int, dtype: torch.dtype,
                   occupancy: Optional[Callable[[int], int]] = None, sms: int = SMS,
                   threads: Optional[int] = None,
                   per_sm: Optional[int] = None) -> AdaLNBwdPlan:
    """K12's backward plan for `samples` samples of `rows` rows of `c`
    values. `occupancy(vectors)` gives the blocks per SM of the kernel
    instantiation (the launcher asks the card; ASSUMED_OCCUPANCY without
    one); `threads` (per row) and `per_sm` (a cap on blocks per SM)
    override the rules (`tools/quant_tune.py` sweeps them). A batch of more
    samples than the card holds blocks is refused."""
    if dtype not in DTYPES:
        raise ValueError(f"rows of {dtype} are not supported: bf16 or fp32")
    if c <= 0 or c % 8:
        raise ValueError(f"row width {c} must be a positive multiple of 8")
    e = VEC_BYTES // dtype.itemsize
    nvec = c // e
    if threads is None:
        threads = next((t for t in BWD_THREADS if -(-nvec // t) <= BWD_VECTORS),
                       BLOCK_THREADS)
    if threads not in BWD_THREADS:
        raise ValueError(f"threads per row must be one of {BWD_THREADS}, got {threads}")
    # the row plan's checks (row width, samples, a thread count that holds
    # the row) before the occupancy query
    row_plan(samples * rows, c, dtype, samples=samples, threads=threads, groups=1)
    vectors = -(-nvec // threads)
    occ = occupancy(vectors) if occupancy else ASSUMED_OCCUPANCY
    if per_sm is not None:
        occ = min(occ, per_sm)
    if occ < 1:
        raise ValueError(f"no block of K12's backward fits an SM at C = {c} {dtype}")
    capacity = occ * sms
    if samples > capacity:
        raise ValueError(f"batch {samples} exceeds the {capacity} blocks the card holds at once")
    row_groups = -(-rows // (BLOCK_THREADS // threads))
    groups = -(-row_groups // (capacity // samples))
    row = row_plan(samples * rows, c, dtype, samples=samples, threads=threads, groups=groups)
    per = -(-2 * c // row.grid[0])
    lanes = min(max(1, BLOCK_THREADS // per), row.grid[0])
    return AdaLNBwdPlan(row=row, blocks_per_sm=occ, merge_lanes=1 << (lanes.bit_length() - 1))


@functools.lru_cache(maxsize=None)
def _bwd_occupancy(device: int, x_bf16: bool, vectors: int, c: int) -> int:
    from prompt_diffusion_tpu_torch.ops._build import cuda_ext

    with torch.cuda.device(device):
        blocks = cuda_ext().adaln_bwd_occupancy(x_bf16, vectors, c)
    if blocks < 0:
        raise RuntimeError(f"adaln_bwd occupancy query failed ({blocks}) for {vectors} vectors")
    return blocks


def adaln(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, eps: float,
          plan: Optional[RowPlan] = None) -> torch.Tensor:
    """K12 on the card: x (B, N, C), scale and shift (B, 1, C) or (B, C)
    views in bf16 or fp32 (read in place) -> LayerNorm without affine, then
    x * (1 + scale[b]) + shift[b], in x's dtype (B, N, C); K13's row plan
    and checks (bf16 or fp32, C a multiple of 8 up to MAX_ROW_BYTES, dense
    16-byte aligned rows, the modulation's batch x's); one launch."""
    if x.ndim != 3:
        raise ValueError(f"fused_adaln expects (B, N, C), got {tuple(x.shape)}")
    b, n, c = x.shape
    layout = _rows(x, samples=True)
    sc = _modulation("scale", scale, b, c, x.device)
    sh = _modulation("shift", shift, b, c, x.device)
    plan = plan or row_plan(b * n, c, x.dtype, samples=b)
    y, _ = _launch(ADALN_F, x, layout, plan, sc, sh, eps)
    return y.view(b, n, c)


def adaln_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, eps: float,
              shift: Optional[torch.Tensor] = None, plan: Optional[AdaLNBwdPlan] = None):
    """K12's backward on the card, one cooperative launch: x (B, N, C) and
    the output's gradient g (x's shape and dtype, its own strides), scale
    as `adaln` takes it -> (dx in x's dtype (B, N, C), dscale in scale's
    dtype and shape, dshift in shift's dtype and shape, scale's where shift
    is not given: its values are not read). `plan` overrides
    `adaln_bwd_plan`'s."""
    if x.ndim != 3:
        raise ValueError(f"fused_adaln expects (B, N, C), got {tuple(x.shape)}")
    b, n, c = x.shape
    layout = _rows(x, samples=True)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"the gradient must be {tuple(x.shape)} {x.dtype} on {x.device}, got "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")
    glayout = _rows(g, samples=True)
    sc = _modulation("scale", scale, b, c, x.device)
    shift = scale if shift is None else shift
    _modulation("shift", shift, b, c, x.device)
    from prompt_diffusion_tpu_torch.ops._build import cuda_ext

    ext = cuda_ext()
    bf16 = x.dtype == torch.bfloat16
    if plan is None:
        dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
        plan = adaln_bwd_plan(
            b, n, c, x.dtype, sms=torch.cuda.get_device_properties(dev).multi_processor_count,
            occupancy=lambda vpt: _bwd_occupancy(dev, bf16, vpt, c))
    if ((plan.samples, plan.row.rows, plan.row.c) != (b, n, c)
            or plan.row.vec_elems * x.element_size() != VEC_BYTES):
        raise ValueError(f"the plan covers {plan.samples} x {plan.row.rows} rows of "
                         f"{plan.row.c} {plan.row.vec_elems}-value vectors, not {b} x {n} rows "
                         f"of {c} {x.dtype}")
    dx = torch.empty((b, n, c), dtype=x.dtype, device=x.device)
    dscale = torch.empty((b, c), dtype=scale.dtype, device=x.device)
    dshift = torch.empty((b, c), dtype=shift.dtype, device=x.device)
    ws = torch.empty((plan.workspace,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        ext.adaln_bwd(x.data_ptr(), bf16, layout[2], layout[3], g.data_ptr(), glayout[2],
                      glayout[3], b, n, c, sc[0], sc[1], sc[2], sc[3], float(eps),
                      plan.row.threads, plan.row.vectors, plan.row.groups, plan.bps,
                      plan.merge_lanes, dx.data_ptr(), dscale.data_ptr(),
                      scale.dtype == torch.bfloat16, dshift.data_ptr(),
                      shift.dtype == torch.bfloat16, ws.data_ptr(),
                      torch.cuda.current_stream().cuda_stream)
    return dx, dscale.view(scale.shape), dshift.view(shift.shape)
