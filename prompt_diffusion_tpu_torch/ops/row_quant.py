"""The launch plan and launchers of K10 (tanh-GELU -> int8), K13 (AdaLN
-> int8) and K7 (GEGLU -> int8), the CUDA C++ kernels of
`csrc/row_quant.cu`.

`fused_act.fused_gelu_quant`, `fused_act.fused_geglu_quant` and
`fused_adaln.fused_adaln_quant` send a CUDA tensor here. `row_plan` cuts a
row of C output values into 16-byte vectors (8 bf16 or 4 fp32) and gives
them to the row's threads, vector t + k * TPR to thread t; a thread holds
that vector of each of the row's `inputs` (K7: h and gate, 2 inputs), and
all of them count against the 8 vectors a thread may hold: one warp per
row while a lane holds at most 8 vectors (C <= 2048 in bf16: the row's
reductions are shuffles, with no barrier), else the fewest threads (64,
128 or 256) that hold at most 4 vectors each (K10's C = 6144 in bf16: 256
threads of 3 vectors), else 256 threads of up to 8; for K7 at most 3 + 3
(C = 1280, 2560 and 5120: 64, 128 and 256 threads of 3 + 3).
Blocks are 256 threads, so a block holds 256 / TPR rows at a time (a row
group); it walks `groups` row groups of one sample (the K13 modulation is
per sample), loading the next group while it quantizes the current one
when `groups` > 1: 4, or 2, where the grid still keeps MIN_BLOCKS blocks,
else 1. Rows are at most 32 KB (`MAX_ROW_BYTES`): C <= 16384 in bf16, 8192
in fp32 (K7: 2C values, C <= 8192 and 4096).

Every refusal is a `ValueError` raised before the extension is built or a
launch is queued; a CUDA tensor never falls back to the plain version.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

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
MAX_ROW_BYTES = BLOCK_THREADS * MAX_VECTORS * VEC_BYTES  # 32 KB
DTYPES = (torch.bfloat16, torch.float32)
GELU, ADALN, GEGLU = 0, 1, 2  # the `op` of `csrc/row_quant.cu`
# row groups a block walks, pipelined, while the grid keeps MIN_BLOCKS blocks
# (~2 per SM of the H100's 132): the best of 1, 2, 4 and 8 groups at each
# SD3 shape, or within 1% of it (`tools/quant_tune.py --part time`)
MAX_GROUPS, MIN_BLOCKS = 4, 256


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
    if threads not in (32, 64, 128, 256):
        raise ValueError(f"threads per row must be 32, 64, 128 or 256, got {threads}")
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


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x (..., C) as an (N, C) view of dense, 16-byte aligned rows; never a
    copy."""
    _check_float("x", x)
    c = x.shape[-1]
    if c <= 0 or c % 8:
        raise ValueError(f"row width {c} must be a positive multiple of 8")
    if c * x.element_size() > MAX_ROW_BYTES:
        raise ValueError(f"row width {c} exceeds the plan's "
                         f"{MAX_ROW_BYTES // x.element_size()} {x.dtype} values")
    try:
        x2 = x.view(-1, c)
    except RuntimeError:
        x2 = None
    if x2 is None or x.stride(-1) != 1 or x2.stride(0) < c:
        raise ValueError(f"rows must be contiguous: shape {tuple(x.shape)}, strides {x.stride()}")
    if x2.data_ptr() % VEC_BYTES or (x2.stride(0) * x2.element_size()) % VEC_BYTES:
        raise ValueError(f"rows must be 16-byte aligned, row stride {x2.stride(0)}")
    return x2


def _modulation(name: str, t: torch.Tensor, b: int, c: int, device) -> torch.Tensor:
    """A (B, 1, C) or (B, C) scale or shift as a (B, C) view."""
    _check_float(name, t)
    if t.shape not in ((b, 1, c), (b, c)):
        raise ValueError(f"{name} must be ({b}, 1, {c}) or ({b}, {c}) for x's batch {b}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    return t.reshape(b, c)


def _launch(op, x2, b, plan, sc=None, sh=None, eps=0.0):
    """Codes (rows, plan.c) and scales (rows,) of the `b` x plan.rows rows
    of x2 (each plan.inputs x plan.c wide)."""
    from prompt_diffusion_tpu_torch.ops._build import cuda_ext

    ext = cuda_ext()
    rows = b * plan.rows
    codes = torch.empty((rows, plan.c), dtype=torch.int8, device=x2.device)
    scales = torch.empty((rows,), dtype=torch.float32, device=x2.device)
    mod = []
    for t in (sc, sh):
        mod += ([0, False, 0, 0] if t is None else
                [t.data_ptr(), t.dtype == torch.bfloat16, t.stride(0), t.stride(1)])
    with torch.cuda.device(x2.device):
        ext.row_quant(op, x2.data_ptr(), x2.dtype == torch.bfloat16, plan.rows * x2.stride(0),
                      x2.stride(0), b, plan.rows, plan.c, *mod, float(eps), plan.threads,
                      plan.vectors, plan.groups, plan.grid[0], codes.data_ptr(),
                      scales.data_ptr(), torch.cuda.current_stream().cuda_stream)
    return codes, scales


def gelu_quant(x: torch.Tensor, plan: Optional[RowPlan] = None):
    """K10 on the card: x (..., C) -> (int8 codes (..., C), fp32 row scales
    (..., 1)); `plan` overrides `row_plan`'s."""
    x2 = _rows(x)
    plan = plan or row_plan(x2.shape[0], x2.shape[1], x2.dtype)
    codes, scales = _launch(GELU, x2, 1, plan)
    return codes.view(x.shape), scales.view(*x.shape[:-1], 1)


def geglu_quant(proj: torch.Tensor, plan: Optional[RowPlan] = None):
    """K7 on the card: proj (..., 2I), rows [h | gate] -> (int8 codes of
    h * gelu_erf(gate) (..., I), fp32 row scales (..., 1)); one launch, no
    copy of proj; `plan` overrides `row_plan`'s."""
    x2 = _rows(proj)
    if x2.shape[1] % 16:
        raise ValueError(f"fused_geglu_quant takes (..., 2I) rows with I a multiple of 8, got "
                         f"width {x2.shape[1]}")
    inner = x2.shape[1] // 2
    plan = plan or row_plan(x2.shape[0], inner, x2.dtype, inputs=2)
    if plan.inputs != 2 or plan.c != inner:
        raise ValueError(f"the plan covers {plan.inputs} x {plan.c}, not 2 x {inner}")
    codes, scales = _launch(GEGLU, x2, 1, plan)
    lead = proj.shape[:-1]
    return codes.view(*lead, inner), scales.view(*lead, 1)


def adaln_quant(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, eps: float,
                plan: Optional[RowPlan] = None):
    """K13 on the card: x (B, N, C), scale and shift (B, 1, C) or (B, C)
    views in bf16 or fp32 (read in place, any batch and column strides) ->
    (int8 codes (B, N, C), fp32 row scales (B, N, 1)); one launch."""
    if x.ndim != 3:
        raise ValueError(f"fused_adaln_quant expects (B, N, C), got {tuple(x.shape)}")
    b, n, c = x.shape
    x2 = _rows(x)
    sc = _modulation("scale", scale, b, c, x.device)
    sh = _modulation("shift", shift, b, c, x.device)
    plan = plan or row_plan(b * n, c, x.dtype, samples=b)
    codes, scales = _launch(ADALN, x2, b, plan, sc, sh, eps)
    return codes.view(b, n, c), scales.view(b, n, 1)
