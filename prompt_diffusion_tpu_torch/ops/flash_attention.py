"""Flash attention kernels K1, K2 and K9, the attention lab kernels, their
plain versions and wrappers.

Replaces `prompt_diffusion_tpu/ops/flash_attention.py`:
  * K1 `flash_attention_packed` (packed (B, N, H*D) self-attention);
  * K2 `flash_attention` ((B, N, H, D) attention, the VAE mid-block);
  * K9 `flash_attention_packed_int8` (packed int8-QK^T attention, the SD3
    joint attention of the int8 serving mode; the SD1.5 self-attention
    with `int8_attention`).
On the card one function, `attention_route`, states which hand-written
kernel a call runs, by mode, head dimension and dtype:
  * K1 and K2 at D in SM90_HEAD_DIMS (40, 64, 80, 128) and K9 with per-head
    K (SM90_INT8_HEAD_DIMS: 32, 40, 64, 80, 128) run
    `csrc/attention_sm90.cuh`: `wgmma` warpgroups fed by TMA, a
    producer warpgroup and two or three consumer warpgroups taking turns
    (its header says what bounds it and how it is laid out; `sm90_plan`,
    `sm90_consumers` and `sm90_tensor_maps` state its tiles, shared memory
    and tensor maps);
  * K2 at the VAE's D = 512 runs `csrc/attention_sm90_wide.cuh`: two
    consumer warpgroups own 256 of O's columns each over the same 64 query
    rows, the logits summed from two half-depth partials (`wide_plan`
    states its layout, `WidePlan.grid` its grid);
  * the lab modes L1 (`flash_attention_tiled`), L2
    (`attention_no_softmax`) and L3 (`flash_attention_two_pass`) at the
    head dims of SM90_LAB_HEAD_DIMS run `csrc/attention_sm90_lab.cu`'s and
    `attention_sm90_lab_two_pass.cu`'s instantiations of the same kernel
    at a tile of SM90_LAB_TILES (`sm90_lab_plan`), and L4
    (`flash_attention_packed_int8_rowk`) at SM90_ROWK_HEAD_DIMS its int8
    instantiation with per-key scales on K9's plan (`sm90_rowk_plan`); at
    any other head dim or tile a CUDA tensor is refused;
  * other head dims above 128 run the wide kernel of
    `csrc/flash_attention.cu` (the parent of the D = 512 kernel); other
    head dims up to 128 its narrow kernel at a tile of LAB_TILES
    (`kernel_tile`), the parent design of the sm90 kernel, which
    `_parent_launch` also runs at any mode and tile of its own (the
    parent's times beside the new kernel's); `_int8_parent_launch` runs
    `csrc/int8_attention.cu`'s `int8_attn_kernel` (at `int8_block_q`
    query rows per block, D in INT8_PARENT_HEAD_DIMS), the sm90 int8
    kernel's parent, the same way.
Packed memory is the (B, N, H, D) layout, so the kernels read either
through strides. Inputs on the card are bf16; logits and softmax are fp32,
P is rounded to bf16 before P.V, and P.V accumulates in fp32. K9 quantizes
K first: its per-head mode, K9p, is one cooperative launch of an
all-resident grid whose one barrier carries each head's amax
(`quant_k_plan`); K9's wrapper launches it and the sm90 kernel on one
scratch allocation, with the plans worked out once per shape
(`_int8_sm90_setup`). `quant_k_int8` runs the prologue alone.

The lab kernels of `tools/attn_variants.py`, `attn_lab2.py`, `attn_lab3.py`
and `attn_int8_lab.py` are modes of the same kernels, each with its own
wrapper and launch count:
  * `flash_attention_tiled` (L1): online softmax with chosen query and key
    tiles (`_online_kernel`), K1's loop on the sm90 kernel;
  * `attention_no_softmax` (L2): O = sum_j bf16(s_ij * scale) V_j
    (`_online_kernel` with do_softmax=False), the sm90 kernel's turn
    without the softmax;
  * `flash_attention_two_pass` (L3): the exact row maximum first, then one
    softmax with no rescaling (the full-K kernels), the sm90 kernel's
    two-pass mode;
  * `flash_attention_packed_int8_rowk` (L4): K9 with one K scale per key
    row (`_kernel_v2`), the sm90 int8 kernel with each key's scale in its
    logit before the row maximum, after the per-row prologue; `_kernel_v3`
    is K9 itself.
`prompt_diffusion_tpu_torch/tools/attn_lab.py` runs them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from prompt_diffusion_tpu_torch.ops.dispatch import recompute_grads, use_kernel


def _torch_attention(q, k, v, scale: float, mask=None):
    """Plain attention over (B, N, H, D) (`_xla_attention`): fp32 logits,
    fp32 softmax, probabilities cast to v's dtype, fp32
    accumulation of P.V, result in v's dtype. A boolean `mask`
    broadcastable to (B, H, Nq, Nk) keeps the True positions."""
    logits = torch.matmul(q.float().permute(0, 2, 1, 3), k.float().permute(0, 2, 3, 1))
    logits = logits * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float().permute(0, 2, 1, 3))
    return out.permute(0, 2, 1, 3).to(v.dtype)


def _packed_ref(q, k, v, num_heads: int, scale: float):
    """Plain attention over packed (B, N, H*D) tensors."""
    b, nq, hd = q.shape
    d = hd // num_heads
    out = _torch_attention(q.unflatten(-1, (num_heads, d)), k.unflatten(-1, (num_heads, d)),
                           v.unflatten(-1, (num_heads, d)), scale)
    return out.reshape(b, nq, hd)


# (block_q, block_k) pairs of the narrow kernel (D <= NARROW_D) in
# csrc/flash_attention.cu; above NARROW_D the wide kernel runs the online
# mode at WIDE_TILE only
LAB_TILES = ((64, 32), (64, 64), (64, 128), (128, 32), (128, 64), (128, 128))
NARROW_D, WIDE_TILE = 128, (64, 32)
# K1's tile: the fastest of LAB_TILES at both SD1.5 heads, D = 40 (64²) and
# 80 (32²), in the paths' CFG batch (`tools/attn_tune.py`, PERF.md)
NARROW_TILE = (128, 64)
# the kernels' mode codes (csrc/flash_attention.cu, attention_sm90.cuh); the
# lab's "tiled" (L1) is the online mode at a chosen tile
_MODES = {"online": 0, "tiled": 0, "no_softmax": 1, "two_pass": 2}


def kernel_tile(d: int) -> tuple:
    """The (block_q, block_k) tile of `flash_attention.cu` at head dimension
    `d`: K1's and K2's where `attention_route` takes them there."""
    return WIDE_TILE if d > NARROW_D else NARROW_TILE


# csrc/attention_sm90.cuh: K1 and K2 in the online mode at SM90_HEAD_DIMS,
# K9 with per-head K at SM90_INT8_HEAD_DIMS. A block is one producer
# warpgroup and `sm90_consumers` consumer warpgroups of SM90_CONSUMER_ROWS
# query rows (three at D <= SM90_WIDE_CONSUMERS_D, else two); K and V tiles
# of SM90_BLOCK_K keys (K9 on three consumers: SM90_INT8_BLOCK_K) in rings
# of SM90_STAGES stages; every shared tile row one SWIZZLE_SPAN-byte swizzle
# span; at most SMEM_PER_BLOCK bytes of shared memory a block (the H100's
# 227 KB)
SM90_HEAD_DIMS, SM90_INT8_HEAD_DIMS = (40, 64, 80, 128), (32, 40, 64, 80, 128)
SM90_CONSUMER_ROWS, SM90_STAGES, SM90_WIDE_CONSUMERS_D = 64, 2, 64
SM90_BLOCK_K, SM90_INT8_BLOCK_K = 128, 112
# K9 on three consumers does a unit of padded work (query rows x keys, each
# rounded up to its tile) ~1.1x faster than on two: at the SD3 joint shape
# 0.5417 device ms for 4608 x 4480 against 0.5832 for 4480 x 4480
# (`tools/attn_tune.py --part sm90`, NVIDIA H100 80GB HBM3, 700 W)
SM90_INT8_THREE_CONSUMER_GAIN = 1.1
SWIZZLE_SPAN, SMEM_PER_BLOCK = 128, 232448
_ROUTE_MODES = ("online", "tiled", "no_softmax", "two_pass", "int8", "int8_rowk")
# csrc/attention_sm90_lab.cu, attention_sm90_lab_two_pass.cu: the lab modes
# L1 ("tiled"), L2 ("no_softmax") and L3 ("two_pass") on the sm90 kernel at
# these head dims (L3 also at lab3's heads padded from 40 to 64 and 128),
# at (block_q, block_k) tiles of SM90_LAB_TILES: SM90_CONSUMER_ROWS query
# rows per consumer warpgroup (two, or three at D <= SM90_WIDE_CONSUMERS_D)
# and 64- or 128-key tiles; L4 (per-row K) at SM90_ROWK_HEAD_DIMS on K9's
# plans, lab mode code SM90_ROWK_MODE, its key scales in a ring of
# SM90_STAGES stages of SM90_SCALE_ALIGN-byte aligned rows, their rows a
# pitch of whole SM90_SCALE_PITCH floats apart (a TMA stride: 16 bytes)
SM90_LAB_HEAD_DIMS = {"tiled": (40,), "no_softmax": (40,), "two_pass": (40, 64, 128)}
SM90_LAB_TILES = ((128, 64), (128, 128), (192, 64), (192, 128))
SM90_ROWK_HEAD_DIMS, SM90_ROWK_MODE = (64,), 3
SM90_SCALE_ALIGN, SM90_SCALE_PITCH = 128, 4


def attention_route(mode: str, d: int, dtype=torch.bfloat16) -> str:
    """The kernel a call on the card runs. `mode`: "online" (K1, K2),
    "tiled", "no_softmax", "two_pass" (the labs at a chosen tile), "int8"
    (K9) or "int8_rowk" (the lab's per-row K). Returns "sm90" or
    "int8_sm90" (csrc/attention_sm90.cuh; the labs' "tiled", "no_softmax"
    and "two_pass" at SM90_LAB_HEAD_DIMS through the lab instantiations,
    "int8_rowk" at SM90_ROWK_HEAD_DIMS), "wide_sm90"
    (csrc/attention_sm90_wide.cuh, the online mode at WIDE_HEAD_DIM),
    "narrow" or "wide" (flash_attention.cu's fa_narrow_kernel,
    fa_wide_kernel; for the lab modes only the parent has that head dim,
    `_parent_launch`, and their wrappers refuse a CUDA tensor there) or
    "int8_parent" (int8_attention.cu's int8_attn_kernel: the per-row-K
    lab mode's head dims that only the parent has, `_int8_parent_launch`;
    its wrapper refuses a CUDA tensor there).
    Raises ValueError for what no kernel takes: the kernels read bf16."""
    if mode not in _ROUTE_MODES:
        raise ValueError(f"unknown attention mode {mode!r}; one of {_ROUTE_MODES}")
    if dtype != torch.bfloat16:
        raise ValueError(f"the attention kernels take bf16 inputs, not {dtype}")
    if mode == "int8":
        if d not in SM90_INT8_HEAD_DIMS:
            raise ValueError(f"head dim {d} not supported {SM90_INT8_HEAD_DIMS}")
        return "int8_sm90"
    if mode == "int8_rowk":
        return "int8_sm90" if d in SM90_ROWK_HEAD_DIMS else "int8_parent"
    if d > NARROW_D:
        return "wide_sm90" if mode == "online" and d == WIDE_HEAD_DIM else "wide"
    if mode == "online":
        return "sm90" if d in SM90_HEAD_DIMS else "narrow"
    return "sm90" if d in SM90_LAB_HEAD_DIMS.get(mode, ()) else "narrow"


@dataclasses.dataclass(frozen=True)
class Sm90Plan:
    """How `attention_sm90.cuh` lays out a block at head dimension `d`
    (`int8`: K9, whose K arrives as int8 codes): its consumer warpgroups,
    query rows and threads, key tile and stages; the 128-byte column blocks of a
    Q or V row (bf16) and of a K row; the depth of Q.K^T (D rounded up to
    wgmma's k16, or for int8 codes its k32, over zero pads: Q's are TMA's
    zero fill) and the N of P.V (D); the dynamic shared memory of a block
    (Q, the K and V stages, the 1024-byte alignment slack); and the bytes
    between the heads of K9's codes (`k_head_bytes`). A lab mode's plan
    (`sm90_lab_plan`) names its key tile (`key_tile`); L4's
    (`sm90_rowk_plan`, `row_k`) adds a ring of the key scales' stages
    (`scale_stage`) and the pitch of their rows (`scale_pitch`)."""

    d: int
    int8: bool
    consumers: int
    stages: int = SM90_STAGES
    key_tile: Optional[int] = None
    row_k: bool = False

    @property
    def block_k(self) -> int:
        """Keys of a tile: the lab's `key_tile`, else 128; 112 for K9 on
        three consumers, whose 160 registers a thread hold 128-key tiles
        only with spills."""
        if self.key_tile is not None:
            return self.key_tile
        return SM90_INT8_BLOCK_K if self.int8 and self.consumers == 3 else SM90_BLOCK_K

    @property
    def block_q(self) -> int:
        return SM90_CONSUMER_ROWS * self.consumers

    @property
    def threads(self) -> int:
        """The producer warpgroup and the consumers, 128 threads each."""
        return 128 * (1 + self.consumers)

    @property
    def qv_blocks(self) -> int:
        return -(-2 * self.d // SWIZZLE_SPAN)

    @property
    def k_blocks(self) -> int:
        return -(-self.d // SWIZZLE_SPAN) if self.int8 else self.qv_blocks

    @property
    def qk_depth(self) -> int:
        step = 32 if self.int8 else 16
        return -(-self.d // step) * step

    @property
    def k_head_bytes(self) -> int:
        """Bytes from one head's K codes to the next's as K9p writes them
        for the kernel: D rounded up to 16, since a tensor map takes only
        strides of whole 16 bytes (48 at D = 40, whose last 8 bytes a head
        stay unwritten and lie past the map's extent D, so TMA reads zeros
        there; a map over dense codes whose box starts at column h*D
        faults on the card)."""
        return -(-self.d // 16) * 16 if self.int8 else 2 * self.d

    @property
    def pv_n(self) -> int:
        return self.d

    @property
    def row_pad(self) -> int:
        """Zero columns past D in a bf16 Q or V tile row (TMA's fill)."""
        return self.qv_blocks * SWIZZLE_SPAN // 2 - self.d

    @property
    def scale_stage(self) -> int:
        """Bytes of a stage of L4's key scales: a tile's fp32 scales,
        SM90_SCALE_ALIGN-byte aligned (TMA's destination); 0 elsewhere."""
        align = SM90_SCALE_ALIGN
        return -(-4 * self.block_k // align) * align if self.row_k else 0

    def scale_pitch(self, nk: int) -> int:
        """Floats between two (batch, head) rows of L4's key scales as the
        prologue writes them for the kernel's map: `nk` rounded up to
        SM90_SCALE_PITCH (a stride of whole 16 bytes; at the lab's N = 4250
        a dense row is 17,000 bytes, which no map takes)."""
        return -(-nk // SM90_SCALE_PITCH) * SM90_SCALE_PITCH

    @property
    def smem(self) -> int:
        span = SWIZZLE_SPAN
        return (self.qv_blocks * self.block_q * span
                + self.stages * (self.k_blocks + self.qv_blocks) * self.block_k * span
                + self.stages * self.scale_stage + 1024)

    def grid(self, batch: int, heads: int, nq: int) -> tuple:
        return -(-nq // self.block_q), batch * heads


def sm90_consumers(d: int, int8: bool, nq: Optional[int] = None,
                   nk: Optional[int] = None) -> int:
    """Consumer warpgroups of a block: three at D <= 64 (more rows in
    flight hide the softmax's latency; `tools/attn_tune.py --part sm90`
    times two beside them), two above, where the O accumulator leaves no
    room for a third. K9 at D <= 64 with `nq` queries and `nk` keys keeps
    two where three would pad the work by more than they gain
    (SM90_INT8_THREE_CONSUMER_GAIN): UniFormer's N = 1024 is whole 128-row
    and 128-key tiles, but 1152 rows and 1120 keys on three."""
    if d > SM90_WIDE_CONSUMERS_D:
        return 2
    if int8 and nq is not None and nk is not None:
        padded = lambda n, tile: -(-n // tile) * tile
        three = padded(nq, 3 * SM90_CONSUMER_ROWS) * padded(nk, SM90_INT8_BLOCK_K)
        two = padded(nq, 2 * SM90_CONSUMER_ROWS) * padded(nk, SM90_BLOCK_K)
        if three > SM90_INT8_THREE_CONSUMER_GAIN * two:
            return 2
    return 3


@functools.lru_cache(maxsize=None)
def sm90_plan(d: int, int8: bool = False, consumers: Optional[int] = None) -> Sm90Plan:
    """The plan of the sm90 kernel at head dimension `d` on `consumers`
    warpgroups (`sm90_consumers(d, int8)` by default); ValueError where it
    is not instantiated."""
    dims = SM90_INT8_HEAD_DIMS if int8 else SM90_HEAD_DIMS
    if d not in dims:
        raise ValueError(f"the sm90 {'int8 ' if int8 else ''}kernel takes head dims {dims}, "
                         f"not {d}")
    default = sm90_consumers(d, int8)
    consumers = default if consumers is None else consumers
    if consumers != default and not (int8 and consumers == 2):
        raise ValueError(f"the sm90 kernel at D = {d} runs {default} consumers"
                         + (" (K9 also 2)" if int8 and default == 3 else "") + f", not {consumers}")
    return Sm90Plan(d=d, int8=int8, consumers=consumers)


def sm90_lab_tile(d: int) -> tuple:
    """K1's (block_q, block_k) tile at head dim `d`: the lab wrappers'
    default."""
    return SM90_CONSUMER_ROWS * sm90_consumers(d, False), SM90_BLOCK_K


def sm90_lab_tiles(d: int, mode: str) -> tuple:
    """The tiles of SM90_LAB_TILES instantiated for the lab mode `mode` at
    head dim `d` (none where the mode does not take `d`): three consumers
    only at D <= SM90_WIDE_CONSUMERS_D."""
    if d not in SM90_LAB_HEAD_DIMS.get(mode, ()):
        return ()
    return tuple(t for t in SM90_LAB_TILES
                 if t[0] <= 2 * SM90_CONSUMER_ROWS or d <= SM90_WIDE_CONSUMERS_D)


@functools.lru_cache(maxsize=None)
def sm90_lab_plan(d: int, mode: str, tile: Optional[tuple] = None) -> Sm90Plan:
    """The plan of a lab mode on the sm90 kernel ("tiled": L1, "two_pass":
    L3) at head dim `d` and a (block_q, block_k) `tile` of SM90_LAB_TILES
    (`sm90_lab_tile(d)` by default): block_q / SM90_CONSUMER_ROWS consumer
    warpgroups and block_k-key tiles. ValueError where it is not
    instantiated: another mode, head dim or tile, three consumers above
    D = SM90_WIDE_CONSUMERS_D, or more shared memory than a block has."""
    dims = SM90_LAB_HEAD_DIMS.get(mode)
    if dims is None:
        raise ValueError(f"the sm90 kernel runs the lab modes {tuple(SM90_LAB_HEAD_DIMS)}, "
                         f"not {mode!r}")
    if d not in dims:
        raise ValueError(f"the sm90 kernel's {mode} mode takes head dims {dims}, not {d}")
    tile = sm90_lab_tile(d) if tile is None else tuple(tile)
    if tile not in sm90_lab_tiles(d, mode):
        raise ValueError(f"tiles {tile} are not instantiated at D = {d}; one of "
                         f"{sm90_lab_tiles(d, mode)}")
    plan = Sm90Plan(d=d, int8=False, consumers=tile[0] // SM90_CONSUMER_ROWS, key_tile=tile[1])
    if plan.smem > SMEM_PER_BLOCK:
        raise ValueError(f"the {mode} plan at D = {d}, tiles {tile} needs {plan.smem} bytes of "
                         f"shared memory, above {SMEM_PER_BLOCK}")
    return plan


@functools.lru_cache(maxsize=None)
def sm90_rowk_plan(d: int, nq: int, nk: int) -> Sm90Plan:
    """L4's plan on the sm90 kernel at head dim `d` for `nq` queries and
    `nk` keys: K9's (`sm90_consumers(d, True, nq, nk)` consumers, 112-key
    tiles on three, 128 on two) with the key scales' ring. ValueError at a
    head dim not in SM90_ROWK_HEAD_DIMS."""
    if d not in SM90_ROWK_HEAD_DIMS:
        raise ValueError(f"the sm90 kernel's per-row-K mode takes head dims "
                         f"{SM90_ROWK_HEAD_DIMS}, not {d}")
    return Sm90Plan(d=d, int8=True, consumers=sm90_consumers(d, True, nq, nk), row_k=True)


def lab_parent_tile(tile: tuple) -> tuple:
    """The parent's tile (LAB_TILES) that the lab times beside the sm90
    kernel's `tile`: the same key tile, and the parent's 4 or 8 warps of
    16 rows (64 or 128 query rows) beside two or three consumer warpgroups
    of 64."""
    block_q, block_k = tile
    return block_q - SM90_CONSUMER_ROWS, block_k


# csrc/attention_sm90_wide.cuh: K2 in the online mode at WIDE_HEAD_DIM. A
# CTA is one producer warpgroup and WIDE_CONSUMERS consumer warpgroups over
# the same WIDE_ROWS query rows, each owning D / WIDE_CONSUMERS columns of O
# and half the depth of Q.K^T; K and V tiles of WIDE_BLOCK_K keys in rings
# of SM90_STAGES stages, every row of Q, K and V 2 D / SWIZZLE_SPAN column
# blocks; one CTA a query block. `setmaxnreg` gives the producer and each
# consumer WIDE_REGS registers a thread.
WIDE_HEAD_DIM, WIDE_ROWS, WIDE_BLOCK_K, WIDE_CONSUMERS = 512, 64, 32, 2
WIDE_REGS = (40, 232)
REGISTERS_PER_SM = 65536


@dataclasses.dataclass(frozen=True)
class WidePlan:
    """How `attention_sm90_wide.cuh` lays out a CTA at head dimension `d`:
    its consumer warpgroups, query rows and threads, key tile and stages,
    the 128-byte column blocks of a row, O's columns and Q.K^T's depth per
    consumer, the dynamic shared memory (Q, the K and V
    stages, the two consumers' partial logits in two buffers, the
    1024-byte alignment slack) and the registers of a CTA."""

    d: int
    consumers: int = WIDE_CONSUMERS
    rows: int = WIDE_ROWS
    block_k: int = WIDE_BLOCK_K
    stages: int = SM90_STAGES
    regs: tuple = WIDE_REGS  # (producer, consumer) registers a thread

    @property
    def threads(self) -> int:
        return 128 * (1 + self.consumers)

    @property
    def column_blocks(self) -> int:
        return 2 * self.d // SWIZZLE_SPAN

    @property
    def consumer_cols(self) -> int:
        """O's columns, and Q.K^T's depth, of one consumer."""
        return self.d // self.consumers

    @property
    def partial_bytes(self) -> int:
        """One consumer's fp32 partial logits of a tile."""
        return self.rows * self.block_k * 4

    @property
    def smem(self) -> int:
        span = SWIZZLE_SPAN
        return (self.column_blocks * self.rows * span
                + self.stages * 2 * self.column_blocks * self.block_k * span
                + 2 * self.consumers * self.partial_bytes + 1024)

    @property
    def registers(self) -> int:
        producer, consumer = self.regs
        return 128 * (producer + self.consumers * consumer)

    def grid(self, batch: int, heads: int, nq: int) -> tuple:
        """(query blocks, B * H): the last block's rows past N are read as
        zeros and not stored."""
        return -(-nq // self.rows), batch * heads


@functools.lru_cache(maxsize=None)
def wide_plan(d: int) -> WidePlan:
    """The plan of the wide sm90 kernel at head dimension `d`; ValueError
    where it is not instantiated."""
    if d != WIDE_HEAD_DIM:
        raise ValueError(f"the wide sm90 kernel takes head dim {WIDE_HEAD_DIM}, not {d}")
    return WidePlan(d=d)


def wide_tensor_maps(plan: WidePlan, q, k, v) -> tuple:
    """The maps of q, k and v the wide kernel encodes (`sm90_tensor_map`):
    Q in boxes of the CTA's rows, K and V of the key tile."""
    return tuple(sm90_tensor_map(name, t, rows) for name, t, rows in
                 (("q", q, plan.rows), ("k", k, plan.block_k), ("v", v, plan.block_k)))


_TMA_STRIDE_LIMIT = 1 << 40  # bytes: cuTensorMapEncodeTiled's bound on a stride


def sm90_check_view(name: str, t: torch.Tensor, heads: Optional[int] = None) -> None:
    """Raise ValueError where cuTensorMapEncodeTiled would refuse the sm90
    kernel's map of the (B, N, H, D) view `t` (with `heads`: of a packed
    (B, N, H*D) `t` read as that view): it needs a dense head dimension, a
    16-byte aligned base, and the strides of the dimensions of extent
    above 1 positive multiples of 16 bytes below 2^40 (one of extent 1
    takes stride 16, as the kernel's encoder gives it). The check each
    launch makes; `sm90_tensor_map` states the whole map."""
    es = t.element_size()
    st, sh = t.stride(), t.shape
    if heads is not None:  # the packed rows' view, without building it
        d = sh[2] // heads
        st, sh = (st[0], st[1], d * st[2], st[2]), (sh[0], sh[1], heads, d)
    s0, s1, s2 = st[0] * es, st[1] * es, st[2] * es  # written out: this runs on every launch
    if (st[3] != 1 or t.data_ptr() % 16
            or (sh[0] > 1 and (s0 <= 0 or s0 % 16 or s0 >= _TMA_STRIDE_LIMIT))
            or (sh[1] > 1 and (s1 <= 0 or s1 % 16 or s1 >= _TMA_STRIDE_LIMIT))
            or (sh[2] > 1 and (s2 <= 0 or s2 % 16 or s2 >= _TMA_STRIDE_LIMIT))):
        raise ValueError(f"{name}: TMA needs a dense head dimension, a 16-byte aligned base "
                         f"and strides that are positive multiples of 16 bytes, got element "
                         f"strides {st}")


def sm90_tensor_map(name: str, t: torch.Tensor, rows: int) -> tuple:
    """The TMA tensor map the sm90 kernel encodes for a (B, N, H, D) view
    `t`: (name, element bytes, dims (D, N, H, B), byte strides (N, H, B),
    box). Raises ValueError for a map cuTensorMapEncodeTiled refuses
    (`sm90_check_view`; the box is one swizzle span of values by `rows`
    rows, at most 256, of one head of one sample)."""
    sm90_check_view(name, t)
    es = t.element_size()
    b, n, h, d = t.shape
    strides = tuple(st * es if size > 1 else 16
                    for st, size in ((t.stride(1), n), (t.stride(2), h), (t.stride(0), b)))
    box = (SWIZZLE_SPAN // es, rows, 1, 1)
    if max(box) > 256:
        raise ValueError(f"{name}: box {box} exceeds TMA's 256 values a dimension")
    return name, es, (d, n, h, b), strides, box


def sm90_tensor_maps(plan: Sm90Plan, q, k, v) -> tuple:
    """The maps of q, k (K9: its int8 codes as K9p writes them,
    `quant_k_int8(..., head_bytes=plan.k_head_bytes)`) and v
    (`sm90_tensor_map`)."""
    return tuple(sm90_tensor_map(name, t, rows) for name, t, rows in
                 (("q", q, plan.block_q), ("k", k, plan.block_k), ("v", v, plan.block_k)))


def _check(q, k, v, scale: float) -> None:
    """Raise ValueError for the inputs no attention kernel takes, before any
    build."""
    b, nq, h, d = q.shape
    if not scale > 0:
        raise ValueError(f"scale {scale} must be positive (the kernel takes the row maximum "
                         "before scaling)")
    nk = k.shape[1]
    if k.shape != (b, nk, h, d) or v.shape != (b, nk, h, d):
        raise ValueError(f"q/k/v shapes disagree: {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    device = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.device != device:
            raise ValueError(f"{name} must be bf16 on {device}, got {t.dtype} on {t.device}")
        st = t.stride()
        if st[3] != 1 or st[0] % 8 or st[1] % 8 or st[2] % 8 or t.data_ptr() % 16:
            raise ValueError(f"{name} rows must be dense and 16-byte aligned, strides {st}")
    if d % 8 or d > 512:
        raise ValueError(f"head dim {d} not supported (needs D % 8 == 0 and D <= 512)")


def _sm90_launch(q, k, v, scale: float) -> torch.Tensor:
    """`attention_sm90.cuh` on bf16 (B, N, H, D) views that
    `sm90_check_view` passed (K1, K2; K9's launch is `_int8_sm90_launch`,
    the lab modes' `_lab_sm90_launch`); returns a contiguous (B, Nq, H, D)
    bf16 tensor."""
    from prompt_diffusion_tpu_torch.ops._build import cuda_ext

    b, nq, h, d = q.shape
    plan = sm90_plan(d)
    out = torch.empty((b, nq, h, d), dtype=torch.bfloat16, device=q.device)
    with torch.cuda.device(q.device):
        cuda_ext().attention_sm90_fwd(
            q.data_ptr(), k.data_ptr(), 0, v.data_ptr(), out.data_ptr(), False, b, h, nq,
            k.shape[1], d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            float(scale), plan.consumers, torch.cuda.current_stream().cuda_stream)
    return out


def _wide_launch(q, k, v, scale: float) -> torch.Tensor:
    """`attention_sm90_wide.cuh` on (B, N, H, 512) bf16 views that
    `sm90_check_view` passed; returns a contiguous (B, Nq, H, D) bf16
    tensor."""
    from prompt_diffusion_tpu_torch.ops._build import cuda_ext

    b, nq, h, d = q.shape
    out = torch.empty((b, nq, h, d), dtype=torch.bfloat16, device=q.device)
    with torch.cuda.device(q.device):
        cuda_ext().attention_sm90_wide_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, nq, k.shape[1], d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            float(scale), torch.cuda.current_stream().cuda_stream)
    return out


def _lab_sm90_launch(q, k, v, scale: float, mode: str, tile: tuple) -> torch.Tensor:
    """`attention_sm90_lab.cu`: the lab mode `mode` ("tiled", "no_softmax",
    "two_pass") on bf16 (B, N, H, D) views at `tile` (`sm90_lab_plan`);
    every refusal before any build. Returns a contiguous (B, Nq, H, D) bf16
    tensor."""
    b, nq, h, d = q.shape
    _check(q, k, v, scale)
    plan = sm90_lab_plan(d, mode, tuple(tile))
    for name, t in (("q", q), ("k", k), ("v", v)):
        sm90_check_view(name, t)
    from prompt_diffusion_tpu_torch.ops._build import cuda_ext

    out = torch.empty((b, nq, h, d), dtype=torch.bfloat16, device=q.device)
    with torch.cuda.device(q.device):
        cuda_ext().attention_sm90_lab_fwd(
            q.data_ptr(), k.data_ptr(), 0, 0, v.data_ptr(), out.data_ptr(), b, h, nq, k.shape[1],
            d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            float(scale), _MODES[mode], plan.consumers, plan.block_k,
            torch.cuda.current_stream().cuda_stream)
    return out


def _launch(q, k, v, scale: float) -> torch.Tensor:
    """K1's and K2's launch on (B, N, H, D) views: the kernel
    `attention_route("online", D)` names, the parent `flash_attention.cu`
    at `kernel_tile(D)` where no sm90 kernel takes D; returns a contiguous
    (B, Nq, H, D) tensor."""
    d = q.shape[-1]
    _check(q, k, v, scale)
    route = attention_route("online", d, q.dtype)
    if route in ("sm90", "wide_sm90"):
        for name, t in (("q", q), ("k", k), ("v", v)):
            sm90_check_view(name, t)
        if route == "wide_sm90":
            return _wide_launch(q, k, v, scale)
        return _sm90_launch(q, k, v, scale)
    return _parent_launch(q, k, v, scale, "online", kernel_tile(d))


def _parent_launch(q, k, v, scale: float, mode: str, tile: tuple) -> torch.Tensor:
    """`flash_attention.cu`, the parent design, on (B, N, H, D) views:
    `fa_narrow_kernel` in `mode` ("online", "no_softmax", "two_pass") at a
    `tile` of LAB_TILES up to D = NARROW_D, `fa_wide_kernel` online at
    WIDE_TILE above. K1/K2 at head dims no sm90 kernel takes run it; so do
    the parent's times beside the sm90 kernels (`chip_smoke.py`, the lab,
    `tools/attn_tune.py`). Counts its launches in
    `_parent_launch.launches`. Returns a contiguous (B, Nq, H, D)
    tensor."""
    from prompt_diffusion_tpu_torch.ops._build import cuda_ext

    b, nq, h, d = q.shape
    _check(q, k, v, scale)
    tile = tuple(tile)
    if mode not in _MODES:
        raise ValueError(f"the parent runs the modes {tuple(_MODES)}, not {mode!r}")
    if d > NARROW_D and (mode != "online" or tile != WIDE_TILE):
        raise ValueError(f"head dim {d} > {NARROW_D} runs only the online mode at {WIDE_TILE}")
    if d <= NARROW_D and tile not in LAB_TILES:
        raise ValueError(f"tiles {tile} are not instantiated; one of {LAB_TILES}")
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        cuda_ext().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, nq, k.shape[1], d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            float(scale), _MODES[mode], *tile,
            torch.cuda.current_stream().cuda_stream)
    _parent_launch.launches += 1
    return out


_parent_launch.launches = 0


# samples per chunk of an attention backward's recompute: the chunk's fp32
# logits stay within this many bytes (a (8, 8, 4096, 4096) batch would hold
# 4.3 GB of logits, and as much again of probabilities and of their gradient)
_BWD_LOGIT_BYTES = 1 << 30


def _recompute_grads(plain, g, inputs, needs, heads: int):
    """`dispatch.recompute_grads` of attention, in chunks of samples whose
    fp32 logits (`heads` x Nq x Nk each) fit `_BWD_LOGIT_BYTES`; each
    sample's gradient depends on that sample alone."""
    q, k = inputs[0], inputs[1]
    chunk = max(1, _BWD_LOGIT_BYTES // (4 * heads * q.shape[1] * k.shape[1]))
    parts = [recompute_grads(plain, g[s:s + chunk], [t[s:s + chunk] for t in inputs], needs)
             for s in range(0, q.shape[0], chunk)]
    return [(col[0] if len(col) == 1 else torch.cat(col)) if n else None
            for col, n in zip(zip(*parts), needs)]


class _Attention(torch.autograd.Function):
    """K2 with its gradient: the kernel forward on CUDA tensors (the plain
    version on the CPU), the backward by recompute of `_torch_attention`."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v)
        if not use_kernel(q):
            return _torch_attention(q, k, v, scale)
        out = _launch(q, k, v, scale)
        flash_attention.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        flash_attention.backward_calls += 1
        plain = functools.partial(_torch_attention, scale=ctx.scale)
        q = ctx.saved_tensors[0]
        return (*_recompute_grads(plain, g, ctx.saved_tensors, ctx.needs_input_grad[:3],
                                  q.shape[2]), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """K2: attention over (B, N, H, D) tensors, no mask; differentiable in
    q, k and v (each backward counted in `backward_calls`)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _Attention.apply(q, k, v, float(scale))


flash_attention.launches = 0
flash_attention.backward_calls = 0


class _PackedAttention(torch.autograd.Function):
    """K1 with its gradient: the kernel forward on CUDA tensors (the plain
    version on the CPU), the backward by recompute of `_packed_ref`."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, scale):
        ctx.num_heads, ctx.scale = num_heads, scale
        ctx.save_for_backward(q, k, v)
        if not use_kernel(q):
            return _packed_ref(q, k, v, num_heads, scale)
        d = q.shape[-1] // num_heads
        out = _launch(q.unflatten(-1, (num_heads, d)), k.unflatten(-1, (num_heads, d)),
                      v.unflatten(-1, (num_heads, d)), scale)
        flash_attention_packed.launches += 1
        return out.view(q.shape)

    @staticmethod
    def backward(ctx, g):
        flash_attention_packed.backward_calls += 1
        plain = functools.partial(_packed_ref, num_heads=ctx.num_heads, scale=ctx.scale)
        return (*_recompute_grads(plain, g, ctx.saved_tensors, ctx.needs_input_grad[:3],
                                  ctx.num_heads), None, None)


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """K1: attention over packed (B, N, H*D) tensors, the projection
    layout, with no head transposes; differentiable in q, k and v (each
    backward counted in `backward_calls`)."""
    d = q.shape[-1] // num_heads
    if scale is None:
        scale = d ** -0.5
    return _PackedAttention.apply(q, k, v, num_heads, float(scale))


flash_attention_packed.launches = 0
flash_attention_packed.backward_calls = 0


def _torch_attention_no_softmax(q, k, v, scale: float):
    """Plain no-softmax lab attention over (B, N, H, D): fp32 logits times
    `scale`, cast to v's dtype, P.V summed in fp32, result in v's dtype."""
    logits = torch.matmul(q.float().permute(0, 2, 1, 3), k.float().permute(0, 2, 3, 1))
    p = (logits * scale).to(v.dtype).float()
    return torch.matmul(p, v.float().permute(0, 2, 1, 3)).permute(0, 2, 1, 3).to(v.dtype)


def _lab_sm90(wrapper, mode, q, k, v, scale, block_q, block_k):
    """L1, L2 and L3: the plain version on the CPU, the sm90 kernel's lab
    mode on the card at (block_q, block_k) of SM90_LAB_TILES (K1's tile at
    D where None), any other tile refused on both."""
    default_q, default_k = sm90_lab_tile(q.shape[-1])
    tile = (default_q if block_q is None else block_q, default_k if block_k is None else block_k)
    if tile not in SM90_LAB_TILES:
        raise ValueError(f"tiles {tile} are not instantiated; one of {SM90_LAB_TILES}")
    if not use_kernel(q):
        plain = _torch_attention_no_softmax if mode == "no_softmax" else _torch_attention
        return plain(q, k, v, float(scale))
    out = _lab_sm90_launch(q, k, v, float(scale), mode, tile)
    wrapper.launches += 1
    return out


def flash_attention_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                          block_q: Optional[int] = None,
                          block_k: Optional[int] = None) -> torch.Tensor:
    """Lab L1: softmax attention over (B, N, H, D) with an online softmax
    over key tiles of `block_k` and `block_q` query rows per block
    (`attn_variants.py::_online_kernel`): K1's loop on the sm90 kernel at a
    tile of SM90_LAB_TILES (K1's tile by default), head dims
    SM90_LAB_HEAD_DIMS["tiled"]."""
    return _lab_sm90(flash_attention_tiled, "tiled", q, k, v, scale, block_q, block_k)


def attention_no_softmax(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                         block_q: Optional[int] = None,
                         block_k: Optional[int] = None) -> torch.Tensor:
    """Lab L2: O = sum_j bf16(s_ij * scale) V_j over (B, N, H, D), no max,
    exp or division (`attn_variants.py::_online_kernel`,
    do_softmax=False): the sm90 kernel's turn without the softmax at a tile
    of SM90_LAB_TILES (K1's tile by default), head dims
    SM90_LAB_HEAD_DIMS["no_softmax"]."""
    return _lab_sm90(attention_no_softmax, "no_softmax", q, k, v, scale, block_q, block_k)


def flash_attention_two_pass(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                             block_q: Optional[int] = None,
                             block_k: Optional[int] = None) -> torch.Tensor:
    """Lab L3: softmax attention over (B, N, H, D) in two passes over the
    keys, the exact row maximum, then exp(s - m), its sum and P.V with no
    rescaling (the full-K kernels of `attn_variants.py`, `attn_lab2.py` and
    `attn_lab3.py`): the sm90 kernel's two-pass mode at a tile of
    SM90_LAB_TILES (K1's tile by default), head dims
    SM90_LAB_HEAD_DIMS["two_pass"]."""
    return _lab_sm90(flash_attention_two_pass, "two_pass", q, k, v, scale, block_q, block_k)


flash_attention_tiled.launches = attention_no_softmax.launches = 0
flash_attention_two_pass.launches = 0


def _int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax / 127, 1e-8) with the IEEE quotient on every device, as the
    TPU kernel, the JAX package on the CPU and K9 compute it. (PyTorch's CUDA
    division by a Python number multiplies by its reciprocal, one ulp off
    the quotient for ~4% of values; a divisor tensor on the same device
    takes the true division.)"""
    return torch.clamp_min(amax / torch.full((), 127.0, device=amax.device), 1e-8)


def _quant_k_per_head(k: torch.Tensor, num_heads: int):
    """Packed (B, N, H*D) K -> (int8 codes (B, N, H*D), fp32 scales (B, H)):
    one scale per (batch, head), max(amax / 127, 1e-8), codes round(k / s)
    with ties to even, clipped to +-127 (`flash_attention.py:391-395` of the
    JAX package, which computes it outside the kernel too). The plain
    version of `quant_k_int8`."""
    b, nk, hd = k.shape
    kf = k.float().view(b, nk, num_heads, hd // num_heads)
    skh = _int8_scale(kf.abs().amax(dim=(1, 3)))
    codes = torch.clamp(torch.round(kf / skh[:, None, :, None]), -127, 127).to(torch.int8)
    return codes.view(b, nk, hd), skh


def _quant_k_per_row(k: torch.Tensor, num_heads: int):
    """Packed (B, N, H*D) K -> (int8 codes (B, N, H*D), fp32 scales (B, H,
    N)): one scale per (batch, key row, head), as `attn_int8_lab.py:72-76`
    computes it outside the kernel."""
    b, nk, hd = k.shape
    kf = k.float().view(b, nk, num_heads, hd // num_heads)
    skr = _int8_scale(kf.abs().amax(dim=-1))  # (B, N, H)
    codes = torch.clamp(torch.round(kf / skr[..., None]), -127, 127).to(torch.int8)
    return codes.view(b, nk, hd), skr.permute(0, 2, 1)


def _torch_int8_attention(q, k, v, num_heads: int, scale: float, row_k: bool = False):
    """Plain K9 over packed (B, N, H*D) tensors, the TPU kernel's math:
    K per (batch, head) and Q per row and head to int8; logits
    f32(q_i8 . k_i8) * (sq * (skh * scale)); fp32 softmax as exp(s - max)
    over its sum; P cast to v's dtype, P.V summed in fp32, divided by the
    sum; output in q's dtype. The integer products are exact in fp32 (|sum|
    < 2^24 for D < 1040, also under TF32: the codes have 8 bits). With
    `row_k` (the lab's v2) K has one scale per key row, the logits are
    f32(q_i8 . k_i8) * (sq * sk) * scale, and P is cast to bf16 whatever
    v's dtype, as the lab's kernel casts it (`attn_int8_lab.py:62`)."""
    b, nq, hd = q.shape
    d = hd // num_heads
    kc, sk = (_quant_k_per_row if row_k else _quant_k_per_head)(k, num_heads)
    qf = q.float().view(b, nq, num_heads, d)
    sq = _int8_scale(qf.abs().amax(dim=-1, keepdim=True))  # (B, Nq, H, 1)
    qc = torch.clamp(torch.round(qf / sq), -127, 127)
    heads = lambda t: t.view(b, -1, num_heads, d).permute(0, 2, 1, 3)  # (B, H, N, D)
    s32 = torch.matmul(heads(qc), heads(kc.float()).transpose(-1, -2))  # (B, H, Nq, Nk)
    if row_k:
        logits = s32 * (sq.permute(0, 2, 1, 3) * sk[:, :, None, :]) * scale
    else:
        logits = s32 * (sq.permute(0, 2, 1, 3) * (sk[:, :, None, None] * scale))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(torch.bfloat16 if row_k else v.dtype).float(), heads(v).float()) / l
    return o.permute(0, 2, 1, 3).reshape(b, nq, hd).to(q.dtype)


def flash_attention_packed_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                num_heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """K9: int8-QK^T attention over packed (B, N, H*D) tensors (the int8
    serving mode's attention). K is quantized with one scale per (batch,
    head), folded into the softmax scale, by K9's prologue
    (`quant_k_int8`); Q per row inside the kernel; fp32 softmax; P.V in
    bf16 with fp32 sums. The prologue and the kernel on CUDA, the plain
    version on the CPU."""
    return _int8_attention(flash_attention_packed_int8, False, q, k, v, num_heads, scale)


flash_attention_packed_int8.launches = 0


def flash_attention_packed_int8_rowk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     num_heads: int,
                                     scale: Optional[float] = None) -> torch.Tensor:
    """Lab L4: K9 with one K scale per (batch, key row, head), the logits
    f32(s32) * (sq * sk) * scale (`attn_int8_lab.py::_kernel_v2`): on the
    card the per-row prologue (`quant_k_int8(..., per_row=True)`), then the
    sm90 int8 kernel with each key's scale in its logit before the row
    maximum (`sm90_rowk_plan`), head dims SM90_ROWK_HEAD_DIMS."""
    return _int8_attention(flash_attention_packed_int8_rowk, True, q, k, v, num_heads, scale)


flash_attention_packed_int8_rowk.launches = 0


def _int8_attention(wrapper, row_k, q, k, v, num_heads, scale):
    d = q.shape[-1] // num_heads
    if scale is None:
        scale = d ** -0.5
    if not use_kernel(q):
        return _torch_int8_attention(q, k, v, num_heads, float(scale), row_k)
    out = _int8_launch(q, k, v, num_heads, float(scale), row_k)
    wrapper.launches += 1
    return out


# K9 and its per-head prologue K9p at INT8_HEAD_DIMS (the sm90 kernel);
# the parent `int8_attn_kernel` (`_int8_parent_launch`) and the per-row
# prologue at INT8_PARENT_HEAD_DIMS (a row's D / 8 lanes divide a warp)
INT8_HEAD_DIMS, INT8_PARENT_HEAD_DIMS = SM90_INT8_HEAD_DIMS, (32, 64, 128)
INT8_BLOCK_Q = (64, 128)


def int8_block_q(nq: int) -> int:
    """K9's query rows per block at `nq` queries: 128, the tile of K1's
    narrow kernel, unless 128-row blocks would leave more than a tenth of
    their rows idle (the ViT's N = 1025 leaves 127 of 1,152): then 64.
    On the H100 64 rows win at N = 1025 and lose at the SD3 joint 4429
    and the lab's 4250 (2.3% idle) (`tools/attn_tune.py --part int8`)."""
    pad = -nq % 128
    return 64 if 10 * pad > nq + pad else 128


def _check_packed_bf16(name, t, device):
    if t.dtype != torch.bfloat16 or t.device != device:
        raise ValueError(f"{name} must be bf16 on {device}, got {t.dtype} on {t.device}")
    if t.stride(-1) != 1 or t.stride(1) % 8 or t.stride(0) % 8 or t.data_ptr() % 16:
        raise ValueError(f"{name} rows must be dense and 16-byte aligned, strides {t.stride()}")


def _check_int8(q, k, v, num_heads: int, scale: float, block_q: Optional[int] = None) -> None:
    """Raise ValueError for what K9 on the sm90 kernel (`block_q` None) or
    on its parent at `block_q` query rows, and K9p, refuse, before any
    build (L4's head dims are checked by `sm90_rowk_plan`)."""
    b, nq, hd = q.shape
    nk = k.shape[1]
    if k.shape != (b, nk, hd) or v.shape != (b, nk, hd) or hd % num_heads:
        raise ValueError(f"q/k/v shapes disagree: {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} with {num_heads} heads")
    dims = INT8_HEAD_DIMS if block_q is None else INT8_PARENT_HEAD_DIMS
    if hd // num_heads not in dims:
        raise ValueError(f"head dim {hd // num_heads} not supported {dims}")
    if not scale > 0:
        raise ValueError(f"scale {scale} must be positive (the kernel takes the row maximum "
                         "before scaling)")
    if block_q is not None and block_q not in INT8_BLOCK_Q:
        raise ValueError(f"block_q {block_q} is not instantiated; one of {INT8_BLOCK_Q}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_packed_bf16(name, t, q.device)
    if block_q is None:  # the sm90 kernel's maps of Q and V (K9p writes K's codes)
        sm90_check_view("q", q, num_heads)
        sm90_check_view("v", v, num_heads)


def _int8_launch(q, k, v, num_heads: int, scale: float, row_k: bool = False) -> torch.Tensor:
    """The kernel `attention_route` names after K's prologue: the sm90
    int8 kernel, for per-head K (`_int8_sm90_launch`) or per-row K
    (`_int8_rowk_sm90_launch`); returns a contiguous (B, Nq, H*D) bf16
    tensor."""
    if row_k:
        return _int8_rowk_sm90_launch(q, k, v, num_heads, scale)
    return _int8_sm90_launch(q, k, v, num_heads, scale)


def _int8_rowk_sm90_launch(q, k, v, num_heads: int, scale: float) -> torch.Tensor:
    """L4 on the card: the per-row prologue `k_row_codes_kernel` (codes
    (B, Nk, H*D), scales in rows `plan.scale_pitch(Nk)` floats apart),
    then the sm90 kernel's per-row-K mode on them (`sm90_rowk_plan`), on
    one stream in one device context; every refusal before any build.
    Counts the prologue's launch in `quant_k_int8.launches`. Returns a
    contiguous (B, Nq, H*D) bf16 tensor."""
    b, nq, hd = q.shape
    nk = k.shape[1]
    if hd % num_heads:
        raise ValueError(f"{num_heads} heads do not divide {hd} columns")
    d = hd // num_heads
    plan = sm90_rowk_plan(d, nq, nk)
    _check_int8(q, k, v, num_heads, scale)
    from prompt_diffusion_tpu_torch.ops._build import cuda_ext

    kc, sk = quant_k_int8(k, num_heads, per_row=True, scale_pitch=plan.scale_pitch(nk))
    out = torch.empty((b, nq, hd), dtype=torch.bfloat16, device=q.device)
    with torch.cuda.device(q.device):
        cuda_ext().attention_sm90_lab_fwd(
            q.data_ptr(), kc.data_ptr(), sk.data_ptr(), sk.stride(1), v.data_ptr(),
            out.data_ptr(), b, num_heads, nq, nk, d, q.stride(0), q.stride(1), d, kc.stride(0),
            kc.stride(1), d, v.stride(0), v.stride(1), d, out.stride(0), out.stride(1), d, scale,
            SM90_ROWK_MODE, plan.consumers, plan.block_k, torch.cuda.current_stream().cuda_stream)
    return out


def _int8_parent_launch(q, k, v, num_heads: int, scale: float, row_k: bool = False,
                        block_q: Optional[int] = None) -> torch.Tensor:
    """`int8_attention.cu`'s `int8_attn_kernel`, the parent design of the
    sm90 int8 kernel, after its prologue (`quant_k_int8`, per head or per
    key row): at `block_q` query rows per block (`int8_block_q` by
    default), D in INT8_PARENT_HEAD_DIMS. No wrapper runs it; the parent's
    times beside K9 and L4 do (`chip_smoke.py`, the lab,
    `tools/attn_tune.py`). Counts its launches in
    `_int8_parent_launch.launches`. Returns a contiguous (B, Nq, H*D)
    tensor."""
    b, nq, hd = q.shape
    block_q = int8_block_q(nq) if block_q is None else block_q
    _check_int8(q, k, v, num_heads, scale, block_q)
    from prompt_diffusion_tpu_torch.ops._build import cuda_ext

    kc, sk = quant_k_int8(k, num_heads, row_k)
    out = torch.empty((b, nq, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        cuda_ext().int8_attention_fwd(
            q.data_ptr(), kc.data_ptr(), sk.data_ptr(), row_k, v.data_ptr(), out.data_ptr(),
            b, num_heads, nq, k.shape[1], hd // num_heads, q.stride(0), q.stride(1),
            kc.stride(0), kc.stride(1), v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            scale, block_q, torch.cuda.current_stream().cuda_stream)
    _int8_parent_launch.launches += 1
    return out


_int8_parent_launch.launches = 0


@functools.lru_cache(maxsize=256)
def _int8_sm90_setup(b: int, nq: int, nk: int, num_heads: int, d: int, device: int) -> tuple:
    """What K9's launch on the card `device` needs at a shape, worked out
    once: the sm90 plan (its consumers for these lengths), K9p's plan (the
    card's occupancy and SM count asked once) and the layout of its one
    scratch allocation: K's codes (B, Nk, H, plan.k_head_bytes) at byte 0,
    their (B, H) fp32 scales at `off_sk`, K9p's workspace at `off_ws`,
    `nbytes` in all. Returns (plan, K9p's plan, off_sk, off_ws, nbytes)."""
    plan = sm90_plan(d, True, sm90_consumers(d, True, nq, nk))
    qk = quant_k_plan(b, nk, num_heads, d, occupancy=lambda t: _quant_k_occupancy(device, d, t),
                      sms=torch.cuda.get_device_properties(device).multi_processor_count)
    off_sk = -(-b * nk * num_heads * plan.k_head_bytes // 16) * 16
    off_ws = off_sk + 4 * b * num_heads
    return plan, qk, off_sk, off_ws, off_ws + 4 * qk.workspace


def _int8_sm90_launch(q, k, v, num_heads: int, scale: float) -> torch.Tensor:
    """K9 with per-head K on the card: K9p's launch into a scratch
    allocation (codes, scales, workspace), then the sm90 kernel's on it,
    on one stream in one device context; the plans come from
    `_int8_sm90_setup`. Counts K9p's launch in `quant_k_int8.launches`.
    Returns a contiguous (B, Nq, H*D) bf16 tensor."""
    b, nq, hd = q.shape
    nk = k.shape[1]
    _check_int8(q, k, v, num_heads, scale)
    from prompt_diffusion_tpu_torch.ops._build import cuda_ext

    ext = cuda_ext()
    d = hd // num_heads
    device = q.device
    plan, qk, off_sk, off_ws, nbytes = _int8_sm90_setup(b, nq, nk, num_heads, d, device.index)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=device)
    out = torch.empty((b, nq, hd), dtype=torch.bfloat16, device=device)
    codes, kd = scratch.data_ptr(), plan.k_head_bytes
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        ext.int8_quant_k_head(k.data_ptr(), k.stride(0), k.stride(1), b, num_heads, nk, d,
                              qk.rows, qk.threads, qk.bps, codes + off_ws, codes + off_sk, codes,
                              kd, stream)
        quant_k_int8.launches += 1
        ext.attention_sm90_fwd(q.data_ptr(), codes, codes + off_sk, v.data_ptr(), out.data_ptr(),
                               True, b, num_heads, nq, nk, d, q.stride(0), q.stride(1), d,
                               nk * num_heads * kd, num_heads * kd, kd, v.stride(0), v.stride(1),
                               d, nq * hd, hd, d, scale, plan.consumers, stream)
    return out


# K9p's plan: threads of a block, at most (the kernel's __launch_bounds__),
# and key rows in flight per block, R = max(1, QK_ROW_THREADS // CV) with CV
# = H*D/8 16-byte vectors a key row; blocks per SM at most QK_BLOCKS_PER_SM
# (the best of 1 to 16 in `tools/quant_tune.py --part time` on the H100 at
# the SD3 joint shape), and what the CPU tests assume of the occupancy
# query where no card answers it
QK_MAX_THREADS, QK_ROW_THREADS, QK_MAX_HEADS = 512, 256, 128
QK_BLOCKS_PER_SM, QK_ASSUMED_OCCUPANCY, SMS = 4, 8, 132


@dataclasses.dataclass(frozen=True)
class QuantKPlan:
    """How K9p covers a (batch, nk, H*D) K: blocks of `threads` >= cv x
    rows threads (whole warps), `bps` blocks per sample each holding a
    contiguous range of its key rows, thread (r, v) vector v of rows r, r +
    rows, ...; every block resident at once."""

    batch: int
    nk: int
    heads: int
    d: int
    cv: int
    rows: int
    threads: int
    bps: int
    blocks_per_sm: int

    @property
    def grid(self) -> int:
        return self.batch * self.bps

    @property
    def workspace(self) -> int:
        """fp32 slots: each block's amax per head."""
        return self.grid * self.heads

    def block_rows(self, j: int):
        """Key rows [first, last) of its sample that block j holds."""
        return j * self.nk // self.bps, (j + 1) * self.nk // self.bps


def quant_k_plan(batch: int, nk: int, num_heads: int, d: int,
                 occupancy: Optional[Callable[[int], int]] = None,
                 sms: int = SMS) -> QuantKPlan:
    """K9p's plan for `batch` samples of `nk` key rows of `num_heads`
    heads of `d`. `occupancy(threads)` gives the blocks per SM of the
    kernel at `threads` threads (the launcher asks the card;
    QK_ASSUMED_OCCUPANCY without one); at most QK_BLOCKS_PER_SM of them
    are used. Raises ValueError on a shape the kernel does not take and
    RuntimeError where the grid cannot be resident."""
    if batch < 1 or nk < 1 or num_heads < 1:
        raise ValueError(f"empty K (B, N, H) = ({batch}, {nk}, {num_heads})")
    if d not in INT8_HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported {INT8_HEAD_DIMS}")
    cv = num_heads * d // 8
    if cv > QK_MAX_THREADS or num_heads > QK_MAX_HEADS:
        raise ValueError(f"{num_heads} heads of {d} exceed the {QK_MAX_THREADS} vectors a K9p "
                         f"block holds per key row")
    rows = max(1, QK_ROW_THREADS // cv)
    threads = -(-cv * rows // 32) * 32
    occ = occupancy(threads) if occupancy else QK_ASSUMED_OCCUPANCY
    return _quant_k_plan(batch, nk, num_heads, d, cv, rows, threads, occ, sms,
                         QK_BLOCKS_PER_SM)


@functools.lru_cache(maxsize=None)
def _quant_k_plan(batch, nk, num_heads, d, cv, rows, threads, occ, sms, blocks_per_sm):
    """The plan at most `blocks_per_sm` blocks an SM (`tools/quant_tune.py`
    sweeps it)."""
    per_sm = min(occ, blocks_per_sm)
    if per_sm < 1 or batch > per_sm * sms:
        raise RuntimeError(f"quant_k_int8 of K ({batch}, {nk}, {num_heads * d}) with "
                           f"{num_heads} heads: the grid cannot be resident ({occ} blocks of "
                           f"{threads} threads per SM, {sms} SMs, at least {batch} blocks)")
    return QuantKPlan(batch=batch, nk=nk, heads=num_heads, d=d, cv=cv, rows=rows,
                      threads=threads, bps=max(1, min(nk, per_sm * sms // batch)),
                      blocks_per_sm=per_sm)


@functools.lru_cache(maxsize=None)
def _quant_k_occupancy(device: int, d: int, threads: int) -> int:
    from prompt_diffusion_tpu_torch.ops._build import cuda_ext

    with torch.cuda.device(device):
        blocks = cuda_ext().int8_quant_k_occupancy(d, threads)
    if blocks < 0:
        raise RuntimeError(f"K9p occupancy query failed ({blocks}) at D={d}, {threads} threads")
    return blocks


def quant_k_int8(k: torch.Tensor, num_heads: int, per_row: bool = False,
                 head_bytes: Optional[int] = None, scale_pitch: Optional[int] = None):
    """K9's prologue: packed (B, N, H*D) K -> (int8 codes (B, N, H*D), fp32
    scales), one scale per (batch, head) (B, H), or per (batch, head, key
    row) (B, H, N) with `per_row` (D in INT8_PARENT_HEAD_DIMS). On CUDA one
    launch of `csrc/int8_attention.cu`: K9p (`k_head_quant_kernel`,
    `quant_k_plan`) per head, `k_row_codes_kernel` per row; bit-equal to
    the plain versions `_quant_k_per_head` and `_quant_k_per_row`, which
    the CPU takes. Per head with `head_bytes` (a multiple of 8, at least D; K9's
    `Sm90Plan.k_head_bytes`) the codes' heads lie that many bytes apart,
    as the sm90 kernel reads them: a (B, N, H, D) view of (B, N, H,
    head_bytes) memory (on the CPU the plain codes viewed so). Per row
    with `scale_pitch` (a multiple of SM90_SCALE_PITCH, at least N; L4's
    `Sm90Plan.scale_pitch`) the scales' (batch, head) rows lie that many
    floats apart, as the sm90 kernel's map reads them: a (B, H, N) view of
    (B, H, scale_pitch) memory whose floats past N stay unwritten (on the
    CPU the plain scales)."""
    if head_bytes is not None and per_row:
        raise ValueError("head_bytes lays out per-head codes; the per-row codes are dense")
    if scale_pitch is not None and not per_row:
        raise ValueError("scale_pitch lays out per-row scales; the per-head scales are (B, H)")
    if scale_pitch is not None and (scale_pitch < k.shape[1] or scale_pitch % SM90_SCALE_PITCH):
        raise ValueError(f"scale_pitch {scale_pitch}: a multiple of {SM90_SCALE_PITCH}, at least "
                         f"N = {k.shape[1]}")
    if not use_kernel(k):
        codes, scales = (_quant_k_per_row if per_row else _quant_k_per_head)(k, num_heads)
        return (codes, scales) if head_bytes is None else (codes.unflatten(-1, (num_heads, -1)),
                                                           scales)
    b, nk, hd = k.shape
    dims = INT8_PARENT_HEAD_DIMS if per_row else INT8_HEAD_DIMS
    if hd % num_heads or hd // num_heads not in dims:
        raise ValueError(f"head dim of {hd} / {num_heads} not supported {dims}")
    _check_packed_bf16("k", k, k.device)
    d = hd // num_heads
    _check_head_bytes(head_bytes, d)
    from prompt_diffusion_tpu_torch.ops._build import cuda_ext

    ext = cuda_ext()
    if per_row:
        pitch = nk if scale_pitch is None else scale_pitch
        codes = torch.empty((b, nk, hd), dtype=torch.int8, device=k.device)
        scales = torch.empty((b, num_heads, pitch), dtype=torch.float32, device=k.device)
        with torch.cuda.device(k.device):
            ext.int8_quant_k_rows(k.data_ptr(), k.stride(0), k.stride(1), b, num_heads, nk, d,
                                  scales.data_ptr(), pitch, codes.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
        scales = scales[..., :nk]
    else:
        dev = k.device.index if k.device.index is not None else torch.cuda.current_device()
        plan = quant_k_plan(b, nk, num_heads, d,
                            occupancy=lambda t: _quant_k_occupancy(dev, d, t),
                            sms=torch.cuda.get_device_properties(dev).multi_processor_count)
        codes, scales = _quant_k_head(k, plan, head_bytes)
    quant_k_int8.launches += 1
    return codes, scales


def _check_head_bytes(head_bytes: Optional[int], d: int) -> None:
    if head_bytes is not None and (head_bytes < d or head_bytes % 8):
        raise ValueError(f"head_bytes {head_bytes}: a multiple of 8, at least D = {d}")


def _quant_k_head(k: torch.Tensor, plan: QuantKPlan, head_bytes: Optional[int] = None):
    """K9p's launch on a checked K at `plan` (`tools/quant_tune.py` gives
    the plans of its sweep): dense (B, N, H*D) codes, or with `head_bytes`
    the (B, N, H, D) view of codes whose heads lie that many bytes apart."""
    from prompt_diffusion_tpu_torch.ops._build import cuda_ext

    b, nk, hd = k.shape
    if (plan.batch, plan.nk, plan.heads * plan.d) != (b, nk, hd):
        raise ValueError(f"the plan covers {(plan.batch, plan.nk, plan.heads, plan.d)}, not "
                         f"K {tuple(k.shape)}")
    _check_head_bytes(head_bytes, plan.d)
    kd = plan.d if head_bytes is None else head_bytes
    codes = torch.empty((b, nk, plan.heads, kd), dtype=torch.int8, device=k.device)
    scales = torch.empty((b, plan.heads), dtype=torch.float32, device=k.device)
    ws = torch.empty((plan.workspace,), dtype=torch.float32, device=k.device)
    with torch.cuda.device(k.device):
        cuda_ext().int8_quant_k_head(k.data_ptr(), k.stride(0), k.stride(1), b, plan.heads, nk,
                                     plan.d, plan.rows, plan.threads, plan.bps, ws.data_ptr(),
                                     scales.data_ptr(), codes.data_ptr(), kd,
                                     torch.cuda.current_stream().cuda_stream)
    if head_bytes is None:
        return codes.view(b, nk, hd), scales
    return codes[..., :plan.d], scales


quant_k_int8.launches = 0
