"""The launch plans and launchers of K5 (GroupNorm(+SiLU) -> int8) and K3
(GroupNorm(+SiLU or ReLU)), the CUDA C++ kernels of `csrc/gn_quant.cu`.

`fused_group_norm.fused_group_norm_quant` and `fused_group_norm` send a
CUDA tensor here. Each kernel is one cooperative launch of a persistent
grid (the design is described in the source); `gn_plan` (K5) and
`gn_float_plan` (K3) decide how the grid covers the activation:
  * a block is CV x R threads rounded up to whole warps: CV = C / 8
    threads a pixel, each holding 8 channels (one 16-byte vector of bf16,
    two of fp32), R = max(1, 256 // CV) pixel rows in flight (C = 320: 40
    x 6 = 240 threads, 256 launched); thread (r, v) reads channels 8v ..
    8v + 7 of pixels r, r + R, ... of each chunk of R x K pixels;
  * K, the pixels a thread loads at once, is the largest of 8 (bf16
    only), 4, 2 and 1 whose chunks still give half the SMs a block (the 8²
    latents take K = 4: 128 blocks; the sweep of `tools/quant_tune.py
    --part time` on the H100: ~one full block per SM beat one chunk per
    resident block at the 8² and 16² sites, by a third at (8, 1280, 8,
    8));
  * each sample's pixels are split into `bps` contiguous ranges, one per
    block, the same count within one pixel (a grid barrier waits for the
    slowest block), each cut into chunks of R x K pixels; bps = the blocks
    the card holds at once over the samples (the occupancy query, with the
    kernel's shared buffers, `static_smem`), at most one block per chunk
    of the sample. A batch of more samples than the card holds blocks is
    refused (the largest batch a path gives is 16).
The workspace is B x bps x G group partials (mean, M2), then a count per
block (every group's the same); K5's then an amax per block. Every slot is written before
it is read, so neither needs a memset.

Every refusal of a shape or dtype is a `ValueError` raised before the
extension is built or a launch is queued; K3's grid that the occupancy
query says cannot be resident raises a `RuntimeError` naming the shape.
A CUDA tensor never falls back to the plain version.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import torch

VEC_BYTES = 16
THREAD_CHANNELS = 8  # channels of a pixel a thread holds (the kernels' kPix)
MAX_THREADS = 512  # the kernels' __launch_bounds__
ROW_THREADS = 256  # pixel rows in flight: R = max(1, ROW_THREADS // CV)
# pixels a thread loads per chunk (the kernels' template K), most first; 8
# fp32 pixels (16 vectors) would not fit a thread's registers
KS = {torch.bfloat16: (8, 4, 2, 1), torch.float32: (4, 2, 1)}
SMS = 132  # the H100 SXM's SMs (the launcher reads the card's)
SMEM_BLOCK = 232448  # bytes of shared memory a Hopper block may have
WARP = 32
DTYPES = tuple(KS)
# blocks per SM the CPU tests assume where no card answers the occupancy
# query (the launcher asks the card)
ASSUMED_OCCUPANCY = 2
# K3's epilogues, as the kernel's template takes them
ACT_NONE, ACT_SILU, ACT_RELU = 0, 1, 2


def static_smem(c: int, rows: int, groups: int) -> int:
    """Bytes of the kernels' shared buffers (`static_floats` in
    `csrc/gn_quant.cu`): gamma and beta, 2 R C per-row channel means and
    M2, cmin and cmax, R row counts, 2 G group terms, a float per warp."""
    return 4 * (4 * c + 2 * rows * c + rows + 2 * groups + WARP)


def merge_lanes(threads: int, groups: int) -> int:
    """Lanes of a warp per group in the kernels' merges (`merge_lanes` in
    `csrc/gn_quant.cu`): the largest power of two <= min(32, threads //
    groups), at least 1."""
    per = max(1, min(WARP, threads // groups))
    return 1 << (per.bit_length() - 1)


@dataclasses.dataclass(frozen=True)
class GnPlan:
    """How `csrc/gn_quant.cu` covers a (batch, hw, c) activation: blocks of
    `threads` >= cv x rows threads (whole warps), `bps` blocks per sample
    each holding a contiguous range of its pixels cut into chunks of rows x
    k pixels (`chunks` of them cover a sample), `blocks_per_sm` resident
    per SM."""

    batch: int
    hw: int
    c: int
    groups: int
    cv: int
    rows: int
    threads: int
    k: int
    chunks: int
    bps: int
    blocks_per_sm: int
    quant: bool = True  # K5's plan (with an amax slot per block), else K3's

    @property
    def grid(self) -> int:
        return self.batch * self.bps

    @property
    def workspace(self) -> int:
        """fp32 slots of the workspace: the group partials (mean, M2) of
        every sample's blocks, a count per block, then (K5) an amax per
        block."""
        return self.grid * (2 * self.groups + 1) + (self.grid if self.quant else 0)

    def block_pixels(self, j: int) -> Tuple[int, int]:
        """Pixels [first, last) of its sample that block j of the sample
        holds (the kernel's p0, p1)."""
        return j * self.hw // self.bps, (j + 1) * self.hw // self.bps

    def block_chunks(self, j: int) -> int:
        """The chunks of rows x k pixels that cut block j's range."""
        first, last = self.block_pixels(j)
        return -(-(last - first) // (self.rows * self.k))

    def pixels(self, j: int, chunk: int, r: int):
        """Pixels of the sample that row r's threads of block j read in
        `chunk`."""
        lo, hi = self.block_pixels(j)
        first = lo + chunk * self.rows * self.k + r
        return [p for p in range(first, first + self.k * self.rows, self.rows) if p < hi]


def _check_shape(batch: int, c: int, hw: int, groups: int, dtype: torch.dtype,
                 name: str = "fused_group_norm_quant") -> int:
    """Threads per pixel; raises ValueError on what the kernel does not
    take."""
    if dtype not in DTYPES:
        raise ValueError(f"{name} takes bf16 or fp32 activations, got {dtype}")
    if batch < 1 or c < 1 or hw < 1:
        raise ValueError(f"empty activation (B, C, HW) = ({batch}, {c}, {hw})")
    if groups < 1 or c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    if c % THREAD_CHANNELS:
        raise ValueError(f"channels {c} must be a multiple of {THREAD_CHANNELS}")
    cv = c // THREAD_CHANNELS
    if cv > MAX_THREADS:
        raise ValueError(f"{c} channels exceed the plan's {MAX_THREADS} threads of "
                         f"{THREAD_CHANNELS} channels per pixel")
    if static_smem(c, max(1, ROW_THREADS // cv), groups) > SMEM_BLOCK:
        raise ValueError(f"the workspace of {c} channels, {groups} groups exceeds the shared "
                         f"memory the plan allows")
    return cv


def _threads(cv: int) -> int:
    """Threads of a block: cv x R, rounded up to whole warps."""
    return -(-cv * max(1, ROW_THREADS // cv) // WARP) * WARP


@functools.lru_cache(maxsize=None)
def _plan(batch, c, hw, groups, dtype, occupancy: Tuple[int, ...], sms, k, quant) -> GnPlan:
    """K5's plan (quant) or K3's; `occupancy` the blocks per SM at each of
    the dtype's KS."""
    name = "fused_group_norm_quant" if quant else "fused_group_norm"
    cv = _check_shape(batch, c, hw, groups, dtype, name)
    rows = max(1, ROW_THREADS // cv)
    threads = _threads(cv)
    ks = KS[dtype]
    occ = dict(zip(ks, occupancy))
    if k is not None and k not in ks:
        raise ValueError(f"pixels per thread must be one of {ks} in {dtype}, got {k}")

    def unresident(msg):
        if quant:
            return ValueError(msg)
        return RuntimeError(f"{name} of ({batch}, {c}, {hw} pixels) {dtype} in {groups} "
                            f"groups: the grid cannot be resident: {msg}")

    for kk in ((k,) if k is not None else ks):
        if occ[kk] < 1:
            raise unresident(f"no block of {threads} threads fits an SM (occupancy {occ[kk]})")
        capacity = occ[kk] * sms
        chunks = -(-hw // (rows * kk))
        if 2 * batch * chunks >= sms or kk == ks[-1] or k is not None:
            break
    if batch > capacity:
        raise unresident(f"batch {batch} exceeds the {capacity} blocks the card holds at once")
    return GnPlan(batch=batch, hw=hw, c=c, groups=groups, cv=cv, rows=rows, threads=threads,
                  k=kk, chunks=chunks, bps=max(1, min(chunks, capacity // batch)),
                  blocks_per_sm=occ[kk], quant=quant)


def _occupancies(c, groups, dtype, occupancy, name) -> Tuple[int, ...]:
    cv = _check_shape(1, c, 1, groups, dtype, name)
    threads = _threads(cv)
    smem = static_smem(c, max(1, ROW_THREADS // cv), groups)
    return tuple((occupancy(kk, threads, smem) if occupancy else ASSUMED_OCCUPANCY)
                 for kk in KS[dtype])


def gn_plan(batch: int, c: int, hw: int, groups: int, dtype: torch.dtype,
            occupancy: Optional[Callable[[int, int, int], int]] = None, sms: int = SMS,
            k: Optional[int] = None) -> GnPlan:
    """K5's plan for `batch` samples of `hw` pixels of `c` channels in
    `groups` groups. `occupancy(k, threads, smem)` gives the blocks per SM
    of the kernel with K = k at `threads` threads and `smem` bytes of
    shared memory (the launcher asks the card; ASSUMED_OCCUPANCY without
    one); `k` forces K (`tools/quant_tune.py` sweeps it)."""
    _check_shape(batch, c, hw, groups, dtype)
    occ = _occupancies(c, groups, dtype, occupancy, "fused_group_norm_quant")
    return _plan(batch, c, hw, groups, dtype, occ, sms, k, True)


def gn_float_plan(batch: int, c: int, hw: int, groups: int, dtype: torch.dtype,
                  occupancy: Optional[Callable[[int, int, int], int]] = None, sms: int = SMS,
                  k: Optional[int] = None) -> GnPlan:
    """K3's plan: `gn_plan`'s choice of K and blocks per sample, for K3's
    kernel (`occupancy` asks of it); a grid that cannot be resident raises
    a RuntimeError naming the shape."""
    _check_shape(batch, c, hw, groups, dtype, "fused_group_norm")
    occ = _occupancies(c, groups, dtype, occupancy, "fused_group_norm")
    return _plan(batch, c, hw, groups, dtype, occ, sms, k, False)


@functools.lru_cache(maxsize=None)
def _occupancy(device: int, x_bf16: bool, silu: bool, k: int, threads: int, smem: int) -> int:
    from prompt_diffusion_tpu_torch.ops._build import cuda_ext

    with torch.cuda.device(device):
        blocks = cuda_ext().gn_quant_occupancy(x_bf16, k, silu, threads, smem)
    if blocks < 1:
        raise RuntimeError(f"gn_quant occupancy query failed ({blocks}) for K={k}, "
                           f"{threads} threads")
    return blocks


@functools.lru_cache(maxsize=None)
def _float_occupancy(device: int, x_bf16: bool, act: int, k: int, threads: int,
                     smem: int) -> int:
    """K3's blocks per SM (0: none fits, which `gn_float_plan` refuses)."""
    from prompt_diffusion_tpu_torch.ops._build import cuda_ext

    with torch.cuda.device(device):
        blocks = cuda_ext().gn_float_occupancy(x_bf16, k, act, threads, smem)
    if blocks < 0:
        raise RuntimeError(f"gn_float occupancy query failed ({blocks}) for K={k}, "
                           f"{threads} threads")
    return blocks


def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_inputs(x, weight, bias, groups, name):
    """What both launchers refuse of their arguments, before any build."""
    if x.ndim != 4:
        raise ValueError(f"{name} takes (B, C, H, W), got {tuple(x.shape)}")
    if not x.dtype.is_floating_point:
        raise ValueError(f"{name} takes a float tensor, got {x.dtype}")
    b, c, h, w = x.shape
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"affine must be ({c},), got {tuple(weight.shape)}, "
                         f"{tuple(bias.shape)}")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError(f"affine on {weight.device}, {bias.device}, x on {x.device}")
    _check_shape(b, c, h * w, groups, x.dtype, name)


def _affine(weight, bias):
    """fp32 gamma and beta, 16-byte aligned (the kernels stage them by
    16-byte cp.async)."""
    gamma, beta = weight.float().contiguous(), bias.float().contiguous()
    if gamma.data_ptr() % VEC_BYTES or beta.data_ptr() % VEC_BYTES:
        raise ValueError("the affine must be 16-byte aligned")
    return gamma, beta


def _check_plan(plan: Optional[GnPlan], shape, quant: bool):
    """A given plan must be for this (B, C, HW, G) and this kernel."""
    if plan is not None and ((plan.batch, plan.c, plan.hw, plan.groups) != shape
                             or plan.quant != quant):
        raise ValueError(f"the plan covers {(plan.batch, plan.c, plan.hw, plan.groups)} for "
                         f"{'K5' if plan.quant else 'K3'}, not {shape} for "
                         f"{'K5' if quant else 'K3'}")


def gn_quant(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
             eps: float, silu: bool, plan: Optional[GnPlan] = None):
    """K5 on the card: x (B, C, H, W) bf16 or fp32 (read in channels_last
    memory; a copy only if x is not), weight and bias (C,) -> (int8 codes
    (B, C, H, W) in channels_last memory, fp32 scale per sample (B,)); one
    launch. `plan` overrides `gn_plan`'s."""
    _check_inputs(x, weight, bias, groups, "fused_group_norm_quant")
    b, c, h, w = x.shape
    _check_plan(plan, (b, c, h * w, groups), True)
    from prompt_diffusion_tpu_torch.ops._build import cuda_ext

    ext = cuda_ext()
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    bf16 = x.dtype == torch.bfloat16
    if plan is None:
        plan = gn_plan(b, c, h * w, groups, x.dtype, sms=_sms(dev),
                       occupancy=lambda k, t, m: _occupancy(dev, bf16, bool(silu), k, t, m))
    x = x.contiguous(memory_format=torch.channels_last)
    if x.data_ptr() % VEC_BYTES:
        raise ValueError("x must be 16-byte aligned")
    gamma, beta = _affine(weight, bias)
    codes = torch.empty_like(x, dtype=torch.int8, memory_format=torch.channels_last)
    scales = torch.empty((b,), dtype=torch.float32, device=x.device)
    ws = torch.empty((plan.workspace,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        ext.gn_quant(x.data_ptr(), bf16, gamma.data_ptr(), beta.data_ptr(), codes.data_ptr(),
                     scales.data_ptr(), ws.data_ptr(), b, h * w, c, groups, float(eps),
                     bool(silu), plan.k, plan.rows, plan.threads, plan.chunks, plan.bps,
                     torch.cuda.current_stream().cuda_stream)
    return codes, scales


def gn_float(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
             eps: float, act: int, plan: Optional[GnPlan] = None) -> torch.Tensor:
    """K3 on the card: x (B, C, H, W) bf16 or fp32 (read in channels_last
    memory; a copy only if x is not), weight and bias (C,) -> GroupNorm of
    x, then SiLU (ACT_SILU), ReLU (ACT_RELU) or nothing (ACT_NONE), in x's
    dtype and channels_last memory; one launch. `plan` overrides
    `gn_float_plan`'s."""
    _check_inputs(x, weight, bias, groups, "fused_group_norm")
    if act not in (ACT_NONE, ACT_SILU, ACT_RELU):
        raise ValueError(f"act must be ACT_NONE, ACT_SILU or ACT_RELU, got {act}")
    b, c, h, w = x.shape
    _check_plan(plan, (b, c, h * w, groups), False)
    from prompt_diffusion_tpu_torch.ops._build import cuda_ext

    ext = cuda_ext()
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    bf16 = x.dtype == torch.bfloat16
    if plan is None:
        plan = gn_float_plan(b, c, h * w, groups, x.dtype, sms=_sms(dev),
                             occupancy=lambda k, t, m: _float_occupancy(dev, bf16, act, k, t, m))
    x = x.contiguous(memory_format=torch.channels_last)
    if x.data_ptr() % VEC_BYTES:
        raise ValueError("x must be 16-byte aligned")
    gamma, beta = _affine(weight, bias)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    ws = torch.empty((plan.workspace,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        ext.gn_float(x.data_ptr(), bf16, gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
                     ws.data_ptr(), b, h * w, c, groups, float(eps), act, plan.k, plan.rows,
                     plan.threads, plan.chunks, plan.bps,
                     torch.cuda.current_stream().cuda_stream)
    return y
