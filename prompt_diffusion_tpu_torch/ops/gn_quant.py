"""The launch plan and launcher of K5 (GroupNorm(+SiLU) -> int8), the CUDA
C++ kernel of `csrc/gn_quant.cu`.

`fused_group_norm.fused_group_norm_quant` sends a CUDA tensor here. The
kernel is one cooperative launch of a persistent grid (its design is
described in the source); `gn_plan` decides how the grid covers the
activation:
  * a block is CV x R threads rounded up to whole warps: CV = C / 8 (bf16)
    or C / 4 (fp32) 16-byte vectors of a pixel, R = max(1, 256 // CV) pixel
    rows in flight (C = 320 in bf16: 40 x 6 = 240 threads, 256 launched);
    thread (r, v) reads vector v of pixels r, r + R, ... of each chunk of
    R x K pixels;
  * K, the vectors a thread loads at once, is the largest of 8, 4, 2 and 1
    whose chunks still give half the SMs a block (the 8² latents take K =
    4: 128 blocks; the sweep of `tools/quant_tune.py --part time` on the
    H100: ~one full block per SM beat one chunk per resident block at the
    8² and 16² sites, by a third at (8, 1280, 8, 8));
  * each sample's chunks are split into `bps` contiguous ranges, one per
    block, bps = the blocks the card holds at once over the samples (the
    occupancy query, with the kernel's shared reduction buffers,
    `static_smem`), at most one block per chunk.
The workspace is `grid` x (3 G + 1) fp32: each block's group partials
(count, mean, M2), then its amax; every slot is written before it is read,
so it needs no memset.

Every refusal is a `ValueError` raised before the extension is built or a
launch is queued; a CUDA tensor never falls back to the plain version.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import torch

VEC_BYTES = 16
MAX_THREADS = 512  # the kernel's __launch_bounds__
ROW_THREADS = 256  # pixel rows in flight: R = max(1, ROW_THREADS // CV)
KS = (8, 4, 2, 1)  # vectors a thread loads per chunk (the kernel's template K)
SMS = 132  # the H100 SXM's SMs (the launcher reads the card's)
SMEM_BLOCK = 232448  # bytes of shared memory a Hopper block may have
WARP = 32
DTYPES = (torch.bfloat16, torch.float32)
# blocks per SM the CPU tests assume where no card answers the occupancy
# query (the launcher asks the card)
ASSUMED_OCCUPANCY = 2


def static_smem(c: int, rows: int, groups: int, threads: int) -> int:
    """Bytes of the kernel's reduction buffers (`static_floats` in
    `csrc/gn_quant.cu`): red, the larger of 2 R C and R C + 3 max(threads,
    G); cmin, cmax, gamma and beta C each, R row counts, 2 G group terms, a
    float per warp."""
    red = max(2 * rows * c, rows * c + 3 * max(threads, groups))
    return 4 * (red + 4 * c + rows + 2 * groups + WARP)


@dataclasses.dataclass(frozen=True)
class GnPlan:
    """How `csrc/gn_quant.cu` covers a (batch, hw, c) activation: blocks of
    `threads` >= cv x rows threads (whole warps), chunks of rows x k
    pixels, `chunks` per sample, `bps` blocks per sample each holding a
    contiguous range of them, `blocks_per_sm` resident per SM."""

    batch: int
    hw: int
    c: int
    groups: int
    vec_elems: int
    cv: int
    rows: int
    threads: int
    k: int
    chunks: int
    bps: int
    blocks_per_sm: int

    @property
    def grid(self) -> int:
        return self.batch * self.bps

    @property
    def workspace(self) -> int:
        """fp32 slots of the workspace: group partials, then block amaxes."""
        return self.grid * (3 * self.groups + 1)

    def block_chunks(self, j: int) -> Tuple[int, int]:
        """Chunks [first, last) of its sample that block j of the sample
        holds (the kernel's ch0, ch1)."""
        return j * self.chunks // self.bps, (j + 1) * self.chunks // self.bps

    def pixels(self, chunk: int, r: int):
        """Pixels of the sample that row r's threads read in `chunk`."""
        first = chunk * self.rows * self.k + r
        return [p for p in range(first, first + self.k * self.rows, self.rows) if p < self.hw]


def _check_shape(batch: int, c: int, hw: int, groups: int, dtype: torch.dtype) -> int:
    """Vectors per pixel; raises ValueError on what the kernel does not take."""
    if dtype not in DTYPES:
        raise ValueError(f"fused_group_norm_quant takes bf16 or fp32 activations, got {dtype}")
    if batch < 1 or c < 1 or hw < 1:
        raise ValueError(f"empty activation (B, C, HW) = ({batch}, {c}, {hw})")
    if groups < 1 or c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    if c % 8:
        raise ValueError(f"channels {c} must be a multiple of 8 (16-byte vectors)")
    cv = c * dtype.itemsize // VEC_BYTES
    if cv > MAX_THREADS:
        raise ValueError(f"{c} channels of {dtype} exceed the plan's {MAX_THREADS} vectors "
                         f"per pixel")
    rows = max(1, ROW_THREADS // cv)
    if static_smem(c, rows, groups, _threads(cv)) > SMEM_BLOCK:
        raise ValueError(f"the workspace of {c} channels, {groups} groups exceeds the shared "
                         f"memory the plan allows")
    return cv


def _threads(cv: int) -> int:
    """Threads of a block: cv x R, rounded up to whole warps."""
    return -(-cv * max(1, ROW_THREADS // cv) // WARP) * WARP


@functools.lru_cache(maxsize=None)
def _plan(batch, c, hw, groups, dtype, occupancy: Tuple[int, ...], sms, k) -> GnPlan:
    cv = _check_shape(batch, c, hw, groups, dtype)
    rows = max(1, ROW_THREADS // cv)
    threads = _threads(cv)
    occ = dict(zip(KS, occupancy))
    if k is not None and k not in KS:
        raise ValueError(f"vectors per thread must be one of {KS}, got {k}")
    for kk in ((k,) if k is not None else KS):
        if occ[kk] < 1:
            raise ValueError(f"no block of {threads} threads fits an SM (occupancy {occ[kk]})")
        capacity = occ[kk] * sms
        chunks = -(-hw // (rows * kk))
        if 2 * batch * chunks >= sms or kk == KS[-1] or k is not None:
            break
    if batch > capacity:
        raise ValueError(f"batch {batch} exceeds the {capacity} blocks the card holds at once")
    return GnPlan(batch=batch, hw=hw, c=c, groups=groups, vec_elems=VEC_BYTES // dtype.itemsize,
                  cv=cv, rows=rows, threads=threads, k=kk, chunks=chunks,
                  bps=max(1, min(chunks, capacity // batch)), blocks_per_sm=occ[kk])


def gn_plan(batch: int, c: int, hw: int, groups: int, dtype: torch.dtype,
            occupancy: Optional[Callable[[int, int, int], int]] = None, sms: int = SMS,
            k: Optional[int] = None) -> GnPlan:
    """The plan for `batch` samples of `hw` pixels of `c` channels in
    `groups` groups. `occupancy(k, threads, smem)` gives the blocks per SM
    of the kernel with K = k at `threads` threads and `smem` bytes of
    shared memory (the launcher asks the card; ASSUMED_OCCUPANCY without
    one); `k` forces K (`tools/quant_tune.py` sweeps it)."""
    cv = _check_shape(batch, c, hw, groups, dtype)
    threads = _threads(cv)
    smem = static_smem(c, max(1, ROW_THREADS // cv), groups, threads)
    occ = tuple((occupancy(kk, threads, smem) if occupancy else ASSUMED_OCCUPANCY)
                for kk in KS)
    return _plan(batch, c, hw, groups, dtype, occ, sms, k)


@functools.lru_cache(maxsize=None)
def _occupancy(device: int, x_bf16: bool, silu: bool, k: int, threads: int, smem: int) -> int:
    from prompt_diffusion_tpu_torch.ops._build import cuda_ext

    with torch.cuda.device(device):
        blocks = cuda_ext().gn_quant_occupancy(x_bf16, k, silu, threads, smem)
    if blocks < 1:
        raise RuntimeError(f"gn_quant occupancy query failed ({blocks}) for K={k}, "
                           f"{threads} threads")
    return blocks


def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def gn_quant(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
             eps: float, silu: bool, plan: Optional[GnPlan] = None):
    """K5 on the card: x (B, C, H, W) bf16 or fp32 (read in channels_last
    memory; a copy only if x is not), weight and bias (C,) -> (int8 codes
    (B, C, H, W) in channels_last memory, fp32 scale per sample (B,)); one
    launch. `plan` overrides `gn_plan`'s."""
    if x.ndim != 4:
        raise ValueError(f"fused_group_norm_quant takes (B, C, H, W), got {tuple(x.shape)}")
    if not x.dtype.is_floating_point:
        raise ValueError(f"fused_group_norm_quant takes a float tensor, got {x.dtype}")
    b, c, h, w = x.shape
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"affine must be ({c},), got {tuple(weight.shape)}, "
                         f"{tuple(bias.shape)}")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError(f"affine on {weight.device}, {bias.device}, x on {x.device}")
    _check_shape(b, c, h * w, groups, x.dtype)
    from prompt_diffusion_tpu_torch.ops._build import cuda_ext

    ext = cuda_ext()
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    bf16 = x.dtype == torch.bfloat16
    if plan is None:
        plan = gn_plan(b, c, h * w, groups, x.dtype, sms=_sms(dev),
                       occupancy=lambda k, t, m: _occupancy(dev, bf16, bool(silu), k, t, m))
    if (plan.batch, plan.c, plan.hw, plan.groups) != (b, c, h * w, groups):
        raise ValueError(f"the plan covers {(plan.batch, plan.c, plan.hw, plan.groups)}, not "
                         f"{(b, c, h * w, groups)}")
    x = x.contiguous(memory_format=torch.channels_last)
    if x.data_ptr() % VEC_BYTES:
        raise ValueError("x must be 16-byte aligned")
    gamma, beta = weight.float().contiguous(), bias.float().contiguous()
    codes = torch.empty_like(x, dtype=torch.int8, memory_format=torch.channels_last)
    scales = torch.empty((b,), dtype=torch.float32, device=x.device)
    ws = torch.empty((plan.workspace,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        ext.gn_quant(x.data_ptr(), bf16, gamma.data_ptr(), beta.data_ptr(), codes.data_ptr(),
                     scales.data_ptr(), ws.data_ptr(), b, h * w, c, groups, float(eps),
                     bool(silu), plan.k, plan.rows, plan.threads, plan.chunks, plan.bps,
                     torch.cuda.current_stream().cuda_stream)
    return codes, scales
