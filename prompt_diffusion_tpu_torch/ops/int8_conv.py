"""int8 3x3 convolution kernel K8 in its two variants, their plain
versions, their tile and split-K plan, and the int8 GEMM helper of the W8A8
serving mode.

Replaces `prompt_diffusion_tpu/ops/int8_conv.py::conv3x3_int8`: a SAME 3x3
stride-1 int8 convolution with int32 accumulation and the dequant epilogue
fma(acc, s_a[b] * s_w[oc], bias), in the JAX package's two variants:
  * "im2col" (`_conv_kernel`, the default): here an implicit GEMM whose
    ring stages are 128-byte slices of the im2col rows, gathered from
    device memory inside the kernel (no im2col is materialised, unlike the
    TPU path);
  * "xshift" (`_conv_kernel_xshift`): each ring stage holds a 32-channel
    slice of the raw halo'd input rows and of all nine taps' weights, and
    the nine taps run as shifted products (`conv3x3_int8_xshift`).
Both kernels are CUDA C++ (`csrc/int8_conv.cu`, whose header says what
bounds each and how it is laid out); each equals its plain version, and
the two variants each other, bit for bit. `conv_plan` picks the tile
height and the split-K of a call; the wrapper passes its plan down. The JAX package picks the variant from an environment variable at
import; the port takes it as an argument (`QuantConv.conv_variant`,
`PromptDiffusionSD15.create`).

Layouts: activations NHWC (an NCHW channels_last tensor permuted, a free
view), weights (Cout, 3, 3, Cin), the order of a channels_last OIHW conv
weight and the column-major B operand of the GEMM.

`int8_matmul` is the int8 x int8 -> int32 product of `QuantDense`, the
1x1 and stride-2 `QuantConv` and this plain version. The JAX package
leaves it to XLA; here it is `torch._int_mm` (a hand-written GEMM with the
epilogue fused is queued as G1 in ROADMAP.md).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from prompt_diffusion_tpu_torch.ops.dispatch import use_kernel


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 @ w (N, K) int8, transposed -> (M, N) int32, exact.

    `torch._int_mm` on CUDA needs M > 16 and K, N multiples of 8, and takes
    the weight as the transpose of a row-major (N, K) matrix; zero rows and
    columns pad the operands up to that (zeros add nothing to an integer
    sum) and are cut off the result."""
    m, k = a.shape
    n = w.shape[0]
    pad_k, pad_n, pad_m = (-k) % 8, (-n) % 8, max(0, 17 - m)
    if pad_k or pad_m:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        w = F.pad(w, (0, pad_k, 0, pad_n))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    return out[:m, :n] if (pad_m or pad_n) else out


def im2col3x3(xq: torch.Tensor, stride: int) -> torch.Tensor:
    """(B, H, W, C) int8 -> (B * Ho * Wo, 9 * C) int8 rows of a 3x3 conv
    with padding 1, columns in (dy, dx, c) order, from nine shifted views
    (`F.unfold` has no int8 kernel)."""
    b, h, w, c = xq.shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
    cols = [xp[:, dy:dy + stride * (ho - 1) + 1:stride, dx:dx + stride * (wo - 1) + 1:stride]
            for dy in range(3) for dx in range(3)]
    return torch.cat(cols, dim=-1).reshape(b * ho * wo, 9 * c)


def _epilogue(acc, s_a, s_w, bias, out_dtype):
    """(B, H, W, Cout) int32 -> out_dtype: the fp32 epilogue with s_a * s_w
    formed first (`quant.py`'s dequant order) and f32(acc) * scale + bias
    rounded once, as one fused multiply-add: the JAX package's kernel and
    XLA path contract it so on the CPU. The fp32 product is exact in fp64,
    so the fp64 sum rounded to fp32 is that FMA unless the fp64 sum falls
    exactly on an fp32 rounding tie (a chance of about 2^-29 per
    element)."""
    scale = s_a.view(-1, 1, 1, 1) * s_w.view(1, 1, 1, -1)
    if bias is None:
        out = acc.float() * scale
    else:
        out = (acc.float().double() * scale.double() + bias.double()).float()
    return out.to(out_dtype)


def _torch_conv3x3_int8(xq, s_a, wq, s_w, bias, out_dtype):
    """Plain K8, im2col: int8 im2col, one int8 GEMM, the epilogue."""
    b, h, w, cin = xq.shape
    cout = wq.shape[0]
    acc = int8_matmul(im2col3x3(xq, 1), wq.reshape(cout, 9 * cin)).view(b, h, w, cout)
    return _epilogue(acc, s_a, s_w, bias, out_dtype)


def _torch_conv3x3_int8_xshift(xq, s_a, wq, s_w, bias, out_dtype):
    """Plain K8, xshift (`_conv_kernel_xshift`'s data flow): the raw rows
    padded by one pixel; per tap an int8 GEMM over the whole padded rows,
    whose x-shifted slice is added to the int32 sum; the epilogue."""
    b, h, w, cin = xq.shape
    cout = wq.shape[0]
    xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((b, h, w, cout), dtype=torch.int32, device=xq.device)
    for dy in range(3):
        rows = xp[:, dy:dy + h].reshape(-1, cin)
        for dx in range(3):
            tap = int8_matmul(rows, wq[:, dy, dx].contiguous()).view(b, h, w + 2, cout)
            acc += tap[:, :, dx:dx + w]
    return _epilogue(acc, s_a, s_w, bias, out_dtype)


VARIANTS = ("im2col", "xshift")

# The kernels' tiles and ring stage (csrc/int8_conv.cu): 128 output pixels
# (or 256, xshift only) by 128 output channels; a stage is 128 bytes of the
# im2col K (tap * Cin + channel) or, for xshift, 32 channels of all nine
# taps.
BLOCK_MS, BLOCK_N = (128, 256), 128
STAGE_K = {"im2col": 128, "xshift": 32}
XS_WIDE = 128  # xshift tiles rows wider than this in x, 128 pixels a tile
SMS = 132  # the H100's streaming multiprocessors
MAX_SPLITS, MIN_STAGES_PER_SPLIT = 8, 4


def blocks_per_sm(variant: str, block_m: int) -> int:
    """Blocks of a kernel an SM holds: two im2col blocks (98 KB of shared
    memory each), one xshift block (140-205 KB)."""
    return 2 if variant == "im2col" and block_m == 128 else 1


@dataclass(frozen=True)
class ConvPlan:
    """How one K8 call is cut: `m_tiles` x `n_tiles` output tiles of
    `block_m` pixels by BLOCK_N channels, the K loop's `stages` ring stages
    in `splits` splits (grid z) of `per_split` stages each (the last may
    hold fewer). splits > 1 sums int32 partials in a (splits, M, Cout)
    workspace."""

    variant: str
    cin: int
    block_m: int
    m_tiles: int
    n_tiles: int
    stages: int
    per_split: int
    splits: int

    def k_ranges(self) -> List[List[Tuple[int, int]]]:
        """For each split, the [start, end) ranges of the im2col K index
        (tap * Cin + channel) that its partial sums: one range for im2col,
        one per tap for xshift (a split covers whole channel slices of every
        tap)."""
        k_total = 9 * self.cin
        out = []
        for z in range(self.splits):
            lo, hi = z * self.per_split, min((z + 1) * self.per_split, self.stages)
            if self.variant == "im2col":
                out.append([(lo * STAGE_K["im2col"], min(hi * STAGE_K["im2col"], k_total))])
            else:
                c_lo, c_hi = lo * STAGE_K["xshift"], min(hi * STAGE_K["xshift"], self.cin)
                out.append([(t * self.cin + c_lo, t * self.cin + c_hi) for t in range(9)])
        return out


def conv_plan(b: int, h: int, w: int, cin: int, cout: int, variant: str = "im2col",
              splits: Optional[int] = None) -> ConvPlan:
    """The tiles and split-K of K8 at (B, H, W, Cin -> Cout).

    xshift takes tiles of 256 pixels where they still fill every SM (the
    64x64 and 32x32 latents at CFG batch 8; not the 512-wide rows, nor Cin
    % 16 != 0), which halves the weight bytes each product reads; else 128.
    im2col always takes 128: at 256 it holds one block per SM instead of
    two, and was slower when tried. The K loop is split only where the output tiles fill at most
    half of the blocks the card holds at once (SMS x `blocks_per_sm`): then
    as many splits as fill one such wave, at most MAX_SPLITS and at least
    MIN_STAGES_PER_SPLIT stages each (the 8x8 latents at every batch; 16x16
    at CFG batch 4 under im2col). `splits` forces a count (tuning, tests);
    either is cut to whole stages, so no split is empty. Cin % 16 != 0
    (the byte-gather path) is never split."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown conv3x3_int8 variant {variant!r}; one of {VARIANTS}")
    n_tiles = math.ceil(cout / BLOCK_N)
    wide = variant == "xshift" and w > XS_WIDE
    block_m = 256 if (variant == "xshift" and cin % 16 == 0 and not wide
                      and math.ceil(b * h * w / 256) * n_tiles >= SMS) else 128
    m_tiles = b * h * math.ceil(w / XS_WIDE) if wide else math.ceil(b * h * w / block_m)
    stages = math.ceil((9 * cin if variant == "im2col" else cin) / STAGE_K[variant])
    if splits is None:
        fill = SMS * blocks_per_sm(variant, block_m) // (m_tiles * n_tiles)
        splits = 1 if cin % 16 or fill < 2 else min(MAX_SPLITS, fill,
                                                   max(1, stages // MIN_STAGES_PER_SPLIT))
    if splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    per_split = math.ceil(stages / min(splits, stages))
    return ConvPlan(variant, cin, block_m, m_tiles, n_tiles, stages, per_split,
                    math.ceil(stages / per_split))


def conv3x3_int8(xq: torch.Tensor, s_a: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 out_dtype: torch.dtype = torch.bfloat16, variant: str = "im2col") -> torch.Tensor:
    """K8: SAME 3x3 stride-1 int8 convolution with the fused dequant epilogue.

    xq (B, H, W, Cin) int8, s_a (B,) fp32, wq (Cout, 3, 3, Cin) int8,
    s_w (Cout,) fp32, bias (Cout,) fp32 or None -> (B, H, W, Cout) in
    `out_dtype` (bf16 or fp32). `variant` "im2col" (the in-kernel gather)
    or "xshift" (`conv3x3_int8_xshift`); both give the same bits. The
    kernel on CUDA, the plain version on the CPU."""
    if variant == "xshift":
        return conv3x3_int8_xshift(xq, s_a, wq, s_w, bias, out_dtype)
    if variant != "im2col":
        raise ValueError(f"unknown conv3x3_int8 variant {variant!r}; one of {VARIANTS}")
    if not use_kernel(xq):
        return _torch_conv3x3_int8(xq, s_a, wq, s_w, bias, out_dtype)
    out = _launch(xq, s_a, wq, s_w, bias, out_dtype, xshift=False)
    conv3x3_int8.launches += 1
    return out


conv3x3_int8.launches = 0


def conv3x3_int8_xshift(xq: torch.Tensor, s_a: torch.Tensor, wq: torch.Tensor,
                        s_w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                        out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """K8's xshift variant: the same function and arguments as
    `conv3x3_int8`, computed from the raw halo'd rows staged once in shared
    memory, the nine taps as shifted products."""
    if not use_kernel(xq):
        return _torch_conv3x3_int8_xshift(xq, s_a, wq, s_w, bias, out_dtype)
    out = _launch(xq, s_a, wq, s_w, bias, out_dtype, xshift=True)
    conv3x3_int8_xshift.launches += 1
    return out


conv3x3_int8_xshift.launches = 0


def _check(xq, s_a, wq, s_w, bias, out_dtype):
    """Refuses what the kernels do not take (before any build or launch)."""
    if xq.ndim != 4 or wq.ndim != 4:
        raise ValueError(f"conv3x3_int8 takes (B,H,W,Cin) and (Cout,3,3,Cin), got "
                         f"{tuple(xq.shape)}, {tuple(wq.shape)}")
    b, h, w, cin = xq.shape
    cout = wq.shape[0]
    if tuple(wq.shape) != (cout, 3, 3, cin):
        raise ValueError(f"weight {tuple(wq.shape)} does not match Cin {cin}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"conv3x3_int8 takes int8 operands, got {xq.dtype}, {wq.dtype}")
    if wq.device != xq.device:
        raise ValueError(f"weight on {wq.device}, activation on {xq.device}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bf16 or fp32, got {out_dtype}")
    if min(b, h, w, cin, cout) < 1 or math.ceil(cout / BLOCK_N) > 65535 or 9 * cin > 2 ** 30:
        raise ValueError(f"({b},{h},{w},{cin}->{cout}) does not fit the kernel's grid "
                         f"(at most {65535 * BLOCK_N} output channels)")
    vectors = {"s_a": (s_a, b), "s_w": (s_w, cout)}
    if bias is not None:
        vectors["bias"] = (bias, cout)
    for name, (t, n) in vectors.items():
        if tuple(t.shape) != (n,) or t.dtype != torch.float32 or t.device != xq.device:
            raise ValueError(f"{name} must be fp32 ({n},) on {xq.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _launch(xq, s_a, wq, s_w, bias, out_dtype, xshift, splits=None):
    """Checks, plans (`conv_plan`; `splits` forces a count) and launches
    one variant; returns the (B, H, W, Cout) output."""
    _check(xq, s_a, wq, s_w, bias, out_dtype)
    b, h, w, cin = xq.shape
    cout = wq.shape[0]
    plan = conv_plan(b, h, w, cin, cout, "xshift" if xshift else "im2col", splits)
    if plan.m_tiles > 2 ** 31 - 1:
        raise ValueError(f"{plan.m_tiles} pixel tiles do not fit the kernel's grid")
    from prompt_diffusion_tpu_torch.ops._build import cuda_ext

    xq, wq = xq.contiguous(), wq.contiguous()
    s_a, s_w = s_a.contiguous(), s_w.contiguous()
    bias = bias.contiguous() if bias is not None else None
    vec = cin % 16 == 0  # 16-byte copies; a view that starts off 16 bytes is copied
    if vec and xq.data_ptr() % 16:
        xq = xq.clone()
    if vec and wq.data_ptr() % 16:
        wq = wq.clone()
    out = torch.empty((b, h, w, cout), dtype=out_dtype, device=xq.device)
    ws = (torch.empty((plan.splits, b * h * w, cout), dtype=torch.int32, device=xq.device)
          if plan.splits > 1 else None)
    with torch.cuda.device(xq.device):
        cuda_ext().conv3x3_int8(
            xq.data_ptr(), wq.data_ptr(), s_a.data_ptr(), s_w.data_ptr(),
            bias.data_ptr() if bias is not None else 0, out.data_ptr(),
            ws.data_ptr() if ws is not None else 0, b, h, w, cin, cout,
            out_dtype == torch.bfloat16, vec, plan.block_m, plan.splits, plan.per_split, xshift,
            torch.cuda.current_stream().cuda_stream)
    return out
