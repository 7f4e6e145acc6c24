"""Activation -> int8 kernels K7, K10 and K11 and their plain versions.

Replaces `prompt_diffusion_tpu/ops/fused_act.py::fused_geglu_quant`
(`_geglu_quant_kernel` through `_run`): the feed-forward of every SD1.5
transformer block in the int8 serving mode, h * gelu_erf(gate) of the
(..., 2I) projection, then int8 codes (..., I) with one fp32 scale per row,
which the FF `out` QuantDense takes as a pair. K7 is CUDA C++
(`csrc/row_quant.cu`, op GEGLU, launched by `row_quant.geglu_quant`; its
design is described there): rows in 16-byte vectors held in registers, no
power-of-two padding, the division once per row. The GELU uses the exact
erf (CUDA's erff), as the reference and PyTorch's `F.gelu` do (the TPU
kernel carried an A&S approximation of erf only because Mosaic could not
lower it). Its former Triton program (`_triton_quant.geglu_quant_kernel`)
stays only as the parent design that `tools/quant_tune.py --part time`
launches beside it; no wrapper routes to it.

K10 replaces `fused_gelu_quant` (`_gelu_quant_kernel`): tanh-GELU, then
int8 codes with one scale per row, the input of the SD3 MMDiT's `ff_out`
and `ff_context_out` (the block's widest activation, (B, N, 4C)). It is
CUDA C++ (`csrc/row_quant.cu`, launched by `row_quant.gelu_quant`). K11
replaces `fused_quant_rows` (`_quant_rows_kernel`): per-row int8 of the
attention outputs that feed `to_out` and `to_add_out`, CUDA C++ too
(`csrc/row_quant.cu`, op ROWS, launched by `row_quant.quant_rows`), which
reads the MMDiT's `attn[:, :n_h]` and `attn[:, n_h:]` in place, slices of
one packed (B, N_h + N_c, C) output, with their own sample stride: one
launch and no copy. Its former Triton program (`act_quant_kernel` with
GELU=False) stays only as the parent design that `tools/quant_tune.py
--part time` launches. All three are bound by memory traffic (one read,
one int8 write); the TPU kernels' pad of the row count to 8 is a tiling
rule with no counterpart here.

Under tensor parallelism (`parallel/tensor_parallel.py`) a rank holds a
slice of the columns of K10's and K11's rows, while the row's scale spans
them all. Given the tensor group, `fused_gelu_quant` and `fused_quant_rows`
run the split (`split_act_quant`): `act_amax` (one launch: each row's amax
over the rank's columns), an all-reduce of it with MAX over the group,
then `act_codes` (one launch: the codes of the rank's columns from that
amax), both CUDA C++ (`csrc/row_quant.cu`, `row_split_kernel`). Max is
exact in any order, so the codes and scales are the unsharded K10's and
K11's bit for bit.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from prompt_diffusion_tpu_torch.ops.dispatch import use_kernel
from prompt_diffusion_tpu_torch.ops.fused_layer_norm import rowquant, rowquant_amax
from prompt_diffusion_tpu_torch.ops.row_quant import (
    codes_from_amax,
    geglu_quant,
    gelu_quant,
    quant_rows,
    row_amax,
)


def _torch_geglu_quant(proj: torch.Tensor):
    """Plain K7: fp32 h * gelu_erf(gate), then `rowquant`."""
    h, gate = proj.float().chunk(2, dim=-1)
    return rowquant(h * F.gelu(gate))


def fused_geglu_quant(proj: torch.Tensor):
    """K7: (..., 2I) GEGLU projection [h | gate] -> (int8 (..., I), fp32 row
    scales (..., 1)); the CUDA kernel on the card (bf16 or fp32 rows, I a
    multiple of 8, 2I within `row_quant.MAX_ROW_BYTES`, one launch, no copy
    of proj), the plain version on the CPU."""
    if not use_kernel(proj):
        return _torch_geglu_quant(proj)
    out = geglu_quant(proj)
    fused_geglu_quant.launches += 1
    return out


fused_geglu_quant.launches = 0


def _torch_act(x: torch.Tensor, gelu: bool) -> torch.Tensor:
    """fp32, tanh-GELU or nothing: what K10 / K11 quantize."""
    h = x.float()
    return F.gelu(h, approximate="tanh") if gelu else h


def _torch_act_quant(x: torch.Tensor, gelu: bool):
    """Plain K10 / K11 (`_jnp_fallback`): fp32, tanh-GELU or nothing, then
    `rowquant`."""
    return rowquant(_torch_act(x, gelu))


def act_amax(x: torch.Tensor, gelu: bool) -> torch.Tensor:
    """Pass 1 of K10 (`gelu`) or K11 split over a tensor group: (..., C),
    the rank's columns of each row -> fp32 (..., 1), each row's max |y| over
    them (y = tanh-GELU(x) or x); the CUDA kernel on the card (K10's and
    K11's inputs, read in place, one launch), the plain version on the
    CPU."""
    if not use_kernel(x):
        return _torch_act(x, gelu).abs().amax(dim=-1, keepdim=True)
    out = row_amax(x, gelu)
    act_amax.launches += 1
    return out


act_amax.launches = 0


def act_codes(x: torch.Tensor, amax: torch.Tensor, gelu: bool):
    """Pass 2 of K10 (`gelu`) or K11 split over a tensor group: x as
    `act_amax` takes it and each row's amax over the whole row (fp32
    (..., 1)) -> (int8 (..., C), fp32 row scales (..., 1)), `rowquant`'s
    arithmetic with that amax; the CUDA kernel on the card (one launch),
    the plain version on the CPU."""
    if not use_kernel(x):
        return rowquant_amax(_torch_act(x, gelu), amax)
    out = codes_from_amax(x, amax, gelu)
    act_codes.launches += 1
    return out


act_codes.launches = 0


def split_act_quant(x: torch.Tensor, gelu: bool, group=None):
    """K10 (`gelu`) or K11 on the rank's slice of each row, the scale over
    the whole row: `act_amax`, its all-reduce with MAX over `group` (none
    where `group` is None: a group of one rank), `act_codes`."""
    amax = act_amax(x, gelu)
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    return act_codes(x, amax, gelu)


def fused_gelu_quant(x: torch.Tensor, group=None):
    """K10: (..., C) -> tanh-GELU -> (int8 (..., C), fp32 row scales
    (..., 1)); the CUDA kernel on the card (bf16 or fp32 rows, C a multiple
    of 8 up to `row_quant.MAX_ROW_BYTES`, one launch), the plain version on
    the CPU. Given the tensor `group` whose ranks hold the rest of each
    row: `split_act_quant`."""
    if group is not None:
        return split_act_quant(x, True, group)
    if not use_kernel(x):
        return _torch_act_quant(x, gelu=True)
    out = gelu_quant(x)
    fused_gelu_quant.launches += 1
    return out


fused_gelu_quant.launches = 0


def fused_quant_rows(x: torch.Tensor, group=None):
    """K11: (..., C) -> (int8 (..., C), fp32 row scales (..., 1)); the CUDA
    kernel on the card (bf16 or fp32 rows, C a multiple of 8 up to
    `row_quant.MAX_ROW_BYTES`, a (B, N, C) x read in place with its own
    strides, one launch), the plain version on the CPU. Given the tensor
    `group` whose ranks hold the rest of each row: `split_act_quant`."""
    if group is not None:
        return split_act_quant(x, False, group)
    if not use_kernel(x):
        return _torch_act_quant(x, gelu=False)
    out = quant_rows(x)
    fused_quant_rows.launches += 1
    return out


fused_quant_rows.launches = 0
