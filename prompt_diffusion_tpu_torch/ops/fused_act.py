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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from prompt_diffusion_tpu_torch.ops.dispatch import use_kernel
from prompt_diffusion_tpu_torch.ops.fused_layer_norm import rowquant
from prompt_diffusion_tpu_torch.ops.row_quant import geglu_quant, gelu_quant, quant_rows


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


def _torch_act_quant(x: torch.Tensor, gelu: bool):
    """Plain K10 / K11 (`_jnp_fallback`): fp32, tanh-GELU or nothing, then
    `rowquant`."""
    h = x.float()
    if gelu:
        h = F.gelu(h, approximate="tanh")
    return rowquant(h)


def fused_gelu_quant(x: torch.Tensor):
    """K10: (..., C) -> tanh-GELU -> (int8 (..., C), fp32 row scales
    (..., 1)); the CUDA kernel on the card (bf16 or fp32 rows, C a multiple
    of 8 up to `row_quant.MAX_ROW_BYTES`, one launch), the plain version on
    the CPU."""
    if not use_kernel(x):
        return _torch_act_quant(x, gelu=True)
    out = gelu_quant(x)
    fused_gelu_quant.launches += 1
    return out


fused_gelu_quant.launches = 0


def fused_quant_rows(x: torch.Tensor):
    """K11: (..., C) -> (int8 (..., C), fp32 row scales (..., 1)); the CUDA
    kernel on the card (bf16 or fp32 rows, C a multiple of 8 up to
    `row_quant.MAX_ROW_BYTES`, a (B, N, C) x read in place with its own
    strides, one launch), the plain version on the CPU."""
    if not use_kernel(x):
        return _torch_act_quant(x, gelu=False)
    out = quant_rows(x)
    fused_quant_rows.launches += 1
    return out


fused_quant_rows.launches = 0
