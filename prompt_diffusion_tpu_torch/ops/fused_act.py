"""Activation -> int8 kernels K7, K10 and K11 and their plain versions.

Replaces `prompt_diffusion_tpu/ops/fused_act.py::fused_geglu_quant`
(`_geglu_quant_kernel` through `_run`): the feed-forward of every SD1.5
transformer block in the int8 serving mode, h * gelu_erf(gate) of the
(..., 2I) projection, then int8 codes (..., I) with one fp32 scale per row,
which the FF `out` QuantDense takes as a pair. K7 is a Triton program.

What bounds it: memory traffic (one read of the bf16 projection, one int8
write at half its width). One program holds whole rows in registers
(I = 1280..5120 on the SD1.5 path), so the GELU, the row's amax and the
codes take a single read; the row tail is masked. The GELU uses the exact
erf, as the reference does (the TPU kernel carried an A&S approximation of
erf only because Mosaic could not lower it).

K10 replaces `fused_gelu_quant` (`_gelu_quant_kernel`): tanh-GELU, then
int8 codes with one scale per row, the input of the SD3 MMDiT's `ff_out`
and `ff_context_out` (the block's widest activation, (B, N, 4C)). It is
CUDA C++ (`csrc/row_quant.cu`, launched by `row_quant.gelu_quant`; its
design is described there). K11 replaces `fused_quant_rows`
(`_quant_rows_kernel`): per-row int8 of the attention outputs that feed
`to_out` and `to_add_out`, a Triton program that holds whole rows in
registers like K7 (C = 1536 on the SD3 path) and masks the row tail. Both
are bound by memory traffic (one read, one int8 write); the TPU kernels'
pad of the row count to 8 is a tiling rule with no counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from prompt_diffusion_tpu_torch.ops.dispatch import use_kernel
from prompt_diffusion_tpu_torch.ops.fused_layer_norm import _TILE, rowquant
from prompt_diffusion_tpu_torch.ops.row_quant import gelu_quant


def _torch_geglu_quant(proj: torch.Tensor):
    """Plain K7: fp32 h * gelu_erf(gate), then `rowquant`."""
    h, gate = proj.float().chunk(2, dim=-1)
    return rowquant(h * F.gelu(gate))


def fused_geglu_quant(proj: torch.Tensor):
    """K7: (..., 2I) GEGLU projection [h | gate] -> (int8 (..., I), fp32 row
    scales (..., 1)); the kernel on CUDA, the plain version on the CPU."""
    if not use_kernel(proj):
        return _torch_geglu_quant(proj)
    import triton

    from prompt_diffusion_tpu_torch.ops import _triton_quant as tq

    if proj.shape[-1] % 2 or not proj.dtype.is_floating_point:
        raise ValueError(f"fused_geglu_quant takes a float (..., 2I) tensor, got "
                         f"{proj.dtype} {tuple(proj.shape)}")
    inner = proj.shape[-1] // 2
    x2 = proj.contiguous().view(-1, 2 * inner)
    n = x2.shape[0]
    block_i = triton.next_power_of_2(inner)
    block_r = max(1, _TILE // block_i)
    q = torch.empty((n, inner), dtype=torch.int8, device=proj.device)
    s_a = torch.empty((n, 1), dtype=torch.float32, device=proj.device)
    with torch.cuda.device(proj.device):
        tq.geglu_quant_kernel[(triton.cdiv(n, block_r),)](
            x2, q, s_a, n, inner, BLOCK_R=block_r, BLOCK_I=block_i,
            num_warps=8 if block_i >= 4096 else 4)
    fused_geglu_quant.launches += 1
    lead = proj.shape[:-1]
    return q.view(*lead, inner), s_a.view(*lead, 1)


fused_geglu_quant.launches = 0


def _torch_act_quant(x: torch.Tensor, gelu: bool):
    """Plain K10 / K11 (`_jnp_fallback`): fp32, tanh-GELU or nothing, then
    `rowquant`."""
    h = x.float()
    if gelu:
        h = F.gelu(h, approximate="tanh")
    return rowquant(h)


def _quant_rows(x: torch.Tensor):
    """K11's Triton launch (`act_quant_kernel` with GELU=False)."""
    import triton

    from prompt_diffusion_tpu_torch.ops import _triton_quant as tq

    if not x.dtype.is_floating_point:
        raise ValueError(f"takes a float tensor, got {x.dtype}")
    c = x.shape[-1]
    x2 = x.contiguous().view(-1, c)
    n = x2.shape[0]
    block_c = triton.next_power_of_2(c)
    block_r = max(1, _TILE // block_c)
    q = torch.empty((n, c), dtype=torch.int8, device=x.device)
    s_a = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        tq.act_quant_kernel[(triton.cdiv(n, block_r),)](
            x2, q, s_a, n, c, BLOCK_R=block_r, BLOCK_C=block_c, GELU=False,
            num_warps=8 if block_c >= 4096 else 4)
    return q.view(x.shape), s_a.view(*x.shape[:-1], 1)


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
    """K11: (..., C) -> (int8 (..., C), fp32 row scales (..., 1)); the
    kernel on CUDA, the plain version on the CPU."""
    if not use_kernel(x):
        return _torch_act_quant(x, gelu=False)
    out = _quant_rows(x)
    fused_quant_rows.launches += 1
    return out


fused_quant_rows.launches = 0
