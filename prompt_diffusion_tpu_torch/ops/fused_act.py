"""GEGLU -> int8 kernel K7, in Triton, and its plain version.

Replaces `prompt_diffusion_tpu/ops/fused_act.py::fused_geglu_quant`
(`_geglu_quant_kernel` through `_run`): the feed-forward of every SD1.5
transformer block in the int8 serving mode, h * gelu_erf(gate) of the
(..., 2I) projection, then int8 codes (..., I) with one fp32 scale per row,
which the FF `out` QuantDense takes as a pair.

What bounds it: memory traffic (one read of the bf16 projection, one int8
write at half its width). One program holds whole rows in registers
(I = 1280..5120 on the SD1.5 path), so the GELU, the row's amax and the
codes take a single read; the row tail is masked. The GELU uses the exact
erf, as the reference does (the TPU kernel carried an A&S approximation of
erf only because Mosaic could not lower it).

K10 (`fused_gelu_quant`) and K11 (`fused_quant_rows`) of the same JAX file
belong to SD3 and are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from prompt_diffusion_tpu_torch.ops.dispatch import use_kernel
from prompt_diffusion_tpu_torch.ops.fused_layer_norm import _TILE, rowquant


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
