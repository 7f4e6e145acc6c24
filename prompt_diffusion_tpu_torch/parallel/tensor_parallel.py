"""Megatron tensor parallelism for the SD3 MMDiT's JointBlocks, over
torch.distributed.

Counterpart of `prompt_diffusion_tpu/parallel/tensor_parallel.py`, whose
rule table `TP_RULES` copies (`_TP_KERNEL_RULES`; a test holds the copy):
the attention projections and the feed-forwards' expansions are
column-sharded (each rank keeps its slice of the output features: its
heads, its hidden units), the return projections and the contractions
row-sharded (its slice of the input features), and a row-sharded layer's
partial products are all-reduced over the tensor group before its bias is
added. `JointBlock.heads` becomes H / tp, so the attention runs on each
rank's heads (K2 under bf16 at the MMDiT's lengths, K9 under int8).
Everything else (the AdaLN projections, embedders, norms, taps, the head)
stays replicated.

Under the int8 policy the same rules give the unsharded layers' bits:
  * a column-sharded `QuantDense` keeps its slice of the fp32 weight and
    quantizes it (the scale is per output channel, so the codes are the
    whole weight's rows);
  * a row-sharded one (`RowParallelQuantDense`) quantizes the whole weight
    first, so each output channel's scale spans every input feature, and
    keeps its slice of the codes; its int8 GEMM's int32 accumulator is
    all-reduced (SUM, exact) before the dequantization and the bias, once;
  * its input, K11's codes of the attention output (`to_out`,
    `to_add_out`) or K10's of the feed-forward's hidden units (`ff_out`,
    `ff_context_out`), takes one scale over the whole row, of which the
    rank holds a slice: `JointBlock.tp_group` hands the group to K10 and
    K11, which run split (`ops/fused_act.py::split_act_quant`: the row amax
    all-reduced with MAX between two launches);
  * K13, K9 and K9's prologue need nothing: K13 runs on replicated rows,
    K9's Q scale is per (row, head) and its K scale per (sample, head), and
    a rank's heads are whole.
One JointBlock exchanges 4 int32 accumulators and 4 row amax vectors (2 and
2 in the last, context_pre_only, block).

    mesh = make_tp_mesh(num_tensor=4)        # under torchrun, 4 ranks
    apply_tp(pipe.transformer, mesh); apply_tp(pipe.controlnet, mesh)

Differences from the JAX package, by design:
  * heads that the tensor width does not divide are refused; JAX leaves
    such a kernel replicated without a word;
  * it serves the forward: the all-reduce after a row-sharded layer is a
    plain collective, not an autograd function, so the sharded module is
    for inference (JAX's tests hold its forward only).
A tensor width of 1 leaves the module as it is.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from prompt_diffusion_tpu_torch.ops.int8_conv import int8_matmul
from prompt_diffusion_tpu_torch.ops.quant import QuantDense, _dequant

TP_AXIS = "tensor"

# layer name -> "col" (output features sharded) or "row" (input features
# sharded, partial sums all-reduced, bias after), as `_TP_KERNEL_RULES`
TP_RULES = {
    "to_q": "col",
    "to_k": "col",
    "to_v": "col",
    "add_q_proj": "col",
    "add_k_proj": "col",
    "add_v_proj": "col",
    "to_out": "row",
    "to_add_out": "row",
    "ff_in": "col",
    "ff_out": "row",
    "ff_context_in": "col",
    "ff_context_out": "row",
}


def make_tp_mesh(num_data: int = 1, num_tensor: Optional[int] = None, device: str = "cuda"):
    """The ('data', 'tensor') mesh over every rank (the process group
    joined as `parallel.mesh.make_mesh` joins it); the tensor width
    defaults to the rest of the world."""
    from torch.distributed.device_mesh import init_device_mesh

    from prompt_diffusion_tpu_torch.parallel.mesh import init_distributed

    dev = init_distributed(device)
    world = dist.get_world_size()
    num_tensor = world // num_data if num_tensor is None else num_tensor
    if num_data * num_tensor != world:
        raise ValueError(f"a {num_data}x{num_tensor} mesh needs {num_data * num_tensor} "
                         f"ranks, the world has {world}")
    return init_device_mesh(dev.type, (num_data, num_tensor), mesh_dim_names=("data", TP_AXIS))


class RowParallelDense(nn.Module):
    """The rank's columns of a Dense weight (out, in / tp): its partial
    product, all-reduced over the tensor group, then the whole bias."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor], group):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)
        self.group = group

    def forward(self, x):
        y = F.linear(x.to(self.weight.dtype), self.weight)
        dist.all_reduce(y, group=self.group)
        return y if self.bias is None else y + self.bias


class RowParallelQuantDense(nn.Module):
    """The rank's columns of an int8 `QuantDense`'s codes (out, in / tp),
    quantized from the whole fp32 weight (the scale of each output channel
    spans every input feature): the int8 GEMM of its slice of the input
    pair, the int32 accumulator all-reduced over the tensor group, then
    the unsharded layer's dequantization and bias."""

    def __init__(self, layer: QuantDense, rank: int, tp: int, group):
        super().__init__()
        wq, s_w = layer.quantized()
        n = wq.shape[1] // tp
        self.register_buffer("wq", wq[:, rank * n:(rank + 1) * n].contiguous())
        self.register_buffer("s_w", s_w.clone())
        self.bias = None if layer.bias is None else nn.Parameter(
            layer.bias.detach().clone(), requires_grad=False)
        self.out_dtype, self.group = layer.out_dtype, group

    def forward(self, x):
        """`x`: the (int8 (..., in / tp), fp32 per-row (..., 1)) pair of the
        rank's columns, the scale over whole rows (K10 / K11 split)."""
        xq, s_a = x
        acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), self.wq).contiguous()
        dist.all_reduce(acc, group=self.group)
        return _dequant(acc.view(*xq.shape[:-1], -1), s_a * self.s_w, self.bias,
                        self.out_dtype)


def _slice_col(layer: nn.Linear, rank: int, tp: int) -> None:
    n = layer.weight.shape[0] // tp
    with torch.no_grad():
        layer.weight = nn.Parameter(layer.weight[rank * n:(rank + 1) * n].clone(),
                                    requires_grad=layer.weight.requires_grad)
        if layer.bias is not None:
            layer.bias = nn.Parameter(layer.bias[rank * n:(rank + 1) * n].clone(),
                                      requires_grad=layer.bias.requires_grad)
    layer.out_features = n


def _row(layer: nn.Linear, rank: int, tp: int, group) -> nn.Module:
    if isinstance(layer, QuantDense):
        return RowParallelQuantDense(layer, rank, tp, group)
    n = layer.weight.shape[1] // tp
    w = layer.weight.detach()[:, rank * n:(rank + 1) * n].clone()
    b = None if layer.bias is None else layer.bias.detach().clone()
    return RowParallelDense(w, b, group)


def apply_tp(module: nn.Module, mesh) -> nn.Module:
    """Rewrites every JointBlock of `module` (an `SD3Transformer` or
    `SD3ControlNet`, bf16, fp32 or int8) in place for the mesh's tensor
    axis, by `TP_RULES`; returns `module`. Refuses heads the width does not
    divide."""
    from prompt_diffusion_tpu_torch.models.mmdit_sd3 import JointBlock

    tp = mesh.size(mesh.mesh_dim_names.index(TP_AXIS))
    blocks = [m for m in module.modules() if isinstance(m, JointBlock)]
    for blk in blocks:
        if blk.heads % tp:
            raise ValueError(f"{blk.heads} heads do not divide over a tensor width of {tp}")
    if tp == 1:
        return module
    rank, group = mesh.get_local_rank(TP_AXIS), mesh.get_group(TP_AXIS)
    for blk in blocks:
        for name, kind in TP_RULES.items():
            layer = getattr(blk, name, None)
            if layer is None:  # the last block is context_pre_only
                continue
            if kind == "col":
                _slice_col(layer, rank, tp)
            else:
                setattr(blk, name, _row(layer, rank, tp, group))
        blk.heads //= tp
        blk.tp_group = group
    return module
