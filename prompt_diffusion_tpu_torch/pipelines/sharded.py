"""`generate` with the requests sharded over the ranks of a mesh.

Counterpart of the JAX package's sharded generate (GSPMD over the batch
axis, `tests/test_multidevice.py::test_sd15_generate_sharded_equivalence`):
each rank runs its rows of the requests and the images are all-gathered.
What the pipeline draws from the generator is drawn for the whole batch
by the pipeline's own `draw_noise`, the one that `generate` draws through,
so a rank's rows see the unsharded call's noise.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from prompt_diffusion_tpu_torch.ops.quant import _QuantizedWeight
from prompt_diffusion_tpu_torch.parallel.mesh import batch_slice, world_size


def is_int8(pipe) -> bool:
    """Whether any of the pipeline's modules holds int8 weights."""
    return any(isinstance(m, _QuantizedWeight) for net in pipe.jax_modules().values()
               for m in net.modules())


def generate_sharded(pipe, mesh, **kwargs) -> torch.Tensor:
    """`pipe.generate(**kwargs)` (SD1.5 or SD3) with the requests sharded
    over every rank of the mesh: `pipe.draw_noise(**kwargs)` fills in the
    noise for the whole batch, each rank runs its rows of every
    per-request argument (a tensor or array whose leading size is the
    batch's, in dicts too: prompts, conditions, the noise, per-sample
    scales) and the images are all-gathered. The batch must divide over
    the ranks. Refused: DDIM with eta > 0 (its loop noise is drawn for the
    whole batch at every step), and the int8 policy (`quant_act`'s
    per-tensor scale spans the whole batch, which a rank sees a slice of:
    ROADMAP queue 2, item 5)."""
    if is_int8(pipe):
        raise NotImplementedError(
            "sharded generate under the int8 policy: the per-tensor activation scale spans "
            "the whole batch, a rank sees a slice (ROADMAP queue 2, item 5: int8 sharded "
            "generate with a per-sample scale)")
    if kwargs.get("eta", 0.0) != 0.0:
        raise NotImplementedError("sharded generate with eta > 0: DDIM's loop noise is drawn "
                                  "for the whole batch at every step")
    kwargs.update(pipe.draw_noise(**kwargs))
    b = kwargs["init_noise"].shape[0]

    def part(v):
        if isinstance(v, dict):
            return {k: part(x) for k, x in v.items()}
        if isinstance(v, (torch.Tensor, np.ndarray)) and v.ndim and v.shape[0] == b:
            return batch_slice(v, mesh)
        return v

    local = pipe.generate(**{k: part(v) for k, v in kwargs.items()})
    if world_size(mesh) == 1:
        return local
    out = local.new_empty((b,) + tuple(local.shape[1:]))
    dist.all_gather_into_tensor(out, local.contiguous())
    return out
