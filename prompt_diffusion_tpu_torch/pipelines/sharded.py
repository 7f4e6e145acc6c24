"""`generate` with the requests sharded over the ranks of a mesh.

Counterpart of the JAX package's sharded generate (GSPMD over the batch
axis, `tests/test_multidevice.py::test_sd15_generate_sharded_equivalence`):
each rank runs its rows of the requests and the images are all-gathered.
What spans the whole batch is computed for the whole batch, so a rank's
rows see the unsharded call's numbers, as GSPMD's do:
  * the noise `generate` draws before its loop (x_T, SD3's VAE sampling
    noise) is drawn for the whole batch by the pipeline's own
    `draw_noise`, the one that `generate` draws through;
  * DDIM's eta > 0 step noise is drawn for the whole batch at every step
    from the same seeded generator, and each rank takes its rows;
  * under the int8 policy the per-tensor activation scale (`quant_act`)
    takes its amax over every rank (one MAX all-reduce a quantized
    tensor); the kernels' per-sample and per-row scales need nothing.
Both run inside `parallel.mesh.sharded_batch`, entered here over more
than one rank: a mesh of one rank runs `generate` itself, with no
collective.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from prompt_diffusion_tpu_torch.parallel.mesh import (
    BatchShard,
    batch_rank,
    batch_slice,
    sharded_batch,
    world_size,
)


def generate_sharded(pipe, mesh, **kwargs) -> torch.Tensor:
    """`pipe.generate(**kwargs)` (SD1.5 or SD3, any policy and sampler) with
    the requests sharded over every rank of the mesh (`make_mesh`'s, which
    spans the world): `pipe.draw_noise(**kwargs)` fills in the noise for
    the whole batch, each rank runs its rows of every per-request argument
    (a tensor or array whose leading size is the batch's, in dicts too:
    prompts, conditions, the noise, per-sample scales) inside
    `sharded_batch`, and the images are all-gathered. The batch must
    divide over the ranks. The same `generator` state on every rank (the
    same seed) gives the unsharded call's images."""
    kwargs.update(pipe.draw_noise(**kwargs))
    b = kwargs["init_noise"].shape[0]

    def part(v):
        if isinstance(v, dict):
            return {k: part(x) for k, x in v.items()}
        if isinstance(v, (torch.Tensor, np.ndarray)) and v.ndim and v.shape[0] == b:
            return batch_slice(v, mesh)
        return v

    local_kwargs = {k: part(v) for k, v in kwargs.items()}
    w = world_size(mesh)
    if w == 1:
        return pipe.generate(**local_kwargs)
    n, r = b // w, batch_rank(mesh)
    with sharded_batch(BatchShard(dist.group.WORLD, b, slice(r * n, (r + 1) * n))):
        local = pipe.generate(**local_kwargs)
    out = local.new_empty((b,) + tuple(local.shape[1:]))
    dist.all_gather_into_tensor(out, local.contiguous())
    return out
