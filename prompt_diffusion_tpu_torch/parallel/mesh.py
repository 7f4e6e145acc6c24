"""Device mesh, batch slicing and the ZeRO-sharded flat state layout over
torch.distributed.

Counterpart of `prompt_diffusion_tpu/parallel/mesh.py`: one
`('data', 'fsdp')` mesh (`torch.distributed.device_mesh.DeviceMesh`), the
batch sharded over both axes (global rank r = data index * num_fsdp +
fsdp index takes rows [r * B / W, (r + 1) * B / W)), and the trainable
state sharded ZeRO-style over `fsdp` and replicated over `data`. GSPMD
inserts the JAX package's collectives; here they are written out, one of
each kind per optimizer step:

  * the masters are one flat fp32 buffer per kind (master, mu, nu, acc,
    EMA) over `TrainState`'s tensor list, each tensor's segment starting
    on an `ALIGN`-element boundary, split into equal chunks (the last one
    padded) across `fsdp`; `FlatLayout` maps tensors to chunks;
  * after an update the chunks are all-gathered into the modules' tensors
    in their dtypes (`make_param_gather`'s replicated constraint);
  * after `backward()` the flat gradient is reduce-scattered over `fsdp`,
    all-reduced over `data` and divided by the world size (the gather's
    VJP, and the data-parallel mean);
  * the clip's global norm is the all-reduce of the chunks' squared norms.

The JAX package picks one axis of each large tensor to shard
(`_fsdp_spec`); the flat chunks are another layout of the same elementwise
arithmetic, so the numbers do not change. A group of one rank exchanges
nothing, so a 1 x 1 mesh computes what no mesh does, bit for bit.

`make_mesh` joins the process group `torchrun` describes (`RANK`,
`WORLD_SIZE`, `LOCAL_RANK`; NCCL on the card, gloo on the CPU) unless the
caller has joined one already.

A call whose batch is split over the ranks (`pipelines/sharded.py`) runs
inside `sharded_batch`: what spans the whole batch reads `batch_shard()`
(the int8 per-tensor activation scale all-reduces its amax over the
group, DDIM's eta > 0 step noise is drawn for the whole batch and cut to
the rank's rows). Outside one, `batch_shard()` is None and nothing is
exchanged.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "fsdp")
# elements: every segment and chunk of a flat buffer starts 512-byte aligned,
# as a fresh fp32 allocation does, so a whole tensor's view reduces (the
# clip's norm) exactly as the tensor would
ALIGN = 128


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """This rank's part of a call whose batch is split over a process
    group."""

    group: dist.ProcessGroup  # the ranks the batch is split over
    batch: int  # the whole batch
    rows: slice  # this rank's rows of it


_BATCH_SHARD: contextvars.ContextVar = contextvars.ContextVar("batch_shard", default=None)


@contextlib.contextmanager
def sharded_batch(shard: BatchShard) -> Iterator[BatchShard]:
    """Runs the block as `shard`'s rank of a call split over its group."""
    token = _BATCH_SHARD.set(shard)
    try:
        yield shard
    finally:
        _BATCH_SHARD.reset(token)


def batch_shard() -> Optional[BatchShard]:
    """The split call this code runs in (`sharded_batch`), or None."""
    return _BATCH_SHARD.get()


def launched() -> bool:
    """Whether `torchrun` (or another launcher of its protocol) started
    this process."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def init_distributed(device: str = "cuda") -> torch.device:
    """Joins the process group `torchrun` describes, once per process
    (NCCL for "cuda", gloo for "cpu"), and returns this rank's device: on
    the card `cuda:LOCAL_RANK`, made the current device."""
    kind = torch.device(device).type
    if kind != "cuda":
        if not dist.is_initialized():
            dist.init_process_group("gloo")
        return torch.device("cpu")
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl", device_id=dev)  # the rank's card, not a guess
    return torch.device("cuda", torch.cuda.current_device())


def make_mesh(num_data: Optional[int] = None, num_fsdp: int = 1, device: str = "cuda"):
    """The 2D (data, fsdp) mesh over every rank of the process group
    (joined here if it is not yet); `num_data` defaults to the rest of the
    world. Refuses a shape whose product is not the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = init_distributed(device)
    world = dist.get_world_size()
    if num_fsdp < 1 or (num_data is None and world % num_fsdp):
        raise ValueError(f"--num-fsdp {num_fsdp} does not divide the world size {world}")
    num_data = world // num_fsdp if num_data is None else num_data
    if num_data * num_fsdp != world:
        raise ValueError(f"a {num_data}x{num_fsdp} mesh needs {num_data * num_fsdp} ranks, "
                         f"the world has {world}")
    return init_device_mesh(dev.type, (num_data, num_fsdp), mesh_dim_names=AXES)


def mesh_device(mesh) -> torch.device:
    """This rank's device on `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def world_size(mesh) -> int:
    """The ranks the batch is sharded over (1 without a mesh)."""
    return 1 if mesh is None else mesh.size()


def batch_rank(mesh) -> int:
    """This rank's index along the batch: data index * num_fsdp + fsdp index."""
    if mesh is None:
        return 0
    return mesh.get_local_rank("data") * _size(mesh, "fsdp") + mesh.get_local_rank("fsdp")


def batch_slice(x, mesh):
    """This rank's rows of a global batch: a tensor, an array, or a tuple
    (NamedTuple) of them. Refuses a batch the world size does not divide."""
    w = world_size(mesh)
    if isinstance(x, tuple):
        return type(x)(*(batch_slice(t, mesh) for t in x))
    if w == 1:
        return x
    n = x.shape[0]
    if n % w:
        raise ValueError(f"a batch of {n} does not divide over {w} ranks")
    r = batch_rank(mesh)
    return x[r * (n // w):(r + 1) * (n // w)]


def _size(mesh, axis: str) -> int:
    """The ranks along one mesh axis (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(AXES.index(axis))


def fsdp_size(mesh) -> int:
    """The ranks the state is sharded over (1 without a mesh)."""
    return _size(mesh, "fsdp")


def sum_over_ranks(x: torch.Tensor, mesh, axis: Optional[str] = None) -> torch.Tensor:
    """The sum of `x` over the ranks of one mesh axis (every rank with
    `axis=None`); `x` itself where that group has one rank (as without a
    mesh)."""
    if (world_size(mesh) if axis is None else _size(mesh, axis)) == 1:
        return x
    y = x.clone()
    dist.all_reduce(y, group=None if axis is None else mesh.get_group(axis))
    return y


def mean_over_ranks(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of `x` over every rank of the mesh."""
    return sum_over_ranks(x, mesh) / world_size(mesh)


def gather_fsdp(shard: torch.Tensor, mesh) -> torch.Tensor:
    """The whole flat buffer from this rank's chunk: an all-gather over
    `fsdp` (the chunk itself where `fsdp` has one rank)."""
    n = _size(mesh, "fsdp")
    if n == 1:
        return shard
    full = shard.new_empty(n * shard.numel())
    dist.all_gather_into_tensor(full, shard, group=mesh.get_group("fsdp"))
    return full


def reduce_gradient(flat: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's chunk of the data-parallel mean of the flat gradient:
    reduce-scatter over `fsdp`, all-reduce over `data`, divided by the
    world size. One rank: `flat` itself."""
    f, w = _size(mesh, "fsdp"), world_size(mesh)
    if w == 1:
        return flat
    if f > 1:
        shard = flat.new_empty(flat.numel() // f)
        dist.reduce_scatter_tensor(shard, flat, group=mesh.get_group("fsdp"))
    else:
        shard = flat
    if _size(mesh, "data") > 1:
        dist.all_reduce(shard, group=mesh.get_group("data"))
    return shard.div_(w)


def rank0_value(value, mesh):
    """Global rank 0's `value` (a picklable object) on every rank, so a
    decision taken from local files is the same everywhere."""
    if world_size(mesh) == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier(mesh) -> None:
    if world_size(mesh) > 1:
        dist.barrier()


def is_rank0(mesh) -> bool:
    return mesh is None or dist.get_rank() == 0


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class FlatLayout:
    """Tensors of `shapes` laid end to end in one flat fp32 buffer (each
    segment starting on an `ALIGN` boundary), split into `num_shards` equal
    chunks; `shard` is this rank's. `pieces` lists (tensor index, start,
    stop) of the elements of each tensor that lie in the chunk, in tensor
    coordinates."""

    def __init__(self, shapes: Sequence[Tuple[int, ...]], num_shards: int = 1, shard: int = 0):
        self.shapes = [tuple(s) for s in shapes]
        self.numels = [math.prod(s) for s in self.shapes]
        self.offsets, pos = [], 0
        for n in self.numels:
            self.offsets.append(pos)
            pos += _round_up(n, ALIGN)
        self.chunk = max(_round_up(-(-pos // num_shards), ALIGN), ALIGN)
        self.total = self.chunk * num_shards
        self.lo = shard * self.chunk
        hi = self.lo + self.chunk
        self.pieces: List[Tuple[int, int, int]] = []
        for i, (o, n) in enumerate(zip(self.offsets, self.numels)):
            a, b = max(self.lo, o), min(hi, o + n)
            if a < b:
                self.pieces.append((i, a - o, b - o))

    def pack(self, tensors: Sequence[torch.Tensor], device) -> torch.Tensor:
        """A whole flat fp32 buffer (zero padding) holding `tensors`."""
        full = torch.zeros(self.total, dtype=torch.float32, device=device)
        for seg, t in zip(self.unpack(full), tensors):
            seg.copy_(t)
        return full

    def unpack(self, full: torch.Tensor) -> List[torch.Tensor]:
        """Each tensor's view, in its shape, of a whole flat buffer."""
        return [full[o:o + n].view(s) for o, n, s in zip(self.offsets, self.numels, self.shapes)]

    def views(self, chunk: torch.Tensor) -> List[torch.Tensor]:
        """The pieces' views of this rank's chunk: a whole tensor in its
        shape, a part of one flat."""
        out = []
        for i, a, b in self.pieces:
            start = self.offsets[i] + a - self.lo
            v = chunk[start:start + b - a]
            out.append(v.view(self.shapes[i]) if b - a == self.numels[i] else v)
        return out
