"""Data parallelism over torch.distributed (counterpart of
styl3r_tpu/parallel/mesh.py; the reference trains with Lightning DDP over
NCCL, SURVEY.md §2.8).

The JAX trainer keeps the params replicated over a 1-D `data` mesh, shards
the global batch on its leading dim, and XLA inserts the gradient all-reduce
inside the jitted step. Here each process (a rank, as torchrun starts them)
holds the whole model and its own rows of the global batch, and the train
step averages the gradients over the ranks explicitly after the backward and
before the global-norm clip (`all_reduce_grads_`), so that every rank clips
and updates alike and the update is the global batch's. Not
DistributedDataParallel: the identity branch runs two forwards of one module
before its backward, stage 0 leaves the stylizer and the gs heads without
gradients, and stage 2's frozen parameters must not be reduced at all.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
from torch import Tensor

from ..device import resolve_device

# Gradients are reduced in flat f32 buckets of at most this many elements
# (64 MiB): few collectives, and a bounded staging copy.
BUCKET_ELEMENTS = 1 << 24
# Metrics reduced by max or min over the ranks (the pair cap's telemetry, as
# the JAX step's max/min over the global batch); the rest are averaged.
_MAX_METRICS = ("live_pairs",)
_MIN_METRICS = ("pair_slots",)


class DataGroup(NamedTuple):
    """The ranks a global batch is split over: this process's rank, their
    number and their process group (None: the default group)."""

    rank: int
    world: int
    group: Optional[dist.ProcessGroup] = None

    def all_reduce_(self, tensor: Tensor, op=dist.ReduceOp.SUM) -> Tensor:
        """All-reduce `tensor` in place over the group (a sum by default)."""
        dist.all_reduce(tensor, op=op, group=self.group)
        return tensor


def init_distributed(device_type: str) -> Tuple[int, int, torch.device]:
    """(rank, world size, device) of this process. Under torchrun (RANK,
    WORLD_SIZE and LOCAL_RANK in the environment) it starts the default
    process group: NCCL on CUDA, on the card LOCAL_RANK, which becomes the
    current device; gloo when the caller asked for the CPU. Without
    WORLD_SIZE it starts no group and returns (0, 1, the device). Nothing
    falls back: without CUDA a "cuda" run raises, and so does a failed NCCL
    init."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type {device_type!r}: expected cuda or cpu")
    if "WORLD_SIZE" not in os.environ:
        return 0, 1, resolve_device("cpu" if device_type == "cpu" else None)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device_type == "cpu":
        dist.init_process_group("gloo", rank=rank, world_size=world)
        return rank, world, torch.device("cpu")
    device = resolve_device()  # the card LOCAL_RANK
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", rank=rank, world_size=world, device_id=device)
    return rank, world, device


def data_group() -> Optional[DataGroup]:
    """The default process group as a DataGroup when torch.distributed is
    initialized (as data/dataset.py::data_shard reads it), else None."""
    if dist.is_available() and dist.is_initialized():
        return DataGroup(dist.get_rank(), dist.get_world_size())
    return None


def shard_batch(batch, rank: int, world: int):
    """Rank `rank`'s rows [r*b/W, (r+1)*b/W) of a global batch: a Batch-shaped
    tuple of arrays or tensors with leading dim b (None passes; a dict, such
    as a sparse anchor, is sharded value by value). Raises when W does not
    divide b."""
    b = batch[0].shape[0]
    if b % world:
        raise ValueError(f"a global batch of {b} does not split over {world} ranks")
    n = b // world

    def rows(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: rows(v) for k, v in x.items()}
        return x[rank * n:(rank + 1) * n]

    return type(batch)(*(rows(x) for x in batch))


def local_tensor(t: Tensor) -> Tensor:
    """A DTensor's shard on this rank (tensor parallelism, parallel/tp.py);
    a plain tensor itself."""
    to_local = getattr(t, "to_local", None)
    return to_local() if to_local is not None else t


def _buckets(tensors: Iterable[Tensor], limit: int = BUCKET_ELEMENTS) -> Iterator[List[Tensor]]:
    """Consecutive runs of tensors of at most `limit` elements together (a
    larger tensor is a run of its own)."""
    bucket, size = [], 0
    for t in tensors:
        if bucket and size + t.numel() > limit:
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += t.numel()
    if bucket:
        yield bucket


def all_reduce_grads_(params: Sequence[nn.Parameter], data: DataGroup) -> int:
    """Average the gradients of `params` (the ones the optimizer holds) over
    the data group, in place, in flat f32 buckets. A parameter whose grad is
    None (stage 0's stylizer and gs heads) is skipped: every rank runs the
    same step, so the same ones are None everywhere, and a first small
    collective checks that, since buckets of different gradients would
    otherwise be summed (or a rank would wait for a bucket that never
    comes). The check is exact: one int8 flag a parameter (1 where its grad
    is not None), all-reduced as [flags, -flags] by MAX, gives back
    [flags, -flags] only when every rank holds the same pattern. Returns
    the bytes reduced."""
    device = params[0].device
    grads = [local_tensor(p.grad) for p in params if p.grad is not None]
    n = sum(g.numel() for g in grads)
    flags = torch.tensor([p.grad is not None for p in params], dtype=torch.int8, device=device)
    mine = torch.cat([flags, -flags])
    seen = data.all_reduce_(mine.clone(), op=dist.ReduceOp.MAX)
    if not torch.equal(seen, mine):
        # Every rank finds a difference (the union and the intersection of
        # the patterns differ), so all of them take this second collective.
        counts = data.all_reduce_(torch.tensor([n, -n], dtype=torch.int64, device=device), op=dist.ReduceOp.MAX)
        first = int((seen != mine).reshape(2, -1).any(0).nonzero()[0])
        raise RuntimeError(
            f"rank {data.rank}: {n} gradient elements in {len(grads)} of {len(params)} parameters to reduce, the "
            f"ranks hold between {-int(counts[1])} and {int(counts[0])} elements: their steps left different "
            f"parameters without a gradient, the first at parameter index {first}"
        )
    for bucket in _buckets(grads):
        flat = torch.cat([g.reshape(-1).float() for g in bucket])
        data.all_reduce_(flat).div_(data.world)
        torch._foreach_copy_(bucket, [x.view_as(g) for x, g in zip(flat.split([g.numel() for g in bucket]), bucket)])
    return 4 * n


def reduce_metrics(metrics: Dict[str, Tensor], data: DataGroup) -> Dict[str, Tensor]:
    """A step's scalar metrics over the data group: `live_pairs` by max,
    `pair_slots` by min, every other (the losses, the global gradient norm)
    by mean, which with equal shards is the global batch's value. Each keeps
    its dtype."""
    names = sorted(metrics)
    out = dict(metrics)
    for op, keys in (
        (dist.ReduceOp.SUM, [k for k in names if k not in _MAX_METRICS + _MIN_METRICS]),
        (dist.ReduceOp.MAX, [k for k in names if k in _MAX_METRICS]),
        (dist.ReduceOp.MIN, [k for k in names if k in _MIN_METRICS]),
    ):
        if not keys:
            continue
        values = data.all_reduce_(torch.stack([metrics[k].double() for k in keys]), op=op)
        if op == dist.ReduceOp.SUM:
            values = values / data.world
        out.update({k: v.to(metrics[k].dtype) for k, v in zip(keys, values.unbind())})
    return out


def broadcast_params_(module: nn.Module, src: int = 0) -> None:
    """Give every rank rank `src`'s parameters and buffers (the default
    group): the init, a warm start or a restored state, whichever that rank
    loaded."""
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t, src=src)


def gather_objects(obj: Any, data: Optional[DataGroup]) -> List[Any]:
    """Every rank's `obj`, in rank order ([obj] without a data group)."""
    if data is None:
        return [obj]
    out: List[Any] = [None] * data.world
    dist.all_gather_object(out, obj, group=data.group)
    return out
