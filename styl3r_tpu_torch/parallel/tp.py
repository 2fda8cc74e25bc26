"""Tensor parallelism over a 2-D (data, model) device mesh (counterpart of
styl3r_tpu/parallel/tp.py).

The reference scales by data parallelism only; this is the Megatron split
of every transformer block of the CroCo backbone, its decoders and the
token stylizer: qkv, projq, projk, projv and fc1 column-parallel (their
output features sharded over the mesh's "model" dim), proj and fc2
row-parallel (their input features sharded; their outputs all-reduced once
an attention and once an MLP). Everything else stays replicated: norms,
patch embeddings, the DPT heads and the adapter. The JAX module names its
layers the same way (its name rule also catches the patch embeddings' conv,
`patch_embed.proj`, which is no linear and stays whole here).

Two details the JAX module leaves to XLA:
  * the fused qkv's output rows are [q | k | v] over all heads, so a
    contiguous shard of them is not whole heads; shard_params_tp permutes
    the rows so that each model rank holds q, k and v of its own heads, and
    gathered_state_dict undoes it, so that checkpoints keep the reference
    layout;
  * the global-norm clip must see the whole gradient: a sharded gradient's
    squares are summed over the model group, a replicated one counts once
    (global_sq_norm, which train/step.py's clip calls).

Usage (after torch.distributed is started on every rank):
    mesh = make_mesh_2d(n_data, n_model, "cuda")
    shard_params_tp(model, mesh)
    data = data_group_2d(mesh)           # the gradient all-reduce's ranks
    optimizer = make_optimizer(model)    # its moments follow the shardings
    step = make_train_step(model, optimizer, ..., data=data)
    step(state, shard_batch(batch, data.rank, data.world), generator)
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
from torch import Tensor
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.parallel import ColwiseParallel, ParallelStyle, RowwiseParallel, parallelize_module

from ..models.vit import Attention, CrossAttention, Mlp
from .mesh import DataGroup, shard_batch

AXES = ("data", "model")
# Column-parallel (output features sharded) and row-parallel (input
# features sharded) layers of a block, by name (JAX tp.py's _COLUMN, _ROW).
_COLUMN = ("qkv", "projq", "projk", "projv", "fc1")
_ROW = ("proj", "fc2")


def make_mesh_2d(n_data: Optional[int] = None, n_model: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over the first n_data * n_model ranks (n_data
    defaults to what the world size leaves)."""
    if n_data is None:
        n_data = dist.get_world_size() // n_model
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=AXES)


def data_group_2d(mesh: DeviceMesh) -> DataGroup:
    """The ranks of this rank's "data" row: a global batch is split over
    them (shard_batch) and replicated over "model", and the gradients are
    averaged over them alone."""
    data = mesh["data"]
    return DataGroup(data.get_local_rank(), data.size(), data.get_group())


def batch_sharding_2d(batch, mesh: DeviceMesh):
    """This rank's rows of a global batch: split over "data", the same on
    every rank of a "model" column."""
    data = data_group_2d(mesh)
    return shard_batch(batch, data.rank, data.world)


def _blocks(model: nn.Module):
    """(name, module) of every attention and MLP of a transformer block."""
    return [(n, m) for n, m in model.named_modules() if isinstance(m, (Attention, CrossAttention, Mlp))]


def tensor_parallel_plan(model: nn.Module) -> Dict[str, ParallelStyle]:
    """parallelize_module's plan: each block's column layers colwise, its
    row layers rowwise, by fully qualified name."""
    plan: Dict[str, ParallelStyle] = {}
    for name, module in _blocks(model):
        for child, _ in module.named_children():
            if child in _COLUMN:
                plan[f"{name}.{child}"] = ColwiseParallel()
            elif child in _ROW:
                plan[f"{name}.{child}"] = RowwiseParallel()
    return plan


def qkv_rows(num_heads: int, head_dim: int, n_model: int) -> Tensor:
    """The row order of a fused qkv under an n_model-way column split: for
    each model rank, q, k and v of its heads. Row i of the sharded layout
    is row qkv_rows(...)[i] of the reference's [q | k | v]."""
    dim = num_heads * head_dim
    local = num_heads // n_model
    rows = [
        part * dim + head * head_dim + torch.arange(head_dim)
        for rank in range(n_model)
        for part in range(3)
        for head in range(rank * local, (rank + 1) * local)
    ]
    return torch.cat(rows)


def shard_params_tp(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Megatron-shard `model`'s blocks in place over mesh["model"]: permute
    each fused qkv's rows into per-rank heads, set each attention's local
    head count, and apply tensor_parallel_plan. The weights become DTensors
    (sharded or, for the row layers' biases, replicated); every other
    parameter stays a plain tensor, the same on every model rank."""
    tp = mesh["model"]
    n_model = tp.size()
    for name, module in _blocks(model):
        if isinstance(module, Mlp):
            if module.fc1.out_features % n_model:
                raise ValueError(f"{name}: {module.fc1.out_features} hidden features over {n_model} model ranks")
            continue
        if module.num_heads % n_model:
            raise ValueError(f"{name}: {module.num_heads} heads over {n_model} model ranks")
        if isinstance(module, Attention) and n_model > 1:
            rows = qkv_rows(module.num_heads, module.head_dim, n_model).to(module.qkv.weight.device)
            with torch.no_grad():
                module.qkv.weight.copy_(module.qkv.weight[rows])
                module.qkv.bias.copy_(module.qkv.bias[rows])
        module.num_heads //= n_model
    return parallelize_module(model, tp, tensor_parallel_plan(model))


def gathered_state_dict(model: nn.Module) -> Dict[str, Tensor]:
    """A TP-sharded model's state dict as plain tensors in the reference
    layout (each DTensor gathered, each fused qkv's rows put back): what
    checkpoints and utils/convert.py hold. A collective: every rank of the
    mesh calls it."""
    sd = {k: v.full_tensor() if isinstance(v, DTensor) else v for k, v in model.state_dict().items()}
    for name, module in _blocks(model):
        weight = module.qkv.weight if isinstance(module, Attention) else None
        if isinstance(weight, DTensor) and weight.device_mesh.size() > 1:
            n_model = weight.device_mesh.size()
            rows = qkv_rows(module.num_heads * n_model, module.head_dim, n_model)
            back = torch.argsort(rows).to(weight.device)
            for leaf in ("weight", "bias"):
                sd[f"{name}.qkv.{leaf}"] = sd[f"{name}.qkv.{leaf}"][back]
    return sd


def global_sq_norm(grads: Iterable[Tensor]) -> Tensor:
    """The sum of squares of whole gradients, each counted once: a DTensor
    sharded over a mesh adds its local shard's squares summed over that
    mesh's group; a replicated DTensor or a plain tensor (the same on every
    model rank) adds its local squares. f32."""
    local, sharded, group = [], [], None
    for g in grads:
        if isinstance(g, DTensor):
            if any(isinstance(p, Shard) for p in g.placements):
                sharded.append(g.to_local())
                group = g.device_mesh.get_group()
                continue
            if not all(isinstance(p, Replicate) for p in g.placements):
                raise ValueError(f"a gradient placed as {g.placements}: expected Shard or Replicate")
            g = g.to_local()
        local.append(g)
    total = sum((g.float() ** 2).sum() for g in local)
    if sharded:
        part = sum((g.float() ** 2).sum() for g in sharded)
        dist.all_reduce(part, group=group)
        total = total + part
    return total
