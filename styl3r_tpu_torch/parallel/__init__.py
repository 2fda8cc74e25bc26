"""Multi-device training (counterpart of styl3r_tpu/parallel/): data
parallelism over torch.distributed (mesh.py) and Megatron tensor
parallelism over a (data, model) device mesh (tp.py)."""

from .mesh import (
    DataGroup,
    all_reduce_grads_,
    broadcast_params_,
    data_group,
    init_distributed,
    reduce_metrics,
    shard_batch,
)
from .tp import (
    batch_sharding_2d,
    data_group_2d,
    gathered_state_dict,
    make_mesh_2d,
    shard_params_tp,
    tensor_parallel_plan,
)

__all__ = [
    "DataGroup",
    "all_reduce_grads_",
    "broadcast_params_",
    "data_group",
    "init_distributed",
    "reduce_metrics",
    "shard_batch",
    "batch_sharding_2d",
    "data_group_2d",
    "gathered_state_dict",
    "make_mesh_2d",
    "shard_params_tp",
    "tensor_parallel_plan",
]
