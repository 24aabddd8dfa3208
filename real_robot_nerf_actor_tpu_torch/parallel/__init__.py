"""Data, ray and tensor parallelism on torch.distributed (the port's
counterpart of the JAX package's `parallel/`). `train_dp` and `dryrun`
import the trainers, so they are imported by name, not from here."""
from real_robot_nerf_actor_tpu_torch.parallel.constraints import (
    replicated, shard_hidden, tensor_parallel)
from real_robot_nerf_actor_tpu_torch.parallel.mesh import (
    Mesh, MeshSpec, RowParallelDense, data_parallel_shardings, make_mesh, replicate,
    shard_batch, shard_module_, shard_params_rule, shard_rays)

__all__ = ["Mesh", "MeshSpec", "RowParallelDense", "data_parallel_shardings", "make_mesh",
           "replicate", "replicated", "shard_batch", "shard_hidden", "shard_module_",
           "shard_params_rule", "shard_rays", "tensor_parallel"]
