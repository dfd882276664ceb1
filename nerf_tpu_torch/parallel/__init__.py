from nerf_tpu_torch.parallel.mesh import (
    make_mesh,
    ray_sharding,
    replicated,
    tp_param_shardings,
)
from nerf_tpu_torch.parallel.train import make_sharded_train_step, shard_train_state

__all__ = [
    "make_mesh",
    "ray_sharding",
    "replicated",
    "tp_param_shardings",
    "make_sharded_train_step",
    "shard_train_state",
]
