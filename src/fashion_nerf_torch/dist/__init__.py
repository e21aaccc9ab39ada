"""Distribution of the port on torch.distributed: the ("dp", "tp") mesh,
the data-parallel step's collectives, the tensor-parallel rule and the
segmented ray scan; counterpart of `fashion_nerf.dist`."""

from fashion_nerf_torch.dist.mesh import (init_distributed, make_mesh,
                                          param_shardings, ray_sharding,
                                          resolve_mesh, shard_state)
from fashion_nerf_torch.dist.segmented import segmented_ray_scan

__all__ = ["make_mesh", "ray_sharding", "param_shardings",
           "init_distributed", "resolve_mesh", "shard_state",
           "segmented_ray_scan"]
