from .specs import (ShardingRules, dp_axes, dp_size, local_slice, mesh_shape,
                    place, place_leaf, tp_size)

__all__ = ["ShardingRules", "dp_axes", "dp_size", "local_slice",
           "mesh_shape", "place", "place_leaf", "tp_size"]
