"""Serving-side distribution (port of ``repro/distrib``).

* ``distrib.tp`` — tensor-parallel serve meshes over ``torch.distributed``:
  ``serve_mesh(tp)`` builds the 1 x tp ("data", "model") mesh a
  ``ModelRuntime`` places its params / KV / bank shards on (rules in
  ``sharding.specs``), and ``TPShard`` carries the split model's
  collectives; ``head_shard_map`` checks a kernel's head-split arguments
  carry the rank's share.
* ``distrib.cluster`` — ``EngineCluster``: N engine replicas behind one
  engine-shaped surface, with adapter-affinity routing, least-loaded
  spillover, queued-work rebalancing, and one aggregated
  ``cluster_stats()`` report whose N=1 case is the single-engine report.
"""
from .cluster import EngineCluster, format_cluster_report
from .tp import head_shard_map, serve_mesh

__all__ = ["EngineCluster", "format_cluster_report", "head_shard_map",
           "serve_mesh"]
