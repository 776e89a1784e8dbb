"""Multi-device / multi-host scale-out.

The reference is single-process, single-node (SURVEY §2.11: its only
parallelism is std::async over ROI ranges, parallel.h:23-42, plus optional
single-GPU offload).  This package is the net-new distributed layer of this
build:

* intra-slice (device mesh): the padded ROI batch axis is sharded over a 1-D
  ``("roi",)`` device mesh.  Feature kernels are embarrassingly parallel over
  ROIs, so computation-follows-data under ``jit`` — XLA's SPMD partitioner
  emits no collectives on the hot path; the per-batch packed output is
  gathered once at collection time.
* inter-host: the slide/pair list is sharded by JAX process index — each
  host drives its own local devices over its own slides (the counterpart
  of the reference's slide-level std::async fan-out,
  workflow_2d_whole.cpp:292-330).
"""

from .mesh import roi_mesh, shard_batch, replicate
from .dataset import process_shard, initialize_distributed

__all__ = ["roi_mesh", "shard_batch", "replicate", "process_shard",
           "initialize_distributed"]
