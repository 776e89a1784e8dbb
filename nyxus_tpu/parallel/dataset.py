"""Inter-host dataset sharding.

The reference fans whole slides out over threads of one process
(workflow_2d_whole.cpp:292-330).  Multi-host systems instead run one
process per host: shard the (intensity, mask) pair list by process index so
each host featurizes a disjoint slide subset with its own local devices.
Outputs compose trivially — each host writes its own per-slide rows (CSV /
Arrow streams are per-slide in the reference output contract too).
"""

from __future__ import annotations

import jax


def initialize_distributed(**kwargs) -> None:
    """Bring up the JAX distributed runtime (multi-host).  Thin gate around
    jax.distributed.initialize: no-op when already initialized or when the
    run is single-process."""
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError:
        pass  # already initialized


def process_shard(items, index=None, count=None):
    """This host's slice of a work list: round-robin by process index so
    heterogeneous slide sizes balance in expectation.

    Resolution order: explicit args > NYXUS_PROCESS_INDEX/COUNT env (for
    mpirun/srun-style launchers and multi-process tests without a JAX
    coordinator) > jax.process_index()/process_count()."""
    import os
    if index is None:
        env = os.environ.get("NYXUS_PROCESS_INDEX")
        index = int(env) if env is not None else jax.process_index()
    if count is None:
        env = os.environ.get("NYXUS_PROCESS_COUNT")
        count = int(env) if env is not None else jax.process_count()
    return list(items)[index::count]
