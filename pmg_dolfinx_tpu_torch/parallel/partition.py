"""The duplicated-plane layout of a partitioned axis.

Port of `pmg_dolfinx_tpu.parallel.partition.duplicate_planes`. Each shard
of a partitioned axis stores the dof planes of its own cells including
the interface plane it shares with its right neighbour, so interface
planes appear on both shards. The slab partition (`SlabPartition`) waits
with `DistPMG` (ROADMAP.md Queue 1 item 10).
"""

import numpy as np


def duplicate_planes(mg: np.ndarray, npl: int, n_shards: int) -> np.ndarray:
    """Global per-plane axis array -> duplicated-plane layout: shard
    ``s``'s ``npl`` planes start at ``s*(npl-1)``."""
    return np.concatenate(
        [mg[s * (npl - 1): s * (npl - 1) + npl] for s in range(n_shards)]
    )
