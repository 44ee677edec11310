"""The distributed layer, every shard stacked on one device or each
rank's block of shards on its own (`multihost`): the 1D slab
(`dist.DistPMG`), the 2D/3D box decomposition of the Kronecker family
(`grid2d.GridPMG`), the gather-free coarse solves (`fdm_dist.DistFDM`,
`dist.build_hmg_dist`, `grid2d.build_hmg_grid`), the sharded time loops
(`transient_dist`) and the unstructured-mesh cell partition with its
shared-entity exchange (`dss_dist.DSSDist`, `dss_dist.DSSPartition`).
Every collective goes through one seam, `grid2d.StackedGrid`, or across
processes its rank-blocked twin `multihost.RankGrid`."""

from .partition import SlabPartition
from .dist import DistPMG, build_hmg_dist
from .grid2d import GridPMG, GridPartition, StackedGrid, build_hmg_grid
from .fdm_dist import DistFDM
from .dss_dist import DSSDist, DSSPartition
from .multihost import (
    RankGrid,
    fetch_global,
    initialize,
    process_count,
    process_index,
    put_global,
)
from .transient_dist import (
    convdiff_dist_evolve,
    heat_dist_evolve,
    semilinear_dist_evolve,
    wave_leapfrog_dist_evolve,
    wave_newmark_dist_evolve,
)
