"""Slab partition of the structured box mesh, and the duplicated-plane
layout of a partitioned axis.

Port of `pmg_dolfinx_tpu.parallel.partition` (host numpy, as the JAX
package keeps it):

- cells are split into ``n_shards`` contiguous slabs along x (the cell
  ordering is x-slowest, so slabs are contiguous cell ranges);
- each shard stores the dof planes of its own cells including the
  interface plane it shares with its right neighbour, so interface planes
  appear on both shards (the one-plane-deep ghost layer);
- duplicated planes hold identical values; a cell scatter leaves partial
  sums on them, which the neighbour exchange of `parallel.dist`
  reconciles;
- every shard owns its planes ``[0, cpd*P)`` and the last shard its final
  plane too: the ownership weights make reductions exact.

`DistPMG` (`parallel.dist`) stacks the shards on one device; this module
gives JAX's public layout ``(n_shards * npl, NY, NZ)``, which is the
stacked ``(n_shards, npl, NY, NZ)`` tensor reshaped.
"""

import numpy as np

from ..fem.mesh import BoxMesh


def duplicate_planes(mg: np.ndarray, npl: int, n_shards: int) -> np.ndarray:
    """Global per-plane axis array -> duplicated-plane layout: shard
    ``s``'s ``npl`` planes start at ``s*(npl-1)``."""
    return np.concatenate(
        [mg[s * (npl - 1): s * (npl - 1) + npl] for s in range(n_shards)]
    )


class SlabPartition:
    """Static partition data for ``mesh`` split into ``n_shards`` x-slabs."""

    def __init__(self, mesh: BoxMesh, n_shards: int):
        self.mesh = mesh
        self.n_shards = int(n_shards)
        nx = mesh.nc[0]
        if nx % self.n_shards != 0:
            raise ValueError(
                f"nx={nx} must be divisible by n_shards={self.n_shards} "
                "(pick the mesh with fit_box_cells(..., multiple=n_shards))"
            )
        self.cells_per_shard_x = nx // self.n_shards
        self.ncells_local = self.cells_per_shard_x * mesh.nc[1] * mesh.nc[2]

    # -- per-degree local layout ---------------------------------------

    def local_planes(self, P: int) -> int:
        """Number of x-planes stored per shard (owned + 1 shared)."""
        return self.cells_per_shard_x * P + 1

    def axis_starts(self, P: int):
        """Per-shard x-plane starts and the local plane count of the
        duplicated-plane layout."""
        npl = self.local_planes(P)
        return [s * (npl - 1) for s in range(self.n_shards)], npl

    def local_shape(self, P: int):
        _, NY, NZ = self.mesh.lattice_shape(P)
        return (self.local_planes(P), NY, NZ)

    def local_ndofs(self, P: int) -> int:
        npl, NY, NZ = self.local_shape(P)
        return npl * NY * NZ

    def local_dofmap(self, P: int) -> np.ndarray:
        """Cell dofmap of ONE slab in local-lattice flat indices (the same
        for every shard: the slab geometry repeats)."""
        sub = BoxMesh(
            (self.cells_per_shard_x, self.mesh.nc[1], self.mesh.nc[2]),
            extent=(1.0, 1.0, 1.0),  # only connectivity matters here
        )
        return sub.dofmap(P)

    # -- global <-> distributed layout ---------------------------------

    def to_dist(self, P: int, u: np.ndarray) -> np.ndarray:
        """Expand a global dof vector into the duplicated slab layout
        ``(n_shards * local_planes, NY, NZ)``."""
        NX, NY, NZ = self.mesh.lattice_shape(P)
        lat = np.asarray(u).reshape(NX, NY, NZ)
        npl = self.local_planes(P)
        shards = [
            lat[s * (npl - 1): s * (npl - 1) + npl]
            for s in range(self.n_shards)
        ]
        return np.concatenate(shards, axis=0)

    def from_dist(self, P: int, ud: np.ndarray) -> np.ndarray:
        """Collapse the duplicated layout back to the global flat vector."""
        NX, NY, NZ = self.mesh.lattice_shape(P)
        npl = self.local_planes(P)
        ud = np.asarray(ud).reshape(self.n_shards, npl, NY, NZ)
        parts = [ud[s, :-1] for s in range(self.n_shards - 1)] + [ud[-1]]
        return np.concatenate(parts, axis=0).reshape(NX * NY * NZ)

    def ownership_weights(self, P: int) -> np.ndarray:
        """Per-entry weights making dots over the duplicated layout exact."""
        npl, NY, NZ = self.local_shape(P)
        w = np.ones((self.n_shards, npl, NY, NZ))
        w[:-1, -1] = 0.0  # duplicated interface plane counted on the owner
        return w.reshape(self.n_shards * npl, NY, NZ)

    def cell_slab_slices(self):
        """Global cell index ranges per shard (cells are slab-contiguous)."""
        return [
            slice(s * self.ncells_local, (s + 1) * self.ncells_local)
            for s in range(self.n_shards)
        ]
