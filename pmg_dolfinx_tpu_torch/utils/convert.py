"""Carry hierarchy state between the JAX package and the port.

`hierarchy_data_from_numpy` turns a JAX `PMGHierarchy.data` tree, already
converted to numpy (``jax.tree.map(np.asarray, hier.data)``), into the
port's data layout: ``levels`` and ``transfer`` lists of dicts of
tensors plus the optional ``fdm`` dict. Every operator family carries
over under the JAX names: the Kronecker levels (``kb_mats`` ..., from
1D factors with Robin ends, graded spacing and per-axis kappa folded
in), the lattice family (``Gt``, ``lb_mats``, ``G`` with a tensor kappa
folded in, ``E*``/``D*``, ``m3`` with a sigma field and the Robin mass
baked in) and the dofmap levels (``dofmap``, ``G``, ``coeff``, ``D``),
with
``diag_inv``, ``lmax`` and the transfers (``I*`` or ``M1``,
``dofmap_c``/``dofmap_f``, ``mult_f``); the ``csr`` levels' BCOO matrices
become torch sparse CSR tensors; the ``dss`` levels carry their ``G``,
``coeff``, ``D``, ``m3``, Schwarz blocks and transfer weights (the JAX
TPU row-gather tables have no port counterpart and are left out: the
port's own tables come from the same mesh's layout); the ``amg`` coarse
data (``agg0``, ``scale0``, ``dinv0``, ``omega0``, the ``inner`` sparse
levels and ``chol``) carries over whole. Pass the result to the port's
`PMGHierarchy.load_state` to run its cycles on the JAX state (the
calibrated ``lmax`` included), so cycle parity is tested apart from
calibration parity.

`grid_data_from_numpy` does the same for the device grid: it turns a
numpy copy of the JAX `GridPMG.data` into the data of the port's
`parallel.grid2d.GridPMG` (its `load_state` takes the result), every
backend's level arrays (the Kronecker factors, the general family's
``G``, ``Gt``, ``lb_mats``, ``dofmap``, ``coeff`` and ``m3``) and the
coarse data (``fdm``, ``coarse_chol``, ``hmg`` with the h-levels of
`build_hmg_grid` or `build_hmg_grid_general`) in the stacked layout.

`dist_data_from_numpy` does the same for the 1D slab: it turns a numpy
copy of the JAX `DistPMG.data` into the data of the port's
`parallel.dist.DistPMG`. Both carry the ``hmg`` coarse data (gathered or
distributed levels, transfers, bottom factor) and the distributed FDM
bundle, laid out as the port's own arrays.

`dss_dist_data_from_numpy` does the same for the distributed unstructured
path: it turns a numpy copy of the JAX `DSSDist.data` into the data of
the port's `parallel.dss_dist.DSSDist` (the per-dof and per-cell arrays;
the layouts are equal, so each is a reshape).

`packed_state_from_numpy` does the same for the serving classes of
`ops.kron_packed`: it undoes the JAX lane packing of their factors.
"""

import numpy as np
import torch


# The JAX DSS level's TPU layout tables (row gathers, variant-sorted
# slices, the one-hot permutation matrix): the port builds its own.
_JAX_DSS_TABLES = frozenset((
    "vert_id", "vert_src", "face_id", "edge_id", "face_src", "edge_src",
    "face_gid", "face_gunsort", "face_sorder", "face_ssrc", "edge_gid",
    "edge_gunsort", "edge_sorder", "edge_ssrc", "pmat"))


def _sparse(M, device, dtype):
    """A BCOO (``data``, ``indices`` ``(nnz, 2)``, ``shape``) as a torch
    sparse CSR tensor."""
    import scipy.sparse as sp

    from ..ops.csr import to_sparse_csr

    idx = np.asarray(M.indices)
    C = sp.coo_matrix((np.asarray(M.data, np.float64),
                       (idx[:, 0], idx[:, 1])), shape=tuple(M.shape))
    return to_sparse_csr(C.tocsr(), dtype, device)


def _convert(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype) for k, v in tree.items()
                if k not in _JAX_DSS_TABLES}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device, dtype) for v in tree]
    if hasattr(tree, "indices") and hasattr(tree, "data") and not isinstance(
            tree, np.ndarray):
        return _sparse(tree, device, dtype)
    arr = np.asarray(tree)
    if arr.dtype == np.bool_:
        return torch.tensor(arr, device=device)
    if np.issubdtype(arr.dtype, np.integer):
        return torch.tensor(arr, dtype=torch.int64, device=device)
    return torch.tensor(arr, dtype=dtype, device=device)


def hierarchy_data_from_numpy(tree, device, dtype):
    """Port-layout hierarchy data (``levels``, ``transfer``, ``fdm``,
    ``amg``) from a numpy copy of the JAX hierarchy's data tree; float
    arrays are cast to ``dtype``, bool markers stay bool, integer dofmaps
    and aggregate maps become int64, BCOO matrices sparse CSR."""
    out = {
        "levels": _convert(list(tree["levels"]), device, dtype),
        "transfer": _convert(list(tree["transfer"]), device, dtype),
    }
    for key in ("fdm", "amg"):
        if key in tree:
            out[key] = _convert(tree[key], device, dtype)
    return out


# The lattice-shaped arrays of a JAX GridPMG level or transfer: JAX keeps
# them in its global duplicated layout, the port stacks the shards.
_GRID_LATTICE_KEYS = ("bc_marker", "weights", "diag_inv", "weights_f", "m3")


def _grid_level_array(k, t, shards):
    """One array of a JAX GridPMG level or transfer in the port's stacked
    layout: the duplicated-layout lattices (`_GRID_LATTICE_KEYS`), the
    general family's quadrature-lattice ``G`` ``(Qx, Qy, Qz, 6)`` and
    K-A's ``Gt`` ``(6, Qx, Qy, Qz)`` cut per shard, the dofmap backend's
    box-blocked per-cell ``G`` ``(ncx, ncy, ncz, nq, 6)`` and ``coeff``
    ``(ncx, ncy, ncz)`` stacked with each shard's cells flattened; the
    rest (axis factors, ``lb_mats``, the local dofmap) as they are."""
    from ..parallel.grid2d import stack_blocks, stack_gfirst, stack_shards

    if k in _GRID_LATTICE_KEYS:
        return stack_shards(t, shards)
    if k == "Gt":
        return stack_gfirst(t.movedim(0, -1), shards)
    if k == "G" and t.dim() == 4:
        return stack_blocks(t, shards)
    if k == "G" and t.dim() == 5:
        return stack_blocks(t, shards).reshape(
            tuple(shards) + (-1,) + tuple(t.shape[3:]))
    if k == "coeff" and t.dim() == 3:
        return stack_blocks(t, shards).reshape(tuple(shards) + (-1,))
    return t


def grid_data_from_numpy(tree, grid, device, dtype):
    """The port's `GridPMG` data (``levels``, ``transfer``, ``fdm``) from a
    numpy copy of the JAX `GridPMG.data` (``jax.tree.map(np.asarray,
    grid.data)``). ``grid`` is the port's `GridPMG` (or `GridPartition`)
    of the same mesh and shards. The lattice arrays (``bc_marker``,
    ``weights``, ``diag_inv``, ``weights_f``, ``m3``) go from JAX's
    global duplicated layout ``(sx*nplx, sy*nply, sz*nplz)`` to the
    stacked ``(sx, sy, sz, nplx, nply, nplz)``; the general family's
    geometry (``G``, ``Gt``, ``coeff``) is cut per shard
    (`_grid_level_array`); the grid-stacked ``kb_mats``, ``lb_mats``, the
    ``K*``/``m*`` and ``E*``/``D*`` factors, the local dofmap, the
    interpolation matrices, ``lmax`` and the global ``fdm`` and
    ``coarse_chol`` arrays keep their layout. The ``hmg`` data (gathered,
    or the distributed h-levels of `build_hmg_grid` /
    `build_hmg_grid_general`) is laid out as the port's own. Float arrays
    are cast to ``dtype``."""
    from ..parallel.grid2d import stack_shards

    shards = getattr(grid, "part", grid).shards

    def one(d):
        return {k: _grid_level_array(k, _convert(v, device, dtype), shards)
                for k, v in d.items()}

    out = {
        "levels": [one(lv) for lv in tree["levels"]],
        "transfer": [one(tr) for tr in tree["transfer"]],
    }
    if "fdm" in tree:
        out["fdm"] = _convert(tree["fdm"], device, dtype)
        if "bc" in out["fdm"]:   # the distributed FDM: dinv, bc stacked
            for k in ("dinv", "bc"):
                out["fdm"][k] = stack_shards(out["fdm"][k], shards)
    if "coarse_chol" in tree:
        out["coarse_chol"] = _convert(tree["coarse_chol"], device, dtype)
    if "hmg" in tree:
        mine = getattr(grid, "data", {}).get("hmg")
        out["hmg"] = _like(_convert(tree["hmg"], device, dtype), mine,
                           lambda t: stack_shards(t, shards),
                           qlattice=lambda t: _grid_level_array(
                               "G", t, shards))
    return out


def _like(tree, ref, stack, qlattice=None, key=None):
    """A converted JAX tree laid out as the port's ``ref`` tree: a leaf
    whose shape differs is the port's stacked layout of the JAX array
    (``stack``, on a grid, for lattices in JAX's duplicated layout;
    ``qlattice`` for a grid h-level's quadrature-lattice ``G``; a grid's
    line blocks re-stacked; else, as on the slab, a reshape of the same
    memory order)."""
    if isinstance(tree, dict):
        return {k: _like(v, None if ref is None else ref.get(k), stack,
                         qlattice, k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_like(v, None if ref is None else ref[i], stack, qlattice,
                      key)
                for i, v in enumerate(tree)]
    if ref is None or tuple(tree.shape) == tuple(ref.shape):
        return tree
    if tree.dim() == 3 and ref.dim() == 6 and stack is not None:
        return stack(tree)
    if key == "G" and qlattice is not None:
        return qlattice(tree)
    if tree.dim() == 4 and ref.dim() == 7:   # a grid's line blocks
        s0, s1 = (s for i, s in enumerate(ref.shape[:3])
                  if i != _unit_axis(ref.shape[:3]))
        n0, n1, n = ref.shape[3], ref.shape[4], ref.shape[-1]
        st = tree.reshape(s0, n0, s1, n1, n, n).permute(0, 2, 1, 3, 4, 5)
        return st.unsqueeze(_unit_axis(ref.shape[:3])).contiguous()
    return tree.reshape(ref.shape)


def _unit_axis(shards):
    """The line axis of a grid's line blocks: a shard axis of size 1 (the
    last one; any unit axis gives the same layout)."""
    return max(a for a in range(3) if shards[a] == 1)


# The vectors of a JAX DistPMG level or transfer, in its duplicated slab
# layout ``(S*npl, NY, NZ)`` (Kronecker family) or flat (general backends).
_SLAB_VECTOR_KEYS = ("bc_marker", "weights", "diag_inv", "weights_f", "m3",
                     "mult_f")


def dist_data_from_numpy(tree, dist, device, dtype):
    """The port's `DistPMG` data (``levels``, ``transfer``, ``fdm`` or
    ``coarse_chol``) from a numpy copy of the JAX `DistPMG.data`
    (``jax.tree.map(np.asarray, dist.data)``). ``dist`` is the port's
    `DistPMG` of the same mesh, slab count and backend. The level and
    transfer vectors go from JAX's duplicated layout to the port's working
    one (``(S, npl, NY, NZ)`` for the Kronecker family, flat otherwise);
    the row-stacked per-slab ``kb_mats["Ktx"]`` ``(S*npl, npl)`` becomes
    the block-diagonal ``(S*npl, S*npl)`` kernel 1 reads on the stack; the
    Schwarz ``Ux`` / ``ginv`` / ``bc`` take the slab stack's shapes; every
    other array (the shard-invariant factors, ``line_inv``, ``G``, the
    dofmaps, ``lmax``, the interpolation matrices and the global coarse
    arrays) keeps its layout. Float arrays are cast to ``dtype``."""
    S = dist.n_shards

    def vec(t, P):
        if dist.operator_kind in ("kron", "kron_blocked"):
            return t.reshape((S,) + dist.part.local_shape(P))
        return t.reshape(-1)

    def one(d, P):
        out = {}
        for k, v in d.items():
            t = _convert(v, device, dtype) if not isinstance(v, dict) else v
            if k in _SLAB_VECTOR_KEYS:
                t = vec(t, P)
            elif k == "kb_mats":
                t = _convert(v, device, dtype)
                K = t["Ktx"]
                n = K.shape[1]
                t["Ktx"] = torch.block_diag(*K.reshape(S, n, n)).contiguous()
            elif k == "schwarz":
                t = _convert(v, device, dtype)
                npl = dist.part.local_planes(P)
                t["Ux"] = t["Ux"].reshape(S, -1, npl)
                t["ginv"] = t["ginv"].reshape((S, -1) + tuple(
                    t["ginv"].shape[1:]))
                t["bc"] = t["bc"].reshape((S,) + dist.part.local_shape(P))
            out[k] = t
        return out

    degrees = dist.degrees
    out = {
        "levels": [one(lv, P) for lv, P in zip(tree["levels"], degrees)],
        "transfer": [one(tr, P) for tr, P in zip(tree["transfer"],
                                                 degrees[1:])],
    }
    for key in ("fdm", "coarse_chol"):
        if key in tree:
            out[key] = _convert(tree[key], device, dtype)
    if "hmg" in tree or "bc" in tree.get("fdm", {}):
        # The hmg data and the distributed FDM bundle: each array laid out
        # as the port's own (slab stacks reshape, same memory order).
        for key in ("fdm", "hmg"):
            if key in tree:
                out[key] = _like(_convert(tree[key], device, dtype),
                                 dist.data.get(key), None)
    return out


# The arrays of a JAX DSSDist level and transfer the port carries: the
# per-dof vectors and per-cell factors on the stacked layout (equal to
# JAX's), the Schwarz blocks and the smoother bound. JAX's index tables
# (``*_pack``, ``*_src``, ``pmat``, the bit-planes) are not carried: the
# port's own come from the same partition.
_DSS_DIST_KEYS = frozenset((
    "G", "coeff", "D", "bc_marker", "weights", "m3", "diag_inv", "lmax",
    "schwarz", "M1", "inv_mult_f"))


def dss_dist_data_from_numpy(tree, dist, device, dtype):
    """The port's `DSSDist` data (``levels``, ``transfer``,
    ``coarse_chol``) from a numpy copy of the JAX `DSSDist.data`
    (``jax.tree.map(np.asarray, dist.data)``). ``dist`` is the port's
    `DSSDist` of the same mesh, shard count and options: every carried
    array takes the shape of its counterpart there (the same memory
    order). Float arrays are cast to ``dtype``."""

    def one(d, ref):
        return {k: _like(_convert(v, device, dtype), ref[k], None)
                for k, v in d.items() if k in _DSS_DIST_KEYS and k in ref}

    out = {
        "levels": [one(lv, ref) for lv, ref in zip(tree["levels"],
                                                   dist.data["levels"])],
        "transfer": [one(tr, ref) for tr, ref in zip(tree["transfer"],
                                                     dist.data["transfer"])],
    }
    if "coarse_chol" in tree:
        out["coarse_chol"] = _convert(tree["coarse_chol"], device, dtype)
    return out


def packed_state_from_numpy(mats, kind, shape, *, device):
    """The port's serving factors (`ops.kron_packed`) from a JAX packed
    class's state, as numpy arrays: ``kind='kron'`` takes
    `PackedKronBatch.mats` (``Ktx``, ``Kty``, ``KZbd``, ``sxy``, ``szrow``)
    and ``kind='fdm'`` `PackedFDMBatch.mats` (``Vxt``, ``Vx``, ``Vyt``,
    ``Vy``, ``VZTbd``, ``VZbd``, ``dinv``), each with the class's packed
    marker under ``bcp``. The lane layout is undone: the ``NYp`` / ``Zp``
    / ``Bp`` padding is cut off and one diagonal block of each
    block-diagonal z matrix is kept (``KZbd`` holds ``Ktz^T``, ``VZTbd``
    ``Vz`` and ``VZbd`` ``Vz^T``). ``shape`` is the lattice
    ``(NX, NY, NZ)``. The result is the dict the port's class of the same
    kind builds from the mesh."""
    from ..ops.kron_packed import fdm_mats, kron_mats

    NX, NY, NZ = shape
    m = {k: np.asarray(v) for k, v in mats.items()}
    _, NYp, L = m["bcp"].shape
    Zp = 32 if NZ <= 32 else 64  # the JAX packing's lanes per slot

    def lattice(a):
        """Packed ``(NX, NYp, Bp*Zp)`` -> column 0 ``(NX, NY, NZ)``."""
        return a.reshape(NX, NYp, L // Zp, Zp)[:, :NY, 0, :NZ]

    bc = lattice(m["bcp"])
    if kind == "kron":
        return kron_mats(m["Ktx"], m["Kty"][:NY, :NY], m["KZbd"][:NZ, :NZ].T,
                         m["sxy"][:, :NY], m["szrow"][0, :NZ], bc,
                         device=device)
    if kind == "fdm":
        return fdm_mats(m["Vxt"], m["Vx"], m["Vyt"][:NY, :NY],
                        m["Vy"][:NY, :NY], m["VZTbd"][:NZ, :NZ].T,
                        m["VZbd"][:NZ, :NZ].T, lattice(m["dinv"]), bc,
                        device=device)
    raise ValueError(f"kind must be 'kron' or 'fdm', got {kind!r}")
