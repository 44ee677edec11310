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
``dofmap_c``/``dofmap_f``, ``mult_f``). Pass the result to the port's
`PMGHierarchy.load_state` to run its cycles on the JAX state (the
calibrated ``lmax`` included), so cycle parity is tested apart from
calibration parity.

`grid_data_from_numpy` does the same for the device grid: it turns a
numpy copy of the JAX `GridPMG.data` into the data of the port's
`parallel.grid2d.GridPMG` (its `load_state` takes the result).

`packed_state_from_numpy` does the same for the serving classes of
`ops.kron_packed`: it undoes the JAX lane packing of their factors.
"""

import numpy as np
import torch


def _convert(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device, dtype) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype == np.bool_:
        return torch.tensor(arr, device=device)
    if np.issubdtype(arr.dtype, np.integer):
        return torch.tensor(arr, dtype=torch.int64, device=device)
    return torch.tensor(arr, dtype=dtype, device=device)


def hierarchy_data_from_numpy(tree, device, dtype):
    """Port-layout hierarchy data (``levels``, ``transfer``, ``fdm``)
    from a numpy copy of the JAX hierarchy's data tree; float arrays are
    cast to ``dtype``, bool markers stay bool, integer dofmaps become
    int64."""
    out = {
        "levels": _convert(list(tree["levels"]), device, dtype),
        "transfer": _convert(list(tree["transfer"]), device, dtype),
    }
    if "fdm" in tree:
        out["fdm"] = _convert(tree["fdm"], device, dtype)
    return out


# The lattice-shaped arrays of a JAX GridPMG level or transfer: JAX keeps
# them in its global duplicated layout, the port stacks the shards.
_GRID_LATTICE_KEYS = ("bc_marker", "weights", "diag_inv", "weights_f")


def grid_data_from_numpy(tree, grid, device, dtype):
    """The port's `GridPMG` data (``levels``, ``transfer``, ``fdm``) from a
    numpy copy of the JAX `GridPMG.data` (``jax.tree.map(np.asarray,
    grid.data)``). ``grid`` is the port's `GridPMG` (or `GridPartition`)
    of the same mesh and shards. The lattice arrays (``bc_marker``,
    ``weights``, ``diag_inv``, ``weights_f``) go from JAX's global
    duplicated layout ``(sx*nplx, sy*nply, sz*nplz)`` to the stacked
    ``(sx, sy, sz, nplx, nply, nplz)``; the grid-stacked ``kb_mats``, the
    ``K*``/``m*`` factors, the interpolation matrices, ``lmax`` and the
    global ``fdm`` arrays keep their layout. Float arrays are cast to
    ``dtype``."""
    from ..parallel.grid2d import stack_shards

    shards = getattr(grid, "part", grid).shards

    def one(d):
        out = {}
        for k, v in d.items():
            t = _convert(v, device, dtype)
            out[k] = (stack_shards(t, shards) if k in _GRID_LATTICE_KEYS
                      else t)
        return out

    out = {
        "levels": [one(lv) for lv in tree["levels"]],
        "transfer": [one(tr) for tr in tree["transfer"]],
    }
    if "fdm" in tree:
        out["fdm"] = _convert(tree["fdm"], device, dtype)
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
