"""Matrix-free Laplacian on UNSTRUCTURED hex topology: the DSS path.

Port of `pmg_dolfinx_tpu.ops.unstructured`: the reference's topology-
agnostic gather -> per-cell sum-factorised apply -> scatter
(src/laplacian.hpp:143-278) on the entity-blocked dof numbering of
`fem.unstructured._build_dss` (``[cell interiors | face interiors | edge
interiors | vertices]``, the mesh's canonical numbering, shared by every
backend). What the user sees is the JAX package's: the same numbering,
zero-on-gather and identity-row Dirichlet semantics, and the same
owner-first, fixed-order sums over each shared entity's cells, so the f64
results equal JAX's bit for bit.

The JAX form is built around a TPU weakness: element gathers there cost
~7 cycles each, so it moves rows of >= 8 lanes (padded face / edge rows,
width-8 replicated vertex rows), orients shared faces by variant-sorted
slices and maps block order to lattice order by a one-hot matmul. A GPU
gathers elements at memory speed, so the port folds all of that into
index tables built once from the layout (`dss_device_tables`):

- gather: one index gather through the ``(nc * n^3,)`` table of every
  cell node's dof (the orientation and the block -> lattice permutation
  are permutations, so they fold into the table: it IS the DSS dofmap);
- scatter: per entity class (interiors, faces, edges, vertices) one
  gather of its ``(rows, K)`` source table from the cell results (flat
  lattice positions, owner first, padded with a zero slot), then the K
  columns summed left to right; no atomics, so the f32 sums are the same
  on every run.

The cell contraction between them is `ops.laplacian.laplacian_apply_cells`
(torch einsums, TF32 off). No CUDA kernel here: JAX writes no Pallas
kernel for this path either (static-shape XLA).
"""

from typing import NamedTuple

import numpy as np
import torch

from ..fem.unstructured import VAR1D, VAR2D
from .laplacian import laplacian_apply_cells


class DSSMeta(NamedTuple):
    """Static sizes of a DSS layout, carried on `Level.dss`. ``Wf`` /
    ``We`` (the JAX form's padded row widths) and ``vslices`` (its
    per-variant slice counts) are kept with JAX's values so the meta
    compares equal; the port's tables need neither."""

    nc: int
    P: int
    m: int
    n_int: int
    nF: int
    nE: int
    nV: int
    Wf: int
    We: int
    vslices: tuple | None = None


def _padw(w):
    return max(8, -(-w // 8) * 8)


def dss_meta(layout) -> DSSMeta:
    m = layout["m"]
    vsl = None
    if m > 1:
        vsl = tuple(
            tuple(int(c) for c in np.bincount(layout[k].ravel(),
                                              minlength=nv))
            for k, nv in (("face_var", 8), ("face_inv", 8),
                          ("edge_var", 2), ("edge_inv", 2)))
    return DSSMeta(
        nc=layout["nc"], P=layout["P"], m=m, n_int=layout["n_int"],
        nF=layout["nF"], nE=layout["nE"], nV=layout["nV"],
        Wf=_padw(m * m), We=_padw(m), vslices=vsl,
    )


def _variant_maps(variants, shape):
    """``maps[v][s]``: the source index of entry ``s`` after variant ``v``
    (``T(a).ravel() == a.ravel()[maps[v]]``)."""
    a = np.arange(int(np.prod(shape))).reshape(shape)
    return np.stack([np.asarray(T(a)).ravel() for T in variants])


def _tables_np(layout):
    """Host (numpy int64) index tables of the port's DSS apply from a
    `fem.unstructured` layout: ``gather`` ``(nc, n^3)`` (the dof of every
    cell node, lattice order) and ``src`` (the list of per-class
    ``(rows, K)`` scatter sources: flat ``cell * n^3 + node`` positions,
    owner first, padded with ``nc * n^3``), their rows in dof order."""
    P, m, nc = layout["P"], layout["m"], layout["nc"]
    n = P + 1
    n3 = n ** 3
    n_int, nF, nE = layout["n_int"], layout["nF"], layout["nE"]
    perm = np.asarray(layout["perm_lat"], dtype=np.int64)
    o_f = n_int
    o_e = o_f + nF * m * m
    o_v = o_e + nE * m
    cells = np.arange(nc, dtype=np.int64)
    pad = nc * n3
    # block-order columns: interiors m^3 | faces 6 m^2 | edges 12 m | 8
    c_f, c_e = m ** 3, m ** 3 + 6 * m * m
    c_v = c_e + 12 * m
    blk = np.empty((nc, n3), dtype=np.int64)
    blk[:, :c_f] = cells[:, None] * m ** 3 + np.arange(m ** 3)
    src = [(cells[:, None] * n3 + perm[None, :c_f]).reshape(-1, 1)]
    if m:
        fmap = _variant_maps(VAR2D, (m, m))
        fid = layout["face_id"].astype(np.int64)
        # local = VAR2D[var](canonical)
        blk[:, c_f:c_e] = (o_f + fid[:, :, None] * m * m
                           + fmap[layout["face_var"]]).reshape(nc, -1)
        emap = _variant_maps(VAR1D, (m,))
        eid = layout["edge_id"].astype(np.int64)
        blk[:, c_e:c_v] = (o_e + eid[:, :, None] * m
                           + emap[layout["edge_var"]]).reshape(nc, -1)
        # canonical = VAR[inv](local): the local entry each canonical one
        # reads, as a flat lattice position of the sharing cell
        for width, ents, nloc, col0, imap, key in (
                (m * m, nF, 6, c_f, fmap, "face"),
                (m, nE, 12, c_e, emap, "edge")):
            inv = layout[key + "_inv"].reshape(-1)
            loc = (col0 + np.arange(nloc)[:, None] * width)  # (nloc, 1)
            pos = (np.repeat(cells, nloc)[:, None] * n3
                   + perm[(loc[np.tile(np.arange(nloc), nc)]
                           + imap[inv])])            # (nc*nloc, width)
            pos = np.concatenate([pos, np.full((1, width), pad)])
            s = layout[key + "_src"].astype(np.int64)  # pad = nc * nloc
            src.append(pos[s].transpose(0, 2, 1).reshape(ents * width, -1))
    blk[:, c_v:] = o_v + layout["vert_id"].astype(np.int64)
    vpos = np.concatenate([(cells[:, None] * n3 + perm[None, c_v:]
                            ).reshape(-1), [pad]])
    src.append(vpos[layout["vert_src"].astype(np.int64)])
    gather = np.empty_like(blk)
    gather[:, perm] = blk
    return gather, src


def dss_device_tables(layout, dtype=torch.float64, *, device) -> dict:
    """Device copies of the index tables the apply reads (int64 on
    ``device``): ``gather`` ``(nc * n^3,)`` and ``src_0..src_3`` (or fewer:
    classes with no rows are left out), one ``(rows, K)`` scatter source
    per entity class, plus ``own`` ``(ndofs,)``, every dof's owner
    position (the owner-write scatter). ``dtype`` keeps the JAX
    function's slot (its one-hot permutation matrix's dtype); the port's
    tables are integer."""
    gather, src = _tables_np(layout)
    idx = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                    dtype=torch.int64, device=device)
    t = {"gather": idx(gather.reshape(-1)),
         "own": idx(np.concatenate([s[:, 0] for s in src]))}
    for i, s in enumerate(src):
        if len(s):
            t[f"src_{i}"] = idx(s)
    return t


def dss_gather(x, t, meta):
    """Continuous dof vector ``(ndofs,)`` -> cell slabs ``(nc, n, n, n)``
    (the reference gather, src/laplacian.hpp:182-189): one index gather
    through ``t["gather"]``."""
    n = meta.P + 1
    return x.index_select(0, t["gather"]).reshape(-1, n, n, n)


def dss_scatter(yc, t, meta, first=False):
    """Cell slabs ``(nc, n, n, n)`` -> continuous dof vector: each dof sums
    its sharers' cell values, owner first, left to right (the reference's
    atomicAdd scatter, src/laplacian.hpp:272-277, in a fixed order).
    ``first=True`` takes the owner's value only, exact for
    value-consistent fields (prolongation writes identical values from
    every sharer).

    Stacked tables (`parallel.dss_dist.stacked_tables`: ``src_i`` ``(S,
    rows, K)``, ``own`` ``(S, ndl)``, padding rows at the zero slot) give
    the shards' sums shard-major, each shard's classes in turn."""
    flat = yc.reshape(-1)
    stacked = t["own"].dim() == 2
    if first and not stacked:
        return flat.index_select(0, t["own"])
    flat = torch.cat([flat, flat.new_zeros(1)])
    if first:
        return flat.index_select(0, t["own"].reshape(-1))
    parts = []
    for i in range(4):
        s = t.get(f"src_{i}")
        if s is None:
            continue
        g = flat.index_select(0, s.reshape(-1)).reshape(s.shape)
        acc = g[..., 0]
        for k in range(1, s.shape[-1]):
            acc = acc + g[..., k]
        parts.append(acc)
    return torch.cat(parts, dim=-1).reshape(-1)


def apply_cells(u_cells, G, coeff, D, precision="highest"):
    """Cell-local stiffness action (`ops.laplacian.laplacian_apply_cells`);
    ``precision`` keeps the JAX slot (either value, true f32/f64: the
    XLA-path rule of `ops.kron_blocked`)."""
    from .kron_blocked import _check_precision

    _check_precision(precision)
    return laplacian_apply_cells(u_cells, G, coeff, D)


def dss_laplacian_apply(x, lv, meta, precision="highest", sigma=0.0,
                        apply_bc=True):
    """Full matrix-free ``y = A x`` on the DSS dof vector. ``lv`` holds the
    index tables plus ``G (nc, n^3, 6)``, ``coeff (nc,)``, ``D (n, n)``,
    ``bc_marker`` and (when ``sigma``) the bc-zeroed lumped mass ``m3``.
    Semantics of `ops.laplacian.laplacian_apply` (bc zero on gather,
    identity rows)."""
    bc = lv["bc_marker"]
    xb = torch.where(bc, torch.zeros_like(x), x)
    u = dss_gather(xb, lv, meta)
    yc = apply_cells(u, lv["G"], lv["coeff"], lv["D"], precision=precision)
    y = dss_scatter(yc, lv, meta)
    if sigma:
        y = y + sigma * lv["m3"] * x
    if not apply_bc:
        return y
    return torch.where(bc, x, y)


def dss_prolongate(xc, M1, lv_c, meta_c, lv_f, meta_f,
                   precision="highest"):
    """Coarse->fine p-transfer: cell-gather coarse, per-cell 1D-Kronecker
    interpolation, owner-write fine (the C0 interpolant; the semantics of
    `ops.interpolate.prolongate`)."""
    u = dss_gather(xc, lv_c, meta_c)
    v = torch.einsum("ai,bj,ck,xijk->xabc", M1, M1, M1, u)
    return dss_scatter(v, lv_f, meta_f, first=True)


def dss_restrict(xf, M1, lv_f, meta_f, lv_c, meta_c, inv_mult_f,
                 precision="highest"):
    """Fine->coarse multiplicity-weighted transpose transfer (the
    semantics of `ops.interpolate.restrict`)."""
    u = dss_gather(xf * inv_mult_f, lv_f, meta_f)
    v = torch.einsum("ai,bj,ck,xabc->xijk", M1, M1, M1, u)
    return dss_scatter(v, lv_c, meta_c)
