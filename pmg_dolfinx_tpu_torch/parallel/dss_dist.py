"""Distributed p-multigrid on UNSTRUCTURED hex meshes (the DSS backend),
every shard stacked on one device.

Port of `pmg_dolfinx_tpu.parallel.dss_dist`. The JAX package runs
`DSSDist` as one ``shard_map`` program: the cells are split into
contiguous ranges padded with dummy cells to a common count, each shard
holds the faces, edges and vertices its cells touch (entities on a shard
boundary duplicated on every touching shard, in the global canonical
orientation), the DSS apply runs on shard-local tables, and after every
overlap-add the shared entities' partial sums are reconciled: each shard
gathers its partials into a global shared-slot buffer (zero where it does
not touch a slot), one ``psum`` sums them, and the totals are gathered
back onto the shared rows. Prolongation needs no exchange (duplicates
compute equal values); dots are ownership-weighted (owner = the shard of
an entity's first global sharer).

Layout. The port stacks the ``S`` shards on one device: a distributed
vector is ONE flat tensor ``(S * ndl,)``, shard-major, value for value
JAX's ``to_dist`` layout (each shard's ``ndl`` local dofs: interiors
cell-major, then faces, edges and vertices, each class padded to the
largest shard's count; padding dofs have ``l2g = -1``, weight 0 and are
Dirichlet rows). Each shard's local layout (a dict in `fem.unstructured`'s
layout format) goes through the single device's own table builder
(`ops.unstructured._tables_np`) and the results are stacked with per-shard
offsets, so ONE index gather and one scatter (``(S, rows, K)`` source
tables, the sums landing shard-major) cover all shards; the cell
contraction runs once over the ``S * ncl`` cells. The dummy cells have
zero geometry, coefficient and Schwarz blocks: they gather real local
dofs, apply zero and no scatter source names them.

The seam. The exchange's sum over shards and the ``direct`` coarse
solve's gather are `StackedGrid.psum`; dots are `StackedGrid.dot`. The
pack and unpack are index gathers on the stacked vector.

Host setup. `DSSPartition` builds JAX's per-shard tables (the same
entity order, sharer lists, pack / unpack, shared and owned flags; `l2g`,
weights and bc equal array for array) with numpy grouping instead of
JAX's per-entity Python loops. The JAX form's TPU row-layout devices
(``_pad_cols`` / ``_padw`` row padding, ``perm_matrix``, the variant
bit-planes) have no counterpart: the port's tables fold them in.

`DSSDist` takes JAX's arguments: smoothers ``cheb`` (point Jacobi) and
``schwarz`` (cell-local blocks, their overlap-add exchanged); coarse
solves ``cg`` (distributed), ``direct`` (the dense Cholesky of the global
coarse matrix, gathered through ``psum``) and ``smoother``; a scalar,
DG-0 or tensor kappa and a scalar sigma. As in JAX, a mesh without a DSS
layout, ``coarse="amg"`` and a sigma field raise ValueError. Across
processes (``devices=``, `multihost`) each rank cuts its shards' tables
and per-cell arrays from the host partition and the exchange's ``psum``
adds the ranks' sums. ``precision`` passes to the DSS apply (its torch
ops compute either value in f32/f64, the XLA-path rule of
`ops.kron_blocked`). JAX's ``pvary`` and
``make_mesh`` have no counterpart (no device mesh).
"""

import numpy as np
import torch

from ..ops.kron_blocked import _check_precision
from ..ops.unstructured import (
    DSSMeta,
    _padw,
    _tables_np,
    apply_cells,
    dss_gather,
    dss_prolongate,
    dss_restrict,
    dss_scatter,
)
from ..solvers.cg import cg_solve
from ..solvers.pmg import (
    DEFAULT_CALIBRATION_ITERS,
    DEFAULT_CALIBRATION_RTOL,
    DEFAULT_SMOOTHER_ITERS,
    EIG_RANGE_FACTORS,
    Level,
    _level_precond,
    _merge_state,
    v_cycle,
)
from ..solvers.tridiag import lanczos_eigenvalue_estimates

_KINDS = (("face", 6), ("edge", 12), ("vert", 8))


# -- host-side partition ------------------------------------------------


def _entity_partition(global_id, global_src, n_ent, nloc_cf, cell_shard,
                      n_shards):
    """Per-shard local tables for one entity kind (JAX's tables, built by
    grouping rather than per-entity loops).

    ``global_id (nc, nloc)`` entity index per cell slot; ``global_src
    (n_ent, K)`` global sharer table (flat cellface = cell * nloc + loc,
    padded with ``nc * nloc``); ``cell_shard (nc,)`` shard of every cell.
    Returns (a list of per-shard dicts: ``ents`` the local entities'
    global ids ascending, ``local_id`` ``(ncl_s, nloc)``, ``src`` the
    local sharer lists in global sharer order padded with -1, ``pack``
    the local index of every shared entity or -1, ``unpack`` every local
    entity's shared slot or -1, ``is_shared``, ``owned``; the number of
    shared entities)."""
    del nloc_cf
    global_id = np.asarray(global_id)
    nc, nloc = global_id.shape
    cell_shard = np.asarray(cell_shard)
    src = np.asarray(global_src, dtype=np.int64)
    pad = nc * nloc
    valid = src != pad
    cell = np.where(valid, src, 0) // nloc
    sh = np.where(valid, cell_shard[cell], -1)
    lo = np.where(valid, sh, n_shards).min(axis=1)
    shared_mask = lo != sh.max(axis=1)
    shared = np.nonzero(shared_mask)[0]
    slot = np.full(n_ent, -1, dtype=np.int64)
    slot[shared] = np.arange(len(shared))
    owner = cell_shard[src[:, 0] // nloc] if n_ent else np.zeros(0, int)

    out = []
    for s in range(n_shards):
        cells_s = np.nonzero(cell_shard == s)[0]
        ids_s = global_id[cells_s]
        loc_ents, inv = np.unique(ids_s.ravel(), return_inverse=True)
        local_id = inv.reshape(ids_s.shape).astype(np.int64)
        nEl = len(loc_ents)
        cmap = np.full(nc, -1, dtype=np.int64)
        cmap[cells_s] = np.arange(len(cells_s))
        mine = valid[loc_ents] & (sh[loc_ents] == s)
        rows = src[loc_ents]
        lcf = np.where(mine, cmap[cell[loc_ents]] * nloc + rows % nloc, -1)
        # each row's local sharers moved left, in global sharer order
        order = np.argsort(~mine, axis=1, kind="stable")
        lcf = np.take_along_axis(lcf, order, axis=1)
        Kl = int(mine.sum(axis=1).max()) if nEl else 1
        pos = np.searchsorted(loc_ents, shared)
        hit = pos < nEl
        hit[hit] = loc_ents[pos[hit]] == shared[hit]
        out.append(dict(
            ents=loc_ents, local_id=local_id,
            src=np.ascontiguousarray(lcf[:, :Kl]),
            pack=np.where(hit, pos, -1).astype(np.int64),
            unpack=slot[loc_ents],
            is_shared=shared_mask[loc_ents],
            owned=owner[loc_ents] == s,
        ))
    return out, len(shared)


def _pad_stack(arrs, fill):
    """Stack variable-size per-shard arrays padded with ``fill`` to a
    common shape; returns (stacked, sizes)."""
    sizes = [a.shape[0] for a in arrs]
    m = max(sizes) if sizes else 0
    rest = arrs[0].shape[1:]
    out = np.full((len(arrs), m) + rest, fill, dtype=arrs[0].dtype)
    for i, a in enumerate(arrs):
        out[i, :a.shape[0]] = a
    return out, sizes


class DSSPartition:
    """Host-side cell partition and per-shard DSS tables for each degree.

    Cells are split into ``n_shards`` contiguous ranges padded with dummy
    cells to a common count ``ncl``. ``tables(P)`` returns JAX's per-degree
    ``meta`` (the per-shard `DSSMeta`), ``ndl``, ``l2g``, ``weights`` and
    ``bc`` (``(S, ndl)`` each), plus the port's ``layouts`` (each shard's
    local layout, `fem.unstructured`'s format) and ``xslot`` ``(S, ndl)``
    (each local dof's global shared-slot index, -1 where not shared, and
    ``nshd`` slots in all)."""

    def __init__(self, mesh, n_shards):
        self.mesh = mesh
        self.n_shards = int(n_shards)
        nc = mesh.ncells
        base, extra = divmod(nc, self.n_shards)
        counts = [base + (i < extra) for i in range(self.n_shards)]
        self.cell_shard = np.repeat(np.arange(self.n_shards), counts)
        self.ncl = max(counts)          # padded per-shard cell count
        self.counts = counts
        # the global cell of every stacked cell slot, -1 for dummy cells
        slots = np.full((self.n_shards, self.ncl), -1, dtype=np.int64)
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        for s, (c0, k) in enumerate(zip(start, counts)):
            slots[s, :k] = np.arange(c0, c0 + k)
        self.slot_cells = slots.reshape(-1)
        self._per_degree = {}

    def per_cell(self, a):
        """A per-cell array ``(nc, ...)`` on the stacked cell slots
        ``(S * ncl, ...)``, zero on the dummy cells."""
        a = np.asarray(a)
        out = np.zeros((len(self.slot_cells),) + a.shape[1:], dtype=a.dtype)
        real = self.slot_cells >= 0
        out[real] = a[self.slot_cells[real]]
        return out

    def tables(self, Pdeg):
        if Pdeg in self._per_degree:
            return self._per_degree[Pdeg]
        mesh = self.mesh
        lt = mesh.dss_layout(Pdeg)
        m = lt["m"]
        S, ncl = self.n_shards, self.ncl
        kinds = {}
        for kind, nloc in _KINDS:
            if kind != "vert" and m == 0:
                continue
            kinds[kind] = _entity_partition(
                lt[f"{kind}_id"], lt[f"{kind}_src"], lt[f"n{kind[0].upper()}"],
                nloc, self.cell_shard, S)
        npad = {k: max(p["ents"].shape[0] for p in per)
                for k, (per, _) in kinds.items()}
        nFl, nEl, nVl = npad.get("face", 0), npad.get("edge", 0), npad["vert"]
        meta = DSSMeta(nc=ncl, P=Pdeg, m=m, n_int=ncl * m ** 3, nF=nFl,
                       nE=nEl, nV=nVl, Wf=_padw(m * m), We=_padw(m))
        ndl = meta.n_int + nFl * m * m + nEl * m + nVl
        width = dict(face=m * m, edge=m, vert=1)
        offs_l = dict(face=meta.n_int, edge=meta.n_int + nFl * m * m,
                      vert=meta.n_int + nFl * m * m + nEl * m)
        offs_g = dict(face=lt["nc"] * m ** 3,
                      edge=lt["nc"] * m ** 3 + lt["nF"] * m * m,
                      vert=lt["nc"] * m ** 3 + lt["nF"] * m * m
                      + lt["nE"] * m)
        w = np.zeros((S, ndl))
        l2g = np.full((S, ndl), -1, dtype=np.int64)
        xslot = np.full((S, ndl), -1, dtype=np.int64)
        slot0 = 0
        for kind, (per, nsh) in kinds.items():
            wd = width[kind]
            for s, p in enumerate(per):
                lo = offs_l[kind]
                n = len(p["ents"])
                sl = slice(lo, lo + n * wd)
                l2g[s, sl] = (offs_g[kind] + p["ents"][:, None].astype(
                    np.int64) * wd + np.arange(wd)).reshape(-1)
                w[s, sl] = np.repeat(p["owned"].astype(np.float64), wd)
                xslot[s, sl] = np.where(
                    np.repeat(p["unpack"], wd) >= 0,
                    slot0 + (p["unpack"][:, None] * wd
                             + np.arange(wd)).reshape(-1), -1)
            slot0 += nsh * wd
        # interiors of the real cells, cell-major
        shard_cells = [np.nonzero(self.cell_shard == s)[0] for s in range(S)]
        for s, cs in enumerate(shard_cells):
            nreal = len(cs) * m ** 3
            l2g[s, :nreal] = (cs[:, None] * m ** 3
                              + np.arange(m ** 3)).reshape(-1)
            w[s, :nreal] = 1.0
        marker = np.asarray(mesh.boundary_dof_marker(Pdeg))
        bcl = np.ones((S, ndl), dtype=bool)
        sel = l2g >= 0
        bcl[sel] = marker[l2g[sel]]

        # Each shard's local layout: its cells' local entity ids and the
        # global orientation rows (zero for dummy cells, whose slots no
        # source names), the local sharer lists padded to the common
        # entity count.
        layouts = [dict(perm_lat=lt["perm_lat"], P=Pdeg, m=m, nc=ncl,
                        n_int=meta.n_int, nF=nFl, nE=nEl, nV=nVl)
                   for _ in range(S)]
        for key in ("face_var", "face_inv", "edge_var", "edge_inv"):
            rows, _ = _pad_stack([lt[key][cs] for cs in shard_cells], 0)
            for loc, a in zip(layouts, rows):
                loc[key] = a
        for kind, nloc in _KINDS:
            if kind not in kinds:
                for loc in layouts:
                    loc[f"{kind}_id"] = np.zeros((ncl, nloc), np.int64)
                    loc[f"{kind}_src"] = np.zeros((0, 1), np.int64)
                continue
            per = kinds[kind][0]
            ids, _ = _pad_stack([p["local_id"] for p in per], 0)
            for loc, p, a in zip(layouts, per, ids):
                src = np.full((npad[kind], p["src"].shape[1]), ncl * nloc,
                              dtype=np.int64)
                src[:len(p["src"])] = np.where(p["src"] < 0, ncl * nloc,
                                               p["src"])
                loc[f"{kind}_id"] = a
                loc[f"{kind}_src"] = src

        out = dict(meta=meta, ndl=ndl, l2g=l2g, weights=w, bc=bcl,
                   layouts=layouts, xslot=xslot, nshd=slot0)
        self._per_degree[Pdeg] = out
        return out

    # -- vector converters (host) --------------------------------------

    def to_dist(self, Pdeg, u):
        t = self.tables(Pdeg)
        u = np.asarray(u).reshape(-1)
        out = np.zeros((self.n_shards, t["ndl"]), dtype=u.dtype)
        sel = t["l2g"] >= 0
        out[sel] = u[t["l2g"][sel]]
        return out.reshape(-1)

    def from_dist(self, Pdeg, ud):
        t = self.tables(Pdeg)
        ud = np.asarray(ud).reshape(self.n_shards, t["ndl"])
        out = np.zeros(self.mesh.num_dofs(Pdeg), dtype=ud.dtype)
        sel = (t["l2g"] >= 0) & (t["weights"] > 0.5)
        out[t["l2g"][sel]] = ud[sel]
        return out


def stacked_tables(t, *, device):
    """The device tables of one degree on the stacked layout (int64 on
    ``device``): ``gather`` ``(S * ncl * n^3,)`` into the stacked vector,
    the scatter sources ``src_i`` ``(S, rows, K)`` and ``own`` ``(S,
    ndl)`` into the stacked cell results with one zero slot appended
    (`ops.unstructured.dss_scatter`'s stacked form), and the exchange's
    ``x_pack`` / ``x_ok`` ``(S * nshd,)`` (each shard's row of the
    shared-slot buffer: the stacked position of its copy of each slot, or
    none) and ``x_pos`` / ``x_slot`` (every shared local dof's stacked
    position and slot)."""
    layouts, ndl = t["layouts"], t["ndl"]
    S = len(layouts)
    per = [_tables_np(lt) for lt in layouts]
    cells = per[0][0].size                 # ncl * n^3 cell nodes a shard
    zero = S * cells
    gather = np.concatenate([g.reshape(-1) + s * ndl
                             for s, (g, _) in enumerate(per)])
    idx = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                    dtype=torch.int64, device=device)
    out = {"gather": idx(gather)}
    owners = []
    for i in range(len(per[0][1])):
        srcs = [p[1][i] for p in per]
        rows = srcs[0].shape[0]
        if not rows:
            continue
        K = max(a.shape[1] for a in srcs)
        st = np.full((S, rows, K), zero, dtype=np.int64)
        for s, a in enumerate(srcs):
            st[s, :, :a.shape[1]] = np.where(a == cells, zero, a + s * cells)
        out[f"src_{i}"] = idx(st)
        owners.append(st[:, :, 0])
    out["own"] = idx(np.concatenate(owners, axis=1))
    xs = t["xslot"].reshape(-1)
    pos = np.nonzero(xs >= 0)[0]
    nshd = t["nshd"]
    pack = np.zeros(S * nshd, dtype=np.int64)
    ok = np.zeros(S * nshd, dtype=bool)
    dst = (pos // ndl) * nshd + xs[pos]
    pack[dst] = pos
    ok[dst] = True
    out.update(x_pack=idx(pack), x_ok=torch.as_tensor(ok, device=device),
               x_pos=idx(pos), x_slot=idx(xs[pos]))
    return out


# -- device-side exchange ----------------------------------------------


def dss_exchange(y, t, meta, *, grid):
    """Reconcile the shared-entity partial sums of a stacked DSS dof vector
    ``y`` (a fresh overlap-add result, written in place and returned):
    each shard's partials gathered into its row of the global shared-slot
    buffer (zero where it does not touch a slot), `StackedGrid.psum` over
    the shards, the totals gathered back onto every shared local dof."""
    if t["x_pos"].numel() == 0:
        return y
    buf = torch.where(t["x_ok"], y.index_select(0, t["x_pack"]), 0.0)
    tot = grid.psum(buf.view(grid.block + (-1,)))
    return y.index_copy_(0, t["x_pos"], tot.index_select(0, t["x_slot"]))


def dss_dist_cycle_ops(precision="highest", sigma=0.0, *, grid):
    """Sharded V-cycle primitives for the DSS backend on the stacked
    layout: the single device's gather / cell contraction / scatter on the
    stacked tables, the shared-entity exchange after every overlap-add
    (apply, restrict and the Schwarz smoother's, through
    ``dss_exchange``); ``grid`` the `StackedGrid` of the shards (or a
    rank's `multihost.RankGrid`, whose block is the local shard count)."""
    from ..ops.kron_blocked import _check_precision

    _check_precision(precision)
    S = grid.block[0]
    exchange = lambda y, t, meta: dss_exchange(y, t, meta, grid=grid)

    def apply_op(lv, x, level):
        bc = lv["bc_marker"]
        xb = torch.where(bc, torch.zeros_like(x), x)
        u = dss_gather(xb, lv, level.dss)
        yc = apply_cells(u, lv["G"], lv["coeff"], lv["D"])
        y = exchange(dss_scatter(yc, lv, level.dss), lv, level.dss)
        if sigma:
            y = y + sigma * lv["m3"] * x
        return torch.where(bc, x, y)

    def restrict_op(tr, r, level_c, level_f):
        raw = dss_restrict(r, tr["M1"], tr["tf"], level_f.dss, tr["tc"],
                           level_c.dss, tr["inv_mult_f"])
        return exchange(raw, tr["tc"], level_c.dss)

    def prolong_op(tr, u, level_c, level_f):
        # Duplicated entities compute equal values on every touching shard
        # (consistent coarse duplicates): no exchange.
        return dss_prolongate(u, tr["M1"], tr["tc"], level_c.dss, tr["tf"],
                              level_f.dss)

    return dict(
        apply=apply_op,
        restrict=restrict_op,
        prolong=prolong_op,
        dot=lambda u, v, lv: grid.dot(u, v, lv["weights"]),
        zeros=lambda level, like: torch.zeros(
            S * level.ndofs, dtype=like.dtype, device=like.device),
        dss_exchange=exchange,
    )


class DSSDist:
    """Multi-shard p-multigrid on an UNSTRUCTURED hex mesh (DSS backend),
    every shard stacked on one device (``device``, CUDA unless the caller
    asks for the CPU).

    The JAX package's signature. ``n_devices`` is the number of shards
    (None: one shard), stacked on ``device``, or with a process group up
    spread over the ranks as `DistPMG`'s slabs are (``devices``: the rank
    of each shard). Coarse solvers: ``"cg"`` (fully
    distributed), ``"direct"`` (the gathered dense Cholesky, solved once)
    or ``"smoother"``; smoothers: ``"cheb"`` (point Jacobi) or
    ``"schwarz"`` (cell-local blocks + exchange); ``kappa`` a scalar, a
    DG-0 array or callable, or a tensor (folded into the geometry
    factors); ``sigma`` a scalar. Vectors in and out of `solve` /
    `solve_pcg` are global flat vectors (numpy or tensors in, tensors on
    ``device`` out); `apply` and `operator` take the stacked layout of
    `to_dist`."""

    def __init__(self, mesh, n_devices=None, degrees=(1, 3), kappa=2.0,
                 dtype=torch.float64, smoother_iters=DEFAULT_SMOOTHER_ITERS,
                 coarse="cg", coarse_cfg=None, devices=None,
                 calibration_iters=DEFAULT_CALIBRATION_ITERS,
                 precision="highest", sigma=0.0, smoother="cheb", *,
                 device="cuda"):
        from ..fem.assembly import (
            geometry_factors_np,
            resolve_kappa_split,
            resolve_sigma,
            shifted_mass_np,
            stiffness_diagonal_np,
        )
        from ..fem.gll import derivative_matrix, interpolation_matrix_1d

        if not hasattr(mesh, "dss_layout"):
            raise ValueError("DSSDist needs an UnstructuredHexMesh")
        if coarse not in ("cg", "direct", "smoother"):
            raise ValueError(
                "DSSDist coarse must be 'cg', 'direct' or 'smoother' "
                "('amg' is single-device)")
        if smoother not in ("cheb", "schwarz"):
            raise ValueError(
                f"DSSDist smoother must be 'cheb' or 'schwarz', got "
                f"{smoother!r}")
        _check_precision(precision)
        self.sigma, sigma_field = resolve_sigma(sigma)
        if sigma_field is not None:
            raise ValueError("DSSDist supports a scalar sigma only")
        self.n_shards = S = int(n_devices or 1)
        self.part = DSSPartition(mesh, S)
        self.mesh = mesh
        self.degrees = tuple(int(p) for p in degrees)
        self.dtype = dtype
        self.device = torch.device(device)
        from .multihost import layout_grid

        # every shard stacked here, or this rank's block of them: a rank
        # cuts its shards' tables and per-cell arrays on the host
        self.grid = layout_grid((S, 1, 1), devices, device=self.device)
        lo, nb = self.grid.origin[0], self.grid.block[0]
        # this rank's rows of a stacked per-cell (S * ncl, ...) array
        cells = lambda a: a[lo * self.part.ncl:(lo + nb) * self.part.ncl]
        self._kc, self._kappa_fold, _ = resolve_kappa_split(mesh, kappa)
        self.kappa_cells = (self._kappa_fold
                            if self._kappa_fold is not None else self._kc)
        self.coarse = coarse
        self.coarse_cfg = dict(coarse_cfg or {})
        self.eigs = []
        ops = dss_dist_cycle_ops(precision, sigma=self.sigma, grid=self.grid)
        self._ops = ops
        part, dev = self.part, self.device
        tensor = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                           dtype=dtype, device=dev)

        self._vec = []     # per level: (l2g clamped, real, own pos, own l2g)
        level_data, levels = [], []
        for Pdeg in self.degrees:
            t = self._tables(Pdeg)
            meta, ndl = t["meta"], t["ndl"]
            n = Pdeg + 1
            l2g = t["l2g"]
            sel = l2g >= 0
            G_cells, _ = geometry_factors_np(mesh, Pdeg,
                                             kappa=self._kappa_fold)
            lv = stacked_tables(t, device=dev)
            lv.update(
                G=tensor(cells(part.per_cell(G_cells))),
                coeff=tensor(cells(part.per_cell(self._kc))),
                D=tensor(derivative_matrix(Pdeg)),
                bc_marker=torch.as_tensor(t["bc"].reshape(-1), device=dev),
                weights=tensor(t["weights"].reshape(-1)),
            )
            dg = stiffness_diagonal_np(mesh, Pdeg, self.kappa_cells)
            if self.sigma:
                m3g = shifted_mass_np(mesh, Pdeg, None)
                dg = dg + self.sigma * m3g
                m3l = np.zeros((nb, ndl))
                m3l[sel] = np.where(t["bc"][sel], 0.0, m3g[l2g[sel]])
                lv["m3"] = tensor(m3l.reshape(-1))
            dl = np.ones((nb, ndl))
            dl[sel] = np.where(t["bc"][sel], 1.0, dg[l2g[sel]])
            lv["diag_inv"] = tensor(1.0 / dl.reshape(-1))
            if smoother == "schwarz":
                from ..solvers.schwarz_dss import build_schwarz_dss

                sw = build_schwarz_dss(mesh, Pdeg, kappa, dtype,
                                       sigma=self.sigma, device="cpu")
                # w from the GLOBAL multiplicity through l2g (0 on padding)
                wl = np.zeros((nb, ndl))
                wl[sel] = sw["w"].double().numpy()[l2g[sel]]
                lv["schwarz"] = dict(
                    V=tensor(cells(part.per_cell(sw["V"].double().numpy()))),
                    ginv=tensor(cells(part.per_cell(
                        sw["ginv"].double().numpy()))),
                    w=tensor(wl.reshape(-1)), bc=lv["bc_marker"])
            level = Level(P=Pdeg, ndofs=ndl, smoother_iters=smoother_iters,
                          dss=meta)
            own = np.nonzero((sel & (t["weights"] > 0.5)).reshape(-1))[0]
            idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)
            self._vec.append((idx(np.where(sel, l2g, 0).reshape(-1)),
                              torch.as_tensor(sel.reshape(-1), device=dev),
                              idx(own), idx(l2g.reshape(-1)[own])))
            # Smoother calibration as JAX runs it distributed: recorded CG
            # on A x = 1 from 0, preconditioned as the smoother is,
            # Lanczos, lmax inflated by 1.1.
            ones = tensor(sel.reshape(-1).astype(np.float64))
            _, info = cg_solve(
                lambda x, _lv=lv, _level=level: ops["apply"](_lv, x, _level),
                ones, torch.zeros_like(ones), lv["diag_inv"],
                rtol=DEFAULT_CALIBRATION_RTOL, maxiter=calibration_iters,
                record=True, dot=lambda u, v, _lv=lv: ops["dot"](u, v, _lv),
                precond=_level_precond(lv, level, ops),
            )
            eigs = lanczos_eigenvalue_estimates(
                info["alphas"].cpu().numpy(), info["betas"].cpu().numpy(),
                info["stored"].cpu().numpy())
            self.eigs.append(eigs)
            lv["lmax"] = torch.tensor(EIG_RANGE_FACTORS[1] * eigs[-1],
                                      dtype=dtype, device=dev)
            level_data.append(lv)
            levels.append(level)
        self.levels = tuple(levels)

        transfer = []
        for i in range(len(self.degrees) - 1):
            Pc, Pf = self.degrees[i], self.degrees[i + 1]
            tf = self._tables(Pf)
            sel = tf["l2g"] >= 0
            inv_mult = np.zeros(sel.shape)
            inv_mult[sel] = 1.0 / np.asarray(
                mesh.dof_multiplicity(Pf))[tf["l2g"][sel]]
            transfer.append(dict(
                M1=tensor(interpolation_matrix_1d(Pc, Pf)),
                tc=level_data[i], tf=level_data[i + 1],
                inv_mult_f=tensor(inv_mult.reshape(-1))))
        self.data = dict(levels=level_data, transfer=transfer)

        if coarse == "direct":
            from ..solvers.pmg import dense_cholesky

            self.data["coarse_chol"] = tensor(dense_cholesky(
                mesh, self.degrees[0], self.kappa_cells, self.sigma))
            ops["coarse_gather"], ops["coarse_slice"] = self._coarse_hooks()

    def _tables(self, Pdeg):
        """`DSSPartition.tables` of the grid's shards: the per-shard
        arrays and local layouts cut to its block (all of them when every
        shard is stacked here)."""
        t = self.part.tables(Pdeg)
        cut = slice(self.grid.origin[0],
                    self.grid.origin[0] + self.grid.block[0])
        return dict(t, layouts=t["layouts"][cut], l2g=t["l2g"][cut],
                    weights=t["weights"][cut], bc=t["bc"][cut],
                    xslot=t["xslot"][cut])

    def _coarse_hooks(self):
        """``coarse_gather``: the owned coarse values written (each dof has
        one owner) into each shard's row of a global coarse buffer, then
        `StackedGrid.psum`; ``coarse_slice``: every shard's local values
        of the global coarse vector (padding reads dof 0, as in JAX)."""
        S = self.grid.block[0]
        nd0 = self.mesh.num_dofs(self.degrees[0])
        l2g0, _, own, own_g = self._vec[0]
        ndl0 = self.levels[0].ndofs
        flat = (own // ndl0) * nd0 + own_g
        grid = self.grid

        def coarse_gather(v):
            buf = v.new_zeros(S * nd0)
            buf.index_copy_(0, flat, v.index_select(0, own))
            return grid.psum(buf.view(grid.block + (nd0,)))

        def coarse_slice(g):
            return g.index_select(0, l2g0)

        return coarse_gather, coarse_slice

    # -- vector layout helpers -------------------------------------------

    @property
    def ops(self):
        """The cycle-ops dict (apply/restrict/prolong/dot/zeros/
        dss_exchange and the coarse hooks) on the stacked layout."""
        return self._ops

    def to_dist(self, u, level=-1):
        """A global flat vector (numpy or tensor) -> the stacked layout
        ``(S * ndl,)`` on the device in the working dtype (0 on padding)."""
        l2g, real, _, _ = self._vec[level]
        # the local values gathered on the build device (a rank: the
        # host), then uploaded
        u = torch.as_tensor(u).reshape(-1).to(
            self.grid.build_device(self.device))
        loc = u.index_select(0, l2g.to(u.device)).to(device=self.device,
                                                     dtype=self.dtype)
        return torch.where(real, loc, 0.0)

    def from_dist(self, ud, level=-1):
        """The stacked layout -> the global flat vector (each dof from its
        owner), a tensor on the device, on every rank (a rank's owned
        values summed with the others' zeros: exact)."""
        _, _, own, own_g = self._vec[level]
        out = ud.new_zeros(self.mesh.num_dofs(self.degrees[level]))
        out.index_copy_(0, own_g, ud.index_select(0, own))
        return self.grid.psum(out[None, None, None])

    def load_state(self, data):
        """Overwrite the level, transfer and coarse arrays (the calibrated
        ``lmax`` included) with those of ``data`` — the port's layout, e.g.
        from `utils.convert.dss_dist_data_from_numpy` of the JAX
        `DSSDist`'s data — so cycles can be compared apart from
        calibration. Keys ``data`` does not hold keep their values; shapes
        must match."""
        for i, lv in enumerate(data["levels"]):
            _merge_state(self.data["levels"][i], lv, f"levels[{i}]")
        for i, tr in enumerate(data.get("transfer", ())):
            _merge_state(self.data["transfer"][i], tr, f"transfer[{i}]")
        if "coarse_chol" in data and "coarse_chol" in self.data:
            _merge_state(self.data, {"coarse_chol": data["coarse_chol"]},
                         "coarse_chol")

    # -- solver API --------------------------------------------------------

    def _vcycle(self, b, u):
        return v_cycle(self.data, b, u, levels=self.levels,
                       coarse=self.coarse, coarse_cfg=self.coarse_cfg,
                       ops=self._ops)

    def _fine_apply(self, x):
        return self._ops["apply"](self.data["levels"][-1], x, self.levels[-1])

    def apply(self, b_dist, u_dist):
        """One V-cycle on stacked vectors."""
        return self._vcycle(b_dist, u_dist)

    def operator(self):
        """Fine-level operator ``x_dist -> (A x)_dist`` on the stacked
        layout."""
        return self._fine_apply

    def solve(self, b, num_cycles=10):
        """Stationary V-cycle iteration on a global rhs from zero. Returns
        ``(u, residual_norms)``: the global solution on the device and the
        fine residual norm (ownership-weighted) after each cycle, read back
        once at the end."""
        bd = self.to_dist(b)
        ud = torch.zeros_like(bd)
        lvf = self.data["levels"][-1]
        norms = []
        for _ in range(num_cycles):
            ud = self._vcycle(bd, ud)
            r = bd - self._fine_apply(ud)
            norms.append(torch.sqrt(self._ops["dot"](r, r, lvf)))
        res = ([float(v) for v in torch.stack(norms).cpu().numpy()]
               if norms else [])
        return self.from_dist(ud), res

    def solve_pcg(self, b, rtol=1e-8, maxiter=50):
        """FCG with the stacked V-cycle preconditioner from zero. Returns
        ``(u, niter)``; the loop reads its convergence flag on the host once
        per iteration."""
        from ..solvers.cg import fcg_solve

        lvf = self.data["levels"][-1]
        bd = self.to_dist(b)
        u, info = fcg_solve(
            self._fine_apply, bd, torch.zeros_like(bd),
            lambda r: self._vcycle(r, torch.zeros_like(r)),
            rtol=float(rtol), maxiter=int(maxiter),
            dot=lambda u_, v_: self._ops["dot"](u_, v_, lvf))
        return self.from_dist(u), int(info["niter"])
