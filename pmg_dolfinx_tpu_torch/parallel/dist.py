"""The 1D slab decomposition (`DistPMG`), every slab stacked on one device.

Port of `pmg_dolfinx_tpu.parallel.dist`. JAX runs `DistPMG` as one
``shard_map`` program over a 1D device mesh ``"x"``: each shard holds
the ``npl = cells_x/S * P + 1`` x-planes of its slab (`SlabPartition`,
the interface plane duplicated), cell compute is shard-local, interface
partial sums are exchanged with both neighbours after every cell scatter
and inner products are ownership-weighted local dots plus a ``psum``.

Layout. The port stacks the ``S`` slabs on one device. The Kronecker
family (``kron``, ``kron_blocked``) keeps a slab vector as ONE contiguous
tensor ``(S, npl, NY, NZ)``; reshaped to ``(S*npl, NY, NZ)`` it is JAX's
public duplicated layout. The general backends (``dofmap``, ``lattice``)
keep JAX's flat ``(S * local_ndofs,)``. Pointwise work runs on the whole
tensor; the per-slab work (cell kernels, einsums) is batched over ``S``.

The seam. Every collective of the JAX program goes through the port's
one communication object, `parallel.grid2d.StackedGrid`, with ``shards =
(S, 1, 1)``: the non-wrapping ``ppermute`` pair of `_exchange_partials`
(the grid's exchange along x), the ``psum`` of the dots and the
``all_gather`` / ``dynamic_slice`` of the gathered coarse solves. A slab
tensor is viewed as the grid's ``(S, 1, 1, npl, NY, NZ)`` for them.

``kron_blocked`` runs kernels #1-#3 (`ops.kron_blocked`) with the x
exchange between kernel 1 and kernel 2, each kernel launched ONCE over
the stacked lattice ``(S*npl, NY, NZ)``: a block-diagonal ``Ktx`` (each
block a slab's own banded x-stiffness, zero between blocks, so every
slab gets its own ``t1`` exactly) and the stacked scale factors. The
other design, kernels 1 and 2 once per slab on its contiguous block (what
`GridPMG` does), measured 1.9x slower on the card (PERF.md §6);
`chip_smoke.py` builds it from `slab_blocks` to time it against this one.

Ported: `SlabPartition`, the cycle-op factories `dist_cycle_ops`
(dofmap), `dist_kron_cycle_ops`, `dist_kron_blocked_cycle_ops`,
`dist_lattice_cycle_ops`, `build_hmg_dist` (the gather-free h-multigrid
coarse hierarchy) and `DistPMG` with the point-Jacobi, line
(``line-y``/``line-z``) and Schwarz smoothers, the ``cg``, ``smoother``
and gathered ``fdm`` / ``direct`` / ``hmg`` coarse solves, the
non-gathered ``coarse_cfg["dist"]`` forms (``fdm``: `fdm_dist`'s pencil
transposes; ``hmg``: `build_hmg_dist`, its bottom gathered or, with
``bottom="fdm"``, distributed too), a scalar sigma, Robin faces and
graded spacing on every backend, and scalar, per-axis and diagonal-tensor
kappa; on the Kronecker family Robin ends and grading ride the 1D
factors (a sharded x axis gets per-slab row-stacked ``Kx`` blocks, the
stacked kernel operand ``Ktx`` each slab's own block), on the general
backends (``dofmap``, ``lattice``) the Robin boundary mass is baked into
``m3`` and curved hexes, DG-0 and off-diagonal tensor kappa (folded into
G), a sigma field and the gathered general ``hmg`` (`build_hmg_general`)
run too; `solve`, `solve_pcg`, `solve_refined` (its f64 apply picked as
JAX picks it), `load_state`. JAX's ``pvary`` has no counterpart
(ROADMAP.md, "Do not port"); ``make_mesh`` neither (no device mesh). As
in JAX, a per-cell or off-diagonal tensor kappa on the Kronecker family
raises ValueError. Across processes (``devices=``, `multihost`) each rank
holds a run of slabs and uploads its part of the host-built stack
(`slab_level_spec`). ``precision="high"`` runs the bf16x3 kernels of
`ops.kron_blocked` / `ops.lattice_blocked` as in `PMGHierarchy`, with
the transfers at 'highest'. As in JAX, the slab's
distributed hmg is the Kronecker h-hierarchy only; the general family's
runs on `GridPMG` with ``shards=(S, 1, 1)``.
"""

import numpy as np
import torch

from ..ops.kron_blocked import _check_precision
from ..solvers.cg import cg_solve
from ..solvers.pmg import (
    DEFAULT_CALIBRATION_ITERS,
    DEFAULT_CALIBRATION_RTOL,
    DEFAULT_SMOOTHER_ITERS,
    EIG_RANGE_FACTORS,
    Level,
    _level_precond,
    _merge_state,
    _shifted,
    fmg_initial_guess,
    v_cycle,
)
from ..solvers.tridiag import lanczos_eigenvalue_estimates
from .partition import SlabPartition, duplicate_planes


def _shifted_diag_np(mesh, Pdeg, kappa_cells, sigma, sigma_field=None):
    """Global operator diagonal with the optional lumped-mass shift
    ``sigma`` (a sigma field scales the mass, `shifted_mass_np`) and the
    Robin faces' boundary mass (`robin_mass_np`)."""
    from ..fem.assembly import (robin_mass_np, shifted_mass_np,
                                stiffness_diagonal_np)

    d = stiffness_diagonal_np(mesh, Pdeg, kappa_cells)
    if sigma:
        d = d + sigma * shifted_mass_np(mesh, Pdeg, sigma_field)
    if getattr(mesh, "has_robin", False):
        d = d + robin_mass_np(mesh, Pdeg)
    return d


def _grid(n_shards):
    """The layout a factory's ``n_shards`` slot names: JAX's slab count
    (every slab stacked here) or the solver's own grid (a `StackedGrid`
    or a rank's `multihost.RankGrid`, whose ``block`` is the leading
    shape of the tensors it takes)."""
    from .grid2d import StackedGrid

    if isinstance(n_shards, StackedGrid):
        return n_shards
    return StackedGrid((int(n_shards), 1, 1))


def _six(t, n_shards, shape):
    """A slab tensor (``(S, npl, NY, NZ)``, ``(S*npl, NY, NZ)`` or flat)
    viewed as the grid's stacked ``(S, 1, 1, npl, NY, NZ)``."""
    return t.reshape((n_shards, 1, 1) + tuple(shape))


def _exchange_partials(lat, n_shards, *, inplace=False):
    """Reconcile interface-plane partial sums with both neighbours.

    ``n_shards`` is the slab count or the slab's grid (`_grid`); ``lat``
    is the stacked slab lattice ``(S, npl, NY, NZ)`` (``S`` the grid's
    local block on a rank): shard
    ``s``'s last plane and shard ``s+1``'s first plane are copies of one
    global plane, each holding the partial sum of its own cells; after
    the exchange both hold the full sum (the non-wrapping ``ppermute``
    pair of `StackedGrid`, zeros at the chain ends). Returns a new
    tensor, or writes ``lat`` when ``inplace``."""
    from .grid2d import _exchange_axis

    grid = _grid(n_shards)
    if grid.shards[0] == 1:
        return lat
    out = _exchange_axis(_six(lat, grid.block[0], lat.shape[1:]),
                         grid, 0, inplace=inplace)
    return out.reshape(lat.shape)


def _slab_transfers(n_shards, flat):
    """The lattice p-transfers, dot, zeros and exchange of the slab
    layout: restriction weights the fine interface planes by ownership,
    contracts each slab with the LOCAL per-axis transposed interpolation
    and reconciles the coarse interface partials; prolongation needs no
    communication (both owners of a plane compute it alike)."""
    from .grid2d import _stacked_contract

    grid = _grid(n_shards)
    S = grid.block[0]

    def out(t, level):
        return t.reshape(-1) if flat else t.reshape((S,) + level.shape)

    def restrict_op(tr, r, level_c, level_f):
        lat = _six(r * tr["weights_f"], S, level_f.shape)
        for dim, name in enumerate(("Ix", "Iy", "Iz")):
            lat = _stacked_contract(tr[name].mT, lat, dim)
        return out(_exchange_partials(lat[:, 0, 0], grid, inplace=True),
                   level_c)

    def prolong_op(tr, u, level_c, level_f):
        lat = _six(u, S, level_c.shape)
        for dim, name in enumerate(("Ix", "Iy", "Iz")):
            lat = _stacked_contract(tr[name], lat, dim)
        return out(lat, level_f)

    return dict(
        restrict=restrict_op, prolong=prolong_op,
        dot=lambda u, v, lv: grid.dot(u, v, lv["weights"]),
        zeros=lambda level, like: torch.zeros(
            (S * level.ndofs,) if flat else (S,) + tuple(level.shape),
            dtype=like.dtype, device=like.device),
        exchange=lambda lat: _exchange_partials(lat, grid),
    )


def _stacked_dofmap(dofmap, n_shards, ndofs_local):
    """The replicated local dofmap offset per slab into the flat stack:
    ``(S * ncells_local, n^3)``, slab-major (the global cell order)."""
    off = torch.arange(n_shards, device=dofmap.device) * ndofs_local
    return (dofmap[None] + off[:, None, None]).reshape(-1, dofmap.shape[1])


def dist_cycle_ops(n_shards, sigma=0.0):
    """V-cycle primitives of the dofmap backend on the slab layout (flat
    vectors): `laplacian_scatter_raw` per slab with the replicated local
    dofmap (batched over the slabs), then the partial-sum exchange;
    dofmap p-transfers likewise (restriction exchanged, prolongation
    consistent without communication). ``sigma`` adds the lumped-mass
    shift after the exchange. ``n_shards`` may be the solver's grid
    (`_grid`); the local slab count is its block."""
    from ..ops.interpolate import prolongate, restrict
    from ..ops.laplacian import laplacian_scatter_raw

    grid = _grid(n_shards)
    S = grid.block[0]

    def raw(lv, x, level):
        dm = _stacked_dofmap(lv["dofmap"], S, level.ndofs)
        y = laplacian_scatter_raw(x, dm, lv["G"], lv["coeff"], lv["D"],
                                  lv["bc_marker"])
        lat = y.reshape((S,) + level.shape)
        return _exchange_partials(lat, grid, inplace=True).reshape(-1)

    def restrict_op(tr, r, level_c, level_f):
        y = restrict(r, _stacked_dofmap(tr["dofmap_c"], S, level_c.ndofs),
                     _stacked_dofmap(tr["dofmap_f"], S, level_f.ndofs),
                     tr["M1"], tr["mult_f"], S * level_c.ndofs)
        lat = y.reshape((S,) + level_c.shape)
        return _exchange_partials(lat, grid, inplace=True).reshape(-1)

    def prolong_op(tr, u, level_c, level_f):
        return prolongate(u, _stacked_dofmap(tr["dofmap_c"], S, level_c.ndofs),
                          _stacked_dofmap(tr["dofmap_f"], S, level_f.ndofs),
                          tr["M1"], S * level_f.ndofs)

    return dict(_slab_transfers(grid, flat=True),
                apply=_shifted(raw, sigma), restrict=restrict_op,
                prolong=prolong_op)


def dist_kron_cycle_ops(n_shards, precision="highest", sigma=0.0):
    """V-cycle primitives of the plain-torch Kronecker-sum backend on the
    slab layout: per slab the symmetrized ``S (Kt_x ⊕ Kt_y ⊕ Kt_z) S``
    with the LOCAL x stiffness and the duplicated-layout x mass (batched
    over the slabs), the x term reconciled by the exchange; lattice
    transfers. Vectors ``(S, npl, NY, NZ)``."""
    from ..ops.kron_blocked import _check_precision
    from .grid2d import grid_kron_cycle_ops

    _check_precision(precision)
    grid = _grid(n_shards)
    S = grid.block[0]
    grid_apply = grid_kron_cycle_ops(grid, precision, sigma)["apply"]

    def apply_op(lv, x, level):
        six = lambda t: _six(t, S, level.shape)
        y = grid_apply(dict(lv, bc_marker=six(lv["bc_marker"])), six(x),
                       level)
        return y.reshape(x.shape)

    return dict(_slab_transfers(grid, flat=False), apply=apply_op)


def slab_blocks(mats, n_shards):
    """Each slab's own arrays from the stacked ``kb_mats`` of a slab level
    (a list, slab order): its diagonal block of the block-diagonal
    ``Ktx`` and its rows of the x-dependent factors, each a contiguous
    copy; the shard-invariant y/z factors are shared."""
    n = mats["Ktx"].shape[0] // n_shards
    out = []
    for s in range(n_shards):
        rows = slice(s * n, (s + 1) * n)
        m = dict(mats)
        m["Ktx"] = mats["Ktx"][rows, rows].contiguous()
        for key in ("sx2d", "sxz", "sxzm", "mx2"):
            if key in mats:
                m[key] = mats[key][rows].contiguous()
        out.append(m)
    return out


def dist_kron_blocked_cycle_ops(n_shards, precision="highest", sigma=0.0):
    """V-cycle primitives over the blocked kernel pair on the slab layout:
    kernel 1's output (the x term, the only shard-partial quantity) rides
    the exchange before kernel 2 reads it; the down-sweep residual is
    fused into kernel 3. Each kernel runs once over the stacked lattice
    (block-diagonal ``Ktx``, the level's ``kb_mats``). CPU tensors run
    the plain versions. Lattice transfers in exact precision, as in the
    JAX package."""
    from ..ops.kron_blocked import (
        _check_precision,
        blocked_kron_apply,
        blocked_kron_residual,
    )

    _check_precision(precision)
    grid = _grid(n_shards)
    S = grid.block[0]

    def ex(t1):  # kernel 1's output is the entry point's own tensor
        lat = t1.view((S, -1) + tuple(t1.shape[1:]))
        return _exchange_partials(lat, grid, inplace=True).view(t1.shape)

    def run(lv, x, level, r=None):
        x = x.contiguous()
        flat3 = lambda t: t.reshape((-1,) + tuple(level.shape[1:]))
        if r is None:
            y = blocked_kron_apply(flat3(x), flat3(lv["bc_marker"]),
                                   lv["kb_mats"], precision=precision,
                                   exchange=ex, sigma=sigma)
        else:
            y = blocked_kron_residual(flat3(r.contiguous()), flat3(x),
                                      flat3(lv["bc_marker"]), lv["kb_mats"],
                                      precision=precision, exchange=ex,
                                      sigma=sigma)
        return y.reshape(x.shape)

    return dict(
        _slab_transfers(grid, flat=False),
        apply=lambda lv, x, level: run(lv, x, level),
        residual=lambda lv, b, u, level: run(lv, u, level, r=b),
    )


def dist_lattice_cycle_ops(n_shards, precision="highest", sigma=0.0):
    """V-cycle primitives of the plain-torch lattice backend on the slab
    layout (flat vectors): per slab the lattice apply with the LOCAL x
    axis matrices and the slab's quadrature-lattice geometry (batched
    over the slabs), the exchange, then the pointwise ``sigma`` shift;
    lattice transfers."""
    from ..ops.kron_blocked import _check_precision
    from ..ops.lattice import lattice_laplacian_apply

    _check_precision(precision)
    grid = _grid(n_shards)
    S = grid.block[0]

    def raw(lv, x, level):
        shape = (S,) + tuple(level.shape)
        mats = {k: lv[k] for k in ("Ex", "Dx", "Ey", "Dy", "Ez", "Dz")}
        G = lv["G"].reshape((S, -1) + tuple(lv["G"].shape[1:]))
        y = lattice_laplacian_apply(x.reshape(shape), mats, G,
                                    lv["bc_marker"].reshape(shape),
                                    apply_bc=False)
        return _exchange_partials(y, grid, inplace=True).reshape(-1)

    return dict(_slab_transfers(grid, flat=True),
                apply=_shifted(raw, sigma))


def slab_coarse_hooks(part, P0, *, grid=None):
    """Gather/slice hooks of the gathered coarse solves: ``coarse_gather``
    takes the slab coarse vector to the global lattice (3D from the
    Kronecker layout, flat from the flat one; the duplicated interface
    planes kept once), ``coarse_slice`` a global vector back to the
    layout of its shape (3D -> ``(S, npl, NY, NZ)``, flat -> flat; ``S``
    this rank's slabs on a `multihost.RankGrid`)."""
    grid = _grid(part.n_shards if grid is None else grid)
    S = grid.block[0]
    shape0 = part.local_shape(P0)
    glob = part.mesh.lattice_shape(P0)

    def coarse_gather(b0):
        g = grid.all_gather(_six(b0, S, shape0))
        return g if b0.dim() == 4 else g.reshape(-1)

    def coarse_slice(ug):
        loc = grid.local_slices(ug.reshape(glob), shape0)
        return (loc.reshape((S,) + shape0) if ug.dim() == 3
                else loc.reshape(-1))

    return coarse_gather, coarse_slice


def slab_schwarz(swg, part, Pdeg, dtype, device):
    """The global Schwarz data ``swg`` (`build_schwarz_np`'s arrays, numpy
    or tensors) in the slab layout: ``Ux`` as per-slab diagonal blocks
    ``(S, ncl*n, npl)`` (`shard_dense_axis`), ``Uy`` / ``Uz`` whole,
    ``ginv`` cut cell-contiguously per slab and the marker ``(S, npl, NY,
    NZ)`` (4D for every backend: the dense apply runs on the slab stack)."""
    from ..solvers.schwarz import shard_dense_axis
    from .grid2d import _host

    S = part.n_shards
    t = lambda a: torch.as_tensor(np.asarray(_host(a)), dtype=dtype,
                                  device=device)
    g = t(swg["ginv"])
    return dict(
        Ux=t(shard_dense_axis(_host(swg["Ux"]), Pdeg,
                              *part.axis_starts(Pdeg))
             ).reshape(S, -1, part.local_planes(Pdeg)),
        Uy=t(swg["Uy"]), Uz=t(swg["Uz"]),
        ginv=g.reshape((S, -1) + tuple(g.shape[1:])),
        bc=torch.as_tensor(part.to_dist(
            Pdeg, np.asarray(_host(swg["bc"]), np.float64)) > 0.5,
            device=device).reshape((S,) + part.local_shape(Pdeg)),
    )


def _hmg_sizes(nc, div, sizes, min_cells, what):
    """The shard-aligned cell counts of a distributed h-hierarchy (finest
    first): ``sizes`` validated, every level divisible by ``div``; else
    `coarsenable_levels` under ``div``."""
    from ..solvers.hmg import coarsenable_levels, validate_hmg_sizes

    if sizes is not None:
        sizes = validate_hmg_sizes(nc, sizes)
        for lvl in sizes:
            if any(c % d for c, d in zip(lvl, div)):
                raise ValueError(
                    f"coarse_cfg['sizes'] level {lvl} is not divisible "
                    f"by {what}; every h-level must split into the same "
                    "per-shard slabs for the distributed (dist=True) "
                    "hierarchy"
                )
        return sizes
    return coarsenable_levels(nc, min_cells=min_cells, divisors=div)


def _hmg_global(mesh, P0, kappa, dtype, smoother_iters, precision, bottom,
                min_cells, sigma, sizes, smoother, device):
    """The global `build_hmg` pass over the distributed hierarchy's level
    sizes: per-level lmax, diagonals, line / Schwarz data and the bottom
    factor (the distributed operator is the same, so they carry over).
    An 'fdm' bottom is the distributed one, attached by the caller."""
    from ..solvers.hmg import build_hmg

    if bottom not in ("direct", "cg", "smoother", "fdm"):
        raise ValueError(
            f"distributed hmg: unsupported bottom '{bottom}' "
            "(choose from direct, cg, smoother, fdm)"
        )
    _, g_data, g_bottom = build_hmg(
        mesh, P0, kappa, dtype, smoother_iters=smoother_iters,
        precision=precision,
        bottom="smoother" if bottom == "fdm" else bottom,
        min_cells=min_cells, sigma=sigma, sizes=sizes, smoother=smoother,
        device=device)
    return g_data, g_bottom


def _hmg_box_meshes(mesh, sizes_cf):
    """The coarse -> fine level meshes of a distributed box h-hierarchy:
    each level keeps the mesh's faces and Robin alphas (the end updates
    rediscretised per level) and a graded mesh's spacing merged onto the
    coarser cells (`coarsen_spacing`), as the global `build_hmg` pass
    builds them."""
    from ..fem.mesh import BoxMesh
    from ..solvers.hmg import _level_mesh, _same_or

    make = _level_mesh(mesh, BoxMesh)
    return [_same_or(mesh, nc, make) for nc in sizes_cf]


def build_hmg_dist(mesh, n_shards, P0, kappa, dtype, smoother_iters=2,
                   precision="highest", bottom="direct", min_cells=2,
                   sigma=0.0, divisors=None, sizes=None, smoother="cheb", *,
                   device):
    """Distributed (non-gathered) geometric h-multigrid coarse hierarchy
    on the slab layout, every slab stacked on ``device``.

    Every h-level stays in the duplicated-plane slab layout: coarsening is
    shard-aligned (each level's x-cells divisible by ``n_shards``, or by
    ``divisors[0]``, which pins the hierarchy across slab counts), so the
    level applies are `dist_kron_cycle_ops` (the partial-sum exchange) and
    the transfers the LOCAL blocks of the per-axis h-interpolation (fine
    interface planes ownership-weighted, coarse partials reconciled by the
    exchange, `_slab_transfers`). Only the bottom solve may gather, at the
    coarsest level; ``bottom="fdm"`` solves it with `fdm_dist` instead, so
    nothing gathers. Calibration (per-level lmax), diagonals, line blocks,
    Schwarz data and the bottom factor come from one global `build_hmg`
    pass over the same level sizes. ``smoother``: 'cheb', 'line-y' /
    'line-z' (lines along x would span slabs) or 'schwarz'.

    Returns ``(levels, data, specs, bottom_mode, gather, unslice,
    bottom_solve)``: the `v_cycle` data (vectors ``(S, npl, NY, NZ)``), the
    grid axes each array is stacked over, the bottom, the coarsest-level
    gather / slice hooks and, for ``bottom="fdm"``, the distributed bottom
    solve (``hmg_ops["fdm_dist"]``). The arrays are the whole stack on
    ``device``; when ``n_shards`` is a rank's grid (`_grid`) the hooks
    communicate through it and the caller cuts the rank's block by
    ``specs``."""
    from ..fem.assembly import resolve_kappa_axes
    from ..ops.kron import axis_stiffness_mass, local_axis_K, robin_axis_ends
    from ..solvers.hmg import local_axis_h_interpolation
    from ..solvers.line import parse_line_smoother, shard_line_blocks
    from .grid2d import _host

    grid = _grid(n_shards)
    S = grid.shards[0]
    kax = resolve_kappa_axes(mesh, kappa)
    schwarz = smoother == "schwarz"
    line_axis = (None if schwarz
                 else parse_line_smoother(smoother, mesh, np.diag(kax),
                                          allowed=(1, 2)))
    if line_axis == 0:
        raise ValueError(
            "distributed (dist=True) h-MG line smoother cannot relax "
            "along x — the slab axis; use 'line-y'/'line-z'"
        )
    div = tuple(divisors) if divisors is not None else (S, 1, 1)
    if div[0] % S:
        raise ValueError(
            f"divisors[0]={div[0]} must be a multiple of n_shards={S}")
    sizes = _hmg_sizes(mesh.nc, div, sizes, min_cells,
                       f"divisors={div}")
    if len(sizes) < 2:
        raise ValueError(
            f"mesh nc={mesh.nc} is not h-coarsenable with x-cells "
            f"divisible by n_shards={S} (divisors={div}); use the "
            "gathered hmg coarse (coarse_cfg without dist=True) or a "
            "coarser-friendly mesh size"
        )
    meshes = _hmg_box_meshes(mesh, sizes[::-1])
    g_data, g_bottom = _hmg_global(
        mesh, P0, kappa, dtype, smoother_iters, precision, bottom,
        min_cells, sigma, sizes, smoother, device)
    parts = [SlabPartition(m, S) for m in meshes]
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    SLAB = ("x",)

    levels, level_data, level_specs = [], [], []
    for m, p_l, g_lv in zip(meshes, parts, g_data["levels"]):
        npl = p_l.local_planes(P0)
        shape = (S,) + p_l.local_shape(P0)
        # Robin ends rediscretised per h-level: row-stacked per slab on x
        # where they or the grading make the slabs differ, folded into the
        # global y/z matrices (the 1/k_a pre-divide keeps alpha kappa-free).
        Kx, kx_stacked = local_axis_K(m, 0, p_l.cells_per_shard_x, P0,
                                      kax[0], S)
        Ky, my = axis_stiffness_mass(m.nc[1], P0, m.h_cells[1],
                                     robin=robin_axis_ends(m, 1, 1.0 / kax[1]))
        Kz, mz = axis_stiffness_mass(m.nc[2], P0, m.h_cells[2],
                                     robin=robin_axis_ends(m, 2, 1.0 / kax[2]))
        _, mx_g = axis_stiffness_mass(m.nc[0], P0, m.h_cells[0])
        lv = dict(
            Kx=t(Kx), Ky=t(kax[1] * Ky), Kz=t(kax[2] * Kz),
            mx=t(duplicate_planes(mx_g, npl, S)), my=t(my), mz=t(mz),
            bc_marker=torch.as_tensor(p_l.to_dist(
                P0, m.boundary_dof_marker(P0)) > 0.5,
                device=device).reshape(shape),
            diag_inv=t(p_l.to_dist(P0, _host(g_lv["diag_inv"]).reshape(-1))
                       ).reshape(shape),
            weights=t(p_l.ownership_weights(P0)).reshape(shape),
            lmax=g_lv["lmax"],
        )
        spec = dict(Kx=SLAB if kx_stacked else (), Ky=(), Kz=(),
                    mx=SLAB, my=(), mz=(),
                    bc_marker=SLAB, diag_inv=SLAB, weights=SLAB, lmax=())
        if line_axis is not None:
            lv["line_inv"] = t(shard_line_blocks(
                _host(g_lv["line_inv"]), m.lattice_shape(P0), line_axis,
                [p_l.axis_starts(P0), None]))
            spec["line_inv"] = SLAB
        if schwarz:
            lv["schwarz"] = slab_schwarz(g_lv["schwarz"], p_l, P0, dtype,
                                         device)
            spec["schwarz"] = dict(Ux=SLAB, Uy=(), Uz=(), ginv=SLAB,
                                   bc=SLAB)
        levels.append(Level(P=P0, ndofs=p_l.local_ndofs(P0),
                            smoother_iters=smoother_iters,
                            shape=p_l.local_shape(P0),
                            line_axis=(line_axis if line_axis is not None
                                       else 2)))
        level_data.append(lv)
        level_specs.append(spec)

    transfer, transfer_specs = [], []
    for (mc, pc), (mf, pf) in zip(zip(meshes, parts),
                                  zip(meshes[1:], parts[1:])):
        # A graded axis interpolates on its fine cells' sizes; on the
        # sharded x axis that gives per-slab blocks (S, Nf, Nc).
        h_fine = (lambda a: mf.h_cells[a] if mf.is_graded else None)
        Ix, x_stacked = local_axis_h_interpolation(
            pc.cells_per_shard_x, P0, mf.nc[0] // mc.nc[0], S,
            h_fine=h_fine(0))
        Iy, _ = local_axis_h_interpolation(mc.nc[1], P0,
                                           mf.nc[1] // mc.nc[1], 1,
                                           h_fine=h_fine(1))
        Iz, _ = local_axis_h_interpolation(mc.nc[2], P0,
                                           mf.nc[2] // mc.nc[2], 1,
                                           h_fine=h_fine(2))
        Ix = t(Ix)
        if x_stacked:
            Ix = Ix.reshape(S, -1, Ix.shape[1])
        transfer.append(dict(
            Ix=Ix, Iy=t(Iy), Iz=t(Iz),
            weights_f=t(pf.ownership_weights(P0)).reshape(
                (S,) + pf.local_shape(P0))))
        transfer_specs.append(dict(Ix=SLAB if x_stacked else (), Iy=(),
                                   Iz=(), weights_f=SLAB))

    data = dict(levels=level_data, transfer=transfer)
    specs = dict(levels=level_specs, transfer=transfer_specs)
    if "coarse_chol" in g_data:
        data["coarse_chol"] = g_data["coarse_chol"]
        specs["coarse_chol"] = ()
    bottom_solve = None
    if bottom == "fdm":
        # The distributed-FDM bottom (parallel/fdm_dist.py): the hierarchy
        # never gathers.
        from .fdm_dist import make_fdm_dist

        data["fdm"], specs["fdm"], bottom_solve = make_fdm_dist(
            meshes[0], P0, parts[0], (("x", S) if S > 1 else None, None,
                                      None),
            SLAB, kappa, dtype, precision=precision, sigma=sigma,
            device=device, grid=grid)
        g_bottom = "fdm"
    hmg_gather, hmg_slice = slab_coarse_hooks(parts[0], P0, grid=grid)
    return (tuple(levels), data, specs, g_bottom, hmg_gather, hmg_slice,
            bottom_solve)


def slab_level_spec(data, n_shards):
    """The layout of each array of a `DistPMG` level or transfer (JAX's
    PartitionSpec tree, `multihost.take_block`'s ``spec``): the working-
    layout vectors, the x-slab geometry and per-cell arrays, the
    duplicated x mass, a row-stacked ``Kx`` and the x-dependent kernel
    factors over the slab axis (the block-diagonal ``Ktx`` by rows and
    columns), the rest replicated."""
    SLAB = ("x",)
    spec = {}
    for k, v in data.items():
        if k in ("bc_marker", "weights", "diag_inv", "m3", "line_inv", "G",
                 "coeff", "mx", "mult_f", "weights_f"):
            spec[k] = SLAB
        elif k == "Kx":    # row-stacked per slab, or one matrix for all
            stacked = n_shards > 1 and v.shape[0] == n_shards * v.shape[1]
            spec[k] = SLAB if stacked else ()
        elif k == "schwarz":
            spec[k] = dict(Ux=SLAB, Uy=(), Uz=(), ginv=SLAB, bc=SLAB)
        elif k == "kb_mats":
            spec[k] = {key: (("x", "x") if key == "Ktx" else SLAB)
                       for key in ("Ktx", "sx2d", "sxz", "sxzm", "mx2")}
    return spec


class DistPMG:
    """p-multigrid on a slab-partitioned box mesh, every slab stacked on
    one device (``device``, CUDA unless the caller asks for the CPU).

    The JAX package's signature. ``n_devices`` is the number of slabs
    (None: one slab, the whole mesh). With no process group every slab
    is stacked on ``device``; with one up (`multihost.initialize`) the
    slabs span the ranks, contiguous runs of equal length, or as
    ``devices`` (the rank of each slab) says, and each rank holds its run
    on its ``device`` (`to_dist` gives the rank's slabs; `from_dist`,
    `solve`'s solution and its residual list are the same on every
    rank). ``operator``: ``"dofmap"`` (the
    default), ``"lattice"`` (plain torch; the general backends keep flat
    vectors), ``"kron"`` (plain torch) or ``"kron_blocked"`` (kernels
    #1-#3, float32; vectors ``(S, npl, NY, NZ)``); ``coarse``: ``"cg"``,
    ``"smoother"``, the gathered ``"fdm"``, ``"direct"`` and ``"hmg"``,
    and with ``coarse_cfg=dict(dist=True)`` the non-gathered ``"fdm"``
    (pencil transposes) and ``"hmg"`` (`build_hmg_dist`, constant-kappa
    boxes, Robin faces and grading included);
    ``smoother``: ``"cheb"`` (point Jacobi), ``"line-y"`` / ``"line-z"``
    (``"line"`` resolves to one of them; lines along x would span
    shards) or ``"schwarz"``; ``kappa`` a scalar, per-axis tuple or
    diagonal tensor, ``sigma`` a scalar, Robin faces and graded spacing
    on every backend; on ``dofmap`` / ``lattice`` also a DG-0 (array or
    callable) or any tensor kappa, a sigma field and curved meshes.
    Vectors in and out of `solve` / `solve_pcg` / `solve_refined` are
    global flat vectors (numpy or tensors in, tensors on ``device`` out);
    `apply`, `operator` and `residual_norm` take the slab layout of
    `to_dist`.
    """

    def __init__(self, mesh, n_devices=None, degrees=(1, 3), kappa=2.0,
                 dtype=torch.float64, smoother_iters=DEFAULT_SMOOTHER_ITERS,
                 coarse="cg", coarse_cfg=None, devices=None,
                 calibration_iters=DEFAULT_CALIBRATION_ITERS,
                 operator="dofmap", precision="highest", sigma=0.0,
                 smoother="cheb", *, device="cuda"):
        from ..fem.assembly import (
            ops_shift_scalar,
            resolve_kappa_axes,
            resolve_kappa_split,
            resolve_sigma,
        )
        from ..fem.mesh import require_axis_aligned
        from ..solvers.line import parse_line_smoother

        n_devices = int(n_devices or 1)
        self.n_shards = n_devices
        self.part = SlabPartition(mesh, n_devices)
        self.mesh = mesh
        self.degrees = tuple(int(p) for p in degrees)
        self.sigma, sigma_field = resolve_sigma(sigma)
        self._sigma_field = sigma_field
        if sigma_field is not None:
            if operator in ("kron", "kron_blocked"):
                raise ValueError(
                    "a sigma FIELD (callable) requires a general backend "
                    "— the Kronecker paths carry only a separable scalar "
                    "shift"
                )
            if coarse == "fdm" or (coarse_cfg or {}).get("dist"):
                raise ValueError(
                    "a sigma FIELD supports the gathered coarse solvers "
                    "(cg/smoother/direct/hmg) only"
                )
            if smoother != "cheb" or (coarse_cfg or {}).get(
                    "smoother", "cheb") != "cheb":
                raise ValueError(
                    "line/schwarz smoothers support a scalar sigma only"
                )
        self._robin = bool(getattr(mesh, "has_robin", False))
        if (not any(any(f) for f in getattr(mesh, "dirichlet_faces",
                                            ((True, True),) * 3))
                and self.sigma == 0.0 and not self._robin):
            raise ValueError(
                "pure-Neumann problem (no Dirichlet face) with sigma=0 is "
                "singular (constant nullspace); add a Dirichlet face, a "
                "positive sigma shift, or a Robin face"
            )
        # Line blocks along y or z are slab-local; the Schwarz cell blocks
        # are cell-local, their overlap-add reconciled by the exchange.
        self._schwarz = smoother == "schwarz"
        self._line_axis = (None if self._schwarz
                           else parse_line_smoother(smoother, mesh, kappa,
                                                    allowed=(1, 2)))
        if self._line_axis == 0:
            raise ValueError(
                "DistPMG smoother='line' cannot relax along x — the "
                "sharded axis (lines would span shards); use 'line-y'/"
                "'line-z', or GridPMG with an x-unsharded layout"
            )
        if operator not in ("kron", "kron_blocked", "lattice", "dofmap"):
            raise ValueError(
                f"DistPMG: unknown operator backend {operator!r} (choose "
                "'kron', 'kron_blocked', 'lattice' or 'dofmap'; the fused "
                "general-hex 'lattice_blocked' runs on GridPMG — a 1D "
                "slab is shards=(S, 1, 1))"
            )
        kron_family = operator in ("kron", "kron_blocked")
        # Robin faces on the general backends ride the baked pointwise
        # shift (the boundary mass folded into m3, scalar 1.0).
        self._ops_sigma = ops_shift_scalar(mesh, self.sigma, kron_family)
        if kron_family:
            require_axis_aligned(mesh, f"DistPMG operator='{operator}'")
        if operator == "kron_blocked" and dtype != torch.float32:
            raise ValueError(
                "operator='kron_blocked' is f32-only (CUDA kernels); "
                f"got dtype={dtype}"
            )
        if coarse == "fdm":
            require_axis_aligned(mesh, "coarse='fdm'")
        kc, kt, const = resolve_kappa_split(mesh, kappa)
        self._kappa_raw = kappa
        # A tensor kappa folds into G (_kappa_fold); _kc is the per-cell
        # scalar (ones for a tensor), applied to G through scale_G.
        self._kc, self._kappa_fold = kc, kt
        self.kappa_cells = kt if kt is not None else kc
        self.kappa = float(kc[0]) if const else None
        # The forms the Kronecker family and the fdm coarse solves can
        # express (scalar, per-axis, diagonal tensor); JAX's ValueError for
        # the rest on the Kronecker family.
        try:
            self.kappa_axes = resolve_kappa_axes(mesh, kappa,
                                                 split=(kc, kt, const))
        except ValueError:
            if kron_family:
                raise
            self.kappa_axes = None
        if coarse == "fdm" and self.kappa_axes is None:
            raise ValueError(
                "DistPMG: coarse='fdm' is constant-coefficient (scalar, "
                "per-axis or diagonal-tensor) only; use 'hmg', 'cg', "
                "'smoother' or 'direct'"
            )
        _check_precision(precision)
        if coarse not in ("cg", "smoother", "fdm", "direct", "hmg"):
            raise ValueError(
                f"DistPMG: unsupported coarse solver '{coarse}' "
                "(choose from cg, smoother, fdm, direct, hmg)"
            )
        self.device = torch.device(device)
        self.dtype = dtype
        self.precision = precision
        self.coarse = coarse
        self.coarse_cfg = dict(coarse_cfg or {})
        self.operator_kind = operator
        self._kron = kron_family
        from .multihost import layout_grid

        # every slab stacked here, or this rank's block of them; a rank
        # builds the whole stack on the host and uploads its block
        self.grid = g = layout_grid((n_devices, 1, 1), devices,
                                    device=self.device)
        self._bdev = g.build_device(self.device)
        self.eigs = []

        if operator == "kron":
            ops = dist_kron_cycle_ops(g, precision, sigma=self.sigma)
        elif operator == "kron_blocked":
            ops = dist_kron_blocked_cycle_ops(g, precision, sigma=self.sigma)
        elif operator == "lattice":
            ops = dist_lattice_cycle_ops(g, precision, sigma=self._ops_sigma)
        else:
            ops = dist_cycle_ops(g, sigma=self._ops_sigma)
        if coarse in ("fdm", "direct", "hmg"):
            gather, unslice = slab_coarse_hooks(self.part, self.degrees[0],
                                                grid=g)
            ops = dict(ops, coarse_gather=gather, coarse_slice=unslice)
        self._ops = ops

        level_data, levels = [], []
        for Pdeg in self.degrees:
            lv = self._place(self._build_level(Pdeg))
            level = Level(P=Pdeg, ndofs=self.part.local_ndofs(Pdeg),
                          smoother_iters=smoother_iters,
                          shape=self.part.local_shape(Pdeg),
                          line_axis=(self._line_axis
                                     if self._line_axis is not None else 2))
            # Smoother calibration, as JAX runs it distributed: recorded CG
            # on A x = 1 from 0, preconditioned as the smoother is,
            # Lanczos, lmax inflated by 1.1.
            ones = torch.ones(self._vshape(level), dtype=dtype,
                              device=self.device)
            _, info = cg_solve(
                lambda x, _lv=lv, _level=level: ops["apply"](_lv, x, _level),
                ones, torch.zeros_like(ones), lv["diag_inv"],
                rtol=DEFAULT_CALIBRATION_RTOL, maxiter=calibration_iters,
                record=True, dot=lambda u, v, _lv=lv: ops["dot"](u, v, _lv),
                precond=_level_precond(lv, level, ops),
            )
            eigs = lanczos_eigenvalue_estimates(
                info["alphas"].cpu().numpy(), info["betas"].cpu().numpy(),
                info["stored"].cpu().numpy(),
            )
            self.eigs.append(eigs)
            lv["lmax"] = torch.tensor(EIG_RANGE_FACTORS[1] * eigs[-1],
                                      dtype=dtype, device=self.device)
            level_data.append(lv)
            levels.append(level)
        self.levels = tuple(levels)
        self.data = dict(levels=level_data,
                         transfer=[self._place(self._build_transfer(Pc, Pf))
                                   for Pc, Pf in zip(self.degrees[:-1],
                                                     self.degrees[1:])])
        if coarse == "direct":
            from ..solvers.pmg import dense_cholesky

            self.data["coarse_chol"] = torch.as_tensor(
                dense_cholesky(mesh, self.degrees[0], self.kappa_cells,
                               self.sigma, sigma_field),
                dtype=dtype, device=self.device)
        elif coarse == "fdm" and self.coarse_cfg.get("dist"):
            # The non-gathered form: pencil all_to_all transposes on the
            # sharded x axis (parallel/fdm_dist.py); the gather hooks go
            # unused on this branch.
            from .fdm_dist import make_fdm_dist

            fdm, spec, ops["fdm_dist"] = make_fdm_dist(
                mesh, self.degrees[0], self.part,
                (("x", n_devices) if n_devices > 1 else None, None, None),
                ("x",),
                self.kappa_axes, dtype, precision=precision,
                sigma=self.sigma, device=self._bdev, grid=g)
            self.data["fdm"] = self._place(fdm, spec)
        elif coarse == "fdm":
            from ..solvers.fdm import FastDiagonalizationSolver

            fd = FastDiagonalizationSolver(
                mesh, self.degrees[0], kappa=self.kappa_axes, dtype=dtype,
                precision=precision, sigma=self.sigma, device=self.device,
            )
            self.data["fdm"] = dict(
                Vx=fd.Vs[0], Vy=fd.Vs[1], Vz=fd.Vs[2],
                Vxt=fd.Vts[0], Vyt=fd.Vts[1], Vzt=fd.Vts[2],
                dinv=fd.dinv, bc_global=fd.bc_marker,
            )
            self.coarse_cfg["fdm_shape"] = mesh.lattice_shape(self.degrees[0])
            self.coarse_cfg["fdm_trims"] = fd.trims
        elif coarse == "hmg":
            self._build_hmg(smoother_iters, sigma_field)

    def _build_hmg(self, smoother_iters, sigma_field):
        """The ``hmg`` coarse solve: with ``coarse_cfg["dist"]`` every
        h-level in the slab layout (`build_hmg_dist`, constant-kappa boxes);
        else the gathered global hierarchy solved on the stack (`build_hmg`
        on boxes, `build_hmg_general` on the general family)."""
        from ..solvers.pmg import kron_cycle_ops

        mesh, cfg, P0 = self.mesh, self.coarse_cfg, self.degrees[0]
        kw = dict(smoother_iters=smoother_iters, precision=self.precision,
                  bottom=cfg.get("bottom", "direct"),
                  min_cells=cfg.get("min_cells", 2), sigma=self.sigma,
                  sizes=cfg.get("sizes"), smoother=cfg.get("smoother", "cheb"),
                  device=self.device)
        box = (getattr(mesh, "is_axis_aligned", True)
               and self.kappa_axes is not None and sigma_field is None)
        if cfg.get("dist"):
            # Non-gathered: every h-level stays in the slab layout; only
            # the coarsest bottom solve may gather.
            if not box:
                raise ValueError(
                    "DistPMG coarse_cfg dist=True (distributed hmg) "
                    "requires a constant-kappa axis-aligned BoxMesh; "
                    "for the general family use the gathered hmg "
                    "coarse here, or GridPMG(shards=(n, 1, 1), "
                    "coarse='hmg', coarse_cfg=dict(dist=True)) — "
                    "the multi-axis build_hmg_grid_general covers "
                    "the 1D-slab layout"
                )
            kw.update(device=self._bdev)
            (levels, data, specs, bottom, gather, unslice,
             bottom_solve) = build_hmg_dist(
                mesh, self.grid, P0, self.kappa_axes, self.dtype,
                divisors=cfg.get("divisors"), **kw)
            data = self._place(data, specs)
            hmg_ops = dict(dist_kron_cycle_ops(self.grid, self.precision,
                                               sigma=self.sigma),
                           coarse_gather=gather, coarse_slice=unslice)
            if bottom_solve is not None:
                hmg_ops["fdm_dist"] = bottom_solve
            cfg.update(hmg_dist=True)
        elif box:
            from ..solvers.hmg import build_hmg

            levels, data, bottom = build_hmg(mesh, P0, self.kappa_axes,
                                             self.dtype, **kw)
            hmg_ops = kron_cycle_ops(self.precision, sigma=self.sigma)
        else:
            from ..solvers.hmg import build_hmg_general

            levels, data, bottom, hmg_ops = build_hmg_general(
                mesh, P0, self._kappa_raw, self.dtype,
                sigma_field=sigma_field, **kw)
        self.data["hmg"] = data
        cfg.update(hmg_levels=levels, hmg_ops=hmg_ops, hmg_bottom=bottom,
                   cycles=cfg.get("cycles", 3))

    # -- setup -----------------------------------------------------------

    def _vshape(self, level):
        """The working-layout shape of a vector on ``level`` (this rank's
        slabs)."""
        if self._kron:
            return (self.grid.block[0],) + tuple(level.shape)
        return (self.grid.block[0] * level.ndofs,)

    def _place(self, data, spec=None):
        """Set-up arrays built for the whole stack -> this grid's slabs on
        the device (`StackedGrid.place` under ``spec``, default
        `slab_level_spec`)."""
        spec = slab_level_spec(data, self.n_shards) if spec is None else spec
        return self.grid.place(data, spec, self.device)

    def _work(self, dup, Pdeg, dtype=None):
        """A host array in JAX's duplicated layout ``(S*npl, NY, NZ)`` ->
        the working layout on the build device (``(S, npl, NY, NZ)`` or
        flat)."""
        t = torch.as_tensor(np.ascontiguousarray(dup), device=self._bdev)
        if dtype is not None:
            t = t.to(dtype)
        if self._kron:
            return t.reshape((self.n_shards,) + self.part.local_shape(Pdeg))
        return t.reshape(-1)

    def _build_level(self, Pdeg):
        """The per-level arrays under the JAX package's names, vectors in
        the working layout: ``bc_marker``, ``weights``, ``diag_inv``, the
        smoother's ``line_inv`` or ``schwarz``, ``m3`` (general backends
        with a shift) and the backend's arrays."""
        from ..fem.assembly import general_shift_np

        part, mesh, dtype = self.part, self.mesh, self.dtype
        lv = dict(
            bc_marker=self._work(
                part.to_dist(Pdeg, mesh.boundary_dof_marker(Pdeg)) > 0.5,
                Pdeg),
            weights=self._work(part.ownership_weights(Pdeg), Pdeg, dtype),
            diag_inv=self._work(part.to_dist(Pdeg, 1.0 / _shifted_diag_np(
                mesh, Pdeg, self.kappa_cells, self.sigma,
                sigma_field=self._sigma_field)), Pdeg, dtype),
        )
        if self._line_axis is not None:
            from ..solvers.line import line_block_inverses, shard_line_blocks

            lv["line_inv"] = torch.as_tensor(shard_line_blocks(
                line_block_inverses(mesh, Pdeg, self._kappa_raw,
                                    self._line_axis, sigma=self.sigma),
                mesh.lattice_shape(Pdeg), self._line_axis,
                [part.axis_starts(Pdeg), None]), dtype=dtype,
                device=self._bdev)
        elif self._schwarz:
            lv["schwarz"] = self._slab_schwarz(Pdeg)
        if self._ops_sigma and not self._kron:
            # sigma * (field-scaled) lumped mass, any Robin boundary mass
            # baked in (fem.assembly.general_shift_np).
            lv["m3"] = self._work(part.to_dist(Pdeg, general_shift_np(
                mesh, Pdeg, self.sigma, self._sigma_field)[1]), Pdeg, dtype)
        if self._kron:
            lv.update(self._kron_arrays(Pdeg, dtype))
        elif self.operator_kind == "lattice":
            lv.update(self._lattice_arrays(Pdeg, dtype))
        else:
            from ..fem.assembly import geometry_factors_np
            from ..fem.gll import derivative_matrix

            G_cells, _ = geometry_factors_np(mesh, Pdeg,
                                             kappa=self._kappa_fold)
            tensor = lambda a: torch.tensor(a, dtype=dtype,
                                            device=self._bdev)
            lv.update(
                dofmap=torch.tensor(part.local_dofmap(Pdeg),
                                       dtype=torch.int64, device=self._bdev),
                G=tensor(G_cells), coeff=tensor(self._kc),
                D=tensor(derivative_matrix(Pdeg)),
            )
        return lv

    def _kron_arrays(self, Pdeg, dtype, operator=None):
        """The Kronecker family's level arrays: the LOCAL x stiffness
        (per-slab row-stacked ``(S*npl, npl)`` where Robin x ends or an x
        grading make the slabs differ), global y/z stiffness (kappa and
        Robin ends folded in) and the duplicated-layout x mass (``kron``),
        or the symmetrized ``kb_mats`` on the stacked lattice
        (``kron_blocked``: ``Ktx`` block-diagonal, each block its own
        slab's ``Kx`` over its own sqrt-mass scaling)."""
        from ..ops.kron import axis_stiffness_mass, local_axis_K, robin_axis_ends

        part, mesh, kax = self.part, self.mesh, self.kappa_axes
        S, npl = part.n_shards, part.local_planes(Pdeg)
        Kx, x_stacked = local_axis_K(mesh, 0, part.cells_per_shard_x, Pdeg,
                                     kax[0], S)
        Ky, my = axis_stiffness_mass(
            mesh.nc[1], Pdeg, mesh.h_cells[1],
            robin=robin_axis_ends(mesh, 1, 1.0 / kax[1]))
        Kz, mz = axis_stiffness_mass(
            mesh.nc[2], Pdeg, mesh.h_cells[2],
            robin=robin_axis_ends(mesh, 2, 1.0 / kax[2]))
        _, mx_g = axis_stiffness_mass(mesh.nc[0], Pdeg, mesh.h_cells[0])
        mx_dup = duplicate_planes(mx_g, npl, S)
        if (operator or self.operator_kind) == "kron":
            t = lambda a: torch.as_tensor(a, dtype=dtype, device=self._bdev)
            return dict(Kx=t(Kx), Ky=t(kax[1] * Ky), Kz=t(kax[2] * Kz),
                        mx=t(mx_dup), my=t(my), mz=t(mz))
        from ..ops.kron_blocked import (
            _check_band,
            checked_face_masks,
            symmetrized_mats,
        )

        Kx_shards = (Kx.reshape(S, npl, npl) if x_stacked
                     else np.broadcast_to(Kx, (S, npl, npl)))
        # The shard-invariant y/z factors from the helper on slab 0's
        # block; the x-dependent ones stacked over the slabs (the sqrt-mass
        # scalings differ between boundary and interior slabs, and Robin
        # ends or grading make the blocks differ), Ktx block-diagonal.
        fm = checked_face_masks(mesh, Pdeg, mesh.boundary_dof_marker(Pdeg))
        kb = symmetrized_mats(
            (Kx_shards[0], kax[1] * Ky, kax[2] * Kz), (mx_dup[:npl], my, mz),
            dtype, None if fm is None else (fm[0][:npl], fm[1], fm[2]),
            band=Pdeg, device=self._bdev)
        sx = np.sqrt(mx_dup)
        sz = np.sqrt(mz)
        Ktx = np.zeros((S * npl, S * npl))
        for s, (K_s, ss) in enumerate(zip(Kx_shards, sx.reshape(S, npl))):
            Ktx[s * npl:(s + 1) * npl, s * npl:(s + 1) * npl] = (
                K_s / ss[:, None] / ss[None, :])
        _check_band("x", Ktx, Pdeg)
        arrays = dict(Ktx=Ktx, sx2d=sx[:, None], sxz=np.outer(sx, sz))
        if fm is not None:
            mxd = duplicate_planes(fm[0], npl, S)
            arrays.update(sxzm=np.outer(mxd * sx, fm[2] * sz),
                          mx2=mxd[:, None])
        kb.update({k: torch.as_tensor(v, dtype=dtype,
                                      device=self._bdev).contiguous()
                   for k, v in arrays.items()})
        return dict(kb_mats=kb)

    def _lattice_arrays(self, Pdeg, dtype):
        """The lattice backend's level arrays: the quadrature-lattice
        geometry (slab-contiguous along x, kappa folded in) and the axis
        matrices of ONE slab's cells."""
        from ..fem.assembly import geometry_factors_np, scale_G
        from ..ops.lattice import geometry_to_qlattice, lattice_mats

        part, mesh = self.part, self.mesh
        G_cells, _ = geometry_factors_np(mesh, Pdeg, kappa=self._kappa_fold)
        lv = lattice_mats((part.cells_per_shard_x, mesh.nc[1], mesh.nc[2]),
                          Pdeg, dtype, self._bdev)
        lv["G"] = torch.as_tensor(geometry_to_qlattice(
            scale_G(G_cells, self._kc, self._kappa_fold), mesh.nc, Pdeg),
            dtype=dtype, device=self._bdev)
        return lv

    def _slab_schwarz(self, Pdeg):
        """The global Schwarz data in the slab layout (`slab_schwarz`)."""
        from ..solvers.schwarz import build_schwarz_np

        swg = build_schwarz_np(self.mesh, Pdeg, self._kappa_raw,
                               sigma=self.sigma)
        return slab_schwarz(swg, self.part, Pdeg, self.dtype, self._bdev)

    def _build_transfer(self, Pc, Pf):
        from ..fem.gll import interpolation_matrix_1d
        from ..ops.lattice import axis_interpolation_matrix

        part, mesh, dtype = self.part, self.mesh, self.dtype
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=self._bdev)
        if self.operator_kind == "dofmap":
            dm = lambda P: torch.tensor(part.local_dofmap(P),
                                           dtype=torch.int64,
                                           device=self._bdev)
            return dict(
                M1=t(interpolation_matrix_1d(Pc, Pf)),
                dofmap_c=dm(Pc), dofmap_f=dm(Pf),
                mult_f=self._work(part.to_dist(Pf, mesh.dof_multiplicity(Pf)),
                                  Pf, dtype),
            )
        return dict(
            Ix=t(axis_interpolation_matrix(part.cells_per_shard_x, Pc, Pf)),
            Iy=t(axis_interpolation_matrix(mesh.nc[1], Pc, Pf)),
            Iz=t(axis_interpolation_matrix(mesh.nc[2], Pc, Pf)),
            weights_f=self._work(part.ownership_weights(Pf), Pf, dtype),
        )

    # -- vector layout helpers -------------------------------------------

    @property
    def ops(self):
        """The cycle-ops dict (apply/residual/restrict/prolong/dot/zeros/
        exchange and the coarse hooks) on the slab layout."""
        return self._ops

    def to_dist(self, u, level=-1):
        """A global flat vector (numpy or tensor) -> the working slab layout
        on the device (``(S, npl, NY, NZ)`` for the Kronecker family, flat
        ``(S * local_ndofs,)`` otherwise) in the working dtype."""
        return self._slabs(u, level, self.dtype)

    def _slabs(self, u, level, dtype):
        """`to_dist` in ``dtype`` (`StackedGrid.put_local`)."""
        Pdeg = self.degrees[level]
        loc = self.grid.put_local(
            torch.as_tensor(u).reshape(self.mesh.lattice_shape(Pdeg)),
            self.part.local_shape(Pdeg), device=self.device, dtype=dtype)
        return loc.reshape(self._vshape(self.levels[level]))

    def from_dist(self, ud, level=-1):
        """The slab layout -> the global flat vector (a tensor on the
        device, on every rank)."""
        six = _six(ud, self.grid.block[0], self.levels[level].shape)
        return self.grid.all_gather(six).reshape(-1)

    def load_state(self, data):
        """Overwrite the level, transfer and coarse arrays (the calibrated
        ``lmax`` included) with those of ``data`` — the port's layout, e.g.
        from `utils.convert.dist_data_from_numpy` of the JAX `DistPMG`'s
        data — so cycles can be compared apart from calibration. Keys
        ``data`` does not hold keep their values; shapes must match."""
        for i, lv in enumerate(data["levels"]):
            _merge_state(self.data["levels"][i], lv, f"levels[{i}]")
        for i, tr in enumerate(data.get("transfer", ())):
            _merge_state(self.data["transfer"][i], tr, f"transfer[{i}]")
        for key in ("fdm", "hmg", "coarse_chol"):
            if key in data and key in self.data:
                if key == "coarse_chol":
                    _merge_state(self.data, {key: data[key]}, key)
                else:
                    _merge_state(self.data[key], data[key], key)

    # -- solver API --------------------------------------------------------

    def _vcycle(self, b, u):
        return v_cycle(self.data, b, u, levels=self.levels,
                       coarse=self.coarse, coarse_cfg=self.coarse_cfg,
                       ops=self._ops)

    def _fine_apply(self, x):
        return self._ops["apply"](self.data["levels"][-1], x, self.levels[-1])

    def _fmg_guess_dist(self, bd):
        """The full-multigrid guess for a slab-layout rhs."""
        return fmg_initial_guess(self.data, bd, levels=self.levels,
                                 coarse=self.coarse,
                                 coarse_cfg=self.coarse_cfg, ops=self._ops)

    def _warn_tensor(self):
        from ..solvers.pmg import warn_tensor_stationary

        warn_tensor_stationary(self._kappa_fold, self.kappa_axes,
                               self.operator_kind,
                               line=(self._line_axis is not None
                                     or self._schwarz))

    def apply(self, b_dist, u_dist):
        """One V-cycle on slab-layout vectors."""
        return self._vcycle(b_dist, u_dist)

    def operator(self):
        """Fine-level operator ``x_dist -> (A x)_dist`` on the slab layout."""
        return self._fine_apply

    def residual_norm(self, b_dist, u_dist):
        """``|b - A u|`` (ownership-weighted) as a float."""
        r = b_dist - self._fine_apply(u_dist)
        lvf = self.data["levels"][-1]
        return float(torch.sqrt(self._ops["dot"](r, r, lvf)))

    def solve(self, b, num_cycles=10, residuals=True, u0=None, fmg=False):
        """Stationary V-cycle iteration on a global rhs from zero (``u0``
        resumes from an iterate, ``fmg=True`` starts from the
        full-multigrid guess). Returns ``(u, residual_norms)``: the global
        flat solution on the device and the fine residual norm after each
        cycle, read back once at the end."""
        from ..solvers.pmg import warn_high_precision_stationary

        warn_high_precision_stationary(
            self.precision, self.mesh.num_dofs(self.degrees[-1]))
        self._warn_tensor()
        bd = self.to_dist(b)
        if u0 is not None:
            ud = self.to_dist(u0)
        elif fmg:
            ud = self._fmg_guess_dist(bd)
        else:
            ud = torch.zeros_like(bd)
        lvf = self.data["levels"][-1]
        norms = []
        for _ in range(num_cycles):
            ud = self._vcycle(bd, ud)
            r = bd - self._fine_apply(ud)
            norms.append(torch.sqrt(self._ops["dot"](r, r, lvf)))
        out = self.from_dist(ud)
        if not residuals or not norms:
            return out, []
        return out, [float(v) for v in torch.stack(norms).cpu().numpy()]

    def solve_pcg(self, b, rtol=1e-8, maxiter=50, fmg=False):
        """V-cycle-preconditioned flexible CG on the slabs from zero (or
        the FMG guess). Returns ``(u, niter)``; the loop reads its
        convergence flag on the host once per iteration."""
        from ..solvers.cg import fcg_solve

        lvf = self.data["levels"][-1]
        bd = self.to_dist(b)
        u0 = self._fmg_guess_dist(bd) if fmg else torch.zeros_like(bd)
        u, info = fcg_solve(
            self._fine_apply, bd, u0,
            lambda r: self._vcycle(r, torch.zeros_like(r)),
            rtol=float(rtol), maxiter=int(maxiter),
            dot=lambda u_, v_: self._ops["dot"](u_, v_, lvf),
        )
        return self.from_dist(u), int(info["niter"])

    def _refine_apply64(self):
        """``u64 -> A u64`` in float64 on the slab layout for
        `solve_refined`, as the JAX package picks it: the slab Kronecker
        apply on axis-aligned meshes with a constant (per-axis) kappa and no
        sigma field (Robin ends and grading folded into the axis factors),
        else the slab lattice apply with f64 geometry and ``m3``; built
        once."""
        if getattr(self, "_apply64", None) is not None:
            return self._apply64
        f64, S, Pf = torch.float64, self.grid.block[0], self.degrees[-1]
        fine = self.levels[-1]
        lv64 = dict(bc_marker=self.data["levels"][-1]["bc_marker"])
        if (getattr(self.mesh, "is_axis_aligned", True)
                and self.kappa_axes is not None
                and self._sigma_field is None):
            lv64.update(self._place(self._kron_arrays(Pf, f64,
                                                      operator="kron")))
            raw = dist_kron_cycle_ops(self.grid, sigma=self.sigma)["apply"]
            if not self._kron:  # the general layout is flat
                six = (S,) + tuple(fine.shape)
                lv64["bc_marker"] = lv64["bc_marker"].reshape(six)
                apply = lambda u: raw(lv64, u.reshape(six), fine).reshape(-1)
            else:
                apply = lambda u: raw(lv64, u, fine)
        else:
            arrays = self._lattice_arrays(Pf, f64)
            if self._ops_sigma:
                from ..fem.assembly import general_shift_np

                arrays["m3"] = self._work(self.part.to_dist(
                    Pf, general_shift_np(self.mesh, Pf, self.sigma,
                                         self._sigma_field)[1]), Pf, f64)
            lv64.update(self._place(arrays))
            raw = dist_lattice_cycle_ops(self.grid,
                                         sigma=self._ops_sigma)["apply"]
            apply = lambda u: raw(lv64, u, fine)
        self._apply64 = apply
        return apply

    def solve_refined(self, b, num_cycles=15, rtol=0.0, residuals=True,
                      u0=None, fmg=False):
        """Mixed-precision iterative refinement on the slabs: a float64
        residual through the f64 slab apply (Kronecker on axis-aligned
        meshes, lattice otherwise) with the working-dtype V-cycle as the
        error smoother. ``u0`` resumes from an iterate, ``fmg=True`` starts
        from the working-dtype FMG guess. Returns ``(u64, residual_norms)``
        (the f64 residual norm before each cycle); with ``rtol`` the loop
        stops once it falls below ``rtol * |b|``."""
        self._warn_tensor()
        apply64 = self._refine_apply64()
        f64 = torch.float64
        w64 = self.data["levels"][-1]["weights"].to(f64)
        b64 = self._slabs(b, -1, f64)
        if u0 is not None:
            u64 = self._slabs(u0, -1, f64)
        elif fmg:
            u64 = self._fmg_guess_dist(b64.to(self.dtype)).to(f64)
        else:
            u64 = torch.zeros_like(b64)
        r0 = (float(np.linalg.norm(np.asarray(
            torch.as_tensor(b).detach().cpu(), dtype=np.float64)))
            if rtol else None)
        norms = []
        for _ in range(num_cycles):
            r64 = b64 - apply64(u64)
            rn = torch.sqrt(self.grid.dot(r64, r64, w64))
            r = r64.to(self.dtype)
            u64 = u64 + self._vcycle(r, torch.zeros_like(r)).to(f64)
            norms.append(rn)
            if rtol and float(rn) < rtol * r0:
                break
        rnorms = ([float(v) for v in torch.stack(norms).cpu().numpy()]
                  if residuals and norms else [])
        return self.from_dist(u64), rnorms
