"""Geometric h-multigrid on the structured lattice: the AMG replacement.

Port of `pmg_dolfinx_tpu.solvers.hmg`. The reference's coarse solver is
hypre BoomerAMG; on structured boxes geometric h-coarsening (factor 2 or
3 per level, closed-form nodal transfers) does the same job. The levels
are data for the same `solvers.pmg.v_cycle` the p-hierarchy runs: they
differ by mesh spacing instead of degree, the transfers are per-axis 1D
interpolation matrices between nested lattices (restriction is the
transpose), and each level smooths with the calibrated fourth-kind
Chebyshev over point Jacobi, line relaxation (`solvers.line`) or the
cell-wise Schwarz blocks (`solvers.schwarz`).

`build_hmg` builds Kronecker-sum levels (axis-aligned boxes, a constant
scalar, per-axis or diagonal-tensor kappa, Robin ends and graded spacing
on every level: plain torch `kron_cycle_ops`); `build_hmg_general`
rediscretises the lattice operator per level (curved `PerturbedBoxMesh`
hexes, variable or tensor kappa volume-averaged onto each level's cells,
sigma fields and Robin faces baked into each level's shift: plain torch
`lattice_cycle_ops`). A graded fine mesh coarsens by merging cells
(`coarsen_spacing`). The bottom is a dense Cholesky solve
(``"direct"``, up to 4096 dofs, else Krylov), ``"cg"`` or the level's
smoother. `PMGHierarchy(coarse="hmg")` runs a few nested h-cycles as the
p=1 coarse solve.
"""

import numpy as np
import torch

from ..fem.gll import gauss_lobatto, lagrange_tabulate
from ..fem.mesh import BoxMesh
from .line import line_block_inverses, parse_line_smoother


def axis_h_interpolation(nc_coarse: int, P: int = 1, factor: int = 2,
                         dtype=np.float64, h_fine=None):
    """1D nodal interpolation from an ``nc_coarse``-cell lattice to the
    ``factor``-refined one at degree P: ``I[f, c] = l_c(x_f)``. Uniform
    spacing (``h_fine=None``): the fine nodes sit at ``(k + xg)/factor``
    of the coarse cell. Graded: ``h_fine[(factor * nc_coarse,)]`` gives
    the fine cells' widths."""
    xg, _ = gauss_lobatto(P + 1)
    Nf, Nc = factor * nc_coarse * P + 1, nc_coarse * P + 1
    I = np.zeros((Nf, Nc), dtype=dtype)
    if h_fine is None:
        blocks = [
            lagrange_tabulate(xg, (k + xg) / factor, 0)[0]  # (P+1, P+1)
            for k in range(factor)
        ]
    else:
        h_fine = np.asarray(h_fine, dtype=np.float64)
        if h_fine.shape != (factor * nc_coarse,):
            raise ValueError(
                f"h_fine must hold one width per FINE cell "
                f"({factor * nc_coarse},), got {h_fine.shape}")
    for c in range(nc_coarse):
        cols = slice(c * P, c * P + P + 1)
        if h_fine is not None:
            w = h_fine[factor * c:factor * (c + 1)]
            offs = np.concatenate(([0.0], np.cumsum(w)))
            W = offs[-1]
        for k in range(factor):
            fcell = factor * c + k
            rows = slice(fcell * P, fcell * P + P + 1)
            if h_fine is None:
                I[rows, cols] = blocks[k]
            else:
                pts = (offs[k] + xg * w[k]) / W
                I[rows, cols] = lagrange_tabulate(xg, pts, 0)[0]
    return I


def local_axis_h_interpolation(nc_c_local, P, factor, n_shards,
                               h_fine=None, dtype=np.float64):
    """Per-shard 1D h-transfer of a distributed hierarchy: ``(I,
    stacked)``. ``stacked=False``: one shard-invariant ``(Nf_l, Nc_l)``
    block; ``stacked=True``: row-stacked per-shard blocks ``(S * Nf_l,
    Nc_l)`` (a sharded graded axis)."""
    if h_fine is None:
        return axis_h_interpolation(nc_c_local, P, factor=factor,
                                    dtype=dtype), False
    h_fine = np.asarray(h_fine, dtype=np.float64)
    if n_shards == 1:
        return axis_h_interpolation(nc_c_local, P, factor=factor,
                                    dtype=dtype, h_fine=h_fine), False
    nfl = nc_c_local * factor
    blocks = [
        axis_h_interpolation(nc_c_local, P, factor=factor, dtype=dtype,
                             h_fine=h_fine[s * nfl:(s + 1) * nfl])
        for s in range(n_shards)
    ]
    return np.vstack(blocks), True


def coarsen_spacing(h_cells, nc_fine, nc_coarse):
    """Per-axis absolute cell sizes of the ``nc_coarse`` mesh whose cells
    merge consecutive fine cells (``nc_fine[a] // nc_coarse[a]`` each)."""
    out = []
    for hc, nf, ncs in zip(h_cells, nc_fine, nc_coarse):
        f = nf // ncs
        out.append(np.asarray(hc, np.float64).reshape(ncs, f).sum(axis=1))
    return tuple(out)


def coarsenable_levels(nc, min_cells=2, max_levels=10, divisors=(1, 1, 1)):
    """Mesh sizes [finest, ..., coarsest], coarsening by 2 (or 3 when 2
    does not divide) while every axis stays at ``min_cells`` or above and
    divisible by its ``divisors`` entry."""
    out = [tuple(nc)]
    cur = tuple(nc)
    while len(out) < max_levels:
        nxt = None
        for f in (2, 3):
            if all(c % f == 0 and c // f >= min_cells
                   and (c // f) % d == 0
                   for c, d in zip(cur, divisors)):
                nxt = tuple(c // f for c in cur)
                break
        if nxt is None:
            break
        cur = nxt
        out.append(cur)
    return out


def semicoarsen_sizes(nc, axes, min_cells=2, max_levels=10):
    """Mesh sizes [finest, ..., coarsest] coarsening only ``axes`` (by 2 or
    3) until they bottom out, then every axis together where all divide
    (ratio-preserving): semi-coarsening, the geometric analogue of AMG's
    strength-of-connection coarsening. Feed it to ``coarse_cfg["sizes"]``."""
    out = [tuple(nc)]
    cur = tuple(nc)
    axes = tuple(axes)
    while len(out) < max_levels:
        nxt = None
        for f in (2, 3):
            cand = tuple(c // f if a in axes and c % f == 0
                         and c // f >= min_cells else c
                         for a, c in enumerate(cur))
            if cand != cur:
                nxt = cand
                break
        if nxt is None:
            rest = coarsenable_levels(cur, min_cells=min_cells,
                                      max_levels=max_levels - len(out) + 1)
            out.extend(rest[1:])
            break
        cur = nxt
        out.append(cur)
    return out


def axis_coupling(mesh, kappa):
    """Per-axis effective coupling ``mean(kappa_aa) / mean(h_a)^2``: a
    coefficient's diagonal and stretched cells both count (on a graded
    mesh the mean spacing per axis)."""
    from ..fem.assembly import resolve_kappa_split

    kc, kt, _ = resolve_kappa_split(mesh, kappa)
    if kt is not None:
        kaa = np.diagonal(kt.mean(axis=0))
    else:
        kaa = np.full(3, float(np.mean(kc)))
    h_eff = np.array([float(hc.mean()) for hc in mesh.h_cells])
    return kaa / h_eff ** 2


def semicoarsen_axes(mesh, kappa, threshold=4.0):
    """The strongly-coupled axes for `semicoarsen_sizes`: those whose
    `axis_coupling` exceeds ``threshold`` times the weakest (empty when
    the problem is near-isotropic)."""
    c = axis_coupling(mesh, kappa)
    return tuple(a for a in range(3) if c[a] > threshold * c.min())


def validate_hmg_sizes(nc, sizes):
    """Check a user hierarchy (``coarse_cfg["sizes"]``): triples, finest
    first, ``sizes[0]`` the mesh's cell counts, every pair nested."""
    sizes = [tuple(int(c) for c in s) for s in sizes]
    for lvl in sizes:
        if len(lvl) != 3:
            raise ValueError(
                f"hmg sizes levels must be (ncx, ncy, ncz) triples, got "
                f"{lvl}"
            )
    if len(sizes) < 2:
        raise ValueError(f"hmg sizes needs >= 2 levels, got {sizes}")
    if sizes[0] != tuple(nc):
        raise ValueError(
            f"hmg sizes must start at the mesh's cell counts {tuple(nc)} "
            f"(finest first), got sizes[0]={sizes[0]}"
        )
    for lf, lc in zip(sizes, sizes[1:]):
        if any(c < 1 or f % c or f // c < 1 for f, c in zip(lf, lc)):
            raise ValueError(
                f"hmg sizes must be per-axis nested (finer divisible by "
                f"coarser): {lf} -> {lc}"
            )
        if lf == lc:
            raise ValueError(f"hmg sizes contains a repeated level {lf}")
    return sizes


def _level_mesh(mesh, cls, **kw):
    """``nc -> cls(nc, ...)``: a level mesh of the h-hierarchy on ``mesh``'s
    extent, faces and Robin coefficients, a graded mesh's spacing merged
    onto the coarser cells (`coarsen_spacing`)."""
    robin = mesh.robin_alpha if getattr(mesh, "has_robin", False) else None

    def make(nc):
        return cls(nc, extent=mesh.extent,
                   dirichlet_faces=mesh.dirichlet_faces, robin=robin,
                   spacing=(coarsen_spacing(mesh.h_cells, mesh.nc, nc)
                            if mesh.is_graded else None), **kw)

    return make


def _same_or(mesh, nc, make):
    """The level mesh on ``nc`` cells: ``mesh`` itself on its own cell
    counts (the mesh the constructor would rebuild; its cached host
    geometry is reused), else ``make(nc)``."""
    return mesh if tuple(nc) == tuple(mesh.nc) else make(nc)


def _level_sizes(mesh, sizes, min_cells, max_levels):
    """Coarse -> fine cell counts of the h-hierarchy."""
    if sizes is None:
        sizes = coarsenable_levels(mesh.nc, min_cells=min_cells,
                                   max_levels=max_levels)
    else:
        sizes = validate_hmg_sizes(mesh.nc, sizes)
    return list(sizes)[::-1]


def _calibrate(ops, lv, level, ones, calibration_iters):
    """``lmax`` of the level's preconditioned operator (the one its smoother
    iterates on: line, Schwarz or Jacobi), recorded CG from zero on
    ``A x = 1`` plus Lanczos; 2.0 when Lanczos has too few coefficients
    (the Jacobi-preconditioned spectrum lies in (0, 2])."""
    from .pmg import EIG_RANGE_FACTORS, _generic_calibration
    from .tridiag import lanczos_eigenvalue_estimates

    _, info = _generic_calibration(lv, ones, torch.zeros_like(ones), ops=ops,
                                   level=level, maxiter=calibration_iters)
    try:
        eigs = lanczos_eigenvalue_estimates(
            info["alphas"].cpu().numpy(), info["betas"].cpu().numpy(),
            info["stored"].cpu().numpy())
        lmax = float(eigs[-1])
    except ValueError:
        lmax = 2.0
    return torch.tensor(EIG_RANGE_FACTORS[1] * lmax, dtype=ones.dtype,
                        device=ones.device)


def _transfers(meshes, P, dtype, device):
    """Per-axis interpolation ``Ix/Iy/Iz`` between consecutive levels."""
    out = []
    for mc, mf in zip(meshes[:-1], meshes[1:]):
        out.append({
            "I" + name: torch.as_tensor(axis_h_interpolation(
                nc_c, P, factor=nc_f // nc_c,
                h_fine=mf.h_cells[a] if mf.is_graded else None),
                dtype=dtype, device=device)
            for a, (name, nc_c, nc_f) in enumerate(zip("xyz", mc.nc, mf.nc))
        })
    return out


def _bottom(bottom, meshes, P, who):
    if bottom not in ("direct", "cg", "smoother"):
        raise ValueError(
            f"{who}: unsupported bottom '{bottom}' "
            "(choose from direct, cg, smoother)"
        )
    if bottom == "direct" and meshes[0].num_dofs(P) > 4096:
        # A dense factor at this size would dwarf the cycle: Krylov bottom.
        return "cg"
    return bottom


def build_hmg(mesh, P, kappa, dtype, smoother_iters=2, min_cells=2,
              max_levels=10, precision="highest",
              calibration_iters=20, bottom="direct", sigma=0.0,
              sizes=None, smoother="cheb", *, device):
    """``(levels, data, bottom)`` of the Kronecker-sum h-hierarchy for
    `v_cycle` on ``device``: levels coarse -> fine, ``data`` with
    ``levels``, ``transfer`` and (direct bottom) ``coarse_chol``.
    ``kappa`` is a scalar, per-axis or constant diagonal-tensor coefficient;
    the mesh's Robin ends and grading carry to every level. ``sigma``
    rediscretises ``A + sigma M`` per level; ``smoother`` is 'cheb' (point
    Jacobi), 'line' / 'line-x|y|z' or 'schwarz'."""
    from ..fem.assembly import resolve_kappa_axes
    from ..ops.kron import axis_stiffness_mass, kron_diagonal, robin_axis_ends
    from .pmg import Level, kron_cycle_ops

    kax = resolve_kappa_axes(mesh, kappa)
    sizes = _level_sizes(mesh, sizes, min_cells, max_levels)
    meshes = [_same_or(mesh, nc, _level_mesh(mesh, BoxMesh))
              for nc in sizes]
    ops = kron_cycle_ops(precision, sigma=sigma)
    # A scalar kappa keeps the scalar form (the same assembled blocks and
    # bottom factor); a true per-axis one goes as the diagonal tensor.
    kassemble = (float(kax[0]) if kax[0] == kax[1] == kax[2]
                 else np.diag(kax))
    schwarz = smoother == "schwarz"
    line_axis = (None if schwarz
                 else parse_line_smoother(smoother, mesh, np.diag(kax)))
    tensor = lambda a: torch.as_tensor(a, dtype=dtype, device=device)

    levels, level_data = [], []
    for m in meshes:
        lv = {}
        if line_axis is not None:
            lv["line_inv"] = tensor(
                line_block_inverses(m, P, kassemble, line_axis, sigma=sigma))
        elif schwarz:
            from .schwarz import build_schwarz

            lv["schwarz"] = build_schwarz(m, P, kassemble, dtype,
                                          sigma=sigma, device=device)
        for a, (name, nc_a, h_a, k_a) in enumerate(
                zip("xyz", m.nc, m.h_cells, kax)):
            K, mass = axis_stiffness_mass(
                nc_a, P, h_a, robin=robin_axis_ends(m, a, 1.0 / k_a))
            lv["K" + name] = tensor(k_a * K)
            lv["m" + name] = tensor(mass)
        shape = m.lattice_shape(P)
        bc = torch.tensor(m.boundary_dof_marker(P),
                             device=device).reshape(shape)
        diag = kron_diagonal(
            (lv["Kx"], lv["Ky"], lv["Kz"]), (lv["mx"], lv["my"], lv["mz"]),
            bc, sigma=sigma,
        )
        # lattice-shaped markers and diagonal: kron cycle vectors are 3D
        lv["bc_marker"] = bc
        lv["diag_inv"] = (1.0 / diag).reshape(shape)
        level = Level(P=P, ndofs=m.num_dofs(P), smoother_iters=smoother_iters,
                      shape=shape,
                      line_axis=line_axis if line_axis is not None else 2)
        lv["lmax"] = _calibrate(ops, lv, level,
                                torch.ones(shape, dtype=dtype, device=device),
                                calibration_iters)
        levels.append(level)
        level_data.append(lv)

    data = dict(levels=level_data, transfer=_transfers(meshes, P, dtype,
                                                        device))
    bottom = _bottom(bottom, meshes, P, "build_hmg")
    if bottom == "direct":
        from .pmg import dense_cholesky

        data["coarse_chol"] = tensor(dense_cholesky(meshes[0], P, kassemble,
                                                    sigma))
    return tuple(levels), data, bottom


def coarsen_cell_field(vals, nc_fine, nc_coarse, h_cells=None):
    """Volume-average a per-cell DG-0 field onto a coarser cell grid (each
    coarse cell averages its children); ``h_cells`` (a graded mesh's cell
    widths) weights the children by their volumes."""
    fx, fy, fz = (nf // nc for nf, nc in zip(nc_fine, nc_coarse))
    vals = np.asarray(vals)
    tail = vals.shape[1:]  # () for scalars, (3, 3) for tensor kappa
    v = vals.reshape(nc_fine + tail)
    v = v.reshape((nc_coarse[0], fx, nc_coarse[1], fy, nc_coarse[2], fz)
                  + tail)
    if h_cells is None:
        return v.mean(axis=(1, 3, 5)).reshape((-1,) + tail)
    hx, hy, hz = (np.asarray(h, np.float64) for h in h_cells)
    w = (hx.reshape(nc_coarse[0], fx)[:, :, None, None, None, None]
         * hy.reshape(nc_coarse[1], fy)[None, None, :, :, None, None]
         * hz.reshape(nc_coarse[2], fz)[None, None, None, None, :, :])
    w = w / w.sum(axis=(1, 3, 5), keepdims=True)
    w = w.reshape(w.shape + (1,) * len(tail))
    return (v * w).sum(axis=(1, 3, 5)).reshape((-1,) + tail)


def build_hmg_general(mesh, P, kappa, dtype, smoother_iters=2, min_cells=2,
                      max_levels=10, precision="highest",
                      calibration_iters=20, bottom="direct", sigma=0.0,
                      sizes=None, smoother="cheb", sigma_field=None, *,
                      device):
    """``(levels, data, bottom, ops)`` of the rediscretised lattice
    h-hierarchy (curved `PerturbedBoxMesh` hexes or boxes) on ``device``.

    Every level is a mesh of the same class on coarsened cell counts (the
    perturbed mesh's warp evaluated at the coarse corners, an exact subset
    of the fine ones), with its own geometry factors; a kappa array or
    tensor is volume-averaged onto each level's cells (a callable is
    sampled at each level's centroids) and the sigma shift, a sigma field
    and Robin faces use each level's own lumped and boundary masses. Transfers are the reference-coordinate nodal
    interpolation of `axis_h_interpolation`. ``ops`` is the plain torch
    `lattice_cycle_ops` (flat vectors)."""
    from ..fem.assembly import (
        general_shift_np,
        geometry_factors_np,
        ops_shift_scalar,
        resolve_kappa,
        scale_G,
        stiffness_diagonal_np,
    )
    from ..fem.mesh import PerturbedBoxMesh
    from ..ops.lattice import geometry_to_qlattice, lattice_mats
    from .pmg import Level, lattice_cycle_ops

    sizes = _level_sizes(mesh, sizes, min_cells, max_levels)
    if isinstance(mesh, PerturbedBoxMesh):
        make = _level_mesh(mesh, PerturbedBoxMesh, warp=mesh._warp)
    else:
        make = _level_mesh(mesh, BoxMesh)
    meshes = [_same_or(mesh, nc, make) for nc in sizes]
    kappa_fine, _ = resolve_kappa(mesh, kappa)
    ops_sigma = ops_shift_scalar(mesh, sigma)
    ops = lattice_cycle_ops(precision, sigma=ops_sigma)
    schwarz = smoother == "schwarz"
    line_axis = (None if schwarz
                 else parse_line_smoother(smoother, mesh, kappa))
    tensor = lambda a: torch.as_tensor(a, dtype=dtype, device=device)

    def coarsen(m):
        """The level's per-cell coefficient (scalar or tensor)."""
        if callable(kappa):
            return resolve_kappa(m, kappa)[0]
        return coarsen_cell_field(
            kappa_fine, mesh.nc, m.nc,
            h_cells=mesh.h_cells if mesh.is_graded else None)

    levels, level_data = [], []
    for m in meshes:
        kc = coarsen(m)
        kfold = kc if kc.ndim == 3 else None  # a tensor folds into G
        G_cells, _ = geometry_factors_np(m, P, kappa=kfold)
        lv = lattice_mats(m.nc, P, dtype, device)
        lv["G"] = tensor(geometry_to_qlattice(scale_G(G_cells, kc, kfold),
                                              m.nc, P))
        lv["bc_marker"] = torch.tensor(m.boundary_dof_marker(P),
                                          device=device)
        diag = stiffness_diagonal_np(m, P, kc)
        if ops_sigma:
            m3 = general_shift_np(m, P, sigma, sigma_field)[1]
            lv["m3"] = tensor(m3)
            diag = diag + ops_sigma * m3
        lv["diag_inv"] = tensor(1.0 / diag)
        if line_axis is not None:
            lv["line_inv"] = tensor(line_block_inverses(
                m, P, kc, line_axis, sigma=sigma))
        elif schwarz:
            from .schwarz import build_schwarz

            # the separable approximation: per-cell (volume-averaged)
            # coefficients on the nominal box geometry
            lv["schwarz"] = build_schwarz(m, P, kc, dtype,
                                          sigma=sigma, device=device)
        level = Level(P=P, ndofs=m.num_dofs(P),
                      smoother_iters=smoother_iters,
                      shape=m.lattice_shape(P),
                      line_axis=line_axis if line_axis is not None else 2)
        lv["lmax"] = _calibrate(
            ops, lv, level,
            torch.ones(level.ndofs, dtype=dtype, device=device),
            calibration_iters)
        levels.append(level)
        level_data.append(lv)

    data = dict(levels=level_data, transfer=_transfers(meshes, P, dtype,
                                                        device))
    bottom = _bottom(bottom, meshes, P, "build_hmg_general")
    if bottom == "direct":
        from .pmg import dense_cholesky

        data["coarse_chol"] = tensor(dense_cholesky(
            meshes[0], P, coarsen(meshes[0]), sigma, sigma_field))
    return tuple(levels), data, bottom, ops
