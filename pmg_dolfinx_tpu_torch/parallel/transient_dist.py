"""Sharded transient stepping: the heat, wave, semilinear and
convection-diffusion time loops on slab and 2D/3D grid layouts, every
shard stacked on one device.

Port of `pmg_dolfinx_tpu.parallel.transient_dist`. The single-device
evolvers (`solvers.transient`) take one exact FDM direct solve per step;
these take the distributed one (`parallel.fdm_dist`, pencil transposes
through `StackedGrid.all_to_all`), so no step gathers the lattice. JAX's
``lax.scan`` is a Python loop over the steps on the device, the per-step
source factors in one device tensor: nothing is read back to the host
between steps.

Every step is SOLVE-ONLY, because the FDM solve is exact:

- Crank-Nicolson: ``(M/dt + K/2) u^{n+1} = (M/dt - K/2) u^n + f`` and
  ``M/dt - K/2 = 2 M/dt - (M/dt + K/2)``, so ``u^{n+1} = A^{-1}(2 (M/dt)
  u^n + f) - u^n``: the explicit ``A u^n`` of the single-device path
  cancels against the exact inverse (the same trajectory to rounding);
- Newmark-beta is solve-only in predictor form; its one operator apply
  (the initial acceleration) is the single-device `KronLaplacian` at
  call time;
- leapfrog's forward apply is the mass-weighted eigen-transform form of
  `make_fdm_apply_dist`, on the same transposes.

Kappa is a scalar, per-axis tuple or constant diagonal tensor; graded
spacing, mixed Dirichlet/Neumann faces and Robin ends ride the fdm_dist
embeddings. States in and out are global flat vectors (numpy or tensors
in, tensors on ``device`` out).
"""

import numpy as np
import torch

from ..fem.assembly import lumped_mass_np
from ..solvers.transient import _g, _half_kappa, _scales
from .fdm_dist import DistFDM


def _dist_bundle(mesh, P, shards, kappa, sigma, dtype, precision,
                 devices, f, *, device):
    """``(dfdm, m3, m3d, fd_vec)``: the distributed solver of ``K + sigma
    M``, the bc-zeroed lumped mass (host and stacked) and the stacked
    load."""
    dfdm = DistFDM(mesh, P, shards, kappa=kappa, dtype=dtype,
                   precision=precision, sigma=sigma, devices=devices,
                   device=device)
    m3 = lumped_mass_np(mesh, P, bc_zero=True)
    m3d = dfdm.to_dist(m3)
    fvec = (np.zeros(mesh.num_dofs(P)) if f is None
            else np.asarray(f, dtype=np.float64).reshape(-1))
    return dfdm, m3, m3d, dfdm.to_dist(fvec)


def heat_dist_evolve(mesh, P, shards, kappa=1.0, dt=1e-2, scheme="cn",
                     dtype=torch.float64, precision="highest", f=None,
                     f_time=None, devices=None, *, device="cuda"):
    """Sharded ``evolve(u0, nsteps) -> u_T`` for the heat equation: BE or
    CN (by the exact-inverse identity), one distributed FDM solve per
    step. ``shards``: int (x-slab) or 3-tuple (device grid), as `DistFDM`.
    ``f`` is an optional time-independent load, ``f_time`` its separable
    time factor; ``u0`` carries the Dirichlet data."""
    if scheme not in ("be", "cn"):
        raise ValueError(f"scheme must be 'be' or 'cn', got {scheme!r}")
    sigma = 1.0 / float(dt)
    kap_op = _half_kappa(kappa) if scheme == "cn" else kappa
    dfdm, _, m3, fl = _dist_bundle(mesh, P, shards, kap_op, sigma, dtype,
                                   precision, devices, f,
                                   device=device)
    fd, solve = dfdm.data, dfdm._solve_local
    bc = fd["bc"]

    if scheme == "be":
        def step(u, g):
            return solve(fd, torch.where(bc, u, sigma * m3 * u + g * fl))
    else:
        # Dirichlet rows carry 2u, so the pass-through lands back on u
        # after the subtraction.
        def step(u, g):
            rhs = torch.where(bc, 2.0 * u, 2.0 * sigma * m3 * u + g * fl)
            return solve(fd, rhs) - u

    when = "end" if scheme == "be" else "mid"

    def evolve(u0, nsteps):
        u = dfdm.to_dist(u0)
        g = _scales(f_time, dt, int(nsteps), when, dtype, dfdm.device)
        for n in range(int(nsteps)):
            u = step(u, g[n])
        return dfdm.from_dist(u)

    return evolve


def wave_leapfrog_dist_evolve(mesh, P, shards, kappa=1.0, dt=1e-2,
                              dtype=torch.float64, precision="highest",
                              f=None, f_time=None, devices=None, *,
                              device="cuda"):
    """Sharded explicit leapfrog ``evolve(u0, v0, nsteps) -> (u_T, v_T)``:
    one distributed FORWARD apply per step (`make_fdm_apply_dist`, the
    mass-weighted eigen-transform form on the solve's transposes) and
    pointwise lumped updates. Conditionally stable with the single
    device's bound (`wave_stable_dt`: the same spectrum); the transform
    apply equals the kron apply to eigendecomposition rounding."""
    from .fdm_dist import dist_layout, make_fdm_apply_dist

    device = torch.device(device)
    part, grid, axes_spec, lat_spec = dist_layout(mesh, shards,
                                                  devices=devices,
                                                  device=device)
    fd, spec, apply_local = make_fdm_apply_dist(
        mesh, P, part, axes_spec, lat_spec, kappa, dtype,
        precision=precision, device=grid.build_device(device), grid=grid)
    fd = grid.place(fd, spec, device)
    glob, loc = mesh.lattice_shape(P), part.local_shape(P)

    def to_d(u):
        return grid.put_local(torch.as_tensor(u).reshape(glob), loc,
                              device=device, dtype=dtype)

    bc_np = np.asarray(mesh.boundary_dof_marker(P))
    m3 = lumped_mass_np(mesh, P, bc_zero=True)
    msl = to_d(np.where(bc_np, 1.0, m3))
    fl = to_d(np.zeros_like(m3) if f is None
              else np.asarray(f, dtype=np.float64).reshape(-1))
    bc = fd["bc"]

    def accel(u, g):
        Au = apply_local(fd, u)  # where(bc, u, A u_masked)
        return torch.where(bc, 0.0, (g * fl - Au) / msl)

    def evolve(u0, v0, nsteps):
        if int(nsteps) < 1:
            raise ValueError(
                f"leapfrog needs nsteps >= 1 (the Taylor start IS the "
                f"first step), got {nsteps}")
        g = _scales(f_time, dt, int(nsteps) - 1, "end", dtype, device)
        u0, v0 = to_d(u0), to_d(v0)
        v0 = torch.where(bc, 0.0, v0)
        um1, u = u0, torch.where(
            bc, u0, u0 + dt * v0 + (0.5 * dt * dt) * accel(u0, _g(f_time,
                                                                 0.0)))
        for n in range(int(nsteps) - 1):
            um1, u = u, torch.where(
                bc, u, 2.0 * u - um1 + (dt * dt) * accel(u, g[n]))
        vT = (u - um1) / dt + (0.5 * dt) * accel(
            u, _g(f_time, dt * int(nsteps)))
        return (grid.all_gather(u).reshape(-1),
                grid.all_gather(vT).reshape(-1))

    return evolve


def semilinear_dist_evolve(mesh, P, shards, nonlin, kappa=1.0, dt=1e-3,
                           scheme="cnab", sigma=0.0, dtype=torch.float64,
                           precision="highest", f=None, f_time=None,
                           devices=None, *, device="cuda"):
    """Sharded IMEX semilinear reaction-diffusion ``evolve(u0, nsteps) ->
    u_T``: the linear part implicit through the distributed FDM, the
    collocated reaction ``m3 N(u)`` explicit. The reaction is pointwise on
    consistent duplicated planes, so it needs no exchange. The schemes of
    `solvers.transient.semilinear_fdm_evolve` ('be', 'cnab')."""
    if scheme not in ("be", "cnab"):
        raise ValueError(f"scheme must be 'be' or 'cnab', got {scheme!r}")
    sdt = 1.0 / float(dt)
    if scheme == "be":
        kap_op, shift, when = kappa, float(sigma) + sdt, "end"
    else:
        kap_op, shift, when = (_half_kappa(kappa),
                               0.5 * float(sigma) + sdt, "mid")
    dfdm, _, m3, fl = _dist_bundle(mesh, P, shards, kap_op, shift, dtype,
                                   precision, devices, f,
                                   device=device)
    fd, solve = dfdm.data, dfdm._solve_local
    bc = fd["bc"]

    def run(u, g):
        if scheme == "be":
            for n in range(len(g)):
                rhs = torch.where(bc, u, sdt * m3 * u - m3 * nonlin.N(u)
                                  + g[n] * fl)
                u = solve(fd, rhs)
            return u
        N_m1 = nonlin.N(u)
        for n in range(len(g)):
            N_n = nonlin.N(u)
            S = g[n] * fl - m3 * (1.5 * N_n - 0.5 * N_m1)
            rhs = torch.where(bc, 2.0 * u, 2.0 * sdt * m3 * u + S)
            u, N_m1 = solve(fd, rhs) - u, N_n
        return u

    def evolve(u0, nsteps):
        g = _scales(f_time, dt, int(nsteps), when, dtype, dfdm.device)
        return dfdm.from_dist(run(dfdm.to_dist(u0), g))

    return evolve


def convdiff_dist_evolve(mesh, P, shards, velocity, kappa=1.0, dt=1e-3,
                         scheme="cnab", sigma=0.0, dtype=torch.float64,
                         precision="highest", f=None, f_time=None,
                         devices=None, *, device="cuda"):
    """Sharded IMEX convection-diffusion ``evolve(u0, nsteps) -> u_T``:
    the diffusion (and a ``sigma`` reaction, shift ``sigma + 1/dt`` for BE,
    ``sigma/2 + 1/dt`` with kappa/2 for CN) implicit through the
    distributed FDM, the separable advection explicit. The advection data
    follow the distributed Kronecker levels: the local 1D advection matrix
    of one shard (equal-cell shards), the per-axis masses in the
    duplicated-plane layout on a sharded axis, and each axis term's
    interface partials reconciled along that axis only
    (`grid2d._exchange_axis`). CNAB's diffusion half uses the
    exact-inverse identity, so a step is three advection contractions and
    one solve."""
    from ..ops.kron import (axis_advection, axis_stiffness_mass,
                            kron_advection_terms)
    from .grid2d import AXES, _exchange_axis
    from .multihost import take_block
    from .partition import duplicate_planes

    if scheme not in ("be", "cnab"):
        raise ValueError(f"scheme must be 'be' or 'cnab', got {scheme!r}")
    cvel = np.asarray(velocity, dtype=np.float64)
    if cvel.shape != (3,):
        raise ValueError(f"velocity must be a 3-vector, got {cvel.shape}")
    sdt = 1.0 / float(dt)
    kap_op = _half_kappa(kappa) if scheme == "cnab" else kappa
    shift = (0.5 * float(sigma) + sdt if scheme == "cnab"
             else float(sigma) + sdt)
    dfdm, _, m3, fl = _dist_bundle(mesh, P, shards, kap_op, shift, dtype,
                                   precision, devices, f,
                                   device=device)
    fd, solve, grid = dfdm.data, dfdm._solve_local, dfdm.grid
    sh3 = grid.shards
    loc = tuple(dfdm.part.local_shape(P))
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                  device=dfdm.device)
    Cs = tuple(t(axis_advection(mesh.nc[a] // sh3[a], P)) for a in range(3))
    ms = []
    for a in range(3):
        # the duplicated mass of a sharded axis, this rank's shards of it
        m_g = axis_stiffness_mass(mesh.nc[a], P, mesh.h_cells[a])[1]
        ms.append(t(take_block(duplicate_planes(m_g, loc[a], sh3[a]),
                               (AXES[a],), grid) if sh3[a] > 1 else m_g))
    cv = t(cvel)
    exchanges = tuple(
        (lambda v, a=a: _exchange_axis(v, grid, a)) if sh3[a] > 1 else None
        for a in range(3))
    bc = fd["bc"]

    def adv(u):
        w = torch.where(bc, torch.zeros_like(u), u)
        return kron_advection_terms(w, Cs, ms, cv, precision=precision,
                                    exchanges=exchanges)

    def run(u, g):
        if scheme == "be":
            for n in range(len(g)):
                rhs = torch.where(bc, u, sdt * m3 * u - adv(u) + g[n] * fl)
                u = solve(fd, rhs)
            return u
        # The exact-inverse identity for the CN diffusion half; AB2
        # advection in the explicit remainder S, started with adv(u0).
        adv_m1 = adv(u)
        for n in range(len(g)):
            adv_n = adv(u)
            S = g[n] * fl - (1.5 * adv_n - 0.5 * adv_m1)
            rhs = torch.where(bc, 2.0 * u, 2.0 * sdt * m3 * u + S)
            u, adv_m1 = solve(fd, rhs) - u, adv_n
        return u

    when = "end" if scheme == "be" else "mid"

    def evolve(u0, nsteps):
        g = _scales(f_time, dt, int(nsteps), when, dtype, dfdm.device)
        return dfdm.from_dist(run(dfdm.to_dist(u0), g))

    return evolve


def wave_newmark_dist_evolve(mesh, P, shards, kappa=1.0, dt=1e-2,
                             beta=0.25, gamma=0.5, dtype=torch.float64,
                             precision="highest", f=None, f_time=None,
                             devices=None, *, device="cuda"):
    """Sharded Newmark-beta ``evolve(u0, v0, nsteps) -> (u_T, v_T)``: one
    distributed FDM solve (``sigma = 1/(beta dt^2)``) per step plus
    pointwise updates. The initial acceleration's one operator apply is
    the single-device `KronLaplacian` at call time (set-up work, read
    back to the host as in the JAX package); every step is gather-free."""
    from ..ops.kron import KronLaplacian

    if not (beta > 0.0 and gamma >= 0.5):
        raise ValueError(f"need beta > 0, gamma >= 1/2, got {beta}, {gamma}")
    c0 = 1.0 / (beta * dt * dt)
    dfdm, m3_np, m3, fl = _dist_bundle(mesh, P, shards, kappa, c0, dtype,
                                       precision, devices, f,
                                       device=device)
    fd, solve = dfdm.data, dfdm._solve_local
    bc = fd["bc"]
    bc_np = np.asarray(mesh.boundary_dof_marker(P))
    m3safe = np.where(bc_np, 1.0, m3_np)
    fvec_np = (np.zeros_like(m3_np) if f is None
               else np.asarray(f, dtype=np.float64).reshape(-1))
    op = KronLaplacian(mesh, P, kappa=kappa, dtype=dtype,
                       precision=precision, device=dfdm.device)

    def evolve(u0, v0, nsteps):
        u0 = np.asarray(torch.as_tensor(u0).detach().cpu(),
                        dtype=np.float64).reshape(-1)
        v0 = np.where(bc_np, 0.0, np.asarray(
            torch.as_tensor(v0).detach().cpu(), dtype=np.float64).reshape(-1))
        Ku = np.asarray(op(torch.as_tensor(u0, dtype=dtype,
                                           device=dfdm.device)).cpu(),
                        dtype=np.float64).reshape(-1)
        a0 = np.where(bc_np, 0.0, (_g(f_time, 0.0) * fvec_np - Ku) / m3safe)
        g = _scales(f_time, dt, int(nsteps), "end", dtype, dfdm.device)
        u, v, a = dfdm.to_dist(u0), dfdm.to_dist(v0), dfdm.to_dist(a0)
        for n in range(int(nsteps)):
            ustar = u + dt * v + ((0.5 - beta) * dt * dt) * a
            u1 = solve(fd, torch.where(bc, u, g[n] * fl + c0 * m3 * ustar))
            a1 = torch.where(bc, 0.0, c0 * (u1 - ustar))
            v = v + dt * ((1.0 - gamma) * a + gamma * a1)
            u, a = u1, a1
        return dfdm.from_dist(u), dfdm.from_dist(v)

    return evolve
