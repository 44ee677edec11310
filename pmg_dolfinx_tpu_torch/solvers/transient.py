"""Transient problems on the shifted (reaction-diffusion) family: the heat
equation ``u_t - div(kappa grad u) = f`` (backward Euler / Crank-Nicolson)
and the wave equation ``u_tt - div(kappa grad u) = f`` (Newmark-beta and
leapfrog).

Port of `pmg_dolfinx_tpu.solvers.transient`. With GLL-lumped mass M the
implicit left operators are the framework's shifted form ``A + sigma M``
(``sigma = 1/dt``, CN halves kappa; Newmark ``sigma = 1/(beta dt^2)``),
so on an axis-aligned box every step is one exact FDM direct solve, and
on a curved mesh one FCG(V) solve of a shifted hierarchy. Each JAX
``lax.scan`` is a Python loop over the steps here, on the device, with
the per-step source factors in one device tensor indexed per step: the
scanned evolvers read nothing back to the host inside their loops.
`heat_pcg_evolve` and `wave_pcg_evolve` are host loops in both packages
and return their per-step FCG counts.

The serving evolvers (`heat_packed_evolve`, `wave_packed_evolve`) step a
batch of trajectories through `ops.kron_packed` (the CUDA kernels on a
CUDA device): pack once, step in the working layout, unpack at the end;
homogeneous Dirichlet data, states ``(B, ndofs)``, float32.

Kappa is a scalar, a per-axis tuple or a constant diagonal tensor on the
FDM and serving paths (`_half_kappa` halves each for CN); graded spacing,
mixed Dirichlet/Neumann faces and Robin ends ride the per-axis factors of
every box evolver. Not ported yet: the semilinear evolvers (need `models/semilinear.py`)
and `convdiff_fdm_evolve` (needs the advection terms); ROADMAP.md Queue 1
item 9.
"""

import numpy as np
import torch

from ..fem.assembly import lumped_mass_np
from ..ops.kron_blocked import _check_precision
from .fdm import FastDiagonalizationSolver


def source_scales(f_time, dt, nsteps, when):
    """Per-step source factors ``g(t_n)`` of a separable load
    ``f(x, t) = g(t) f(x)``, evaluated on the host at the scheme's times:
    ``when='end'`` (t_{n+1}: BE, Newmark), ``'mid'`` (t_{n+1/2}: CN),
    ``'start'`` (t_n). ``f_time=None`` gives ones."""
    if f_time is None:
        return np.ones(nsteps)
    off = {"end": 1.0, "mid": 0.5, "start": 0.0}[when]
    return np.array([float(f_time(dt * (n + off))) for n in range(nsteps)],
                    dtype=np.float64)


def _half_kappa(kappa):
    """kappa/2 for scalar, per-axis and diagonal-tensor coefficients. A
    per-axis 3-tuple stays a tuple: `resolve_kappa_axes` recognizes the
    per-axis form by tuple-ness (a (3,) array reads as a per-cell
    field)."""
    if np.isscalar(kappa):
        return 0.5 * float(kappa)
    if (isinstance(kappa, (tuple, list)) and len(kappa) == 3
            and all(np.ndim(k) == 0 for k in kappa)):
        return tuple(0.5 * float(k) for k in kappa)
    k = np.asarray(kappa, dtype=np.float64)
    return 0.5 * k


def _lattice_vectors(mesh, P, f, dtype, device):
    """``(shape, bc, m3, fvec)`` on the lattice: the Dirichlet marker, the
    bc-zeroed lumped mass and the load (zeros without ``f``)."""
    shape = mesh.lattice_shape(P)
    bc = torch.tensor(mesh.boundary_dof_marker(P), device=device).reshape(shape)
    m3 = torch.tensor(lumped_mass_np(mesh, P, bc_zero=True), dtype=dtype,
                      device=device).reshape(shape)
    fvec = (torch.zeros(shape, dtype=dtype, device=device) if f is None
            else torch.tensor(np.asarray(f).reshape(shape), dtype=dtype,
                              device=device))
    return shape, bc, m3, fvec


def _scales(f_time, dt, nsteps, when, dtype, device):
    return torch.tensor(source_scales(f_time, dt, nsteps, when), dtype=dtype,
                        device=device)


def _g(f_time, t):
    return 1.0 if f_time is None else float(f_time(t))


def heat_fdm_evolve(mesh, P, kappa=1.0, dt=1e-2, scheme="cn",
                    dtype=torch.float64, precision="highest", f=None,
                    f_time=None, *, device):
    """``evolve(u0, nsteps) -> u_T`` (lattice-shaped) on an axis-aligned
    box: one FDM direct solve per step. ``scheme`` 'be' (O(dt)) or 'cn'
    (O(dt^2), the right side ``2 (M/dt) u - A u`` through one shifted kron
    apply). ``f`` is an assembled load (Dirichlet rows zeroed), ``f_time``
    its separable time factor. ``u0`` carries the Dirichlet data."""
    from ..ops.kron import KronLaplacian

    if scheme not in ("be", "cn"):
        raise ValueError(f"scheme must be 'be' or 'cn', got {scheme!r}")
    _check_precision(precision)
    sigma = 1.0 / float(dt)
    shape, bc, m3, fvec = _lattice_vectors(mesh, P, f, dtype, device)

    if scheme == "be":
        solver = FastDiagonalizationSolver(mesh, P, kappa=kappa, dtype=dtype,
                                           sigma=sigma, device=device)

        def step(u, g):
            rhs = torch.where(bc, u, sigma * m3 * u + g * fvec)
            return solver.solve(rhs)
    else:
        kap_half = _half_kappa(kappa)
        solver = FastDiagonalizationSolver(mesh, P, kappa=kap_half,
                                           dtype=dtype, sigma=sigma,
                                           device=device)
        op = KronLaplacian(mesh, P, kappa=kap_half, dtype=dtype, sigma=sigma,
                           device=device)

        def step(u, g):
            Au = op(u.reshape(-1)).reshape(shape)
            rhs = 2.0 * sigma * m3 * u - Au + g * fvec
            return solver.solve(torch.where(bc, u, rhs))

    when = "end" if scheme == "be" else "mid"

    def evolve(u0, nsteps):
        u = torch.as_tensor(u0).to(device=device, dtype=dtype).reshape(shape)
        g = _scales(f_time, dt, int(nsteps), when, dtype, device)
        for n in range(int(nsteps)):
            u = step(u, g[n])
        return u

    return evolve


def _packed_bundle(mesh, P, B, device):
    """Factories of the serving steppers' classes and their unpack: ``B ==
    1`` goes through the single-RHS classes, ``B >= 2`` through the batch
    classes; states are ``(B, ndofs)`` either way. A class's ``pack``
    takes a state, or one vector shared by every column (it broadcasts
    over the batch)."""
    from ..ops import kron_packed as kp

    if B == 1:
        op_cls, fdm_cls, kw = kp.PackedKronSingle, kp.PackedFDMSingle, {}
    else:
        op_cls, fdm_cls, kw = kp.PackedKronBatch, kp.PackedFDMBatch, {"B": B}
    mk_op = lambda **k: op_cls(mesh, P, device=device, **kw, **k)
    mk_fdm = lambda **k: fdm_cls(mesh, P, device=device, **kw, **k)
    unpack = lambda ref, PT: ref.unpack(PT).reshape(B, -1)
    return mk_op, mk_fdm, unpack


def heat_packed_evolve(mesh, P, kappa=1.0, dt=1e-2, B=8, scheme="cn",
                       interpret=False, f=None, f_time=None, *, device):
    """``evolve(U0[(B, ndofs)], nsteps) -> U_T`` stepping a batch of
    trajectories through the serving kernels (float32, NZ <= 64): one
    packed FDM direct solve per step; CN by the exact-inverse identity
    ``u1 = A^{-1}(2 sigma M u + f) - u`` with ``A = K/2 + M/dt``.
    Homogeneous Dirichlet data; ``f`` / ``f_time`` as in
    `heat_fdm_evolve`, shared by every column. ``interpret`` is the JAX
    package's Pallas interpret mode (``False`` only)."""
    from ..ops.kron_blocked import _tpu_knob

    _tpu_knob("interpret", interpret, False)
    if scheme not in ("be", "cn"):
        raise ValueError(f"scheme must be 'be' or 'cn', got {scheme!r}")
    _, mk_fdm, unpack = _packed_bundle(mesh, P, B, device)
    sigma = 1.0 / float(dt)
    kap_op = _half_kappa(kappa) if scheme == "cn" else kappa
    fdm = mk_fdm(kappa=kap_op, sigma=sigma)
    m3p = fdm.pack(lumped_mass_np(mesh, P, bc_zero=True))
    fp = None if f is None else fdm.pack(np.asarray(f))

    def step(Pu, g):
        if scheme == "be":
            rhs = sigma * m3p * Pu
            if fp is not None:
                rhs = rhs + g * fp
            return fdm.solve_packed(rhs)
        rhs = 2.0 * sigma * m3p * Pu
        if fp is not None:
            rhs = rhs + g * fp
        return fdm.solve_packed(rhs) - Pu

    when = "end" if scheme == "be" else "mid"

    def evolve(U0, nsteps):
        g = _scales(f_time, dt, int(nsteps), when, torch.float32, device)
        Pu = fdm.pack(U0)
        for n in range(int(nsteps)):
            Pu = step(Pu, g[n])
        return unpack(fdm, Pu)

    return evolve


def wave_newmark_evolve(mesh, P, kappa=1.0, dt=1e-2, beta=0.25, gamma=0.5,
                        dtype=torch.float64, precision="highest", f=None,
                        f_time=None, *, device):
    """``evolve(u0, v0, nsteps) -> (u_T, v_T)`` for ``M u_tt + K u = f`` on an
    axis-aligned box: Newmark-beta in predictor form, one FDM direct solve
    per step with ``sigma = 1/(beta dt^2)``. ``(1/4, 1/2)`` (the default)
    conserves the discrete energy exactly; ``gamma > 1/2`` damps. ``f`` /
    ``f_time`` as in `heat_fdm_evolve` (evaluated at t_{n+1})."""
    from ..ops.kron import KronLaplacian

    if not (beta > 0.0 and gamma >= 0.5):
        raise ValueError(f"need beta > 0, gamma >= 1/2, got {beta}, {gamma}")
    _check_precision(precision)
    c0 = 1.0 / (beta * dt * dt)
    shape, bc, m3, fvec = _lattice_vectors(mesh, P, f, dtype, device)
    m3safe = torch.where(bc, torch.ones_like(m3), m3)
    solver = FastDiagonalizationSolver(mesh, P, kappa=kappa, dtype=dtype,
                                       sigma=c0, device=device)
    op = KronLaplacian(mesh, P, kappa=kappa, dtype=dtype, device=device)

    def step(u, v, a, g):
        ustar = u + dt * v + ((0.5 - beta) * dt * dt) * a
        u1 = solver.solve(torch.where(bc, u, g * fvec + c0 * m3 * ustar))
        a1 = torch.where(bc, 0.0, c0 * (u1 - ustar))
        v1 = v + dt * ((1.0 - gamma) * a + gamma * a1)
        return u1, v1, a1

    def evolve(u0, v0, nsteps):
        g = _scales(f_time, dt, int(nsteps), "end", dtype, device)
        u = torch.as_tensor(u0).to(device=device, dtype=dtype).reshape(shape)
        v = torch.as_tensor(v0).to(device=device, dtype=dtype).reshape(shape)
        v = torch.where(bc, 0.0, v)
        Ku = op(u.reshape(-1)).reshape(shape)
        a = torch.where(bc, 0.0, (_g(f_time, 0.0) * fvec - Ku) / m3safe)
        for n in range(int(nsteps)):
            u, v, a = step(u, v, a, g[n])
        return u, v

    return evolve


def wave_packed_evolve(mesh, P, kappa=1.0, dt=1e-2, B=8, scheme="newmark",
                       beta=0.25, gamma=0.5, interpret=False, f=None,
                       f_time=None, *, device):
    """``evolve(U0, V0[(B, ndofs)], nsteps) -> (U_T, V_T)`` through the
    serving kernels (float32, NZ <= 64, homogeneous Dirichlet):
    ``'newmark'`` is one packed FDM solve per step (its start acceleration
    one packed apply), ``'leapfrog'`` one packed apply per step
    (conditionally stable, `wave_stable_dt`). The packed mass and interior
    mask keep Dirichlet rows exactly zero. ``interpret`` is the JAX
    package's Pallas interpret mode (``False`` only)."""
    from ..ops.kron_blocked import _tpu_knob

    _tpu_knob("interpret", interpret, False)
    if scheme not in ("newmark", "leapfrog"):
        raise ValueError(
            f"scheme must be 'newmark' or 'leapfrog', got {scheme!r}")
    mk_op, mk_fdm, unpack = _packed_bundle(mesh, P, B, device)
    op0 = mk_op(kappa=kappa)
    bc = np.asarray(mesh.boundary_dof_marker(P))
    m3p = op0.pack(lumped_mass_np(mesh, P, bc_zero=True))
    mask = op0.pack((~bc).astype(np.float32))
    m3div = torch.where(m3p > 0, m3p, torch.ones_like(m3p))
    fp = None if f is None else op0.pack(np.asarray(f))

    def accel(Pu, g):
        Ku = op0.apply_packed(Pu)
        num = (g * fp - Ku) if fp is not None else -Ku
        return mask * num / m3div

    if scheme == "newmark":
        if not (beta > 0.0 and gamma >= 0.5):
            raise ValueError(
                f"need beta > 0, gamma >= 1/2, got {beta}, {gamma}")
        c0 = 1.0 / (beta * dt * dt)
        fdm = mk_fdm(kappa=kappa, sigma=c0)

        def evolve(U0, V0, nsteps):
            g = _scales(f_time, dt, int(nsteps), "end", torch.float32, device)
            u = op0.pack(U0)
            v = mask * op0.pack(V0)
            a = accel(u, _g(f_time, 0.0))
            for n in range(int(nsteps)):
                ustar = u + dt * v + ((0.5 - beta) * dt * dt) * a
                rhs = c0 * m3p * ustar
                if fp is not None:
                    rhs = rhs + g[n] * fp
                u1 = fdm.solve_packed(rhs)
                a1 = mask * c0 * (u1 - ustar)
                v = v + dt * ((1.0 - gamma) * a + gamma * a1)
                u, a = u1, a1
            return unpack(op0, u), unpack(op0, v)
    else:
        def evolve(U0, V0, nsteps):
            if int(nsteps) < 1:
                raise ValueError(
                    f"leapfrog needs nsteps >= 1, got {nsteps}")
            # Steps use t_n for n = 1..nsteps-1; start g(0), end g(T).
            g = _scales(f_time, dt, int(nsteps) - 1, "end", torch.float32,
                        device)
            u = op0.pack(U0)
            v = mask * op0.pack(V0)
            um1, u = u, u + dt * v + (0.5 * dt * dt) * accel(u, _g(f_time,
                                                                   0.0))
            for n in range(int(nsteps) - 1):
                um1, u = u, 2.0 * u - um1 + (dt * dt) * accel(u, g[n])
            vT = (u - um1) / dt + (0.5 * dt) * accel(
                u, _g(f_time, dt * int(nsteps)))
            return unpack(op0, u), unpack(op0, vT)

    return evolve


def wave_stable_dt(mesh, P, kappa=1.0):
    """Exact leapfrog stability bound ``dt_max = 2 / sqrt(lambda_max(M^{-1}
    K))``, from the FDM eigenvalue sums (float64, on the host)."""
    s = FastDiagonalizationSolver(mesh, P, kappa=kappa, dtype=torch.float64,
                                  device="cpu")
    lam_max = float((1.0 / s.dinv).max())
    return 2.0 / np.sqrt(lam_max)


def wave_leapfrog_evolve(mesh, P, kappa=1.0, dt=1e-2, dtype=torch.float64,
                         precision="highest", f=None, f_time=None, *, device):
    """Explicit central-difference ``evolve(u0, v0, nsteps) -> (u_T, v_T)``:
    one kron apply and pointwise updates per step, conditionally stable
    (``dt < wave_stable_dt``), O(dt^2); ``v_T = (u^N - u^{N-1})/dt +
    (dt/2) a^N``."""
    from ..ops.kron import KronLaplacian

    _check_precision(precision)
    shape, bc, m3, fvec = _lattice_vectors(mesh, P, f, dtype, device)
    m3safe = torch.where(bc, torch.ones_like(m3), m3)
    op = KronLaplacian(mesh, P, kappa=kappa, dtype=dtype, device=device)

    def accel(u, g):
        Ku = op(u.reshape(-1)).reshape(shape)
        return torch.where(bc, 0.0, (g * fvec - Ku) / m3safe)

    def evolve(u0, v0, nsteps):
        if int(nsteps) < 1:
            raise ValueError(
                f"leapfrog needs nsteps >= 1 (the Taylor start IS the "
                f"first step), got {nsteps}")
        g = _scales(f_time, dt, int(nsteps) - 1, "end", dtype, device)
        u0 = torch.as_tensor(u0).to(device=device, dtype=dtype).reshape(shape)
        v0 = torch.as_tensor(v0).to(device=device, dtype=dtype).reshape(shape)
        v0 = torch.where(bc, 0.0, v0)
        # Taylor start: u^1 = u^0 + dt v^0 + (dt^2/2) a^0.
        um1, u = u0, torch.where(
            bc, u0, u0 + dt * v0 + (0.5 * dt * dt) * accel(u0,
                                                           _g(f_time, 0.0)))
        for n in range(int(nsteps) - 1):
            um1, u = u, torch.where(
                bc, u, 2.0 * u - um1 + (dt * dt) * accel(u, g[n]))
        vT = (u - um1) / dt + (0.5 * dt) * accel(
            u, _g(f_time, dt * int(nsteps)))
        return u, vT

    return evolve


def wave_pcg_evolve(hier, mesh, P, dt, beta=0.25, gamma=0.5, rtol=1e-9,
                    f=None):
    """Newmark-beta ``evolve(u0, v0, nsteps) -> (u_T, v_T, iters)`` for the
    general family: ``hier`` built with ``sigma = 1/(beta dt^2)`` and the
    unscaled kappa; each step one FCG(V) solve in error form around the
    predictor ``u*``. Host loop; per-step FCG counts."""
    if not (beta > 0.0 and gamma >= 0.5):
        raise ValueError(f"need beta > 0, gamma >= 1/2, got {beta}, {gamma}")
    c0 = 1.0 / (beta * dt * dt)
    dtype, device = hier.dtype, hier.device
    bc = torch.tensor(mesh.boundary_dof_marker(P), device=device)
    m3 = torch.tensor(lumped_mass_np(mesh, P, bc_zero=True), dtype=dtype,
                      device=device)
    m3safe = torch.where(bc, torch.ones_like(m3), m3)
    fvec = (torch.zeros_like(m3) if f is None
            else torch.tensor(np.asarray(f).reshape(-1), dtype=dtype,
                              device=device))
    A = hier.operator()  # shifted apply A + sigma M (flat contract)

    def evolve(u0, v0, nsteps):
        u = torch.as_tensor(u0).to(device=device, dtype=dtype).reshape(-1)
        v = torch.as_tensor(v0).to(device=device, dtype=dtype).reshape(-1)
        v = torch.where(bc, 0.0, v)
        # a0 = M^{-1}(f - K u0), K u = A_sigma u - sigma M u.
        Ku = A(u) - c0 * m3 * u
        a = torch.where(bc, 0.0, (fvec - Ku) / m3safe)
        iters = []
        for _ in range(int(nsteps)):
            ustar = u + dt * v + ((0.5 - beta) * dt * dt) * a
            res = torch.where(bc, 0.0, fvec + c0 * m3 * ustar - A(ustar))
            e, niter = hier.solve_pcg(res, rtol=rtol)
            u = ustar + e
            a1 = torch.where(bc, 0.0, c0 * e)
            v = v + dt * ((1.0 - gamma) * a + gamma * a1)
            a = a1
            iters.append(int(niter))
        return u, v, iters

    return evolve


def heat_pcg_evolve(hier, mesh, P, dt, scheme="cn", rtol=1e-9, f=None):
    """``evolve(u0, nsteps) -> (u_T, iters)`` for the general family: each
    step one FCG(V) solve of the shifted hierarchy (``hier`` built with
    ``sigma = 1/dt``, and kappa/2 for CN) in error form around ``u^n``.
    Host loop; per-step FCG counts."""
    if scheme not in ("be", "cn"):
        raise ValueError(f"scheme must be 'be' or 'cn', got {scheme!r}")
    sigma = 1.0 / float(dt)
    dtype, device = hier.dtype, hier.device
    m3 = torch.tensor(lumped_mass_np(mesh, P, bc_zero=True), dtype=dtype,
                      device=device)
    fvec = (torch.zeros_like(m3) if f is None
            else torch.tensor(np.asarray(f).reshape(-1), dtype=dtype,
                              device=device))
    A = hier.operator()  # shifted fine-level apply (flat contract)

    def evolve(u0, nsteps):
        u = torch.as_tensor(u0).to(device=device, dtype=dtype).reshape(-1)
        iters = []
        for _ in range(int(nsteps)):
            Au = A(u)
            if scheme == "be":
                res = sigma * m3 * u + fvec - Au
            else:
                res = 2.0 * (sigma * m3 * u - Au) + fvec
            e, niter = hier.solve_pcg(res, rtol=rtol)
            u = u + e
            iters.append(int(niter))
        return u, iters

    return evolve


def heat_pcg_evolve_scanned(hier, mesh, P, dt, scheme="cn", inner_iters=5,
                            f=None, f_time=None):
    """``evolve(u0, nsteps) -> u_T``: the general-family stepper with a FIXED
    ``inner_iters`` FCG(V) iterations per step on the warm error form
    (`solvers.cg.fcg_solve_fixed`), so the step loop reads nothing back to
    the host. ``hier`` as in `heat_pcg_evolve`, a general backend
    ('dofmap', 'lattice', 'lattice_blocked'); use ``coarse='smoother'``:
    the 'cg' coarse solve reads its convergence flag on the host inside
    every V-cycle."""
    from .cg import fcg_solve_fixed
    from .pmg import v_cycle

    if scheme not in ("be", "cn"):
        raise ValueError(f"scheme must be 'be' or 'cn', got {scheme!r}")
    if hier.operator_kind in ("kron", "kron_blocked"):
        raise ValueError(
            "heat_pcg_evolve_scanned targets the GENERAL backends; the "
            "kron family has the exact FDM stepper (heat_fdm_evolve)")
    sigma = 1.0 / float(dt)
    dtype, device = hier.dtype, hier.device
    m3 = torch.tensor(lumped_mass_np(mesh, P, bc_zero=True), dtype=dtype,
                      device=device)
    fvec = (torch.zeros_like(m3) if f is None
            else torch.tensor(np.asarray(f).reshape(-1), dtype=dtype,
                              device=device))
    ops, data, fine = hier.ops, hier.data, hier.levels[-1]
    lvf = data["levels"][-1]
    A = lambda x: ops["apply"](lvf, x, fine)
    M = lambda r: v_cycle(data, r, torch.zeros_like(r), levels=hier.levels,
                          coarse=hier.coarse, coarse_cfg=hier.coarse_cfg,
                          ops=ops)
    dot = lambda a, b: ops["dot"](a, b, lvf)

    def evolve(u0, nsteps):
        nsteps = int(nsteps)
        g = _scales(f_time, dt, nsteps, "mid" if scheme == "cn" else "end",
                    dtype, device)
        u = torch.as_tensor(u0).to(device=device, dtype=dtype).reshape(-1)
        for n in range(nsteps):
            Au = A(u)
            if scheme == "be":
                res = sigma * m3 * u + g[n] * fvec - Au
            else:
                res = 2.0 * (sigma * m3 * u - Au) + g[n] * fvec
            e, _ = fcg_solve_fixed(A, res, torch.zeros_like(u), M, rtol=0.0,
                                   maxiter=inner_iters, dot=dot)
            u = u + e
        return u

    return evolve


def snapshot_evolve(evolve, state, nsteps, every):
    """Trajectory sampling over any evolver: run ``nsteps`` in chunks of
    ``every`` and keep the state after each chunk. Returns ``(snapshots,
    final_state)``, ``snapshots`` a list of ``(step_index, state)`` pairs
    (the final state included). ``state`` is one array (heat) or a tuple
    (wave: ``(u0, v0)``); ``evolve`` is called as ``evolve(*state, n)``.
    Each chunk restarts the evolver from the carried state: exact for the
    Markov-in-state schemes (heat BE/CN), up to the consistency identity
    for Newmark, a locally O(dt^3) Taylor restart for leapfrog."""
    nsteps, every = int(nsteps), int(every)
    if every < 1 or nsteps < 1:
        raise ValueError(
            f"need nsteps >= 1 and every >= 1, got {nsteps}, {every}")
    args = tuple(state) if isinstance(state, (tuple, list)) else (state,)
    snaps = []
    done = 0
    while done < nsteps:
        n = min(every, nsteps - done)
        out = evolve(*args, n)
        args = tuple(out) if isinstance(out, tuple) else (out,)
        done += n
        snaps.append((done, out))
    return snaps, snaps[-1][1]
