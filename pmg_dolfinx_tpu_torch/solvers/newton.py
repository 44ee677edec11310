"""Inexact Newton-Krylov for semilinear reaction-diffusion problems.

Port of `pmg_dolfinx_tpu.solvers.newton`. The discrete
system, with the nonlinear reaction collocated through the lumped mass,

    F(u) = A u + m3 * N(u) - b = 0,

where ``A`` is the fine-level operator of a built hierarchy (any backend,
with its own ``sigma``/Robin shift), ``m3`` the bc-zeroed lumped mass
and ``N`` a `models.semilinear.Nonlinearity`. Each Newton step solves

    J(u_k) du = -F(u_k),    J(u) x = A x + m3 * N'(u) * x

matrix-free with flexible CG preconditioned by the hierarchy's frozen
V-cycle (which ignores the reaction; FCG absorbs the lag), to the
tolerance of a simplified Eisenstat-Walker forcing sequence. On
``operator="kron_blocked"`` every apply and V-cycle runs the CUDA
kernels #1-#3 (and #4/#7, #10/#11 when the hierarchy fuses them).

The JAX package jits a residual and a step program per ``(nonlinearity,
lin_maxiter)`` and caches them on the hierarchy; here nothing compiles,
so each call builds its plain closures anew. On the slab and the grid
the same closures run on the stacked layout (`solvers.shardwrap`).
"""

import numpy as np
import torch

from ..fem.assembly import lumped_mass_np
from .cg import fcg_solve
from .pmg import v_cycle
from .shardwrap import layout_converters

# Simplified Eisenstat-Walker (choice 2) forcing parameters.
EW_ETA0 = 1e-2
EW_ETA_MAX = 1e-2
EW_ETA_MIN = 1e-10
EW_GAMMA = 0.9


def _make_programs(hier, nonlin, lin_maxiter):
    """``(resid, step)`` closures for this hierarchy and nonlinearity."""
    ops = hier._ops
    levels = hier.levels
    fine = levels[-1]
    coarse, coarse_cfg = hier.coarse, hier.coarse_cfg
    N, dN = nonlin.N, nonlin.dN

    def resid(data, u, bw, m3w):
        lv = data["levels"][-1]
        F = ops["apply"](lv, u, fine) + m3w * N(u) - bw
        return torch.sqrt(ops["dot"](F, F, lv))

    def step(data, u, bw, m3w, eta, damp):
        lv = data["levels"][-1]
        A = lambda x: ops["apply"](lv, x, fine)
        F = A(u) + m3w * N(u) - bw
        w = dN(u)
        J = lambda x: A(x) + m3w * w * x
        M = lambda r: v_cycle(
            data, r, torch.zeros_like(r),
            levels=levels, coarse=coarse, coarse_cfg=coarse_cfg, ops=ops,
        )
        du, info = fcg_solve(
            J, -F, torch.zeros_like(u), M,
            rtol=eta, maxiter=lin_maxiter,
            dot=lambda a, c: ops["dot"](a, c, lv),
        )
        return u + damp * du, info["niter"]

    return resid, step


def newton_solve(hier, b, nonlin, *, rtol=1e-9, atol=0.0, maxiter=20,
                 lin_rtol=None, lin_maxiter=60, u0=None, damping=1.0):
    """Solve ``A u + m3 N(u) = b`` by V-cycle-preconditioned inexact
    Newton.

    ``hier`` is a built `PMGHierarchy`, `DistPMG` or `GridPMG` (its
    linear operator, shift included, is ``A``); ``b`` the global flat rhs
    with zero Dirichlet rows; ``nonlin`` a
    `models.semilinear.Nonlinearity`. Stops when ``|F|
    <= rtol |F(u0)| + atol``. ``lin_rtol`` fixes the inner FCG tolerance;
    None is the Eisenstat-Walker forcing ``eta_k = clip(0.9 (|F_k| /
    |F_{k-1}|)^2, 1e-10, 1e-2)``. ``damping`` scales every step.

    Returns ``(u, info)``: ``u`` flat on the hierarchy's device, ``info =
    dict(niter, fnorms, lin_iters, converged)`` with ``fnorms[k] =
    |F(u_k)|`` (the final iterate included). One host read per Newton
    step for ``|F|``, and one per FCG iteration.
    """
    fine = hier.levels[-1]
    resid_fn, step_fn = _make_programs(hier, nonlin, int(lin_maxiter))

    to_w, from_w = layout_converters(hier)
    bw = to_w(b)
    m3 = lumped_mass_np(hier.mesh, fine.P, bc_zero=True)
    m3w = to_w(m3)
    uw = torch.zeros_like(bw) if u0 is None else to_w(u0)

    fnorms, lin_iters = [], []
    f_prev = None
    eta = float(lin_rtol) if lin_rtol is not None else EW_ETA0
    converged = False
    for _ in range(int(maxiter)):
        f_k = float(resid_fn(hier.data, uw, bw, m3w))
        fnorms.append(f_k)
        f0 = fnorms[0]
        if f_k <= rtol * f0 + atol:
            converged = True
            break
        if lin_rtol is None and f_prev is not None and f_prev > 0:
            eta = float(np.clip(EW_GAMMA * (f_k / f_prev) ** 2,
                                EW_ETA_MIN, EW_ETA_MAX))
        f_prev = f_k
        uw, nit = step_fn(hier.data, uw, bw, m3w, eta, float(damping))
        lin_iters.append(int(nit))
    else:
        # Loop exhausted: record the final residual for the caller.
        fnorms.append(float(resid_fn(hier.data, uw, bw, m3w)))
        converged = fnorms[-1] <= rtol * fnorms[0] + atol

    return from_w(uw), dict(
        niter=len(lin_iters), fnorms=fnorms, lin_iters=lin_iters,
        converged=converged,
    )
