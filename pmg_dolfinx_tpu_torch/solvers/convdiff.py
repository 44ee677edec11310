"""Steady convection-diffusion: ``-div(kappa grad u) + c . grad u + sigma u
= f`` with a constant velocity ``c`` on axis-aligned boxes.

Port of `pmg_dolfinx_tpu.solvers.convdiff`. The advection
operator factors per axis like the Kronecker-sum stiffness (``c . grad
-> sum_a c_a M_b (x) C_a (x) M_c``, `ops.kron.kron_advection_terms`), so
the operator is the hierarchy's ``kron`` apply plus three contractions.
The system is nonsymmetric: `solvers.bicgstab` preconditioned by the
hierarchy's V-cycle on the symmetric (diffusion + sigma) part, effective
up to moderate cell-Peclet numbers; `sd_stabilized_kappa` adds the
streamline-diagonal diffusion for the advection-dominated regime.

As in the JAX package the advection rides the level data of
``operator="kron"`` (the per-axis masses), which runs as torch einsums:
JAX has no Pallas form of this operator. On the slab (`DistPMG`) and
the grid (`GridPMG`) the same program runs on the stacked layout, each
axis' advection term reconciled by that axis' exchange
(`solvers.shardwrap.axis_exchanges`).
"""

import numpy as np
import torch

from ..fem.assembly import resolve_kappa_axes
from ..ops.kron import axis_advection, kron_advection_terms
from .bicgstab import bicgstab_solve
from .pmg import v_cycle
from .shardwrap import axis_exchanges, layout_converters, shards_of


def sd_stabilized_kappa(mesh, P, velocity, kappa, tau=None, h_eff="p"):
    """Streamline-diagonal artificial diffusion for the advection-dominated
    regime: per-axis ``kappa_a^eff = kappa_a + tau_a c_a^2``, the diagonal
    of the streamline tensor ``tau c c^T`` (a constant diagonal tensor, so
    it rides the whole Kronecker family: build the hierarchy with the
    returned kappa and call `convdiff_solve` as usual).

    ``tau_a`` defaults to ``h/(2|c_a|) (coth(Pe_a) - 1/Pe_a)`` with ``h``
    per ``h_eff``: ``'p'`` the mean cell width over P (accuracy-leaning),
    ``'cell'`` the mean cell width (robustness-leaning), or a float; a
    scalar ``tau`` overrides it. Returns ``(kappa_axes, taus)``, both
    3-tuples.
    """
    kax = resolve_kappa_axes(mesh, kappa)
    cvel = np.asarray(velocity, dtype=np.float64)
    if cvel.shape != (3,):
        raise ValueError(f"velocity must be a 3-vector, got {cvel.shape}")
    taus = []
    for a in range(3):
        ca = abs(float(cvel[a]))
        if tau is not None:
            taus.append(float(tau))
        elif ca < 1e-300:
            taus.append(0.0)
        else:
            if h_eff == "p":
                h_a = float(np.mean(mesh.h_cells[a])) / float(P)
            elif h_eff == "cell":
                h_a = float(np.mean(mesh.h_cells[a]))
            else:
                h_a = float(h_eff)
            pe = ca * h_a / (2.0 * kax[a])
            taus.append(h_a / (2.0 * ca)
                        * (1.0 / np.tanh(pe) - 1.0 / pe))
    keff = tuple(kax[a] + taus[a] * float(cvel[a]) ** 2 for a in range(3))
    return keff, tuple(taus)


def _make_program(hier, lin_maxiter):
    ops = hier._ops
    levels = hier.levels
    fine = levels[-1]
    coarse, coarse_cfg = hier.coarse, hier.coarse_cfg
    precision = getattr(hier, "precision", "highest")
    exchanges = axis_exchanges(hier)

    def run(data, bw, u0, Cs, cvel, rtol):
        lv = data["levels"][-1]
        ms = (lv["mx"], lv["my"], lv["mz"])

        def A(x):
            yd = ops["apply"](lv, x, fine)  # diffusion + sigma, bc rows
            w = torch.where(lv["bc_marker"], torch.zeros_like(x), x)
            adv = kron_advection_terms(w, Cs, ms, cvel, precision=precision,
                                       exchanges=exchanges)
            return torch.where(lv["bc_marker"], x, yd + adv)

        M = lambda r: v_cycle(
            data, r, torch.zeros_like(r),
            levels=levels, coarse=coarse, coarse_cfg=coarse_cfg, ops=ops,
        )
        return bicgstab_solve(
            A, bw, u0, M, rtol=rtol, maxiter=lin_maxiter,
            dot=lambda a, c: ops["dot"](a, c, lv),
        )

    return run


def convdiff_solve(hier, b, velocity, *, rtol=1e-8, maxiter=200, u0=None):
    """Solve the convection-diffusion system whose symmetric part is
    ``hier``'s fine-level operator (kappa diffusion + optional sigma) and
    whose advection velocity is the constant 3-vector ``velocity``.

    ``hier`` (a `PMGHierarchy`, `DistPMG` or `GridPMG`) must be built
    with ``operator='kron'`` (box meshes, graded spacing included: the 1D
    advection matrix is scale-free). Returns
    ``(u, info)``: ``u`` flat on the hierarchy's device, ``info =
    dict(niter, rel_resid)`` from the preconditioned BiCGStab loop.
    """
    if getattr(hier, "operator_kind", None) != "kron":
        raise ValueError(
            "convdiff_solve needs a hierarchy built with operator='kron' "
            f"(got {getattr(hier, 'operator_kind', None)!r}): the "
            "advection terms ride the kron level data (per-axis masses)")
    dtype, device = hier.dtype, hier.device
    fine = hier.levels[-1]
    shards = shards_of(hier)
    Cs = tuple(
        torch.tensor(axis_advection(hier.mesh.nc[a] // shards[a], fine.P),
                     dtype=dtype, device=device)
        for a in range(3)
    )
    cvel = np.asarray(velocity, dtype=np.float64)
    if cvel.shape != (3,):
        raise ValueError(f"velocity must be a 3-vector, got {cvel.shape}")
    cvel = torch.tensor(cvel, dtype=dtype, device=device)

    run = _make_program(hier, int(maxiter))

    to_w, from_w = layout_converters(hier)
    bw = to_w(b)
    uw = torch.zeros_like(bw) if u0 is None else to_w(u0)
    u, info = run(hier.data, bw, uw, Cs, cvel, float(rtol))
    rel = float(np.sqrt(float(info["rnorm"]) / max(float(info["rnorm0"]),
                                                   np.finfo(np.float64).tiny)))
    return from_w(u), dict(niter=int(info["niter"]), rel_resid=rel)
