"""Jacobi-preconditioned conjugate gradients with coefficient recording,
and flexible CG.

Port of `pmg_dolfinx_tpu.solvers.cg`. Scalars stay 0-d tensors on the
vectors' device, so the recording path runs without a host sync:

    p = M^-1 r ;  rnorm = <p, r>
    loop: y = A p ; alpha = rnorm / <p, y>
          x += alpha p ; r -= alpha y ; z = M^-1 r
          rnorm' = <r, z> ; beta = rnorm' / rnorm
          converged if rnorm'/rnorm0 < rtol^2
          p = beta p + z
          record (alpha, beta, rnorm') only when the iteration did NOT
          trigger convergence

``record=True`` is the JAX package's fixed-length ``lax.scan``: a Python
loop of exactly ``maxiter`` iterations that FREEZES its state with
``torch.where`` after convergence and writes 0 into the recorded
``alphas``/``betas`` — `solvers.tridiag.lanczos_eigenvalue_estimates`
reads exactly those arrays, so there is no early exit. The other paths
are data-dependent loops (JAX ``while_loop``) that read the convergence
flag on the host once per iteration.
"""

import torch


def _safe_div(num, den):
    """Divide guarding against an exact-zero denominator (a ``where``,
    so it never syncs or raises)."""
    return num / torch.where(den == 0, torch.ones_like(den), den)


def _default_dot(u, v):
    return torch.dot(u.reshape(-1), v.reshape(-1))


def cg_solve(A, b, x0, diag_inv, *, rtol=1e-8, maxiter=100, record=False,
             dot=_default_dot, precond=None):
    """Solve ``A x = b`` with Jacobi-preconditioned CG.

    ``A`` is a callable ``x -> A @ x``; ``diag_inv`` the inverse operator
    diagonal; ``rtol`` is on the preconditioned residual norm. With
    ``record=True`` the loop runs exactly ``maxiter`` iterations and also
    returns the per-iteration ``alphas``, ``betas``, ``residuals`` and
    ``stored`` mask. ``precond`` (a callable ``r -> M^-1 r``, a fixed SPD
    linear operator) replaces the Jacobi preconditioner. Returns ``(x,
    info)``.
    """
    M = precond if precond is not None else (lambda r: diag_inv * r)
    r = b - A(x0)
    p = M(r)
    rnorm0 = dot(p, r)
    rtol2 = rtol * rtol

    def iteration(x, r, p, rnorm):
        y = A(p)
        alpha = _safe_div(rnorm, dot(p, y))
        x = x + alpha * p
        r = r - alpha * y
        z = M(r)
        rnorm_new = dot(r, z)
        beta = _safe_div(rnorm_new, rnorm)
        converged = _safe_div(rnorm_new, rnorm0) < rtol2
        p = beta * p + z
        return x, r, p, rnorm_new, alpha, beta, converged

    x, rnorm = x0, rnorm0
    if not record:
        k = 0
        done = bool(rnorm0 <= 0)
        while k < maxiter and not done:
            x, r, p, rnorm, _, _, converged = iteration(x, r, p, rnorm)
            k += 1
            done = bool(converged)
        return x, dict(niter=k, rnorm=rnorm, rnorm0=rnorm0)

    k = torch.zeros((), dtype=torch.int64, device=b.device)
    done = torch.zeros((), dtype=torch.bool, device=b.device)
    zero = torch.zeros((), dtype=rnorm0.dtype, device=b.device)
    alphas, betas, residuals, stored = [], [], [], []
    for _ in range(maxiter):
        xn, rn, pn, rnorm_n, alpha, beta, converged = iteration(x, r, p, rnorm)
        active = torch.logical_not(done)
        # Freeze the state once converged (fixed-length loop).
        x = torch.where(active, xn, x)
        r = torch.where(active, rn, r)
        p = torch.where(active, pn, p)
        rnorm = torch.where(active, rnorm_n, rnorm)
        stored.append(torch.logical_and(active, torch.logical_not(converged)))
        alphas.append(torch.where(active, alpha, zero))
        betas.append(torch.where(active, beta, zero))
        residuals.append(torch.where(active, rnorm_n, zero))
        k = k + active.to(k.dtype)
        done = torch.logical_or(done, converged)
    return x, dict(
        niter=k,
        rnorm=rnorm,
        rnorm0=rnorm0,
        alphas=torch.stack(alphas),
        betas=torch.stack(betas),
        residuals=torch.stack(residuals),
        stored=torch.stack(stored),
    )


def fcg_solve(A, b, x0, M, *, rtol=1e-8, maxiter=50, dot=_default_dot):
    """Flexible (Polak-Ribiere) preconditioned conjugate gradients, for
    preconditioners that are not exactly fixed linear operators (a
    V-cycle with a Krylov coarse solve). Returns ``(x, info)`` with
    ``niter`` (a Python int)."""
    r = b - A(x0)
    z = M(r)
    p = z
    rz = dot(r, z)
    rz0 = rz
    rtol2 = rtol * rtol
    x = x0
    k = 0
    done = bool(rz <= 0)
    while k < maxiter and not done:
        x, r, z, p, rz, converged = _fcg_iteration(A, M, dot, x, r, z, p, rz,
                                                   rz0, rtol2)
        done = bool(converged)
        k += 1
    return x, dict(niter=k, rnorm=rz, rnorm0=rz0)


def _fcg_iteration(A, M, dot, x, r, z, p, rz, rz0, rtol2):
    q = A(p)
    alpha = _safe_div(rz, dot(p, q))
    x = x + alpha * p
    r_new = r - alpha * q
    z_new = M(r_new)
    # Polak-Ribiere (flexible) beta.
    beta = _safe_div(dot(z_new, r_new - r), rz)
    rz_new = dot(r_new, z_new)
    converged = _safe_div(rz_new, rz0) < rtol2
    p = z_new + beta * p
    return x, r_new, z_new, p, rz_new, converged


def fcg_solve_fixed(A, b, x0, M, *, rtol=0.0, maxiter=5, dot=_default_dot):
    """`fcg_solve` as a loop of exactly ``maxiter`` iterations that freezes
    its state with ``torch.where`` once converged (the JAX ``while_loop``
    traced inside a scan): the same iterate, and no host sync. Returns
    ``(x, info)`` with ``niter`` a 0-d tensor."""
    r = b - A(x0)
    z = M(r)
    p = z
    rz = dot(r, z)
    rz0 = rz
    rtol2 = rtol * rtol
    x = x0
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    done = rz <= 0
    for _ in range(maxiter):
        new = _fcg_iteration(A, M, dot, x, r, z, p, rz, rz0, rtol2)
        active = torch.logical_not(done)
        x, r, z, p, rz = (torch.where(active, n, o)
                          for n, o in zip(new[:5], (x, r, z, p, rz)))
        k = k + active.to(k.dtype)
        done = torch.logical_or(done, new[5])
    return x, dict(niter=k, rnorm=rz, rnorm0=rz0)
