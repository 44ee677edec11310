"""Preconditioned BiCGStab for nonsymmetric operators.

Port of `pmg_dolfinx_tpu.solvers.bicgstab`: the right-preconditioned van
der Vorst form (the preconditioner applied to the search direction ``p``
and the stabilizer ``s``), for the convection-diffusion family, whose
advection breaks the symmetry CG/FCG need. The JAX ``while_loop`` is a
loop that reads its ``done`` flag on the host once per iteration; the
scalars stay 0-d tensors on the vectors' device.
"""

from .cg import _default_dot, _safe_div


def bicgstab_solve(A, b, x0, M, *, rtol=1e-8, maxiter=200,
                   dot=_default_dot):
    """Solve ``A x = b`` with the preconditioner ``M`` (``r -> z``, e.g. a
    V-cycle on the symmetric part of ``A``).

    Returns ``(x, info)`` with ``info = dict(niter, rnorm, rnorm0)``:
    ``niter`` a Python int, ``rnorm`` the squared 2-norm of the true
    recursive residual, ``rnorm0 = |b|^2``. Stops when ``|r| <= rtol
    |b|`` (tested at entry too). Zero denominators give zero updates, as
    in `solvers.cg`.
    """
    r = b - A(x0)
    rhat = r  # the fixed shadow residual
    rnorm0 = dot(b, b)
    rho = dot(rhat, r)
    rtol2 = rtol * rtol
    x, p, v = x0, r, r.new_zeros(r.shape)
    alpha = omega = rho.new_ones(())
    rnorm = dot(r, r)
    k = 0
    done = bool(rnorm <= rtol2 * rnorm0)
    while k < maxiter and not done:
        ph = M(p)
        v = A(ph)
        alpha = _safe_div(rho, dot(rhat, v))
        s = r - alpha * v
        sh = M(s)
        t = A(sh)
        omega = _safe_div(dot(t, s), dot(t, t))
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        rnorm = dot(r, r)
        rho_new = dot(rhat, r)
        beta = _safe_div(rho_new, rho) * _safe_div(alpha, omega)
        p = r + beta * (p - omega * v)
        rho = rho_new
        k += 1
        done = bool(rnorm <= rtol2 * rnorm0)
    return x, dict(niter=k, rnorm=rnorm, rnorm0=rnorm0)
