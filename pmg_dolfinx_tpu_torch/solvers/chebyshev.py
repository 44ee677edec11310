"""Chebyshev smoothers (fourth and first kind), Jacobi-preconditioned.

Port of `pmg_dolfinx_tpu.solvers.chebyshev`: `chebyshev4_solve` (the
"optimised fourth-kind" Chebyshev iteration of Phillips & Fischer,
arXiv:2210.03179). The fixed-iteration recurrence (k = 1..num_iters):

    r = b - A x
    z = (4 / (3 lmax)) M^-1 r
    repeat: x += z
            r -= A z
            z  = (2k-1)/(2k+3) z + (8k+4)/((2k+3) lmax) M^-1 r

``num_iters + 1`` operator applies per smooth; a Python loop where JAX
has ``fori_loop``. `chebyshev1_solve` is the classic first-kind
three-term iteration over ``[lmin, lmax]``.
"""


def chebyshev4_solve(A, b, x, diag_inv, lmax, num_iters):
    """Fourth-kind Chebyshev smoothing of ``A x = b`` from initial guess x.

    ``lmax`` (float or 0-d tensor) is the inflated upper eigenvalue bound
    of ``M^-1 A``; ``diag_inv`` the inverse diagonal (point Jacobi) or a
    callable ``r -> M^-1 r``.
    """
    M = diag_inv if callable(diag_inv) else (lambda r: diag_inv * r)
    r = b - A(x)
    z = (4.0 / (3.0 * lmax)) * M(r)
    for i in range(num_iters):
        x = x + z
        r = r - A(z)
        kf = float(i + 1)  # the reference index runs 1..num_iters
        z = z * (2.0 * kf - 1.0) / (2.0 * kf + 3.0) + (
            (8.0 * kf + 4.0) / ((2.0 * kf + 3.0) * lmax)
        ) * M(r)
    return x


def chebyshev1_solve(A, b, x, diag_inv, eig_range, num_iters):
    """Classic (first-kind) Chebyshev iteration over ``[lmin, lmax]``:
    the three-term recurrence with ``theta = (lmax + lmin) / 2`` and
    ``delta = (lmax - lmin) / 2``."""
    lmin, lmax = eig_range
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    r = diag_inv * (b - A(x))
    d = r / theta
    for _ in range(num_iters):
        x = x + d
        r = r - diag_inv * A(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * r
        rho = rho_new
    return x
