"""Lanczos tridiagonal eigenvalue estimation from CG coefficients.

Host-side (NumPy, setup-time) twin of `CGSolver::compute_eigenvalues` and
the `tqli` QL-with-implicit-shifts eigensolver (reference src/cg.hpp:16-84,
121-142; python mirrors python_tests/{tqli,eigenvalue_computation}.py).

The CG recurrence coefficients define the Lanczos tridiagonal of the
Jacobi-preconditioned operator (Saad, *Iterative Methods for Sparse Linear
Systems*, §6.7.3):

    d[0]   = 1/alpha[0]
    d[i+1] = 1/alpha[i+1] + beta[i]/alpha[i]
    e[i]   = sqrt(beta[i]) / alpha[i]

whose eigenvalues estimate the extremal spectrum of ``M^-1 A`` — the input
to Chebyshev smoother calibration (examples/pmg/main.cpp:303-330).

The arrays involved are tiny (the drivers use 20 CG iterations), so this
runs on host in float64. `tqli` is provided for algorithmic parity with
the reference and validated against `numpy.linalg.eigvalsh` /
`scipy.linalg.eigh_tridiagonal` in the tests, mirroring
python_tests/tqli.py:93-99.
"""

import numpy as np


def tqli(d, e, max_sweeps: int = 30):
    """Eigenvalues of a symmetric tridiagonal matrix by the implicit-shift
    QL algorithm (in-place on copies; returns sorted eigenvalues).

    ``d`` is the diagonal (n,), ``e`` the off-diagonal in ``e[:n-1]``
    (an extra trailing workspace slot is allocated internally).
    """
    d = np.array(d, dtype=np.float64, copy=True)
    n = d.shape[0]
    e_work = np.zeros(n)
    e_work[: n - 1] = np.asarray(e, dtype=np.float64)[: n - 1]
    e = e_work

    for l in range(n):
        for sweep in range(max_sweeps + 1):
            # Find the first m >= l where the subdiagonal is negligible.
            m = l
            while m < n - 1:
                scale = abs(d[m]) + abs(d[m + 1])
                if abs(e[m]) + scale == scale:
                    break
                m += 1
            if m == l:
                break
            if sweep == max_sweeps:
                raise RuntimeError("tqli failed to converge")
            # Implicit shift from the 2x2 at l.
            g = (d[l + 1] - d[l]) / (2.0 * e[l])
            r = np.hypot(g, 1.0)
            shift = g + r if g >= 0 else g - r
            g = d[m] - d[l] + e[l] / shift
            s, c, p = 1.0, 1.0, 0.0
            for i in range(m - 1, l - 1, -1):
                f = s * e[i]
                b = c * e[i]
                r = np.hypot(f, g)
                e[i + 1] = r
                if r == 0.0:
                    d[i + 1] -= p
                    e[m] = 0.0
                    break
                s = f / r
                c = g / r
                g = d[i + 1] - p
                r = (d[i] - g) * s + 2.0 * c * b
                p = s * r
                d[i + 1] = g + p
                g = c * r - b
            else:
                d[l] -= p
                e[l] = g
                e[m] = 0.0
        e[l] = 0.0
    return np.sort(d)


def eigenvalues_tridiagonal(d, e):
    """Eigenvalues via dense symmetric solve (robust default path)."""
    n = len(d)
    T = np.diag(np.asarray(d, dtype=np.float64))
    off = np.asarray(e, dtype=np.float64)[: n - 1]
    T += np.diag(off, 1) + np.diag(off, -1)
    return np.linalg.eigvalsh(T)


def lanczos_eigenvalue_estimates(alphas, betas, stored=None, method="tqli"):
    """Spectrum estimates of ``M^-1 A`` from recorded CG coefficients.

    ``alphas``/``betas`` are the fixed-shape buffers from
    ``cg_solve(record=True)``; ``stored`` masks the valid entries (the
    reference stores per accepted iteration, cg.hpp:213-218).
    Returns eigenvalues sorted ascending.
    """
    alphas = np.asarray(alphas, dtype=np.float64)
    betas = np.asarray(betas, dtype=np.float64)
    raw_first = alphas[0] if alphas.shape[0] else 0.0
    if stored is not None:
        mask = np.asarray(stored, dtype=bool)
        alphas, betas = alphas[mask], betas[mask]
    ne = alphas.shape[0]
    if ne == 0:
        # CG converged DURING its first iteration, so the stored mask is
        # empty — but that iteration's alpha was still written to the
        # raw buffer (active iterations record before the convergence
        # flag freezes the scan) and is a valid Rayleigh quotient.
        # Reached by strongly shifted hierarchies on tiny meshes
        # (Newmark sigma = 1/(beta dt^2) with ndofs ~ 1e3).
        if raw_first > 0.0:
            lam = 1.0 / raw_first
            return np.array([lam, lam])
        raise ValueError("Insufficient CG coefficients to estimate eigenvalues")
    if ne == 1:
        # CG converged in one iteration: the operator is (numerically) a
        # scaled identity on this rhs and the 1x1 Lanczos matrix IS the
        # Rayleigh quotient — a tight single-point spectrum estimate.
        # Reached by strongly shifted hierarchies (Newmark stepping has
        # sigma = 1/(beta dt^2) >> lambda_max(K)).
        lam = 1.0 / alphas[0]
        return np.array([lam, lam])
    d = 1.0 / alphas
    d[1:] += betas[:-1] / alphas[:-1]
    e = np.sqrt(betas[:-1]) / alphas[:-1]
    if method == "tqli":
        return tqli(d, e)
    return eigenvalues_tridiagonal(d, e)
