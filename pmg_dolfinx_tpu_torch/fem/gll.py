"""1D Gauss-Lobatto-Legendre (GLL) quadrature and Lagrange tabulation.

These are the 1D building blocks of every tensor-product hex element in the
framework. They replace Basix in the reference:

- reference src/laplacian.hpp:299-317 creates a degree-P `gll_warped`
  Lagrange interval element and a GLL quadrature rule whose points coincide
  with the element nodes (P+1 points per direction), then tabulates the 1D
  derivative table `dphi[(P+1) x (P+1)]`.
- reference src/precompute.hpp:256-271 (`tabulate_1d`) is the host-side twin.

The collocation property (quadrature points == element nodes) makes the 1D
value table the identity, so operators only ever need the derivative matrix.

All functions here are NumPy, float64, setup-time only; a copy of
`pmg_dolfinx_tpu.fem.gll` (the port imports nothing of the JAX package).
"""

from functools import lru_cache

import numpy as np
from numpy.polynomial import legendre as npleg


@lru_cache(maxsize=None)
def _gauss_lobatto_cached(m: int):
    if m < 2:
        raise ValueError("GLL rule needs at least 2 points")
    # Interior nodes: roots of P'_{m-1} on [-1, 1].
    cm1 = np.zeros(m)
    cm1[m - 1] = 1.0  # Legendre coefficient vector of P_{m-1}
    dcoef = npleg.legder(cm1)
    interior = npleg.legroots(dcoef) if m > 2 else np.array([])
    x = np.concatenate([[-1.0], np.sort(np.real(interior)), [1.0]])
    # Weights: w_i = 2 / (m (m-1) P_{m-1}(x_i)^2)
    pm1 = npleg.legval(x, cm1)
    w = 2.0 / (m * (m - 1) * pm1**2)
    # Map [-1, 1] -> [0, 1]
    x01 = 0.5 * (x + 1.0)
    w01 = 0.5 * w
    x01[0], x01[-1] = 0.0, 1.0
    x01.setflags(write=False)
    w01.setflags(write=False)
    return x01, w01


def gauss_lobatto(m: int) -> tuple[np.ndarray, np.ndarray]:
    """Return (points, weights) of the m-point GLL rule on [0, 1].

    Exact for polynomials of degree <= 2m - 3. The points double as the
    nodes of the degree-(m-1) GLL-variant Lagrange element.
    """
    return _gauss_lobatto_cached(m)


@lru_cache(maxsize=None)
def _gauss_legendre_cached(m: int):
    x, w = npleg.leggauss(m)
    x01 = 0.5 * (x + 1.0)
    w01 = 0.5 * w
    x01.setflags(write=False)
    w01.setflags(write=False)
    return x01, w01


def gauss_legendre(m: int) -> tuple[np.ndarray, np.ndarray]:
    """Return (points, weights) of the m-point Gauss-Legendre rule on [0, 1].

    Exact for degree <= 2m - 1. Used for accurate error norms (the solver
    itself uses the collocated GLL rule, matching the reference forms).
    """
    return _gauss_legendre_cached(m)


def lagrange_tabulate(nodes: np.ndarray, points: np.ndarray, nderiv: int = 0) -> np.ndarray:
    """Tabulate the Lagrange basis on `nodes` at `points`.

    Returns ``table[(nderiv + 1, npoints, nnodes)]`` with
    ``table[d, q, i] = d^d l_i / dx^d (points[q])``, matching the layout of
    basix tabulate used at reference src/precompute.hpp:256-271.

    Implementation: express each Lagrange basis function in the Legendre
    basis (well-conditioned Vandermonde solve; fine for the degrees <= ~16
    used here), then evaluate derivatives of the Legendre basis.
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    points = np.asarray(points, dtype=np.float64)
    n = nodes.shape[0]
    # Legendre basis on [0, 1]: L_k(2 x - 1).
    t_nodes = 2.0 * nodes - 1.0
    V = npleg.legvander(t_nodes, n - 1)  # (n, n): V[i, k] = L_k(t_i)
    # Coefficients C[:, i] of basis i: V @ C = I  =>  C = V^{-1}
    C = np.linalg.inv(V)
    t_pts = 2.0 * points - 1.0
    out = np.empty((nderiv + 1, points.shape[0], n))
    coef = np.eye(n)  # columns: Legendre coefficient vectors (degree k)
    for d in range(nderiv + 1):
        # Evaluate each Legendre polynomial's d-th derivative at points.
        # chain rule: d/dx = 2 d/dt
        Vd = np.stack(
            [npleg.legval(t_pts, npleg.legder(coef[:, k], m=d) if d else coef[:, k]) for k in range(n)],
            axis=-1,
        )  # (npts, n)
        out[d] = (2.0**d) * (Vd @ C)
    return out


def derivative_matrix(P: int) -> np.ndarray:
    """1D GLL derivative matrix ``D[q, i] = l_i'(x_q)`` for degree P.

    x_q are the (P+1) GLL points (== element nodes). This is the `dphi`
    table uploaded to device at reference src/laplacian.hpp:312-317.
    """
    x, _ = gauss_lobatto(P + 1)
    return lagrange_tabulate(x, x, nderiv=1)[1]


def interpolation_matrix_1d(P_coarse: int, P_fine: int) -> np.ndarray:
    """1D inter-degree interpolation matrix ``M[f, c] = l_c^{coarse}(x_f^{fine})``.

    The 3D element interpolation operator (reference src/interpolate.hpp:118,
    basix::compute_interpolation_operator) is its triple Kronecker product;
    the framework applies it sum-factorized, axis by axis.
    """
    xc, _ = gauss_lobatto(P_coarse + 1)
    xf, _ = gauss_lobatto(P_fine + 1)
    return lagrange_tabulate(xc, xf, nderiv=0)[0]
