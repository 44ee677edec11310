"""Per-quadrature-point geometry factors for the weighted Laplacian.

Port of the numpy paths of `pmg_dolfinx_tpu.fem.geometry`
(`geometry_factors(xp=np)`): host-side float64 setup for the right-hand
side and error norms. For each cell and quadrature point q, with
trilinear coordinate map x(X):

    J   = dx/dX                      (3x3 Jacobian)
    K   = adj(J) = detJ * J^{-1}
    G_q = (w_q / detJ) * K @ K.T     (symmetric; 6 unique entries stored)

Entry order ``[G00, G10, G20, G11, G21, G22]``.
"""

import numpy as np

from .gll import gauss_lobatto, lagrange_tabulate


def tabulate_geometry_dphi(P: int) -> np.ndarray:
    """Trilinear (Q1) basis derivative table at the degree-P GLL points,
    ``dphi[(3, nq, 8)]`` with ``nq = (P+1)**3``; corner ordering
    ``(a*2 + b)*2 + c``."""
    q1, _ = gauss_lobatto(P + 1)
    tab = lagrange_tabulate(np.array([0.0, 1.0]), q1, nderiv=1)
    phi, dphi = tab[0], tab[1]  # (nq1, 2)
    nq1 = q1.shape[0]
    out = np.empty((3, nq1, nq1, nq1, 8))
    for a in range(2):
        for b in range(2):
            for c in range(2):
                loc = (a * 2 + b) * 2 + c
                out[0, ..., loc] = np.einsum("i,j,k->ijk", dphi[:, a], phi[:, b], phi[:, c])
                out[1, ..., loc] = np.einsum("i,j,k->ijk", phi[:, a], dphi[:, b], phi[:, c])
                out[2, ..., loc] = np.einsum("i,j,k->ijk", phi[:, a], phi[:, b], dphi[:, c])
    return out.reshape(3, nq1**3, 8)


def quadrature_weights_3d(P: int) -> np.ndarray:
    """Tensor-product GLL weights ``w[(P+1)**3]``, q index ``(i*n + j)*n + k``."""
    _, w = gauss_lobatto(P + 1)
    return np.einsum("i,j,k->ijk", w, w, w).reshape(-1)


def geometry_factors(xgeom, geometry_dofmap, dphi_geom, weights, xp=np,
                     kappa=None):
    """Compute ``G[(ncells, nq, 6)]`` and ``detJ[(ncells, nq)]`` in numpy
    float64. ``kappa`` (optional) is an ``(ncells,)`` DG-0 scalar field
    that post-multiplies the 6 entries. ``xp`` keeps the JAX package's
    fifth parameter, its array module: here always numpy (the port's
    geometry is host setup), anything else raises ValueError."""
    if xp is not np:
        raise ValueError(
            f"xp={xp!r}: the port computes geometry factors on the host "
            "with numpy only (pass xp=numpy)")
    coords = xgeom[geometry_dofmap]  # (ncells, 8, 3)
    J = np.einsum("cka,bqk->cqab", coords, dphi_geom)
    K = _adjugate_3x3(J)
    detJ = (
        J[..., 0, 0] * K[..., 0, 0]
        + J[..., 1, 0] * K[..., 0, 1]
        + J[..., 2, 0] * K[..., 0, 2]
    )
    KKt = np.einsum("xqam,xqbm->xqab", K, K)
    scale = weights[None, :] / detJ
    G = np.stack(
        [
            KKt[..., 0, 0],
            KKt[..., 1, 0],
            KKt[..., 2, 0],
            KKt[..., 1, 1],
            KKt[..., 2, 1],
            KKt[..., 2, 2],
        ],
        axis=-1,
    ) * scale[..., None]
    if kappa is not None:
        G = G * np.asarray(kappa)[:, None, None]
    return G, detJ


def _adjugate_3x3(J, xp=np):
    """Adjugate of a batched 3x3 matrix: ``adj(J) = detJ * J^{-1}``;
    ``xp`` is ``np`` or ``torch``."""
    a, b, c = J[..., 0, 0], J[..., 0, 1], J[..., 0, 2]
    d, e, f = J[..., 1, 0], J[..., 1, 1], J[..., 1, 2]
    g, h, i = J[..., 2, 0], J[..., 2, 1], J[..., 2, 2]
    row0 = xp.stack([e * i - f * h, -(b * i - c * h), b * f - c * e], axis=-1)
    row1 = xp.stack([-(d * i - f * g), a * i - c * g, -(a * f - c * d)], axis=-1)
    row2 = xp.stack([d * h - e * g, -(a * h - b * g), a * e - b * d], axis=-1)
    return xp.stack([row0, row1, row2], axis=-2)
