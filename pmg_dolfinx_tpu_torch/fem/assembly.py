"""NumPy host-side helpers: RHS assembly, error norms, coefficient specs.

Port of the parts of `pmg_dolfinx_tpu.fem.assembly` the flagship solve
needs. Everything here is setup-time NumPy (float64), copied from the
JAX package so the arrays agree bit for bit; none of it runs in the
solve path. Variable, per-axis and tensor kappa are not ported yet
(ROADMAP.md, Queue 1 item 7).
"""

import numpy as np

from .geometry import geometry_factors, quadrature_weights_3d, tabulate_geometry_dphi
from .gll import gauss_legendre, gauss_lobatto, lagrange_tabulate
from .mesh import BoxMesh

_KAPPA_TODO = ("only a scalar kappa is ported; variable, per-axis and "
               "tensor kappa are ROADMAP.md Queue 1 item 7")


def geometry_factors_np(mesh: BoxMesh, P: int,
                        kappa=None) -> tuple[np.ndarray, np.ndarray]:
    """G and detJ for all cells, NumPy float64."""
    G, detJ = geometry_factors(
        mesh.geometry_x,
        mesh.geometry_dofmap,
        tabulate_geometry_dphi(P),
        quadrature_weights_3d(P),
        kappa=kappa,
    )
    return np.asarray(G), np.asarray(detJ)


def assemble_rhs(mesh: BoxMesh, P: int, f, bc: bool = True) -> np.ndarray:
    """Assemble ``b_i = integral f phi_i dx`` with the collocated GLL rule.

    With collocation the local load vector is diagonal:
    ``b_local[q] = w_q detJ_q f(x_q)``. With ``bc=True`` Dirichlet entries
    are zeroed afterwards (homogeneous Dirichlet data).
    """
    _, detJ = geometry_factors_np(mesh, P)
    w = quadrature_weights_3d(P)
    dofmap = mesh.dofmap(P)
    coords = mesh.dof_coords(P)[dofmap]  # (ncells, nld, 3)
    fvals = f(coords.reshape(-1, 3).T).reshape(dofmap.shape)
    b_local = w[None, :] * detJ * fvals
    b = np.zeros(mesh.num_dofs(P))
    np.add.at(b, dofmap.ravel(), b_local.ravel())
    if bc:
        b[mesh.boundary_dof_marker(P)] = 0.0
    return b


def resolve_sigma(sigma):
    """Split the reaction coefficient into ``(ops_scalar, field)``: a
    scalar passes through (``field=None``), a callable ``sigma(x)``
    returns ``(1.0, sigma)``."""
    if callable(sigma):
        return 1.0, sigma
    return float(sigma), None


def ops_shift_scalar(mesh: BoxMesh, sigma, kron_family: bool = False):
    """The cycle-ops pointwise-shift scalar for a level on ``mesh``.
    Robin faces on the general backends force it to 1.0; the kron family
    keeps the plain sigma."""
    if getattr(mesh, "has_robin", False) and not kron_family:
        return 1.0
    return float(sigma)


def resolve_kappa(mesh: BoxMesh, kappa):
    """Resolve a scalar coefficient to ``(kappa_cells, is_constant)``."""
    if callable(kappa) or np.ndim(kappa) != 0:
        raise NotImplementedError(_KAPPA_TODO)
    return np.full(mesh.ncells, float(kappa)), True


def resolve_kappa_split(mesh: BoxMesh, kappa):
    """`resolve_kappa` split for the geometry fold: ``(kappa_scalar,
    kappa_tensor, is_constant)``; the tensor part is always None here."""
    kc, const = resolve_kappa(mesh, kappa)
    return kc, None, const


def resolve_kappa_axes(mesh: BoxMesh, kappa, split=None):
    """Resolve a kron-family scalar coefficient to ``(k, k, k)``."""
    kc, _, const = split if split is not None else resolve_kappa_split(
        mesh, kappa)
    if not const:
        raise NotImplementedError(_KAPPA_TODO)
    k = float(kc[0])
    return (k, k, k)


def l2_error(mesh: BoxMesh, P: int, u_h: np.ndarray, u_exact, nq: int | None = None) -> float:
    """Accurate L2 norm of ``u_h - u_exact`` via Gauss-Legendre quadrature
    on the affine axis-aligned cells."""
    nq = nq or P + 3
    xq, wq = gauss_legendre(nq)
    xg, _ = gauss_lobatto(P + 1)
    phi1 = lagrange_tabulate(xg, xq, 0)[0]  # (nq, P+1)
    n = P + 1
    u_cells = u_h[mesh.dofmap(P)].reshape(mesh.nc + (n, n, n))
    uq = np.einsum("qi,rj,sk,cdeijk->cdeqrs", phi1, phi1, phi1, u_cells)
    hx, hy, hz = mesh.h_cells
    X = mesh.axis_nodes(0)[:-1, None] + xq[None, :] * hx[:, None]
    Y = mesh.axis_nodes(1)[:-1, None] + xq[None, :] * hy[:, None]
    Z = mesh.axis_nodes(2)[:-1, None] + xq[None, :] * hz[:, None]
    pts = np.stack(
        np.broadcast_arrays(
            X[:, None, None, :, None, None],
            Y[None, :, None, None, :, None],
            Z[None, None, :, None, None, :],
        ),
        axis=0,
    )
    ue = u_exact(pts.reshape(3, -1)).reshape(uq.shape)
    w3 = np.einsum("q,r,s->qrs", wq, wq, wq)
    detJ = np.einsum("c,d,e->cde", hx, hy, hz)
    err2 = np.sum((uq - ue) ** 2 * w3[None, None, None]
                  * detJ[:, :, :, None, None, None])
    return float(np.sqrt(err2))
