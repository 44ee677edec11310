"""NumPy host-side helpers: assembly oracle, RHS, error norms, coefficients.

Port of the parts of `pmg_dolfinx_tpu.fem.assembly` the flagship and
curved-hex solves need: the scipy stiffness oracle, the RHS, the lumped
mass, the Gauss-Legendre (axis-aligned) and collocated (any hex) L2
errors, and the coefficient resolvers. Everything here is setup-time
NumPy (float64), copied from the JAX package so the arrays agree bit for
bit; none of it runs in the solve path. Variable, per-axis and tensor
kappa are not ported yet (ROADMAP.md, Queue 1 item 7).
"""

import numpy as np

from .geometry import geometry_factors, quadrature_weights_3d, tabulate_geometry_dphi
from .gll import (
    derivative_matrix,
    gauss_legendre,
    gauss_lobatto,
    lagrange_tabulate,
)
from .mesh import BoxMesh

_KAPPA_TODO = ("only a scalar kappa is ported; variable, per-axis and "
               "tensor kappa are ROADMAP.md Queue 1 item 7")


def geometry_factors_np(mesh: BoxMesh, P: int,
                        kappa=None) -> tuple[np.ndarray, np.ndarray]:
    """G and detJ for all cells, NumPy float64 (read-only arrays).

    Without ``kappa`` the result is kept on the mesh per degree: the
    hierarchy, the RHS and the L2 error of one problem share one
    computation (at 16.2M dofs, p=6, it holds 1.4 GB and saves tens of
    seconds each time)."""
    cache = mesh.__dict__.setdefault("_geometry_factors_np", {})
    if kappa is None and P in cache:
        return cache[P]
    G, detJ = geometry_factors(
        mesh.geometry_x,
        mesh.geometry_dofmap,
        tabulate_geometry_dphi(P),
        quadrature_weights_3d(P),
        kappa=kappa,
    )
    G, detJ = np.asarray(G), np.asarray(detJ)
    G.setflags(write=False)
    detJ.setflags(write=False)
    if kappa is None:
        cache[P] = (G, detJ)
    return G, detJ


def gradient_tables(P: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """3D basis gradient tables ``B_d[(nq, ndofs)]`` at the GLL points
    (``Bx = D (x) I (x) I`` etc.: the 1D value table is the identity)."""
    n = P + 1
    D = derivative_matrix(P)
    I = np.eye(n)
    Bx = np.einsum("qi,rj,sk->qrsijk", D, I, I).reshape(n**3, n**3)
    By = np.einsum("qi,rj,sk->qrsijk", I, D, I).reshape(n**3, n**3)
    Bz = np.einsum("qi,rj,sk->qrsijk", I, I, D).reshape(n**3, n**3)
    return Bx, By, Bz


def element_stiffness(G_cell: np.ndarray, P: int, coeff: float = 1.0) -> np.ndarray:
    """Dense element stiffness ``A^e = coeff * sum_ab B_a^T diag(G_ab) B_b``."""
    B = gradient_tables(P)
    idx = [[0, 1, 2], [1, 3, 4], [2, 4, 5]]
    A = np.zeros((B[0].shape[1], B[0].shape[1]))
    for a in range(3):
        for b in range(3):
            A += B[a].T @ (G_cell[:, idx[a][b], None] * B[b])
    return coeff * A


def assemble_stiffness(mesh: BoxMesh, P: int, kappa=1.0, bc: bool = True):
    """Assemble the global stiffness matrix (scipy CSR): the oracle of the
    matrix-free operators. With ``bc=True`` Dirichlet rows and columns are
    zeroed and the diagonal set to 1 (the matrix-free bc semantics)."""
    import scipy.sparse as sp

    kc, kt, _ = resolve_kappa_split(mesh, kappa)
    G, _ = geometry_factors_np(mesh, P, kappa=kt)
    dofmap = mesh.dofmap(P)
    ndofs = mesh.num_dofs(P)
    ncells, nld = dofmap.shape
    rows = np.repeat(dofmap, nld, axis=1).ravel()
    cols = np.tile(dofmap, (1, nld)).ravel()
    vals = np.empty((ncells, nld, nld))
    for c in range(ncells):
        vals[c] = element_stiffness(G[c], P, kc[c])
    A = sp.coo_matrix((vals.ravel(), (rows, cols)), shape=(ndofs, ndofs)).tocsr()
    if bc:
        marker = mesh.boundary_dof_marker(P)
        keep = sp.diags((~marker).astype(np.float64))
        A = keep @ A @ keep + sp.diags(marker.astype(np.float64))
    return A.tocsr()


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


def lumped_mass_np(mesh: BoxMesh, P: int, bc_zero: bool = False) -> np.ndarray:
    """GLL-lumped mass ``m_i = sum_{cells ∋ i} w_q detJ(c, q)`` on any hex
    mesh (float64); ``bc_zero=True`` zeroes the Dirichlet entries (the
    ``m3`` of a scalar sigma shift on the general backends)."""
    _, detJ = geometry_factors_np(mesh, P)
    w = quadrature_weights_3d(P)
    vals = w[None, :] * detJ
    m = np.zeros(mesh.num_dofs(P))
    np.add.at(m, mesh.dofmap(P).ravel(), vals.ravel())
    if bc_zero:
        m[mesh.boundary_dof_marker(P)] = 0.0
    return m


def scale_G(G_cells, kappa_scalar, kappa_tensor):
    """Apply the scalar DG-0 coefficient to the geometry factors (identity
    when a tensor coefficient was already folded into ``G_cells``)."""
    if kappa_tensor is not None:
        return G_cells
    return G_cells * kappa_scalar[:, None, None]


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


def l2_error_collocated(mesh: BoxMesh, P: int, u_h: np.ndarray,
                        u_exact) -> float:
    """L2 error with the collocated GLL rule, valid on any hex mesh:
    ``err^2 = sum_cq w_q detJ_cq (u_h - u_e)^2`` at the dof points."""
    _, detJ = geometry_factors_np(mesh, P)
    w = quadrature_weights_3d(P)
    dofmap = mesh.dofmap(P)
    coords = mesh.dof_coords(P)[dofmap]  # (ncells, nld, 3)
    ue = u_exact(coords.reshape(-1, 3).T).reshape(dofmap.shape)
    diff = np.asarray(u_h)[dofmap] - ue
    return float(np.sqrt(np.sum(w[None, :] * detJ * diff**2)))
