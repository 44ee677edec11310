"""NumPy host-side helpers: assembly oracle, RHS, error norms, coefficients.

Port of `pmg_dolfinx_tpu.fem.assembly`: the scipy stiffness oracle
(with the Robin boundary mass), the RHS, the Robin surface terms
(`robin_mass_np`, `robin_rhs_np`), the Dirichlet lifting `lifted_rhs`,
the lumped mass and its shifted forms (`shifted_mass_np` /
`general_shift_np`: a scalar sigma or a sigma field, Robin faces baked
in), the stiffness diagonal, the Gauss-Legendre (axis-aligned) and
collocated (any hex) L2 errors, and the coefficient resolvers (kappa as
a scalar, a per-axis tuple, a DG-0 array, a callable, or a constant or
per-cell 3x3 tensor). Everything here is setup-time NumPy (float64),
copied from the JAX package so the arrays agree bit for bit; none of it
runs in the solve path.
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
    zeroed and the diagonal set to 1 (the matrix-free bc semantics). Robin
    faces add their boundary mass."""
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
    if getattr(mesh, "has_robin", False):
        # the (GLL-diagonal) Robin boundary mass belongs to the form
        A = A + sp.diags(robin_mass_np(mesh, P, bc_zero=False))
    if bc:
        marker = mesh.boundary_dof_marker(P)
        keep = sp.diags((~marker).astype(np.float64))
        A = keep @ A @ keep + sp.diags(marker.astype(np.float64))
    return A.tocsr()


def _face_surface_quadrature(mesh: BoxMesh, P: int, axis: int, side: int):
    """Collocated GLL surface rule on one boundary face: ``(dofs, wts,
    pts)``, the global dof ids ``(nfc, n, n)`` of the face nodes of every
    boundary-layer cell, the weights ``w_j w_k |t_u x t_v|`` (Q1 face
    metric) and the node coordinates ``(nfc, n, n, 3)``. Shared-edge nodes
    appear once per adjacent cell; scatter-add to assemble."""
    n = P + 1
    xg, w1 = gauss_lobatto(n)
    nx, ny, nz = mesh.nc
    corners = mesh.geometry_x[mesh.geometry_dofmap].reshape(
        nx, ny, nz, 2, 2, 2, 3
    )
    csl = [slice(None)] * 3
    csl[axis] = 0 if side == 0 else -1
    fsl = [slice(None)] * 3
    fsl[axis] = 0 if side == 0 else 1
    # (nfc, 2, 2, 3): the face's corners over its two in-face axes
    C = corners[tuple(csl) + tuple(fsl)].reshape(-1, 2, 2, 3)
    phi = np.stack([1.0 - xg, xg], axis=1)  # (n, 2)
    # tangents of the bilinear face map: d/du depends on v only and
    # d/dv on u only
    Xu = np.einsum("kb,cbD->ckD", phi, C[:, 1] - C[:, 0])  # at v = xg_k
    Xv = np.einsum("ja,caD->cjD", phi, C[:, :, 1] - C[:, :, 0])  # at u = xg_j
    Tu = np.broadcast_to(Xu[:, None, :, :], (C.shape[0], n, n, 3))
    Tv = np.broadcast_to(Xv[:, :, None, :], (C.shape[0], n, n, 3))
    nrm = np.cross(Tu, Tv)
    dS = np.sqrt((nrm**2).sum(axis=-1))  # (nfc, n, n)
    wts = w1[None, :, None] * w1[None, None, :] * dS
    dm = mesh.dofmap(P).reshape(nx, ny, nz, n, n, n)
    dsl = [slice(None)] * 3
    dsl[axis] = 0 if side == 0 else -1
    lsl = [slice(None)] * 3
    lsl[axis] = 0 if side == 0 else -1
    dofs = dm[tuple(dsl) + tuple(lsl)].reshape(-1, n, n)
    pts = mesh.dof_coords(P)[dofs]  # (nfc, n, n, 3)
    return dofs, wts, pts


def robin_mass_np(mesh: BoxMesh, P: int, bc_zero: bool = True) -> np.ndarray:
    """Diagonal Robin boundary mass ``b[(ndofs,)]``: ``b_i = sum_{Robin
    faces F ∋ i} alpha_F w_i^F`` with the collocated GLL surface rule, the
    term ``integral alpha u v ds`` of ``kappa du/dn + alpha u = g``. On an
    axis-aligned box it equals the per-axis end-point form ``alpha e e^T
    (x) M (x) M`` the Kronecker/FDM family carries. ``bc_zero=True``
    zeroes the Dirichlet-marked entries (identity rows)."""
    b = np.zeros(mesh.num_dofs(P))
    for axis in range(3):
        for side in range(2):
            alpha = float(mesh.robin_alpha[axis, side])
            if alpha == 0.0:
                continue
            dofs, wts, _ = _face_surface_quadrature(mesh, P, axis, side)
            np.add.at(b, dofs.ravel(), alpha * wts.ravel())
    if bc_zero:
        b[mesh.boundary_dof_marker(P)] = 0.0
    return b


def robin_rhs_np(mesh: BoxMesh, P: int, g) -> np.ndarray:
    """Robin data ``integral g v ds`` of the load vector. ``g`` is a
    callable over points ``x[(3, npts)]`` used on every Robin face, or a
    dict keyed by ``(axis, side)`` of callables or scalars. Dirichlet
    entries are zeroed; add to `assemble_rhs`'s volume term."""
    b = np.zeros(mesh.num_dofs(P))
    for axis in range(3):
        for side in range(2):
            if float(mesh.robin_alpha[axis, side]) == 0.0:
                continue
            gf = g.get((axis, side), 0.0) if isinstance(g, dict) else g
            dofs, wts, pts = _face_surface_quadrature(mesh, P, axis, side)
            gv = (gf(pts.reshape(-1, 3).T).reshape(wts.shape)
                  if callable(gf) else float(gf))
            np.add.at(b, dofs.ravel(), (gv * wts).ravel())
    b[mesh.boundary_dof_marker(P)] = 0.0
    return b


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


def shifted_mass_np(mesh: BoxMesh, P: int, sigma_field=None,
                    bc_zero: bool = True) -> np.ndarray:
    """GLL-lumped mass, scaled pointwise by the reaction field
    ``sigma_field(x)`` at the dof coordinates when one is given: the
    ``m3`` vector of a sigma shift."""
    m = lumped_mass_np(mesh, P, bc_zero=bc_zero)
    if sigma_field is not None:
        m = m * np.asarray(sigma_field(mesh.dof_coords(P).T), np.float64)
    return m


def general_shift_np(mesh: BoxMesh, P: int, sigma, sigma_field=None):
    """``(ops_sigma, m3)``: the pointwise shift of a general-backend level
    (the apply and the Jacobi diagonal add ``ops_sigma * m3 * u``). Without
    Robin faces the scalar is sigma and ``m3`` the (field-scaled) lumped
    mass, None when sigma is 0. With Robin faces the boundary mass and
    ``sigma * m3`` are baked into one ``m3`` and the scalar is 1.0."""
    sigma = float(sigma)
    scalar = ops_shift_scalar(mesh, sigma)
    if not getattr(mesh, "has_robin", False):
        return scalar, (shifted_mass_np(mesh, P, sigma_field)
                        if sigma else None)
    m3 = robin_mass_np(mesh, P)
    if sigma:
        m3 = m3 + sigma * shifted_mass_np(mesh, P, sigma_field)
    return scalar, m3


def lifted_rhs(mesh: BoxMesh, P: int, kappa, f, g):
    """Inhomogeneous Dirichlet data ``u = g`` on the flagged faces by
    lifting: ``(b_hom, u_g)``, solve ``A w = b_hom`` and take ``u = w +
    u_g``. ``u_g`` is ``g`` at the Dirichlet dofs (zero elsewhere) and
    ``b_hom = b_raw - A_raw u_g`` with its Dirichlet rows zeroed (one
    host scipy matvec)."""
    bc = np.asarray(mesh.boundary_dof_marker(P))
    u_g = np.zeros(mesh.num_dofs(P))
    coords = mesh.dof_coords(P)
    u_g[bc] = np.asarray(g(coords[bc].T), dtype=np.float64)
    b = assemble_rhs(mesh, P, f, bc=False)
    A = assemble_stiffness(mesh, P, kappa=kappa, bc=False)
    b = b - A @ u_g
    b[bc] = 0.0
    return b, u_g


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
    """Resolve a coefficient to ``(kappa_cells, is_constant)``. ``kappa``
    is a scalar, a per-axis ``(kx, ky, kz)`` (sugar for the diagonal
    tensor), an ``(ncells,)`` DG-0 array in dofmap cell order, a
    symmetric ``(3, 3)`` or ``(ncells, 3, 3)`` diffusion tensor (resolved
    to ``(ncells, 3, 3)``), or a callable over points ``x[(3, npts)]``
    sampled at the cell centroids returning scalars or 3x3 tensors.
    ``is_constant`` is True only for a constant scalar."""
    if (isinstance(kappa, (tuple, list)) and len(kappa) == 3
            and all(np.ndim(k) == 0 for k in kappa)):
        kappa = np.diag([float(k) for k in kappa])
    if callable(kappa):
        vals = np.asarray(
            kappa(mesh.cell_centroids().T), dtype=np.float64
        )
        if vals.ndim >= 2 and vals.shape[-2:] == (3, 3):
            kappa = vals.reshape(-1, 3, 3)  # a tensor field: below
        else:
            vals = vals.reshape(-1)
            if vals.shape != (mesh.ncells,):
                raise ValueError(
                    f"kappa callable returned shape {vals.shape}, "
                    f"expected ({mesh.ncells},)"
                )
            return vals, bool(np.all(vals == vals[0]))
    arr = np.asarray(kappa, dtype=np.float64)
    if arr.ndim == 0:
        return np.full(mesh.ncells, float(arr)), True
    if arr.shape[-2:] == (3, 3) and arr.ndim in (2, 3):
        if arr.ndim == 3 and arr.shape[0] != mesh.ncells:
            raise ValueError(
                f"per-cell tensor kappa has shape {arr.shape}, expected "
                f"({mesh.ncells}, 3, 3)"
            )
        arr = np.broadcast_to(arr, (mesh.ncells, 3, 3)).copy()
        if not np.allclose(arr, np.swapaxes(arr, -1, -2)):
            raise ValueError("tensor kappa must be symmetric")
        return arr, False
    if arr.shape != (mesh.ncells,):
        raise ValueError(
            f"per-cell kappa has shape {arr.shape}, expected ({mesh.ncells},)"
            " — or (3, 3) / (ncells, 3, 3) for a diffusion tensor"
        )
    return arr.copy(), bool(np.all(arr == arr[0]))


def resolve_kappa_split(mesh: BoxMesh, kappa):
    """`resolve_kappa` split for the geometry fold: ``(kappa_scalar,
    kappa_tensor, is_constant)``. ``kappa_scalar`` is always an
    ``(ncells,)`` array (all ones for a tensor coefficient) and
    ``kappa_tensor`` None or the ``(ncells, 3, 3)`` field for
    `geometry_factors(kappa=...)`; pair with `scale_G`."""
    kc, const = resolve_kappa(mesh, kappa)
    if kc.ndim == 3:
        return np.ones(mesh.ncells), kc, False
    return kc, None, const


def resolve_kappa_axes(mesh: BoxMesh, kappa, split=None):
    """Resolve a Kronecker-family coefficient to per-axis scalars ``(kx,
    ky, kz)``: a scalar, a length-3 sequence, or a constant diagonal
    ``(3, 3)`` / ``(ncells, 3, 3)`` tensor. Per-cell, off-diagonal or
    otherwise non-separable coefficients raise ValueError (use the
    lattice or dofmap backends)."""
    if (isinstance(kappa, (tuple, list)) and len(kappa) == 3
            and all(np.ndim(k) == 0 for k in kappa)):
        return tuple(float(k) for k in kappa)
    kc, kt, const = split if split is not None else resolve_kappa_split(
        mesh, kappa)
    if kt is None:
        if not const:
            raise ValueError(
                "the Kronecker-sum factorization needs a constant (or "
                "constant per-axis / diagonal-tensor) kappa; got a "
                "per-cell field — use operator='lattice', 'lattice_blocked' or 'dofmap'"
            )
        k = float(kc[0])
        return (k, k, k)
    if not np.allclose(kt, kt[0]):
        raise ValueError(
            "the Kronecker-sum factorization needs a CONSTANT diagonal "
            "tensor kappa; got a per-cell tensor field — use "
            "operator='lattice' or 'dofmap'"
        )
    K0 = kt[0]
    if not np.allclose(K0, np.diag(np.diag(K0))):
        raise ValueError(
            "the Kronecker-sum factorization needs a constant DIAGONAL "
            "tensor kappa (it cannot express cross-derivative terms); "
            f"got off-diagonal entries {K0.tolist()} — use "
            "operator='lattice' or 'dofmap'"
        )
    return tuple(float(v) for v in np.diag(K0))


def stiffness_diagonal_np(mesh: BoxMesh, P: int, kappa=1.0) -> np.ndarray:
    """The exact stiffness diagonal in float64 on the host (the dofmap
    formula of `ops.laplacian.laplacian_diagonal`, summed in cell order);
    ``kappa`` is any form `resolve_kappa` takes. Dirichlet rows get 1."""
    kc, kt, _ = resolve_kappa_split(mesh, kappa)
    G, _ = geometry_factors_np(mesh, P, kappa=kt)
    kappa = kc[:, None, None, None]
    n = P + 1
    g = G.reshape(mesh.ncells, n, n, n, 6)
    D = derivative_matrix(P)
    D2 = D * D
    d = np.diagonal(D)
    diag = (
        np.einsum("mi,cmjk->cijk", D2, g[..., 0])
        + np.einsum("mj,cimk->cijk", D2, g[..., 3])
        + np.einsum("mk,cijm->cijk", D2, g[..., 5])
        + 2.0
        * (
            d[:, None, None] * d[None, :, None] * g[..., 1]
            + d[:, None, None] * d[None, None, :] * g[..., 2]
            + d[None, :, None] * d[None, None, :] * g[..., 4]
        )
    ) * kappa
    out = np.zeros(mesh.num_dofs(P))
    np.add.at(out, mesh.dofmap(P).ravel(), diag.ravel())
    out[mesh.boundary_dof_marker(P)] = 1.0
    return out


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
