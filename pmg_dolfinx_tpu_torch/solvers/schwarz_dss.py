"""Cell-wise FDM Schwarz smoother on UNSTRUCTURED hex topology.

Port of `pmg_dolfinx_tpu.solvers.schwarz_dss` (the host NumPy copied, so
the blocks agree bit for bit). The Schwarz blocks are CELL-LOCAL, the
structure the DSS layout moves: the cell expansion / overlap-add is
`ops.unstructured.dss_gather` / `dss_scatter`, and the per-cell separable
block inverse is three batched (P+1)x(P+1) eigenvector transforms around
a pointwise eigenvalue scale, batched over all cells at once (torch
einsums, TF32 off).

Block construction (the separable Lottes-Fischer approximation, same
class as the box general-family path): each cell gets per-axis 1D
stiffness/mass from its own mean edge length along that axis, with

- neighbour end augmentation (``K[0,0]``/``m[0]`` of a same-size
  virtual neighbour cell) on ends whose face is INTERIOR — what makes
  the non-overlapping local problem well-posed, exactly the box
  `_axis_eigs` global-matrix block for uniform spacing (graded boxes
  use the true neighbour h there; here the own-h approximation);
- Dirichlet identity embedding on ends whose face is a fully-marked
  boundary face; free (Neumann) ends otherwise.

The per-cell generalized eigenproblems are solved BATCHED
(``np.linalg.eigh`` over an (ncells*3, n, n) stack) with the bc
embedding done by masking rows/cols to the identity — no per-cell
Python loop. Coefficients: the per-cell scalar (or the diagonal of a
tensor) kappa scales the per-axis eigenvalues, ``sigma`` adds exactly
(mass-orthonormal eigenbases make it a pure offset).
"""

import numpy as np
import torch


def _cell_axis_lengths(mesh):
    """Mean edge length of every cell along each lattice axis
    ``(ncells, 3)``."""
    C = mesh.geometry_x[mesh.geometry_dofmap]  # (nc, 8, 3)
    axes_edges = (
        ((0, 4), (1, 5), (2, 6), (3, 7)),   # x edges
        ((0, 2), (1, 3), (4, 6), (5, 7)),   # y edges
        ((0, 1), (2, 3), (4, 5), (6, 7)),   # z edges
    )
    h = np.empty((len(C), 3))
    for a, edges in enumerate(axes_edges):
        h[:, a] = np.mean(
            [np.linalg.norm(C[:, i] - C[:, j], axis=1) for i, j in edges],
            axis=0)
    return h


def _cell_face_flags(mesh, P):
    """(interior, dirichlet) flags per (cell, axis, end): interior =
    the face is shared with another cell; dirichlet = every dof of the
    face is marked."""
    from ..fem.unstructured import _FACES

    lt = mesh.dss_layout(P)
    nc = mesh.ncells
    n = P + 1
    dml = mesh.dofmap(P).reshape(nc, n, n, n)
    marker = np.asarray(mesh.boundary_dof_marker(P))
    interior = np.zeros((nc, 3, 2), dtype=bool)
    dirichlet = np.zeros((nc, 3, 2), dtype=bool)
    if lt["nF"]:
        if lt["face_src"].shape[1] > 1:
            has_two = lt["face_src"][:, 1] != nc * 6
        else:
            has_two = np.zeros(lt["nF"], dtype=bool)
    else:
        # P=1: no face-interior entities; interiority comes from the
        # topological boundary faces (owned by exactly one cell).
        bset = set(mesh._boundary_cell_faces())
    for fi, (_, a, e) in enumerate(_FACES):
        if lt["nF"]:
            interior[:, a, e] = has_two[lt["face_id"][:, fi]]
        else:
            interior[:, a, e] = [(c, fi) not in bset for c in range(nc)]
        sl = [slice(None)] * 3
        sl[a] = 0 if e == 0 else n - 1
        face_dofs = dml[(slice(None),) + tuple(sl)].reshape(nc, -1)
        dirichlet[:, a, e] = marker[face_dofs].all(axis=1)
    return interior, dirichlet


def build_schwarz_dss(mesh, P, kappa, dtype, sigma=0.0, *, device):
    """Device data for `dss_schwarz_apply`: per-axis eigenvector stacks
    ``V (nc, 3, n, n)`` (mass-orthonormal, bc rows identity), the
    cell-expanded inverse eigenvalue grid ``ginv (nc, n, n, n)``, the
    multiplicity weight ``w (ndofs,)`` and the bc marker, on ``device``."""
    from ..fem.assembly import resolve_kappa_split
    from ..ops.kron import axis_stiffness_mass

    n = P + 1
    nc = mesh.ncells
    kc, kt, _ = resolve_kappa_split(mesh, kappa)
    if kt is not None:
        kd = np.diagonal(kt, axis1=1, axis2=2)  # (nc, 3)
    else:
        kd = np.broadcast_to(np.asarray(kc, np.float64)[:, None], (nc, 3))
    h = _cell_axis_lengths(mesh)
    interior, dirichlet = _cell_face_flags(mesh, P)

    # Reference 1D matrices at unit spacing: K ~ 1/h, m ~ h.
    K1u, m1u = axis_stiffness_mass(1, P, 1.0)
    K1u, m1u = np.asarray(K1u, np.float64), np.asarray(m1u, np.float64)

    S = (K1u[None, None] / h[:, :, None, None]).copy()  # (nc, 3, n, n)
    d = (m1u[None, None] * h[:, :, None]).copy()        # (nc, 3, n)
    # Neighbour end augmentation on interior ends (own-h virtual
    # neighbour: K[0,0] == K[-1,-1] and m[0] == m[-1] at uniform h).
    for e, (row, src) in enumerate(((0, n - 1), (n - 1, 0))):
        aug = interior[:, :, e]
        S[:, :, row, row] += aug * K1u[src, src] / h
        d[:, :, row] += aug * m1u[src] * h
    # Dirichlet embedding: zero the bc row/col, unit diagonal/mass.
    for e, row in ((0, 0), (1, n - 1)):
        bce = dirichlet[:, :, e]
        S[:, :, row, :] = np.where(bce[:, :, None], 0.0, S[:, :, row, :])
        S[:, :, :, row] = np.where(bce[:, :, None], 0.0, S[:, :, :, row])
        S[:, :, row, row] = np.where(bce, 1.0, S[:, :, row, row])
        d[:, :, row] = np.where(bce, 1.0, d[:, :, row])
    L = np.sqrt(d)
    w_eig, W = np.linalg.eigh(S / L[..., :, None] / L[..., None, :])
    V = W / L[..., :, None]          # (nc, 3, n, n), V^T diag(d) V = I
    lam = w_eig                      # (nc, 3, n)

    lsum = (
        kd[:, 0, None, None, None] * lam[:, 0, :, None, None]
        + kd[:, 1, None, None, None] * lam[:, 1, None, :, None]
        + kd[:, 2, None, None, None] * lam[:, 2, None, None, :]
        + float(sigma)
    )
    mult = np.asarray(mesh.dof_multiplicity(P))
    arr = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                    device=device)
    return dict(
        V=arr(V),
        ginv=arr(1.0 / lsum),
        w=arr(1.0 / np.sqrt(mult)),
        bc=torch.tensor(np.asarray(mesh.boundary_dof_marker(P)),
                        device=device),
    )


def dss_schwarz_apply(sw, r, t, meta, precision="highest", exchange=None):
    """Apply ``M^-1 = W [sum_cells R_c^T B_c^-1 R_c] W`` on the DSS dof
    vector: bc-zero and weight, DSS cell gather, batched per-cell
    eigenvector transforms around the pointwise eigenvalue scale, DSS
    overlap-add scatter, weight, bc identity epilogue. ``exchange`` keeps
    the JAX slot of the distributed layer's partial-sum reconciliation
    (applied after the overlap-add when given)."""
    from ..ops.kron_blocked import _check_precision
    from ..ops.unstructured import dss_gather, dss_scatter

    _check_precision(precision)
    xb = torch.where(sw["bc"], torch.zeros_like(r), r) * sw["w"]
    u = dss_gather(xb, t, meta)
    V = sw["V"]
    # V^T transforms (contract the node index against V's rows).
    u = torch.einsum("ciq,cijk->cqjk", V[:, 0], u)
    u = torch.einsum("cjq,cijk->ciqk", V[:, 1], u)
    u = torch.einsum("ckq,cijk->cijq", V[:, 2], u)
    u = u * sw["ginv"]
    u = torch.einsum("ckq,cijq->cijk", V[:, 2], u)
    u = torch.einsum("cjq,ciqk->cijk", V[:, 1], u)
    u = torch.einsum("ciq,cqjk->cijk", V[:, 0], u)
    y = dss_scatter(u, t, meta)
    if exchange is not None:
        y = exchange(y)
    y = y * sw["w"]
    return torch.where(sw["bc"], r, y)
