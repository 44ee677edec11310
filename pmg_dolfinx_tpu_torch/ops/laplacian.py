"""Matrix-free sum-factorised Laplacian through the cell dofmap.

Port of `pmg_dolfinx_tpu.ops.laplacian`, the reference's own structure
(src/laplacian.hpp:143-278): gather each cell's dofs, apply the per-cell
kernel, scatter-add back. In torch the gather is `index_select` and the
scatter `index_add_`; on a CUDA device `index_add_` adds with atomics, so
the float32 sum order of a shared dof changes from run to run (the f64
CPU path is sequential). This is the ``operator="dofmap"`` backend, the
exact diagonal of every general-hex backend, and the oracle the lattice
forms are held against. The geometry-batched apply
(`laplacian_apply_batched`) is not ported yet.

    gather  : u_cells = x[dofmap]  (bc dofs zeroed)
    forward : du_d = D contracted along axis d
    scale   : fw = coeff * G @ du  (6-entry symmetric G)
    back    : y_cells = D^T contracted along each axis
    scatter : y[dofmap] += y_cells; y[bc] = x[bc]
"""

import torch

from ..fem.assembly import geometry_factors_np, resolve_kappa_split
from ..fem.gll import derivative_matrix


def laplacian_apply_cells(u_cells, G, coeff, D):
    """Cell-local stiffness action: ``u_cells`` ``(ncells, n, n, n)``,
    ``G`` ``(ncells, n^3, 6)``, ``coeff`` ``(ncells,)``, ``D`` ``(n, n)``
    with ``D[q, i] = l_i'(x_q)``; returns ``(ncells, n, n, n)``."""
    n = D.shape[0]
    g = G.reshape(G.shape[0], n, n, n, 6)
    ux = torch.einsum("qi,cijk->cqjk", D, u_cells)
    uy = torch.einsum("qj,cijk->ciqk", D, u_cells)
    uz = torch.einsum("qk,cijk->cijq", D, u_cells)
    c = coeff[:, None, None, None]
    fw0 = c * (g[..., 0] * ux + g[..., 1] * uy + g[..., 2] * uz)
    fw1 = c * (g[..., 1] * ux + g[..., 3] * uy + g[..., 4] * uz)
    fw2 = c * (g[..., 2] * ux + g[..., 4] * uy + g[..., 5] * uz)
    return (
        torch.einsum("qi,cqjk->cijk", D, fw0)
        + torch.einsum("qj,ciqk->cijk", D, fw1)
        + torch.einsum("qk,cijq->cijk", D, fw2)
    )


def laplacian_scatter_raw(x, dofmap, G, coeff, D, bc_marker):
    """Gather -> cell apply -> scatter-add, without the bc row epilogue
    (bc dofs zeroed on gather only). ``dofmap`` is an int64 tensor."""
    n = D.shape[0]
    ncells = dofmap.shape[0]
    idx = dofmap.reshape(-1)
    xb = torch.where(bc_marker, torch.zeros_like(x), x)
    u_cells = xb.index_select(0, idx).reshape(ncells, n, n, n)
    y_cells = laplacian_apply_cells(u_cells, G, coeff, D)
    return torch.zeros_like(x).index_add_(0, idx, y_cells.reshape(-1))


def laplacian_apply(x, dofmap, G, coeff, D, bc_marker):
    """``y = A x`` on a flat dof vector; bc rows return ``x``."""
    y = laplacian_scatter_raw(x, dofmap, G, coeff, D, bc_marker)
    return torch.where(bc_marker, x, y)


def laplacian_diagonal_raw(dofmap, G, coeff, D, ndofs):
    """Scatter-added diagonal without the bc override."""
    n = D.shape[0]
    ncells = dofmap.shape[0]
    g = G.reshape(ncells, n, n, n, 6)
    D2 = D * D
    d = torch.diagonal(D)
    diag = (
        torch.einsum("mi,cmjk->cijk", D2, g[..., 0])
        + torch.einsum("mj,cimk->cijk", D2, g[..., 3])
        + torch.einsum("mk,cijm->cijk", D2, g[..., 5])
        + 2.0
        * (
            d[:, None, None] * d[None, :, None] * g[..., 1]
            + d[:, None, None] * d[None, None, :] * g[..., 2]
            + d[None, :, None] * d[None, None, :] * g[..., 4]
        )
    )
    diag = diag * coeff[:, None, None, None]
    out = torch.zeros(ndofs, dtype=diag.dtype, device=diag.device)
    return out.index_add_(0, dofmap.reshape(-1), diag.reshape(-1))


def laplacian_diagonal(dofmap, G, coeff, D, bc_marker, ndofs):
    """Matrix-free diagonal of A (Jacobi); bc rows get 1. For local dof
    ``(i, j, k)`` the element diagonal is ``sum_m D[m,i]^2 G00[m,j,k] +
    D[m,j]^2 G11[i,m,k] + D[m,k]^2 G22[i,j,m] + 2 (D[i,i] D[j,j] G01 +
    D[i,i] D[k,k] G02 + D[j,j] D[k,k] G12)``, scatter-added over cells."""
    out = laplacian_diagonal_raw(dofmap, G, coeff, D, ndofs)
    return torch.where(bc_marker, torch.ones_like(out), out)


class MatFreeLaplacian:
    """Operator bundle of the dofmap formulation on ``device``: dofmap, G,
    1D derivative table, bc marker, diagonal; ``op(x) -> y`` on flat
    vectors. ``kappa`` is any form `fem.assembly.resolve_kappa` takes (a
    tensor folds into G)."""

    def __init__(self, mesh, P, kappa=1.0, dtype=torch.float64, *, device):
        self.P = int(P)
        self.mesh = mesh
        self.dtype = dtype
        self.device = torch.device(device)
        t = lambda a: torch.tensor(a, dtype=dtype, device=self.device)
        kc, kt, _ = resolve_kappa_split(mesh, kappa)
        G, _ = geometry_factors_np(mesh, self.P, kappa=kt)
        self.G = t(G)
        self.coeff = t(kc)
        self.D = t(derivative_matrix(self.P))
        self.dofmap = torch.tensor(mesh.dofmap(self.P), dtype=torch.int64,
                                   device=self.device)
        self.bc_marker = torch.tensor(mesh.boundary_dof_marker(self.P),
                                      device=self.device)
        self.ndofs = mesh.num_dofs(self.P)
        self.diag = laplacian_diagonal(self.dofmap, self.G, self.coeff,
                                       self.D, self.bc_marker, self.ndofs)
        self.diag_inv = 1.0 / self.diag

    def __call__(self, x):
        return laplacian_apply(x, self.dofmap, self.G, self.coeff, self.D,
                               self.bc_marker)
