"""Lattice-form matrix-free Laplacian and the p-transfers between degrees.

Port of `pmg_dolfinx_tpu.ops.lattice`. The dof lattice ``(NX, NY, NZ)``
maps to the quadrature lattice ``(Qx, Qy, Qz)``, ``Q = nc*(P+1)``
(cell-discontinuous points), through per-axis block-banded matrices: the
expansion ``E`` (``E[c*n + j, c*P + j] = 1``, which duplicates the
cell-interface planes) and the derivative ``Dg`` (``Dg[c*n + q, c*P + i]
= D1[q, i]``). Then

    ux = Dx o (Ey o (Ez o u)),  uy = Ex o (Dy o (Ez o u)),  uz = ...
    (tx, ty, tz) = G @ (ux, uy, uz)      per quadrature point
    y  = Ez^T o Ey^T o Dx^T o tx + ...   (E^T overlap-adds the interfaces)

on general (curved) hexes. The axis matrices are host numpy (float64,
copied from the JAX package); the contractions are dense `torch.einsum`
calls, as the JAX package leaves them to XLA. This is the
``operator="lattice"`` backend and the plain version of the CUDA kernels
of `ops/lattice_blocked.py`. `expand_axis0` / `fold_axis0` are the
reshape-and-add forms of ``E`` and ``E^T`` along one axis.
"""

import numpy as np
import torch

from ..fem.gll import derivative_matrix, interpolation_matrix_1d
from .kron_blocked import _check_precision


def axis_matrices(nc: int, P: int, dtype=np.float64):
    """Global per-axis (E, Dg) matrices of shape ``(nc*(P+1), nc*P+1)``."""
    n = P + 1
    N = nc * P + 1
    Q = nc * n
    D1 = derivative_matrix(P)
    E = np.zeros((Q, N), dtype=dtype)
    Dg = np.zeros((Q, N), dtype=dtype)
    for c in range(nc):
        for q in range(n):
            E[c * n + q, c * P + q] = 1.0
            Dg[c * n + q, c * P: c * P + n] = D1[q]
    return E, Dg


def axis_interpolation_matrix(nc: int, P_coarse: int, P_fine: int, dtype=np.float64):
    """Global per-axis inter-degree interpolation ``(nc*Pf+1, nc*Pc+1)``;
    its plain transpose is the restriction."""
    M1 = interpolation_matrix_1d(P_coarse, P_fine)
    Nf, Nc = nc * P_fine + 1, nc * P_coarse + 1
    I1 = np.zeros((Nf, Nc), dtype=dtype)
    for c in range(nc):
        # Overlapping interface rows receive identical values (C0 nodal).
        I1[c * P_fine: c * P_fine + P_fine + 1,
           c * P_coarse: c * P_coarse + P_coarse + 1] = M1
    return I1


def along_x(M, t):
    return torch.einsum("ax,xyz->ayz", M, t)


def along_y(M, t):
    return torch.einsum("by,xyz->xbz", M, t)


def along_z(M, t):
    return torch.einsum("cz,xyz->xyc", M, t)


def lattice_prolongate(x_c, I1s, shape_c, precision="highest"):
    """Coarse->fine transfer via three per-axis dense contractions.
    Shape-preserving: lattice-shaped in -> lattice-shaped out, flat in ->
    flat out. ``precision`` is the JAX package's fourth positional; only
    'highest' is ported."""
    _check_precision(precision)
    Ix, Iy, Iz = I1s
    t = x_c.reshape(shape_c)
    t = along_x(Ix, t)
    t = along_y(Iy, t)
    t = along_z(Iz, t)
    return t if x_c.ndim == 3 else t.reshape(-1)


def lattice_restrict(x_f, I1s, shape_f, precision="highest"):
    """Fine->coarse transfer: the transposed per-axis contractions."""
    _check_precision(precision)
    Ix, Iy, Iz = I1s
    t = x_f.reshape(shape_f)
    t = along_x(Ix.T, t)
    t = along_y(Iy.T, t)
    t = along_z(Iz.T, t)
    return t if x_f.ndim == 3 else t.reshape(-1)


def expand_axis0(t, nc, P):
    """Dof axis -> quadrature axis along dim 0: ``out[c*n+i] = t[c*P+i]``
    (a copy, no arithmetic)."""
    n = P + 1
    head = t[:-1].reshape((nc, P) + tuple(t.shape[1:]))
    tail = t[P::P][:, None]
    return torch.cat([head, tail], dim=1).reshape((nc * n,) + tuple(t.shape[1:]))


def fold_axis0(s, nc, P):
    """Transpose of `expand_axis0`: overlap-add the cell-block rows back to
    the dof axis (``out[c*P+i] += s[c*n+i]``)."""
    n = P + 1
    s = s.reshape((nc, n) + tuple(s.shape[1:]))
    core = s[:, :P].reshape((nc * P,) + tuple(s.shape[2:]))
    zero = torch.zeros((1,) + tuple(core.shape[1:]), dtype=core.dtype,
                       device=core.device)
    out = torch.cat([core, zero], dim=0)  # rows 0 .. nc*P
    extra = s[:, P]  # contributions to rows (c+1)*P
    tail = out[1:].reshape((nc, P) + tuple(core.shape[1:])).clone()
    tail[:, P - 1] += extra
    return torch.cat([out[:1], tail.reshape((nc * P,) + tuple(core.shape[1:]))],
                     dim=0)


def _expand(t, axis, nc, P):
    if axis == 0:
        return expand_axis0(t, nc, P)
    t = torch.movedim(t, axis, 0)
    return torch.movedim(expand_axis0(t, nc, P), 0, axis)


def _fold(s, axis, nc, P):
    if axis == 0:
        return fold_axis0(s, nc, P)
    s = torch.movedim(s, axis, 0)
    return torch.movedim(fold_axis0(s, nc, P), 0, axis)


def lattice_laplacian_apply(x, mats, G, bc_marker, precision="highest",
                            apply_bc=True):
    """``y = A x`` on a flat ``(NX*NY*NZ,)`` or lattice-shaped dof vector
    (shape-preserving).

    ``mats`` holds the per-axis ``Ex, Dx, Ey, Dy, Ez, Dz`` (``(Q_a,
    N_a)``), ``G`` the ``(Qx, Qy, Qz, 6)`` weighted geometry factors with
    the coefficient folded in, ``bc_marker`` a bool marker shaped like
    ``x``. Dirichlet dofs are zeroed on input; their rows return ``x``
    unless ``apply_bc=False`` (the raw accumulation). ``precision`` is the
    JAX package's fifth parameter ('highest' only).
    """
    _check_precision(precision)
    Ex, Dx = mats["Ex"], mats["Dx"]
    Ey, Dy = mats["Ey"], mats["Dy"]
    Ez, Dz = mats["Ez"], mats["Dz"]
    NX, NY, NZ = Ex.shape[1], Ey.shape[1], Ez.shape[1]

    xb = torch.where(bc_marker, torch.zeros_like(x), x).reshape(NX, NY, NZ)

    # Forward: values of grad(u) on the quadrature lattice.
    t_z = along_z(Ez, xb)                        # (NX, NY, Qz)
    s_zy = along_y(Ey, t_z)                      # (NX, Qy, Qz)
    ux = along_x(Dx, s_zy)
    uy = along_x(Ex, along_y(Dy, t_z))
    uz = along_x(Ex, along_y(Ey, along_z(Dz, xb)))

    tx = G[..., 0] * ux + G[..., 1] * uy + G[..., 2] * uz
    ty = G[..., 1] * ux + G[..., 3] * uy + G[..., 4] * uz
    tz = G[..., 2] * ux + G[..., 4] * uy + G[..., 5] * uz

    # Backward: transposed contractions; E^T sums interface contributions.
    bx = along_x(Dx.T, tx)                       # (NX, Qy, Qz)
    by = along_x(Ex.T, ty)
    bz = along_x(Ex.T, tz)
    cxy = along_y(Ey.T, bx) + along_y(Dy.T, by)  # (NX, NY, Qz)
    cz = along_y(Ey.T, bz)
    y = along_z(Ez.T, cxy) + along_z(Dz.T, cz)   # (NX, NY, NZ)

    y = y.reshape(x.shape)
    if not apply_bc:
        return y
    return torch.where(bc_marker, x, y)


def geometry_to_qlattice(G_cells, nc, P):
    """Reorder per-cell G ``(ncells, (P+1)^3, 6)`` to the quadrature
    lattice layout ``(Qx, Qy, Qz, 6)`` (numpy)."""
    n = P + 1
    nx, ny, nz = nc
    G = np.asarray(G_cells).reshape(nx, ny, nz, n, n, n, 6)
    G = np.transpose(G, (0, 3, 1, 4, 2, 5, 6))
    return np.ascontiguousarray(G.reshape(nx * n, ny * n, nz * n, 6))


def lattice_mats(nc, P, dtype, device):
    """The six per-axis ``E``/``Dg`` matrices of `axis_matrices` as
    tensors: ``Ex, Dx, Ey, Dy, Ez, Dz``."""
    mats = {}
    for name, nc_a in zip("xyz", nc):
        E, Dg = axis_matrices(nc_a, P)
        mats["E" + name] = torch.as_tensor(E, dtype=dtype, device=device)
        mats["D" + name] = torch.as_tensor(Dg, dtype=dtype, device=device)
    return mats


class LatticeLaplacian:
    """General-hex operator in lattice form (plain torch), on ``device``.

    Same contract as `ops.laplacian.MatFreeLaplacian` (``op(x)``,
    ``diag``, ``diag_inv``); the diagonal comes from the exact dofmap
    formulation. ``kappa`` is any form `fem.assembly.resolve_kappa`
    takes (a tensor folds into G).
    """

    def __init__(self, mesh, P, kappa=2.0, dtype=torch.float32,
                 precision="highest", *, device):
        from ..fem.assembly import (
            geometry_factors_np,
            resolve_kappa_split,
            scale_G,
        )
        from .laplacian import laplacian_diagonal

        _check_precision(precision)
        self.P = int(P)
        self.mesh = mesh
        self.dtype = dtype
        self.device = torch.device(device)
        self.ndofs = mesh.num_dofs(P)
        self.mats = lattice_mats(mesh.nc, self.P, dtype, self.device)
        kc, kt, _ = resolve_kappa_split(mesh, kappa)
        G_cells, _ = geometry_factors_np(mesh, self.P, kappa=kt)
        self.G = torch.tensor(
            geometry_to_qlattice(scale_G(G_cells, kc, kt), mesh.nc, self.P),
            dtype=dtype, device=self.device)
        self.bc_marker = torch.tensor(mesh.boundary_dof_marker(self.P),
                                      device=self.device)
        t = lambda a: torch.tensor(a, dtype=dtype, device=self.device)
        self.diag = laplacian_diagonal(
            torch.tensor(mesh.dofmap(self.P), dtype=torch.int64,
                         device=self.device),
            t(G_cells), t(kc), t(derivative_matrix(self.P)), self.bc_marker,
            self.ndofs)
        self.diag_inv = 1.0 / self.diag

    def __call__(self, x):
        return lattice_laplacian_apply(x, self.mats, self.G, self.bc_marker)
