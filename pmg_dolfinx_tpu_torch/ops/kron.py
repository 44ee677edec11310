"""Kronecker-sum Laplacian on axis-aligned box meshes (plain torch).

Port of `pmg_dolfinx_tpu.ops.kron`. On an axis-aligned box the GLL
stiffness operator is the Kronecker sum

    A = kappa * ( K_x (x) M_y (x) M_z + M_x (x) K_y (x) M_z
                + M_x (x) M_y (x) K_z )

with banded 1D stiffness ``K[(N, N)]`` and diagonal lumped mass
``m[(N,)]``. `kron_laplacian_apply` evaluates it as three `torch.einsum`
contractions, as the JAX package leaves it to XLA; this is the
``operator="kron"`` backend and the in-solver reference for the CUDA
kernels of `ops/kron_blocked.py`.
"""

import numpy as np
import torch

from ..fem.gll import gauss_lobatto
from .lattice import axis_matrices


def axis_stiffness_mass(nc: int, P: int, h,
                        robin=(0.0, 0.0)) -> tuple[np.ndarray, np.ndarray]:
    """1D GLL stiffness ``K[(N, N)]`` and lumped mass ``m[(N,)]`` on an
    ``nc``-cell 1D mesh with per-cell spacings ``h`` (scalar or (nc,)).

    K = Dg^T diag(w_q / h_c) Dg ;  m = E^T (w_q * h_c).
    ``robin=(alpha_lo, alpha_hi)`` adds ``alpha * e_end e_end^T`` to K.
    """
    h = np.broadcast_to(np.asarray(h, dtype=np.float64), (nc,))
    E, Dg = axis_matrices(nc, P)
    _, w1 = gauss_lobatto(P + 1)
    w = np.tile(w1, nc)
    hq = np.repeat(h, P + 1)
    K = Dg.T @ ((w / hq)[:, None] * Dg)
    m = E.T @ (w * hq)
    if robin[0]:
        K[0, 0] += float(robin[0])
    if robin[1]:
        K[-1, -1] += float(robin[1])
    return K, m


def robin_axis_ends(mesh, axis: int, scale: float = 1.0):
    """Per-axis Robin end coefficients ``(alpha_lo, alpha_hi) * scale``;
    ``(0, 0)`` for a mesh without Robin faces."""
    ra = getattr(mesh, "robin_alpha", None)
    if ra is None:
        return (0.0, 0.0)
    return (float(ra[axis, 0]) * scale, float(ra[axis, 1]) * scale)


def kron_laplacian_apply(x, Ks, ms, bc_marker, apply_bc=True, sigma=0.0):
    """``y = A x`` via the Kronecker-sum form (shape-preserving).

    ``x`` is flat ``(NX*NY*NZ,)`` or lattice-shaped ``(NX, NY, NZ)``;
    ``Ks`` the per-axis stiffness with kappa folded in, ``ms`` the
    per-axis lumped masses, ``bc_marker`` a bool marker shaped like
    ``x``. Uses the symmetrized scaling ``A = S (Kt_x ⊕ Kt_y ⊕ Kt_z) S``
    with ``s_a = sqrt(m_a)``, ``Kt_a = K_a / (s_a s_a^T)``; ``sigma``
    adds the lumped-mass shift ``sigma M``.
    """
    Kx, Ky, Kz = Ks
    mx, my, mz = ms
    NX, NY, NZ = Kx.shape[1], Ky.shape[1], Kz.shape[1]
    sx, sy, sz = torch.sqrt(mx), torch.sqrt(my), torch.sqrt(mz)
    Ktx = Kx / sx[:, None] / sx[None, :]
    Kty = Ky / sy[:, None] / sy[None, :]
    Ktz = Kz / sz[:, None] / sz[None, :]
    s3 = sx[:, None, None] * sy[None, :, None] * sz[None, None, :]
    w = (torch.where(bc_marker, torch.zeros_like(x), x).reshape(NX, NY, NZ)) * s3

    t1 = torch.einsum("ax,xyz->ayz", Ktx, w)
    t2 = torch.einsum("by,xyz->xbz", Kty, w)
    t3 = torch.einsum("cz,xyz->xyc", Ktz, w)
    t = t1 + t2 + t3
    if sigma:
        # sigma * w * s3 == sigma * M * mask(x): w already carries one
        # sqrt-mass factor.
        t = t + sigma * w
    y = (t * s3).reshape(x.shape)
    if not apply_bc:
        return y
    return torch.where(bc_marker, x, y)


def kron_diagonal(Ks, ms, bc_marker, sigma=0.0):
    """Closed-form operator diagonal (flat, for Jacobi); bc rows get 1."""
    Kx, Ky, Kz = Ks
    mx, my, mz = ms
    dx, dy, dz = (torch.diagonal(K) for K in (Kx, Ky, Kz))
    m3 = mx[:, None, None] * my[None, :, None] * mz[None, None, :]
    diag = (
        dx[:, None, None] * my[None, :, None] * mz[None, None, :]
        + mx[:, None, None] * dy[None, :, None] * mz[None, None, :]
        + mx[:, None, None] * my[None, :, None] * dz[None, None, :]
        + sigma * m3
    ).reshape(-1)
    return torch.where(bc_marker.reshape(-1), torch.ones_like(diag), diag)


class KronLaplacian:
    """Operator bundle for axis-aligned `BoxMesh` on ``device``: ``op(x)``
    on flat or lattice-shaped vectors, ``diag``, ``diag_inv``. ``sigma``
    adds the lumped-mass shift; ``kappa`` is a scalar."""

    def __init__(self, mesh, P, kappa=2.0, dtype=torch.float32, sigma=0.0,
                 *, device):
        from ..fem.assembly import resolve_kappa_axes
        from ..fem.mesh import require_axis_aligned

        require_axis_aligned(mesh, "KronLaplacian")
        self.P = int(P)
        self.mesh = mesh
        self.dtype = dtype
        self.sigma = float(sigma)
        self.ndofs = mesh.num_dofs(P)
        self.shape = mesh.lattice_shape(P)
        self.kappa_axes = resolve_kappa_axes(mesh, kappa)
        Ks, ms = [], []
        for a, (nc_a, h_a, k_a) in enumerate(zip(mesh.nc, mesh.h_cells,
                                                 self.kappa_axes)):
            K, m = axis_stiffness_mass(
                nc_a, self.P, h_a, robin=robin_axis_ends(mesh, a, 1.0 / k_a))
            Ks.append(torch.tensor(k_a * K, dtype=dtype, device=device))
            ms.append(torch.tensor(m, dtype=dtype, device=device))
        self.Ks = tuple(Ks)
        self.ms = tuple(ms)
        self.bc_marker = torch.tensor(mesh.boundary_dof_marker(self.P),
                                      device=device)
        self.diag = kron_diagonal(self.Ks, self.ms, self.bc_marker,
                                  sigma=self.sigma)
        self.diag_inv = 1.0 / self.diag

    def __call__(self, x):
        return kron_laplacian_apply(x, self.Ks, self.ms,
                                    self.bc_marker.reshape(x.shape),
                                    sigma=self.sigma)
