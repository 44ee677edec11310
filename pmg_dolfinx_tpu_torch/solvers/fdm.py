"""Fast Diagonalization Method: a direct solver in six contractions.

Port of `pmg_dolfinx_tpu.solvers.fdm` (`_axis_eig`, `fdm_solve`,
`FastDiagonalizationSolver.solve`). For the constant-coefficient
operator on an axis-aligned box the Kronecker sum diagonalizes exactly:
with the per-axis generalized eigenproblem ``K v = lambda M v`` on the
free nodes (``V^T M V = I``),

    A^{-1} = (V (x) V (x) V)  diag(kappa (lx + ly + lz))^{-1}  (V^T)^{(x)3}

The eigenproblems are host numpy (float64); the solve is six
`torch.einsum` contractions and a pointwise division, as the JAX package
leaves it to XLA. `FastDiagonalizationSolver.refine` wraps the solve in
float64 iterative refinement.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.kron import axis_stiffness_mass


def _axis_eig(nc, P, h, ends=(True, True), robin=(0.0, 0.0)):
    """Free-node generalized eigenpairs of the 1D (K, M) pencil.

    ``ends`` are the per-end Dirichlet flags (flagged end nodes are
    trimmed). Returns ``V[(Ni, Ni)]`` with ``V^T M V = I`` and eigenvalues
    ``lam[(Ni,)]``; Ni = nc*P + 1 - sum(ends).
    """
    K, m = axis_stiffness_mass(nc, P, h, robin=robin)
    lo = 1 if ends[0] else 0
    hi = -1 if ends[1] else None
    Ki = K[lo:hi, lo:hi]
    mi = m[lo:hi]
    s = 1.0 / np.sqrt(mi)
    T = (s[:, None] * Ki) * s[None, :]
    lam, Q = np.linalg.eigh((T + T.T) / 2.0)
    V = s[:, None] * Q
    return V, lam


_ALL_DIRICHLET_TRIMS = ((1, 1), (1, 1), (1, 1))


def fdm_solve(b, Vs, Vts, dinv, bc_marker, shape, precision="highest",
              trims=_ALL_DIRICHLET_TRIMS):
    """Direct solve ``u = A^{-1} b`` (shape-preserving).

    ``Vs``/``Vts`` are the per-axis eigenvector matrices and transposes,
    ``dinv`` the reciprocal eigenvalue-sum lattice, ``shape`` the full
    lattice shape, ``trims`` the per-axis (lo, hi) Dirichlet-plane trim
    counts. Dirichlet rows return ``u[bc] = b[bc]``. ``precision`` is the
    JAX package's seventh parameter ('highest' only).
    """
    from ..ops.kron_blocked import _check_precision

    _check_precision(precision)
    b3 = b.reshape(shape)
    t = b3[tuple(slice(lo, n - hi) for n, (lo, hi) in zip(shape, trims))]
    Vx, Vy, Vz = Vs
    Vxt, Vyt, Vzt = Vts
    t = torch.einsum("ax,xyz->ayz", Vxt, t)
    t = torch.einsum("by,xyz->xbz", Vyt, t)
    t = torch.einsum("cz,xyz->xyc", Vzt, t)
    t = t * dinv
    t = torch.einsum("ax,xyz->ayz", Vx, t)
    t = torch.einsum("by,xyz->xbz", Vy, t)
    t = torch.einsum("cz,xyz->xyc", Vz, t)
    # F.pad takes (lo, hi) pairs from the last axis backwards.
    (xl, xh), (yl, yh), (zl, zh) = trims
    u = F.pad(t, (zl, zh, yl, yh, xl, xh)).reshape(b.shape)
    return torch.where(bc_marker.reshape(b.shape), b, u)


class FastDiagonalizationSolver:
    """Direct solver bundle for `BoxMesh` + a constant scalar, per-axis or
    diagonal-tensor kappa (each axis' eigenvalues scale by its ``k_a``),
    graded spacing, mixed Dirichlet/Neumann faces and Robin ends (pre-
    divided by ``k_a``); ``solve(b)`` is exact to working precision in one
    application."""

    def __init__(self, mesh, P, kappa=2.0, dtype=torch.float32,
                 precision="highest", sigma=0.0, *, device):
        """``sigma`` shifts the operator by the lumped mass (the shift
        adds to the eigenvalue sums); ``precision`` is the JAX package's
        fifth parameter ('highest' only)."""
        from ..fem.assembly import resolve_kappa_axes
        from ..fem.mesh import require_axis_aligned
        from ..ops.kron import robin_axis_ends
        from ..ops.kron_blocked import _check_precision

        _check_precision(precision)
        require_axis_aligned(mesh, "FastDiagonalizationSolver")
        P = int(P)
        self.mesh = mesh
        self.P = P
        self.dtype = dtype
        self.device = torch.device(device)
        self.shape = mesh.lattice_shape(P)
        faces = getattr(mesh, "dirichlet_faces", ((True, True),) * 3)
        self.trims = tuple((int(lo), int(hi)) for lo, hi in faces)
        kx, ky, kz = resolve_kappa_axes(mesh, kappa)
        Vs, Vts, lams = [], [], []
        for a, (nc_a, h_a, ends, k_a) in enumerate(
                zip(mesh.nc, mesh.h_cells, faces, (kx, ky, kz))):
            V, lam = _axis_eig(nc_a, P, h_a, ends=ends,
                               robin=robin_axis_ends(mesh, a, 1.0 / k_a))
            Vs.append(torch.as_tensor(V, dtype=dtype, device=device))
            Vts.append(torch.as_tensor(V.T.copy(), dtype=dtype,
                                       device=device))
            lams.append(lam)
        self.Vs, self.Vts = tuple(Vs), tuple(Vts)
        lx, ly, lz = lams
        d = (kx * lx[:, None, None] + ky * ly[None, :, None]
             + kz * lz[None, None, :]) + float(sigma)
        if d.size and float(d.min()) <= 1e-14 * max(1.0, float(d.max())):
            raise ValueError(
                "FDM: singular operator (no Dirichlet face and sigma=0 "
                "leaves the constant nullspace); add a Dirichlet face or "
                "a positive sigma shift"
            )
        self.dinv = torch.as_tensor(1.0 / d, dtype=dtype, device=device)
        self.bc_marker = torch.tensor(mesh.boundary_dof_marker(P),
                                      device=device)
        self._kappa = (kx, ky, kz)
        self._sigma = float(sigma)

    def solve(self, b):
        """``u = A^{-1} b``; ``b`` (any float dtype, any device, flat or
        lattice-shaped) is cast to the solver's dtype and device first,
        as in the JAX package."""
        b = torch.as_tensor(b).to(device=self.device, dtype=self.dtype)
        return fdm_solve(b, self.Vs, self.Vts, self.dinv, self.bc_marker,
                         self.shape, trims=self.trims)

    def solve_many(self, B):
        """`solve` over a leading right-hand-side axis (one column after
        another; the JAX package vmaps them)."""
        B = torch.as_tensor(B).to(device=self.device, dtype=self.dtype)
        return torch.stack([self.solve(b) for b in B])

    def refine(self, b, cycles=3):
        """float64 iterative refinement around the working-dtype solve:
        ``r64 = b - A64 u64 ; u64 += solve(r64)``, with the f64 Kronecker
        operator carrying the same sigma. Returns ``(u64, rnorms)``, the
        f64 residual norm before each correction."""
        from ..ops.kron import KronLaplacian

        if getattr(self, "_op64", None) is None:
            self._op64 = KronLaplacian(self.mesh, self.P,
                                       kappa=self._kappa,
                                       dtype=torch.float64,
                                       sigma=self._sigma, device=self.device)
        b64 = torch.as_tensor(b).to(device=self.device, dtype=torch.float64)
        u64 = torch.zeros_like(b64)
        rnorms = []
        for _ in range(cycles):
            r64 = b64 - self._op64(u64)
            rnorms.append(torch.linalg.vector_norm(r64))
            u64 = u64 + self.solve(r64).to(torch.float64).reshape(u64.shape)
        return u64, [float(r) for r in rnorms]
