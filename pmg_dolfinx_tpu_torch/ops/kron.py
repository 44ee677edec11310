"""Kronecker-sum Laplacian on axis-aligned box meshes (plain torch).

Port of `pmg_dolfinx_tpu.ops.kron` (the apply, the diagonal, the
operator class and the device-grid helpers `local_axis_K` /
`stacked_local_K`). On an axis-aligned box the GLL
stiffness operator is the Kronecker sum

    A = kappa * ( K_x (x) M_y (x) M_z + M_x (x) K_y (x) M_z
                + M_x (x) M_y (x) K_z )

with banded 1D stiffness ``K[(N, N)]`` and diagonal lumped mass
``m[(N,)]``. `kron_laplacian_apply` evaluates it as three `torch.einsum`
contractions, as the JAX package leaves it to XLA; this is the
``operator="kron"`` backend and the in-solver reference for the CUDA
kernels of `ops/kron_blocked.py`. The advection half (`axis_advection`,
`kron_advection_terms`, `kron_convdiff_apply`) adds ``c . grad`` the
same way, for the convection-diffusion family (`solvers/convdiff.py`).
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


def axis_advection(nc: int, P: int) -> np.ndarray:
    """1D GLL advection (weak first-derivative) matrix ``C[(N, N)]``,
    ``C_ij = integral phi_i phi_j' dx``, on an ``nc``-cell 1D mesh
    (float64). Scale-free: the 1/h of the derivative cancels the h of the
    volume element, so graded cells share one matrix; GLL quadrature
    integrates the product exactly, so ``C + C^T = e_N e_N^T - e_0
    e_0^T``. The 3D advection ``c . grad`` on an axis-aligned box is
    ``sum_a c_a M_b (x) C_a (x) M_c`` (`kron_advection_terms`)."""
    E, Dg = axis_matrices(nc, P)
    _, w1 = gauss_lobatto(P + 1)
    w = np.tile(w1, nc)
    return E.T @ (w[:, None] * Dg)


def _stacked_factor(m, w, a):
    """The axis-``a`` lumped mass ``m`` (the duplicated layout of a
    sharded axis) as a broadcast factor of the lattice ``w``: one lattice
    ``(NX, NY, NZ)``, the slab stack ``(S, npl, NY, NZ)`` (x sharded) or
    the grid stack ``(sx, sy, sz, nx, ny, nz)``."""
    lead = w.dim() - 3
    n = w.shape[lead + a]
    shape = [1] * w.dim()
    shape[lead + a] = n
    if lead == 3:
        shape[a] = w.shape[a]
    elif lead == 1 and a == 0:
        shape[0] = w.shape[0]
    return m.reshape(shape)


def kron_advection_terms(x_masked, Cs, ms, cvel, precision="highest",
                         exchanges=(None, None, None)):
    """``sum_a c_a (M_b (x) C_a (x) M_c) x`` on the lattice-shaped,
    bc-masked input: three `torch.einsum` contractions (TF32 off,
    `pmg_dolfinx_tpu_torch/__init__.py`), as the JAX package leaves them
    to XLA. ``cvel`` is the velocity 3-vector (a tensor or a sequence of
    floats). On a sharded layout (the slab stack ``(S, npl, NY, NZ)`` or
    the grid stack ``(sx, sy, sz, nx, ny, nz)``, with the LOCAL ``Cs`` and
    the duplicated-layout ``ms``) ``exchanges[a]`` reconciles the axis-a
    term's interface planes (`solvers.shardwrap.axis_exchanges`); the
    mass scalings are pointwise and already consistent."""
    from .kron_blocked import _check_precision

    _check_precision(precision)
    w = x_masked
    lead = "ijk"[:w.dim() - 3]
    eqs = (f"ax,{lead}xyz->{lead}ayz", f"by,{lead}xyz->{lead}xbz",
           f"cz,{lead}xyz->{lead}xyc")
    ts = []
    for a in range(3):
        t = torch.einsum(eqs[a], Cs[a], w)
        if exchanges[a] is not None:
            t = exchanges[a](t)
        ts.append(t)
    mx, my, mz = (_stacked_factor(m, w, a) for a, m in enumerate(ms))
    return (cvel[0] * ts[0] * (my * mz)
            + cvel[1] * ts[1] * (mx * mz)
            + cvel[2] * ts[2] * (mx * my))


def kron_convdiff_apply(x, Ks, Cs, ms, cvel, bc_marker,
                        precision="highest", sigma=0.0,
                        exchange=None, adv_exchanges=(None, None, None)):
    """Convection-diffusion operator ``y = (A + sigma M + B(c)) x`` on the
    Kronecker family: `kron_laplacian_apply` (unmasked epilogue) plus
    `kron_advection_terms`, one shared bc mask and epilogue (Dirichlet
    rows return ``x``). Nonsymmetric: solve with `solvers.bicgstab`."""
    lat = x.reshape(Ks[0].shape[1], Ks[1].shape[1], Ks[2].shape[1])
    bc3 = bc_marker.reshape(lat.shape)
    w = torch.where(bc3, torch.zeros_like(lat), lat)
    y = kron_laplacian_apply(w, Ks, ms, bc3, precision=precision,
                             apply_bc=False, exchange=exchange, sigma=sigma)
    y = y + kron_advection_terms(w, Cs, ms, cvel, precision=precision,
                                 exchanges=adv_exchanges)
    return torch.where(bc3, lat, y).reshape(x.shape)


def robin_axis_ends(mesh, axis: int, scale: float = 1.0):
    """Per-axis Robin end coefficients ``(alpha_lo, alpha_hi) * scale``;
    ``(0, 0)`` for a mesh without Robin faces."""
    ra = getattr(mesh, "robin_alpha", None)
    if ra is None:
        return (0.0, 0.0)
    return (float(ra[axis, 0]) * scale, float(ra[axis, 1]) * scale)


def stacked_local_K(Kl, k_a, robin_ends, n_shards):
    """Per-shard row-stacked kappa-folded LOCAL axis stiffness ``(S * npl,
    npl)`` (float64) for a sharded axis whose global ends carry Robin
    terms: the ``alpha`` updates land on the first shard's ``[0, 0]`` and
    the last shard's ``[-1, -1]``."""
    out = np.tile(k_a * np.asarray(Kl, np.float64), (int(n_shards), 1))
    out[0, 0] += float(robin_ends[0])
    out[-1, -1] += float(robin_ends[1])
    return out


def local_axis_K(mesh, a, nc_local, Pdeg, k_a, n_shards_a):
    """Kappa-folded LOCAL axis stiffness of one shard of a device grid,
    with the mesh's Robin ends: ``(K, stacked)``. ``stacked=False``: the
    shard-invariant ``(npl, npl)`` float64 matrix (a uniform axis without
    Robin ends, or an unsharded one with its spacing and Robin ends folded
    in); ``stacked=True``: the per-shard row-stacked ``(S * npl, npl)``
    form of a sharded axis whose local stiffness differs per shard: Robin
    ends at the global ends (`stacked_local_K`) and/or GRADED spacing (each
    block assembled from its shard's cells). The sharded Kronecker levels
    (`DistPMG`, `GridPMG`, their h-hierarchies) and the general family's
    f64 refinement applies build their axis factors here."""
    ends = robin_axis_ends(mesh, a)
    h_cells = np.broadcast_to(np.asarray(mesh.h_cells[a], np.float64),
                              (mesh.nc[a],))
    graded = not bool(np.allclose(h_cells, h_cells[0], rtol=1e-12))
    if n_shards_a == 1 or not graded:
        K, _ = axis_stiffness_mass(nc_local, Pdeg,
                                   h_cells if n_shards_a == 1
                                   else h_cells[0])
        if ends == (0.0, 0.0):
            return k_a * K, False
        if n_shards_a == 1:
            K = k_a * K
            K[0, 0] += ends[0]
            K[-1, -1] += ends[1]
            return K, False
        return stacked_local_K(K, k_a, ends, n_shards_a), True
    blocks = []
    for s in range(n_shards_a):
        Ks, _ = axis_stiffness_mass(
            nc_local, Pdeg, h_cells[s * nc_local:(s + 1) * nc_local])
        blocks.append(k_a * Ks)
    out = np.vstack(blocks)
    out[0, 0] += float(ends[0])
    out[-1, -1] += float(ends[1])
    return out, True


def kron_laplacian_apply(x, Ks, ms, bc_marker, precision="highest",
                         apply_bc=True, exchange=None, sigma=0.0):
    """``y = A x`` via the Kronecker-sum form (shape-preserving).

    ``x`` is flat ``(NX*NY*NZ,)`` or lattice-shaped ``(NX, NY, NZ)``;
    ``Ks`` the per-axis stiffness with kappa folded in, ``ms`` the
    per-axis lumped masses, ``bc_marker`` a bool marker shaped like
    ``x``. Uses the symmetrized scaling ``A = S (Kt_x ⊕ Kt_y ⊕ Kt_z) S``
    with ``s_a = sqrt(m_a)``, ``Kt_a = K_a / (s_a s_a^T)``; ``sigma``
    adds the lumped-mass shift ``sigma M``. ``exchange`` (optional) is
    applied to the K_x term's lattice before the terms are summed: the
    interface partial-sum reconciliation of an x-sharded layout, as in
    the JAX package. ``precision`` is the JAX package's (either value, in
    f32/f64: the XLA-path rule of `ops.kron_blocked`).
    The parameters keep the JAX package's order.
    """
    from .kron_blocked import _check_precision

    _check_precision(precision)
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
    if exchange is not None:
        t1 = exchange(t1)
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
    adds the lumped-mass shift; ``kappa`` is a scalar, a per-axis tuple or
    a constant diagonal tensor (`resolve_kappa_axes`), graded spacing and
    Robin ends ride the 1D factors; ``precision`` is the JAX package's
    fifth parameter (either value, as in `kron_laplacian_apply`)."""

    def __init__(self, mesh, P, kappa=2.0, dtype=torch.float32,
                 precision="highest", sigma=0.0, *, device):
        from ..fem.assembly import resolve_kappa_axes
        from ..fem.mesh import require_axis_aligned
        from .kron_blocked import _check_precision

        _check_precision(precision)
        require_axis_aligned(mesh, "KronLaplacian")
        self.P = int(P)
        self.precision = precision
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
