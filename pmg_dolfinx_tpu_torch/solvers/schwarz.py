"""Cell-wise fast-diagonalization (FDM) Schwarz smoother.

Port of `pmg_dolfinx_tpu.solvers.schwarz`: symmetric additive Schwarz over
per-cell blocks of the operator, each block inverted by separable fast
diagonalization (Lottes & Fischer's spectral-element smoother, in its
non-overlapping multiplicity-weighted form). Setup is host numpy
(float64): per-axis generalized eigenpairs of the 1D cell blocks, the
cell-expanded inverse eigenvalue grid ``ginv``, and the dense per-axis
forward transforms ``U_a`` with the multiplicity weight and the per-axis
Dirichlet mask folded in. The apply is six dense rectangular axis
contractions around ``ginv`` (``form="dense"``, the production form), or
the batched per-cell form through the zero-FLOP cell expansion / overlap
add of `ops.lattice` (``form="batched"``, the independent reference the
tests hold the dense form to). Both are `torch.einsum` calls, as the JAX
package leaves them to XLA.

For the Kronecker-form operator (axis-aligned boxes, scalar kappa, the
sigma lumped-mass shift) the separable block is the exact cell block of
the bc-applied assembled matrix; on curved hexes it is the separable
approximation on the nominal box geometry. The blocks are cell-local, so
on a device grid the only communication is the partial-sum exchange of
the interface planes after the overlap-add (``exchange=``).
"""

import numpy as np
import torch


def _axis_eigs(nca, P, h, left_bc=True, right_bc=True, robin=(0.0, 0.0)):
    """Per-cell-position generalized eigenpairs of the 1D cell blocks:
    ``V[(nca, n, n)]`` with ``V^T diag(m) V = I`` blockwise and
    ``lam[(nca, n)]``. Each cell's block is the global 1D stiffness
    restricted to the cell (neighbour contributions on shared end nodes
    included) against the lumped mass; Dirichlet end nodes get identity
    (eigenvalue 1). ``robin`` folds end-point updates (pre-divided by
    kappa) into the end cells' blocks."""
    from ..ops.kron import axis_stiffness_mass

    n = P + 1
    K1, M1 = axis_stiffness_mass(nca, P, h, robin=robin)
    K1, M1 = np.asarray(K1, np.float64), np.asarray(M1, np.float64)
    V = np.zeros((nca, n, n))
    lam = np.ones((nca, n))
    for c in range(nca):
        sl = slice(c * P, c * P + n)
        S, d = K1[sl, sl], M1[sl]
        bcn = ([0] if (left_bc and c == 0) else []) + (
            [n - 1] if (right_bc and c == nca - 1) else [])
        keep = np.setdiff1d(np.arange(n), bcn)
        L = np.sqrt(d[keep])
        w, W = np.linalg.eigh(S[np.ix_(keep, keep)] / L[:, None] / L[None, :])
        V[c][np.ix_(keep, keep)] = W / L[:, None]  # d-orthonormal columns
        for b in bcn:
            V[c, b, b] = 1.0
        lam[c, keep] = w
    return V, lam


def axis_multiplicity(nca, P):
    """1D dof multiplicity: 2 on interior cell interfaces, 1 elsewhere."""
    m = np.ones(nca * P + 1)
    if nca > 1:
        m[P:-1:P] += 1.0
    return m


def _axis_dense(V, P, left_bc=True, right_bc=True):
    """Dense per-axis forward transform ``U = blockdiag(V_c^T) @ E @ diag(w
    * (1 - bc))`` of shape ``(nca*n, N)`` (float64): the cell expansion,
    the multiplicity weight ``1/sqrt(mult)`` and the Dirichlet end mask
    folded into the per-cell eigenvector transposes, so ``M^-1 = U_x^T
    U_y^T U_z^T [ginv * (U_x U_y U_z r)]`` plus identity on bc."""
    nca, n = V.shape[0], P + 1
    N = nca * P + 1
    s = 1.0 / np.sqrt(axis_multiplicity(nca, P))
    if left_bc:
        s[0] = 0.0
    if right_bc:
        s[-1] = 0.0
    U = np.zeros((nca * n, N))
    for c in range(nca):
        U[c * n:(c + 1) * n, c * P:c * P + n] = (
            V[c].T * s[c * P:c * P + n][None, :])
    return U


def shard_dense_axis(U, P, starts, npl):
    """Per-shard diagonal blocks of a dense axis matrix, row-stacked:
    ``(S * ncl*n, npl)``. ``starts``/``npl`` are the duplicated-plane
    layout's per-shard node starts and local plane count
    (`GridPartition._axis_starts`); each block maps a shard's local nodes
    (duplicated interface planes included) to its local cells, an exact
    slice since cells never span shards."""
    U = np.asarray(U)
    n = U.shape[0] // ((U.shape[1] - 1) // P)
    ncl = (npl - 1) // P
    return np.concatenate(
        [U[(s0 // P) * n:(s0 // P + ncl) * n, s0:s0 + npl]
         for s0 in starts], axis=0)


def build_schwarz_np(mesh, P, kappa, sigma=0.0):
    """Host (numpy, float64) Schwarz data for `schwarz_precond_apply`.

    Keys: the per-axis eigenvector stacks ``Vx/Vy/Vz`` (cell-indexed), the
    dense transforms ``Ux/Uy/Uz``, the cell-expanded inverse eigenvalue
    grid ``ginv``, the multiplicity weight ``w`` and the bc marker ``bc``
    (both lattice-shaped). ``sigma`` adds the lumped-mass shift exactly
    (a pure eigenvalue offset). Raises ValueError when the mesh's
    Dirichlet marker is not the union of whole flagged faces (both forms
    assume that per-axis separable set)."""
    from ..fem.assembly import resolve_kappa_split

    kc, kt, _ = resolve_kappa_split(mesh, kappa)
    ncx, ncy, ncz = mesh.nc
    if kt is not None:
        # a tensor: its per-cell diagonal (the separable approximation)
        kd = np.diagonal(kt, axis1=1, axis2=2).reshape(ncx, ncy, ncz, 3)
    else:
        kd = np.broadcast_to(
            np.asarray(kc, np.float64).reshape(ncx, ncy, ncz)[..., None],
            (ncx, ncy, ncz, 3),
        )
    faces = getattr(mesh, "dirichlet_faces", ((True, True),) * 3)
    Vs, lams = [], []
    for a, (nca, ha) in enumerate(zip(mesh.nc, mesh.h_cells)):
        # Robin end updates pre-divided by the plane-mean kappa of the
        # face-adjacent cells (the per-cell ``kd * lam`` restores alpha).
        robin = (0.0, 0.0)
        if getattr(mesh, "has_robin", False):
            from ..ops.kron import robin_axis_ends

            ends = robin_axis_ends(mesh, a)
            if ends != (0.0, 0.0):
                k_lo = float(kd[..., a].take(0, axis=a).mean())
                k_hi = float(kd[..., a].take(-1, axis=a).mean())
                robin = (ends[0] / k_lo, ends[1] / k_hi)
        V, lam = _axis_eigs(nca, P, ha, left_bc=faces[a][0],
                            right_bc=faces[a][1], robin=robin)
        Vs.append(V)
        lams.append(lam)
    n = P + 1
    lsum = (
        kd[:, None, :, None, :, None, 0] * lams[0][:, :, None, None, None, None]
        + kd[:, None, :, None, :, None, 1] * lams[1][None, None, :, :, None, None]
        + kd[:, None, :, None, :, None, 2] * lams[2][None, None, None, None, :, :]
        + float(sigma)
    )
    mult = np.einsum(
        "a,b,c->abc",
        axis_multiplicity(ncx, P),
        axis_multiplicity(ncy, P),
        axis_multiplicity(ncz, P),
    )
    bc = np.asarray(mesh.boundary_dof_marker(P)).reshape(mult.shape) > 0.5
    sep = np.zeros(bc.shape, bool)
    for a in range(3):
        sl = [slice(None)] * 3
        for end, flagged in zip((0, -1), faces[a]):
            if flagged:
                sl[a] = end
                sep[tuple(sl)] = True
    if not np.array_equal(bc, sep):
        raise ValueError(
            "schwarz smoother assumes a per-axis separable (whole-face) "
            "Dirichlet marker; got a non-separable boundary_dof_marker"
        )
    return dict(
        Vx=Vs[0],
        Vy=Vs[1],
        Vz=Vs[2],
        Ux=_axis_dense(Vs[0], P, *faces[0]),
        Uy=_axis_dense(Vs[1], P, *faces[1]),
        Uz=_axis_dense(Vs[2], P, *faces[2]),
        ginv=1.0 / lsum.reshape(ncx * n, ncy * n, ncz * n),
        w=1.0 / np.sqrt(mult),
        bc=bc,
    )


# The device arrays of each apply form: production builders ship 'dense'
# only (the batched form's lattice-sized w is dead memory there).
_FORM_KEYS = {
    "dense": ("Ux", "Uy", "Uz", "ginv"),
    "batched": ("Vx", "Vy", "Vz", "ginv", "w"),
    "both": ("Vx", "Vy", "Vz", "Ux", "Uy", "Uz", "ginv", "w"),
}


def build_schwarz(mesh, P, kappa, dtype, sigma=0.0, form="dense", *,
                  device):
    """Tensors on ``device`` for `schwarz_precond_apply` (a dict):
    ``form="dense"`` ships the dense-form arrays, ``"batched"`` / ``"both"``
    the reference form's too; the bool ``bc`` always."""
    sw = build_schwarz_np(mesh, P, kappa, sigma=sigma)
    out = {k: torch.as_tensor(sw[k], dtype=dtype, device=device)
           for k in _FORM_KEYS[form]}
    out["bc"] = torch.as_tensor(sw["bc"], device=device)
    return out


def _dense_apply(sw, x):
    """The six axis contractions around ``ginv``; on a device grid's
    stacked ``(sx, sy, sz, nx, ny, nz)`` layout each ``U_a`` is per shard,
    ``(S_a, nca_l*n, npl_a)``."""
    Ux, Uy, Uz, g = sw["Ux"], sw["Uy"], sw["Uz"], sw["ginv"]
    if Ux.dim() == 2:
        t = torch.einsum("ax,xyz->ayz", Ux, x)
        t = torch.einsum("by,ayz->abz", Uy, t)
        t = torch.einsum("cz,abz->abc", Uz, t) * g
        t = torch.einsum("cz,abc->abz", Uz, t)
        t = torch.einsum("by,abz->ayz", Uy, t)
        return torch.einsum("ax,ayz->xyz", Ux, t)
    t = torch.einsum("iax,ijkxyz->ijkayz", Ux, x)
    t = torch.einsum("jby,ijkayz->ijkabz", Uy, t)
    t = torch.einsum("kcz,ijkabz->ijkabc", Uz, t) * g
    t = torch.einsum("kcz,ijkabc->ijkabz", Uz, t)
    t = torch.einsum("jby,ijkabz->ijkayz", Uy, t)
    return torch.einsum("iax,ijkayz->ijkxyz", Ux, t)


def schwarz_precond_apply(sw, r, shape, P, precision="highest",
                          exchange=None, form=None):
    """Apply the Schwarz preconditioner ``r -> M^-1 r`` (shape-preserving).

    ``M^-1 = W [sum_cells R_c^T B_c^-1 R_c] W`` with ``W`` the symmetric
    multiplicity weight and ``B_c^-1`` the separable FDM inverse, in the
    ``"dense"`` form (default when ``sw`` holds ``Ux``) or the
    ``"batched"`` reference form (cell expansion, batched per-cell
    ``V^T`` / ``V`` products, overlap-add). ``r`` is flat or lattice-shaped
    (or, dense form, a device grid's stacked layout, ``shape`` the local
    lattice); ``exchange`` reconciles the interface partials of a device
    grid after the overlap-add. ``precision`` is the JAX package's
    ('highest' only)."""
    from ..ops.kron_blocked import _check_precision
    from ..ops.lattice import _expand, _fold

    _check_precision(precision)
    n = P + 1
    NX, NY, NZ = shape
    ncx, ncy, ncz = (NX - 1) // P, (NY - 1) // P, (NZ - 1) // P
    lead = tuple(r.shape[:-3]) if r.dim() > 3 else ()
    x = r.reshape(lead + tuple(shape))
    if form is None:
        form = "dense" if "Ux" in sw else "batched"
    if form not in ("dense", "batched"):
        raise ValueError(f"form must be 'dense' or 'batched', got {form!r}")
    if form == "dense":
        y = _dense_apply(sw, x)
        if exchange is not None:
            y = exchange(y)
        return torch.where(sw["bc"], x, y).reshape(r.shape)
    xb = torch.where(sw["bc"], torch.zeros_like(x), x) * sw["w"]
    t = _expand(_expand(_expand(xb, 2, ncz, P), 1, ncy, P), 0, ncx, P)
    # V^T transforms (per-cell-position eigenbases, batched matmuls)
    t = torch.einsum("cab,caq->cbq", sw["Vx"], t.reshape(ncx, n, -1))
    t = t.reshape(ncx * n, ncy, n, ncz * n)
    t = torch.einsum("cab,xcaz->xcbz", sw["Vy"], t)
    t = t.reshape(ncx * n, ncy * n, ncz, n)
    t = torch.einsum("cab,xyca->xycb", sw["Vz"], t)
    t = t.reshape(ncx * n, ncy * n, ncz * n) * sw["ginv"]
    # V transforms back
    t = t.reshape(ncx * n, ncy * n, ncz, n)
    t = torch.einsum("cab,xycb->xyca", sw["Vz"], t)
    t = t.reshape(ncx * n, ncy, n, ncz * n)
    t = torch.einsum("cab,xcbz->xcaz", sw["Vy"], t)
    t = t.reshape(ncx, n, -1)
    t = torch.einsum("cab,cbq->caq", sw["Vx"], t)
    t = t.reshape(ncx * n, ncy * n, ncz * n)
    y = _fold(_fold(_fold(t, 0, ncx, P), 1, ncy, P), 2, ncz, P)
    if exchange is not None:
        y = exchange(y)
    y = y * sw["w"]
    return torch.where(sw["bc"], x, y).reshape(r.shape)
