"""Smoothed-aggregation algebraic multigrid coarse solver.

Port of `pmg_dolfinx_tpu.solvers.amg` (the reference's BoomerAMG role,
src/amg.hpp:33-47): classical smoothed aggregation built at setup on the
host from the assembled coarsest-p matrix (scipy CSR, the golden
assembly; the host NumPy is the JAX package's, copied), applied on the
device. It is the topology-agnostic multilevel coarse solve, so it runs
on unstructured meshes where the geometric h-MG refuses.

- LEVEL 0 (the p-coarse problem) stays MATRIX-FREE: pre/post smoothing is
  the hierarchy's own smoother and the smoothed prolongator is applied as
  ``P = (I - omega D^-1 A)^psmooth T0`` with A the hierarchy's operator
  apply (on the flagship box: kernels #1-#3); the aggregate map is one
  index sum into ``n_agg + 1`` slots (JAX: `segment_sum`).
- DEEPER LEVELS are small: Galerkin products ``A_{l+1} = P^T A_l P`` as
  torch sparse CSR tensors until ``<= dense_cap`` dofs, where a dense
  Cholesky factor bottoms out (`torch.linalg.solve_triangular`).

Dirichlet rows of A are identity (assembly contract) and are EXCLUDED
from aggregation (zero rows of T0). Aggregation: greedy root-
neighbourhood MIS over the strength graph (``|a_ij| >= theta sqrt(a_ii
a_jj)``; theta=0 keeps the full stencil), the standard three passes.
Tentative prolongator: piecewise constant over aggregates with unit-norm
columns; Jacobi smoothing weight ``omega = (4/3) / lambda_max(D^-1 A)``
(host power iteration; no safety margin, as in the JAX package).
"""

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.csr import to_sparse_csr
from .chebyshev import chebyshev4_solve

DENSE_CAP = 3000        # switch to dense Cholesky at/below this size
MAX_LEVELS = 10
OMEGA_FACTOR = 4.0 / 3.0


def _strength_graph(A, theta):
    """Symmetric strength-of-connection filter on CSR ``A``."""
    if theta <= 0.0:
        return A
    d = np.sqrt(np.abs(A.diagonal()))
    C = A.tocoo()
    keep = np.abs(C.data) >= theta * d[C.row] * d[C.col]
    keep |= C.row == C.col
    return sp.coo_matrix(
        (C.data[keep], (C.row[keep], C.col[keep])), shape=A.shape
    ).tocsr()


def aggregate(A, exclude=None, theta=0.0):
    """Greedy aggregation over the strength graph (host).

    Returns ``(agg, n_agg)``: per-dof aggregate index, ``-1`` for
    excluded (Dirichlet) dofs. Standard three passes: (1) roots whose
    whole free neighborhood is unaggregated seed an aggregate from it,
    (2) leftovers join a neighboring aggregate, (3) isolated remainders
    seed from whatever free neighbors remain.
    """
    S = _strength_graph(A.tocsr(), theta)
    n = S.shape[0]
    indptr, indices = S.indptr, S.indices
    free = np.ones(n, dtype=bool) if exclude is None else ~np.asarray(
        exclude, dtype=bool)
    agg = np.full(n, -1, dtype=np.int64)
    na = 0
    for i in range(n):
        if not free[i] or agg[i] >= 0:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        nbrs = nbrs[free[nbrs]]
        if (agg[nbrs] < 0).all():
            agg[nbrs] = na
            agg[i] = na
            na += 1
    for i in range(n):
        if not free[i] or agg[i] >= 0:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        cand = agg[nbrs[free[nbrs]]]
        cand = cand[cand >= 0]
        if len(cand):
            agg[i] = cand[0]
    for i in range(n):
        if not free[i] or agg[i] >= 0:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        sel = free[nbrs] & (agg[nbrs] < 0)
        agg[i] = na
        agg[nbrs[sel]] = na
        na += 1
    return agg, na


def _tentative(agg, na):
    """Unit-column piecewise-constant prolongator T0 (scipy CSR)."""
    rows = np.where(agg >= 0)[0]
    cols = agg[rows]
    cnt = np.bincount(cols, minlength=na).astype(np.float64)
    vals = 1.0 / np.sqrt(cnt[cols])
    return sp.coo_matrix((vals, (rows, cols)),
                         shape=(len(agg), na)).tocsr()


def _lmax_jacobi(A, iters=30, seed=0):
    """Power-iteration estimate of ``lambda_max(D^-1 A)`` (host)."""
    dinv = 1.0 / A.diagonal()
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(A.shape[0])
    lam = 1.0
    for _ in range(iters):
        w = dinv * (A @ v)
        lam = np.linalg.norm(w)
        v = w / lam
    return float(lam)


def build_amg(A0, bc_mask, dtype, theta=0.0, dense_cap=DENSE_CAP,
              max_levels=MAX_LEVELS, smoother_iters=2, psmooth=2, nu=2, *,
              device):
    """Host setup from the assembled (bc-applied) coarsest-p matrix.

    Returns ``(data, meta)``: the device data and the static meta tuple
    ``(n_agg0, 2 * smoother_iters, psmooth, nu)``. ``data`` keys:

    - level 0 (matrix-free side): ``agg0`` int64 (bc dofs -> n_agg0, the
      dummy slot), ``scale0``, ``dinv0``, ``omega0``;
    - ``inner``: list of per-level dicts - ``A``, ``P``, ``PT`` (sparse
      CSR, smoothed), ``dinv``, ``lmax`` - for the intermediate levels;
    - ``chol``: dense Cholesky factor of the bottom level.
    """
    A0 = A0.tocsr()
    bc_mask = np.asarray(bc_mask, dtype=bool)
    agg, na = aggregate(A0, exclude=bc_mask, theta=theta)
    if na == 0:
        raise ValueError("aggregation produced no aggregates "
                         "(all dofs Dirichlet?)")
    T0 = _tentative(agg, na)
    lmax0 = _lmax_jacobi(A0)
    omega0 = OMEGA_FACTOR / lmax0
    Dinv0 = sp.diags(1.0 / A0.diagonal())
    # ``psmooth`` Jacobi smoothing steps on the tentative prolongator:
    # P = (I - omega D^-1 A)^psmooth T0.
    P = T0
    for _ in range(psmooth):
        P = P - omega0 * (Dinv0 @ (A0 @ P))
    A = (P.T @ A0 @ P).tocsr()

    vec = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                    device=device)
    agg_dev = np.where(agg >= 0, agg, na)
    scale = np.zeros(len(agg))
    rows = agg >= 0
    cnt = np.bincount(agg[rows], minlength=na).astype(np.float64)
    scale[rows] = 1.0 / np.sqrt(cnt[agg[rows]])
    data = dict(
        agg0=torch.as_tensor(agg_dev, dtype=torch.int64, device=device),
        scale0=vec(scale),
        dinv0=vec(1.0 / A0.diagonal()),
        omega0=vec(omega0),
    )

    inner = []
    for _ in range(max_levels):
        if A.shape[0] <= dense_cap:
            break
        aggl, nal = aggregate(A, theta=theta)
        T = _tentative(aggl, nal)
        om = OMEGA_FACTOR / _lmax_jacobi(A)
        Pl = T
        for _ in range(psmooth):
            Pl = Pl - om * (sp.diags(1.0 / A.diagonal()) @ (A @ Pl))
        inner.append(dict(
            A=to_sparse_csr(A, dtype, device),
            P=to_sparse_csr(Pl, dtype, device),
            PT=to_sparse_csr(Pl.T.tocsr(), dtype, device),
            dinv=vec(1.0 / A.diagonal()),
            lmax=vec(1.1 * _lmax_jacobi(A)),
        ))
        A = (Pl.T @ A @ Pl).tocsr()
    Ad = A.toarray()
    data["inner"] = inner
    data["chol"] = vec(np.linalg.cholesky(Ad))
    meta = (int(na), 2 * smoother_iters, int(psmooth), int(nu))
    return data, meta


def _inner_cycle(inner, l, b, chol, iters):
    """V(iters, iters) over the assembled sparse levels; dense Cholesky
    bottom."""
    if l == len(inner):
        y = torch.linalg.solve_triangular(chol, b.reshape(-1, 1), upper=False)
        return torch.linalg.solve_triangular(chol.T, y,
                                             upper=True).reshape(b.shape)
    lv = inner[l]
    A = lambda t: torch.mv(lv["A"], t)
    x = chebyshev4_solve(A, b, torch.zeros_like(b), lv["dinv"], lv["lmax"],
                         iters)
    r = b - A(x)
    e = _inner_cycle(inner, l + 1, torch.mv(lv["PT"], r), chol, iters)
    x = x + torch.mv(lv["P"], e)
    return chebyshev4_solve(A, b, x, lv["dinv"], lv["lmax"], iters)


def amg_cycle(amg, b, u, meta, lv0, level0, smooth, apply0):
    """One SA-AMG V-cycle on the (p-coarse) level-0 problem on flat
    vectors.

    ``smooth``/``apply0`` are the outer hierarchy's level-0 smoother hook
    and matrix-free apply: level 0 never touches an assembled matrix. The
    smoothed prolongator is applied matrix-free: ``P v = (I - omega D^-1
    A)^psmooth T0 v`` and ``P^T r = T0^T (I - omega A D^-1)^psmooth r``
    (A symmetric). ``nu`` repeats the level-0 smoother hook per pre/post
    stage."""
    na, iters, psmooth, nu = meta
    for _ in range(nu):
        u = smooth(lv0, b, u, level0)
    r = b - apply0(u)
    w = r
    for _ in range(psmooth):
        w = w - amg["omega0"] * apply0(amg["dinv0"] * w)
    rc = torch.zeros(na + 1, dtype=w.dtype, device=w.device).index_add_(
        0, amg["agg0"], amg["scale0"] * w)[:-1]
    e = _inner_cycle(amg["inner"], 0, rc, amg["chol"], iters)
    v = amg["scale0"] * torch.cat([e, e.new_zeros(1)])[amg["agg0"]]
    for _ in range(psmooth):
        v = v - amg["omega0"] * amg["dinv0"] * apply0(v)
    u = u + v
    for _ in range(nu):
        u = smooth(lv0, b, u, level0)
    return u
