"""Parity of the port's solvers with the JAX package, float64 on the CPU.

Same operator (the Kronecker-sum apply on a non-cubic box), same seeded
inputs; every result agrees to <= 1e-12 relative. The recording CG path
is held to the JAX fixed-length scan including its freeze after
convergence (zeros in ``alphas``/``betas``, the ``stored`` mask), which
the Lanczos estimate reads.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pmg_dolfinx_tpu.fem.mesh import BoxMesh as JBoxMesh  # noqa: E402
from pmg_dolfinx_tpu.ops.kron import KronLaplacian  # noqa: E402
from pmg_dolfinx_tpu.ops.kron import kron_laplacian_apply as j_apply  # noqa: E402
from pmg_dolfinx_tpu.solvers import cg as j_cg  # noqa: E402
from pmg_dolfinx_tpu.solvers import chebyshev as j_cheb  # noqa: E402
from pmg_dolfinx_tpu.solvers import fdm as j_fdm  # noqa: E402
from pmg_dolfinx_tpu.solvers import tridiag as j_tri  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh as TBoxMesh  # noqa: E402
from pmg_dolfinx_tpu_torch.ops.kron import kron_diagonal  # noqa: E402
from pmg_dolfinx_tpu_torch.ops.kron import kron_laplacian_apply as t_apply  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers import cg as t_cg  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers import chebyshev as t_cheb  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers import fdm as t_fdm  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers import tridiag as t_tri  # noqa: E402

NC = (3, 4, 5)
TOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return np.abs(a - b).max() / (scale if scale else 1.0)


def _ops(P, sigma=0.0):
    """The JAX and torch operators (lattice-shaped) on the same data."""
    jm = JBoxMesh(NC)
    op = KronLaplacian(jm, P, kappa=2.0, dtype=jnp.float64, sigma=sigma)
    shape = jm.lattice_shape(P)
    bc_j = op.bc_marker.reshape(shape)
    Ks = [torch.tensor(np.asarray(K)) for K in op.Ks]
    ms = [torch.tensor(np.asarray(m)) for m in op.ms]
    bc_t = torch.tensor(np.asarray(bc_j))
    A_j = lambda x: j_apply(x, op.Ks, op.ms, bc_j, sigma=sigma)
    A_t = lambda x: t_apply(x, Ks, ms, bc_t, sigma=sigma)
    dinv_t = (1.0 / kron_diagonal(Ks, ms, bc_t, sigma=sigma)).reshape(shape)
    dinv_j = jnp.asarray(op.diag_inv).reshape(shape)
    assert _rel(dinv_t.numpy(), dinv_j) <= TOL
    return shape, A_j, A_t, dinv_j, dinv_t


def _vec(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("sigma", [0.0, 0.5])
def test_kron_apply_matches(sigma):
    shape, A_j, A_t, _, _ = _ops(3, sigma)
    x = _vec(shape, 0)
    assert _rel(A_t(torch.from_numpy(x)).numpy(), A_j(jnp.asarray(x))) <= TOL


@pytest.mark.parametrize("P,maxiter", [(3, 20), (1, 40)])
def test_cg_record_and_lanczos_match(P, maxiter):
    """P=1 has 24 free unknowns, so CG converges inside 40 iterations and
    the freeze path (zeros after convergence) is compared too."""
    shape, A_j, A_t, dinv_j, dinv_t = _ops(P)
    b = np.ones(shape)
    kw = dict(rtol=1e-6, maxiter=maxiter, record=True)
    xj, ij = j_cg.cg_solve(A_j, jnp.asarray(b), jnp.zeros(shape), dinv_j, **kw)
    xt, it = t_cg.cg_solve(A_t, torch.from_numpy(b),
                           torch.zeros(shape, dtype=torch.float64), dinv_t,
                           **kw)
    for key in ("alphas", "betas", "residuals"):
        assert _rel(it[key].numpy(), ij[key]) <= TOL, key
    assert np.array_equal(it["stored"].numpy(), np.asarray(ij["stored"]))
    assert int(it["niter"]) == int(ij["niter"])
    assert _rel(xt.numpy(), xj) <= TOL
    if P == 1:
        assert int(it["niter"]) < maxiter
        assert not it["stored"].numpy()[-1] and it["alphas"].numpy()[-1] == 0
    ej = j_tri.lanczos_eigenvalue_estimates(ij["alphas"], ij["betas"],
                                            ij["stored"])
    et = t_tri.lanczos_eigenvalue_estimates(it["alphas"].numpy(),
                                            it["betas"].numpy(),
                                            it["stored"].numpy())
    assert _rel(et, ej) <= TOL
    assert np.array_equal(t_tri.tqli(ej, ej[:-1] * 0.1),
                          j_tri.tqli(ej, ej[:-1] * 0.1))


def test_cg_while_loop_matches():
    shape, A_j, A_t, dinv_j, dinv_t = _ops(3)
    b = _vec(shape, 1)
    xj, ij = j_cg.cg_solve(A_j, jnp.asarray(b), jnp.zeros(shape), dinv_j,
                           rtol=1e-8, maxiter=200)
    xt, it = t_cg.cg_solve(A_t, torch.from_numpy(b),
                           torch.zeros(shape, dtype=torch.float64), dinv_t,
                           rtol=1e-8, maxiter=200)
    assert it["niter"] == int(ij["niter"]) < 200
    assert _rel(xt.numpy(), xj) <= 1e-10


def test_chebyshev_and_fcg_match():
    shape, A_j, A_t, dinv_j, dinv_t = _ops(3)
    b, x0 = _vec(shape, 2), _vec(shape, 3)
    lmax = 2.3
    cj = j_cheb.chebyshev4_solve(A_j, jnp.asarray(b), jnp.asarray(x0),
                                 dinv_j, lmax, 3)
    ct = t_cheb.chebyshev4_solve(A_t, torch.from_numpy(b),
                                 torch.from_numpy(x0), dinv_t,
                                 torch.tensor(lmax, dtype=torch.float64), 3)
    assert _rel(ct.numpy(), cj) <= TOL
    # FCG preconditioned by a zero-guess Chebyshev sweep
    Mj = lambda r: j_cheb.chebyshev4_solve(A_j, r, jnp.zeros_like(r), dinv_j,
                                           lmax, 2)
    Mt = lambda r: t_cheb.chebyshev4_solve(A_t, r, torch.zeros_like(r),
                                           dinv_t, lmax, 2)
    xj, ij = j_cg.fcg_solve(A_j, jnp.asarray(b), jnp.zeros(shape), Mj,
                            rtol=1e-8, maxiter=100,
                            dot=lambda u, v: jnp.sum(u * v))
    xt, it = t_cg.fcg_solve(A_t, torch.from_numpy(b),
                            torch.zeros(shape, dtype=torch.float64), Mt,
                            rtol=1e-8, maxiter=100,
                            dot=lambda u, v: torch.sum(u * v))
    assert it["niter"] == int(ij["niter"]) < 100
    assert _rel(xt.numpy(), xj) <= 1e-10


@pytest.mark.parametrize("sigma", [0.0, 0.5])
def test_fdm_solve_matches(sigma):
    jm, tm = JBoxMesh(NC), TBoxMesh(NC)
    P = 2
    fj = j_fdm.FastDiagonalizationSolver(jm, P, kappa=2.0,
                                         dtype=jnp.float64, sigma=sigma)
    ft = t_fdm.FastDiagonalizationSolver(tm, P, kappa=2.0,
                                         dtype=torch.float64, sigma=sigma,
                                         device="cpu")
    b = _vec(jm.lattice_shape(P), 4)
    uj = fj.solve(jnp.asarray(b))
    ut = ft.solve(torch.from_numpy(b))
    assert ut.shape == tuple(b.shape)
    assert _rel(ut.numpy(), uj) <= TOL
    # flat in, flat out
    assert _rel(ft.solve(torch.from_numpy(b.reshape(-1))).numpy(),
                np.asarray(uj).reshape(-1)) <= TOL
