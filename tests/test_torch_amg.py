"""The port's smoothed-aggregation AMG coarse solve (`solvers/amg.py`,
``coarse='amg'``) against the JAX package.

- `aggregate` gives JAX's aggregates exactly (the greedy host passes are
  copied), with the invariants of JAX's test (free dofs covered,
  Dirichlet dofs excluded, unit tentative columns);
- `build_amg` data equals JAX's to 1e-12 (level 0, the inner sparse
  levels with their smoothed prolongators, the dense bottom factor);
- the matrix-free smoothed prolongator at level 0 equals the assembled
  ``(I - omega D^-1 A) T0``;
- FCG(V) counts with the AMG coarse equal JAX's and stay flat under
  refinement; sigma; the box ``kron`` backend through the flat seam;
- `utils.convert` carries a JAX ``dss`` + ``amg`` hierarchy into the
  port: one V-cycle on the JAX state equals JAX's to 1e-12.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp

os.environ.setdefault("JAX_PLATFORMS", "cpu")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from pmg_dolfinx_tpu.fem.mesh import BoxMesh as JBox  # noqa: E402
from pmg_dolfinx_tpu.fem.unstructured import (  # noqa: E402
    l_shaped_hex_mesh as jlshape,
)
from pmg_dolfinx_tpu.solvers import amg as jamg  # noqa: E402
from pmg_dolfinx_tpu.solvers.pmg import PMGHierarchy as JH  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.assembly import (  # noqa: E402
    assemble_rhs,
    assemble_stiffness,
)
from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.unstructured import (  # noqa: E402
    l_shaped_hex_mesh,
)
from pmg_dolfinx_tpu_torch.models.poisson import f_rhs  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers import amg as tamg  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy  # noqa: E402


def _dense(M):
    if isinstance(M, torch.Tensor):
        return M.to_dense().numpy() if M.layout != torch.strided else M.numpy()
    if hasattr(M, "todense") and not isinstance(M, np.ndarray):
        return np.asarray(M.todense())
    return np.asarray(M)


def _close(a, b, tol=1e-12):
    a, b = _dense(a).astype(np.float64), _dense(b).astype(np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max())


@pytest.mark.parametrize("theta", [0.0, 0.1])
def test_aggregate_equals_jax_and_invariants(theta):
    mesh = l_shaped_hex_mesh(3)
    A = assemble_stiffness(mesh, 1, kappa=2.0)
    bc = np.asarray(mesh.boundary_dof_marker(1))
    agg, na = tamg.aggregate(A, exclude=bc, theta=theta)
    agg_j, na_j = jamg.aggregate(A, exclude=bc, theta=theta)
    assert na == na_j and np.array_equal(agg, agg_j)
    assert (agg[bc] == -1).all() and (agg[~bc] >= 0).all()
    assert set(agg[~bc]) == set(range(na))
    T0 = tamg._tentative(agg, na)
    np.testing.assert_allclose((T0.T @ T0).diagonal(), 1.0, rtol=1e-14)
    assert tamg._lmax_jacobi(A.tocsr()) == jamg._lmax_jacobi(A.tocsr())


def test_build_amg_matches_jax():
    """A small ``dense_cap`` forces an inner sparse level (2,800 p=3
    dofs, 71 aggregates, a 1 x 1 dense bottom)."""
    mesh = l_shaped_hex_mesh(3)
    A = assemble_stiffness(mesh, 3, kappa=2.0).tocsr()
    bc = np.asarray(mesh.boundary_dof_marker(3))
    kw = dict(dense_cap=10, smoother_iters=2, psmooth=2, nu=1)
    dt, mt = tamg.build_amg(A, bc, torch.float64, device="cpu", **kw)
    dj, mj = jamg.build_amg(A, bc, jnp.float64, **kw)
    assert mt == mj
    assert len(dt["inner"]) == len(dj["inner"]) >= 1
    assert np.array_equal(dt["agg0"].numpy(), np.asarray(dj["agg0"]))
    for k in ("scale0", "dinv0", "omega0", "chol"):
        _close(dt[k], dj[k])
    for lt, lj in zip(dt["inner"], dj["inner"]):
        for k in ("A", "P", "PT", "dinv", "lmax"):
            _close(lt[k], lj[k])


def test_matrix_free_smoothed_P_matches_scipy():
    from pmg_dolfinx_tpu_torch.ops.csr import MatrixOperator

    mesh = l_shaped_hex_mesh(2)
    P0 = 2
    A = assemble_stiffness(mesh, P0, kappa=2.0).tocsr()
    bc = np.asarray(mesh.boundary_dof_marker(P0))
    data, meta = tamg.build_amg(A, bc, torch.float64, psmooth=1,
                                device="cpu")
    na = meta[0]
    agg = data["agg0"].numpy()
    T0 = tamg._tentative(np.where(agg == na, -1, agg), na)
    omega = float(data["omega0"])
    Psm = T0 - omega * (sp.diags(1.0 / A.diagonal()) @ (A @ T0))
    op = MatrixOperator(mesh, P0, kappa=2.0, device="cpu")
    rng = np.random.default_rng(0)
    e = torch.tensor(rng.standard_normal(na))
    v0 = data["scale0"] * torch.cat([e, e.new_zeros(1)])[data["agg0"]]
    v = v0 - data["omega0"] * data["dinv0"] * op(v0)
    np.testing.assert_allclose(v.numpy(), Psm @ e.numpy(), rtol=1e-12,
                               atol=1e-14)
    r = rng.standard_normal(A.shape[0])
    r[bc] = 0.0
    r = torch.tensor(r)
    w = r - data["omega0"] * op(data["dinv0"] * r)
    rc = torch.zeros(na + 1, dtype=w.dtype).index_add_(
        0, data["agg0"], data["scale0"] * w)[:-1]
    np.testing.assert_allclose(rc.numpy(), Psm.T @ r.numpy(), rtol=1e-12,
                               atol=1e-14)


def _fcg(mesh, degrees, coarse, cfg=None, operator="dss", sigma=0.0,
         jmesh=None):
    P = max(degrees)
    b = assemble_rhs(mesh, P, f_rhs(2.0, sigma=sigma))
    kw = dict(degrees=degrees, kappa=2.0, coarse=coarse, operator=operator,
              sigma=sigma)
    _, it = PMGHierarchy(mesh, coarse_cfg=dict(cfg or {}), device="cpu",
                         **kw).solve_pcg(torch.tensor(b), rtol=1e-8,
                                         maxiter=80)
    if jmesh is None:
        return int(it)
    _, itj = JH(jmesh, coarse_cfg=dict(cfg or {}), **kw).solve_pcg(
        jnp.asarray(b), rtol=1e-8, maxiter=80)
    return int(it), int(itj)


def test_fcg_counts_equal_jax_and_flat_under_refinement():
    """With ``dense_cap=60`` (a genuinely multilevel hierarchy): the FCG
    count equals JAX's at n=3, and stays flat at n=6 against the exact
    dense coarse (JAX measured 6 at n=6 and n=9 against 5)."""
    cfg = dict(dense_cap=60)
    it, itj = _fcg(l_shaped_hex_mesh(3), (1, 3), "amg", cfg,
                   jmesh=jlshape(3))
    assert it == itj
    m6 = l_shaped_hex_mesh(6)
    it6 = _fcg(m6, (1, 3), "amg", cfg)
    assert it6 <= it + 1
    assert it6 <= _fcg(m6, (1, 3), "direct") + 2


def test_amg_with_sigma_matches_direct_counts():
    mesh = l_shaped_hex_mesh(3)
    its = {c: _fcg(mesh, (1, 3), c, sigma=1.5) for c in ("amg", "direct")}
    assert its["amg"] <= its["direct"] + 2


def test_amg_on_box_kron_backend_matches_jax():
    """Lattice-shaped carriers reshape at the AMG seam: the ``kron`` +
    ``amg`` trajectory equals JAX's (f64, 1e-10 of the first residual)."""
    b = assemble_rhs(BoxMesh((4, 4, 4)), 3, f_rhs(2.0))
    kw = dict(degrees=(1, 3), kappa=2.0, coarse="amg", operator="kron")
    _, rt = PMGHierarchy(BoxMesh((4, 4, 4)), device="cpu", **kw).solve(
        torch.tensor(b), num_cycles=8)
    _, rj = JH(JBox((4, 4, 4)), **kw).solve(jnp.asarray(b), num_cycles=8)
    rt, rj = np.array(rt), np.asarray(rj)
    assert np.abs(rt - rj).max() <= 1e-10 * rj[0]
    assert rt[-1] / rt[0] < 2e-4


def test_convert_carries_dss_amg_hierarchy():
    """`hierarchy_data_from_numpy` on a JAX ``dss`` + ``amg`` hierarchy
    (an inner sparse level: ``dense_cap=2``; Schwarz-DSS blocks): after
    `load_state` the port's V-cycle equals JAX's to 1e-12, and the
    JAX-only row-gather tables are left out."""
    from pmg_dolfinx_tpu_torch.utils.convert import hierarchy_data_from_numpy

    kw = dict(degrees=(1, 2), kappa=2.0, coarse="amg", operator="dss",
              smoother="schwarz", coarse_cfg=dict(dense_cap=2))
    jh = JH(jlshape(3), **kw)
    th = PMGHierarchy(l_shaped_hex_mesh(3), device="cpu", **kw)
    state = hierarchy_data_from_numpy(jax.tree.map(np.asarray, jh.data),
                                      "cpu", torch.float64)
    assert "pmat" not in state["levels"][-1] and "amg" in state
    assert state["amg"]["inner"][0]["A"].layout == torch.sparse_csr
    th.load_state(state)
    for lt, lj in zip(th.data["levels"], jh.data["levels"]):
        assert float(lt["lmax"]) == float(lj["lmax"])
    n = th.levels[-1].ndofs
    rng = np.random.default_rng(1)
    b, u = rng.standard_normal(n), rng.standard_normal(n)
    got = th.apply(torch.tensor(b), torch.tensor(u)).numpy()
    want = np.asarray(jh.apply(jnp.asarray(b), jnp.asarray(u)))
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
