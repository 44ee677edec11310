"""The port's DSS operator backend (`ops/unstructured.py`,
``operator='dss'``) and the DSS Schwarz smoother (`solvers/schwarz_dss.py`)
against the JAX package.

- layout: `dss_gather` and `dss_scatter` (the full sums and the
  owner-write) are BIT-exact with JAX's on a mesh with every cell's
  corner frame rotated (all dihedral face / edge orientations), at p =
  1-4 (P=1 all vertices, P=2 1x1 faces, P>=3 full blocks);
- operator: the apply equals JAX's to 1e-12 (f64) with a DG-0 kappa, and
  the port's ``dofmap`` oracle; the p-transfers equal JAX's to 1e-13;
- solver: the ``dss`` hierarchy's trajectory and FCG count equal JAX's
  (1e-10; DG-0 kappa with sigma, a tensor kappa) and the port's
  ``dofmap`` hierarchy's; FCG reaches the discretization error;
- Schwarz: `build_schwarz_dss` equals JAX's, the Schwarz-DSS
  hierarchy cycles as JAX's, matches the box Schwarz on a wrapped box
  and cuts the FCG count on a curved mesh with a variable kappa.
"""

import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from pmg_dolfinx_tpu.fem import unstructured as jfu  # noqa: E402
from pmg_dolfinx_tpu.ops import unstructured as jus  # noqa: E402
from pmg_dolfinx_tpu.solvers.pmg import PMGHierarchy as JH  # noqa: E402
from pmg_dolfinx_tpu_torch.fem import unstructured as tfu  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.assembly import (  # noqa: E402
    assemble_rhs,
    geometry_factors_np,
    l2_error_collocated,
)
from pmg_dolfinx_tpu_torch.fem.gll import (  # noqa: E402
    derivative_matrix,
    interpolation_matrix_1d,
)
from pmg_dolfinx_tpu_torch.models.poisson import f_rhs  # noqa: E402
from pmg_dolfinx_tpu_torch.ops import unstructured as tus  # noqa: E402
from pmg_dolfinx_tpu_torch.ops.interpolate import (  # noqa: E402
    prolongate,
    restrict,
)
from pmg_dolfinx_tpu_torch.ops.laplacian import laplacian_apply  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy  # noqa: E402
from test_torch_unstructured import _rotated_cells  # noqa: E402


def _u_exact(x):
    return np.sin(np.pi * x[0]) * np.sin(np.pi * x[1]) * np.sin(np.pi * x[2])


def _meshes(n=2, seed=0):
    """(port, JAX) meshes of the L-shape with rotated corner frames."""
    base = jfu.l_shaped_hex_mesh(n)
    cells = _rotated_cells(np.asarray(base.geometry_dofmap), seed)
    return (tfu.UnstructuredHexMesh(base.geometry_x, cells),
            jfu.UnstructuredHexMesh(base.geometry_x, cells))


def _tables(mt, mj, P):
    lt, lj = mt.dss_layout(P), mj.dss_layout(P)
    return (tus.dss_device_tables(lt, device="cpu"), tus.dss_meta(lt),
            jus.dss_device_tables(lj), jus.dss_meta(lj))


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("P", [1, 2, 3, 4])
def test_gather_scatter_bit_exact(P):
    mt, mj = _meshes(2)
    t, meta, tj, metaj = _tables(mt, mj, P)
    assert tuple(meta) == tuple(metaj)
    nd, n = mt.num_dofs(P), P + 1
    rng = np.random.default_rng(P)
    x = rng.standard_normal(nd)
    u = tus.dss_gather(torch.tensor(x), t, meta)
    assert np.array_equal(u.numpy(), np.asarray(
        jus.dss_gather(jnp.asarray(x), tj, metaj)))
    dm = mt.dofmap(P)
    assert np.array_equal(u.numpy(), x[dm].reshape(mt.ncells, n, n, n))
    yc = rng.standard_normal((mt.ncells, n, n, n))
    for first in (False, True):
        got = tus.dss_scatter(torch.tensor(yc), t, meta, first=first)
        want = jus.dss_scatter(jnp.asarray(yc), tj, metaj, first=first)
        assert np.array_equal(got.numpy(), np.asarray(want)), first
    y_ref = np.zeros(nd)
    np.add.at(y_ref, dm.ravel(), u.numpy().ravel())
    y = tus.dss_scatter(u, t, meta).numpy()
    assert np.abs(y - y_ref).max() <= 1e-13 * np.abs(y_ref).max()
    assert np.array_equal(tus.dss_scatter(u, t, meta, first=True).numpy(), x)


@pytest.mark.parametrize("P", [1, 2, 3])
def test_apply_matches_jax_and_dofmap(P):
    mt, mj = _meshes(2, seed=3)
    t, meta, tj, metaj = _tables(mt, mj, P)
    rng = np.random.default_rng(P)
    coeff = rng.uniform(1.0, 3.0, mt.ncells)
    G = geometry_factors_np(mt, P)[0]
    bc = mt.boundary_dof_marker(P)
    lv = dict(t, G=torch.tensor(G), coeff=torch.tensor(coeff),
              D=torch.tensor(derivative_matrix(P)), bc_marker=torch.tensor(bc))
    lvj = dict(tj, G=jnp.asarray(G), coeff=jnp.asarray(coeff),
               D=jnp.asarray(derivative_matrix(P)), bc_marker=jnp.asarray(bc))
    x = rng.standard_normal(mt.num_dofs(P))
    y = tus.dss_laplacian_apply(torch.tensor(x), lv, meta)
    assert _rel(y, jus.dss_laplacian_apply(jnp.asarray(x), lvj, metaj)) \
        <= 1e-12
    y_dm = laplacian_apply(torch.tensor(x), torch.tensor(mt.dofmap(P)).long(),
                           lv["G"], lv["coeff"], lv["D"], lv["bc_marker"])
    assert _rel(y, y_dm) <= 1e-12
    m3 = rng.uniform(0.5, 1.0, mt.num_dofs(P))
    ys = tus.dss_laplacian_apply(torch.tensor(x), dict(lv, m3=torch.tensor(
        m3)), meta, sigma=0.7, apply_bc=False)
    ysj = jus.dss_laplacian_apply(jnp.asarray(x), dict(lvj, m3=jnp.asarray(
        m3)), metaj, sigma=0.7, apply_bc=False)
    assert _rel(ys, ysj) <= 1e-12


def test_transfers_match_jax_and_dofmap():
    mt, mj = _meshes(2, seed=5)
    Pc, Pf = 2, 4
    tc, mc, tcj, mcj = _tables(mt, mj, Pc)
    tf, mf, tfj, mfj = _tables(mt, mj, Pf)
    M1 = interpolation_matrix_1d(Pc, Pf)
    mult = mt.dof_multiplicity(Pf)
    rng = np.random.default_rng(0)
    xc = rng.standard_normal(mt.num_dofs(Pc))
    up = tus.dss_prolongate(torch.tensor(xc), torch.tensor(M1), tc, mc, tf, mf)
    assert _rel(up, jus.dss_prolongate(jnp.asarray(xc), jnp.asarray(M1), tcj,
                                       mcj, tfj, mfj)) <= 1e-13
    dmc, dmf = (torch.tensor(mt.dofmap(P)).long() for P in (Pc, Pf))
    assert _rel(up, prolongate(torch.tensor(xc), dmc, dmf, torch.tensor(M1),
                               mt.num_dofs(Pf))) <= 1e-13
    xf = rng.standard_normal(mt.num_dofs(Pf))
    ur = tus.dss_restrict(torch.tensor(xf), torch.tensor(M1), tf, mf, tc, mc,
                          torch.tensor(1.0 / mult))
    assert _rel(ur, jus.dss_restrict(jnp.asarray(xf), jnp.asarray(M1), tfj,
                                     mfj, tcj, mcj, jnp.asarray(1.0 / mult))
                ) <= 1e-13
    assert _rel(ur, restrict(torch.tensor(xf), dmc, dmf, torch.tensor(M1),
                             torch.tensor(mult), mt.num_dofs(Pc))) <= 1e-13


def _traj(h, b, cycles, lib):
    if lib == "jax":
        return np.asarray(h.solve(jnp.asarray(b), num_cycles=cycles)[1])
    return np.array(h.solve(torch.tensor(b), num_cycles=cycles)[1])


def test_hierarchy_trajectory_matches_jax_and_dofmap():
    """DG-0 kappa, sigma 0.7, p=(1,2,4), direct coarse: the ``dss``
    trajectory and FCG count equal JAX's ``dss`` hierarchy's (1e-10) and
    the port's ``dofmap`` one's (1e-11)."""
    mt, mj = tfu.l_shaped_hex_mesh(2), jfu.l_shaped_hex_mesh(2)
    kappa = np.linspace(1.0, 3.0, mt.ncells)
    b = assemble_rhs(mt, 4, f_rhs(1.0))
    kw = dict(degrees=(1, 2, 4), kappa=kappa, coarse="direct", sigma=0.7)
    th = PMGHierarchy(mt, operator="dss", device="cpu", **kw)
    jh = JH(mj, operator="dss", **kw)
    rt, rj = _traj(th, b, 8, "torch"), _traj(jh, b, 8, "jax")
    assert np.max(np.abs(rt - rj) / rj) <= 1e-10
    rd = _traj(PMGHierarchy(mt, operator="dofmap", device="cpu", **kw), b, 8,
               "torch")
    assert np.max(np.abs(rt - rd) / rd) <= 1e-11
    ut, nt = th.solve_pcg(torch.tensor(b), rtol=1e-10)
    uj, nj = jh.solve_pcg(jnp.asarray(b), rtol=1e-10)
    assert nt == nj
    assert _rel(ut, uj) <= 1e-10


def test_tensor_kappa_matches_jax():
    mt, mj = _meshes(2, seed=7)
    K = np.array([[2.0, 0.3, 0.1], [0.3, 1.5, 0.2], [0.1, 0.2, 1.0]])
    b = assemble_rhs(mt, 3, f_rhs(1.0))
    kw = dict(degrees=(1, 3), kappa=K, coarse="direct")
    ut, nt = PMGHierarchy(mt, operator="dss", device="cpu", **kw).solve_pcg(
        torch.tensor(b), rtol=1e-10)
    uj, nj = JH(mj, operator="dss", **kw).solve_pcg(jnp.asarray(b),
                                                    rtol=1e-10)
    assert nt == nj and nt < 25
    assert _rel(ut, uj) <= 1e-10
    ud, _ = PMGHierarchy(mt, operator="dofmap", device="cpu", **kw).solve_pcg(
        torch.tensor(b), rtol=1e-10)
    assert _rel(ut, ud) <= 1e-8


def test_manufactured_convergence_fcg():
    mesh = tfu.l_shaped_hex_mesh(3)
    P = 4
    b = assemble_rhs(mesh, P, f_rhs(2.0))
    hier = PMGHierarchy(mesh, degrees=(1, 2, P), kappa=2.0, coarse="direct",
                        operator="dss", device="cpu")
    u, it = hier.solve_pcg(torch.tensor(b), rtol=1e-10)
    assert it <= 14
    assert l2_error_collocated(mesh, P, u.numpy(), _u_exact) < 5e-6


def test_dss_requires_layout_mesh():
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh

    with pytest.raises(ValueError, match="dss"):
        PMGHierarchy(BoxMesh((2, 2, 2)), degrees=(1, 2), operator="dss",
                     device="cpu")


def test_build_schwarz_dss_and_cycles_match_jax():
    """`build_schwarz_dss` (sigma 1.2, a p=1 level) equals JAX's arrays;
    the ``dss`` Schwarz hierarchy's trajectory equals JAX's (1e-10) and
    converges."""
    from pmg_dolfinx_tpu.solvers.schwarz_dss import build_schwarz_dss as jb
    from pmg_dolfinx_tpu_torch.solvers.schwarz_dss import (
        build_schwarz_dss as tb,
    )

    mt, mj = _meshes(2, seed=11)
    for P in (1, 2):
        st = tb(mt, P, 2.0, torch.float64, sigma=1.2, device="cpu")
        sj = jb(mj, P, 2.0, jnp.float64, sigma=1.2)
        assert set(st) == set(sj)
        for k in sj:
            a, w = st[k].numpy().astype(np.float64), np.asarray(sj[k],
                                                               np.float64)
            assert np.abs(a - w).max() <= 1e-13 * np.abs(w).max(), (P, k)
    b = assemble_rhs(mt, 2, f_rhs(2.0, sigma=1.2))
    kw = dict(degrees=(1, 2), kappa=2.0, sigma=1.2, coarse="direct",
              operator="dss", smoother="schwarz")
    rt = _traj(PMGHierarchy(mt, device="cpu", **kw), b, 8, "torch")
    rj = _traj(JH(mj, **kw), b, 8, "jax")
    # the last cycles reach 4e-10 of the first residual, where two f64
    # cycles differ at roundoff: measured against the first residual
    assert np.max(np.abs(rt - rj)) <= 1e-10 * rj[0]
    assert rt[-1] / rt[0] < 1e-5


def test_schwarz_dss_matches_box_schwarz_on_wrapped_box():
    """On a uniform box wrapped as an unstructured mesh the per-cell DSS
    Schwarz blocks are the box Schwarz blocks: the residual trajectories
    agree to roundoff."""
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh

    box = BoxMesh((4, 4, 4))
    un = tfu.UnstructuredHexMesh(box.geometry_x, box.geometry_dofmap)
    res = {}
    for mesh, op in ((box, "lattice"), (un, "dss")):
        b = assemble_rhs(mesh, 3, f_rhs(2.0))
        h = PMGHierarchy(mesh, degrees=(1, 3), kappa=2.0, coarse="direct",
                         operator=op, smoother="schwarz", device="cpu")
        res[op] = _traj(h, b, 6, "torch")
    np.testing.assert_allclose(res["dss"], res["lattice"], rtol=1e-6)


def test_schwarz_dss_curved_varkappa_reduces_iterations():
    from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh

    pb = PerturbedBoxMesh((6, 6, 6))
    unc = tfu.UnstructuredHexMesh(pb.geometry_x, pb.geometry_dofmap)
    kap = lambda x: 1.0 + 0.8 * np.sin(3 * x[0]) * np.cos(2 * x[1])
    b = torch.tensor(assemble_rhs(unc, 4, f_rhs(1.0)))
    its = {}
    for sm in ("cheb", "schwarz"):
        h = PMGHierarchy(unc, degrees=(1, 2, 4), kappa=kap, coarse="direct",
                         operator="dss", smoother=sm, device="cpu")
        _, its[sm] = h.solve_pcg(b, rtol=1e-8, maxiter=60)
    assert its["schwarz"] < its["cheb"], its
