"""The port's cell-wise Schwarz smoother (`solvers/schwarz.py`) against the
JAX package.

- `build_schwarz_np` (box, mixed Dirichlet/Neumann faces with a sigma
  shift, curved mesh) equals JAX's to 1e-13 relative, key by key, and
  both refuse a non-separable Dirichlet marker; `_axis_eigs`,
  `axis_multiplicity`, `_axis_dense` and `shard_dense_axis` equal JAX's;
- `schwarz_precond_apply`, dense and batched forms, equal JAX's to 1e-12
  (f64) and each other;
- `PMGHierarchy(smoother="schwarz")` on ``kron``, ``lattice`` and
  ``dofmap`` (f64): eigenvalue estimates to 1e-12, the 4-cycle trajectory
  to 1e-10, the FCG(V) count equal;
- ``kron_blocked`` / ``lattice_blocked`` with Schwarz in f32 (the
  kernels' plain versions on the CPU) on JAX's state (Pallas in interpret
  mode there): trajectories within 1e-4 above 5e-3, FCG counts equal;
- `GridPMG(smoother="schwarz")` against JAX's (f64, (2, 2, 2)) and the
  single device, and in f32 with ``kron_blocked`` against one device.
"""

import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pmg_dolfinx_tpu.fem.mesh import BoxMesh as JBox  # noqa: E402
from pmg_dolfinx_tpu.fem.mesh import PerturbedBoxMesh as JPert  # noqa: E402
from pmg_dolfinx_tpu.solvers import schwarz as js  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh as TBox  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh as TPert  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers import schwarz as ts  # noqa: E402

MIXED = ((True, False), (True, True), (False, True))


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else (
        np.asarray(a))


def _rel_max(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b) / np.abs(b))


@pytest.mark.parametrize("kind,sigma", [("box", 0.0), ("mixed", 0.5),
                                        ("curved", 0.0)])
def test_build_schwarz_np_matches_jax(kind, sigma):
    nc, P = (3, 2, 4), 3
    if kind == "curved":
        tm, jm = TPert(nc), JPert(nc)
    else:
        faces = MIXED if kind == "mixed" else True
        tm, jm = (TBox(nc, dirichlet_faces=faces),
                  JBox(nc, dirichlet_faces=faces))
    sw_t = ts.build_schwarz_np(tm, P, 2.0, sigma=sigma)
    sw_j = js.build_schwarz_np(jm, P, 2.0, sigma=sigma)
    assert set(sw_t) == set(sw_j)
    for k, v in sw_j.items():
        assert sw_t[k].shape == v.shape, k
        if v.dtype == bool:
            assert np.array_equal(sw_t[k], v), k
        else:
            assert _rel_max(sw_t[k], v) <= 1e-13, k
    for nca, ends in ((4, (True, True)), (3, (True, False)),
                      (1, (False, True))):
        Vt, lt = ts._axis_eigs(nca, P, 1.0 / nca, *ends)
        Vj, lj = js._axis_eigs(nca, P, 1.0 / nca, *ends)
        assert _rel_max(Vt, Vj) <= 1e-13 and _rel_max(lt, lj) <= 1e-13
        assert np.array_equal(ts.axis_multiplicity(nca, P),
                              js.axis_multiplicity(nca, P))
        assert _rel_max(ts._axis_dense(Vt, P, *ends),
                        js._axis_dense(Vj, P, *ends)) <= 1e-13
    # x has 3 cells: three one-cell shards, or the whole axis as one
    for starts, npl in (([0, P, 2 * P], P + 1), ([0], 3 * P + 1)):
        assert np.array_equal(ts.shard_dense_axis(sw_t["Ux"], P, starts, npl),
                              js.shard_dense_axis(sw_j["Ux"], P, starts, npl))


def test_build_schwarz_refuses_non_separable_marker():
    def holed(cls):
        class Holed(cls):
            def boundary_dof_marker(self, P):
                m = np.array(super().boundary_dof_marker(P))
                m[self.num_dofs(P) // 2] = True
                return m
        return Holed((2, 2, 2))

    for mod, cls in ((ts, TBox), (js, JBox)):
        with pytest.raises(ValueError, match="non-separable"):
            mod.build_schwarz_np(holed(cls), 2, 2.0)


@pytest.mark.parametrize("flat", [True, False])
def test_schwarz_apply_forms_match_jax(flat):
    nc, P = (3, 2, 4), 3
    mesh = TBox(nc, dirichlet_faces=MIXED)
    shape = mesh.lattice_shape(P)
    sw_t = ts.build_schwarz(mesh, P, 2.0, torch.float64, sigma=0.5,
                            form="both", device="cpu")
    sw_j = js.build_schwarz(JBox(nc, dirichlet_faces=MIXED), P, 2.0,
                            jnp.float64, sigma=0.5, form="both")
    r = np.random.default_rng(3).standard_normal(mesh.num_dofs(P))
    if not flat:
        r = r.reshape(shape)
    out = {}
    for form in ("dense", "batched"):
        yt = ts.schwarz_precond_apply(sw_t, torch.from_numpy(r), shape, P,
                                      form=form)
        yj = js.schwarz_precond_apply(sw_j, jnp.asarray(r), shape, P,
                                      form=form)
        assert tuple(yt.shape) == r.shape
        assert _rel_max(yt, yj) <= 1e-12, form
        out[form] = yt
    assert _rel_max(out["dense"], out["batched"]) <= 1e-12
    dense_only = ts.build_schwarz(mesh, P, 2.0, torch.float64, sigma=0.5,
                                  device="cpu")
    assert set(dense_only) == {"Ux", "Uy", "Uz", "ginv", "bc"}
    with pytest.raises(ValueError, match="form must be"):
        ts.schwarz_precond_apply(sw_t, torch.from_numpy(r), shape, P,
                                 form="nope")


@pytest.mark.parametrize("operator,coarse,sigma", [
    ("kron", "fdm", 0.5),
    ("lattice", "direct", 0.0),
    ("dofmap", "cg", 0.0),
])
def test_pmg_schwarz_f64_matches_jax(operator, coarse, sigma):
    from pmg_dolfinx_tpu.models.poisson import PoissonProblem as JP
    from pmg_dolfinx_tpu_torch.models.poisson import PoissonProblem as TP

    nc = (3, 4, 5)
    kw = dict(degrees=(1, 3), kappa=2.0, coarse=coarse, operator=operator,
              sigma=sigma, smoother="schwarz")
    jp = JP(dtype=jnp.float64, mesh=JBox(nc), **kw)
    tp = TP(dtype=torch.float64, device="cpu", mesh=TBox(nc), **kw)
    for et, ej in zip(tp.hierarchy.eigs, jp.hierarchy.eigs):
        assert _rel(et, ej) <= 1e-12
    _, rj = jp.solve(num_cycles=4)
    _, rt = tp.solve(num_cycles=4)
    assert _rel(rt, rj) <= 1e-10
    _, nj = jp.hierarchy.solve_pcg(jp.b, rtol=1e-6)
    _, nt = tp.hierarchy.solve_pcg(tp.b, rtol=1e-6)
    assert nt == nj


@pytest.mark.parametrize("operator", ["kron_blocked", "lattice_blocked"])
def test_blocked_schwarz_f32_with_jax_state(operator):
    """The plain kernels' f32 cycles with the Schwarz smoother on JAX's
    state (its Pallas kernels in interpret mode): trajectories within 1e-4
    on cycles above 5e-3, FCG counts equal."""
    from pmg_dolfinx_tpu.models.poisson import PoissonProblem as JP
    from pmg_dolfinx_tpu_torch.models.poisson import PoissonProblem as TP
    from pmg_dolfinx_tpu_torch.utils.convert import hierarchy_data_from_numpy

    nc = (4, 4, 4)
    curved = operator == "lattice_blocked"
    kw = dict(degrees=(1, 3), kappa=2.0, operator=operator,
              coarse="cg" if curved else "fdm", smoother="schwarz")
    jp = JP(dtype=jnp.float32, mesh=JPert(nc) if curved else JBox(nc), **kw)
    tp = TP(dtype=torch.float32, device="cpu",
            mesh=TPert(nc) if curved else TBox(nc), **kw)
    tp.hierarchy.load_state(hierarchy_data_from_numpy(
        jax.tree.map(np.asarray, jp.hierarchy.data), "cpu", torch.float32))
    for lv_t, lv_j in zip(tp.hierarchy.data["levels"],
                          jp.hierarchy.data["levels"]):
        assert torch.equal(lv_t["schwarz"]["ginv"], torch.tensor(
            np.asarray(lv_j["schwarz"]["ginv"])))
    r0 = float(np.linalg.norm(np.asarray(jp.b)))
    _, rj = jp.solve(num_cycles=4)
    _, rt = tp.solve(num_cycles=4)
    rj, rt = np.array(rj) / r0, np.array(rt) / r0
    keep = rj > 5e-3
    assert keep.sum() >= 2
    assert np.max(np.abs(rt[keep] - rj[keep]) / rj[keep]) <= 1e-4
    _, nj = jp.hierarchy.solve_pcg(jp.b, rtol=1e-6)
    _, nt = tp.hierarchy.solve_pcg(tp.b, rtol=1e-6)
    assert nt == nj


def test_grid_schwarz_matches_jax_and_single_device():
    from pmg_dolfinx_tpu.parallel import grid2d as jg
    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu_torch.models.poisson import f_rhs
    from pmg_dolfinx_tpu_torch.parallel import grid2d as tg
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    nc = (4, 4, 4)
    b = assemble_rhs(TBox(nc), 3, f_rhs(2.0))
    kw = dict(degrees=(1, 3), smoother="schwarz", coarse="fdm")
    grid = tg.GridPMG(TBox(nc), (2, 2, 2), dtype=torch.float64, device="cpu",
                      **kw)
    hier = PMGHierarchy(TBox(nc), dtype=torch.float64, device="cpu", **kw)
    jgrid = jg.GridPMG(JBox(nc), (2, 2, 2), dtype=jnp.float64, **kw)
    for e_t, e_h, e_j in zip(grid.eigs, hier.eigs, jgrid.eigs):
        assert _rel(e_t, e_j) <= 1e-12 and _rel(e_t, e_h) <= 1e-12
    u, rn = grid.solve(b, num_cycles=4)
    _, rh = hier.solve(b, num_cycles=4)
    uj, rj = jgrid.solve(jnp.asarray(b), num_cycles=4)
    assert _rel(rn, rj) <= 1e-10 and _rel(rn, rh) <= 1e-10
    assert _rel_max(u, uj) <= 1e-10
    assert grid.solve_pcg(b, rtol=1e-6)[1] == jgrid.solve_pcg(
        jnp.asarray(b), rtol=1e-6)[1]


def test_grid_schwarz_kron_blocked_f32_against_one_device():
    """f32, the plain kernels: one grid V-cycle on a seeded rhs and iterate
    at the single device's smoother bounds within 1e-5 of one device's;
    the trajectories within 1e-4 above 5e-3."""
    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu_torch.models.poisson import f_rhs
    from pmg_dolfinx_tpu_torch.parallel import grid2d as tg
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    nc = (4, 4, 4)
    kw = dict(degrees=(1, 3), smoother="schwarz", coarse="fdm",
              operator="kron_blocked", dtype=torch.float32, device="cpu")
    grid = tg.GridPMG(TBox(nc), (1, 2, 4), **kw)
    hier = PMGHierarchy(TBox(nc), **kw)
    for lv_g, lv_s in zip(grid.data["levels"], hier.data["levels"]):
        lv_g["lmax"] = lv_s["lmax"]
    rng = np.random.default_rng(5)
    n = hier.levels[-1].ndofs
    b, u = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
            for _ in range(2))
    v_g = grid.from_dist(grid.apply(grid.to_dist(b), grid.to_dist(u)))
    assert _rel_max(v_g, hier.apply(b, u)) <= 1e-5
    b = assemble_rhs(TBox(nc), 3, f_rhs(2.0))
    r0 = np.linalg.norm(b)
    rg = np.array(grid.solve(b, num_cycles=4)[1]) / r0
    rh = np.array(hier.solve(b, num_cycles=4)[1]) / r0
    keep = rh > 5e-3
    assert np.max(np.abs(rg[keep] - rh[keep]) / rh[keep]) <= 1e-4
