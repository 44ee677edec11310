"""The slab layer's solve modes, its model-family programs and its drivers
against the JAX package (8 virtual CPU devices, f64).

- The other half of `tests/_slab_cases.py`'s parity cases (operator,
  eigenvalues, five cycles, `solve_pcg`, one V-cycle on JAX's state; the
  tolerances of `tests/test_torch_dist.py`).
- `solve_refined` (the Kronecker f64 residual on a box, the lattice one
  on a curved mesh), ``fmg=True`` in `solve`, `solve_pcg` and
  `solve_refined`, and ``u0=`` resume (3 + 2 cycles against JAX's 5):
  residuals to rtol 1e-9, solutions to 1e-10, FCG counts equal.
- JAX's own sharded tests, ported: `newton_solve` on the slab and on the
  grid reproduces the single-device solve (equal Newton counts, ``|F|``
  as JAX's test compares it, solution to 1e-10) and JAX's sharded Newton
  on the same inputs (equal counts, ``|F|`` to rtol 1e-9, solution to
  1e-10), `convdiff_solve` on both
  meets the spsolve oracle (``rel_resid`` < 1e-11, solution to 1e-8).
- `examples/scaling_torch.py` (the 1D slab sweep) prints the rel resid
  column and the invariance lines of `examples/scaling.py` (the other
  slab drivers: `tests/test_torch_shardwrap.py`).
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import scipy.sparse.linalg as spla  # noqa: E402

from _slab_cases import (  # noqa: E402
    CASES,
    _rel,
    check_eigs,
    check_loaded,
    check_operator,
    check_pcg,
    check_trajectory,
)
from pmg_dolfinx_tpu.fem.mesh import BoxMesh as JBox  # noqa: E402
from pmg_dolfinx_tpu.fem.mesh import PerturbedBoxMesh as JPert  # noqa: E402
from pmg_dolfinx_tpu.parallel import dist as jd  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh as TBox  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import (  # noqa: E402
    PerturbedBoxMesh as TPert,
)
from pmg_dolfinx_tpu_torch.models import semilinear  # noqa: E402
from pmg_dolfinx_tpu_torch.parallel import dist as td  # noqa: E402
from pmg_dolfinx_tpu_torch.parallel.grid2d import GridPMG  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers.convdiff import convdiff_solve  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers.newton import newton_solve  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CASES_HERE = list(CASES)[1::2]
KAPPA, SIGMA = 2.0, 0.5
CVEL = (3.0, -1.5, 0.8)


@pytest.mark.parametrize("name", CASES_HERE)
def test_fine_operator_matches_jax(name):
    check_operator(name)


@pytest.mark.parametrize("name", CASES_HERE)
def test_calibration_eigs_match_jax(name):
    check_eigs(name)


@pytest.mark.parametrize("name", CASES_HERE)
def test_five_cycle_trajectory_matches_jax(name):
    check_trajectory(name)


@pytest.mark.parametrize("name", CASES_HERE)
def test_solve_pcg_matches_jax(name):
    check_pcg(name)


@pytest.mark.parametrize("name", CASES_HERE)
def test_vcycle_on_jax_state(name):
    check_loaded(name)


_MODES = {}


def _modes_pair(kind):
    """(JAX, port) DistPMG of the solve-mode tests, f64, built once: a
    ``kron`` + ``fdm`` box on 4 slabs, a curved ``dofmap`` + ``cg`` mesh on
    2 (its f64 refinement residual is the lattice apply)."""
    if kind not in _MODES:
        if kind == "box":
            mj, mt, kw = JBox((8, 4, 4)), TBox((8, 4, 4)), dict(
                n_devices=4, operator="kron", coarse="fdm")
        else:
            mj, mt, kw = JPert((8, 4, 4)), TPert((8, 4, 4)), dict(
                n_devices=2, operator="dofmap", coarse="cg")
        kw.update(degrees=(1, 3), kappa=KAPPA)
        j = jd.DistPMG(mj, **kw)
        t = td.DistPMG(mt, device="cpu", **kw)
        rng = np.random.default_rng(11)
        b = rng.standard_normal(mt.num_dofs(3))
        b[mt.boundary_dof_marker(3)] = 0.0
        _MODES[kind] = (j, t, b)
    return _MODES[kind]


@pytest.mark.parametrize("kind", ["box", "curved"])
def test_solve_refined_matches_jax(kind):
    j, t, b = _modes_pair(kind)
    uj, rj = j.solve_refined(b, num_cycles=5)
    ut, rt = t.solve_refined(b, num_cycles=5)
    np.testing.assert_allclose(rt, rj, rtol=1e-9)
    assert _rel(ut, uj) <= 1e-10
    uj, rj = j.solve_refined(b, num_cycles=3, fmg=True)
    ut, rt = t.solve_refined(b, num_cycles=3, fmg=True)
    np.testing.assert_allclose(rt, rj, rtol=1e-9)
    # resume: 3 refinement cycles, then 2 more from that iterate
    u3, _ = t.solve_refined(b, num_cycles=3)
    _, r5 = t.solve_refined(b, num_cycles=5)
    _, r2 = t.solve_refined(b, num_cycles=2, u0=u3)
    np.testing.assert_allclose(r2, r5[3:], rtol=1e-9)
    # rtol stops the loop as JAX's does
    _, rj = j.solve_refined(b, num_cycles=15, rtol=1e-6)
    _, rt = t.solve_refined(b, num_cycles=15, rtol=1e-6)
    assert len(rt) == len(rj)


@pytest.mark.parametrize("kind", ["box", "curved"])
def test_fmg_and_resume_match_jax(kind):
    j, t, b = _modes_pair(kind)
    uj, rj = j.solve(b, num_cycles=5, fmg=True)
    ut, rt = t.solve(b, num_cycles=5, fmg=True)
    np.testing.assert_allclose(rt, rj, rtol=1e-9)
    assert _rel(ut, uj) <= 1e-10
    uj, nj = j.solve_pcg(b, rtol=1e-9, fmg=True)
    ut, nt = t.solve_pcg(b, rtol=1e-9, fmg=True)
    assert nt == nj and _rel(ut, uj) <= 1e-10
    # 3 + 2 cycles from the resumed iterate against JAX's 5
    _, rj = j.solve(b, num_cycles=5)
    u3, r3 = t.solve(b, num_cycles=3)
    u5, r2 = t.solve(b, num_cycles=2, u0=u3)
    np.testing.assert_allclose(r3 + r2, rj, rtol=1e-9)
    assert _rel(u5, j.solve(b, num_cycles=5)[0]) <= 1e-10
    assert t.residual_norm(t.to_dist(b), t.to_dist(u5)) == pytest.approx(
        r2[-1], rel=1e-12)


def _sharded(layout, mesh, **kw):
    if layout == "slab":
        return td.DistPMG(mesh, n_devices=4, device="cpu", **kw)
    return GridPMG(mesh, shards=(2, 2), device="cpu", **kw)


def _jax_sharded(layout, mesh, **kw):
    if layout == "slab":
        return jd.DistPMG(mesh, n_devices=4, **kw)
    from pmg_dolfinx_tpu.parallel.grid2d import GridPMG as JGrid

    return JGrid(mesh, shards=(2, 2), **kw)


@pytest.mark.parametrize("layout", ["slab", "grid"])
def test_newton_sharded_matches_single(layout):
    """JAX's ``test_newton_sharded_matches_single``: the sharded Newton
    reproduces the single-device trajectory and solution; and it equals
    JAX's sharded Newton (`DistPMG` on 4 devices, `GridPMG` on (2, 2)) on
    the same mesh, rhs and nonlinearity: the same Newton count, ``|F|``
    to rtol 1e-9 (above 1e-13 of the first), the solution to 1e-10."""
    from pmg_dolfinx_tpu.models import semilinear as jsemi
    from pmg_dolfinx_tpu.solvers.newton import newton_solve as jnewton

    mesh = TBox((8, 8, 6))
    nonlin = semilinear.cubic(5.0)
    b = assemble_rhs(mesh, 3, semilinear.f_rhs_semilinear(
        KAPPA, nonlin, sigma=SIGMA))
    kw = dict(degrees=(1, 3), kappa=KAPPA, coarse="fdm", operator="kron",
              sigma=SIGMA)
    single = PMGHierarchy(mesh, device="cpu", **kw)
    u1, info1 = newton_solve(single, b, nonlin, rtol=1e-11, lin_rtol=1e-10)
    u2, info2 = newton_solve(_sharded(layout, mesh, **kw), b, nonlin,
                             rtol=1e-11, lin_rtol=1e-10)
    assert info2["converged"]
    assert info1["niter"] == info2["niter"]
    f1, f2 = np.array(info1["fnorms"]), np.array(info2["fnorms"])
    assert np.allclose(f1, f2, rtol=1e-8), (f1, f2)
    assert _rel(u2, u1) <= 1e-10
    uj, infoj = jnewton(_jax_sharded(layout, JBox((8, 8, 6)), **kw),
                        np.asarray(b), jsemi.cubic(5.0), rtol=1e-11,
                        lin_rtol=1e-10)
    assert infoj["converged"]
    assert info2["niter"] == infoj["niter"]
    fj = np.array(infoj["fnorms"])
    # rtol 1e-9; the last |F| sits at f64 round-off (~1e-14 of |F_0|),
    # where the two summation orders differ by ~5e-16 absolute
    np.testing.assert_allclose(f2, fj, rtol=1e-9, atol=1e-13 * fj[0])
    assert _rel(u2, np.asarray(uj)) <= 1e-10


def _assembled_convdiff(mesh, P, kappa, sigma, cvel):
    """JAX's scipy oracle: the assembled stiffness with the lumped-mass
    shift (bc identity rows) plus the separable advection with bc rows and
    columns masked."""
    import scipy.sparse as sp

    from pmg_dolfinx_tpu_torch.fem.assembly import (assemble_stiffness,
                                                    lumped_mass_np)
    from pmg_dolfinx_tpu_torch.ops import kron as tk

    A = assemble_stiffness(mesh, P, kappa=kappa, bc=True).tocsr()
    A = A + sp.diags(sigma * lumped_mass_np(mesh, P, bc_zero=True))
    Cs = [sp.csr_matrix(tk.axis_advection(mesh.nc[a], P)) for a in range(3)]
    ms = [sp.diags(tk.axis_stiffness_mass(mesh.nc[a], P, mesh.h_cells[a])[1])
          for a in range(3)]
    adv = (cvel[0] * sp.kron(Cs[0], sp.kron(ms[1], ms[2]))
           + cvel[1] * sp.kron(ms[0], sp.kron(Cs[1], ms[2]))
           + cvel[2] * sp.kron(ms[0], sp.kron(ms[1], Cs[2])))
    z = sp.diags((~np.asarray(mesh.boundary_dof_marker(P))).astype(float))
    return (A + z @ adv @ z).tocsc()


def _f_convdiff(kappa, cvel, sigma=0.0):
    pi = np.pi

    def f(x):
        sx, sy, sz = (np.sin(pi * x[a]) for a in range(3))
        cx, cy, cz = (np.cos(pi * x[a]) for a in range(3))
        g = (pi * cx * sy * sz, pi * sx * cy * sz, pi * sx * sy * cz)
        return ((3.0 * pi**2 * kappa + sigma) * sx * sy * sz
                + sum(c_ * g_ for c_, g_ in zip(cvel, g)))

    return f


@pytest.mark.parametrize("layout", ["slab", "grid"])
def test_convdiff_sharded_matches_oracle(layout):
    """JAX's ``test_convdiff_sharded_matches_oracle``: BiCGStab with the
    per-axis advection exchanges solves the spsolve oracle's system."""
    mesh = TBox((8, 8, 6))
    P, sigma = 3, 0.6
    b = assemble_rhs(mesh, P, _f_convdiff(KAPPA, CVEL, sigma))
    hier = _sharded(layout, mesh, degrees=(1, 3), kappa=KAPPA, coarse="fdm",
                    operator="kron", sigma=sigma)
    u, info = convdiff_solve(hier, b, CVEL, rtol=1e-11)
    assert info["rel_resid"] < 1e-11, info
    u_ref = spla.spsolve(_assembled_convdiff(mesh, P, KAPPA, sigma, CVEL), b)
    assert np.linalg.norm(u.numpy() - u_ref) < 1e-8 * np.linalg.norm(u_ref)


def _run(script, *args, torch_side=True):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    extra = ("--device", "cpu") if torch_side else ("--cpu",)
    return subprocess.run([sys.executable, str(ROOT / "examples" / script),
                           *args, *extra], capture_output=True, text=True,
                          env=env, timeout=600, check=True,
                          cwd=ROOT / "examples").stdout


@pytest.mark.parametrize("operator,coarse", [("kron", "cg"),
                                             ("dofmap", "fdm")])
def test_scaling_torch_slab_matches_jax_driver(operator, coarse):
    """The 1D slab sweep prints the JAX driver's rel resid column and its
    invariance line (f64, 1, 2 and 4 slabs)."""
    args = ["--ndofs", "3000", "--degrees", "1", "3", "--dtype", "f64",
            "--cycles", "3", "--max-devices", "4", "--operator", operator,
            "--coarse", coarse]
    out_t = json.loads(_run("scaling_torch.py", *args).strip()
                       .splitlines()[-1])
    assert [r["devices"] for r in out_t["rows"]] == [1, 2, 4]
    assert all(r["invariant"] for r in out_t["rows"][1:])
    j = _run("scaling.py", *args, torch_side=False)
    rows = [line.split() for line in j.splitlines()
            if line.split() and line.split()[0] in ("1", "2", "4")]
    assert [int(r[0]) for r in rows] == [1, 2, 4]
    assert [int(r[1]) for r in rows] == [r["ndofs"] for r in out_t["rows"]]
    rel_j = [float(r[-1]) for r in rows]
    rel_t = [r["rel_resid"] for r in out_t["rows"]]
    np.testing.assert_allclose(rel_t, rel_j, rtol=2e-3)  # printed to 4 digits
    assert j.count("invariant vs 1 device: True") == 2


# -- the hmg coarse solve on the slab and the grid ----------------------------
#
# name: (layout, mesh kind, cells, shards, DistPMG/GridPMG keywords). Each
# case: five cycles' residuals equal JAX's to rtol 1e-10 (its p-level lmax
# from each package's own calibration), the solutions to 1e-10, and one
# V-cycle on JAX's loaded state (`load_state`, the ``hmg`` data included)
# to 1e-12.
_HMG = {
    "slab-gathered-box": ("slab", "box", (8, 4, 4), 4,
                          dict(operator="kron")),
    "slab-gathered-general": ("slab", "curved", (8, 4, 4), 2,
                              dict(operator="dofmap")),
    "slab-dist-direct-cheb": ("slab", "box", (8, 4, 4), 4,
                              dict(operator="kron",
                                   coarse_cfg=dict(dist=True))),
    "slab-dist-fdm-cheb-sigma": ("slab", "box", (8, 4, 4), 4,
                                 dict(operator="kron", sigma=37.0,
                                      coarse_cfg=dict(dist=True,
                                                      bottom="fdm"))),
    "slab-dist-fdm-liney": ("slab", "box", (8, 4, 4), 4,
                            dict(operator="kron",
                                 coarse_cfg=dict(dist=True, bottom="fdm",
                                                 smoother="line-y"))),
    "slab-dist-direct-schwarz-dofmap": ("slab", "box", (8, 4, 4), 2,
                                        dict(operator="dofmap",
                                             coarse_cfg=dict(
                                                 dist=True,
                                                 smoother="schwarz"))),
    "grid-gathered": ("grid", "box", (8, 4, 4), (2, 2, 1), {}),
    "grid-dist-direct-222": ("grid", "box", (4, 8, 4), (2, 2, 2),
                             dict(coarse_cfg=dict(dist=True))),
    "grid-dist-fdm-24-sigma": ("grid", "box", (4, 8, 4), (2, 4),
                               dict(sigma=37.0,
                                    coarse_cfg=dict(dist=True,
                                                    bottom="fdm"))),
    "grid-dist-fdm-schwarz-122": ("grid", "box", (8, 8, 4), (1, 2, 2),
                                  dict(coarse_cfg=dict(dist=True,
                                                       bottom="fdm",
                                                       smoother="schwarz"))),
    "grid-dist-direct-linez-221": ("grid", "box", (8, 4, 4), (2, 2, 1),
                                   dict(coarse_cfg=dict(dist=True,
                                                        smoother="line-z"))),
}
_HMG_BUILT = {}


def _hmg_pair(name):
    """(JAX hierarchy, port hierarchy, seeded rhs), built once."""
    if name not in _HMG_BUILT:
        from pmg_dolfinx_tpu.parallel import grid2d as jg

        layout, kind, nc, lay, kw = _HMG[name]
        mj, mt = ((JBox(nc), TBox(nc)) if kind == "box"
                  else (JPert(nc), TPert(nc)))
        kw = dict(kw, degrees=(1, 3), kappa=KAPPA, coarse="hmg")
        cfg = kw.pop("coarse_cfg", {})
        J, T = ((jd.DistPMG, td.DistPMG) if layout == "slab"
                else (jg.GridPMG, GridPMG))
        j = J(mj, lay, coarse_cfg=dict(cfg), **kw)
        t = T(mt, lay, coarse_cfg=dict(cfg), device="cpu", **kw)
        b = np.random.default_rng(len(_HMG_BUILT)).standard_normal(
            mt.num_dofs(3))
        b[mt.boundary_dof_marker(3)] = 0.0
        _HMG_BUILT[name] = (j, t, b)
    return _HMG_BUILT[name]


@pytest.mark.parametrize("name", list(_HMG))
def test_hmg_coarse_trajectory_matches_jax(name):
    j, t, b = _hmg_pair(name)
    assert bool(t.coarse_cfg.get("hmg_dist")) == bool(
        j.coarse_cfg.get("hmg_dist"))
    assert [lv.shape for lv in t.coarse_cfg["hmg_levels"]] == [
        lv.shape for lv in j.coarse_cfg["hmg_levels"]]
    assert t.coarse_cfg["hmg_bottom"] == j.coarse_cfg["hmg_bottom"]
    uj, rj = j.solve(b, num_cycles=5)
    ut, rt = t.solve(b, num_cycles=5)
    np.testing.assert_allclose(rt, rj, rtol=1e-10)
    assert _rel(ut, np.asarray(uj).reshape(-1)) <= 1e-10


@pytest.mark.parametrize("name", list(_HMG))
def test_hmg_vcycle_on_jax_state(name):
    import jax

    from pmg_dolfinx_tpu_torch.utils.convert import (
        dist_data_from_numpy,
        grid_data_from_numpy,
    )

    j, t, b = _hmg_pair(name)
    conv = (dist_data_from_numpy if isinstance(t, td.DistPMG)
            else grid_data_from_numpy)
    t.load_state(conv(jax.tree.map(np.asarray, j.data), t, "cpu",
                      torch.float64))
    x = np.random.default_rng(5).standard_normal(b.size)
    if isinstance(t, td.DistPMG):
        vj = j.from_dist(j.apply(j.to_dist(b), j.to_dist(x)))
    else:
        vj = j.from_dist(j._vcycle(j.data, j.to_dist(b), j.to_dist(x)))
    vt = t.from_dist(t.apply(t.to_dist(b), t.to_dist(x)))
    assert _rel(vt, np.asarray(vj).reshape(-1)) <= 1e-12


def test_dist_hmg_matches_single_device_hmg():
    """The gather-free slab hierarchy (``dist=True, bottom="fdm"``) on the
    JAX test's mesh, whose shard-aligned h-levels are the single-device
    ones: the trajectory equals the port's single-device hmg coarse."""
    mesh = TBox((8, 4, 4))
    b = assemble_rhs(mesh, 3, lambda x: np.sin(np.pi * x[0]))
    single = PMGHierarchy(mesh, degrees=(1, 3), kappa=KAPPA, coarse="hmg",
                          operator="kron", dtype=torch.float64, device="cpu")
    _, rs = single.solve(b, num_cycles=5)
    dist = td.DistPMG(mesh, n_devices=4, degrees=(1, 3), kappa=KAPPA,
                      coarse="hmg", coarse_cfg=dict(dist=True, bottom="fdm"),
                      operator="kron", device="cpu")
    _, rd = dist.solve(b, num_cycles=5)
    np.testing.assert_allclose(rd, rs, rtol=1e-9)


def test_hmg_dist_refuses_what_jax_refuses():
    from pmg_dolfinx_tpu.parallel import grid2d as jg
    from pmg_dolfinx_tpu_torch.parallel import grid2d as tg

    with pytest.raises(ValueError, match="not h-coarsenable"):
        td.build_hmg_dist(TBox((8, 4, 4)), 8, 1, 2.0, torch.float64,
                          device="cpu")
    with pytest.raises(ValueError, match="not h-coarsenable"):
        jd.build_hmg_dist(JBox((8, 4, 4)), 8, 1, 2.0, np.float64)
    with pytest.raises(ValueError, match="not h-coarsenable"):
        tg.build_hmg_grid(TBox((4, 4, 4)), (4, 1, 1), 1, 2.0, torch.float64,
                          device="cpu")
    with pytest.raises(ValueError, match="not h-coarsenable"):
        jg.build_hmg_grid(JBox((4, 4, 4)), (4, 1, 1), 1, 2.0, np.float64)
    with pytest.raises(ValueError, match="multiple of n_shards"):
        td.build_hmg_dist(TBox((8, 4, 4)), 4, 1, 2.0, torch.float64,
                          divisors=(2, 1, 1), device="cpu")
    with pytest.raises(ValueError, match="cannot relax along x"):
        td.build_hmg_dist(TBox((8, 4, 4)), 2, 1, 2.0, torch.float64,
                          smoother="line-x", device="cpu")
    with pytest.raises(ValueError, match="constant-kappa axis-aligned"):
        td.DistPMG(TPert((8, 4, 4)), n_devices=2, degrees=(1, 3),
                   coarse="hmg", coarse_cfg=dict(dist=True),
                   operator="dofmap", device="cpu")
    # The Kronecker h-hierarchy on a graded mesh runs since item 10 (b)
    # (tests/test_torch_kron_sharded.py); there, as in JAX, a line
    # smoother along a sharded axis is refused.
    graded = (None, None, (1.0, 2.0, 3.0, 4.0))
    with pytest.raises(ValueError, match=r"needs shards\[2\]==1"):
        tg.build_hmg_grid(TBox((4, 8, 4), spacing=graded), (2, 2, 2), 1,
                          2.0, torch.float64, smoother="line-z",
                          device="cpu")
    with pytest.raises(ValueError, match=r"needs shards\[2\]==1"):
        jg.build_hmg_grid(JBox((4, 8, 4), spacing=graded), (2, 2, 2), 1,
                          2.0, np.float64, smoother="line-z")


def test_scaling_torch_hmg_dist_sweeps_match_jax_driver():
    """``--coarse hmg --dist-coarse --bottom fdm``: the slab sweep and the
    grid sweep print the JAX driver's rel resid column, every count's and
    layout's trajectory invariant (the hierarchy pinned by JAX's
    ``divisors``)."""
    args = ["--ndofs", "3000", "--degrees", "1", "3", "--dtype", "f64",
            "--cycles", "3", "--max-devices", "4", "--coarse", "hmg",
            "--dist-coarse", "--bottom", "fdm"]
    for grid in ((), ("--grid",)):
        out_t = json.loads(_run("scaling_torch.py", *args, *grid).strip()
                           .splitlines()[-1])
        assert out_t["dist_coarse"] and out_t["bottom"] == "fdm"
        assert all(r["invariant"] for r in out_t["rows"][1:])
        j = _run("scaling.py", *args, *grid, torch_side=False)
        keys = ("1x1x1", "2x1x1", "2x2x1") if grid else ("1", "2", "4")
        rows = [line.split() for line in j.splitlines()
                if line.split() and line.split()[0] in keys]
        assert len(rows) == len(out_t["rows"]) == 3
        np.testing.assert_allclose([r["rel_resid"] for r in out_t["rows"]],
                                   [float(r[-1]) for r in rows], rtol=2e-3)
        assert j.count("invariant vs 1") == 2 and "False" not in j
