"""The port's h-multigrid and direct coarse solves (`solvers/hmg.py`,
``coarse="direct" | "hmg"``) against the JAX package.

- the host builders (`axis_h_interpolation` uniform and graded,
  `local_axis_h_interpolation`, `coarsen_spacing`, `coarsenable_levels`,
  `semicoarsen_sizes`, `axis_coupling`, `semicoarsen_axes`,
  `validate_hmg_sizes`, `coarsen_cell_field`) equal JAX's to 1e-13;
- `build_hmg` (point Jacobi, line and Schwarz h-smoothers, a sigma shift,
  semicoarsened sizes) and `build_hmg_general` (curved mesh): the same
  levels, per-level lmax to 1e-12 (the 2.0 fallback where CG converges in
  under two iterations included), transfers and dense bottom factor to
  1e-13, the same bottom (``direct`` falls back to ``cg`` past 4096 dofs);
- `PMGHierarchy(coarse="direct" | "hmg")` in f64 (box and curved, each
  h-smoother, semicoarsened sizes): the trajectory to 1e-10 and the FCG(V)
  count, ``cycles`` 3 where `v_cycle` defaults to 2;
- `GridPMG(coarse="direct")` against JAX's and the single device; the grid
  ``hmg`` keeps its refusal (ROADMAP.md Queue 1 item 10);
- the drivers' last lines: `examples/pmg_torch.py --coarse hmg|direct
  --smoother schwarz` against `examples/pmg.py --cpu` (f64), and
  `examples/amg_torch.py` against `examples/amg.py` iteration counts.
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

import jax.numpy as jnp  # noqa: E402

from pmg_dolfinx_tpu.fem.mesh import BoxMesh as JBox  # noqa: E402
from pmg_dolfinx_tpu.fem.mesh import PerturbedBoxMesh as JPert  # noqa: E402
from pmg_dolfinx_tpu.solvers import hmg as jh  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh as TBox  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh as TPert  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers import hmg as th  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else (
        np.asarray(a))


def _rel_max(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b) / np.abs(b))


def test_host_builders_match_jax():
    h = np.random.default_rng(0).uniform(0.5, 2.0, 6)
    for P, f, hf in ((1, 2, None), (3, 3, None), (2, 2, h), (1, 3, h)):
        nc_c = 6 // f
        assert _rel_max(th.axis_h_interpolation(nc_c, P, f, h_fine=hf),
                        jh.axis_h_interpolation(nc_c, P, f, h_fine=hf)) <= 1e-13
    # (coarse cells per shard, P, factor, shards, fine widths)
    for args in ((1, 2, 3, 2, None), (3, 2, 2, 1, h), (1, 2, 3, 2, h)):
        It, st = th.local_axis_h_interpolation(*args[:4], h_fine=args[4])
        Ij, sj = jh.local_axis_h_interpolation(*args[:4], h_fine=args[4])
        assert st == sj and np.array_equal(It, Ij)
    hc = (np.full(4, 0.25), h, np.ones(2))
    for a, b in zip(th.coarsen_spacing(hc, (4, 6, 2), (2, 3, 1)),
                    jh.coarsen_spacing(hc, (4, 6, 2), (2, 3, 1))):
        assert np.array_equal(a, b)
    for nc in ((8, 8, 8), (12, 6, 9), (16, 16, 32), (7, 7, 7)):
        assert th.coarsenable_levels(nc) == jh.coarsenable_levels(nc)
        assert th.coarsenable_levels(nc, divisors=(2, 1, 1)) == (
            jh.coarsenable_levels(nc, divisors=(2, 1, 1)))
        for axes in ((), (2,), (0, 1)):
            assert th.semicoarsen_sizes(nc, axes) == jh.semicoarsen_sizes(
                nc, axes)
    for kw in (dict(nc=(4, 4, 4)), dict(nc=(16, 16, 32),
                                        extent=(1, 1, 0.25))):
        tm, jm = TBox(**kw), JBox(**kw)
        for kappa in (2.0, np.diag([1.0, 3.0, 2.0])):
            assert np.array_equal(th.axis_coupling(tm, kappa),
                                  jh.axis_coupling(jm, kappa))
            assert th.semicoarsen_axes(tm, kappa) == jh.semicoarsen_axes(
                jm, kappa)
    assert th.validate_hmg_sizes((4, 4, 8), [(4, 4, 8), (2, 2, 2)]) == (
        jh.validate_hmg_sizes((4, 4, 8), [(4, 4, 8), (2, 2, 2)]))
    for bad in ([(4, 4, 8)], [(4, 4, 4), (2, 2, 2)], [(4, 4, 8), (3, 2, 2)],
                [(4, 4, 8), (4, 4, 8)], [(4, 4), (2, 2)]):
        with pytest.raises(ValueError, match="hmg sizes"):
            th.validate_hmg_sizes((4, 4, 8), bad)
    vals = np.random.default_rng(1).standard_normal(4 * 6 * 2)
    tens = np.random.default_rng(2).standard_normal((4 * 6 * 2, 3, 3))
    for v in (vals, tens):
        for hcs in (None, hc):
            assert _rel_max(
                th.coarsen_cell_field(v, (4, 6, 2), (2, 3, 1), h_cells=hcs),
                jh.coarsen_cell_field(v, (4, 6, 2), (2, 3, 1),
                                      h_cells=hcs)) <= 1e-13


def _check_hmg(out_t, out_j):
    (lv_t, d_t, bot_t), (lv_j, d_j, bot_j) = out_t[:3], out_j[:3]
    assert bot_t == bot_j
    fields = lambda lv: [(v.P, v.ndofs, v.smoother_iters, tuple(v.shape),
                          v.line_axis) for v in lv]
    assert fields(lv_t) == fields(lv_j)
    for a, b in zip(d_t["levels"], d_j["levels"]):
        assert _rel(float(a["lmax"]), float(b["lmax"])) <= 1e-12
        for k in ("diag_inv", "line_inv"):
            if k in b:
                assert _rel_max(a[k], b[k]) <= 1e-13, k
        if "schwarz" in b:
            assert _rel_max(a["schwarz"]["ginv"], b["schwarz"]["ginv"]) <= (
                1e-13)
    for a, b in zip(d_t["transfer"], d_j["transfer"]):
        for k in b:
            assert np.array_equal(_np(a[k]), np.asarray(b[k])), k
    assert ("coarse_chol" in d_t) == ("coarse_chol" in d_j)
    if "coarse_chol" in d_j:
        assert _rel_max(d_t["coarse_chol"], d_j["coarse_chol"]) <= 1e-13


@pytest.mark.parametrize("nc,kw", [
    ((4, 4, 4), dict()),
    ((4, 4, 8), dict(smoother="line", sigma=0.5,
                     sizes=[(4, 4, 8), (4, 4, 4), (2, 2, 2)])),
    ((6, 6, 6), dict(smoother="schwarz", min_cells=1)),
    ((8, 8, 8), dict(P=2, smoother="line-x", max_levels=2)),
])
def test_build_hmg_matches_jax(nc, kw):
    kw = dict(kw)
    P = kw.pop("P", 1)
    out_t = th.build_hmg(TBox(nc), P, 2.0, torch.float64, device="cpu", **kw)
    out_j = jh.build_hmg(JBox(nc), P, 2.0, jnp.float64, **kw)
    _check_hmg(out_t, out_j)
    with pytest.raises(ValueError, match="unsupported bottom"):
        th.build_hmg(TBox((2, 2, 2)), 1, 2.0, torch.float64, bottom="fdm",
                     device="cpu")


def test_build_hmg_lmax_fallback_matches_jax(monkeypatch):
    """Where Lanczos has too few CG coefficients (ValueError) both packages
    calibrate every h-level to 1.1 x 2.0."""
    from pmg_dolfinx_tpu.solvers import tridiag as jt
    from pmg_dolfinx_tpu_torch.solvers import tridiag as tt

    def short(*a, **k):
        raise ValueError("Insufficient CG coefficients to estimate "
                         "eigenvalues")

    for mod in (jt, tt):
        monkeypatch.setattr(mod, "lanczos_eigenvalue_estimates", short)
    out_t = th.build_hmg_general(TPert((4, 4, 4)), 1, 2.0, torch.float64,
                                 device="cpu")
    out_j = jh.build_hmg_general(JPert((4, 4, 4)), 1, 2.0, jnp.float64)
    _check_hmg(out_t, out_j)
    assert [float(lv["lmax"]) for lv in out_t[1]["levels"]] == [1.1 * 2.0] * 2


@pytest.mark.parametrize("smoother", ["cheb", "schwarz"])
def test_build_hmg_general_matches_jax(smoother):
    nc = (4, 4, 4)
    out_t = th.build_hmg_general(TPert(nc), 1, 2.0, torch.float64,
                                 smoother=smoother, device="cpu")
    out_j = jh.build_hmg_general(JPert(nc), 1, 2.0, jnp.float64,
                                 smoother=smoother)
    _check_hmg(out_t, out_j)
    for a, b in zip(out_t[1]["levels"], out_j[1]["levels"]):
        assert _rel_max(a["G"], b["G"]) <= 1e-13
    # a 17^3-dof coarsest level is past 4096: a Krylov bottom
    assert th.build_hmg(TBox((32, 32, 32)), 1, 2.0, torch.float64,
                        max_levels=2, device="cpu")[2] == "cg"


@pytest.mark.parametrize("curved,operator,coarse,cfg", [
    (False, "kron", "direct", None),
    (False, "lattice", "hmg", dict(smoother="line")),
    (False, "kron", "hmg", dict(smoother="schwarz", hmg_gamma=2)),
    (True, "lattice", "hmg", dict(smoother="schwarz")),
    (True, "dofmap", "direct", None),
])
def test_pmg_coarse_f64_matches_jax(curved, operator, coarse, cfg):
    from pmg_dolfinx_tpu.models.poisson import PoissonProblem as JP
    from pmg_dolfinx_tpu_torch.models.poisson import PoissonProblem as TP

    nc = (4, 4, 4)
    kw = dict(degrees=(1, 3), kappa=2.0, coarse=coarse, operator=operator,
              coarse_cfg=cfg)
    jp = JP(dtype=jnp.float64, mesh=JPert(nc) if curved else JBox(nc), **kw)
    tp = TP(dtype=torch.float64, device="cpu",
            mesh=TPert(nc) if curved else TBox(nc), **kw)
    if coarse == "hmg":
        assert tp.hierarchy.coarse_cfg["cycles"] == 3 == (
            jp.hierarchy.coarse_cfg["cycles"])
        for a, b in zip(tp.hierarchy.data["hmg"]["levels"],
                        jp.hierarchy.data["hmg"]["levels"]):
            assert _rel(float(a["lmax"]), float(b["lmax"])) <= 1e-12
    else:
        assert _rel_max(tp.hierarchy.data["coarse_chol"],
                        jp.hierarchy.data["coarse_chol"]) <= 1e-13
    for et, ej in zip(tp.hierarchy.eigs, jp.hierarchy.eigs):
        assert _rel(et, ej) <= 1e-12
    _, rj = jp.solve(num_cycles=5)
    _, rt = tp.solve(num_cycles=5)
    assert _rel(rt, rj) <= 1e-10
    _, nj = jp.hierarchy.solve_pcg(jp.b, rtol=1e-6)
    _, nt = tp.hierarchy.solve_pcg(tp.b, rtol=1e-6)
    assert nt == nj


def test_semicoarsened_hmg_line_f64_matches_jax():
    """The anisotropy recipe: stretched cells (64:1 coupling), the h-levels
    from `semicoarsen_sizes` of `semicoarsen_axes`, line smoothers on the
    p-levels (auto: z) and the h-levels."""
    from pmg_dolfinx_tpu.solvers.pmg import PMGHierarchy as JH
    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu_torch.models.poisson import f_gauss
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy as TH

    kw = dict(nc=(4, 4, 8), extent=(1.0, 1.0, 0.25))
    tm, jm = TBox(**kw), JBox(**kw)
    axes = th.semicoarsen_axes(tm, 2.0)
    assert axes == jh.semicoarsen_axes(jm, 2.0) == (2,)
    cfg = dict(sizes=th.semicoarsen_sizes(tm.nc, axes), smoother="line")
    hk = dict(degrees=(1, 2), kappa=2.0, coarse="hmg", smoother="line")
    th_ = TH(tm, dtype=torch.float64, device="cpu", coarse_cfg=dict(cfg),
             **hk)
    jh_ = JH(jm, dtype=jnp.float64, coarse_cfg=dict(cfg), **hk)
    assert th_.levels[-1].line_axis == 2
    b = assemble_rhs(tm, 2, f_gauss)
    # 15x a cycle: past three, f64 rounding of the 64:1 line blocks nears
    # 1e-10 of the residual
    _, rt = th_.solve(b, num_cycles=3)
    _, rj = jh_.solve(jnp.asarray(b), num_cycles=3)
    assert _rel(rt, rj) <= 1e-10
    assert th_.solve_pcg(b, rtol=1e-10)[1] == jh_.solve_pcg(
        jnp.asarray(b), rtol=1e-10)[1]


def test_grid_direct_matches_jax_and_single_device():
    from pmg_dolfinx_tpu.parallel import grid2d as jg
    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu_torch.models.poisson import f_rhs
    from pmg_dolfinx_tpu_torch.parallel import grid2d as tg
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    nc = (4, 4, 4)
    b = assemble_rhs(TBox(nc), 3, f_rhs(2.0))
    kw = dict(degrees=(1, 3), coarse="direct", sigma=0.5)
    grid = tg.GridPMG(TBox(nc), (2, 2, 2), dtype=torch.float64, device="cpu",
                      **kw)
    hier = PMGHierarchy(TBox(nc), dtype=torch.float64, device="cpu", **kw)
    jgrid = jg.GridPMG(JBox(nc), (2, 2, 2), dtype=jnp.float64, **kw)
    u, rn = grid.solve(b, num_cycles=5)
    _, rh = hier.solve(b, num_cycles=5)
    uj, rj = jgrid.solve(jnp.asarray(b), num_cycles=5)
    assert _rel(rn, rj) <= 1e-10 and _rel(rn, rh) <= 1e-10
    assert _rel_max(u, uj) <= 1e-10
    assert grid.solve_pcg(b, rtol=1e-6)[1] == jgrid.solve_pcg(
        jnp.asarray(b), rtol=1e-6)[1]
    with pytest.raises(NotImplementedError, match="item 10"):
        tg.GridPMG(TBox(nc), (2, 2), degrees=(1, 2), coarse="hmg",
                   device="cpu")


PMG_FLAGS = {
    "hmg": ["--coarse", "hmg", "--smoother", "schwarz", "--hmg-smoother",
            "line", "--semicoarsen", "auto"],
    "direct": ["--coarse", "direct", "--smoother", "schwarz"],
}
AMG_FLAGS = {mesh: ["--pc", "hmg", "--mesh", mesh]
             for mesh in ("box", "perturbed")}
AMG_FLAGS["linear"] = ["--pc", "hmg", "--kappa-field", "linear"]
PMG_COMMON = ["--ndofs", "3000", "--degrees", "1", "3", "--dtype", "f64",
              "--cycles", "4"]
AMG_COMMON = ["--ndofs", "3000", "--dtype", "f64"]


@pytest.fixture(scope="module")
def jax_drivers():
    """The JAX drivers' outputs for every case below, run side by side."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               OMP_NUM_THREADS="1")
    runs = {("pmg", k): ["pmg.py", "--cpu", *PMG_COMMON, *v]
            for k, v in PMG_FLAGS.items()}
    runs.update({("amg", k): ["amg.py", "--cpu", *AMG_COMMON, *v]
                 for k, v in AMG_FLAGS.items()})
    procs = {k: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / v[0]), *v[1:]],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env) for k, v in runs.items()}
    out = {}
    for k, proc in procs.items():
        out[k] = proc.communicate(timeout=300)[0]
        assert proc.returncode == 0, k
    return out


def _port_driver(name, argv, capsys):
    """Run a port driver's ``main(argv)`` in this process; its stdout."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    capsys.readouterr()
    mod.main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("case", list(PMG_FLAGS))
def test_pmg_driver_matches_jax_driver(case, jax_drivers, capsys):
    t = _port_driver("pmg_torch", ["--device", "cpu", *PMG_COMMON,
                                   *PMG_FLAGS[case]], capsys)
    lt, lj = (json.loads(o.strip().splitlines()[-1])
              for o in (t, jax_drivers[("pmg", case)]))
    assert abs(lt["rel_residual"] - lj["rel_residual"]) <= (
        1e-10 * lj["rel_residual"])
    assert abs(lt["l2_error"] - lj["l2_error"]) <= 1e-10 * lj["l2_error"]


@pytest.mark.parametrize("mesh", list(AMG_FLAGS))
def test_amg_driver_matches_jax_driver(mesh, jax_drivers, capsys):
    t = _port_driver("amg_torch", ["--device", "cpu", *AMG_COMMON,
                                   *AMG_FLAGS[mesh]], capsys)
    iters = [[line for line in o.splitlines() if line.startswith(
        "CG iterations")][0].split(",")[0]
        for o in (t, jax_drivers[("amg", mesh)])]
    assert iters[0] == iters[1]
