"""The port's transient family (`solvers.transient`) and its drivers against
the JAX package.

- A fault of the port, repaired: `FastDiagonalizationSolver.solve` casts
  the right-hand side to the solver's dtype (a float64 b given to a
  float32 solver raised in the port and returned float32 in JAX).
- `PMGHierarchy.operator()` and ``.ops`` (the handles the general-family
  steppers read) against JAX, f64 to 1e-12.
- The box evolvers in f64 to 1e-10 (`heat_fdm_evolve` BE/CN,
  `wave_newmark_evolve`, `wave_leapfrog_evolve`, with and without a
  time-dependent source) and `wave_stable_dt` to 1e-12; the serving
  evolvers (`heat_packed_evolve`, `wave_packed_evolve`, B in {1, 3}) in
  f32 to 1e-5.
- The general family on `PerturbedBoxMesh((3, 3, 3))` in f64: the port
  calibrates its own hierarchy; `heat_pcg_evolve` / `wave_pcg_evolve`
  take the same FCG counts and agree to 1e-8, `heat_pcg_evolve_scanned`
  agrees to 1e-8; `snapshot_evolve` matches one long run.
- Both drivers end to end on the CPU at ~3000 dofs (subprocess): every
  mode runs, the f64 box paths print the JAX evolvers' L2 error to 1e-8
  relative, and the JAX flags whose layers are not ported refuse with the
  ROADMAP item that brings them.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pmg_dolfinx_tpu.fem.mesh import BoxMesh as JBox  # noqa: E402
from pmg_dolfinx_tpu.fem.mesh import PerturbedBoxMesh as JPert  # noqa: E402
from pmg_dolfinx_tpu.solvers import transient as jt  # noqa: E402
from pmg_dolfinx_tpu.solvers.pmg import PMGHierarchy as JHier  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers import transient as tt  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
KAPPA = 2.0


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _mode(mesh, P):
    c = mesh.dof_coords(P)
    u = (np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
         * np.sin(np.pi * c[:, 2]))
    return np.where(mesh.boundary_dof_marker(P), 0.0, u)


def _ricker(t):
    a = (np.pi * 4.0 * (t - 0.25)) ** 2
    return (1.0 - 2.0 * a) * np.exp(-a)


def _source(mesh, P):
    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs

    return assemble_rhs(mesh, P, lambda x: np.exp(
        -sum((x[a] - 0.5) ** 2 for a in range(3)) / 0.02))


def test_fdm_solve_casts_rhs_dtype():
    """A float64 right-hand side given to a float32 solver: JAX casts it
    (`solvers/fdm.py:157`), the port raised in `torch.einsum`."""
    from pmg_dolfinx_tpu.solvers.fdm import FastDiagonalizationSolver as JF
    from pmg_dolfinx_tpu_torch.solvers.fdm import FastDiagonalizationSolver

    P = 3
    b = np.random.default_rng(0).standard_normal(BoxMesh((3, 3, 3)).num_dofs(P))
    js = JF(JBox((3, 3, 3)), P, kappa=KAPPA, dtype=jnp.float32, sigma=10.0)
    ts = FastDiagonalizationSolver(BoxMesh((3, 3, 3)), P, kappa=KAPPA,
                                   dtype=torch.float32, sigma=10.0,
                                   device="cpu")
    uj = js.solve(jnp.asarray(b))
    ut = ts.solve(torch.from_numpy(b))
    assert uj.dtype == jnp.float32 and ut.dtype == torch.float32
    assert _rel(ut, uj) <= 1e-6


@pytest.mark.parametrize("operator", ["lattice", "dofmap", "kron"])
def test_hierarchy_operator_matches_jax(operator):
    mesh_t = (BoxMesh((3, 3, 3)) if operator == "kron"
              else PerturbedBoxMesh((3, 3, 3)))
    mesh_j = JBox((3, 3, 3)) if operator == "kron" else JPert((3, 3, 3))
    kw = dict(degrees=(1, 3), kappa=KAPPA, sigma=40.0, coarse="smoother",
              operator=operator)
    th = PMGHierarchy(mesh_t, dtype=torch.float64, device="cpu", **kw)
    jh = JHier(mesh_j, dtype=jnp.float64, **kw)
    x = np.random.default_rng(1).standard_normal(mesh_t.num_dofs(3))
    y = th.operator()(torch.from_numpy(x))
    assert tuple(y.shape) == x.shape
    assert _rel(y, jh.operator()(jnp.asarray(x))) <= 1e-12
    x1 = x[:mesh_t.num_dofs(1)]
    assert _rel(th.operator(0)(torch.from_numpy(x1)),
                jh.operator(0)(jnp.asarray(x1))) <= 1e-12
    assert th.ops is th._ops and set(th.ops) >= {"apply", "dot", "zeros"}


def test_source_scales_and_kappa_guard():
    f = lambda t: np.cos(3.0 * t)
    for when in ("end", "mid", "start"):
        assert np.array_equal(tt.source_scales(f, 0.1, 5, when),
                              jt.source_scales(f, 0.1, 5, when))
    assert np.array_equal(tt.source_scales(None, 0.1, 4, "end"), np.ones(4))
    assert tt._half_kappa(3.0) == jt._half_kappa(3.0)
    assert tt._half_kappa((1.0, 2.0, 3.0)) == jt._half_kappa((1.0, 2.0, 3.0))
    u0 = _mode(BoxMesh((2, 2, 2)), 2)
    kw = dict(kappa=(1.0, 2.0, 3.0), dt=1e-2)
    assert _rel(tt.heat_fdm_evolve(BoxMesh((2, 2, 2)), 2, device="cpu",
                                   **kw)(u0, 2),
                jt.heat_fdm_evolve(JBox((2, 2, 2)), 2, **kw)(u0, 2)) <= 1e-10


@pytest.mark.parametrize("scheme", ["be", "cn"])
@pytest.mark.parametrize("P", [2, 3])
def test_heat_fdm_evolve_matches_jax(scheme, P):
    nc = (4, 3, 3)
    u0 = _mode(BoxMesh(nc), P)
    kw = dict(kappa=KAPPA, dt=2e-3, scheme=scheme)
    uj = jt.heat_fdm_evolve(JBox(nc), P, **kw)(u0, 4)
    ut = tt.heat_fdm_evolve(BoxMesh(nc), P, device="cpu", **kw)(u0, 4)
    assert ut.dtype == torch.float64 and tuple(ut.shape) == uj.shape
    assert _rel(ut, uj) <= 1e-10


def test_heat_fdm_evolve_with_source_matches_jax():
    nc, P = (3, 3, 3), 3
    f = _source(BoxMesh(nc), P)
    kw = dict(kappa=KAPPA, dt=5e-3, scheme="cn", f=f, f_time=_ricker)
    u0 = np.zeros(BoxMesh(nc).num_dofs(P))
    uj = jt.heat_fdm_evolve(JBox(nc), P, **kw)(u0, 5)
    ut = tt.heat_fdm_evolve(BoxMesh(nc), P, device="cpu", **kw)(u0, 5)
    assert _rel(ut, uj) <= 1e-10


@pytest.mark.parametrize("scheme", ["newmark", "leapfrog"])
@pytest.mark.parametrize("P", [2, 3])
def test_wave_box_evolvers_match_jax(scheme, P):
    nc = (3, 4, 3)
    mesh = BoxMesh(nc)
    u0 = _mode(mesh, P)
    v0 = 0.3 * u0
    dt = 0.5 * jt.wave_stable_dt(JBox(nc), P, kappa=KAPPA)
    if scheme == "newmark":
        jev = jt.wave_newmark_evolve(JBox(nc), P, kappa=KAPPA, dt=dt,
                                     gamma=0.6)
        tev = tt.wave_newmark_evolve(mesh, P, kappa=KAPPA, dt=dt, gamma=0.6,
                                     device="cpu")
    else:
        jev = jt.wave_leapfrog_evolve(JBox(nc), P, kappa=KAPPA, dt=dt)
        tev = tt.wave_leapfrog_evolve(mesh, P, kappa=KAPPA, dt=dt,
                                      device="cpu")
    (uj, vj), (ut, vt) = jev(u0, v0, 5), tev(u0, v0, 5)
    assert _rel(ut, uj) <= 1e-10 and _rel(vt, vj) <= 1e-10


@pytest.mark.parametrize("scheme", ["newmark", "leapfrog"])
def test_wave_box_evolvers_with_source_match_jax(scheme):
    nc, P = (3, 3, 3), 2
    mesh = BoxMesh(nc)
    f = _source(mesh, P)
    z = np.zeros(mesh.num_dofs(P))
    dt = 0.5 * jt.wave_stable_dt(JBox(nc), P, kappa=KAPPA)
    name = f"wave_{scheme}_evolve"
    kw = dict(kappa=KAPPA, dt=dt, f=f, f_time=_ricker)
    uj, vj = getattr(jt, name)(JBox(nc), P, **kw)(z, z, 4)
    ut, vt = getattr(tt, name)(mesh, P, device="cpu", **kw)(z, z, 4)
    assert _rel(ut, uj) <= 1e-10 and _rel(vt, vj) <= 1e-10
    with pytest.raises(ValueError, match="nsteps >= 1"):
        tt.wave_leapfrog_evolve(mesh, P, dt=dt, device="cpu")(z, z, 0)


@pytest.mark.parametrize("P", [2, 3, 6])
def test_wave_stable_dt_matches_jax(P):
    nc = (3, 2, 4)
    assert abs(tt.wave_stable_dt(BoxMesh(nc), P, kappa=KAPPA)
               / jt.wave_stable_dt(JBox(nc), P, kappa=KAPPA) - 1) <= 1e-12


def _batch0(mesh, P, B, seed=0):
    U0 = np.random.default_rng(seed).standard_normal(
        (B, mesh.num_dofs(P))).astype(np.float32)
    U0[:, mesh.boundary_dof_marker(P)] = 0.0
    return U0


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("scheme", ["be", "cn"])
def test_heat_packed_evolve_matches_jax(scheme, B):
    nc, P = (4, 4, 4), 3
    mesh = BoxMesh(nc)
    U0 = _batch0(mesh, P, B)
    kw = dict(kappa=KAPPA, dt=2e-3, B=B, scheme=scheme,
              f=_source(mesh, P) if scheme == "cn" else None,
              f_time=_ricker if scheme == "cn" else None)
    Uj = jt.heat_packed_evolve(JBox(nc), P, **kw)(U0, 5)
    Ut = tt.heat_packed_evolve(mesh, P, device="cpu", **kw)(U0, 5)
    assert Ut.dtype == torch.float32 and tuple(Ut.shape) == (B, U0.shape[1])
    assert _rel(Ut, Uj) <= 1e-5


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("scheme", ["newmark", "leapfrog"])
def test_wave_packed_evolve_matches_jax(scheme, B):
    nc, P = (3, 4, 4), 3
    mesh = BoxMesh(nc)
    U0 = _batch0(mesh, P, B)
    V0 = 0.5 * _batch0(mesh, P, B, seed=1)
    # A Python float: a numpy scalar dt would promote JAX's f32 carry to
    # f64 under x64.
    dt = float(0.72 * jt.wave_stable_dt(JBox(nc), P, kappa=KAPPA))
    kw = dict(kappa=KAPPA, dt=dt, B=B, scheme=scheme, f=_source(mesh, P),
              f_time=_ricker)
    Uj, Vj = jt.wave_packed_evolve(JBox(nc), P, **kw)(U0, V0, 6)
    Ut, Vt = tt.wave_packed_evolve(mesh, P, device="cpu", **kw)(U0, V0, 6)
    assert _rel(Ut, Uj) <= 1e-5 and _rel(Vt, Vj) <= 1e-5
    with pytest.raises(ValueError, match="scheme"):
        tt.wave_packed_evolve(mesh, P, scheme="euler", device="cpu")


def _curved_pair(sigma, kappa, coarse):
    kw = dict(degrees=(1, 3), kappa=kappa, sigma=sigma, coarse=coarse,
              operator="lattice")
    return (PMGHierarchy(PerturbedBoxMesh((3, 3, 3)), dtype=torch.float64,
                         device="cpu", **kw),
            JHier(JPert((3, 3, 3)), dtype=jnp.float64, **kw))


@pytest.mark.parametrize("scheme", ["be", "cn"])
def test_heat_pcg_evolve_matches_jax(scheme):
    P, dt = 3, 5e-3
    th, jh = _curved_pair(1.0 / dt, KAPPA / 2 if scheme == "cn" else KAPPA,
                          "cg")
    u0 = _mode(th.mesh, P)
    ut, it_t = tt.heat_pcg_evolve(th, th.mesh, P, dt, scheme=scheme,
                                  rtol=1e-10)(u0, 3)
    uj, it_j = jt.heat_pcg_evolve(jh, jh.mesh, P, dt, scheme=scheme,
                                  rtol=1e-10)(u0, 3)
    assert it_t == it_j
    assert _rel(ut, uj) <= 1e-8


def test_wave_pcg_evolve_matches_jax():
    P, dt, beta = 3, 0.02, 0.25
    th, jh = _curved_pair(1.0 / (beta * dt * dt), KAPPA, "cg")
    u0 = _mode(th.mesh, P)
    ut, vt, it_t = tt.wave_pcg_evolve(th, th.mesh, P, dt, gamma=0.6,
                                      rtol=1e-10)(u0, 0.2 * u0, 3)
    uj, vj, it_j = jt.wave_pcg_evolve(jh, jh.mesh, P, dt, gamma=0.6,
                                      rtol=1e-10)(u0, 0.2 * u0, 3)
    assert it_t == it_j
    assert _rel(ut, uj) <= 1e-8 and _rel(vt, vj) <= 1e-8


def test_heat_pcg_evolve_scanned_matches_jax():
    P, dt = 3, 2e-3
    th, jh = _curved_pair(1.0 / dt, KAPPA / 2, "smoother")
    u0 = _mode(th.mesh, P)
    f = _source(th.mesh, P)
    kw = dict(scheme="cn", inner_iters=4, f=f, f_time=_ricker)
    ut = tt.heat_pcg_evolve_scanned(th, th.mesh, P, dt, **kw)(u0, 3)
    uj = jt.heat_pcg_evolve_scanned(jh, jh.mesh, P, dt, **kw)(u0, 3)
    assert _rel(ut, uj) <= 1e-8
    hk = PMGHierarchy(BoxMesh((2, 2, 2)), degrees=(1, 2), kappa=KAPPA,
                      operator="kron", sigma=1.0 / dt, device="cpu")
    with pytest.raises(ValueError, match="kron"):
        tt.heat_pcg_evolve_scanned(hk, hk.mesh, 2, dt)


def test_fcg_solve_fixed_matches_while_loop():
    """The sync-free fixed-count FCG freezes at convergence like the
    JAX while_loop: the same iterate and count as `fcg_solve`."""
    from pmg_dolfinx_tpu_torch.solvers.cg import fcg_solve, fcg_solve_fixed

    rng = np.random.default_rng(3)
    Q = rng.standard_normal((12, 12))
    A = torch.from_numpy(Q @ Q.T + 12 * np.eye(12))
    b = torch.from_numpy(rng.standard_normal(12))
    Mv = lambda r: r / torch.diagonal(A)
    x0 = torch.zeros(12, dtype=torch.float64)
    xw, iw = fcg_solve(lambda x: A @ x, b, x0, Mv, rtol=1e-6, maxiter=30)
    xf, if_ = fcg_solve_fixed(lambda x: A @ x, b, x0, Mv, rtol=1e-6,
                              maxiter=30)
    assert int(if_["niter"]) == iw["niter"] < 30
    assert torch.equal(xf, xw)


def test_snapshot_evolve_matches_long_run():
    mesh, P, dt = BoxMesh((3, 3, 3)), 3, 0.01
    u0 = _mode(mesh, P)
    ev = tt.heat_fdm_evolve(mesh, P, kappa=KAPPA, dt=dt, device="cpu")
    snaps, uT = tt.snapshot_evolve(ev, u0, 7, 3)
    assert [s for s, _ in snaps] == [3, 6, 7]
    for step, u in snaps:
        assert torch.equal(u, ev(u0, step)), step
    assert torch.equal(uT, ev(u0, 7))
    wv = tt.wave_newmark_evolve(mesh, P, kappa=KAPPA, dt=dt, device="cpu")
    _, (uw, _) = tt.snapshot_evolve(wv, (u0, np.zeros_like(u0)), 6, 2)
    ur, _ = wv(u0, np.zeros_like(u0), 6)
    assert _rel(uw, ur) <= 1e-9
    with pytest.raises(ValueError, match="every"):
        tt.snapshot_evolve(ev, u0, 5, 0)


def _driver(name, *args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / name), "--device", "cpu",
         "--ndofs", "3000", "--degree", "3", "--steps", "6", *args],
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    return proc


def _jax_l2(evolve_out, P, nc, T, omega=None):
    from pmg_dolfinx_tpu.fem.assembly import l2_error

    lam = 3.0 * np.pi**2 * KAPPA
    amp = np.cos(omega * T) if omega else np.exp(-lam * T)
    u = np.asarray(evolve_out).reshape(-1)
    return l2_error(JBox(nc), P, u, lambda x: amp * np.sin(np.pi * x[0])
                    * np.sin(np.pi * x[1]) * np.sin(np.pi * x[2]))


@pytest.mark.parametrize("args", [
    ("--batch", "3"),
    ("--batch", "1", "--scheme", "be"),
    ("--mesh", "perturbed", "--dtype", "f64"),
    ("--mesh", "perturbed", "--fixed-iters", "3"),
])
def test_heat_driver_runs(args):
    proc = _driver("heat_torch.py", *args)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    # On the curved mesh heat_torch.py reports, as its JAX twin does, the
    # axis-aligned Gauss-Legendre norm (1.2362e-2 in both at this size).
    assert np.isfinite(out["l2_error"]) and out["l2_error"] < 0.05
    if "--mesh" in args and "--fixed-iters" not in args:
        assert "FCG iterations/step" in proc.stdout


def test_heat_driver_f64_matches_jax_evolve():
    """The f64 box path prints the JAX evolver's L2 error (1e-8)."""
    proc = _driver("heat_torch.py", "--dtype", "f64")
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])["l2_error"]
    nc = (4, 4, 4)  # fit_box_cells(3000, 3)
    mesh = JBox(nc)
    u0 = _mode(BoxMesh(nc), 3)
    uT = jt.heat_fdm_evolve(mesh, 3, kappa=KAPPA, dt=1e-3)(u0, 6)
    assert abs(got / _jax_l2(uT, 3, nc, 6e-3) - 1) <= 1e-8


@pytest.mark.parametrize("args", [
    ("--batch", "1", "--scheme", "leapfrog", "--dt", "0"),
    ("--batch", "3", "--scheme", "newmark"),
    ("--pulse", "4"),
    ("--mesh", "perturbed", "--dtype", "f64"),
])
def test_wave_driver_runs(args):
    proc = _driver("wave_torch.py", *args)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    key = "energy_T" if "--pulse" in args else "l2_error"
    assert np.isfinite(out[key])
    if "--dt" in args:
        assert "auto dt" in proc.stdout


def test_wave_driver_f64_matches_jax_evolve():
    proc = _driver("wave_torch.py", "--dtype", "f64", "--scheme",
                   "leapfrog", "--dt", "0")
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    nc = (4, 4, 4)
    dt = 0.72 * jt.wave_stable_dt(JBox(nc), 3, kappa=KAPPA)
    u0 = _mode(BoxMesh(nc), 3)
    uT, _ = jt.wave_leapfrog_evolve(JBox(nc), 3, kappa=KAPPA, dt=dt)(
        u0, np.zeros_like(u0), 6)
    want = _jax_l2(uT, 3, nc, 6 * dt, omega=np.pi * np.sqrt(3 * KAPPA))
    assert abs(out["l2_error"] / want - 1) <= 1e-8
    assert out["energy_drift"] < 1e-2


@pytest.mark.parametrize("name,flag,item", [
    ("heat_torch.py", ("--grade", "z:8", "--dtype", "f64"), None),
    ("wave_torch.py", ("--shards", "2"), "Queue 1 item 10"),
    ("heat_torch.py", ("--shards", "2"), "Queue 1 item 10"),
    ("heat_torch.py", ("--save-series", "out.vtk"), "Queue 1 item 11"),
])
def test_driver_refuses_unported_flags(name, flag, item):
    """The JAX driver flags whose layers the port lacks refuse with their
    ROADMAP item; ``--grade`` (ported) runs, and its f64 box path prints
    the JAX evolver's L2 error on the graded mesh (1e-8)."""
    proc = _driver(name, *flag)
    if item is not None:
        assert proc.returncode != 0 and item in proc.stderr
        return
    from pmg_dolfinx_tpu.fem.assembly import l2_error
    from pmg_dolfinx_tpu.fem.mesh import geometric_spacing

    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])["l2_error"]
    nc = (4, 4, 4)
    mesh = JBox(nc, spacing=(None, None, geometric_spacing(4, 8.0)))
    c = mesh.dof_coords(3)
    u0 = np.where(mesh.boundary_dof_marker(3), 0.0, np.sin(np.pi * c[:, 0])
                  * np.sin(np.pi * c[:, 1]) * np.sin(np.pi * c[:, 2]))
    uT = jt.heat_fdm_evolve(mesh, 3, kappa=KAPPA, dt=1e-3)(u0, 6)
    amp = np.exp(-3.0 * np.pi**2 * KAPPA * 6e-3)
    want = l2_error(mesh, 3, np.asarray(uT).reshape(-1), lambda x: amp * (
        np.sin(np.pi * x[0]) * np.sin(np.pi * x[1]) * np.sin(np.pi * x[2])))
    assert abs(got / want - 1) <= 1e-8
