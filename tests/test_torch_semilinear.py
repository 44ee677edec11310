"""The port's semilinear family (`models.semilinear`, `solvers.newton`,
`solvers.shardwrap`) against the JAX package, float64 on the CPU.

- The nonlinearities and the manufactured source equal JAX's bit for bit
  (the products in JAX's order; Bratu's ``torch.exp`` to 2 ulp of XLA's).
- `newton_solve` on the kron + fdm hierarchy (cubic with a sigma shift;
  Bratu at an absolute tolerance) and on curved hexes through the
  lattice backend: the same Newton and per-step FCG counts, ``fnorms``
  to 1e-9 relative (or, for the last iterates, within 1e-14 of ``|F_0|``:
  those norms are the rounding floor of the residual itself), solutions to
  1e-10. JAX's own oracle, the dense float64 Newton twin, holds the port
  to 1e-9.
- `solvers.shardwrap` on one device and on a `GridPMG` (which it once
  refused). The sharded JAX case ``test_newton_sharded_matches_single``
  (slab and grid) is ported in `tests/test_torch_dist_solvers.py`.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pmg_dolfinx_tpu.fem.assembly import assemble_rhs  # noqa: E402
from pmg_dolfinx_tpu.fem.mesh import BoxMesh as JBox  # noqa: E402
from pmg_dolfinx_tpu.fem.mesh import PerturbedBoxMesh as JPert  # noqa: E402
from pmg_dolfinx_tpu.models import semilinear as js  # noqa: E402
from pmg_dolfinx_tpu.solvers.newton import newton_solve as jnewton  # noqa: E402
from pmg_dolfinx_tpu.solvers.pmg import PMGHierarchy as JHier  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.assembly import (  # noqa: E402
    assemble_stiffness,
    lumped_mass_np,
)
from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh, PerturbedBoxMesh  # noqa: E402
from pmg_dolfinx_tpu_torch.models import semilinear as ts  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers import shardwrap  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers.newton import newton_solve  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy  # noqa: E402

KAPPA, SIGMA = 2.0, 0.7


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _same_fnorms(ft, fj):
    ft, fj = np.asarray(ft), np.asarray(fj)
    assert ft.shape == fj.shape
    assert np.all(np.abs(ft - fj) <= 1e-9 * fj + 1e-14 * fj[0]), (ft, fj)


def test_nonlinearities_match_jax_bitwise():
    u = np.random.default_rng(0).standard_normal(50)
    x = np.random.default_rng(1).random((3, 40))
    for tn, jn in ((ts.cubic(5.0), js.cubic(5.0)),
                   (ts.bratu(3.0), js.bratu(3.0))):
        assert tn.name == jn.name
        for attr in ("N", "dN"):
            got = getattr(tn, attr)(torch.tensor(u)).numpy()
            want = np.asarray(getattr(jn, attr)(u))
            if tn.name.startswith("cubic"):
                assert np.array_equal(got, want)
            else:  # torch.exp and XLA's exp differ in the last bit
                assert np.max(np.abs(got / want - 1)) <= 4.5e-16
        for attr in ("N_np", "dN_np"):
            assert np.array_equal(getattr(tn, attr)(u), getattr(jn, attr)(u))
        assert np.array_equal(ts.f_rhs_semilinear(KAPPA, tn, SIGMA)(x),
                              js.f_rhs_semilinear(KAPPA, jn, SIGMA)(x))


def _dense_newton(mesh, P, sigma, nonlin, b, tol=1e-13, maxiter=40):
    """JAX's oracle: float64 host Newton with sparse-LU steps."""
    A = assemble_stiffness(mesh, P, kappa=KAPPA, bc=True).tocsr()
    m3 = lumped_mass_np(mesh, P, bc_zero=True)
    A = A + sigma * sp.diags(m3)
    u = np.zeros_like(b)
    for _ in range(maxiter):
        F = A @ u + m3 * nonlin.N_np(u) - b
        if np.linalg.norm(F) < tol:
            break
        u = u + spla.spsolve((A + sp.diags(m3 * nonlin.dN_np(u))).tocsc(),
                             -F)
    return u


@pytest.mark.parametrize("model", ["cubic", "bratu"])
def test_newton_kron_matches_jax(model):
    nc, P = (4, 3, 4), 3
    kw = dict(degrees=(1, 3), kappa=KAPPA, coarse="fdm", operator="kron",
              sigma=SIGMA)
    if model == "cubic":
        tn, jn = ts.cubic(5.0), js.cubic(5.0)
        b = assemble_rhs(JBox(nc), P, js.f_rhs_semilinear(KAPPA, jn,
                                                           sigma=SIGMA))
        tol = dict(rtol=1e-9)
    else:
        tn, jn = ts.bratu(5.0), js.bratu(5.0)
        b = np.zeros(JBox(nc).num_dofs(P))
        tol = dict(rtol=0.0, atol=1e-11)
    uj, ij = jnewton(JHier(JBox(nc), **kw), b, jn, **tol)
    ut, it = newton_solve(PMGHierarchy(BoxMesh(nc), device="cpu", **kw), b,
                          tn, **tol)
    assert it["converged"] and ij["converged"]
    assert it["niter"] == ij["niter"] and it["lin_iters"] == ij["lin_iters"]
    _same_fnorms(it["fnorms"], ij["fnorms"])
    assert ut.dtype == torch.float64 and tuple(ut.shape) == b.shape
    assert _rel(ut, uj) <= 1e-10
    u_ref = _dense_newton(BoxMesh(nc), P, SIGMA, tn, b)
    assert _rel(ut, u_ref) <= 1e-9


def test_newton_curved_lattice_matches_jax():
    """Curved hexes through the lattice backend with the direct coarse
    solve, a fixed inner tolerance and damping (JAX's general-family
    case), on a seeded rhs."""
    nc, P = (3, 3, 3), 3
    kw = dict(degrees=(1, 3), kappa=KAPPA, coarse="direct",
              operator="lattice", sigma=SIGMA)
    b = np.random.default_rng(3).standard_normal(JPert(nc).num_dofs(P))
    b[JPert(nc).boundary_dof_marker(P)] = 0.0
    tol = dict(rtol=1e-10, lin_rtol=1e-6, damping=0.9, maxiter=30)
    uj, ij = jnewton(JHier(JPert(nc), **kw), b, js.cubic(4.0), **tol)
    ut, it = newton_solve(PMGHierarchy(PerturbedBoxMesh(nc), device="cpu",
                                       **kw), b, ts.cubic(4.0), **tol)
    assert it["converged"] and it["lin_iters"] == ij["lin_iters"]
    _same_fnorms(it["fnorms"], ij["fnorms"])
    assert _rel(ut, uj) <= 1e-10


def test_newton_temporaries_on_one_hierarchy_and_exhaustion():
    """Two temporary nonlinearities in a row on one hierarchy each solve
    their own problem (no state keyed on a freed object survives a call),
    and an exhausted loop records its final residual."""
    nc = (2, 2, 2)

    def hier():
        return PMGHierarchy(BoxMesh(nc), degrees=(1, 2), kappa=KAPPA,
                            coarse="fdm", operator="kron", device="cpu")

    b = np.ones(BoxMesh(nc).num_dofs(2))
    b[BoxMesh(nc).boundary_dof_marker(2)] = 0.0
    _, info = newton_solve(hier(), b, ts.cubic(5.0), maxiter=1)
    assert len(info["fnorms"]) == 2 and info["niter"] == 1
    assert not info["converged"]
    cs = (1.0, 5.0, 2.0, 3.0)
    shared, us = hier(), []
    for c in cs:
        u, _ = newton_solve(shared, b, ts.cubic(c), rtol=1e-12)
        us.append(u)
    for u, c in zip(us, cs):
        assert torch.equal(u, newton_solve(hier(), b, ts.cubic(c),
                                           rtol=1e-12)[0])
    assert _rel(us[1], us[0]) > 1e-3


def test_shardwrap_one_device_and_grid_refusal():
    from pmg_dolfinx_tpu_torch.parallel.grid2d import GridPMG

    hier = PMGHierarchy(BoxMesh((2, 2, 2)), degrees=(1, 2), operator="kron",
                        coarse="fdm", device="cpu")
    assert not shardwrap.is_sharded(hier)
    assert shardwrap.shards_of(hier) == (1, 1, 1)
    assert shardwrap.axis_exchanges(hier) == (None, None, None)
    to_w, from_w = shardwrap.layout_converters(hier)
    v = torch.arange(hier.levels[-1].ndofs, dtype=torch.float64)
    assert tuple(to_w(v).shape) == hier.levels[-1].shape
    assert torch.equal(from_w(to_w(v)), v)
    # the grid is no longer refused: its shards, its x exchange, its
    # stacked layout, and Newton on it (a zero rhs: u = 0 at once)
    grid = GridPMG(BoxMesh((4, 4, 4)), (2, 1, 1), degrees=(1, 2),
                   operator="kron", coarse="fdm", device="cpu")
    assert shardwrap.is_sharded(grid)
    assert shardwrap.shards_of(grid) == (2, 1, 1)
    ex = shardwrap.axis_exchanges(grid)
    assert callable(ex[0]) and ex[1] is None and ex[2] is None
    to_w, from_w = shardwrap.layout_converters(grid)
    v = torch.arange(BoxMesh((4, 4, 4)).num_dofs(2), dtype=torch.float64)
    assert torch.equal(from_w(to_w(v)), v)
    u, info = newton_solve(grid, np.zeros(BoxMesh((4, 4, 4)).num_dofs(2)),
                           ts.cubic(1.0))
    assert info["converged"] and not bool(u.abs().max())


def _driver(*args):
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, str(root / "examples" / "nonlinear_torch.py"),
         "--device", "cpu", "--ndofs", "3000", *args],
        capture_output=True, text=True, timeout=600, cwd=root, env=env)


def test_nonlinear_driver_f64_matches_jax_newton():
    """``nonlinear_torch.py --dtype f64`` (JAX's flags) prints the JAX
    `newton_solve`'s L2 error and inner counts at the same problem."""
    import json

    from pmg_dolfinx_tpu.fem.assembly import l2_error
    from pmg_dolfinx_tpu.models.poisson import fit_box_cells, u_exact

    proc = _driver("--dtype", "f64")
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    nc = fit_box_cells(3000, 3)
    jn = js.cubic(5.0)
    b = assemble_rhs(JBox(nc), 3, js.f_rhs_semilinear(KAPPA, jn))
    uj, ij = jnewton(JHier(JBox(nc), degrees=(1, 3), kappa=KAPPA,
                           coarse="fdm", operator="kron"), b, jn)
    assert out["lin_iters"] == ij["lin_iters"] and out["converged"]
    want = l2_error(JBox(nc), 3, np.asarray(uj), u_exact)
    assert abs(out["l2_error"] / want - 1) <= 1e-8


@pytest.mark.parametrize("args", [
    ("--model", "bratu", "--dtype", "f64"),
    ("--transient", "--batch", "3", "--steps", "6"),
    ("--transient", "--implicit", "--steps", "2", "--dtype", "f64"),
    ("--transient", "--scheme", "be", "--steps", "6"),
])
def test_nonlinear_driver_modes_run(args):
    import json

    proc = _driver(*args)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert all(np.isfinite(v) for v in out.values()
               if isinstance(v, float))
    if "bratu" in args:
        assert out["converged"] and out["max_u"] > 0
