"""End-to-end parity of the port's p-multigrid solve with the JAX package.

- ``operator="kron"``, float64 (all-Dirichlet, and mixed faces with a
  sigma shift): the port builds and calibrates its own hierarchy; its 6-cycle residual trajectory agrees with the JAX one to
  <= 1e-10 relative per cycle, the FCG(V) count at rtol 1e-6 is equal,
  and the L2 errors agree to <= 1e-10 relative.
- ``operator="kron_blocked"``, float32 (the kernels' plain torch versions
  on the CPU against the JAX emulation): the JAX hierarchy state is
  carried into the port (`utils.convert`, `PMGHierarchy.load_state`), so
  the cycles run on identical state; the trajectory agrees to <= 1e-4
  relative and the FCG count is equal. Four cycles, as the JAX package's
  own f32 kron_blocked-vs-kron test: beyond them the f32 residual nears
  its rounding floor, where the two summation orders differ by more.
- ``v_cycle(..., diagnostics=True)`` and ``PMGHierarchy.apply(b, u,
  diagnostics=True)`` (the JAX package's ``tests/test_pmg.py``
  ``test_vcycle_diagnostics``): the per-level ``pre``/``post`` residual
  norms equal JAX's to 1e-10 relative on ``dofmap``, ``lattice`` and
  ``kron`` (f64, 2 and 3 levels), to 1e-4 with the fused Chebyshev
  smoother of ``kron_blocked`` on JAX's state (f32); a W-cycle raises.
- The example driver runs end to end on the CPU.
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

from pmg_dolfinx_tpu.fem.mesh import BoxMesh as JBoxMesh  # noqa: E402
from pmg_dolfinx_tpu.models.poisson import PoissonProblem as JProblem  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh  # noqa: E402
from pmg_dolfinx_tpu_torch.models.poisson import PoissonProblem as TProblem  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy  # noqa: E402
from pmg_dolfinx_tpu_torch.utils.convert import hierarchy_data_from_numpy  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.abs(b)


MIXED = ((True, False), (True, True), (False, True))


@pytest.mark.parametrize("nc,degrees,coarse,faces,sigma", [
    ((4, 4, 4), (1, 3), "fdm", True, 0.0),
    ((4, 4, 4), (1, 3), "cg", True, 0.0),
    ((4, 4, 4), (1, 3, 6), "fdm", True, 0.0),
    ((4, 4, 4), (1, 3, 6), "cg", True, 0.0),
    ((3, 4, 5), (1, 3), "fdm", True, 0.0),
    ((3, 4, 5), (1, 3), "fdm", MIXED, 0.5),
    ((3, 4, 5), (1, 3), "smoother", MIXED, 0.5),
])
def test_kron_f64_matches_jax(nc, degrees, coarse, faces, sigma):
    """Also mixed Dirichlet/Neumann faces with a lumped-mass shift
    (sigma): per-axis FDM trims and separable masks on a non-cubic box."""
    kw = dict(nc=nc, degrees=degrees, kappa=2.0, coarse=coarse,
              operator="kron", sigma=sigma)
    jp = JProblem(dtype=jnp.float64,
                  mesh=JBoxMesh(nc, dirichlet_faces=faces), **kw)
    tp = TProblem(dtype=torch.float64, device="cpu",
                  mesh=BoxMesh(nc, dirichlet_faces=faces), **kw)
    for et, ej in zip(tp.hierarchy.eigs, jp.hierarchy.eigs):
        assert np.max(_rel(et, ej)) <= 1e-10
    uj, rj = jp.solve(num_cycles=6)
    ut, rt = tp.solve(num_cycles=6)
    assert len(rt) == 6
    assert np.max(_rel(rt, rj)) <= 1e-10
    assert np.max(_rel(tp.error_l2(ut), jp.error_l2(uj))) <= 1e-10
    _, nj = jp.hierarchy.solve_pcg(jp.b, rtol=1e-6)
    ut, nt = tp.hierarchy.solve_pcg(tp.b, rtol=1e-6)
    assert nt == nj
    assert ut.shape == (tp.mesh.num_dofs(degrees[-1]),)


@pytest.mark.parametrize("degrees", [(1, 3), (1, 3, 6)])
def test_kron_blocked_f32_with_jax_state(degrees):
    kw = dict(nc=(4, 4, 4), degrees=degrees, kappa=2.0, coarse="fdm",
              operator="kron_blocked")
    jp = JProblem(dtype=jnp.float32, **kw)
    tp = TProblem(dtype=torch.float32, device="cpu", **kw)
    # the port's own f32 calibration is close to, not equal to, JAX's
    lm_t = [float(lv["lmax"]) for lv in tp.hierarchy.data["levels"]]
    lm_j = [float(lv["lmax"]) for lv in jp.hierarchy.data["levels"]]
    assert np.max(_rel(lm_t, lm_j)) <= 1e-4
    tp.hierarchy.load_state(hierarchy_data_from_numpy(
        jax.tree.map(np.asarray, jp.hierarchy.data), "cpu", torch.float32))
    assert [float(lv["lmax"]) for lv in tp.hierarchy.data["levels"]] == lm_j
    _, rj = jp.solve(num_cycles=4)
    _, rt = tp.solve(num_cycles=4)
    assert np.max(_rel(rt, rj)) <= 1e-4
    _, nj = jp.hierarchy.solve_pcg(jp.b, rtol=1e-6)
    _, nt = tp.hierarchy.solve_pcg(tp.b, rtol=1e-6)
    assert nt == nj


@pytest.mark.parametrize("operator,degrees", [
    ("dofmap", (1, 3)), ("lattice", (1, 3)), ("kron", (1, 3)),
    ("dofmap", (1, 2, 3)), ("kron", (1, 2, 4)),
])
def test_vcycle_diagnostics_match_jax(operator, degrees):
    kw = dict(nc=(4, 4, 4), degrees=degrees, kappa=2.0, operator=operator)
    jp = JProblem(**kw)
    tp = TProblem(dtype=torch.float64, device="cpu", **kw)
    uj, dj = jp.hierarchy.apply(jp.b, jnp.zeros_like(jp.b), diagnostics=True)
    ut, dt = tp.hierarchy.apply(tp.b, torch.zeros_like(tp.b),
                                diagnostics=True)
    assert len(dt["pre"]) == len(dt["post"]) == len(degrees) - 1
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0
               for v in dt["pre"] + dt["post"])
    for key in ("pre", "post"):
        assert np.max(_rel([float(v) for v in dt[key]],
                           [float(v) for v in dj[key]])) <= 1e-10
    assert float(dt["post"][-1]) < float(dt["pre"][0])
    assert np.max(np.abs(ut.numpy() - np.asarray(uj))) <= 1e-10 * np.max(
        np.abs(np.asarray(uj)))
    # the same cycle without diagnostics
    assert torch.equal(tp.hierarchy.apply(tp.b, torch.zeros_like(tp.b)), ut)


def test_vcycle_diagnostics_fused_smoother_with_jax_state():
    """``ops["smooth"]`` is the fused Chebyshev kernel's plain version here
    (#4/#7 on the card): the lists follow JAX's on the same state."""
    from pmg_dolfinx_tpu.solvers.pmg import PMGHierarchy as JHierarchy

    kw = dict(degrees=(1, 3, 6), kappa=2.0, coarse="fdm",
              operator="kron_blocked", fuse_smoother=True)
    jh = JHierarchy(JBoxMesh((4, 4, 4)), dtype=jnp.float32, **kw)
    th = PMGHierarchy(BoxMesh((4, 4, 4)), dtype=torch.float32, device="cpu",
                      **kw)
    th.load_state(hierarchy_data_from_numpy(
        jax.tree.map(np.asarray, jh.data), "cpu", torch.float32))
    b = np.random.default_rng(3).standard_normal(th.levels[-1].ndofs)
    b[BoxMesh((4, 4, 4)).boundary_dof_marker(6)] = 0.0
    _, dj = jh.apply(jnp.asarray(b, jnp.float32),
                     jnp.zeros(b.size, jnp.float32), diagnostics=True)
    _, dt = th.apply(torch.tensor(b, dtype=torch.float32),
                     torch.zeros(b.size), diagnostics=True)
    for key in ("pre", "post"):
        assert len(dt[key]) == 2
        assert np.max(_rel([float(v) for v in dt[key]],
                           [float(v) for v in dj[key]])) <= 1e-4


def test_vcycle_diagnostics_w_cycle_raises():
    from pmg_dolfinx_tpu_torch.solvers.pmg import v_cycle

    hier = PMGHierarchy(BoxMesh((2, 2, 2)), degrees=(1, 2, 3),
                        coarse_cfg={"gamma": 2}, device="cpu")
    b = torch.ones(hier.levels[-1].ndofs, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="V-cycle only"):
        hier.apply(b, torch.zeros_like(b), diagnostics=True)
    with pytest.raises(NotImplementedError, match="V-cycle only"):
        v_cycle(hier.data, b, torch.zeros_like(b), levels=hier.levels,
                coarse=hier.coarse, coarse_cfg=hier.coarse_cfg,
                ops=hier.ops, diagnostics=True)
    # without diagnostics the W-cycle runs
    assert torch.isfinite(hier.apply(b, torch.zeros_like(b))).all()


def test_load_state_checks_shapes():
    hier = PMGHierarchy(BoxMesh((2, 2, 2)), degrees=(1, 2), device="cpu")
    bad = {"levels": [{"diag_inv": torch.ones(3)}], "transfer": []}
    with pytest.raises(ValueError, match="levels\\[0\\].diag_inv"):
        hier.load_state(bad)


# The refusals of options ported since: they now build and cycle.
_PORTED = ("Queue 1 items 6 and 8", "Queue 1 item 1")


@pytest.mark.parametrize("kwargs,match", [
    (dict(operator="csr"), "Queue 1 items 6 and 8"),
    (dict(coarse="hmg"), None),
    (dict(smoother="line"), None),
    (dict(smoother="schwarz"), None),
    (dict(precision="high"), "Queue 1 item 1"),
])
def test_unported_options_raise(kwargs, match):
    """The options still to port raise naming their ROADMAP item; those
    ported since (``match`` None: the h-multigrid coarse solve, the line
    and Schwarz smoothers; or a refusal in `_PORTED`: the assembled
    ``csr`` operator of items 6 and 8, ``precision="high"`` of item 1)
    build and cycle as the JAX package does (f64: eigenvalue estimates to
    1e-12, 3 cycles to 1e-10)."""
    if match is not None and match not in _PORTED:
        with pytest.raises(NotImplementedError, match=match):
            PMGHierarchy(BoxMesh((2, 2, 2)), degrees=(1, 2), device="cpu",
                         **kwargs)
        return
    from pmg_dolfinx_tpu.solvers.pmg import PMGHierarchy as JHierarchy

    hier = PMGHierarchy(BoxMesh((2, 2, 2)), degrees=(1, 2), device="cpu",
                        **kwargs)
    jhier = JHierarchy(JBoxMesh((2, 2, 2)), degrees=(1, 2), **kwargs)
    for et, ej in zip(hier.eigs, jhier.eigs):
        assert np.max(_rel(et, ej)) <= 1e-12
    b = np.random.default_rng(2).standard_normal(hier.levels[-1].ndofs)
    _, rt = hier.solve(b, num_cycles=3)
    _, rj = jhier.solve(jnp.asarray(b), num_cycles=3)
    assert np.max(_rel(rt, rj)) <= 1e-10


def test_unported_solves_raise():
    """The solve modes that once raised here (FMG, ``solve_refined``) run;
    the f32-only guard of the kernel backend stays."""
    hier = PMGHierarchy(BoxMesh((2, 2, 2)), degrees=(1, 2), device="cpu")
    b = torch.ones(hier.levels[-1].ndofs, dtype=torch.float64)
    _, rn = hier.solve(b, num_cycles=2, fmg=True)
    assert len(rn) == 2 and rn[1] < rn[0]
    assert hier.solve_pcg(b, fmg=True)[1] >= 0
    u, rn = hier.solve_refined(b, num_cycles=3)
    assert u.dtype == torch.float64 and len(rn) == 3 and rn[2] < rn[0]
    with pytest.raises(ValueError, match="f32-only"):
        PMGHierarchy(BoxMesh((2, 2, 2)), degrees=(1, 2), device="cpu",
                     operator="kron_blocked", dtype=torch.float64)


def test_example_driver_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "pmg_torch.py"),
         "--device", "cpu", "--ndofs", "3000", "--degrees", "1", "3",
         "--coarse", "fdm", "--operator", "kron_blocked", "--pcg"],
        capture_output=True, text=True, timeout=300, check=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    ).stdout
    assert "FCG(V-cycle) converged in" in out
    last = json.loads(out.strip().splitlines()[-1])
    assert last["rel_residual"] is None
    assert 0.0 < last["l2_error"] < 1e-2
