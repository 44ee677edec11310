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


def test_load_state_checks_shapes():
    hier = PMGHierarchy(BoxMesh((2, 2, 2)), degrees=(1, 2), device="cpu")
    bad = {"levels": [{"diag_inv": torch.ones(3)}], "transfer": []}
    with pytest.raises(ValueError, match="levels\\[0\\].diag_inv"):
        hier.load_state(bad)


@pytest.mark.parametrize("kwargs,match", [
    (dict(operator="csr"), "Queue 1 items 6 and 8"),
    (dict(coarse="hmg"), "Queue 1 items 4"),
    (dict(smoother="line"), "Queue 1 item 7"),
    (dict(coarse_cfg={"gamma": 2}), "Queue 1 item 7"),
    (dict(precision="high"), "Queue 1 item 1"),
])
def test_unported_options_raise(kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        PMGHierarchy(BoxMesh((2, 2, 2)), degrees=(1, 2), device="cpu",
                     **kwargs)


def test_unported_solves_raise():
    hier = PMGHierarchy(BoxMesh((2, 2, 2)), degrees=(1, 2), device="cpu")
    b = torch.ones(hier.levels[-1].ndofs, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="FMG"):
        hier.solve(b, fmg=True)
    with pytest.raises(NotImplementedError, match="FMG"):
        hier.solve_pcg(b, fmg=True)
    with pytest.raises(NotImplementedError, match="solve_refined"):
        hier.solve_refined(b)
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
