"""The curved-hex (general) family end to end against the JAX package.

- Two faults of the port, repaired: `PMGHierarchy`'s default operator is
  JAX's ('dofmap'), and `PoissonProblem.error_l2` uses the collocated
  rule on a general mesh (against JAX to 1e-10), with ``u_exact=``.
- Hierarchies on `PerturbedBoxMesh((3, 3, 3))`, degrees (1, 3):
  'dofmap' and 'lattice' in f64, coarse 'cg' and 'smoother' (also a
  sigma shift on mixed faces): the port calibrates its own hierarchy;
  trajectories agree with JAX to 1e-10 relative, FCG counts are equal.
  'lattice_blocked' in f32 on JAX's state (`utils.convert`,
  `load_state`): 4 cycles agree to 1e-4 relative (the JAX package's own
  f32 bound), FCG counts differ by at most 1.
- JAX state carried through `utils.convert` gives the same f64 V-cycle
  to 1e-12.
- The drivers run end to end on the CPU at ~20k dofs.
"""

import inspect
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

from pmg_dolfinx_tpu.fem.mesh import PerturbedBoxMesh as JMesh  # noqa: E402
from pmg_dolfinx_tpu.models.poisson import PoissonProblem as JProblem  # noqa: E402
from pmg_dolfinx_tpu.solvers.pmg import PMGHierarchy as JHierarchy  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh as TMesh  # noqa: E402
from pmg_dolfinx_tpu_torch.models.poisson import PoissonProblem as TProblem  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy  # noqa: E402
from pmg_dolfinx_tpu_torch.utils.convert import hierarchy_data_from_numpy  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
NC = (3, 3, 3)
MIXED = ((True, False), (True, True), (False, True))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.abs(b)


def _state(jp, dtype):
    return hierarchy_data_from_numpy(jax.tree.map(np.asarray, jp.hierarchy.data),
                                     "cpu", dtype)


def test_default_operator_matches_jax():
    """The port built kron where JAX builds dofmap for the same call."""
    d_t = inspect.signature(PMGHierarchy).parameters["operator"].default
    d_j = inspect.signature(JHierarchy).parameters["operator"].default
    assert d_t == d_j == "dofmap"
    hier = PMGHierarchy(TMesh((2, 2, 2)), degrees=(1, 2), device="cpu")
    assert hier.operator_kind == "dofmap"
    assert "dofmap" in hier.data["levels"][0]


def test_error_l2_on_curved_mesh_matches_jax():
    """On a general mesh the Gauss-Legendre rule assumes affine axis-aligned
    cells; the port used it anyway and returned a wrong number."""
    kw = dict(degrees=(1, 3), kappa=2.0, coarse="cg", operator="lattice")
    jp = JProblem(mesh=JMesh(NC), dtype=jnp.float64, **kw)
    tp = TProblem(mesh=TMesh(NC), dtype=torch.float64, device="cpu", **kw)
    u = np.random.default_rng(0).standard_normal(tp.mesh.num_dofs(3))
    assert _rel(tp.error_l2(torch.tensor(u)), jp.error_l2(u)) <= 1e-10
    # the affine rule on the same mesh gives another number
    from pmg_dolfinx_tpu_torch.fem.assembly import l2_error

    affine = l2_error(tp.mesh, 3, u, lambda x: 0.0 * x[0])
    assert abs(tp.error_l2(torch.tensor(u)) - affine) > 1e-6
    # u_exact= overrides the manufactured solution
    ue = lambda x: x[0] * x[1]
    jq = JProblem(mesh=JMesh(NC), dtype=jnp.float64, u_exact=ue, **kw)
    tq = TProblem(mesh=TMesh(NC), dtype=torch.float64, device="cpu",
                  u_exact=ue, **kw)
    assert _rel(tq.error_l2(torch.tensor(u)), jq.error_l2(u)) <= 1e-10


@pytest.mark.parametrize("operator,coarse,faces,sigma", [
    ("dofmap", "cg", True, 0.0),
    ("dofmap", "smoother", True, 0.0),
    ("lattice", "cg", True, 0.0),
    ("lattice", "smoother", True, 0.0),
    ("lattice", "cg", MIXED, 0.5),
    ("dofmap", "smoother", MIXED, 0.5),
])
def test_hierarchy_f64_matches_jax(operator, coarse, faces, sigma):
    kw = dict(degrees=(1, 3), kappa=2.0, coarse=coarse, operator=operator,
              sigma=sigma)
    jp = JProblem(mesh=JMesh(NC, dirichlet_faces=faces), dtype=jnp.float64,
                  **kw)
    tp = TProblem(mesh=TMesh(NC, dirichlet_faces=faces), dtype=torch.float64,
                  device="cpu", **kw)
    for et, ej in zip(tp.hierarchy.eigs, jp.hierarchy.eigs):
        assert np.max(_rel(et, ej)) <= 1e-10
    uj, rj = jp.solve(num_cycles=6)
    ut, rt = tp.solve(num_cycles=6)
    assert len(rt) == 6
    assert np.max(_rel(rt, rj)) <= 1e-10
    assert _rel(tp.error_l2(ut), jp.error_l2(uj)) <= 1e-10
    _, nj = jp.hierarchy.solve_pcg(jp.b, rtol=1e-6)
    ut, nt = tp.hierarchy.solve_pcg(tp.b, rtol=1e-6)
    assert nt == nj
    assert ut.shape == (tp.mesh.num_dofs(3),)


@pytest.mark.parametrize("coarse", ["cg", "smoother"])
def test_lattice_blocked_f32_with_jax_state(coarse):
    kw = dict(degrees=(1, 3), kappa=2.0, coarse=coarse,
              operator="lattice_blocked")
    jp = JProblem(mesh=JMesh(NC), dtype=jnp.float32, **kw)
    tp = TProblem(mesh=TMesh(NC), dtype=torch.float32, device="cpu", **kw)
    lm_t = [float(lv["lmax"]) for lv in tp.hierarchy.data["levels"]]
    lm_j = [float(lv["lmax"]) for lv in jp.hierarchy.data["levels"]]
    assert np.max(_rel(lm_t, lm_j)) <= 1e-4
    tp.hierarchy.load_state(_state(jp, torch.float32))
    assert [float(lv["lmax"]) for lv in tp.hierarchy.data["levels"]] == lm_j
    _, rj = jp.solve(num_cycles=4)
    _, rt = tp.solve(num_cycles=4)
    assert np.max(_rel(rt, rj)) <= 1e-4
    _, nj = jp.hierarchy.solve_pcg(jp.b, rtol=1e-6)
    _, nt = tp.hierarchy.solve_pcg(tp.b, rtol=1e-6)
    assert abs(nt - nj) <= 1


@pytest.mark.parametrize("operator", ["dofmap", "lattice"])
def test_convert_carries_state_f64(operator):
    """Every array of the JAX hierarchy (dofmaps, G, transfers, diag_inv,
    lmax, m3) lands in the port; one V-cycle then agrees to 1e-12."""
    kw = dict(degrees=(1, 3), kappa=2.0, coarse="cg", operator=operator,
              sigma=0.5)
    jp = JProblem(mesh=JMesh(NC), dtype=jnp.float64, **kw)
    tp = TProblem(mesh=TMesh(NC), dtype=torch.float64, device="cpu", **kw)
    state = _state(jp, torch.float64)
    for lv_t, lv_j in zip(tp.hierarchy.data["levels"], state["levels"]):
        assert lv_t.keys() == lv_j.keys()
    if operator == "dofmap":
        assert state["levels"][0]["dofmap"].dtype == torch.int64
        assert state["transfer"][0]["dofmap_f"].dtype == torch.int64
    tp.hierarchy.load_state(state)
    u = np.random.default_rng(1).standard_normal(tp.mesh.num_dofs(3))
    v_j = np.asarray(jp.hierarchy.apply(jp.b, jnp.asarray(u)))
    v_t = tp.hierarchy.apply(tp.b, torch.tensor(u)).numpy()
    assert np.linalg.norm(v_t - v_j) / np.linalg.norm(v_j) <= 1e-12


def test_general_family_guards():
    tm = TMesh((2, 2, 2))
    with pytest.raises(ValueError, match="axis-aligned"):
        PMGHierarchy(tm, degrees=(1, 2), operator="kron", device="cpu")
    with pytest.raises(ValueError, match="axis-aligned"):
        PMGHierarchy(tm, degrees=(1, 2), coarse="fdm", device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        PMGHierarchy(tm, degrees=(1, 2), sigma=lambda x: x[0],
                     device="cpu")
    with pytest.raises(ValueError, match="f32-only"):
        PMGHierarchy(tm, degrees=(1, 2), operator="lattice_blocked",
                     dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="unknown operator"):
        PMGHierarchy(BoxMesh((2, 2, 2)), degrees=(1, 2), operator="nope",
                     device="cpu")


def _run(script, *args):
    return subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), "--device", "cpu",
         *args],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))


def test_pmg_driver_perturbed_on_cpu():
    out = _run("pmg_torch.py", "--ndofs", "20000", "--degrees", "1", "3",
               "--mesh", "perturbed", "--pcg")
    assert out.returncode == 0, out.stderr
    assert "switching operator backend to 'lattice_blocked'" in out.stdout
    assert "FCG(V-cycle) converged in" in out.stdout
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert 0.0 < last["l2_error"] < 1e-4
    # JAX's switch: the FDM coarse solve is axis-aligned only, so a curved
    # mesh gets the rediscretised h-multigrid coarse solve
    switched = _run("pmg_torch.py", "--ndofs", "2000", "--mesh", "perturbed",
                    "--coarse", "fdm", "--pcg")
    assert switched.returncode == 0, switched.stderr
    assert "switching coarse solver to 'hmg'" in switched.stdout
    assert "FCG(V-cycle) converged in" in switched.stdout


def test_mat_free_driver_geom_on_cpu():
    out = _run("mat_free_torch.py", "--ndofs", "20000", "--degree", "3",
               "--operator", "lattice_blocked", "--variant", "geom",
               "--mat_comp", "--reps", "2")
    assert out.returncode == 0, out.stderr
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["clock"] == "host clock" and last["device"] == "cpu"
    assert last["mat_comp"] < 1e-6
