"""The general family on the 1D slab (`parallel.dist.DistPMG` with
``operator="lattice" | "dofmap"``) against the JAX package's `DistPMG` on
the 8 virtual CPU devices of `tests/conftest.py`, f64, the same inputs
made from a numpy seed.

Per case (a sigma field, a DG-0 kappa with a sigma shift, a rotated
tensor kappa, Robin faces on the sharded and the unsharded axes, graded
spacing along the sharded axis; the ``cg``, ``direct`` and gathered
general ``hmg`` coarse solves; 2 and 4 slabs): the calibration
eigenvalues within 1e-10 relative, five stationary cycles within 1e-10,
`solve_pcg` with the same count and the solution within 1e-10,
`solve_refined` (its float64 apply picked as JAX picks it: the slab
Kronecker apply with the Robin ends and the grading folded in on
axis-aligned meshes, the lattice apply otherwise) within 1e-10, and one
V-cycle on JAX's state (`dist_data_from_numpy` + `load_state`) within
1e-12. These mirror JAX's ``test_variable_kappa.py::
test_variable_kappa_dist_*``, ``test_curved.py::test_perturbed_dist_*``,
``test_sigma_field.py::test_sigma_field_sharded_matches_single``,
``test_tensor_kappa.py::test_tensor_kappa_sharded_matches_single_device``
and the general-operator cases of ``test_robin.py::test_dist_*`` and
``test_graded.py::test_dist_slab_graded_matches_single``.
"""

import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from pmg_dolfinx_tpu.fem import mesh as jm  # noqa: E402
from pmg_dolfinx_tpu.models import poisson as jpo  # noqa: E402
from pmg_dolfinx_tpu.parallel import dist as jd  # noqa: E402
from pmg_dolfinx_tpu_torch.fem import mesh as tm  # noqa: E402
from pmg_dolfinx_tpu_torch.models import poisson as tpo  # noqa: E402
from pmg_dolfinx_tpu_torch.parallel import dist as td  # noqa: E402
from pmg_dolfinx_tpu_torch.utils.convert import (  # noqa: E402
    dist_data_from_numpy,
)

NC = (8, 4, 4)
# Robin on the low x face (the sharded axis: only the first slab's local
# stiffness differs) and both y faces; Dirichlet elsewhere.
ROBIN_FACES = ((False, True), (False, False), (True, True))
ROBIN = ((1.5, 0.0), (2.0, 3.0), (0.0, 0.0))


def _mesh(pkg, kind):
    """``kind``: 'curved', 'robin' (a box with Robin faces), 'graded-box'
    (x graded 4:1) or 'graded-curved' (x and z graded)."""
    if kind == "robin":
        return pkg.BoxMesh(NC, dirichlet_faces=ROBIN_FACES, robin=ROBIN)
    if kind == "graded-box":
        return pkg.BoxMesh(NC, spacing=(pkg.geometric_spacing(8, 4.0), None,
                                        None))
    if kind == "graded-curved":
        return pkg.PerturbedBoxMesh(NC, spacing=(
            pkg.geometric_spacing(8, 4.0), None, pkg.geometric_spacing(4, 3.0)))
    return pkg.PerturbedBoxMesh(NC)


def _coef(pkg, kw):
    out = dict(kw)
    if out.get("kappa") == "linear":
        out["kappa"] = pkg.kappa_linear
    if out.get("kappa") == "aniso":
        out["kappa"] = pkg.kappa_aniso()
    if out.get("sigma") == "linear":
        out["sigma"] = pkg.sigma_linear
    return out


# name: (mesh kind, slabs, DistPMG keywords)
CASES = {
    "lattice-sfield-cg-2": ("curved", 2, dict(operator="lattice",
                                               sigma="linear")),
    "dofmap-klin-sigma-cg-4": ("curved", 4, dict(operator="dofmap",
                                                  kappa="linear",
                                                  sigma=3.0)),
    "lattice-aniso-hmg-2": ("curved", 2, dict(operator="lattice",
                                               kappa="aniso", coarse="hmg")),
    "dofmap-aniso-direct-4": ("curved", 4, dict(operator="dofmap",
                                                 kappa="aniso",
                                                 coarse="direct")),
    "lattice-robin-cg-2": ("robin", 2, dict(operator="lattice")),
    "dofmap-robin-direct-4": ("robin", 4, dict(operator="dofmap",
                                                coarse="direct", sigma=1.0)),
    "dofmap-graded-cg-2": ("graded-box", 2, dict(operator="dofmap")),
    "lattice-graded-sfield-hmg-2": ("graded-curved", 2,
                                    dict(operator="lattice",
                                         kappa="linear", sigma="linear",
                                         coarse="hmg")),
}
_BUILT = {}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _rel_max(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _pair(name):
    """(JAX DistPMG, port DistPMG, seeded rhs, seeded iterate), built
    once per process."""
    if name not in _BUILT:
        kind, S, kw = CASES[name]
        kw = dict(dict(coarse="cg"), **kw)
        j = jd.DistPMG(_mesh(jm, kind), n_devices=S, degrees=(1, 3),
                       **_coef(jpo, kw))
        t = td.DistPMG(_mesh(tm, kind), n_devices=S, degrees=(1, 3),
                       device="cpu", **_coef(tpo, kw))
        mesh = _mesh(tm, kind)
        rng = np.random.default_rng(len(_BUILT))
        b = rng.standard_normal(mesh.num_dofs(3))
        b[mesh.boundary_dof_marker(3)] = 0.0
        _BUILT[name] = (j, t, b, rng.standard_normal(mesh.num_dofs(3)))
    return _BUILT[name]


@pytest.mark.parametrize("name", list(CASES))
def test_dist_general_matches_jax(name):
    j, t, b, _ = _pair(name)
    for e_t, e_j in zip(t.eigs, j.eigs):
        e_t, e_j = np.asarray(e_t), np.asarray(e_j)
        assert np.max(np.abs(e_t - e_j) / np.abs(e_j)) <= 1e-10
    uj, rj = j.solve(b, num_cycles=5)
    ut, rt = t.solve(b, num_cycles=5)
    assert tuple(ut.shape) == (b.size,)
    assert np.max(np.abs(np.array(rt) - rj) / np.array(rj)) <= 1e-10
    assert _rel_max(ut, uj) <= 1e-10
    pj, nj = j.solve_pcg(b, rtol=1e-8)
    pt, nt = t.solve_pcg(b, rtol=1e-8)
    assert nt == nj
    assert _rel_max(pt, pj) <= 1e-10


@pytest.mark.parametrize("name", list(CASES))
def test_dist_general_refined_and_state_match_jax(name):
    j, t, b, x = _pair(name)
    fj, rj = j.solve_refined(b, num_cycles=4)
    ft, rt = t.solve_refined(b, num_cycles=4)
    assert ft.dtype == torch.float64
    assert np.max(np.abs(np.array(rt) - rj) / np.array(rj)) <= 1e-10
    assert _rel_max(ft, fj) <= 1e-10
    t.load_state(dist_data_from_numpy(jax.tree.map(np.asarray, j.data), t,
                                      "cpu", t.dtype))
    vj = j.from_dist(j.apply(j.to_dist(b), j.to_dist(x)))
    vt = t.from_dist(t.apply(t.to_dist(b), t.to_dist(x)))
    assert _rel_max(vt, vj) <= 1e-12
