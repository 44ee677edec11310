"""The general family on the device grid (`parallel.grid2d.GridPMG` with
``operator="lattice" | "lattice_blocked" | "dofmap"``, `build_hmg_grid_general`,
`GridPMG.solve_refined`) against the JAX package's `GridPMG` on the 8
virtual CPU devices of `tests/conftest.py`, the same inputs made from a
numpy seed.

- ``lattice`` and ``dofmap`` in f64 on `PerturbedBoxMesh` with
  `kappa_linear` and ``sigma=11``, with `sigma_linear` (a field) and with
  `kappa_aniso()` (a rotated tensor), on the layouts (2, 2, 2), (2, 2) and
  (1, 2, 4): eigenvalue estimates within 1e-12 relative, five stationary
  cycles and the solution within 1e-10, the same FCG count (JAX's
  ``tests/test_grid2d.py::test_grid_lattice_*`` and
  ``::test_grid_dofmap_oracle_matches_single``, the multi-chip dry run's
  cases 3 and 3b);
- ``lattice_blocked`` in f32 (K-A's plain version on the CPU) against
  JAX's ``lattice_blocked`` (its CPU emulation): cycles above 5e-3 within
  5e-4, the solution within 1e-5;
- the grid apply with a sigma field and Robin faces against the scipy
  `assemble_stiffness` oracle plus the lumped shift, 1e-12 (f64; JAX's
  ``tests/test_robin.py::test_grid_operator_matches_oracle``);
- ``coarse="hmg", coarse_cfg=dict(dist=True)`` (`build_hmg_grid_general`)
  on curved meshes with a DG-0 kappa and sigma, with Robin faces, and
  graded along z: within 1e-10 of JAX;
- `solve_refined` on every backend: an f64 working dtype repeats JAX's
  residual history to 1e-8 relative; an f32 one ends below 1e-6 of
  ``|b|`` as JAX's does;
- `load_state` of JAX's general grid state (`utils.convert.
  grid_data_from_numpy`): four cycles within 1e-10 (f64) and 1e-5 (f32).

K-A per shard on the card is in `tests/test_torch_grid_cuda.py`.
"""

import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pmg_dolfinx_tpu.fem import mesh as jm  # noqa: E402
from pmg_dolfinx_tpu.fem.assembly import assemble_rhs  # noqa: E402
from pmg_dolfinx_tpu.models import poisson as jpo  # noqa: E402
from pmg_dolfinx_tpu.parallel import grid2d as jg  # noqa: E402
from pmg_dolfinx_tpu_torch.fem import mesh as tm  # noqa: E402
from pmg_dolfinx_tpu_torch.models import poisson as tpo  # noqa: E402
from pmg_dolfinx_tpu_torch.parallel import grid2d as tg  # noqa: E402
from pmg_dolfinx_tpu_torch.utils.convert import (  # noqa: E402
    grid_data_from_numpy,
)

# Dirichlet on x, Robin on both y faces and the high z face.
ROBIN_FACES = ((True, True), (False, False), (True, False))
ROBIN = ((0.0, 0.0), (2.0, 3.0), (0.0, 1.5))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _rel_max(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _mesh(pkg, kind, nc):
    """``kind``: 'curved', 'robin' (curved, Robin faces), 'graded'
    (curved, z graded 8:1) or 'box'."""
    if kind == "box":
        return pkg.BoxMesh(nc)
    if kind == "robin":
        return pkg.PerturbedBoxMesh(nc, dirichlet_faces=ROBIN_FACES,
                                    robin=ROBIN)
    if kind == "graded":
        return pkg.PerturbedBoxMesh(nc, spacing=(
            None, None, pkg.geometric_spacing(nc[2], 8.0)))
    return pkg.PerturbedBoxMesh(nc)


def _coef(pkg, kw):
    """The coefficients by name, from the package's own model module."""
    out = dict(kw)
    if out.get("kappa") == "linear":
        out["kappa"] = pkg.kappa_linear
    if out.get("kappa") == "aniso":
        out["kappa"] = pkg.kappa_aniso()
    if out.get("sigma") == "linear":
        out["sigma"] = pkg.sigma_linear
    return out


# name: (mesh kind, cells, shards, GridPMG keywords)
CASES = {
    "lattice-klin-sigma-222": ("curved", (4, 4, 4), (2, 2, 2),
                               dict(operator="lattice", kappa="linear",
                                    sigma=11.0)),
    "lattice-sfield-22": ("curved", (4, 4, 2), (2, 2),
                          dict(operator="lattice", sigma="linear")),
    "lattice-aniso-124": ("curved", (2, 4, 8), (1, 2, 4),
                          dict(operator="lattice", kappa="aniso")),
    "dofmap-klin-sigma-22": ("curved", (4, 4, 2), (2, 2),
                             dict(operator="dofmap", kappa="linear",
                                  sigma=11.0)),
    "dofmap-sfield-124": ("curved", (2, 4, 8), (1, 2, 4),
                          dict(operator="dofmap", sigma="linear")),
    "dofmap-aniso-222": ("curved", (4, 4, 4), (2, 2, 2),
                         dict(operator="dofmap", kappa="aniso")),
    "lattice_blocked-klin-sigma-222": ("curved", (4, 4, 4), (2, 2, 2),
                                       dict(operator="lattice_blocked",
                                            kappa="linear", sigma=11.0)),
    "lattice_blocked-sfield-124": ("curved", (2, 4, 8), (1, 2, 4),
                                   dict(operator="lattice_blocked",
                                        sigma="linear")),
    "hmg-dist-klin-sigma": ("curved", (4, 8, 4), (2, 2, 2),
                            dict(operator="lattice", kappa="linear",
                                 sigma=5.0, coarse="hmg",
                                 coarse_cfg=dict(dist=True))),
    "hmg-dist-robin": ("robin", (4, 8, 4), (2, 2, 2),
                       dict(operator="lattice", coarse="hmg",
                            coarse_cfg=dict(dist=True))),
    "hmg-dist-graded-z": ("graded", (4, 4, 8), (2, 2, 2),
                          dict(operator="lattice", kappa="linear",
                               coarse="hmg", coarse_cfg=dict(dist=True))),
}
F64 = [n for n in CASES if not n.startswith(("lattice_blocked", "hmg"))]
F32 = [n for n in CASES if n.startswith("lattice_blocked")]
HMG = [n for n in CASES if n.startswith("hmg")]
_BUILT = {}


def _f32(name):
    return CASES[name][3]["operator"] == "lattice_blocked"


def _pair(name):
    """(JAX GridPMG, port GridPMG, seeded rhs), built once per process."""
    if name not in _BUILT:
        kind, nc, shards, kw = CASES[name]
        f32 = _f32(name)
        j = jg.GridPMG(_mesh(jm, kind, nc), shards, degrees=(1, 3),
                       dtype=jnp.float32 if f32 else jnp.float64,
                       **_coef(jpo, kw))
        t = tg.GridPMG(_mesh(tm, kind, nc), shards, degrees=(1, 3),
                       dtype=torch.float32 if f32 else torch.float64,
                       device="cpu", **_coef(tpo, kw))
        mesh = _mesh(tm, kind, nc)
        b = np.random.default_rng(len(_BUILT)).standard_normal(
            mesh.num_dofs(3))
        b[mesh.boundary_dof_marker(3)] = 0.0
        _BUILT[name] = (j, t, b)
    return _BUILT[name]


def _check_eigs(j, t, rtol):
    for e_t, e_j in zip(t.eigs, j.eigs):
        e_t, e_j = np.asarray(e_t), np.asarray(e_j)
        assert np.max(np.abs(e_t - e_j) / np.abs(e_j)) <= rtol


@pytest.mark.parametrize("name", F64)
def test_grid_general_matches_jax_f64(name):
    j, t, b = _pair(name)
    _check_eigs(j, t, 1e-12)
    uj, rj = j.solve(jnp.asarray(b), num_cycles=5)
    ut, rt = t.solve(b, num_cycles=5)
    assert ut.dtype == torch.float64 and tuple(ut.shape) == (b.size,)
    assert np.max(np.abs(np.array(rt) - rj) / np.array(rj)) <= 1e-10
    assert _rel_max(ut, uj) <= 1e-10
    pj, nj = j.solve_pcg(b, rtol=1e-8)
    pt, nt = t.solve_pcg(b, rtol=1e-8)
    assert nt == nj
    assert _rel_max(pt, pj) <= 1e-10


@pytest.mark.parametrize("name", F32)
def test_grid_lattice_blocked_matches_jax_f32(name):
    """K-A's plain version per shard against JAX's kernel emulation, f32:
    JAX's own grid tolerance on cycles above 5e-3."""
    j, t, b = _pair(name)
    _check_eigs(j, t, 1e-4)
    uj, rj = j.solve(jnp.asarray(b), num_cycles=5)
    ut, rt = t.solve(b, num_cycles=5)
    assert ut.dtype == torch.float32
    rel_j, rel_t = np.array(rj) / np.linalg.norm(b), np.array(rt) / np.linalg.norm(b)
    keep = rel_j > 5e-3
    assert keep.any()
    assert np.max(np.abs(rel_t[keep] - rel_j[keep]) / rel_j[keep]) <= 5e-4
    assert _rel_max(ut, uj) <= 1e-5


@pytest.mark.parametrize("name", HMG)
def test_grid_hmg_dist_general_matches_jax(name):
    """`build_hmg_grid_general`: the same h-levels as JAX's, every level in
    the stacked layout; eigenvalues, five cycles and the solution within
    1e-10 (JAX's ``test_grid_hmg_distributed_coarse_general_family``,
    ``test_robin.py::test_grid_hmg_general_dist_robin_curved``,
    ``test_graded.py::test_hmg_dist_general_graded_curved``)."""
    j, t, b = _pair(name)
    assert t.coarse_cfg["hmg_dist"]
    shapes_t = [lv.shape for lv in t.coarse_cfg["hmg_levels"]]
    shapes_j = [tuple(lv.shape) for lv in j.coarse_cfg["hmg_levels"]]
    assert shapes_t == shapes_j
    hl = t.data["hmg"]["levels"][-1]
    assert hl["G"].dim() == 7 and hl["bc_marker"].dim() == 6
    _check_eigs(j, t, 1e-12)
    uj, rj = j.solve(jnp.asarray(b), num_cycles=5)
    ut, rt = t.solve(b, num_cycles=5)
    assert np.max(np.abs(np.array(rt) - rj) / np.array(rj)) <= 1e-10
    assert _rel_max(ut, uj) <= 1e-10


@pytest.mark.parametrize("operator", ["lattice", "dofmap"])
def test_grid_apply_matches_assembled_oracle(operator):
    """The grid apply with a sigma field and Robin faces on a curved mesh
    against ``assemble_stiffness`` (Robin boundary mass included) plus the
    field-scaled lumped shift, both bc-applied, f64."""
    import scipy.sparse as sp

    from pmg_dolfinx_tpu_torch.fem.assembly import (assemble_stiffness,
                                                    shifted_mass_np)

    mesh = _mesh(tm, "robin", (4, 4, 4))
    grid = tg.GridPMG(mesh, (2, 2, 2), degrees=(1, 3), kappa=tpo.kappa_linear,
                      sigma=tpo.sigma_linear, operator=operator,
                      device="cpu")
    A = assemble_stiffness(mesh, 3, kappa=tpo.kappa_linear)
    A = A + sp.diags(shifted_mass_np(mesh, 3, tpo.sigma_linear))
    x = np.random.default_rng(8).standard_normal(mesh.num_dofs(3))
    y = grid.from_dist(grid.ops["apply"](grid.data["levels"][-1],
                                         grid.to_dist(x), grid.levels[-1]))
    assert _rel_max(y, A @ x) <= 1e-12


REFINED = {
    "kron": ("box", torch.float64, jnp.float64),
    "lattice": ("curved", torch.float64, jnp.float64),
    "dofmap": ("robin", torch.float64, jnp.float64),
    "kron_blocked": ("box", torch.float32, jnp.float32),
    "lattice_blocked": ("box", torch.float32, jnp.float32),
}


@pytest.mark.parametrize("operator", list(REFINED))
def test_grid_solve_refined_matches_jax(operator):
    """`GridPMG.solve_refined` on every backend, (2, 2, 2), 12 cycles: the
    f64 working dtype repeats JAX's residual history to 1e-8 relative; the
    f32 one ends below 1e-6 of |b|, as JAX's does, and tracks JAX's history
    to 1e-3 above 1e-5 of |b|."""
    kind, t_dt, j_dt = REFINED[operator]
    kw = dict(degrees=(1, 3), kappa=2.0, coarse="cg", operator=operator)
    j = jg.GridPMG(_mesh(jm, kind, (4, 4, 4)), (2, 2, 2), dtype=j_dt, **kw)
    t = tg.GridPMG(_mesh(tm, kind, (4, 4, 4)), (2, 2, 2), dtype=t_dt,
                   device="cpu", **kw)
    b = assemble_rhs(_mesh(jm, kind, (4, 4, 4)), 3, jpo.f_rhs(2.0))
    uj, rj = j.solve_refined(b, num_cycles=12)
    ut, rt = t.solve_refined(b, num_cycles=12)
    assert ut.dtype == torch.float64 and tuple(ut.shape) == (b.size,)
    rj, rt, r0 = np.array(rj), np.array(rt), np.linalg.norm(b)
    assert rt.shape == rj.shape
    if t_dt == torch.float64:
        assert np.max(np.abs(rt - rj) / rj) <= 1e-8
        assert _rel_max(ut, uj) <= 1e-8
    else:
        assert rj[-1] / r0 < 1e-6 and rt[-1] / r0 < 1e-6, rt / r0
        keep = rj / r0 > 1e-5
        assert np.max(np.abs(rt[keep] - rj[keep]) / rj[keep]) <= 1e-3
    _, rt2 = t.solve_refined(b, num_cycles=12, rtol=1e-3)
    assert rt2[-1] < 1e-3 * r0 <= rt2[-2]   # stops at rtol


@pytest.mark.parametrize("name", ["lattice-klin-sigma-222",
                                  "dofmap-sfield-124",
                                  "lattice_blocked-klin-sigma-222",
                                  "hmg-dist-robin"])
def test_grid_general_on_jax_state(name):
    """JAX's calibrated general grid state carried into the port
    (`grid_data_from_numpy` + `load_state`): four cycles within 1e-10 of
    JAX's (f32: 1e-5)."""
    j, t, b = _pair(name)
    f32 = _f32(name)
    data = jax.tree.map(np.asarray, j.data)
    t.load_state(grid_data_from_numpy(data, t, "cpu", t.dtype))
    assert float(t.data["levels"][-1]["lmax"]) == pytest.approx(
        float(data["levels"][-1]["lmax"]), rel=1e-7 if f32 else 1e-15)
    uj, rj = j.solve(jnp.asarray(b), num_cycles=4)
    ut, rt = t.solve(b, num_cycles=4)
    tol = 1e-5 if f32 else 1e-10
    assert np.abs(np.array(rt) - rj).max() / np.linalg.norm(b) <= tol
    assert _rel_max(ut, uj) <= tol
