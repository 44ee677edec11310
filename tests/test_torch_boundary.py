"""Robin and homogeneous Neumann faces and the Dirichlet lifting in the
port against the JAX package.

Mirrors the JAX package's ``tests/test_robin.py``, ``test_mixed_bc.py``
and ``test_lifting.py`` at small sizes, f64:
- the ``robin`` spec of `BoxMesh` / `PerturbedBoxMesh` (``robin_alpha``,
  ``has_robin``, the same ValueErrors);
- the surface terms: `_face_surface_quadrature`, `robin_mass_np`,
  `robin_rhs_np` (a callable and a per-face dict), the stiffness oracle
  with the Robin mass, `general_shift_np` / `_shifted_diag_np` with Robin
  faces baked in, and `lifted_rhs`, to 1e-12 (most bit for bit);
- the mixed-BC model helpers (`u_exact_mixed`, `grad_u_exact_mixed`,
  `f_rhs_mixed`, `robin_data`) bit for bit;
- `PoissonProblem(robin_g=)` on Neumann + Robin boxes and a Robin
  curved mesh, across the operator backends, coarse solvers and
  smoothers: ``b`` to 1e-12, the eigenvalue estimates and one V-cycle on
  a seeded input to 1e-12, the FCG(V) counts and L2 errors equal;
- the pure-Neumann guard (a Robin face pins the constant mode);
- `examples/pmg_torch.py --grade --neumann --robin` (and ``--fdm``)
  against `examples/pmg.py --cpu`, f64: the last JSON line to 1e-10.
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

from pmg_dolfinx_tpu.fem import assembly as ja  # noqa: E402
from pmg_dolfinx_tpu.fem import mesh as jmesh  # noqa: E402
from pmg_dolfinx_tpu.models import poisson as jp  # noqa: E402
from pmg_dolfinx_tpu_torch.fem import assembly as ta  # noqa: E402
from pmg_dolfinx_tpu_torch.fem import mesh as tmesh  # noqa: E402
from pmg_dolfinx_tpu_torch.models import poisson as tp  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
NC = (3, 3, 4)
FACES = ((False, False), (False, False), (True, True))
ROBIN = ((0.0, 0.0), (2.0, 2.0), (0.0, 0.0))
ALL_FACES = [((True, True),) * 3, ((False, False),) * 3,
             ((True, False), (False, True), (True, True)),
             ((False, True), (True, False), (False, False))]


def _np(a):
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _meshes(kind="BoxMesh", nc=NC, **kw):
    return getattr(jmesh, kind)(nc, **kw), getattr(tmesh, kind)(nc, **kw)


def test_robin_spec_matches_jax():
    jm, tm = _meshes(dirichlet_faces=FACES, robin=ROBIN)
    assert np.array_equal(tm.robin_alpha, jm.robin_alpha)
    assert tm.has_robin and not tmesh.BoxMesh(NC).has_robin
    assert not tm.robin_alpha.flags.writeable
    for faces, robin in ((True, ROBIN), (FACES, ((0, 0), (-1.0, 0), (0, 0))),
                         (FACES, ((1.0, 1.0),))):
        with pytest.raises(ValueError) as ej:
            jmesh.BoxMesh(NC, dirichlet_faces=faces, robin=robin)
        with pytest.raises(ValueError) as et:
            tmesh.BoxMesh(NC, dirichlet_faces=faces, robin=robin)
        assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("kind", ["BoxMesh", "PerturbedBoxMesh"])
def test_surface_terms_match_jax(kind):
    robin = ((0.5, 0.0), (2.0, 2.0), (0.0, 1.0))
    faces = ((False, True), (False, False), (True, False))
    spacing = (None, None, tmesh.geometric_spacing(4, 3.0))
    jm, tm = _meshes(kind, dirichlet_faces=faces, robin=robin,
                     spacing=spacing)
    P = 2
    for axis in range(3):
        for side in range(2):
            for a, b in zip(ta._face_surface_quadrature(tm, P, axis, side),
                            ja._face_surface_quadrature(jm, P, axis, side)):
                assert np.array_equal(a, b)
    for bc_zero in (True, False):
        assert np.array_equal(ta.robin_mass_np(tm, P, bc_zero),
                              ja.robin_mass_np(jm, P, bc_zero))
    g = lambda x: np.cos(x[0]) + x[1] * x[2]
    gd = {(1, 0): g, (1, 1): 0.25, (0, 0): lambda x: 1.0 + x[2]}
    for data in (g, gd):
        assert np.array_equal(ta.robin_rhs_np(tm, P, data),
                              ja.robin_rhs_np(jm, P, data))
    for bc in (True, False):
        At = ta.assemble_stiffness(tm, P, kappa=1.5, bc=bc).toarray()
        Aj = ja.assemble_stiffness(jm, P, kappa=1.5, bc=bc).toarray()
        assert np.abs(At - Aj).max() <= 1e-12 * np.abs(Aj).max()
    sf = lambda x: 1.0 + x[0] * x[1]
    for sigma, field in ((0.0, None), (0.5, None), (1.0, sf)):
        st, mt = ta.general_shift_np(tm, P, sigma, field)
        sj, mj = ja.general_shift_np(jm, P, sigma, field)
        assert st == sj and np.array_equal(mt, mj)
    from pmg_dolfinx_tpu.parallel.dist import _shifted_diag_np as jdiag
    from pmg_dolfinx_tpu_torch.parallel.dist import _shifted_diag_np as tdiag

    kc = np.linspace(1.0, 2.0, tm.ncells)
    assert _rel(tdiag(tm, P, kc, 0.5, sf), jdiag(jm, P, kc, 0.5, sf)) <= 1e-13


@pytest.mark.parametrize("kappa", [2.0, "tensor"])
def test_lifted_rhs_matches_jax(kappa):
    if kappa == "tensor":
        kappa = tp.kappa_aniso(ratio=5.0)
    jm, tm = _meshes(dirichlet_faces=((True, True), (True, False),
                                      (False, True)))
    f = lambda x: 1.0 + x[0] * x[2]
    g = lambda x: np.sin(x[0]) + x[1] ** 2 - x[2]
    (bt, ut), (bj, uj) = (ta.lifted_rhs(tm, 2, kappa, f, g),
                          ja.lifted_rhs(jm, 2, kappa, f, g))
    assert np.array_equal(ut, uj)
    assert _rel(bt, bj) <= 1e-13


@pytest.mark.parametrize("faces", ALL_FACES)
def test_mixed_helpers_match_jax(faces):
    x = np.random.default_rng(0).uniform(0.0, 1.0, (3, 50))
    assert np.array_equal(tp.u_exact_mixed(faces)(x),
                          jp.u_exact_mixed(faces)(x))
    assert np.array_equal(tp.grad_u_exact_mixed(faces)(x),
                          jp.grad_u_exact_mixed(faces)(x))
    assert np.array_equal(tp.f_rhs_mixed(2.0, faces, 0.5)(x),
                          jp.f_rhs_mixed(2.0, faces, 0.5)(x))
    robin = ((1.0, 0.0), (0.0, 2.0), (0.5, 0.5))
    for kappa in (2.0, (1.0, 2.0, 3.0)):
        gt = tp.robin_data(kappa, tp.u_exact_mixed(faces),
                           tp.grad_u_exact_mixed(faces), robin)
        gj = jp.robin_data(kappa, jp.u_exact_mixed(faces),
                           jp.grad_u_exact_mixed(faces), robin)
        assert sorted(gt) == sorted(gj)
        for k in gt:
            assert np.array_equal(gt[k](x), gj[k](x))


# (mesh kind, operator, coarse, smoother)
CASES = [
    ("BoxMesh", "kron", "fdm", "cheb"),
    ("BoxMesh", "kron", "hmg", "cheb"),
    ("BoxMesh", "lattice", "cg", "cheb"),
    ("BoxMesh", "dofmap", "direct", "cheb"),
    ("BoxMesh", "kron", "fdm", "schwarz"),
    ("BoxMesh", "kron", "cg", "line"),
    ("PerturbedBoxMesh", "lattice", "hmg", "cheb"),
]


@pytest.mark.parametrize("kind,operator,coarse,smoother", CASES)
def test_robin_problem_matches_jax(kind, operator, coarse, smoother):
    """Neumann x, Robin y (alpha 2) and Dirichlet z, the manufactured
    mixed solution, ``b`` with the Robin data; on the curved mesh the
    Robin faces ride the general family's baked ``m3``."""
    kw = dict(dirichlet_faces=FACES, robin=ROBIN)
    if kind == "BoxMesh":
        kw["spacing"] = (None, None, tmesh.geometric_spacing(NC[2], 4.0))
    jm, tm = _meshes(kind, **kw)
    common = dict(nc=NC, degrees=(1, 2), kappa=2.0, coarse=coarse,
                  operator=operator, smoother=smoother, sigma=0.25)
    models = []
    for pm, mesh, dt, dev in ((jp, jm, jnp.float64, {}),
                              (tp, tm, torch.float64, {"device": "cpu"})):
        u = pm.u_exact_mixed(FACES)
        g = pm.robin_data(2.0, u, pm.grad_u_exact_mixed(FACES), ROBIN)
        models.append(pm.PoissonProblem(
            mesh=mesh, dtype=dt, f=pm.f_rhs_mixed(2.0, FACES, 0.25),
            u_exact=u, robin_g=g, **common, **dev))
    jprob, tprob = models
    assert _rel(tprob.b, jprob.b) <= 1e-13
    for ej, et in zip(jprob.hierarchy.eigs, tprob.hierarchy.eigs):
        assert np.max(np.abs(np.asarray(et) - np.asarray(ej))
                      / np.abs(np.asarray(ej))) <= 1e-12
    r = np.random.default_rng(11).standard_normal(tm.num_dofs(2))
    assert _rel(tprob.hierarchy.apply(r, np.zeros_like(r)),
                jprob.hierarchy.apply(jnp.asarray(r),
                                      jnp.zeros(r.shape))) <= 1e-12
    uj, itj = jprob.hierarchy.solve_pcg(jprob.b, rtol=1e-10)
    ut, itt = tprob.hierarchy.solve_pcg(tprob.b, rtol=1e-10)
    assert itt == itj
    ej, et = jprob.error_l2(np.asarray(uj)), tprob.error_l2(ut)
    assert abs(et - ej) <= 1e-8 * ej


def test_pure_neumann_guard_matches_jax():
    """No Dirichlet face and sigma 0: JAX's ValueError; a Robin face pins
    the constant mode, so the all-Robin box builds and cycles as JAX's."""
    from pmg_dolfinx_tpu.solvers.pmg import PMGHierarchy as JH
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy as TH

    free = ((False, False),) * 3
    jm, tm = _meshes(dirichlet_faces=free)
    with pytest.raises(ValueError) as ej:
        JH(jm, degrees=(1, 2))
    with pytest.raises(ValueError) as et:
        TH(tm, degrees=(1, 2), device="cpu")
    assert str(et.value) == str(ej.value)
    jm, tm = _meshes(dirichlet_faces=free, robin=((1.0, 1.0),) * 3)
    kw = dict(degrees=(1, 2), operator="kron", coarse="fdm")
    jh, th = JH(jm, dtype=jnp.float64, **kw), TH(tm, device="cpu", **kw)
    b = np.random.default_rng(2).standard_normal(tm.num_dofs(2))
    assert _rel(th.apply(b, 0 * b), jh.apply(jnp.asarray(b),
                                             jnp.zeros(b.shape))) <= 1e-12


DRIVER_FLAGS = {
    "mixed": ["--grade", "z:4", "--neumann", "x", "--robin", "y",
              "--coarse", "fdm", "--operator", "kron", "--pcg"],
    "mixed-fdm": ["--grade", "z:4", "--neumann", "x", "--robin", "y",
                  "--fdm"],
    "robin-lattice": ["--robin", "xz", "--coarse", "cg", "--operator",
                      "lattice", "--sigma", "1.5", "--pcg"],
}
DRIVER_COMMON = ["--ndofs", "3000", "--degrees", "1", "3", "--dtype", "f64",
                 "--cycles", "12"]


@pytest.fixture(scope="module")
def jax_drivers():
    """`examples/pmg.py --cpu` for every case, run side by side."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               OMP_NUM_THREADS="1")
    procs = {k: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / "pmg.py"), "--cpu",
         *DRIVER_COMMON, *v], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True, env=env)
        for k, v in DRIVER_FLAGS.items()}
    return {k: p.communicate(timeout=300)[0] for k, p in procs.items()}


@pytest.mark.parametrize("case", list(DRIVER_FLAGS))
def test_pmg_driver_boundary_flags_match_jax(case, jax_drivers, capsys):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "pmg_torch", ROOT / "examples" / "pmg_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    capsys.readouterr()
    mod.main(["--device", "cpu", *DRIVER_COMMON, *DRIVER_FLAGS[case]])
    lt, lj = (json.loads(o.strip().splitlines()[-1])
              for o in (capsys.readouterr().out, jax_drivers[case]))
    assert abs(lt["l2_error"] - lj["l2_error"]) <= 1e-10 * lj["l2_error"]
    assert (lt["rel_residual"] is None) == (lj["rel_residual"] is None)
