"""Variable, per-axis and tensor kappa and sigma fields in the port against
the JAX package.

Mirrors the JAX package's ``tests/test_tensor_kappa.py``,
``test_variable_kappa.py`` and ``test_sigma_field.py`` at small sizes:
- the resolvers (`resolve_kappa`, `resolve_kappa_split`,
  `resolve_kappa_axes`) for every coefficient form (scalar, per-axis
  tuple, DG-0 array, callable scalar or tensor field, constant or
  per-cell 3x3 tensor), with JAX's values and ValueErrors; the tensor
  fold of `geometry_factors`, the stiffness oracle and diagonal, the
  sigma-field mass (f64, bit for bit or 1e-13);
- the model sources (`kappa_linear`, `f_rhs_variable`, `sigma_linear`,
  `f_rhs_sigma_field`, `kappa_aniso`, `f_rhs_tensor`, ...) bit for bit;
- the operators: `LatticeLaplacian`, `MatFreeLaplacian` (f64, 1e-12) and
  `PallasLatticeBlocked` K-A with a tensor, K-B with a DG-0 kappa at
  ``co[36]`` against the Pallas kernels in interpret mode (f32, 1e-5);
- `PMGHierarchy` with each coefficient form on the backends and coarse
  solvers that take it (per-axis and diagonal tensors on the Kronecker
  family with ``fdm`` / ``hmg``, tensor and variable kappa and sigma
  fields on the general family with ``cg`` / ``hmg`` / ``direct``, the
  line and Schwarz smoothers): eigenvalue estimates and one V-cycle to
  1e-12, the FCG(V) counts equal; JAX's refusals and the stationary
  tensor warning; `solve_refined`; a converted JAX state (`utils.convert`)
  with a sigma field and Robin faces;
- the transient `_half_kappa` and the CN heat stepper with per-axis and
  diagonal-tensor kappa (1e-10);
- `examples/pmg_torch.py --kappa-field linear|aniso|aniso-diag` and
  ``--sigma-field`` against `examples/pmg.py --cpu` (f64; `amg_torch.py
  --kappa-field linear`: `tests/test_torch_hmg.py`).
- On the card (marked ``cuda``): K-A on a tensor-folded G and K-B on a
  DG-0 kappa against their plain versions.
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

ROOT = pathlib.Path(__file__).resolve().parent.parent
NC = (3, 2, 4)
NCELLS = 24


@pytest.fixture(scope="module")
def jx():
    """The JAX reference modules (imported here: the card tests of this
    file need no JAX)."""
    pytest.importorskip("jax")
    from types import SimpleNamespace

    import jax.numpy as jnp

    from pmg_dolfinx_tpu.fem import assembly, geometry, mesh
    from pmg_dolfinx_tpu.models import poisson
    from pmg_dolfinx_tpu.ops import laplacian, lattice, pallas_lattice_blocked
    from pmg_dolfinx_tpu.solvers import pmg, transient

    return SimpleNamespace(jnp=jnp, asm=assembly, geo=geometry, mesh=mesh,
                           pm=poisson, lap=laplacian, lat=lattice,
                           jlb=pallas_lattice_blocked, pmg=pmg,
                           transient=transient)


def _np(a):
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _spd_field(n, seed=0):
    A = np.random.default_rng(seed).uniform(-0.3, 0.3, (n, 3, 3))
    return np.einsum("cij,ckj->cik", A, A) + np.eye(3)


def _kappa(form):
    """A coefficient of each form `resolve_kappa` takes."""
    from pmg_dolfinx_tpu_torch.models import poisson as tp

    return {
        "scalar": 2.5,
        "axes": (1.0, 2.0, 5.0),
        "cells": np.linspace(1.0, 3.0, NCELLS),
        "callable": tp.kappa_linear,
        "callable-tensor": lambda x: np.broadcast_to(
            tp.kappa_aniso(ratio=4.0), (x.shape[1], 3, 3)),
        "tensor": tp.kappa_aniso(ratio=10.0),
        "diag": np.diag([1.0, 1.0, 100.0]),
        "cell-tensor": _spd_field(NCELLS),
    }[form]


FORMS = ["scalar", "axes", "cells", "callable", "callable-tensor", "tensor",
         "diag", "cell-tensor"]


def _meshes(jx, kind="BoxMesh", nc=NC, **kw):
    from pmg_dolfinx_tpu_torch.fem import mesh as tmesh

    return getattr(jx.mesh, kind)(nc, **kw), getattr(tmesh, kind)(nc, **kw)


def _same_outcome(ft, fj):
    """Both calls return equal values, or raise the same ValueError."""
    try:
        want = fj()
    except ValueError as e:
        with pytest.raises(ValueError) as et:
            ft()
        assert str(et.value) == str(e)
        return None
    return ft(), want


@pytest.mark.parametrize("form", FORMS)
def test_resolvers_match_jax(jx, form):
    from pmg_dolfinx_tpu_torch.fem import assembly as ta

    jm, tm = _meshes(jx, "PerturbedBoxMesh")
    kappa = _kappa(form)
    (kt, ct), (kj, cj) = (ta.resolve_kappa(tm, kappa),
                          jx.asm.resolve_kappa(jm, kappa))
    assert ct == cj and np.array_equal(kt, kj)
    for a, b in zip(ta.resolve_kappa_split(tm, kappa),
                    jx.asm.resolve_kappa_split(jm, kappa)):
        assert (a is None and b is None) or np.array_equal(a, b)
    got = _same_outcome(lambda: ta.resolve_kappa_axes(tm, kappa),
                        lambda: jx.asm.resolve_kappa_axes(jm, kappa))
    if got is not None:
        assert got[0] == got[1]
    kc, kf, _ = ta.resolve_kappa_split(tm, kappa)
    for P in (1, 2):
        Gt, dt = ta.geometry_factors_np(tm, P, kappa=kf)
        Gj, dj = jx.asm.geometry_factors_np(jm, P, kappa=kf)
        assert np.array_equal(Gt, Gj) and np.array_equal(dt, dj)
        assert _rel(ta.stiffness_diagonal_np(tm, P, kappa),
                    jx.asm.stiffness_diagonal_np(jm, P, kappa)) <= 1e-13
    At = ta.assemble_stiffness(tm, 2, kappa=kappa).toarray()
    Aj = jx.asm.assemble_stiffness(jm, 2, kappa=kappa).toarray()
    assert np.abs(At - Aj).max() <= 1e-12 * np.abs(Aj).max()


def test_resolver_errors_match_jax(jx):
    from pmg_dolfinx_tpu_torch.fem import assembly as ta

    jm, tm = _meshes(jx)
    bad = np.array([[1.0, 0.5, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    for kappa in (bad, np.ones(5), np.ones((5, 3, 3)), lambda x: x[:2],
                  np.ones((NCELLS, 2))):
        with pytest.raises(ValueError) as ej:
            jx.asm.resolve_kappa(jm, kappa)
        with pytest.raises(ValueError) as et:
            ta.resolve_kappa(tm, kappa)
        assert str(et.value) == str(ej.value)


def test_tensor_fold_and_sigma_field_match_jax(jx):
    """`geometry_factors(kappa=(ncells, 3, 3))` on curved cells, bit for
    bit; `resolve_sigma`, `shifted_mass_np` and `general_shift_np` with a
    sigma field."""
    from pmg_dolfinx_tpu_torch.fem import assembly as ta
    from pmg_dolfinx_tpu_torch.fem import geometry as tg
    from pmg_dolfinx_tpu_torch.models import poisson as tp

    jm, tm = _meshes(jx, "PerturbedBoxMesh")
    K = _spd_field(NCELLS, 3)
    args = (tm.geometry_x, tm.geometry_dofmap, tg.tabulate_geometry_dphi(3),
            tg.quadrature_weights_3d(3))
    for a, b in zip(tg.geometry_factors(*args, kappa=K),
                    jx.geo.geometry_factors(*args, xp=np, kappa=K)):
        assert np.array_equal(a, np.asarray(b))
    assert ta.resolve_sigma(tp.sigma_linear) == (1.0, tp.sigma_linear)
    for bc_zero in (True, False):
        assert np.array_equal(
            ta.shifted_mass_np(tm, 2, tp.sigma_linear, bc_zero),
            jx.asm.shifted_mass_np(jm, 2, jx.pm.sigma_linear, bc_zero))
    for sigma in (0.0, 0.5):
        st, mt = ta.general_shift_np(tm, 2, sigma, tp.sigma_linear)
        sj, mj = jx.asm.general_shift_np(jm, 2, sigma, jx.pm.sigma_linear)
        assert st == sj and (mt is None) == (mj is None)
        assert mt is None or np.array_equal(mt, mj)


def test_model_sources_match_jax(jx):
    from pmg_dolfinx_tpu_torch.models import poisson as tp

    x = np.random.default_rng(1).uniform(0.0, 1.0, (3, 40))
    pairs = [
        (tp.kappa_linear, jx.pm.kappa_linear),
        (tp.grad_kappa_linear, jx.pm.grad_kappa_linear),
        (tp.sigma_linear, jx.pm.sigma_linear),
        (tp.grad_u_exact, jx.pm.grad_u_exact),
        (tp.f_rhs_sigma_field(2.0), jx.pm.f_rhs_sigma_field(2.0)),
        (tp.f_rhs_variable(sigma=0.5), jx.pm.f_rhs_variable(sigma=0.5)),
        (tp.f_rhs_tensor(tp.kappa_aniso(), 0.3),
         jx.pm.f_rhs_tensor(jx.pm.kappa_aniso(), 0.3)),
    ]
    for ft, fj in pairs:
        assert np.array_equal(ft(x), fj(x))
    assert np.array_equal(tp.kappa_aniso(0.3, 7.0), jx.pm.kappa_aniso(0.3, 7.0))


@pytest.mark.parametrize("form", ["cells", "tensor", "cell-tensor"])
def test_general_operators_match_jax(jx, form):
    from pmg_dolfinx_tpu_torch.ops.laplacian import MatFreeLaplacian
    from pmg_dolfinx_tpu_torch.ops.lattice import LatticeLaplacian

    jm, tm = _meshes(jx, "PerturbedBoxMesh")
    kappa = _kappa(form)
    x = np.random.default_rng(4).standard_normal(tm.num_dofs(2))
    for tcls, jcls in ((LatticeLaplacian, jx.lat.LatticeLaplacian),
                       (MatFreeLaplacian, jx.lap.MatFreeLaplacian)):
        top = tcls(tm, 2, kappa=kappa, dtype=torch.float64, device="cpu")
        jop = jcls(jm, 2, kappa=kappa, dtype=jx.jnp.float64)
        assert _rel(top(torch.tensor(x)), jop(jx.jnp.asarray(x))) <= 1e-12
        assert _rel(top.diag, jop.diag) <= 1e-12


@pytest.mark.parametrize("form,variant", [("tensor", None),
                                          ("cells", "geom")])
def test_lattice_blocked_coefficients_match_pallas_interpret(jx, form,
                                                            variant):
    """K-A on a tensor-folded G and K-B with a DG-0 kappa at ``co[36]``
    (f32) against the JAX classes with the Pallas kernels interpreted:
    <= 1e-5; 'geom' refuses a tensor with JAX's ValueError."""
    from pmg_dolfinx_tpu_torch.ops import lattice_blocked as tlb

    jm, tm = _meshes(jx, "PerturbedBoxMesh")
    kappa = _kappa(form)
    x = np.random.default_rng(5).standard_normal(tm.num_dofs(2)).astype(
        np.float32)
    op_t = tlb.PallasLatticeBlocked(tm, 2, kappa=kappa, variant=variant,
                                    device="cpu")
    op_j = jx.jlb.PallasLatticeBlocked(jm, 2, kappa=kappa, interpret=True,
                                       variant=variant)
    assert _rel(op_t(torch.from_numpy(x)), op_j(jx.jnp.asarray(x))) <= 1e-5
    assert _rel(op_t.diag, op_j.diag) <= 1e-6
    with pytest.raises(ValueError) as ej:
        jx.jlb.PallasLatticeBlocked(jm, 2, kappa=_kappa("tensor"),
                                    variant="geom")
    with pytest.raises(ValueError) as et:
        tlb.PallasLatticeBlocked(tm, 2, kappa=_kappa("tensor"),
                                 variant="geom", device="cpu")
    assert str(et.value) == str(ej.value)


# (mesh kind, kappa form, sigma field, operator, coarse, smoother)
HIER_CASES = [
    ("BoxMesh", "axes", False, "kron", "fdm", "cheb"),
    ("BoxMesh", "diag", False, "kron", "hmg", "cheb"),
    ("BoxMesh", "tensor", False, "lattice", "cg", "cheb"),
    ("BoxMesh", "tensor", False, "lattice", "hmg", "cheb"),
    ("BoxMesh", "cell-tensor", False, "dofmap", "direct", "cheb"),
    ("BoxMesh", "tensor", False, "lattice", "cg", "line"),
    ("BoxMesh", "tensor", False, "lattice", "cg", "schwarz"),
    ("PerturbedBoxMesh", "callable", False, "lattice", "hmg", "cheb"),
    ("PerturbedBoxMesh", "cells", False, "dofmap", "cg", "cheb"),
    ("PerturbedBoxMesh", "scalar", True, "lattice", "cg", "cheb"),
    ("BoxMesh", "scalar", True, "dofmap", "hmg", "cheb"),
    ("BoxMesh", "scalar", True, "lattice", "direct", "cheb"),
]


@pytest.mark.parametrize("kind,form,field,operator,coarse,smoother",
                         HIER_CASES)
def test_coefficient_hierarchy_matches_jax(jx, kind, form, field, operator,
                                           coarse, smoother):
    from pmg_dolfinx_tpu_torch.models import poisson as tp
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    jm, tm = _meshes(jx, kind, nc=(4, 2, 4))
    kappa = _kappa(form)
    if form in ("cells", "cell-tensor"):
        kappa = (np.linspace(1.0, 3.0, 32) if form == "cells"
                 else _spd_field(32))
    kw = dict(degrees=(1, 2), kappa=kappa, operator=operator, coarse=coarse,
              smoother=smoother)
    jh = jx.pmg.PMGHierarchy(jm, dtype=jx.jnp.float64, **kw, sigma=(
        jx.pm.sigma_linear if field else 0.0))
    th = PMGHierarchy(tm, dtype=torch.float64, device="cpu", **kw, sigma=(
        tp.sigma_linear if field else 0.0))
    assert (th.kappa_axes is None) == (jh.kappa_axes is None)
    for ej, et in zip(jh.eigs, th.eigs):
        assert np.max(np.abs(np.asarray(et) - np.asarray(ej))
                      / np.abs(np.asarray(ej))) <= 1e-12
    b = np.random.default_rng(9).standard_normal(tm.num_dofs(2))
    assert _rel(th.apply(b, np.zeros_like(b)),
                jh.apply(jx.jnp.asarray(b), jx.jnp.zeros(b.shape))) <= 1e-12
    _, itj = jh.solve_pcg(jx.jnp.asarray(b), rtol=1e-8)
    _, itt = th.solve_pcg(b, rtol=1e-8)
    assert itt == itj


def test_coefficient_refusals_match_jax(jx):
    """JAX's ValueErrors: a tensor on the Kronecker family, 'fdm' with a
    variable kappa, a sigma field with the Kronecker family, 'fdm' or a
    line smoother, and `PoissonProblem` without ``f`` for a variable
    kappa or a sigma field."""
    from pmg_dolfinx_tpu_torch.models import poisson as tp
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    jm, tm = _meshes(jx)
    calls = [
        (dict(kappa=_kappa("tensor"), operator="kron"), {}),
        (dict(kappa=_kappa("cells"), operator="lattice", coarse="fdm"), {}),
        (dict(operator="kron"), dict(sigma=True)),
        (dict(operator="lattice", coarse="fdm"), dict(sigma=True)),
        (dict(operator="lattice", smoother="line"), dict(sigma=True)),
    ]
    for kw, extra in calls:
        sj = dict(sigma=jx.pm.sigma_linear) if extra else {}
        st = dict(sigma=tp.sigma_linear) if extra else {}
        with pytest.raises(ValueError) as ej:
            jx.pmg.PMGHierarchy(jm, degrees=(1, 2), **kw, **sj)
        with pytest.raises(ValueError) as et:
            PMGHierarchy(tm, degrees=(1, 2), device="cpu", **kw, **st)
        assert str(et.value) == str(ej.value)
    for kw in (dict(kappa=tp.kappa_linear), dict(sigma=tp.sigma_linear)):
        with pytest.raises(ValueError, match="pass the matching source"):
            tp.PoissonProblem(nc=NC, degrees=(1, 2), operator="lattice",
                              device="cpu", **kw)


def test_tensor_stationary_warning(jx):
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    _, tm = _meshes(jx)
    b = np.random.default_rng(1).standard_normal(tm.num_dofs(2))
    th = PMGHierarchy(tm, degrees=(1, 2), kappa=_kappa("tensor"),
                      operator="lattice", coarse="cg", device="cpu")
    with pytest.warns(UserWarning, match="tensor"):
        th.solve(b, num_cycles=1)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        th.solve_pcg(b, rtol=1e-4)
        PMGHierarchy(tm, degrees=(1, 2), kappa=_kappa("diag"),
                     operator="kron", coarse="fdm",
                     device="cpu").solve(b, num_cycles=1)


@pytest.mark.parametrize("form,field,operator", [
    ("axes", False, "kron"), ("tensor", False, "lattice"),
    ("scalar", True, "lattice")])
@pytest.mark.filterwarnings("ignore:stationary V-cycle")
def test_solve_refined_coefficients_match_jax(jx, form, field, operator):
    """The f64 outer residual: the Kronecker form for a per-axis kappa,
    the lattice form with the tensor fold or the baked sigma field; the
    residual norms of 4 refinement cycles from JAX's calibrated state
    agree to 1e-5 (the f32 V-cycles' rounding)."""
    from pmg_dolfinx_tpu_torch.models import poisson as tp
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    jm, tm = _meshes(jx)
    kw = dict(degrees=(1, 2), kappa=_kappa(form), operator=operator,
              coarse="cg")
    jh = jx.pmg.PMGHierarchy(jm, dtype=jx.jnp.float32, **kw, sigma=(
        jx.pm.sigma_linear if field else 0.0))
    th = PMGHierarchy(tm, dtype=torch.float32, device="cpu", **kw, sigma=(
        tp.sigma_linear if field else 0.0))
    th.load_state({"levels": [
        {k: torch.tensor(np.asarray(v)) for k, v in lv.items()}
        for lv in jh.data["levels"]]})
    b = np.random.default_rng(2).standard_normal(tm.num_dofs(2))
    _, rj = jh.solve_refined(jx.jnp.asarray(b), num_cycles=4)
    _, rt = th.solve_refined(b, num_cycles=4)
    # the f64 residuals of two f32 V-cycle chains on the same state
    assert np.max(np.abs(np.asarray(rt) - np.asarray(rj))
                  / np.asarray(rj)) <= 1e-5
    assert rt[-1] < rt[0]


def test_converted_state_with_field_and_robin_matches_jax(jx):
    """`utils.convert.hierarchy_data_from_numpy` carries a JAX hierarchy's
    baked ``m3`` (a sigma field with Robin faces) and tensor-folded G."""
    import jax

    from pmg_dolfinx_tpu_torch.models import poisson as tp
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy
    from pmg_dolfinx_tpu_torch.utils.convert import hierarchy_data_from_numpy

    faces = ((True, True), (False, False), (True, True))
    robin = ((0.0, 0.0), (1.0, 3.0), (0.0, 0.0))
    jm, tm = _meshes(jx, dirichlet_faces=faces, robin=robin)
    kw = dict(degrees=(1, 2), kappa=_kappa("tensor"), operator="lattice",
              coarse="cg")
    jh = jx.pmg.PMGHierarchy(jm, dtype=jx.jnp.float64,
                             sigma=jx.pm.sigma_linear, **kw)
    th = PMGHierarchy(tm, dtype=torch.float64, sigma=tp.sigma_linear,
                      device="cpu", **kw)
    state = hierarchy_data_from_numpy(jax.tree.map(np.asarray, jh.data),
                                      "cpu", torch.float64)
    for lt, lj in zip(th.data["levels"], state["levels"]):
        for k in ("m3", "G"):
            assert _rel(lt[k], lj[k]) <= 1e-13, k
    th.load_state(state)
    b = np.random.default_rng(3).standard_normal(tm.num_dofs(2))
    assert _rel(th.apply(b, np.zeros_like(b)),
                jh.apply(jx.jnp.asarray(b), jx.jnp.zeros(b.shape))) <= 1e-12


@pytest.mark.parametrize("form", ["scalar", "axes", "diag"])
def test_half_kappa_and_heat_match_jax(jx, form):
    from pmg_dolfinx_tpu_torch.solvers import transient as tt

    kappa = _kappa(form)
    hj, ht = jx.transient._half_kappa(kappa), tt._half_kappa(kappa)
    assert type(ht) is type(hj) and np.array_equal(ht, hj)
    jm, tm = _meshes(jx)
    u0 = np.random.default_rng(6).standard_normal(tm.num_dofs(2))
    u0[tm.boundary_dof_marker(2)] = 0.0
    kw = dict(kappa=kappa, dt=1e-3, scheme="cn")
    uj = jx.transient.heat_fdm_evolve(jm, 2, **kw)(u0, 3)
    ut = tt.heat_fdm_evolve(tm, 2, device="cpu", **kw)(u0, 3)
    assert _rel(ut, uj) <= 1e-10


DRIVER_FLAGS = {
    "linear": ["pmg", "--kappa-field", "linear", "--coarse", "hmg",
               "--pcg"],
    "aniso": ["pmg", "--kappa-field", "aniso", "--coarse", "cg", "--pcg"],
    "aniso-diag": ["pmg", "--kappa-field", "aniso-diag", "--coarse", "fdm",
                   "--pcg"],
    "aniso-diag-fdm": ["pmg", "--kappa-field", "aniso-diag", "--fdm"],
    "sigma-field": ["pmg", "--sigma-field", "--coarse", "direct", "--pcg"],
}
PMG_COMMON = ["--ndofs", "3000", "--degrees", "1", "3", "--dtype", "f64",
              "--cycles", "30"]


def _argv(case):
    name, *flags = DRIVER_FLAGS[case]
    return name, PMG_COMMON + flags


@pytest.fixture(scope="module")
def jax_drivers():
    """`examples/pmg.py --cpu` for every case, run side by side."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               OMP_NUM_THREADS="1")
    procs = {}
    for case in DRIVER_FLAGS:
        name, argv = _argv(case)
        procs[case] = subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / f"{name}.py"), "--cpu",
             *argv], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True, env=env)
    return {k: p.communicate(timeout=300)[0] for k, p in procs.items()}


@pytest.mark.parametrize("case", list(DRIVER_FLAGS))
def test_drivers_coefficient_flags_match_jax(case, jax_drivers, capsys):
    import importlib.util

    name, argv = _argv(case)
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    capsys.readouterr()
    mod.main(["--device", "cpu", *argv])
    out = capsys.readouterr().out
    lt, lj = (json.loads(o.strip().splitlines()[-1])
              for o in (out, jax_drivers[case]))
    assert abs(lt["l2_error"] - lj["l2_error"]) <= 1e-10 * lj["l2_error"]


# --- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("form,variant", [("tensor", None),
                                          ("cell-tensor", None),
                                          ("cells", "geom"),
                                          ("callable", "geom")])
@pytest.mark.parametrize("p", [1, 3, 6])
def test_cuda_lattice_coefficients_match_plain(cuda_device, form, variant,
                                               p):
    """K-A on a tensor-folded G (off-diagonal entries on a box) and K-B
    with a DG-0 kappa at ``co[36]`` against their plain versions:
    <= 1e-5 relative max-norm; one launch each."""
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.ops import lattice_blocked as tlb

    mesh = BoxMesh((3, 2, 4))
    kw = dict(kappa=_kappa(form), variant=variant)
    op_c = tlb.PallasLatticeBlocked(mesh, p, device=cuda_device, **kw)
    op_p = tlb.PallasLatticeBlocked(mesh, p, device="cpu", **kw)
    x = np.random.default_rng(p).standard_normal(mesh.num_dofs(p))
    before = sum(tlb.LAUNCHES.values())
    y = op_c(torch.tensor(x, dtype=torch.float32, device=cuda_device))
    assert sum(tlb.LAUNCHES.values()) == before + 1
    ref = op_p(torch.tensor(x, dtype=torch.float32))
    assert (y.cpu() - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["PackedKronBatch", "PackedFDMBatch",
                                  "PackedKronSingle", "PackedFDMSingle"])
def test_cuda_serving_graded_neumann_per_axis(cuda_device, kind):
    """#18-#21 on a graded box with a Neumann axis and per-axis kappa
    against their plain versions: <= 1e-5."""
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh, geometric_spacing
    from pmg_dolfinx_tpu_torch.ops import kron_packed as kp

    mesh = BoxMesh((5, 4, 6), dirichlet_faces=((False, False), (True, True),
                                               (True, True)),
                   spacing=(None, None, geometric_spacing(6, 8.0)))
    B = 1 if "Single" in kind else 8
    kw = dict(kappa=(1.0, 1.0, 100.0), sigma=0.5)
    if "Batch" in kind:
        kw["B"] = B
    c = getattr(kp, kind)(mesh, 6, device=cuda_device, **kw)
    p = getattr(kp, kind)(mesh, 6, device="cpu", **kw)
    U = np.random.default_rng(8).standard_normal((B, mesh.num_dofs(6)))
    if "Single" in kind:
        U = U[0]
    fn = (lambda o, u: o(u)) if "Kron" in kind else (
        lambda o, u: o.solve(u))
    got = fn(c, torch.tensor(U, dtype=torch.float32, device=cuda_device))
    want = fn(p, torch.tensor(U, dtype=torch.float32))
    assert (got.cpu() - want).abs().max() <= 1e-5 * want.abs().max()
