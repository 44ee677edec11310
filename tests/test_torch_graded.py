"""Graded (non-uniform) spacing in the port against the JAX package.

Mirrors the JAX package's ``tests/test_graded.py`` at small sizes, f64:
- the mesh (`BoxMesh` / `PerturbedBoxMesh` ``spacing``,
  `geometric_spacing`): cell widths, nodes, dof coordinates, centroids
  and the ``h`` / ``is_graded`` contract equal JAX's bit for bit, and the
  same ValueErrors;
- the Kronecker apply and diagonal, the blocked kernels' setup arrays (a
  non-Toeplitz factor) and the FDM direct solve, to 1e-12;
- `PMGHierarchy` on graded meshes (kron + fdm, kron + hmg, lattice + cg,
  dofmap + direct, the curved lattice + hmg): the eigenvalue estimates
  and one V-cycle on a seeded input to 1e-12, the FCG(V) counts equal;
- the transient box evolvers (heat BE / CN, leapfrog) to 1e-10 and the
  serving classes (f32) to 1e-6.
- On the card (marked ``cuda``, skipped without a GPU): kernels #1-#3,
  #4/#7, #10/#11 and #12 on graded factors with Robin ends against their
  plain versions (``python -m pytest --noconftest -m cuda
  tests/test_torch_graded.py``).
"""

import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pmg_dolfinx_tpu_torch.fem import mesh as tmesh  # noqa: E402

NC = (3, 4, 3)
SPACING = (np.random.default_rng(0).uniform(0.5, 2.0, 3), None,
           tmesh.geometric_spacing(3, 8.0))
FACES = ((False, False), (True, True), (True, False))
ROBIN = ((1.5, 2.0), (0.0, 0.0), (0.0, 0.7))


@pytest.fixture(scope="module")
def jx():
    """The JAX reference modules (imported here: the card tests of this
    file need no JAX)."""
    pytest.importorskip("jax")
    from types import SimpleNamespace

    import jax.numpy as jnp

    from pmg_dolfinx_tpu.fem import mesh
    from pmg_dolfinx_tpu.ops import kron, pallas_kron_blocked, pallas_kron_packed
    from pmg_dolfinx_tpu.solvers import fdm, pmg, transient

    return SimpleNamespace(jnp=jnp, mesh=mesh, kron=kron,
                           jkb=pallas_kron_blocked, jkp=pallas_kron_packed,
                           fdm=fdm, pmg=pmg, transient=transient)


def _np(a):
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _meshes(jx, kind="BoxMesh", **kw):
    return getattr(jx.mesh, kind)(NC, **kw), getattr(tmesh, kind)(NC, **kw)


@pytest.mark.parametrize("kind", ["BoxMesh", "PerturbedBoxMesh"])
def test_graded_mesh_arrays_match_jax(jx, kind):
    jm, tm = _meshes(jx, kind, spacing=SPACING)
    assert tm.is_graded and jm.is_graded
    for a in range(3):
        assert np.array_equal(tm.h_cells[a], jm.h_cells[a])
        assert np.array_equal(tm.axis_nodes(a), jm.axis_nodes(a))
    assert np.array_equal(tm.geometry_x, jm.geometry_x)
    assert np.array_equal(tm.cell_centroids(), jm.cell_centroids())
    for P in (1, 3):
        assert np.array_equal(tm.dof_coords(P), jm.dof_coords(P))
    with pytest.raises(ValueError, match="graded"):
        tm.h
    ju, tu = _meshes(jx, kind, spacing=(None, np.full(4, 2.0), None))
    assert not tu.is_graded and tu.h == ju.h
    if kind == "BoxMesh":
        assert repr(tm) == repr(jm)


def test_spacing_validation_matches_jax(jx):
    for n, r in ((5, 8.0), (1, 3.0), (4, 0.25)):
        assert np.array_equal(tmesh.geometric_spacing(n, r),
                              jx.mesh.geometric_spacing(n, r))
    for bad in (dict(spacing=(None, None)),
                dict(spacing=(np.ones(2), None, None)),
                dict(spacing=(np.array([1.0, -1.0, 1.0]), None, None))):
        with pytest.raises(ValueError) as ej:
            jx.mesh.BoxMesh(NC, **bad)
        with pytest.raises(ValueError) as et:
            tmesh.BoxMesh(NC, **bad)
        assert str(et.value) == str(ej.value)
    for args in ((0, 2.0), (3, 0.0)):
        with pytest.raises(ValueError):
            tmesh.geometric_spacing(*args)


@pytest.mark.parametrize("P", [2, 3])
def test_graded_kron_and_fdm_match_jax(jx, P):
    """`KronLaplacian` (per-axis kappa, Robin ends, mixed faces) apply and
    diagonal, the blocked kernels' setup arrays, and the FDM solve and its
    refinement on the graded box."""
    from pmg_dolfinx_tpu_torch.ops import kron_blocked as tkb
    from pmg_dolfinx_tpu_torch.ops.kron import KronLaplacian
    from pmg_dolfinx_tpu_torch.solvers.fdm import FastDiagonalizationSolver

    kw = dict(dirichlet_faces=FACES, robin=ROBIN, spacing=SPACING)
    jm, tm = _meshes(jx, **kw)
    kappa = (1.0, 2.5, 0.5)
    x = np.random.default_rng(P).standard_normal(tm.num_dofs(P))
    jop = jx.kron.KronLaplacian(jm, P, kappa=kappa, dtype=jx.jnp.float64,
                                sigma=0.3)
    top = KronLaplacian(tm, P, kappa=kappa, dtype=torch.float64, sigma=0.3,
                        device="cpu")
    assert _rel(top(torch.tensor(x)), jop(jx.jnp.asarray(x))) <= 1e-12
    assert _rel(top.diag, jop.diag) <= 1e-12
    fm_j = jx.jkb.checked_face_masks(jm, P, jm.boundary_dof_marker(P))
    fm_t = tkb.checked_face_masks(tm, P, tm.boundary_dof_marker(P))
    jmats = jx.jkb.symmetrized_mats(jop.Ks, jop.ms, dtype=jx.jnp.float64,
                                    face_masks=fm_j)
    tmats = tkb.symmetrized_mats([_np(K) for K in jop.Ks],
                                 [_np(m) for m in jop.ms], torch.float64,
                                 fm_t, band=P, device="cpu")
    for k in ("Ktx", "Kty", "KtzT", "sx2d", "sycol", "sxzm", "s23m", "mx2",
              "myb", "mzrow"):
        assert np.array_equal(_np(tmats[k]), _np(jmats[k])), k
    jfd = jx.fdm.FastDiagonalizationSolver(jm, P, kappa=kappa,
                                           dtype=jx.jnp.float64, sigma=0.3)
    tfd = FastDiagonalizationSolver(tm, P, kappa=kappa, dtype=torch.float64,
                                    sigma=0.3, device="cpu")
    assert _rel(tfd.solve(x), jfd.solve(jx.jnp.asarray(x))) <= 1e-12
    # the solve inverts the apply it was built with
    assert _rel(top(tfd.solve(x)), x) <= 1e-12
    jfd32 = jx.fdm.FastDiagonalizationSolver(jm, P, kappa=kappa, sigma=0.3)
    tfd32 = FastDiagonalizationSolver(tm, P, kappa=kappa, sigma=0.3,
                                      device="cpu")
    (uj, rj), (ut, rt) = jfd32.refine(x, 3), tfd32.refine(x, 3)
    assert _rel(ut, uj) <= 1e-12 and rt[-1] < 1e-10 * rt[0]


HIER_CASES = [
    ("BoxMesh", "kron", "fdm"),
    ("BoxMesh", "kron", "hmg"),
    ("BoxMesh", "lattice", "cg"),
    ("BoxMesh", "dofmap", "direct"),
    ("PerturbedBoxMesh", "lattice", "hmg"),
]


@pytest.mark.parametrize("kind,operator,coarse", HIER_CASES)
def test_graded_hierarchy_matches_jax(jx, kind, operator, coarse):
    faces = FACES if kind == "BoxMesh" else True
    jm, tm = _meshes(jx, kind, dirichlet_faces=faces, spacing=SPACING)
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    kw = dict(degrees=(1, 2), kappa=2.0, operator=operator, coarse=coarse)
    jh = jx.pmg.PMGHierarchy(jm, dtype=jx.jnp.float64, **kw)
    th = PMGHierarchy(tm, dtype=torch.float64, device="cpu", **kw)
    for ej, et in zip(jh.eigs, th.eigs):
        assert np.max(np.abs(np.asarray(et) - np.asarray(ej))
                      / np.abs(np.asarray(ej))) <= 1e-12
    b = np.random.default_rng(7).standard_normal(tm.num_dofs(2))
    assert _rel(th.apply(b, np.zeros_like(b)),
                jh.apply(jx.jnp.asarray(b), jx.jnp.zeros(b.shape))) <= 1e-12
    _, itj = jh.solve_pcg(jx.jnp.asarray(b), rtol=1e-8)
    _, itt = th.solve_pcg(b, rtol=1e-8)
    assert itt == itj


@pytest.mark.parametrize("scheme", ["be", "cn", "leapfrog"])
def test_graded_box_evolvers_match_jax(jx, scheme):
    from pmg_dolfinx_tpu_torch.solvers import transient as tt

    jm, tm = _meshes(jx, dirichlet_faces=FACES, spacing=SPACING)
    P, kappa = 2, (2.0, 1.0, 0.5)
    u0 = np.random.default_rng(3).standard_normal(tm.num_dofs(P))
    u0[tm.boundary_dof_marker(P)] = 0.0
    if scheme == "leapfrog":
        dt = 0.5 * tt.wave_stable_dt(tm, P, kappa=kappa)
        assert abs(dt / (0.5 * jx.transient.wave_stable_dt(
            jm, P, kappa=kappa)) - 1) <= 1e-12
        uj, vj = jx.transient.wave_leapfrog_evolve(jm, P, kappa=kappa,
                                                   dt=dt)(u0, 0 * u0, 4)
        ut, vt = tt.wave_leapfrog_evolve(tm, P, kappa=kappa, dt=dt,
                                         device="cpu")(u0, 0 * u0, 4)
        assert _rel(vt, vj) <= 1e-10
    else:
        kw = dict(kappa=kappa, dt=2e-3, scheme=scheme)
        uj = jx.transient.heat_fdm_evolve(jm, P, **kw)(u0, 4)
        ut = tt.heat_fdm_evolve(tm, P, device="cpu", **kw)(u0, 4)
    assert _rel(ut, uj) <= 1e-10


@pytest.mark.parametrize("kind", ["PackedKronBatch", "PackedFDMBatch",
                                  "PackedKronSingle", "PackedFDMSingle"])
def test_graded_serving_classes_match_jax(jx, kind):
    """The serving factors on a graded box with per-axis kappa and a
    Neumann axis (the FDM's zero eigenvalue lifted by the other axes'
    Dirichlet faces), f32 to 1e-6 against JAX's emulation."""
    from pmg_dolfinx_tpu_torch.ops import kron_packed as kp

    faces = ((False, False), (True, True), (True, True))
    jm, tm = _meshes(jx, dirichlet_faces=faces, spacing=SPACING)
    P, B = 3, (1 if "Single" in kind else 3)
    kw = dict(kappa=(1.0, 1.0, 4.0), sigma=0.2)
    if "Batch" in kind:
        kw["B"] = B
    j = getattr(jx.jkp, kind)(jm, P, **kw)
    t = getattr(kp, kind)(tm, P, device="cpu", **kw)
    U = np.random.default_rng(4).standard_normal(
        (B, tm.num_dofs(P))).astype(np.float32)
    if "Single" in kind:
        U = U[0]
    if "Kron" in kind:
        got, want = t(U), j(jx.jnp.asarray(U))
    else:
        got, want = t.solve(U), j.solve(jx.jnp.asarray(U))
    assert _rel(got, want) <= 1e-6


# --- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _graded_robin_hierarchy(device, fuse):
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    mesh = tmesh.BoxMesh((6, 5, 7), dirichlet_faces=FACES, robin=ROBIN,
                         spacing=(None, None, tmesh.geometric_spacing(7, 8)))
    return mesh, PMGHierarchy(mesh, degrees=(1, 3, 6), kappa=(1.0, 2.0, 3.0),
                              dtype=torch.float32, operator="kron_blocked",
                              coarse="fdm", fuse_smoother=fuse,
                              fuse_transfers=fuse, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [False, True])
def test_cuda_graded_robin_cycle_matches_plain(cuda_device, fuse):
    """One V-cycle of the kron_blocked hierarchy on a graded box with
    Robin ends and per-axis kappa (#1-#3 unfused; #4/#7 and #10/#11
    fused) against the same cycle on the CPU (the plain versions, same
    calibrated state): <= 1e-5 relative."""
    from pmg_dolfinx_tpu_torch.ops import kron_blocked as tkb
    from pmg_dolfinx_tpu_torch.ops import transfer as ttr

    _, hc = _graded_robin_hierarchy(cuda_device, fuse)
    _, hp = _graded_robin_hierarchy("cpu", fuse)
    hp.load_state({k: v for k, v in hc.data.items()
                   if k in ("levels", "transfer", "fdm")})
    b = np.random.default_rng(5).standard_normal(hc.levels[-1].ndofs)
    before = dict(tkb.LAUNCHES), dict(ttr.LAUNCHES)
    got = hc.apply(b, np.zeros_like(b))
    want = hp.apply(b, np.zeros_like(b))
    assert _rel(got.cpu(), want) <= 1e-5
    launched = sum(tkb.LAUNCHES.values()) + sum(ttr.LAUNCHES.values())
    assert launched > sum(before[0].values()) + sum(before[1].values())


@pytest.mark.cuda
def test_cuda_kron_fused_graded_matches_plain(cuda_device):
    """#12 (`PallasKronLaplacian`) on graded factors with Robin ends and
    per-axis kappa against its plain version: <= 1e-5."""
    from pmg_dolfinx_tpu_torch.ops import kron_fused as tkf

    mesh = tmesh.BoxMesh((5, 6, 7), dirichlet_faces=FACES, robin=ROBIN,
                         spacing=(None, None, tmesh.geometric_spacing(7, 8)))
    x = np.random.default_rng(6).standard_normal(mesh.num_dofs(6))
    op_c = tkf.PallasKronLaplacian(mesh, 6, kappa=(1.0, 2.0, 3.0),
                                   device=cuda_device)
    op_p = tkf.PallasKronLaplacian(mesh, 6, kappa=(1.0, 2.0, 3.0),
                                   device="cpu")
    assert _rel(op_c(torch.tensor(x, dtype=torch.float32,
                                  device=cuda_device)).cpu(),
                op_p(torch.tensor(x, dtype=torch.float32))) <= 1e-5
