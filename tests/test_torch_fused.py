"""Parity of the port's full-bc blocked kernels and fused Chebyshev
smoother with the JAX package.

- f64: the plain full-bc versions (`plain_t1`, `plain_apply`,
  `plain_residual`) and `blocked_kron_cheb4` against the JAX emulation
  path (``_emu_t1`` / ``_emu_apply``, ``interpret=None`` on the CPU):
  <= 1e-12 relative.
- f32: the entry points ``blocked_kron_apply(x3, bc3, mats)`` /
  ``blocked_kron_residual(b3, u3, bc3, mats)`` with ``mats`` from
  ``symmetrized_mats(Ks, ms)`` (no face masks: the full-bc kernels)
  against the JAX Pallas kernels run with ``interpret=True``: <= 1e-5.
  A box marker and a non-separable one (box faces plus interior dofs),
  sigma in {0, 37}.
- `plain_t23` (#5) and its residual form (#6) against JAX's
  `_kernel_t23` / `_kernel_t23_res` (``interpret=True``) on random banded
  operands and markers that stress the y-march (marked rows at chunk
  borders, marked columns in a warp's z halo) at awkward shapes: <= 1e-5.
- `blocked_kron_cheb4` against JAX's (``interpret=True``,
  ``BoxMesh((5,4,3))``, P=4, f32) and against the port's generic
  `chebyshev4_solve`: <= 1e-6 (JAX's own gate, `tests/test_pallas.py`).
- ``PMGHierarchy(fuse_smoother=True)`` on the JAX hierarchy's state
  (`utils.convert`, `load_state`): f32 residual trajectories <= 1e-4
  relative; the option errors of the JAX package.
- On the card, each new CUDA kernel against its plain version (marked
  ``cuda``; skipped without a GPU). That test needs no JAX, so on a GPU
  machine without JAX it runs as
  ``python -m pytest --noconftest -m cuda tests/test_torch_fused.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh as TBoxMesh  # noqa: E402
from pmg_dolfinx_tpu_torch.ops import kron_blocked as tkb  # noqa: E402
from pmg_dolfinx_tpu_torch.ops.kron import (  # noqa: E402
    axis_stiffness_mass,
    kron_laplacian_apply,
)
from pmg_dolfinx_tpu_torch.solvers.chebyshev import chebyshev4_solve  # noqa: E402

NC = (3, 4, 5)
P = 3


@pytest.fixture
def jx():
    """The JAX reference modules, imported here so that the card test of
    this file does not need JAX."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from pmg_dolfinx_tpu.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu.ops import pallas_kron_blocked
    from pmg_dolfinx_tpu.ops.kron import KronLaplacian
    from pmg_dolfinx_tpu.solvers.pmg import PMGHierarchy

    return SimpleNamespace(jax=jax, jnp=jnp, BoxMesh=BoxMesh,
                           jkb=pallas_kron_blocked,
                           KronLaplacian=KronLaplacian,
                           PMGHierarchy=PMGHierarchy)


def _marker(mesh, P, separable):
    """The box marker, or the box marker plus three interior dofs."""
    bc3 = np.asarray(mesh.boundary_dof_marker(P)).reshape(
        mesh.lattice_shape(P)).copy()
    if not separable:
        bc3[2, 2, 2] = bc3[1, 3, 4] = bc3[4, 1, 2] = True
    return bc3


def _setup(jx, separable, dtype, jdtype, seed=0):
    jm = jx.BoxMesh(NC)
    base = jx.KronLaplacian(jm, P, kappa=2.0, dtype=jdtype)
    bc3 = _marker(jm, P, separable)
    jmats = jx.jkb.symmetrized_mats(base.Ks, base.ms, dtype=jdtype)
    tmats = tkb.symmetrized_mats([np.asarray(K) for K in base.Ks],
                                 [np.asarray(m) for m in base.ms],
                                 band=P, device="cpu", dtype=dtype)
    rng = np.random.default_rng(seed)
    shape = bc3.shape
    return bc3, jmats, tmats, rng.standard_normal(shape), \
        rng.standard_normal(shape)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _rel2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_setup_arrays_equal_without_face_masks(jx):
    """``symmetrized_mats`` without face masks gives JAX's bc-array set
    (``sxz``/``s23`` included) bit for bit, and nothing separable."""
    _, jmats, tmats, _, _ = _setup(jx, True, torch.float64, jx.jnp.float64)
    assert set(tmats) - {"band"} == set(jmats)
    for k, v in jmats.items():
        assert np.array_equal(tmats[k].numpy(), np.asarray(v)), k


@pytest.mark.parametrize("sigma", [0.0, 37.0])
@pytest.mark.parametrize("separable", [True, False])
def test_plain_full_bc_matches_emulation_f64(jx, separable, sigma):
    jnp, jkb = jx.jnp, jx.jkb
    bc3, jmats, tmats, x, b = _setup(jx, separable, torch.float64,
                                     jnp.float64)
    tbc = torch.from_numpy(bc3)
    tx, tb = torch.from_numpy(x), torch.from_numpy(b)
    t1_j = jkb._emu_t1(jnp.asarray(x), bc3, jmats)
    assert _rel(tkb.plain_t1(tx, tbc, tmats).numpy(), t1_j) <= 1e-12
    y_j = jkb._emu_apply(jnp.asarray(x), bc3, t1_j, jmats, sigma=sigma)
    assert _rel(tkb.plain_apply(tx, tbc, tmats, sigma).numpy(), y_j) <= 1e-12
    r_j = jkb.blocked_kron_residual(jnp.asarray(b), jnp.asarray(x), bc3,
                                    jmats, sigma=sigma)
    assert _rel(tkb.blocked_kron_residual(tb, tx, tbc, tmats,
                                          sigma=sigma).numpy(), r_j) <= 1e-12
    dinv = np.abs(np.random.default_rng(5).standard_normal(bc3.shape)) + 0.5
    c_j = jkb.blocked_kron_cheb4(jnp.asarray(b), jnp.asarray(x), bc3, jmats,
                                 jnp.asarray(dinv), jnp.asarray(7.5), 3,
                                 sigma=sigma)
    c_t = tkb.blocked_kron_cheb4(tb, tx, tbc, tmats, torch.from_numpy(dinv),
                                 torch.tensor(7.5, dtype=torch.float64), 3,
                                 sigma=sigma)
    assert _rel(c_t.numpy(), c_j) <= 1e-12


@pytest.mark.parametrize("sigma", [0.0, 37.0])
@pytest.mark.parametrize("separable", [True, False])
def test_entry_points_match_pallas_interpret_f32(jx, separable, sigma):
    jnp, jkb = jx.jnp, jx.jkb
    bc3, jmats, tmats, x, b = _setup(jx, separable, torch.float32,
                                     jnp.float32)
    x32, b32 = x.astype(np.float32), b.astype(np.float32)
    tbc = torch.from_numpy(bc3)
    y_j = jkb.blocked_kron_apply(jnp.asarray(x32), bc3, jmats,
                                 interpret=True, sigma=sigma)
    y_t = tkb.blocked_kron_apply(torch.from_numpy(x32), tbc, tmats,
                                 sigma=sigma)
    assert y_t.dtype == torch.float32
    assert _rel(y_t.numpy(), y_j) <= 1e-5
    r_j = jkb.blocked_kron_residual(jnp.asarray(b32), jnp.asarray(x32), bc3,
                                    jmats, interpret=True, sigma=sigma)
    r_t = tkb.blocked_kron_residual(torch.from_numpy(b32),
                                    torch.from_numpy(x32), tbc, tmats,
                                    sigma=sigma)
    assert _rel(r_t.numpy(), r_j) <= 1e-5


# Shapes that stress the y-march of kernels #5 / #6: an axis no longer
# than 2 band + 1, rows past the march chunks' borders, z extents off the
# 32-lane grid (13, 33) and under one warp (9).
MARCH_SHAPES = [((7, 3, 9), 1), ((5, 37, 33), 3), ((4, 70, 13), 6)]


def _stress_case(shape, band, seed):
    """Random symmetric banded ``K_a`` and positive masses (the full-bc
    arrays, f32), and non-separable markers that stress kernels #5 / #6:
    whole marked y-rows at the march chunks' borders, and marked columns
    on both sides of each 32-column warp border (the z halo), each over
    the x = 0 and y faces plus a random 3% of the dofs."""
    rng = np.random.default_rng(seed)
    Ks = []
    for n in shape:
        A = rng.standard_normal((n, n))
        i, j = np.indices((n, n))
        A[np.abs(i - j) > band] = 0.0
        Ks.append(A + A.T)
    ms = [rng.uniform(0.5, 2.0, n) for n in shape]
    mats = tkb.symmetrized_mats(Ks, ms, torch.float32, band=band,
                                device="cpu")
    markers = []
    for axis, cut in ((1, lambda a: a % 16 in (0, 1, 15) and a < shape[1] - 2),
                      (2, lambda a: a % 32 in (0, 1, 2, 29, 30, 31))):
        bc = rng.random(shape) < 0.03
        bc[0], bc[:, 0], bc[:, -1] = True, True, True
        for a in range(shape[axis]):
            if cut(a):
                idx = [slice(None)] * 3
                idx[axis] = a
                bc[tuple(idx)] = True
        markers.append(bc)
    return rng, mats, markers


@pytest.mark.parametrize("shape,band", MARCH_SHAPES)
def test_plain_t23_stress_markers_match_pallas_interpret(jx, shape, band):
    """f32: `plain_t23` (kernel #5) and ``r - plain_t23`` (#6) against
    JAX's `_kernel_t23` / `_kernel_t23_res` run with ``interpret=True`` on
    the same operands, on markers that stress the march, sigma 0 and 0.5:
    <= 1e-5 relative max-norm (f32, another summation order)."""
    jnp, jkb = jx.jnp, jx.jkb
    rng, m, markers = _stress_case(shape, band, 3 * sum(shape) + band)
    ops = [jnp.asarray(m[k].numpy()) for k in ("Kty", "KtzT", "sx2d",
                                               "sycol", "s23")]
    x, r = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    tx, tr = torch.from_numpy(x), torch.from_numpy(r)
    for sigma in (0.0, 0.5):
        t23 = jkb._build_calls(shape, 8, 8, False, True, (), sigma)[1]
        res = jkb._build_res_call(shape, 8, False, True, (), sigma)
        for bc in markers:
            tbc = torch.from_numpy(bc)
            t1 = tkb.plain_t1(tx, tbc, m)
            args = (jnp.asarray(x), jnp.asarray(bc), jnp.asarray(t1.numpy()),
                    *ops)
            y = tkb.plain_t23(tx, tbc, t1, m, sigma)
            assert _rel(y.numpy(), t23(*args)) <= 1e-5, sigma
            assert _rel(tkb.kron_t23(tx, tbc, t1, m, sigma, r3=tr).numpy(),
                        res(*args, jnp.asarray(r))) <= 1e-5, sigma


def test_jax_signature_binds_bc3_positionally():
    """``blocked_kron_apply(x3, bc3, mats)`` as written against the JAX
    package: the second positional is the marker, the third the arrays
    (the port once took ``(x3, mats)``)."""
    mesh = TBoxMesh(NC)
    Ks, ms = zip(*(axis_stiffness_mass(n, P, h)
                   for n, h in zip(mesh.nc, mesh.h_cells)))
    Ks = [2.0 * K for K in Ks]
    box = torch.from_numpy(_marker(mesh, P, True))
    x3 = torch.from_numpy(np.random.default_rng(2).standard_normal(
        box.shape))
    # the separable arrays: bc3 is bound and not read
    sep = tkb.symmetrized_mats(
        Ks, ms, torch.float64,
        tkb.checked_face_masks(mesh, P, mesh.boundary_dof_marker(P)),
        band=P, device="cpu")
    assert torch.equal(tkb.blocked_kron_apply(x3, box, sep),
                       tkb.plain_apply_m(x3, sep))
    # the bc-array set: the marker drives the Dirichlet rows
    mats = tkb.symmetrized_mats(Ks, ms, band=P, device="cpu",
                                dtype=torch.float64)
    bc3 = torch.from_numpy(_marker(mesh, P, False))
    y = tkb.blocked_kron_apply(x3, bc3, mats)
    assert torch.equal(y[bc3], x3[bc3])
    assert torch.equal(y, tkb.plain_apply(x3, bc3, mats))
    r = tkb.blocked_kron_residual(y, x3, bc3, mats)
    assert float(r.abs().max()) == 0.0


def _cheb_problem(seed=3):
    mesh = TBoxMesh((5, 4, 3))
    P4 = 4
    shape = mesh.lattice_shape(P4)
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(shape).astype(np.float32)
    x0 = rng.standard_normal(shape).astype(np.float32)
    return mesh, P4, shape, b, x0


def test_fused_cheb4_matches_jax_interpret_and_generic(jx):
    jnp, jkb = jx.jnp, jx.jkb
    mesh, P4, shape, b, x0 = _cheb_problem()
    op = jx.KronLaplacian(jx.BoxMesh((5, 4, 3)), P4, kappa=2.0,
                          dtype=jnp.float32)
    bc3 = np.asarray(op.bc_marker).reshape(shape)
    dinv3 = np.asarray(op.diag_inv).reshape(shape)
    jmats = jkb.symmetrized_mats(op.Ks, op.ms)
    x_j = jkb.blocked_kron_cheb4(jnp.asarray(b), jnp.asarray(x0), bc3, jmats,
                                 jnp.asarray(dinv3), jnp.asarray(3.1,
                                                                 jnp.float32),
                                 2, interpret=True)
    Ks = [torch.tensor(np.asarray(K)) for K in op.Ks]
    ms = [torch.tensor(np.asarray(m)) for m in op.ms]
    tmats = tkb.symmetrized_mats(Ks, ms, band=P4, device="cpu")
    tbc = torch.tensor(bc3)
    tdinv = torch.tensor(dinv3)
    lmax = torch.tensor(3.1, dtype=torch.float32)
    x_t = tkb.blocked_kron_cheb4(torch.from_numpy(b), torch.from_numpy(x0),
                                 tbc, tmats, tdinv, lmax, 2)
    assert x_t.dtype == torch.float32
    assert _rel2(x_t.numpy(), x_j) < 1e-6
    # and against the generic recurrence over the plain kron operator
    A = lambda v: kron_laplacian_apply(v, Ks, ms, tbc)
    x_g = chebyshev4_solve(A, torch.from_numpy(b), torch.from_numpy(x0),
                           tdinv, lmax, 2)
    assert _rel2(x_t.numpy(), x_g.numpy()) < 1e-6
    # the caller's tensors are not written
    assert np.array_equal(x0, _cheb_problem()[4])


@pytest.mark.parametrize("degrees", [(1, 3), (1, 3, 6)])
def test_fused_hierarchy_matches_jax_on_jax_state(jx, degrees):
    """``PMGHierarchy(fuse_smoother=True)`` with the JAX hierarchy's state
    (the bc-array arrays ``sxz``/``s23`` arrive through `load_state`):
    four cycles of f32 residuals within 1e-4 of the JAX fused hierarchy,
    and equal FCG counts."""
    from pmg_dolfinx_tpu.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu.models.poisson import f_rhs
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy
    from pmg_dolfinx_tpu_torch.utils.convert import hierarchy_data_from_numpy

    kw = dict(degrees=degrees, kappa=2.0, coarse="fdm",
              operator="kron_blocked", fuse_smoother=True)
    jh = jx.PMGHierarchy(jx.BoxMesh((4, 4, 4)), dtype=jx.jnp.float32, **kw)
    th = PMGHierarchy(TBoxMesh((4, 4, 4)), dtype=torch.float32,
                      device="cpu", **kw)
    assert "smooth" in th.ops
    th.load_state(hierarchy_data_from_numpy(
        jx.jax.tree.map(np.asarray, jh.data), "cpu", torch.float32))
    for lt, lj in zip(th.data["levels"], jh.data["levels"]):
        for k in ("sxz", "s23", "sxzm"):
            assert np.array_equal(lt["kb_mats"][k].numpy(),
                                  np.asarray(lj["kb_mats"][k])), k
    b = assemble_rhs(jh.mesh, degrees[-1], f_rhs(2.0)).astype(np.float32)
    _, rj = jh.solve(b, num_cycles=4)
    _, rt = th.solve(torch.from_numpy(b), num_cycles=4)
    assert np.max(np.abs(np.array(rt) - rj) / np.array(rj)) <= 1e-4
    assert th.solve_pcg(torch.from_numpy(b), rtol=1e-5)[1] == \
        jh.solve_pcg(b, rtol=1e-5)[1]


def test_fuse_options_raise_as_in_jax():
    from pmg_dolfinx_tpu_torch.solvers.pmg import (
        PMGHierarchy,
        kron_blocked_cycle_ops,
    )

    # which cycle primitives each fusion option supplies (JAX :410-414)
    assert {"smooth", "residual"} <= set(kron_blocked_cycle_ops(
        fuse_smoother=True))
    assert "smooth" not in kron_blocked_cycle_ops()
    assert "residual" not in kron_blocked_cycle_ops(fuse_residual=False)

    mesh = TBoxMesh((2, 2, 2))
    for kwargs in (dict(fuse_smoother=True), dict(fuse_transfers=True)):
        with pytest.raises(ValueError, match="fuse_smoother/fuse_transfers"):
            PMGHierarchy(mesh, degrees=(1, 2), operator="kron",
                         device="cpu", **kwargs)
    # fuse_transfers=True builds, as in JAX, and swaps only the transfers
    h = PMGHierarchy(mesh, degrees=(1, 2), operator="kron_blocked",
                     dtype=torch.float32, fuse_transfers=True, device="cpu")
    plain = kron_blocked_cycle_ops()
    assert set(h.ops) == set(plain)
    tr = h.data["transfer"][0]
    lc, lf = h.levels
    r = torch.randn(lf.shape, generator=torch.Generator().manual_seed(1))
    for name, v in (("restrict", r), ("prolong", r[::2, ::2, ::2])):
        got = h.ops[name](tr, v.contiguous(), lc, lf)
        want = plain[name](tr, v.contiguous(), lc, lf)
        assert _rel2(got.numpy(), want.numpy()) <= 1e-6, name


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [0.0, 37.0])
@pytest.mark.parametrize("separable", [True, False])
def test_cuda_full_bc_kernels_match_plain(cuda_device, separable, sigma):
    mesh = TBoxMesh(NC)
    Ks, ms = zip(*(axis_stiffness_mass(n, P, h)
                   for n, h in zip(mesh.nc, mesh.h_cells)))
    mats = tkb.symmetrized_mats([2.0 * K for K in Ks], ms, band=P,
                                device=cuda_device)
    rng = np.random.default_rng(1)
    shape = mesh.lattice_shape(P)
    bc3 = torch.tensor(_marker(mesh, P, separable), device=cuda_device)
    x3, b3, r3 = (torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                               device=cuda_device) for _ in range(3))
    dinv3 = torch.rand(shape, device=cuda_device) + 0.5
    lmax = torch.tensor(3.1, device=cuda_device)
    before = dict(tkb.LAUNCHES)
    t1 = tkb.kron_t1(x3, bc3, mats)
    assert _rel(t1.cpu(), tkb.plain_t1(x3, bc3, mats).cpu()) <= 1e-5
    y = tkb.kron_t23(x3, bc3, t1, mats, sigma)
    assert _rel(y.cpu(), tkb.plain_t23(x3, bc3, t1, mats, sigma).cpu()) <= 1e-5
    r = tkb.blocked_kron_residual(b3, x3, bc3, mats, sigma=sigma)
    assert _rel(r.cpu(), tkb.plain_residual(b3, x3, bc3, mats,
                                            sigma).cpu()) <= 1e-5
    for k, (v, x) in enumerate(((x3, x3), (r3, x3))):
        got = tkb.kron_t23_cheb(v, bc3, t1, mats, x, b3, dinv3, lmax, k, sigma)
        want = tkb.plain_cheb_step(
            v, bc3, x, b3, dinv3, tkb.cheb_coefs(lmax, k, torch.float32,
                                                 cuda_device),
            mats, sigma, t1=t1)
        for g, w in zip(got, want):
            assert _rel(g.cpu(), w.cpu()) <= 1e-5
    assert tkb.LAUNCHES["t1"] == before["t1"] + 2
    assert tkb.LAUNCHES["t23"] == before["t23"] + 1
    assert tkb.LAUNCHES["t23_res"] == before["t23_res"] + 1
    assert tkb.LAUNCHES["t23_cheb"] == before["t23_cheb"] + 2
    x_f = tkb.blocked_kron_cheb4(b3, x3, bc3, mats, dinv3, lmax, 2,
                                 sigma=sigma)
    x_p = tkb.blocked_kron_cheb4(b3.cpu(), x3.cpu(), bc3.cpu(),
                                 {k: (v.cpu() if torch.is_tensor(v) else v)
                                  for k, v in mats.items()},
                                 dinv3.cpu(), lmax.cpu(), 2, sigma=sigma)
    assert _rel2(x_f.cpu(), x_p) <= 1e-5
    with pytest.raises(TypeError, match="bool"):
        tkb.kron_t1(x3, bc3.float(), mats)
