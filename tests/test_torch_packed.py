"""The port's serving kernels module (`ops.kron_packed`) against the JAX
package's lane-packed classes (`ops.pallas_kron_packed`).

- Each of the four classes against its JAX twin on `BoxMesh((3, 3, 3))`
  and `((4, 4, 4))` at p=2 and p=3, B in {1, 3, 4} (3 is not a multiple
  of the TPU packing's g): the port's plain torch versions against the
  JAX emulation path (``interpret=False``) and, for one small case per
  class, against the Pallas kernel bodies in interpret mode; sigma > 0
  and mixed faces; float32, <= 1e-6 relative (norm-wise).
- The direct solve inverts the apply; the single classes equal the batch
  classes at B=1; `utils.convert.packed_state_from_numpy` turns the JAX
  classes' lane-packed factors into exactly the port's factors.
- The same `ValueError`s as JAX (NZ <= 64, the single apply's slab
  height, singular operators, precision names); ``precision='high'`` and
  per-axis kappa raise NotImplementedError.
- On the card, each CUDA kernel against its plain version through all
  four classes (marked ``cuda``; skipped without a GPU). Those tests need
  no JAX: ``python -m pytest --noconftest -m cuda
  tests/test_torch_packed.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh  # noqa: E402
from pmg_dolfinx_tpu_torch.ops import kron_packed as kp  # noqa: E402

MIXED = ((True, False), (False, False), (True, True))
CASES = [(nc, P, B) for nc in ((3, 3, 3), (4, 4, 4)) for P in (2, 3)
         for B in (1, 3, 4)]


@pytest.fixture
def jx():
    """The JAX reference modules, imported here so that the card tests of
    this file do not need JAX."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from pmg_dolfinx_tpu.fem.mesh import BoxMesh as JBoxMesh
    from pmg_dolfinx_tpu.ops import pallas_kron_packed as jkp

    return SimpleNamespace(jnp=jnp, BoxMesh=JBoxMesh, jkp=jkp)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _batch(mesh, P, B, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, mesh.num_dofs(P))).astype(np.float32)


def _pair(jx, kind, nc, P, B, faces=True, sigma=0.0, interpret=False):
    """The JAX and port objects of one class on the same mesh."""
    jm = jx.BoxMesh(nc, dirichlet_faces=faces)
    tm = BoxMesh(nc, dirichlet_faces=faces)
    kw = dict(kappa=2.0, sigma=sigma)
    if kind in ("PackedKronBatch", "PackedFDMBatch"):
        kw["B"] = B
    j = getattr(jx.jkp, kind)(jm, P, interpret=interpret, **kw)
    t = getattr(kp, kind)(tm, P, device="cpu", **kw)
    return tm, j, t


@pytest.mark.parametrize("nc,P,B", CASES)
def test_kron_batch_matches_jax(jx, nc, P, B):
    tm, j, t = _pair(jx, "PackedKronBatch", nc, P, B)
    U = _batch(tm, P, B)
    got = t(U)
    assert got.dtype == torch.float32 and tuple(got.shape) == U.shape
    assert _rel(got, j(jx.jnp.asarray(U))) <= 1e-6
    U4 = U.reshape((B,) + tm.lattice_shape(P))
    assert tuple(t(U4).shape) == U4.shape


@pytest.mark.parametrize("nc,P,B", CASES)
def test_fdm_batch_matches_jax(jx, nc, P, B):
    tm, j, t = _pair(jx, "PackedFDMBatch", nc, P, B)
    U = _batch(tm, P, B, seed=1)
    got = t.solve(U)
    assert got.dtype == torch.float32
    assert _rel(got, j.solve(jx.jnp.asarray(U))) <= 1e-6
    bc = tm.boundary_dof_marker(P)
    assert np.array_equal(got.numpy()[:, bc], U[:, bc])


@pytest.mark.parametrize("kind", ["PackedKronSingle", "PackedFDMSingle"])
@pytest.mark.parametrize("nc,P", [((3, 3, 3), 2), ((3, 3, 3), 3),
                                  ((4, 4, 4), 2), ((4, 4, 4), 3)])
def test_single_matches_jax_and_batch(jx, kind, nc, P):
    """The single classes against JAX's x-slab emulation, and equal to the
    port's batch class at B=1 (the same factors, the same function)."""
    tm, j, t = _pair(jx, kind, nc, P, 1, sigma=0.7)
    x = _batch(tm, P, 1, seed=2)[0]
    if kind == "PackedKronSingle":
        got, want = t(x), j(jx.jnp.asarray(x))
        batch = kp.PackedKronBatch(tm, P, kappa=2.0, B=1, sigma=0.7,
                                   device="cpu")(x[None])[0]
    else:
        got, want = t.solve(x), j.solve(jx.jnp.asarray(x))
        batch = kp.PackedFDMBatch(tm, P, kappa=2.0, B=1, sigma=0.7,
                                  device="cpu").solve(x[None])[0]
    assert tuple(got.shape) == x.shape
    assert _rel(got, want) <= 1e-6
    assert torch.equal(got, batch)


@pytest.mark.parametrize("kind", ["PackedKronBatch", "PackedFDMBatch",
                                  "PackedKronSingle", "PackedFDMSingle"])
def test_matches_pallas_interpret(jx, kind):
    """One small case per class against the Pallas kernel body run by the
    Pallas interpreter (the lane rolls and slab corners included)."""
    tm, j, t = _pair(jx, kind, (3, 3, 3), 2, 3, interpret=True)
    single = kind.endswith("Single")
    U = _batch(tm, 2, 1 if single else 3, seed=3)
    U = U[0] if single else U
    call = (lambda o, u: o(u)) if "Kron" in kind else (
        lambda o, u: o.solve(u))
    assert _rel(call(t, U), call(j, jx.jnp.asarray(U))) <= 1e-6


@pytest.mark.parametrize("kind", ["PackedKronBatch", "PackedFDMBatch"])
def test_sigma_and_mixed_faces(jx, kind):
    tm, j, t = _pair(jx, kind, (4, 3, 5), 3, 3, faces=MIXED, sigma=7.5)
    U = _batch(tm, 3, 3, seed=4)
    call = (lambda o, u: o(u)) if "Kron" in kind else (
        lambda o, u: o.solve(u))
    assert _rel(call(t, U), call(j, jx.jnp.asarray(U))) <= 1e-6


def test_fdm_is_exact_inverse():
    """solve inverts the apply at the same shift: A (A^-1 b) = b."""
    mesh = BoxMesh((4, 5, 3), dirichlet_faces=MIXED)
    P, B, sigma = 3, 3, 4.2
    op = kp.PackedKronBatch(mesh, P, B=B, sigma=sigma, device="cpu")
    fdm = kp.PackedFDMBatch(mesh, P, B=B, sigma=sigma, device="cpu")
    U = torch.from_numpy(_batch(mesh, P, B, seed=5))
    assert _rel(op(fdm.solve(U)), U) <= 1e-5
    # and the diagonal is the KronLaplacian's
    from pmg_dolfinx_tpu_torch.ops.kron import KronLaplacian

    base = KronLaplacian(mesh, P, kappa=2.0, sigma=sigma, device="cpu")
    assert torch.equal(op.diag, base.diag)
    assert torch.equal(op.diag_inv, base.diag_inv)


@pytest.mark.parametrize("kind", ["PackedKronBatch", "PackedFDMBatch",
                                  "PackedKronSingle", "PackedFDMSingle"])
def test_pack_unpack_roundtrip(kind):
    mesh = BoxMesh((4, 5, 3))
    kw = {} if kind.endswith("Single") else {"B": 3}
    obj = getattr(kp, kind)(mesh, 2, device="cpu", **kw)
    lead = () if kind.endswith("Single") else (3,)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        lead + mesh.lattice_shape(2)).astype(np.float32))
    packed = obj.pack(x.reshape(lead + (-1,)))
    assert packed.is_contiguous() and packed.dtype == torch.float32
    assert tuple(packed.shape) == lead + mesh.lattice_shape(2)
    assert torch.equal(obj.unpack(packed), x)


@pytest.mark.parametrize("kind", ["kron", "fdm"])
def test_state_from_numpy_roundtrip(jx, kind):
    """The JAX lane-packed factors, unpacked, are exactly the port's; the
    converted state gives the same batch result."""
    from pmg_dolfinx_tpu_torch.utils.convert import packed_state_from_numpy

    cls = "PackedKronBatch" if kind == "kron" else "PackedFDMBatch"
    tm, j, t = _pair(jx, cls, (4, 3, 5), 3, 3, faces=MIXED, sigma=2.0)
    mats = {k: np.asarray(v) for k, v in j.mats.items()}
    mats["bcp"] = np.asarray(j.bcp)
    conv = packed_state_from_numpy(mats, kind, tm.lattice_shape(3),
                                   device="cpu")
    keys = kp.KRON_KEYS if kind == "kron" else kp.FDM_KEYS
    for k in keys:
        assert torch.equal(conv[k], t.mats[k]), k
    U = torch.from_numpy(_batch(tm, 3, 3, seed=7)).reshape(
        (3,) + tm.lattice_shape(3))
    if kind == "kron":
        assert conv["band"] == t.mats["band"] == 3
        assert torch.equal(kp.packed_apply(U, conv, 2.0), t.apply_packed(U))
    else:
        assert torch.equal(kp.packed_fdm(U, conv), t.solve_packed(U))
    with pytest.raises(ValueError, match="kind"):
        packed_state_from_numpy(mats, "csr", tm.lattice_shape(3),
                                device="cpu")


@pytest.mark.parametrize("kind", ["PackedKronBatch", "PackedFDMBatch",
                                  "PackedKronSingle", "PackedFDMSingle"])
def test_nz_limit_as_jax(jx, kind):
    """NZ = 12*6+1 = 73 > 64 at P=6: both packages refuse the lattice."""
    with pytest.raises(ValueError, match="NZ <= 64"):
        getattr(kp, kind)(BoxMesh((12, 12, 12)), 6, device="cpu")
    with pytest.raises(ValueError, match="NZ <= 64"):
        getattr(jx.jkp, kind)(jx.BoxMesh((12, 12, 12)), 6)


def test_slab_height_as_jax(jx):
    """The single apply's slab-height check (P=9: band 16 > XS=8)."""
    with pytest.raises(ValueError, match="XS"):
        kp.PackedKronSingle(BoxMesh((1, 3, 3)), 9, device="cpu")
    with pytest.raises(ValueError, match="XS"):
        jx.jkp.PackedKronSingle(jx.BoxMesh((1, 3, 3)), 9)
    kp.PackedKronSingle(BoxMesh((2, 4, 4)), 6, device="cpu")


@pytest.mark.parametrize("kind", ["PackedFDMBatch", "PackedFDMSingle"])
def test_singular_rejected(kind):
    mesh = BoxMesh((3, 3, 3), dirichlet_faces=((False, False),) * 3)
    with pytest.raises(ValueError, match="singular"):
        getattr(kp, kind)(mesh, 3, device="cpu")


@pytest.mark.parametrize("kind", ["PackedKronBatch", "PackedKronSingle"])
def test_precision_and_kappa_guards(kind):
    mesh = BoxMesh((3, 3, 3))
    with pytest.raises(NotImplementedError, match="precision='high'"):
        getattr(kp, kind)(mesh, 3, precision="high", device="cpu")
    with pytest.raises(ValueError, match="precision"):
        getattr(kp, kind)(mesh, 3, precision="default", device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        getattr(kp, kind)(mesh, 3, kappa=(1.0, 2.0, 3.0), device="cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nc,P,B", [((3, 4, 5), 3, 3), ((4, 4, 4), 2, 4),
                                    ((10, 10, 10), 6, 2)])
@pytest.mark.parametrize("faces", [True, MIXED])
def test_cuda_batch_kernels_match_plain(cuda_device, nc, P, B, faces):
    mesh = BoxMesh(nc, dirichlet_faces=faces)
    U = torch.tensor(_batch(mesh, P, B, seed=8), device=cuda_device).reshape(
        (B,) + mesh.lattice_shape(P))
    before = dict(kp.LAUNCHES)
    for sigma in (0.0, 1e3):
        op = kp.PackedKronBatch(mesh, P, B=B, sigma=sigma, device=cuda_device)
        fdm = kp.PackedFDMBatch(mesh, P, B=B, sigma=sigma or 1.0,
                                device=cuda_device)
        got = op.apply_packed(U)
        assert _rel(got.cpu(), kp.plain_packed_apply(U, op.mats,
                                                     sigma).cpu()) <= 1e-5
        got = fdm.solve_packed(U)
        assert _rel(got.cpu(), kp.plain_packed_fdm(U, fdm.mats).cpu()) <= 1e-5
    assert kp.LAUNCHES["packed_apply"] == before["packed_apply"] + 2
    assert kp.LAUNCHES["packed_fdm"] == before["packed_fdm"] + 2
    with pytest.raises(TypeError, match="float32"):
        kp.packed_apply(U.double(), op.mats)


@pytest.mark.cuda
def test_cuda_extents_outside_the_build_raise(cuda_device):
    """NX = 16*8+1 = 129 > 128: the CUDA call raises; the plain version
    (a CPU tensor) still runs it."""
    mesh = BoxMesh((16, 2, 2))
    op = kp.PackedKronBatch(mesh, 8, B=1, device=cuda_device)
    U = torch.zeros((1,) + mesh.lattice_shape(8), device=cuda_device)
    with pytest.raises(ValueError, match="compiled for"):
        op.apply_packed(U)
    cpu = kp.PackedKronBatch(mesh, 8, B=1, device="cpu")
    assert cpu.apply_packed(U.cpu()).shape == U.shape


@pytest.mark.cuda
def test_cuda_single_kernels_match_plain(cuda_device):
    mesh = BoxMesh((4, 4, 4))
    x = torch.tensor(_batch(mesh, 3, 1, seed=9)[0], device=cuda_device)
    op = kp.PackedKronSingle(mesh, 3, sigma=0.7, device=cuda_device)
    fdm = kp.PackedFDMSingle(mesh, 3, sigma=0.7, device=cuda_device)
    x3 = x.reshape(1, *mesh.lattice_shape(3))
    assert _rel(op(x).cpu(), kp.plain_packed_apply(
        x3, op.mats, 0.7).reshape(-1).cpu()) <= 1e-5
    assert _rel(fdm.solve(x).cpu(), kp.plain_packed_fdm(
        x3, fdm.mats).reshape(-1).cpu()) <= 1e-5
    assert _rel(op(fdm.solve(x)).cpu(), x.cpu()) <= 1e-4


# --- the kernels' host-side layouts and launch plans (CPU) --------------------

@pytest.mark.parametrize("B,shape,band,sms,resident,want", [
    # the serving size on an H100 (132 SMs, one 512-thread block per SM):
    # short chunks fill the card at B = 1, one whole-x chunk at B = 64
    (1, (61, 61, 61), 6, 132, 1, dict(lanes=64, rows=16, chunk=2)),
    (8, (61, 61, 61), 6, 132, 1, dict(lanes=64, rows=16, chunk=16)),
    (64, (61, 61, 61), 6, 132, 1, dict(lanes=64, rows=16, chunk=61)),
    (1, (25, 25, 25), 3, 132, 2, dict(lanes=32, rows=32)),
    (3, (128, 128, 64), 8, 132, 1, dict(lanes=64, rows=16)),
    (65535, (3, 3, 1), 0, 132, 1, dict(lanes=32, rows=32)),
])
def test_apply_plan_covers_the_lattice(B, shape, band, sms, resident, want):
    plan = kp.apply_plan(B, shape, band, sms, resident)
    for k, v in want.items():
        assert plan[k] == v, (k, plan)
    NX, NY, NZ = shape
    tiles, nch, b = plan["grid"]
    assert plan["lanes"] // 2 * plan["rows"] == kp.APPLY_THREADS
    assert plan["lanes"] >= NZ and b == B
    assert tiles * plan["rows"] >= NY > (tiles - 1) * plan["rows"]
    assert nch * plan["chunk"] >= NX > (nch - 1) * plan["chunk"]
    assert kp.apply_plan(B, shape, band, sms, resident) is plan  # cached


def _banded(n, band, rng):
    """A random symmetric float64 matrix with half-bandwidth ``band``."""
    K = rng.standard_normal((n, n))
    K = K + K.T
    i, j = np.indices((n, n))
    K[np.abs(i - j) > band] = 0.0
    return K


@pytest.mark.parametrize("n,band", [(1, 0), (5, 2), (7, 6), (13, 3), (3, 9)])
def test_band_rows_hold_the_band(n, band):
    rng = np.random.default_rng(n + band)
    K = _banded(n, band, rng)
    rows = kp.band_rows(K, band)
    assert rows.dtype == np.float32
    assert rows.shape == (n, kp.band_pad(band)) and rows.shape[1] % 4 == 0
    back = np.zeros((n, n), np.float32)
    for a in range(n):
        for d in range(2 * band + 1):
            c = a - band + d
            if 0 <= c < n:
                back[a, c] = rows[a, d]
            else:
                assert rows[a, d] == 0.0
    assert np.array_equal(back, K.astype(np.float32))
    assert not rows[:, 2 * band + 1:].any()


def _fdm_operands(shape, rng):
    NX, NY, NZ = shape
    V = [rng.standard_normal((n, n)) for n in (NX, NX, NY, NY, NZ, NZ)]
    dinv = rng.random(shape)
    bc = rng.random(shape) < 0.2
    return V, dinv, bc


@pytest.mark.parametrize("shape", [(5, 7, 3), (8, 4, 1), (3, 9, 61)])
def test_fdm_mats_lay_out_the_kernels_operands(shape):
    rng = np.random.default_rng(sum(shape))
    V, dinv, bc = _fdm_operands(shape, rng)
    m = kp.fdm_mats(*V, dinv, bc, device="cpu")
    NX, NY, NZ = shape
    NXp, NYp, NZp = kp.fdm_layout(shape)
    assert (NXp, NYp, NZp) == tuple(-(-n // 4) * 4 for n in shape)
    for key, M, rows, cols in (("Lxf", V[0], NX, NXp), ("Lxb", V[1], NX, NXp),
                               ("Lyf", V[2], NY, NYp), ("Lyb", V[3], NY, NYp),
                               ("Rzf", V[4], NZp, NZp),
                               ("Rzb", V[5], NZp, NZp)):
        L = m[key].numpy()
        assert L.shape == (rows, cols) and m[key].is_contiguous(), key
        n = M.shape[0]
        assert np.array_equal(L[:n, :n], M.astype(np.float32).T), key
        assert not L[n:].any() and not L[:, n:].any(), key
    assert tuple(m["dinvp"].shape) == (NX, NY, NZp)
    assert np.array_equal(m["dinvp"][..., :NZ].numpy(),
                          dinv.astype(np.float32))
    assert not m["dinvp"][..., NZ:].any()
    assert m["bcp"].dtype == torch.uint8
    assert np.array_equal(m["bcp"][..., :NZ].numpy(), bc.astype(np.uint8))
    assert not m["bcp"][..., NZ:].any()
    # the plain version still reads the unpadded operands
    X = torch.from_numpy(rng.standard_normal((2,) + shape).astype(np.float32))
    assert kp.packed_fdm(X, m).shape == X.shape


def test_kron_mats_lay_out_the_band_rows():
    mesh = BoxMesh((3, 2, 4), dirichlet_faces=MIXED)
    op = kp.PackedKronBatch(mesh, 3, B=2, device="cpu")
    m = op.mats
    assert m["band"] == 3
    for key, full in (("Kxb", "Ktx"), ("Kyb", "Kty"), ("Kzb", "Ktz")):
        assert np.array_equal(m[key].numpy(),
                              kp.band_rows(m[full].numpy(), 3)), key


def test_operands_checked_at_construction():
    rng = np.random.default_rng(3)
    shape = (5, 7, 3)
    K = [_banded(n, 2, rng) for n in shape]
    sxy, sz = rng.random((5, 7)) + 0.5, rng.random(3) + 0.5
    bc = rng.random(shape) < 0.1
    kp.kron_mats(*K, sxy, sz, bc, device="cpu")
    with pytest.raises(ValueError, match="Kty has shape"):
        kp.kron_mats(K[0], K[0], K[2], sxy, sz, bc, device="cpu")
    with pytest.raises(ValueError, match="sxy has shape"):
        kp.kron_mats(*K, sxy.T, sz, bc, device="cpu")
    with pytest.raises(ValueError, match="marker"):
        kp.kron_mats(*K, sxy, sz, bc[0], device="cpu")
    V, dinv, _ = _fdm_operands(shape, rng)
    with pytest.raises(ValueError, match="dinv has shape"):
        kp.fdm_mats(*V, dinv[:, :, :2], bc, device="cpu")
    with pytest.raises(ValueError, match="Vzt has shape"):
        kp.fdm_mats(*V[:4], V[0], V[5], dinv, bc, device="cpu")


# --- the kernels on the card ----------------------------------------------------

AWKWARD = [(5, 7, 3), (61, 61, 61), (127, 3, 64), (128, 128, 64), (3, 128, 1)]


def _random_mats(shape, band, seed, device):
    """Random operands of both kernels at any extents: banded stiffness with
    half-bandwidth ``band``, positive scales, dense eigenvector matrices,
    and a marker with every face on some axes and random interior
    points."""
    rng = np.random.default_rng(seed)
    NX, NY, NZ = shape
    K = [_banded(n, band, rng) for n in shape]
    bc = rng.random(shape) < 0.05
    bc[0], bc[:, -1], bc[..., 0] = True, True, True
    kron = kp.kron_mats(*K, rng.random((NX, NY)) + 0.5, rng.random(NZ) + 0.5,
                        bc, device=device)
    V, dinv, _ = _fdm_operands(shape, rng)
    return kron, kp.fdm_mats(*V, dinv, bc, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", AWKWARD)
@pytest.mark.parametrize("B", [1, 2, 9, 65])
def test_cuda_kernels_at_awkward_extents(cuda_device, shape, B):
    """Extents off the march's tiles and chunks and the FDM's float4 and
    64-column tiles, B off every grid, sigma 0 and not, a marker with
    every face and interior points: both kernels against their plain
    versions, one launch count per call."""
    kron, fdm = _random_mats(shape, 6, sum(shape) + B, cuda_device)
    X = torch.tensor(np.random.default_rng(B).standard_normal(
        (B,) + shape, dtype=np.float32), device=cuda_device)
    before = dict(kp.LAUNCHES)
    for sigma in (0.0, 7.5):
        got = kp.packed_apply(X, kron, sigma)
        assert _rel(got.cpu(), kp.plain_packed_apply(X, kron, sigma).cpu()) \
            <= 1e-5
    got = kp.packed_fdm(X, fdm)
    assert _rel(got.cpu(), kp.plain_packed_fdm(X, fdm).cpu()) <= 1e-5
    bc = fdm["bc"].expand_as(X)
    assert torch.equal(got[bc], X[bc])
    assert kp.LAUNCHES["packed_apply"] == before["packed_apply"] + 2
    assert kp.LAUNCHES["packed_fdm"] == before["packed_fdm"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("band", list(range(11)))
@pytest.mark.parametrize("shape", [(13, 11, 20), (9, 17, 37)])
def test_cuda_apply_every_band(cuda_device, band, shape):
    """Every march instantiation (bands 0-8, 32 and 64 z-lanes) and the
    direct form above band 8, on a lattice narrower than the band."""
    kron, _ = _random_mats(shape, band, band, cuda_device)
    assert kron["band"] == min(band, max(shape) - 1)
    X = torch.tensor(np.random.default_rng(band).standard_normal(
        (3,) + shape, dtype=np.float32), device=cuda_device)
    got = kp.packed_apply(X, kron, 0.5)
    assert _rel(got.cpu(), kp.plain_packed_apply(X, kron, 0.5).cpu()) <= 1e-5


@pytest.mark.cuda
def test_cuda_same_bits_and_first_call_in_graph_capture(cuda_device):
    """Two calls give the same bits, and a first call (no launch plan, no
    shared-memory limit raised yet for this shape) inside a CUDA graph
    capture records a graph whose replay gives them too."""
    shape, B = (9, 10, 11), 4
    kron, fdm = _random_mats(shape, 3, 11, cuda_device)
    X = torch.tensor(np.random.default_rng(4).standard_normal(
        (B,) + shape, dtype=np.float32), device=cuda_device)
    kp._PLANS.clear()
    kp._RESIDENT.clear()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            ga, gf = kp.packed_apply(X, kron, 0.25), kp.packed_fdm(X, fdm)
    graph.replay()
    torch.cuda.synchronize()
    a1, a2 = kp.packed_apply(X, kron, 0.25), kp.packed_apply(X, kron, 0.25)
    f1, f2 = kp.packed_fdm(X, fdm), kp.packed_fdm(X, fdm)
    assert torch.equal(a1, a2) and torch.equal(f1, f2)
    assert torch.equal(ga, a1) and torch.equal(gf, f1)
    assert _rel(a1.cpu(), kp.plain_packed_apply(X, kron, 0.25).cpu()) <= 1e-5


@pytest.mark.cuda
def test_cuda_one_kernel_per_apply_three_per_solve(cuda_device):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kron, fdm = _random_mats((61, 61, 61), 6, 5, cuda_device)
    # B = 1 runs the slab pass in pairs of blocks, B = 8 one block a slab
    assert kp.fdm_launch_plan(1, (61, 61, 61))["slab_pairs"] == 1
    assert kp.fdm_launch_plan(8, (61, 61, 61))["slab_pairs"] == 0
    for B in (1, 8):
        X = torch.zeros((B, 61, 61, 61), device=cuda_device)
        for call, want in ((lambda: kp.packed_apply(X, kron), 1),
                           (lambda: kp.packed_fdm(X, fdm), 3)):
            call()
            torch.cuda.synchronize()
            # The most kernels over five one-call windows: the profiler
            # can leave a window's first kernels out, never add one.
            counts = []
            for _ in range(5):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    call()
                    torch.cuda.synchronize()
                counts.append(sum(e.device_type == DeviceType.CUDA
                                  for e in prof.events()))
            assert max(counts) == want, counts


@pytest.mark.cuda
def test_cuda_refused_batches_raise(cuda_device):
    kron, fdm = _random_mats((5, 7, 3), 2, 6, cuda_device)
    X = torch.zeros((2, 5, 7, 3), device=cuda_device)
    with pytest.raises(ValueError, match="must be \\(B, 5, 7, 3\\)"):
        kp.packed_apply(X[:, :4], kron)
    with pytest.raises(ValueError, match="contiguous"):
        kp.packed_fdm(X.transpose(0, 1).contiguous().transpose(0, 1), fdm)
    with pytest.raises(TypeError, match="float32"):
        kp.packed_fdm(X.double(), fdm)
    with pytest.raises(ValueError, match="compiled for"):
        kp.packed_apply(torch.zeros((65536, 5, 7, 3), device=cuda_device),
                        kron)
    for shape in ((129, 2, 2), (2, 129, 2), (2, 2, 65)):
        k2, f2 = _random_mats(shape, 1, 7, cuda_device)
        Y = torch.zeros((1,) + shape, device=cuda_device)
        with pytest.raises(ValueError, match="compiled for"):
            kp.packed_apply(Y, k2)
        with pytest.raises(ValueError, match="compiled for"):
            kp.packed_fdm(Y, f2)


@pytest.mark.cuda
@pytest.mark.parametrize("start", [1, 2, 3])
def test_cuda_batch_views_off_16_bytes(cuda_device, start):
    """A contiguous batch that starts 4, 8 or 12 bytes past a 16-byte
    boundary (a view into a larger buffer): the apply copies whole 16-byte
    chunks of each plane and must neither read before the batch nor drop
    its first values."""
    shape = (7, 9, 37)
    kron, fdm = _random_mats(shape, 6, start, cuda_device)
    n = int(np.prod(shape))
    big = torch.tensor(np.random.default_rng(start).standard_normal(
        4 * n, dtype=np.float32), device=cuda_device)
    X = big[start:start + 3 * n].view((3,) + shape)
    assert X.data_ptr() % 16 != 0
    assert _rel(kp.packed_apply(X, kron, 0.5).cpu(),
                kp.plain_packed_apply(X, kron, 0.5).cpu()) <= 1e-5
    assert _rel(kp.packed_fdm(X, fdm).cpu(),
                kp.plain_packed_fdm(X, fdm).cpu()) <= 1e-5
