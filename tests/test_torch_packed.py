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
