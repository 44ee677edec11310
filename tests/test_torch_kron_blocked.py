"""Parity of the port's blocked Kronecker apply with the JAX Pallas kernels.

- f32: the port's plain torch versions against the JAX entry points run
  with ``interpret=True`` (the real Pallas kernel bodies, interpreted on
  the CPU): <= 1e-5 relative (f32, different summation order).
- f64: against the JAX emulation path (``interpret=None`` on CPU):
  <= 1e-12 relative.
- The setup arrays equal the JAX ones bit for bit; the band check
  refuses a matrix with an entry outside the band.
- On the card, each CUDA kernel against its plain version (marked
  ``cuda``; skipped without a GPU). That test needs no JAX, so on a GPU
  machine without JAX it runs as
  ``python -m pytest --noconftest -m cuda tests/test_torch_kron_blocked.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh as TBoxMesh  # noqa: E402
from pmg_dolfinx_tpu_torch.ops import kron_blocked as tkb  # noqa: E402
from pmg_dolfinx_tpu_torch.ops.kron import axis_stiffness_mass  # noqa: E402

NC = (3, 4, 5)
MIXED = ((True, False), (True, True), (False, True))
P = 3


@pytest.fixture
def jx():
    """The JAX reference modules, imported here so that the card test of
    this file does not need JAX."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from pmg_dolfinx_tpu.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu.ops import pallas_kron_blocked
    from pmg_dolfinx_tpu.ops.kron import KronLaplacian

    return SimpleNamespace(jnp=jnp, BoxMesh=BoxMesh, jkb=pallas_kron_blocked,
                           KronLaplacian=KronLaplacian)


def _setup(jx, faces, dtype, jdtype, seed=0):
    jm = jx.BoxMesh(NC, dirichlet_faces=faces)
    tm = TBoxMesh(NC, dirichlet_faces=faces)
    base = jx.KronLaplacian(jm, P, kappa=2.0, dtype=jdtype)
    shape = jm.lattice_shape(P)
    bc3 = base.bc_marker.reshape(shape)
    fm_j = jx.jkb.checked_face_masks(jm, P, base.bc_marker)
    fm_t = tkb.checked_face_masks(tm, P, tm.boundary_dof_marker(P))
    jmats = jx.jkb.symmetrized_mats(base.Ks, base.ms, dtype=jdtype,
                                    face_masks=fm_j)
    tmats = tkb.symmetrized_mats([np.asarray(K) for K in base.Ks],
                                 [np.asarray(m) for m in base.ms], dtype,
                                 fm_t, band=P, device="cpu")
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    b = rng.standard_normal(shape)
    return bc3, jmats, tmats, x, b


def _port_mats(faces, device, dtype=torch.float32):
    """The kernels' operands from the port alone (kappa=2)."""
    tm = TBoxMesh(NC, dirichlet_faces=faces)
    Ks, ms = zip(*(axis_stiffness_mass(n, P, h)
                   for n, h in zip(tm.nc, tm.h_cells)))
    fm = tkb.checked_face_masks(tm, P, tm.boundary_dof_marker(P))
    return tm, tkb.symmetrized_mats([2.0 * K for K in Ks], ms, dtype, fm,
                                    band=P, device=device)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("faces", [True, MIXED])
def test_setup_arrays_equal(jx, faces):
    _, jmats, tmats, _, _ = _setup(jx, faces, torch.float64, jx.jnp.float64)
    for k in ("Ktx", "Kty", "KtzT", "sx2d", "sycol", "sxzm", "s23m", "mx2",
              "myb", "mzrow"):
        assert np.array_equal(tmats[k].numpy(), np.asarray(jmats[k])), k
    assert tmats["band"] == P
    assert tkb.default_tiles(6) == jx.jkb.default_tiles(6)
    assert tkb.default_tiles(8) == jx.jkb.default_tiles(8)


@pytest.mark.parametrize("sigma", [0.0, 0.5])
@pytest.mark.parametrize("faces", [True, MIXED])
def test_plain_matches_pallas_interpret_f32(jx, faces, sigma):
    jnp, jkb = jx.jnp, jx.jkb
    bc3, jmats, tmats, x, b = _setup(jx, faces, torch.float32, jnp.float32)
    x32, b32 = x.astype(np.float32), b.astype(np.float32)
    y_j = jkb.blocked_kron_apply(jnp.asarray(x32), bc3, jmats,
                                 interpret=True, sigma=sigma)
    y_t = tkb.blocked_kron_apply(torch.from_numpy(x32), torch.tensor(
        np.asarray(bc3)), tmats, sigma=sigma)
    assert y_t.dtype == torch.float32
    assert _rel(y_t.numpy(), y_j) <= 1e-5
    r_j = jkb.blocked_kron_residual(jnp.asarray(b32), jnp.asarray(x32), bc3,
                                    jmats, interpret=True, sigma=sigma)
    r_t = tkb.blocked_kron_residual(torch.from_numpy(b32),
                                    torch.from_numpy(x32), None, tmats,
                                    sigma=sigma)
    assert _rel(r_t.numpy(), r_j) <= 1e-5


@pytest.mark.parametrize("sigma", [0.0, 0.5])
@pytest.mark.parametrize("faces", [True, MIXED])
def test_plain_matches_emulation_f64(jx, faces, sigma):
    jnp, jkb = jx.jnp, jx.jkb
    bc3, jmats, tmats, x, b = _setup(jx, faces, torch.float64, jnp.float64)
    y_j = jkb.blocked_kron_apply(jnp.asarray(x), bc3, jmats, sigma=sigma)
    y_t = tkb.plain_apply_m(torch.from_numpy(x), tmats, sigma)
    assert _rel(y_t.numpy(), y_j) <= 1e-12
    r_j = jkb.blocked_kron_residual(jnp.asarray(b), jnp.asarray(x), bc3,
                                    jmats, sigma=sigma)
    r_t = tkb.plain_residual_m(torch.from_numpy(b), torch.from_numpy(x),
                               tmats, sigma)
    assert _rel(r_t.numpy(), r_j) <= 1e-12
    # kernel 1 alone is the x-stiffness term of the JAX emulation
    t1_j = jkb._emu_t1(jnp.asarray(x), bc3, jmats)
    assert _rel(tkb.plain_t1_m(torch.from_numpy(x), tmats).numpy(),
                t1_j) <= 1e-12


def test_band_check_and_separable_guard(jx):
    tm, tmats = _port_mats(True, "cpu", torch.float64)
    Ks = [tmats["Ktx"].clone(), tmats["Kty"], tmats["KtzT"].T]
    ms = [torch.ones(K.shape[0], dtype=torch.float64) for K in Ks]
    fm = tkb.checked_face_masks(tm, P, tm.boundary_dof_marker(P))
    tkb.symmetrized_mats(Ks, ms, face_masks=fm, band=P, device="cpu")
    Ks[0][0, P + 1] = 1e-3  # one entry just outside the band
    with pytest.raises(ValueError, match="outside the band"):
        tkb.symmetrized_mats(Ks, ms, face_masks=fm, band=P, device="cpu")
    with pytest.raises(ValueError, match="outside the band"):
        tkb.symmetrized_mats(Ks, ms, face_masks=None, band=P,
                             device="cpu")
    # a non-separable marker has no face masks: the setup gives the
    # bc-array set and the entry points run the full-bc kernels, as JAX
    bad = tm.boundary_dof_marker(P).copy().reshape(tm.lattice_shape(P))
    bad[2, 2, 2] = True  # one interior dof
    assert tkb.checked_face_masks(tm, P, bad) is None
    base = jx.KronLaplacian(jx.BoxMesh(NC), P, kappa=2.0,
                            dtype=jx.jnp.float64)
    jmats = jx.jkb.symmetrized_mats(base.Ks, base.ms, dtype=jx.jnp.float64)
    mats = tkb.symmetrized_mats([np.asarray(K) for K in base.Ks],
                                [np.asarray(m) for m in base.ms], band=P,
                                device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(4)
    x, b = rng.standard_normal(bad.shape), rng.standard_normal(bad.shape)
    assert "sxzm" not in mats
    y_j = jx.jkb.blocked_kron_apply(jx.jnp.asarray(x), bad, jmats)
    y_t = tkb.blocked_kron_apply(torch.from_numpy(x), torch.from_numpy(bad),
                                 mats)
    assert _rel(y_t.numpy(), y_j) <= 1e-12
    r_j = jx.jkb.blocked_kron_residual(jx.jnp.asarray(b), jx.jnp.asarray(x),
                                       bad, jmats)
    r_t = tkb.blocked_kron_residual(torch.from_numpy(b), torch.from_numpy(x),
                                    torch.from_numpy(bad), mats)
    assert _rel(r_t.numpy(), r_j) <= 1e-12
    with pytest.raises(NotImplementedError, match="precision='high'"):
        tkb.blocked_kron_apply(torch.zeros(tm.lattice_shape(P)), None, tmats,
                               precision="high")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [0.0, 0.5])
@pytest.mark.parametrize("faces", [True, MIXED])
def test_cuda_kernels_match_plain(cuda_device, faces, sigma):
    tm, mats = _port_mats(faces, cuda_device)
    rng = np.random.default_rng(1)
    shape = tm.lattice_shape(P)
    x3 = torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                      device=cuda_device)
    b3 = torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                      device=cuda_device)
    before = dict(tkb.LAUNCHES)
    t1 = tkb.kron_t1_m(x3, mats)
    assert _rel(t1.cpu(), tkb.plain_t1_m(x3, mats).cpu()) <= 1e-5
    y = tkb.blocked_kron_apply(x3, None, mats, sigma=sigma)
    assert _rel(y.cpu(), tkb.plain_apply_m(x3, mats, sigma).cpu()) <= 1e-5
    r = tkb.blocked_kron_residual(b3, x3, None, mats, sigma=sigma)
    assert _rel(r.cpu(), tkb.plain_residual_m(b3, x3, mats, sigma).cpu()) <= 1e-5
    assert tkb.LAUNCHES["t1_m"] == before["t1_m"] + 3
    assert tkb.LAUNCHES["t23_m"] == before["t23_m"] + 1
    assert tkb.LAUNCHES["t23_res_m"] == before["t23_res_m"] + 1
    with pytest.raises(TypeError, match="float32"):
        tkb.blocked_kron_apply(x3.double(), None, mats)
