"""Parity of the port's blocked Kronecker apply with the JAX Pallas kernels.

- f32: the port's plain torch versions against the JAX entry points run
  with ``interpret=True`` (the real Pallas kernel bodies, interpreted on
  the CPU): <= 1e-5 relative (f32, different summation order).
- f64: against the JAX emulation path (``interpret=None`` on CPU):
  <= 1e-12 relative.
- The setup arrays equal the JAX ones bit for bit; the band check
  refuses a matrix with an entry outside the band.
- f64: the full-bc plain versions (`plain_t23`, the entry points without
  face masks) against JAX's emulation on markers that stress the y-march
  of kernels #5 / #6 (marked rows at chunk borders, marked columns in a
  warp's z halo) at awkward shapes: <= 1e-12.
- On the card, each CUDA kernel against its plain version (marked
  ``cuda``; skipped without a GPU), also kernels #1-#3 at awkward
  shapes and bands (extents off the 32-lane and march-chunk grids, an
  axis no longer than the band's 2P+1, bands 1, 3, 6 and 16, mixed
  faces), and kernels #4-#6 (`kron_t1` and `kron_t23`, the same marches
  with the full marker) at those shapes on a random non-separable marker
  and on markers that stress the y-march (marked rows at chunk borders,
  marked columns in a warp's z halo), and first #5, #6 and #8 launches
  inside a CUDA graph capture. Those tests need no
  JAX, so on a GPU machine without JAX they run as
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
    # precision='high' on the non-separable marker: the bf16x3 full-bc
    # kernels #4 + #5, held to JAX's kernels in interpret mode (f32)
    jm32 = jx.jkb.symmetrized_mats(base.Ks, base.ms, dtype=jx.jnp.float32)
    m32 = tkb.symmetrized_mats([np.asarray(K) for K in base.Ks],
                               [np.asarray(m) for m in base.ms], band=P,
                               device="cpu")
    x32 = x.astype(np.float32)
    y_j = jx.jkb.blocked_kron_apply(jx.jnp.asarray(x32), bad, jm32,
                                    precision="high", interpret=True)
    y_t = tkb.blocked_kron_apply(torch.from_numpy(x32), torch.from_numpy(bad),
                                 m32, precision="high")
    assert _rel(y_t.numpy(), y_j) <= 1e-5


# Shapes that stress the y-march of kernels #5 / #6 / #8: an axis no
# longer than 2 band + 1, rows past the march chunks' borders, z extents
# off the 32-lane grid (13, 33) and under one warp (9).
MARCH_SHAPES = [((7, 3, 9), 1), ((5, 37, 33), 3), ((4, 70, 13), 6)]


@pytest.mark.parametrize("shape,band", MARCH_SHAPES)
def test_plain_full_bc_stress_markers_match_emulation_f64(jx, shape, band):
    """f64: `plain_t23` (kernel #5, and #6 as ``r - A v``) and the
    full-bc entry points against JAX's emulation of `_kernel_t23`
    (``_emu_apply`` on ``_emu_t1``) on markers that stress the march
    (`_stress_markers`), random banded ``K_a``, sigma 0 and 0.5: <= 1e-12
    relative max-norm."""
    jnp, jkb = jx.jnp, jx.jkb
    rng, m = _banded_mats(shape, band, MIXED, "cpu", 5 * sum(shape) + band,
                          torch.float64)
    jm = {k: jnp.asarray(v.numpy()) for k, v in m.items() if k != "band"}
    x, r = rng.standard_normal(shape), rng.standard_normal(shape)
    tx, tr = torch.from_numpy(x), torch.from_numpy(r)
    for bc in _stress_markers(shape, rng):
        tbc = torch.from_numpy(bc)
        t1_j = jkb._emu_t1(jnp.asarray(x), bc, jm)
        t1 = tkb.plain_t1(tx, tbc, m)
        assert _rel(t1.numpy(), t1_j) <= 1e-12
        for sigma in (0.0, 0.5):
            y_j = jkb._emu_apply(jnp.asarray(x), bc, t1_j, jm, sigma=sigma)
            assert _rel(tkb.plain_t23(tx, tbc, t1, m, sigma).numpy(),
                        y_j) <= 1e-12
            assert _rel(tkb.kron_t23(tx, tbc, t1, m, sigma, r3=tr).numpy(),
                        r - np.asarray(y_j)) <= 1e-12
            full = {k: v for k, v in m.items() if k not in _SEPARABLE}
            assert _rel(tkb.blocked_kron_apply(tx, tbc, full,
                                               sigma=sigma).numpy(),
                        y_j) <= 1e-12
            assert _rel(tkb.blocked_kron_residual(tr, tx, tbc, full,
                                                  sigma=sigma).numpy(),
                        r - np.asarray(y_j)) <= 1e-12


def test_t23_plan_marches_up_to_band_12():
    """Kernels #5 / #6 / #8 run the y-march at every band up to 12 (the
    hierarchies' bands 1, 3 and 6 among them) and the staged tile at bands
    13-16, where the march's residual form measured slower on the card
    (`tools/t23_bands_torch.py`)."""
    assert tkb.T23_MARCH_MAX_BAND == 12
    assert [tkb.t23_plan(b) for b in range(17)] == (["march"] * 13
                                                    + ["tile"] * 4)


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


# Kernels #1-#3 at shapes the marching kernels must get right: extents
# that are not multiples of 32 (lanes) or of the march chunk, one axis no
# longer than 2 band + 1, and bands 1, 3, 6 and 16.
AWKWARD = [((7, 3, 9), 1), ((37, 130, 5), 3), ((70, 13, 33), 6),
           ((130, 70, 40), 6), ((20, 45, 97), 16)]


_SEPARABLE = ("sxzm", "s23m", "mx2", "myb", "mzrow")


def _banded_mats(shape, band, faces, device, seed, dtype=torch.float32):
    """Random symmetric banded ``K_a``, positive masses and the separable
    face masks of ``faces``: the kernels' operands for any band (both
    the separable and the full-bc set)."""
    rng = np.random.default_rng(seed)
    Ks, fm = [], []
    for n, (lo, hi) in zip(shape, faces):
        A = rng.standard_normal((n, n))
        i, j = np.indices((n, n))
        A[np.abs(i - j) > band] = 0.0
        Ks.append(A + A.T)
        m = np.ones(n)
        m[0], m[-1] = (0.0 if lo else 1.0), (0.0 if hi else 1.0)
        fm.append(m)
    ms = [rng.uniform(0.5, 2.0, n) for n in shape]
    return rng, tkb.symmetrized_mats(Ks, ms, dtype, fm, band=band,
                                     device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("faces", [((True, True),) * 3, MIXED])
@pytest.mark.parametrize("shape,band", AWKWARD)
def test_cuda_marching_kernels_awkward_shapes(cuda_device, shape, band,
                                              faces):
    """`kron_t1_m` and `kron_t23_m` (apply and residual, both sigmas)
    against `plain_t1_m` / `plain_t23_m`: <= 1e-5 relative max-norm; each
    launch is counted once."""
    rng, m = _banded_mats(shape, band, faces, cuda_device, sum(shape) + band)
    f32 = lambda: torch.tensor(rng.standard_normal(shape),
                               dtype=torch.float32, device=cuda_device)
    x, r = f32(), f32()
    before = dict(tkb.LAUNCHES)
    t1 = tkb.kron_t1_m(x, m)
    assert _rel(t1.cpu(), tkb.plain_t1_m(x, m).cpu()) <= 1e-5
    for sigma in (0.0, 0.5):
        for rr in (None, r):
            got = tkb.kron_t23_m(x, t1, m, sigma, r3=rr)
            ref = tkb.plain_t23_m(x, t1, m, sigma)
            if rr is not None:
                ref = rr - ref
            assert _rel(got.cpu(), ref.cpu()) <= 1e-5, (sigma, rr is None)
    assert tkb.LAUNCHES["t1_m"] == before["t1_m"] + 1
    assert tkb.LAUNCHES["t23_m"] == before["t23_m"] + 2
    assert tkb.LAUNCHES["t23_res_m"] == before["t23_res_m"] + 2


def _non_separable_marker(shape, faces, rng, frac=0.02):
    """The Dirichlet faces of ``faces`` plus a random ``frac`` of the
    dofs: a marker that no union of box faces gives."""
    bc = rng.random(shape) < frac
    for axis, ends in enumerate(faces):
        for end, on in zip((0, -1), ends):
            if on:
                idx = [slice(None)] * 3
                idx[axis] = end
                bc[tuple(idx)] = True
    return bc


def _stress_markers(shape, rng):
    """Non-separable markers that stress kernels #5 / #6: whole marked
    y-rows at the march chunks' borders (rows 0-4, 7-8, 15-16, 31-33; the
    last two rows stay free of it), and marked columns on both sides of each
    32-column warp border (the z halo), each with a random 2% of the
    dofs."""
    rows = _non_separable_marker(shape, MIXED, rng)
    for j in (0, 1, 2, 3, 4, 7, 8, 15, 16, 31, 32, 33):
        if j < shape[1] - 2:
            rows[:, j, :] = True
    halo = _non_separable_marker(shape, MIXED, rng)
    for k in range(shape[2]):
        if k % 32 in (0, 1, 2, 29, 30, 31):
            halo[:, :, k] = True
    return rows, halo


@pytest.mark.cuda
@pytest.mark.parametrize("faces", [((True, True),) * 3, MIXED])
@pytest.mark.parametrize("shape,band", AWKWARD)
def test_cuda_full_bc_march_awkward_shapes(cuda_device, shape, band, faces):
    """Kernel #4 `kron_t1` (the x-march of kernel 1 with the bool marker)
    and kernels #5 / #6 `kron_t23` (the y-march of kernel 2 with the
    marker byte; apply and residual, both sigmas) on a random
    non-separable marker against `plain_t1` / `plain_t23`: <= 1e-5
    relative max-norm; each launch is counted once, and a second call
    gives the same bits."""
    rng, m = _banded_mats(shape, band, faces, cuda_device,
                          7 * sum(shape) + band)
    bc = torch.tensor(_non_separable_marker(shape, faces, rng),
                      device=cuda_device)
    x, r = (torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                         device=cuda_device) for _ in range(2))
    before = dict(tkb.LAUNCHES)
    got = tkb.kron_t1(x, bc, m)
    assert _rel(got.cpu(), tkb.plain_t1(x, bc, m).cpu()) <= 1e-5
    assert tkb.LAUNCHES == dict(before, t1=before["t1"] + 1)
    t1 = tkb.plain_t1(x, bc, m)
    for sigma in (0.0, 0.5):
        for rr in (None, r):
            name = "t23" if rr is None else "t23_res"
            before = dict(tkb.LAUNCHES)
            got = tkb.kron_t23(x, bc, t1, m, sigma, r3=rr)
            ref = tkb.plain_t23(x, bc, t1, m, sigma)
            if rr is not None:
                ref = rr - ref
            assert _rel(got.cpu(), ref.cpu()) <= 1e-5, (sigma, name)
            assert torch.equal(tkb.kron_t23(x, bc, t1, m, sigma, r3=rr), got)
            assert tkb.LAUNCHES == dict(before, **{name: before[name] + 2})


@pytest.mark.cuda
def test_cuda_full_bc_march_marker_patterns(cuda_device):
    """Kernels #5 / #6 on markers that stress the march: whole marked
    y-rows at the march chunks' borders, marked columns in the z halo of
    the 32-column warps, a z extent off the 32-lane grid, at bands 1, 3
    and 6: <= 1e-5 relative max-norm against `plain_t23`."""
    for shape, band in (((7, 3, 9), 1), ((5, 37, 33), 3), ((4, 70, 13), 6),
                        ((3, 70, 97), 6)):
        rng, m = _banded_mats(shape, band, MIXED, cuda_device, sum(shape))
        for bc_np in _stress_markers(shape, rng):
            bc = torch.tensor(bc_np, device=cuda_device)
            x, r = (torch.tensor(rng.standard_normal(shape),
                                 dtype=torch.float32, device=cuda_device)
                    for _ in range(2))
            t1 = tkb.plain_t1(x, bc, m)
            for sigma in (0.0, 0.5):
                ref = tkb.plain_t23(x, bc, t1, m, sigma)
                assert _rel(tkb.kron_t23(x, bc, t1, m, sigma).cpu(),
                            ref.cpu()) <= 1e-5, (shape, sigma)
                assert _rel(tkb.kron_t23(x, bc, t1, m, sigma, r3=r).cpu(),
                            (r - ref).cpu()) <= 1e-5, (shape, sigma)


@pytest.mark.cuda
def test_cuda_full_bc_march_first_call_in_graph(cuda_device):
    """First launches of #5, #6 and #8 (with both shard corrections) at a
    band no other test uses (the march's shared-memory opt-in is made in
    each first call) inside a CUDA graph capture, replayed: the same bits
    as calls outside the graph, within 1e-5 of `plain_t23`."""
    shape, band = (9, 40, 45), 8
    assert tkb.t23_plan(band) == "march"
    rng, m = _banded_mats(shape, band, MIXED, cuda_device, 12)
    bc = torch.tensor(_non_separable_marker(shape, MIXED, rng),
                      device=cuda_device)
    x, r = (torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                         device=cuda_device) for _ in range(2))
    cy, cz = (torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                           device=cuda_device)
              for s in ((shape[0], 2, shape[2]), (shape[0], shape[1], 2)))
    t1 = tkb.plain_t1(x, bc, m)
    calls = (lambda: tkb.kron_t23(x, bc, t1, m, 0.5),
             lambda: tkb.kron_t23(x, bc, t1, m, 0.5, r3=r),
             lambda: tkb.kron_t23_grid(x, bc, t1, m, 0.5, cy, cz))
    tkb.load_kernels()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        in_graph = [call() for call in calls]
    graph.replay()
    torch.cuda.synchronize()
    refs = (tkb.plain_t23(x, bc, t1, m, 0.5),
            r - tkb.plain_t23(x, bc, t1, m, 0.5),
            tkb.plain_t23_grid(x, bc, t1, m, 0.5, cy, cz))
    for call, y_g, ref in zip(calls, in_graph, refs):
        y = call()
        assert torch.equal(y_g, y)
        assert _rel(y.cpu(), ref.cpu()) <= 1e-5


@pytest.mark.cuda
def test_cuda_wrappers_recheck_replaced_arrays(cuda_device):
    """The wrappers check a mats dict's arrays on every launch: an array
    replaced in the dict, or changed in place, after a launch is checked
    again before the next one."""
    _, m = _banded_mats((9, 10, 11), 3, ((True, True),) * 3, cuda_device, 3)
    x = torch.zeros((9, 10, 11), device=cuda_device)
    t1 = tkb.kron_t1_m(x, m)
    tkb.kron_t23_m(x, t1, m)
    kty = m["Kty"]
    m["Kty"] = kty[:, :-1].contiguous()
    with pytest.raises(ValueError, match="Kty has shape"):
        tkb.kron_t23_m(x, t1, m)
    m["Kty"] = kty
    m["sxzm"] = m["sxzm"].double()
    with pytest.raises(TypeError, match="sxzm must be torch.float32"):
        tkb.kron_t1_m(x, m)
    m["sxzm"] = m["sxzm"].float()
    bc = torch.zeros((9, 10, 11), dtype=torch.bool, device=cuda_device)
    tkb.kron_t1(x, bc, m)
    sxz = m["sxz"]
    m["sxz"] = sxz[:-1].contiguous()
    with pytest.raises(ValueError, match="sxz has shape"):
        tkb.kron_t1(x, bc, m)
    m["sxz"] = sxz
    m["KtzT"].t_()
    with pytest.raises(ValueError, match="KtzT must be contiguous"):
        tkb.kron_t23_m(x, t1, m)
