"""Parity of the port's whole-lattice Kronecker-sum apply
(`ops.kron_fused`, kernel #12) with the JAX package.

- `PallasKronLaplacian` on the CPU (its plain version) against JAX
  `PallasKronLaplacian(interpret=True)` (the Pallas kernel in interpret
  mode), ``BoxMesh((4, 4, 4))``, P=3, f32: relative 2-norm <= 1e-6 (the
  JAX package's own gate, `tests/test_pallas.py`), and its ``diag`` and
  ``diag_inv``; a mixed Dirichlet/Neumann box too.
- `plain_kron_fused` in f64 against the port's symmetrized
  `kron_laplacian_apply`: <= 1e-12 (one operator, two summation forms).
- The same at p=1 and p=6, all and some Dirichlet faces, relative
  max-norm <= 1e-5.
- The march's launch plan (`fused_plan`: band, rows, chunk) at the
  V-cycle's shapes, its band from the matrices (`fused_band`, also on a
  permuted and a wide matrix) and its shared memory.
- On the card, the kernel against its plain version (marked ``cuda``;
  skipped without a GPU): extents below one tile and off the tile and
  chunk grids, bands 0-8 and the runtime-width form on random banded
  matrices, the same bits on two calls and a first call inside a CUDA
  graph capture. Those tests need no JAX, so on a GPU machine without JAX
  they run as
  ``python -m pytest --noconftest -m cuda tests/test_torch_kron_fused.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh as TBoxMesh  # noqa: E402
from pmg_dolfinx_tpu_torch.ops import kron_fused as tkf  # noqa: E402
from pmg_dolfinx_tpu_torch.ops.kron import KronLaplacian  # noqa: E402

MIXED = ((True, False), (False, False), (True, True))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("nc,faces", [((4, 4, 4), True), ((3, 4, 5), MIXED)])
def test_pallas_kron_laplacian_matches_jax_interpret(nc, faces):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from pmg_dolfinx_tpu.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu.ops.pallas_kron import PallasKronLaplacian

    P = 3
    jm = BoxMesh(nc, dirichlet_faces=faces)
    tm = TBoxMesh(nc, dirichlet_faces=faces)
    x = np.random.default_rng(1).standard_normal(tm.num_dofs(P)).astype(
        np.float32)
    pj = PallasKronLaplacian(jm, P, kappa=2.0, interpret=True)
    pt = tkf.PallasKronLaplacian(tm, P, kappa=2.0, device="cpu")
    before = dict(tkf.LAUNCHES)
    y_t = pt(torch.from_numpy(x))
    assert tkf.LAUNCHES == before  # the plain version; no kernel
    assert y_t.dtype == torch.float32 and tuple(y_t.shape) == (pt.ndofs,)
    assert _rel(y_t.numpy(), pj(jnp.asarray(x))) <= 1e-6
    assert np.array_equal(pt.diag.numpy(), np.asarray(pj.diag))
    assert np.array_equal(pt.diag_inv.numpy(), np.asarray(pj.diag_inv))
    # the mass planes are the JAX class's, cut to the unpadded lattice
    NX, NY, NZ = pt.shape
    for got, want in zip(pt.planes, (pj.myzp[:NY, :NZ], pj.mxzp[:NX, :NZ],
                                     pj.mxyp[:NX, :NY])):
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("P", [1, 6])
@pytest.mark.parametrize("faces", ["all", "some"])
def test_plain_matches_jax_interpret_degrees(P, faces):
    """`PallasKronLaplacian` on the CPU (`plain_kron_fused`) against the
    Pallas kernel in interpret mode at p=1 and p=6, relative max-norm."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from pmg_dolfinx_tpu.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu.ops.pallas_kron import PallasKronLaplacian

    nc = (3, 2, 4) if P == 1 else (2, 1, 2)
    dirichlet = True if faces == "all" else MIXED
    tm = TBoxMesh(nc, dirichlet_faces=dirichlet)
    x = np.random.default_rng(4 + P).standard_normal(tm.num_dofs(P)).astype(
        np.float32)
    pj = PallasKronLaplacian(BoxMesh(nc, dirichlet_faces=dirichlet), P,
                             kappa=2.0, interpret=True)
    pt = tkf.PallasKronLaplacian(tm, P, kappa=2.0, device="cpu")
    y_j = np.asarray(pj(jnp.asarray(x)), np.float64)
    y_t = pt(torch.from_numpy(x)).numpy().astype(np.float64)
    assert np.abs(y_t - y_j).max() <= 1e-5 * np.abs(y_j).max()


# The plan at the shapes the repo runs: 127^3 and 253^3 at p=6 (the
# whole-lattice apply's two sizes), 43^3 at p=1; on a card of 132 SMs.
PLANS = [((127,) * 3, 6, (6, 16)), ((253,) * 3, 6, (6, 64)),
         ((43,) * 3, 1, (1, 2)), ((5, 3, 4), 3, (3, 2)),
         ((127,) * 3, 9, (-1, 0))]


@pytest.mark.parametrize("shape,band,plan", PLANS)
def test_fused_plan_for_the_shapes(shape, band, plan):
    """`fused_plan`: the longest chunk while the card gets 3 blocks per
    SM, else the longest of 32, 16, ..., 2 giving every SM a block; the
    runtime-width form (band -1) above `MAX_BAND`."""
    got = tkf.fused_plan(shape, band, 132)
    assert got == plan
    if got[0] >= 0:
        NX, NY, NZ = shape
        blocks = (-(-NZ // tkf.TILE_Z) * -(-NY // tkf.TILE_Y)
                  * -(-NX // got[1]))
        assert blocks >= 132 or got[1] == tkf.MIN_CHUNK


def test_fused_band_from_the_matrices():
    """The band is the widest distance of a nonzero from the diagonal over
    the three matrices: P for the GLL stiffness, the permuted matrix's
    widest off a permutation, 0 for diagonal matrices; one host read,
    cached on the ranges and refreshed after an in-place write."""
    mesh = TBoxMesh((3, 2, 4))
    for P in (1, 3, 6):
        op = tkf.PallasKronLaplacian(mesh, P, device="cpu")
        assert op.band == P
    shape = (6, 5, 7)
    Ks = [torch.eye(n) for n in shape]
    ranges = tkf.band_ranges(Ks)
    assert tkf.fused_band(ranges, shape) == 0
    Ks[1] = Ks[1][torch.tensor([4, 0, 1, 2, 3])].contiguous()
    assert tkf.fused_band(tkf.band_ranges(Ks), shape) == 4
    ranges.copy_(tkf.band_ranges([torch.ones(n, n) for n in shape]))
    assert tkf.fused_band(ranges, shape) == 6


def test_plain_is_the_kron_operator_f64():
    mesh = TBoxMesh((3, 4, 5), dirichlet_faces=MIXED)
    P = 4
    base = KronLaplacian(mesh, P, kappa=2.0, dtype=torch.float64,
                         device="cpu")
    x3 = torch.from_numpy(np.random.default_rng(2).standard_normal(
        base.shape))
    bc3 = base.bc_marker.reshape(base.shape)
    y = tkf.kron_fused_apply(x3, bc3, base.Ks, tkf.mass_planes(base.ms))
    assert y.dtype == torch.float64
    assert _rel(y.numpy(), base(x3).numpy()) <= 1e-12
    assert torch.equal(y[bc3], x3[bc3])


def test_band_ranges_are_the_stiffness_band():
    mesh = TBoxMesh((3, 2, 4))
    P = 3
    op = tkf.PallasKronLaplacian(mesh, P, device="cpu")
    assert op.ranges.dtype == torch.int32
    parts = torch.split(op.ranges, [n for N in op.shape for n in (N, N)])
    for (lo, hi), N in zip(zip(parts[::2], parts[1::2]), op.shape):
        i = torch.arange(N)
        # a row of the GLL stiffness spans its one or two cells
        assert torch.all(lo <= i) and torch.all(hi > i)
        assert int((hi - lo).max()) == 2 * P + 1


# --- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _banded(n, band, seed):
    """A random (n, n) float32 matrix with nonzeros within ``band`` of the
    diagonal."""
    M = np.random.default_rng(seed).standard_normal((n, n))
    i = np.arange(n)
    M[np.abs(i[:, None] - i[None, :]) > band] = 0.0
    return torch.tensor(M, dtype=torch.float32)


# Extents below one tile (32 x 8), off the tile and chunk grids, and a
# lattice long enough along x for several chunks; all and mixed faces.
SHAPES = [((2, 1, 1), 6, True), ((1, 2, 3), 3, MIXED), ((9, 5, 6), 3, MIXED),
          ((3, 11, 2), 6, True), ((21, 2, 2), 2, MIXED)]


@pytest.mark.cuda
@pytest.mark.parametrize("nc,P,faces", SHAPES)
@pytest.mark.parametrize("sms", [None, 1])
def test_cuda_march_awkward_shapes(cuda_device, monkeypatch, nc, P, faces,
                                   sms):
    """The march against `plain_kron_fused` on a non-separable marker:
    <= 1e-5 relative max-norm, one launch; on the card's SM count (short
    chunks) and as if on one SM (the longest chunks)."""
    if sms is not None:
        monkeypatch.setattr(tkf, "_sms", lambda device: sms)
    op = tkf.PallasKronLaplacian(TBoxMesh(nc, dirichlet_faces=faces), P,
                                 kappa=2.0, device=cuda_device)
    rng = np.random.default_rng(sum(op.shape))
    x3 = torch.tensor(rng.standard_normal(op.shape), dtype=torch.float32,
                      device=cuda_device)
    bc3 = op.bc3 | torch.tensor(rng.random(op.shape) < 0.05,
                                device=cuda_device)
    before = tkf.LAUNCHES["kron_fused"]
    y = tkf.kron_fused(x3, bc3, op.Ks, op.planes, op.ranges)
    assert tkf.LAUNCHES["kron_fused"] == before + 1
    ref = tkf.plain_kron_fused(x3, bc3, op.Ks, op.planes)
    assert float((y - ref).abs().max() / ref.abs().max()) <= 1e-5
    assert torch.equal(y[bc3], x3[bc3])


@pytest.mark.cuda
@pytest.mark.parametrize("bands", [(0, 0, 0), (1, 2, 3), (4, 5, 6), (7, 8, 2),
                                   (9, 1, 1), (30, 30, 30)])
def test_cuda_march_bands_and_runtime_width(cuda_device, bands):
    """Random banded matrices: the template bands 0-8 (the widest of the
    three picks the instantiation) and, above `MAX_BAND`, the
    runtime-width form (a dense matrix too)."""
    shape = (33, 19, 40)
    Ks = [_banded(n, b, 7 + n).to(cuda_device) for n, b in zip(shape, bands)]
    planes = tuple(torch.rand(s, device=cuda_device) for s in (
        shape[1:], (shape[0], shape[2]), shape[:2]))
    rng = np.random.default_rng(5)
    x3 = torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                      device=cuda_device)
    bc3 = torch.tensor(rng.random(shape) < 0.1, device=cuda_device)
    ranges = tkf.band_ranges(Ks)
    assert tkf.fused_band(ranges, shape) == max(
        min(b, n - 1) for b, n in zip(bands, shape))
    y = tkf.kron_fused(x3, bc3, Ks, planes, ranges)
    ref = tkf.plain_kron_fused(x3, bc3, Ks, planes)
    assert float((y - ref).abs().max() / ref.abs().max()) <= 1e-5


@pytest.mark.cuda
def test_cuda_same_bits_and_first_call_in_graph_capture(cuda_device,
                                                        monkeypatch):
    """Two calls give the same bits, and the runtime-width form (the
    kernel the march replaced) gives them too; a first call (new operands:
    nothing cached) inside a CUDA graph capture records the kernel, and
    the replay gives the same bits again."""
    op = tkf.PallasKronLaplacian(TBoxMesh((4, 3, 5)), 6, device=cuda_device)
    x = torch.tensor(np.random.default_rng(6).standard_normal(op.ndofs),
                     dtype=torch.float32, device=cuda_device)
    y1, y2 = op(x), op(x)
    assert torch.equal(y1, y2)
    with monkeypatch.context() as m:
        m.setattr(tkf, "MAX_BAND", -1)
        assert torch.equal(op(x), y1)
    op2 = tkf.PallasKronLaplacian(TBoxMesh((4, 3, 5)), 6, device=cuda_device)
    tkf.load_kernels()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y3 = op2(x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y3, y1)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 3, 6])
def test_cuda_kron_fused_matches_plain(cuda_device, P):
    mesh = TBoxMesh((5, 3, 4), dirichlet_faces=MIXED)
    op = tkf.PallasKronLaplacian(mesh, P, kappa=2.0, device=cuda_device)
    x = torch.tensor(np.random.default_rng(3).standard_normal(op.ndofs),
                     dtype=torch.float32, device=cuda_device)
    before = tkf.LAUNCHES["kron_fused"]
    y = op(x)
    assert tkf.LAUNCHES["kron_fused"] == before + 1
    x3 = x.reshape(op.shape)
    ref = tkf.plain_kron_fused(x3, op.bc3, op.Ks, op.planes).reshape(-1)
    assert float((y - ref).abs().max() / ref.abs().max()) <= 1e-5
    assert torch.equal(y.reshape(op.shape)[op.bc3], x3[op.bc3])
    with pytest.raises(TypeError, match="bool"):
        tkf.kron_fused(x3, op.bc3.float(), op.Ks, op.planes)
