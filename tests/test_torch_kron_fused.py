"""Parity of the port's whole-lattice Kronecker-sum apply
(`ops.kron_fused`, kernel #12) with the JAX package.

- `PallasKronLaplacian` on the CPU (its plain version) against JAX
  `PallasKronLaplacian(interpret=True)` (the Pallas kernel in interpret
  mode), ``BoxMesh((4, 4, 4))``, P=3, f32: relative 2-norm <= 1e-6 (the
  JAX package's own gate, `tests/test_pallas.py`), and its ``diag`` and
  ``diag_inv``; a mixed Dirichlet/Neumann box too.
- `plain_kron_fused` in f64 against the port's symmetrized
  `kron_laplacian_apply`: <= 1e-12 (one operator, two summation forms).
- On the card, the kernel against its plain version (marked ``cuda``;
  skipped without a GPU). That test needs no JAX, so on a GPU machine
  without JAX it runs as
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
