"""Parity of the port's fused p-transfers (`ops.transfer`, kernels #10/#11)
with the JAX package.

- `blocked_transfer` on its plain path against JAX `blocked_transfer(...,
  interpret=True)` (the Pallas kernels in interpret mode), both
  directions, ``BoxMesh((4, 3, 5))``, p 1 <-> 3, f32: relative 2-norm
  <= 1e-6 (the JAX package's own gate, `tests/test_pallas.py`).
- `transfer_mats` equal to JAX's, and its ValueError; `nonzero_ranges`
  exact on a sparse matrix and refreshed after an in-place write.
- ``PMGHierarchy(operator="kron_blocked", fuse_transfers=True)``, with and
  without ``fuse_smoother``, on the JAX hierarchy's state (`utils.convert`,
  `load_state`) against JAX's fused-transfer hierarchy: f32 residuals
  within 1e-4 relative, ``BoxMesh((4, 4, 4))``, degrees (1, 3), four
  cycles with the ``fdm`` coarse solve, three with ``cg`` (see the test).
- On the card, both kernels against their plain versions (marked
  ``cuda``; skipped without a GPU). That test needs no JAX, so on a GPU
  machine without JAX it runs as
  ``python -m pytest --noconftest -m cuda tests/test_torch_transfer.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh as TBoxMesh  # noqa: E402
from pmg_dolfinx_tpu_torch.ops import transfer as tt  # noqa: E402
from pmg_dolfinx_tpu_torch.ops.lattice import (  # noqa: E402
    axis_interpolation_matrix,
    lattice_prolongate,
    lattice_restrict,
)

NC = (4, 3, 5)
PC, PF = 1, 3


@pytest.fixture
def jx():
    """The JAX reference modules, imported here so that the card test of
    this file does not need JAX."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from pmg_dolfinx_tpu.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu.ops import pallas_transfer
    from pmg_dolfinx_tpu.solvers.pmg import PMGHierarchy

    return SimpleNamespace(jax=jax, jnp=jnp, BoxMesh=BoxMesh,
                           jt=pallas_transfer, PMGHierarchy=PMGHierarchy)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _I1s(nc=NC, pc=PC, pf=PF):
    return [axis_interpolation_matrix(n, pc, pf) for n in nc]


@pytest.mark.parametrize("direction", ["restrict", "prolong"])
def test_blocked_transfer_matches_pallas_interpret(jx, direction):
    jnp = jx.jnp
    mesh = TBoxMesh(NC)
    shape = mesh.lattice_shape(PF if direction == "restrict" else PC)
    x = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    I1s = _I1s()
    jI = tuple(jnp.asarray(I, jnp.float32) for I in I1s)
    tI = tuple(torch.tensor(I, dtype=torch.float32) for I in I1s)
    y_j = jx.jt.blocked_transfer(jnp.asarray(x),
                                 *jx.jt.transfer_mats(jI, direction),
                                 interpret=True)
    mats = tt.transfer_mats(tI, direction)
    for M, Mj in zip(mats, jx.jt.transfer_mats(jI, direction)):
        assert M.is_contiguous() and np.array_equal(M.numpy(), np.asarray(Mj))
    before = dict(tt.LAUNCHES)
    y_t = tt.blocked_transfer(torch.from_numpy(x), *mats)
    assert tt.LAUNCHES == before  # the plain version; no kernel
    assert y_t.dtype == torch.float32 and tuple(y_t.shape) == y_j.shape
    assert _rel(y_t.numpy(), y_j) <= 1e-6
    # the port's own per-axis transfers compute the same function
    lattice = lattice_restrict if direction == "restrict" else \
        lattice_prolongate
    assert _rel(y_t.numpy(), lattice(torch.from_numpy(x), tI, shape)) <= 1e-6


def test_transfer_mats_direction_error(jx):
    with pytest.raises(ValueError, match="direction"):
        tt.transfer_mats([torch.eye(2)] * 3, "sideways")
    with pytest.raises(ValueError, match="direction"):
        jx.jt.transfer_mats([np.eye(2)] * 3, "sideways")


def test_nonzero_ranges_exact_and_refreshed():
    M = torch.zeros(4, 6)
    M[0, 1:3] = 1.0
    M[2, 0] = M[2, 5] = 2.0            # a gap inside the range
    M[3, 4] = -1.0                     # row 1 stays all-zero
    r = tt.nonzero_ranges(M, 0)
    assert r.dtype == torch.int32
    assert r.tolist() == [[1, 0, 0, 4], [3, 0, 6, 5]]
    assert tt.nonzero_ranges(M, 0) is r            # cached
    assert tt.nonzero_ranges(M, 1).tolist() == [[2, 0, 0, 0, 3, 2],
                                                 [3, 1, 1, 0, 4, 3]]
    M[1, 3] = 1.0                      # an in-place write refreshes it
    assert tt.nonzero_ranges(M, 0).tolist() == [[1, 3, 0, 4], [3, 4, 6, 5]]
    # a coarse vertex's restriction row spans the 2 Pf - 1 fine points
    # between its neighbours (interpolation vanishes at those)
    Ix = torch.tensor(axis_interpolation_matrix(3, 1, 3))
    lo, hi = tt.nonzero_ranges(Ix.T.contiguous(), 0)
    assert lo.tolist() == [0, 1, 4, 7] and hi.tolist() == [3, 6, 9, 10]


@pytest.mark.parametrize("fuse_smoother", [False, True])
@pytest.mark.parametrize("coarse", ["fdm", "cg"])
def test_fused_transfer_hierarchy_matches_jax(jx, coarse, fuse_smoother):
    """``fuse_transfers=True`` (with and without ``fuse_smoother``) on the
    JAX hierarchy's state: f32 residuals within 1e-4 of the JAX
    fused-transfer hierarchy, whose transfers run in interpret mode off
    the TPU (its emulation path), and the same cycles as the port's
    einsum transfers. Four cycles with the ``fdm`` coarse solve; with
    ``cg`` three: its f32 CG runs to its 60-iteration cap, and at cycle 4
    the port and JAX differ by 1.25e-4 with the einsum transfers too."""
    from pmg_dolfinx_tpu.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu.models.poisson import f_rhs
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy
    from pmg_dolfinx_tpu_torch.utils.convert import hierarchy_data_from_numpy

    cycles = 4 if coarse == "fdm" else 3
    kw = dict(degrees=(1, 3), kappa=2.0, coarse=coarse,
              operator="kron_blocked", fuse_smoother=fuse_smoother)
    jh = jx.PMGHierarchy(jx.BoxMesh((4, 4, 4)), dtype=jx.jnp.float32,
                         fuse_transfers=True, **kw)
    state = hierarchy_data_from_numpy(jx.jax.tree.map(np.asarray, jh.data),
                                      "cpu", torch.float32)
    b = assemble_rhs(jh.mesh, 3, f_rhs(2.0)).astype(np.float32)
    _, rj = jh.solve(b, num_cycles=cycles)
    rt = {}
    for fuse in (True, False):
        th = PMGHierarchy(TBoxMesh((4, 4, 4)), dtype=torch.float32,
                          device="cpu", fuse_transfers=fuse, **kw)
        assert ("smooth" in th.ops) == fuse_smoother
        th.load_state(state)
        rt[fuse] = th.solve(torch.from_numpy(b), num_cycles=cycles)[1]
    assert np.max(np.abs(np.array(rt[True]) - rj) / np.array(rj)) <= 1e-4
    # on the CPU both transfer paths run the same einsums
    assert rt[True] == rt[False]


def test_fused_transfer_plans_follow_load_state():
    """The V-cycle forms each transfer's matrices once, and anew when
    `load_state` replaces the interpolation matrices."""
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    h = PMGHierarchy(TBoxMesh((2, 2, 2)), degrees=(1, 2), kappa=2.0,
                     dtype=torch.float32, operator="kron_blocked",
                     fuse_transfers=True, device="cpu")
    tr = h.data["transfer"][0]
    lf, lc = h.levels[1], h.levels[0]
    r = torch.randn(lf.shape, generator=torch.Generator().manual_seed(0))
    want = lattice_restrict(r, (tr["Ix"], tr["Iy"], tr["Iz"]), lf.shape)
    assert _rel(h.ops["restrict"](tr, r, lc, lf), want) <= 1e-6
    h.load_state({"levels": [{}, {}],
                  "transfer": [{k: 2.0 * v for k, v in tr.items()}]})
    tr = h.data["transfer"][0]
    got = h.ops["restrict"](tr, r, lc, lf)
    assert _rel(got, 8.0 * want) <= 1e-6


# --- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rel_max(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("pc,pf", [(1, 3), (3, 6), (2, 5)])
@pytest.mark.parametrize("direction", ["restrict", "prolong"])
def test_cuda_transfer_kernels_match_plain(cuda_device, pc, pf, direction):
    nc = (5, 3, 4)
    I1s = [torch.tensor(axis_interpolation_matrix(n, pc, pf),
                        dtype=torch.float32, device=cuda_device) for n in nc]
    Mx, My, MzT = tt.transfer_mats(I1s, direction)
    p = pf if direction == "restrict" else pc
    shape = tuple(n * p + 1 for n in nc)
    x3 = torch.tensor(np.random.default_rng(3).standard_normal(shape),
                      dtype=torch.float32, device=cuda_device)
    before = dict(tt.LAUNCHES)
    t = tt.transfer_x(x3, Mx)
    assert _rel_max(t, tt.plain_transfer_x(x3, Mx)) <= 1e-5
    y = tt.transfer_yz(t, My, MzT)
    assert _rel_max(y, tt.plain_transfer_yz(t, My, MzT)) <= 1e-5
    y2 = tt.blocked_transfer(x3, Mx, My, MzT)
    assert _rel_max(y2, tt.plain_transfer(x3, Mx, My, MzT)) <= 1e-5
    assert tt.LAUNCHES == {k: v + 2 for k, v in before.items()}
    # a dense matrix: the ranges are the whole rows
    D = torch.rand((7, shape[0]), device=cuda_device)
    assert _rel_max(tt.transfer_x(x3, D), tt.plain_transfer_x(x3, D)) <= 1e-5
    with pytest.raises(TypeError, match="float32"):
        tt.transfer_x(x3.double(), Mx)
