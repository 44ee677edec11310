"""Parity of the port's fused p-transfers (`ops.transfer`, kernels #10/#11)
with the JAX package.

- `blocked_transfer` on its plain path against JAX `blocked_transfer(...,
  interpret=True)` (the Pallas kernels in interpret mode), both
  directions, ``BoxMesh((4, 3, 5))``, p 1 <-> 3, f32: relative 2-norm
  <= 1e-6 (the JAX package's own gate, `tests/test_pallas.py`).
- `transfer_mats` equal to JAX's, and its ValueError; `nonzero_ranges`
  exact on a sparse matrix and refreshed after an in-place write, with
  the widest range (`nonzero_width`) and the rows' order by ``hi`` cached
  beside it; `yz_plan`'s ring width and rows per block for the V-cycle's
  four transfer shapes.
- ``PMGHierarchy(operator="kron_blocked", fuse_transfers=True)``, with and
  without ``fuse_smoother``, on the JAX hierarchy's state (`utils.convert`,
  `load_state`) against JAX's fused-transfer hierarchy: f32 residuals
  within 1e-4 relative, ``BoxMesh((4, 4, 4))``, degrees (1, 3), four
  cycles with the ``fdm`` coarse solve, three with ``cg`` (see the test).
- The same against JAX at p 3 <-> 6 (the Pallas kernels in interpret
  mode), relative max-norm <= 1e-5.
- `x_plan` (ring width, rows per block, columns per thread, or the direct
  form) at the V-cycle's four transfer shapes, and the x rows its
  segments read there.
- On the card, both kernels against their plain versions (marked
  ``cuda``; skipped without a GPU), `transfer_yz` alone at the fused
  V-cycle's four shapes, at odd extents and on a band wider than every
  ring width (the runtime-width variant), and `transfer_x` alone: the
  march (every ring width, 1-4 columns a thread, segments of 1-64 rows)
  and the direct form at the cycle's shapes and odd ones, on a permuted
  matrix with an all-zero row and a dense one; the same bits on two
  calls and a first call inside a CUDA graph capture. Those tests need
  no JAX, so on a GPU machine without JAX they run as
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


@pytest.mark.parametrize("direction", ["restrict", "prolong"])
def test_blocked_transfer_matches_pallas_interpret_p36(jx, direction):
    """p 3 <-> 6 on ``BoxMesh((2, 1, 3))``: `plain_transfer` (the plain
    versions of #10 then #11) against the Pallas kernels in interpret
    mode, relative max-norm."""
    jnp = jx.jnp
    nc = (2, 1, 3)
    I1s = _I1s(nc, 3, 6)
    p = 6 if direction == "restrict" else 3
    shape = tuple(n * p + 1 for n in nc)
    x3 = np.random.default_rng(12).standard_normal(shape).astype(np.float32)
    y_j = np.asarray(jx.jt.blocked_transfer(
        jnp.asarray(x3), *jx.jt.transfer_mats(I1s, direction),
        interpret=True), np.float64)
    Mt = tt.transfer_mats([torch.tensor(I) for I in I1s], direction)
    t = tt.plain_transfer_x(torch.from_numpy(x3), Mt[0])
    y_t = tt.plain_transfer_yz(t, *Mt[1:]).numpy().astype(np.float64)
    assert np.abs(y_t - y_j).max() <= 1e-5 * np.abs(y_j).max()


# transfer_x's plan at the fused V-cycle's four shapes (nc 42) on a card
# of 132 SMs: (ring width, rows per block, columns per thread); rows 0 is
# the direct form (a thread per output).
X_PLANS = [((42, 3, 6), "restrict", (12, 64, 2)),
           ((42, 3, 6), "prolong", (4, 16, 4)),
           ((42, 1, 3), "restrict", (8, 0, 4)),
           ((42, 1, 3), "prolong", (4, 0, 4))]


def _segments(M, S):
    """The x range ``[lo, hi)`` each segment of ``S`` rows of ``M`` (in the
    order of their ranges' ends) marches: the union of its nonempty rows'
    ranges, ``(0, 0)`` for a segment of empty rows."""
    lo, hi = tt.nonzero_ranges(M, 0).long()
    order = torch.argsort(hi, stable=True)
    out = []
    for s0 in range(0, M.shape[0], S):
        rows = order[s0:s0 + S]
        full = hi[rows] > lo[rows]
        out.append((int(lo[rows][full].min()), int(hi[rows][full].max()))
                   if bool(full.any()) else (0, 0))
    return np.array(out).reshape(-1, 2)


@pytest.mark.parametrize("pair,direction,plan", X_PLANS)
def test_x_plan_for_the_cycle_shapes(pair, direction, plan):
    nc, pc, pf = pair
    Mx = tt.transfer_mats(_I1s((nc,), pc, pf) * 3, direction)[0]
    p = pf if direction == "restrict" else pc
    n = nc * p + 1
    assert tt.x_plan(Mx.shape[0], n * n, tt.nonzero_width(Mx, 0), 132) == plan
    W, S, C = plan
    if S:   # the segments fill the card, and re-read at most half of x3
        cols = -(-n * n // (256 * C))
        assert cols * -(-Mx.shape[0] // S) >= 132
        seg = _segments(Mx, S)
        assert (seg[:, 1] - seg[:, 0]).sum() <= 1.5 * n


def test_x_plan_on_a_permuted_matrix():
    """Rows whose ranges end out of order, with an all-zero row: the ring
    holds the widest range, the rows are taken in the stable order of
    their ends (`_yz_rows`, the march's layout) with each one's
    coefficients at the ring's end, and every row's range lies inside its
    segment's."""
    M = _banded(20, 45, 3, 1)[torch.randperm(
        20, generator=torch.Generator().manual_seed(0))].contiguous()
    M[4] = 0.0
    W, S, C = tt.x_plan(20, 30 * 70, tt.nonzero_width(M, 0), 1)
    assert (W, C) == (8, 4) and S > 0
    rows, coef = tt._yz_rows(M, W)
    order, lo, hi = rows.long()
    assert torch.equal(hi, torch.sort(hi, stable=True).values)
    assert int(order[0]) == 4 and int(hi[0]) == 0
    for q in range(20):
        a, l, h = int(order[q]), int(lo[q]), int(hi[q])
        nz = torch.nonzero(M[a]).reshape(-1)
        if len(nz):
            assert (l, h) == (int(nz.min()), int(nz.max()) + 1)
            assert torch.equal(coef[q, W - (h - l):], M[a, l:h])
        assert bool((coef[q, :W - (h - l)] == 0).all())
    seg = _segments(M, S)
    for q in range(20):
        a, b = seg[q // S]
        if hi[q] > lo[q]:
            assert a <= int(lo[q]) and int(hi[q]) <= b


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


def _banded(n, m, band, seed):
    """A random ``(n, m)`` matrix, nonzero within ``band`` of its scaled
    diagonal ``j = i m / n``: a range of up to ``2 band + 1``."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, m))
    i, j = np.indices((n, m))
    M[np.abs(j - (i * m) // n) > band] = 0.0
    return torch.tensor(M, dtype=torch.float32)


def _cycle_mats(nc, pc, pf, direction):
    I = torch.tensor(axis_interpolation_matrix(nc, pc, pf),
                     dtype=torch.float32)
    return tt.transfer_mats((I, I, I), direction)


@pytest.mark.parametrize("case", ["restrict", "prolong", "banded",
                                  "permuted"])
def test_nonzero_width_and_order_cached_and_refreshed(case):
    """The widest range equals numpy's ``max(hi - lo)`` and the order is a
    stable sort of ``hi``, both cached with the ranges and recomputed
    after an in-place write."""
    if case in ("restrict", "prolong"):
        M = _cycle_mats(9, 3, 6, case)[1]
    else:
        M = _banded(23, 31, 4, 2)
        if case == "permuted":
            M = M[torch.randperm(23, generator=torch.Generator()
                                 .manual_seed(0))].contiguous()
    for axis in (0, 1):
        nz = M.numpy() != 0
        nz = nz if axis == 0 else nz.T
        lo = np.where(nz.any(1), nz.argmax(1), 0)
        hi = np.where(nz.any(1), nz.shape[1] - nz[:, ::-1].argmax(1), 0)
        assert tt.nonzero_width(M, axis) == int((hi - lo).max())
        ranges, width, order = tt._nz_lines(M, axis)
        assert tt._nz_lines(M, axis)[2] is order           # cached
        assert ranges.tolist() == [lo.tolist(), hi.tolist()]
        assert order.dtype == torch.int32
        assert order.tolist() == np.argsort(hi, kind="stable").tolist()
    before = tt.nonzero_width(M, 0)
    M[0, :] = 1.0                      # an in-place write refreshes them
    assert tt.nonzero_width(M, 0) == M.shape[1] > before
    hi = tt.nonzero_ranges(M, 0)[1].numpy()
    assert tt._nz_lines(M, 0)[2].tolist() == np.argsort(
        hi, kind="stable").tolist()


# The fused V-cycle's four transfers at 16.2M dofs (nc 42, p 1-3-6): t's
# (A, NY, NZ), out's (B, C) and the plan on a 132-SM card.
CYCLE_PLANS = [
    ((3, 6, "restrict"), (127, 253, 253), (127, 127), (12, 32)),
    ((1, 3, "restrict"), (43, 127, 127), (43, 43), (8, 8)),
    ((1, 3, "prolong"), (127, 43, 43), (127, 127), (4, 32)),
    ((3, 6, "prolong"), (253, 127, 127), (253, 253), (4, 32)),
]


@pytest.mark.parametrize("pair,t_shape,out_bc,plan", CYCLE_PLANS)
def test_yz_plan_for_the_cycle_shapes(pair, t_shape, out_bc, plan):
    """`yz_plan` on the widths the V-cycle's matrices give: the narrowest
    ring width that holds the widest range, and the most rows per block
    that still give the card three blocks for every two SMs; its shared
    memory fits under the default 48 KB."""
    pc, pf, direction = pair
    _, My, MzT = _cycle_mats(42, pc, pf, direction)
    A, NY, NZ = t_shape
    B, C = out_bc
    assert My.shape == (B, NY) and MzT.shape == (NZ, C)
    width = max(tt.nonzero_width(My, 0), tt.nonzero_width(MzT, 1))
    assert width == {6: 12, 3: 5 if direction == "restrict" else 4,
                     1: 2}[pf if direction == "restrict" else pc]
    assert tt.yz_plan(A, NZ, B, C, width, 132) == plan
    assert tt.yz_smem(*plan, NZ, C) <= 48 * 1024


@pytest.mark.parametrize("direction,W", [("restrict", 12), ("restrict", 16),
                                         ("prolong", 4), ("prolong", 0)])
def test_yz_operands_layout(direction, W):
    """`transfer_yz`'s operands laid out once per matrix: the rows in the
    stable order of their ends with their ranges, each row's coefficients
    aligned to its end (zero below its start), the columns' band of MzT
    (zero past each range); refreshed after an in-place write."""
    _, My, MzT = _cycle_mats(9, 3, 6, direction)
    rows, coef = tt._yz_rows(My, W)
    (lo, hi), order = tt.nonzero_ranges(My, 0), tt._nz_lines(My, 0)[2]
    assert rows.tolist() == [order.tolist(), lo[order.long()].tolist(),
                             hi[order.long()].tolist()]
    assert tt._yz_rows(My, W)[0] is rows                 # cached
    band = tt._yz_band(MzT, W)
    if W == 0:
        assert coef is None and band is None
        return
    M = My.numpy()
    for p, (b, l, h) in enumerate(rows.T.tolist()):
        want = [M[b, h - W + d] if h - W + d >= l else 0.0 for d in range(W)]
        assert coef[p].tolist() == want
    zlo, zhi = tt.nonzero_ranges(MzT, 1).tolist()
    for c in range(MzT.shape[1]):
        want = [float(MzT[zlo[c] + d, c]) if d < zhi[c] - zlo[c] else 0.0
                for d in range(W)]
        assert band[:, c].tolist() == want
    My[0, 0] += 1.0                    # an in-place write refreshes them
    assert tt._yz_rows(My, W)[0] is not rows


def test_yz_launch_record_cached_and_rebuilt():
    """One launch record per (My, MzT) pair: the plan and the pointers of
    the laid-out operands, read back from the cache, rebuilt for another
    slab count, another MzT or after an in-place write."""
    _, My, MzT = _cycle_mats(9, 3, 6, "restrict")
    tt._SMS.setdefault(None, 132)       # a CPU tensor's device index
    t = torch.zeros((19, 55, 55))
    rec = tt._yz_launch(t, My, MzT)
    W, RB = tt.yz_plan(19, 55, 19, 19, 12, tt._sms(t.device))
    rows, coef = tt._yz_rows(My, W)
    assert rec == (W, RB, rows.data_ptr(), coef.data_ptr(),
                   tt.nonzero_ranges(MzT, 1).data_ptr(),
                   tt._yz_band(MzT, W).data_ptr())
    assert tt._yz_launch(t, My, MzT) is rec
    assert tt._yz_launch(torch.zeros((3, 55, 55)), My, MzT) is not rec
    rec = tt._yz_launch(t, My, MzT)
    assert tt._yz_launch(t, My, MzT.clone()) is not rec
    rec = tt._yz_launch(t, My, MzT)
    MzT[0, 0] += 0.0
    assert tt._yz_launch(t, My, MzT) is not rec


def test_yz_plan_runtime_width_and_limits():
    """A range wider than every ring width takes W = 0 (the runtime-width
    variant), a small card gets more rows per block, and a z-extent no
    block's shared memory holds raises."""
    assert tt.yz_plan(40, 70, 20, 33, max(tt.YZ_WIDTHS) + 1, 132)[0] == 0
    assert tt.yz_plan(40, 70, 20, 33, 16, 132) == (16, 4)
    assert tt.yz_plan(127, 253, 127, 127, 12, 8) == (12, 32)
    assert tt.yz_plan(3, 253, 3, 127, 0, 132) == (4, 4)
    with pytest.raises(ValueError, match="shared memory"):
        tt.yz_plan(4, 60000, 4, 4, 3, 132)


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


# transfer_yz alone: the fused V-cycle's four shapes (nc 42), then odd
# extents (NZ off the 32-lane grid; restrictions from p=6 with NY = 7,
# shorter than a coarse row's range of up to 13) for three degree pairs.
YZ_CASES = ([(42, pc, pf) for pc, pf in ((3, 6), (1, 3))]
            + [((3, 1, 5), pc, pf) for pc, pf in ((1, 3), (3, 6), (2, 5))])


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["restrict", "prolong"])
@pytest.mark.parametrize("nc,pc,pf", YZ_CASES)
def test_cuda_transfer_yz_shapes(cuda_device, nc, pc, pf, direction):
    """`transfer_yz` against `plain_transfer_yz`: <= 1e-5 relative
    max-norm, one launch counted."""
    ncs = (nc,) * 3 if isinstance(nc, int) else nc
    I1s = [torch.tensor(axis_interpolation_matrix(n, pc, pf),
                        dtype=torch.float32, device=cuda_device) for n in ncs]
    Mx, My, MzT = tt.transfer_mats(I1s, direction)
    p = pf if direction == "restrict" else pc
    shape = (Mx.shape[0],) + tuple(n * p + 1 for n in ncs[1:])
    t = torch.tensor(np.random.default_rng(sum(shape)).standard_normal(shape),
                     dtype=torch.float32, device=cuda_device)
    before = tt.LAUNCHES["transfer_yz"]
    y = tt.transfer_yz(t, My, MzT)
    assert _rel_max(y, tt.plain_transfer_yz(t, My, MzT)) <= 1e-5
    assert tt.LAUNCHES["transfer_yz"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("permute", [False, True])
def test_cuda_transfer_yz_runtime_width(cuda_device, permute):
    """A band wider than every ring width (the runtime-width variant), and
    the same rows in a shuffled order with an all-zero row (ranges whose
    ends are not sorted) at a width the rings hold."""
    band = 10 if not permute else 3
    My, MzT = _banded(20, 45, band, 1), _banded(33, 70, band, 2).T
    if permute:
        My = My[torch.randperm(20, generator=torch.Generator()
                               .manual_seed(0))]
        My[4] = 0.0
    My, MzT = My.contiguous().to(cuda_device), MzT.contiguous().to(cuda_device)
    assert (tt.nonzero_width(My, 0) > max(tt.YZ_WIDTHS)) != permute
    t = torch.tensor(np.random.default_rng(4).standard_normal((6, 45, 70)),
                     dtype=torch.float32, device=cuda_device)
    y = tt.transfer_yz(t, My, MzT)
    assert _rel_max(y, tt.plain_transfer_yz(t, My, MzT)) <= 1e-5
    with pytest.raises(ValueError, match="MzT has shape"):
        tt.transfer_yz(t, My, MzT[:-1].contiguous())


# transfer_x alone: the fused V-cycle's shapes (nc 42) and odd extents.
X_CASES = [(42, 3, 6), (42, 1, 3), ((3, 5, 7), 1, 3), ((3, 5, 7), 3, 6),
           ((2, 1, 9), 2, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("sms", [None, 1, 16])
@pytest.mark.parametrize("direction", ["restrict", "prolong"])
@pytest.mark.parametrize("nc,pc,pf", X_CASES)
def test_cuda_transfer_x_shapes(cuda_device, monkeypatch, nc, pc, pf,
                                direction, sms):
    """`transfer_x` against `plain_transfer_x`, <= 1e-5 relative max-norm,
    one launch: on the card's SM count (the cycle's plans: marches of 64
    and 16 rows, the direct form) and as if on fewer SMs (longer
    segments, the march where the card would take the direct form)."""
    if sms is not None:
        monkeypatch.setattr(tt, "_sms", lambda device: sms)
    ncs = (nc,) * 3 if isinstance(nc, int) else nc
    Mx = tt.transfer_mats([torch.tensor(axis_interpolation_matrix(n, pc, pf),
                                        dtype=torch.float32,
                                        device=cuda_device) for n in ncs],
                          direction)[0]
    p = pf if direction == "restrict" else pc
    shape = tuple(n * p + 1 for n in ncs)
    x3 = torch.tensor(np.random.default_rng(sum(shape)).standard_normal(shape),
                      dtype=torch.float32, device=cuda_device)
    before = tt.LAUNCHES["transfer_x"]
    t = tt.transfer_x(x3, Mx)
    assert tt.LAUNCHES["transfer_x"] == before + 1
    assert _rel_max(t, tt.plain_transfer_x(x3, Mx)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("sms", [None, 1])
@pytest.mark.parametrize("case", ["permuted", "wide", "dense"])
def test_cuda_transfer_x_any_matrix(cuda_device, monkeypatch, case, sms):
    """Rows whose ranges end out of order with an all-zero row (ring width
    4), a band wider than every ring (the runtime width) and a dense
    matrix, as the march and as the direct form."""
    if sms is not None:
        monkeypatch.setattr(tt, "_sms", lambda device: sms)
    if case == "permuted":
        M = _banded(20, 45, 1, 1)[torch.randperm(
            20, generator=torch.Generator().manual_seed(0))]
        M[4] = 0.0
    elif case == "wide":
        M = _banded(20, 45, 10, 2)
    else:
        M = torch.rand((7, 45), generator=torch.Generator().manual_seed(3))
    M = M.contiguous().to(cuda_device)
    x3 = torch.tensor(np.random.default_rng(4).standard_normal((45, 30, 70)),
                      dtype=torch.float32, device=cuda_device)
    t = tt.transfer_x(x3, M)
    assert _rel_max(t, tt.plain_transfer_x(x3, M)) <= 1e-5
    if case == "permuted":
        assert bool((t[4] == 0).all())


@pytest.mark.cuda
def test_cuda_transfer_x_same_bits_and_first_call_in_graph_capture(
        cuda_device):
    """Two calls give the same bits; a first call on new matrices (their
    rows laid out inside the capture; the widest range, the one host
    read, taken before it) inside a CUDA graph capture, replayed, gives
    them again, for the march and the direct form."""
    for nc, pc, pf in ((42, 3, 6), (42, 1, 3)):
        I = torch.tensor(axis_interpolation_matrix(nc, pc, pf),
                         dtype=torch.float32, device=cuda_device)
        Mx = tt.transfer_mats((I, I, I), "restrict")[0]
        n = nc * pf + 1
        x3 = torch.tensor(np.random.default_rng(n).standard_normal(
            (n, n, n)), dtype=torch.float32, device=cuda_device)
        t1, t2 = tt.transfer_x(x3, Mx), tt.transfer_x(x3, Mx)
        assert torch.equal(t1, t2)
        M2 = Mx.clone()
        tt.nonzero_width(M2, 0)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            t3 = tt.transfer_x(x3, M2)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(t3, t1)
