"""precision="high" (bf16x3) in the port, held to the JAX package.

- `split_bf16` equals `pmg_dolfinx_tpu.ops.pallas_util.split_bf16` bit
  for bit on seeded f32 arrays with ties, tiny (subnormal and near-
  subnormal) values and signed zeros.
- The plain 'high' versions of the blocked Kronecker kernels #1-#9
  (separable apply #1+#2, residual #1+#3, full-bc #4+#5 and #4+#6, the
  fused Chebyshev step #4+#7, the grid kernels #8 / #9 with both edge
  corrections and ``sigma``) against the JAX entry points at 'high' with
  ``interpret=True`` (the Pallas kernels' `high` branches): <= 1e-5
  relative in the max norm. The lattice kernels K-A ('v1', 'yexp', 'ym'),
  K-A on the z-grouped geometry ('zgrp') and K-B ('geom') the same way.
- The split acts: for each operator, the port's gap between 'high' and
  'highest' is within a factor 2 of JAX's gap on the same input (a gap
  near f32 rounding, ~1e-8, would mean no split).
- The slice: `PMGHierarchy` at 'high' (kron_blocked + fdm, and
  lattice_blocked + cg on a curved mesh) takes JAX's FCG count within 1
  and follows its trajectory within 1e-4 (relative, above 5e-3); the
  stationary warning behaves as JAX's; a 'high' solve leaves
  ``torch.backends.cuda.matmul.allow_tf32`` as it was.
- On the card (marked ``cuda``; skipped without a GPU), each HIGH kernel
  against its plain 'high' version, and a first HIGH launch inside a CUDA
  graph capture. Those tests need no JAX:
  ``python -m pytest --noconftest -m cuda tests/test_torch_precision_high.py``.
"""

import warnings
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh as TBox  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh as TCurved  # noqa: E402
from pmg_dolfinx_tpu_torch.ops import kron_blocked as tkb  # noqa: E402
from pmg_dolfinx_tpu_torch.ops import lattice_blocked as tlb  # noqa: E402

NC = (3, 4, 5)
P = 3
TOL = 1e-5
_SEPARABLE = ("sxzm", "s23m", "mx2", "myb", "mzrow")


@pytest.fixture
def jx():
    """The JAX reference modules, imported here so that the card tests of
    this file do not need JAX."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from pmg_dolfinx_tpu.fem.mesh import BoxMesh, PerturbedBoxMesh
    from pmg_dolfinx_tpu.ops import pallas_kron_blocked, pallas_util
    from pmg_dolfinx_tpu.ops import pallas_lattice_blocked
    from pmg_dolfinx_tpu.ops.kron import KronLaplacian

    return SimpleNamespace(jnp=jnp, BoxMesh=BoxMesh, Curved=PerturbedBoxMesh,
                           jkb=pallas_kron_blocked, util=pallas_util,
                           jlb=pallas_lattice_blocked,
                           KronLaplacian=KronLaplacian)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, np.float64)


def _rel(a, b):
    """Relative difference in the max norm."""
    a, b = _np(a), _np(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _check_pair(port_high, port_highest, jax_high, jax_highest, what):
    """The port's 'high' result within TOL of JAX's, and its gap to
    'highest' within a factor 2 of JAX's gap."""
    err = _rel(port_high, jax_high)
    gap_t = _rel(port_high, port_highest)
    gap_j = _rel(jax_high, jax_highest)
    assert err <= TOL, (what, err)
    assert gap_j > 1e-7, (what, gap_j)   # the reference's split acts
    assert 0.5 * gap_j <= gap_t <= 2.0 * gap_j, (what, gap_t, gap_j)


# -- the split --------------------------------------------------------------

def test_split_bf16_bit_equal_to_jax(jx):
    rng = np.random.default_rng(0)
    a = rng.standard_normal(4096).astype(np.float32)
    # ties of the hi rounding (exactly half a bf16 ulp above a bf16
    # value, odd and even), ties of the lo rounding, tiny and subnormal
    # values, signed zeros
    base = rng.standard_normal(64).astype(np.float32)
    bits = base.view(np.uint32) & np.uint32(0xFFFF0000)
    ties = np.concatenate([bits | np.uint32(0x8000),
                           (bits | np.uint32(0x18000)),
                           bits | np.uint32(0x0080),
                           bits | np.uint32(0x8080)]).view(np.float32)
    tiny = np.concatenate([
        rng.standard_normal(64).astype(np.float32) * np.float32(1e-36),
        rng.standard_normal(64).astype(np.float32) * np.float32(1e-39),
        np.array([0.0, -0.0, 1e-45, -1e-45, 1.17549435e-38],
                 np.float32)])
    a = np.concatenate([a, ties, tiny])
    hi_j, lo_j = jx.util.split_bf16(jx.jnp.asarray(a))
    hi_t, lo_t = tkb.split_bf16(torch.from_numpy(a))
    assert hi_t.dtype == lo_t.dtype == torch.bfloat16
    for t, j in ((hi_t, hi_j), (lo_t, lo_j)):
        tb = t.view(torch.int16).numpy()
        jb = np.asarray(j).view(np.int16)
        assert np.array_equal(tb, jb)


def test_dot3_drops_only_lo_lo():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((7, 9)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((9, 5)).astype(np.float32))
    (ah, al), (bh, bl) = tkb.split_bf16(a), tkb.split_bf16(b)
    got = tkb.dot3("ik,kj->ij", (ah, al), (bh, bl))
    f = lambda t: t.double()
    want = f(ah) @ f(bh) + f(ah) @ f(bl) + f(al) @ f(bh)
    assert torch.allclose(got.double(), want, rtol=1e-6, atol=1e-6)
    exact = a.double() @ b.double()
    gap = (got.double() - exact).abs().max() / exact.abs().max()
    assert 1e-7 < gap < 1e-4


# -- kernels #1-#9 ------------------------------------------------------------

def _kron_setup(jx, faces=True, seed=0):
    jm = jx.BoxMesh(NC, dirichlet_faces=faces)
    tm = TBox(NC, dirichlet_faces=faces)
    base = jx.KronLaplacian(jm, P, kappa=2.0, dtype=jx.jnp.float32)
    shape = jm.lattice_shape(P)
    bc3 = np.array(base.bc_marker).reshape(shape)
    fm = tkb.checked_face_masks(tm, P, tm.boundary_dof_marker(P))
    tmats = tkb.symmetrized_mats([np.asarray(K) for K in base.Ks],
                                 [np.asarray(m) for m in base.ms],
                                 torch.float32, fm, band=P, device="cpu")
    # both sides read the same f32 arrays
    jmats = {k: jx.jnp.asarray(v.numpy()) for k, v in tmats.items()
             if k != "band"}
    rng = np.random.default_rng(seed)
    x, b = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    return bc3, jmats, tmats, x, b


def _full(mats):
    """The full-bc set: the separable arrays dropped (kernels #4-#8)."""
    return {k: v for k, v in mats.items() if k not in _SEPARABLE}


@pytest.mark.parametrize("sigma", [0.0, 0.5])
@pytest.mark.parametrize("separable", [True, False])
def test_apply_and_residual_high_match_jax(jx, separable, sigma):
    """#1+#2 / #1+#3 (separable) and #4+#5 / #4+#6 (full bc)."""
    jnp, jkb = jx.jnp, jx.jkb
    bc3, jmats, tmats, x, b = _kron_setup(jx)
    if not separable:
        jmats, tmats = _full(jmats), _full(tmats)
    tbc = torch.from_numpy(bc3)
    tx, tb = torch.from_numpy(x), torch.from_numpy(b)
    for fn in ("apply", "residual"):
        out = {}
        for prec in ("high", "highest"):
            if fn == "apply":
                out["j", prec] = jkb.blocked_kron_apply(
                    jnp.asarray(x), bc3, jmats, precision=prec,
                    interpret=True, sigma=sigma)
                out["t", prec] = tkb.blocked_kron_apply(
                    tx, tbc, tmats, precision=prec, sigma=sigma)
            else:
                out["j", prec] = jkb.blocked_kron_residual(
                    jnp.asarray(b), jnp.asarray(x), bc3, jmats,
                    precision=prec, interpret=True, sigma=sigma)
                out["t", prec] = tkb.blocked_kron_residual(
                    tb, tx, tbc, tmats, precision=prec, sigma=sigma)
        _check_pair(out["t", "high"], out["t", "highest"], out["j", "high"],
                    out["j", "highest"], (fn, separable, sigma))


@pytest.mark.parametrize("sigma", [0.0, 0.5])
def test_kernel_1_alone_high_matches_jax(jx, sigma):
    """t1' of kernel #1 on its own (JAX's `_kernel_t1_m` body through its
    built call), at both precisions."""
    bc3, jmats, tmats, x, _ = _kron_setup(jx)
    tx = torch.from_numpy(x)
    out = {}
    for prec in ("high", "highest"):
        t1c, _ = jx.jkb._build_calls_m(tuple(x.shape), 8, 8, prec == "high",
                                       True, (), sigma)
        out["j", prec] = t1c(jx.jnp.asarray(x), jmats["myb"], jmats["Ktx"],
                             jmats["sxzm"])
        out["t", prec] = tkb.plain_t1_m(tx, tmats, prec == "high")
    _check_pair(out["t", "high"], out["t", "highest"], out["j", "high"],
                out["j", "highest"], "t1_m")


@pytest.mark.parametrize("sigma", [0.0, 0.5])
def test_cheb_high_matches_jax(jx, sigma):
    """#4+#7: the fused Chebyshev smoother at 'high'."""
    jnp, jkb = jx.jnp, jx.jkb
    bc3, jmats, tmats, x, b = _kron_setup(jx)
    jmats, tmats = _full(jmats), _full(tmats)
    dinv = (np.abs(np.random.default_rng(5).standard_normal(bc3.shape))
            + 0.5).astype(np.float32)
    out = {}
    for prec in ("high", "highest"):
        out["j", prec] = jkb.blocked_kron_cheb4(
            jnp.asarray(b), jnp.asarray(x), bc3, jmats, jnp.asarray(dinv),
            jnp.asarray(7.5, jnp.float32), 2, precision=prec, interpret=True,
            sigma=sigma)
        out["t", prec] = tkb.blocked_kron_cheb4(
            torch.from_numpy(b), torch.from_numpy(x), torch.from_numpy(bc3),
            tmats, torch.from_numpy(dinv), torch.tensor(7.5), 2,
            precision=prec, sigma=sigma)
    _check_pair(out["t", "high"], out["t", "highest"], out["j", "high"],
                out["j", "highest"], ("cheb", sigma))


@pytest.mark.parametrize("separable", [True, False])
def test_grid_kernels_high_match_jax(jx, separable):
    """#9 (separable) / #8 (full bc) on one shard with both edge
    corrections (fixed received planes) and ``sigma``, apply and fused
    residual."""
    jnp, jkb = jx.jnp, jx.jkb
    bc3, jmats, tmats, x, b = _kron_setup(jx)
    for m in (jmats, tmats):
        m["Ktye"] = m["Kty"][np.array([0, -1])]
        m["KtzTe"] = m["KtzT"][:, np.array([0, -1])]
    if not separable:
        jmats, tmats = _full(jmats), _full(tmats)
    NX, NY, NZ = x.shape
    rng = np.random.default_rng(9)
    cy = rng.standard_normal((2, NX, NZ)).astype(np.float32)
    cz = rng.standard_normal((2, NX, NY)).astype(np.float32)
    ex = lambda c, mod: lambda a0, a1: (mod.asarray(c[0]), mod.asarray(c[1]))
    tmod = SimpleNamespace(asarray=torch.from_numpy)
    for r in (None, b):
        out = {}
        for prec in ("high", "highest"):
            out["j", prec] = jkb.blocked_kron_apply_grid(
                jnp.asarray(x), bc3, jmats, precision=prec, interpret=True,
                ex_y=ex(cy, jnp), ex_z=ex(cz, jnp), sigma=0.5,
                r3=None if r is None else jnp.asarray(r))
            out["t", prec] = tkb.blocked_kron_apply_grid(
                torch.from_numpy(x), torch.from_numpy(bc3), tmats,
                precision=prec, ex_y=ex(cy, tmod), ex_z=ex(cz, tmod),
                sigma=0.5, r3=None if r is None else torch.from_numpy(r))
        _check_pair(out["t", "high"], out["t", "highest"], out["j", "high"],
                    out["j", "highest"], ("grid", separable, r is None))


def test_pallas_kron_blocked_high_operator(jx):
    """The operator class at 'high' against JAX's (interpret mode)."""
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh

    from pmg_dolfinx_tpu.ops.pallas_kron_blocked import PallasKronBlocked

    nc, p = (5, 4, 3), 4
    x = np.random.default_rng(2).standard_normal(
        TBox(nc).num_dofs(p)).astype(np.float32)
    out = {}
    for prec in ("high", "highest"):
        out["j", prec] = PallasKronBlocked(jx.BoxMesh(nc), p, kappa=2.0,
                                           interpret=True,
                                           precision=prec)(jx.jnp.asarray(x))
        op = tkb.PallasKronBlocked(BoxMesh(nc), p, kappa=2.0, precision=prec,
                                   device="cpu")
        assert op.precision == prec
        out["t", prec] = op(torch.from_numpy(x))
    _check_pair(out["t", "high"], out["t", "highest"], out["j", "high"],
                out["j", "highest"], "PallasKronBlocked")


# -- K-A / K-B ----------------------------------------------------------------

@pytest.mark.parametrize("variant,nc,p", [
    ("v1", (3, 2, 4), 3), ("yexp", (3, 2, 4), 3), ("ym", (3, 2, 4), 3),
    ("geom", (3, 2, 4), 3), ("zgrp", (3, 2, 6), 3), ("v1", (2, 2, 2), 6)])
def test_lattice_high_matches_jax(jx, variant, nc, p):
    """K-A ('v1', 'yexp', 'ym'), K-A on Gz ('zgrp') and K-B ('geom') at
    'high' against JAX's kernels in interpret mode, through the operator
    classes on a curved mesh."""
    zb = 2 if variant == "zgrp" else None
    x = np.random.default_rng(0).standard_normal(
        TCurved(nc).num_dofs(p)).astype(np.float32)
    out = {}
    for prec in ("high", "highest"):
        out["j", prec] = jx.jlb.PallasLatticeBlocked(
            jx.Curved(nc), p, kappa=2.0, interpret=True, variant=variant,
            zb=zb, precision=prec)(jx.jnp.asarray(x))
        op = tlb.PallasLatticeBlocked(TCurved(nc), p, kappa=2.0,
                                      variant=variant, zb=zb,
                                      precision=prec, device="cpu")
        out["t", prec] = op(torch.from_numpy(x))
    _check_pair(out["t", "high"], out["t", "highest"], out["j", "high"],
                out["j", "highest"], variant)


def test_lattice_high_default_variant_is_v1():
    """At 'high' the default variant runs the 'v1' splits, at 'highest'
    'yexp' (the JAX package's pick), and the plain version keeps the
    raw accumulation (``apply_bc=False``) on the Dirichlet rows."""
    nc, p = (2, 3, 2), 2
    op = tlb.PallasLatticeBlocked(TCurved(nc), p, precision="high",
                                  device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        op.ndofs).astype(np.float32))
    args = (x, op.mats, op.Gt, op.bc_marker, nc, p)
    v1 = tlb.blocked_lattice_apply(*args, precision="high", variant="v1")
    assert torch.equal(op(x), v1)
    assert torch.equal(tlb.blocked_lattice_apply(*args, precision="high"),
                       v1)
    yexp = tlb.blocked_lattice_apply(*args, precision="high",
                                     variant="yexp")
    assert not torch.equal(yexp, v1)
    raw = tlb.blocked_lattice_apply(*args, precision="high", apply_bc=False)
    bc = op.bc_marker
    assert torch.equal(raw[~bc], v1[~bc])
    assert torch.equal(v1[bc], x[bc])


# -- the slice ----------------------------------------------------------------

def _traj_within(rn_t, rn_j, r0, tol=1e-4, above=5e-3):
    """The port's residual norms within ``tol * r0`` of JAX's on the cycles
    above ``above * r0`` (a bf16x3 residual is ~1e-5 r0 from exact)."""
    rn_t, rn_j = np.asarray(rn_t, np.float64), np.asarray(rn_j, np.float64)
    keep = rn_j / r0 > above
    assert keep.any()
    return np.abs(rn_t - rn_j)[keep].max() / r0 <= tol


@pytest.mark.parametrize("operator,coarse,nc", [
    ("kron_blocked", "fdm", (4, 4, 4)), ("lattice_blocked", "cg", (3, 3, 3))])
def test_hierarchy_high_matches_jax(jx, operator, coarse, nc):
    """`PMGHierarchy(..., (1, 3, 6), float32, precision='high')` (the
    flagship's form on a box, the curved form on a PerturbedBoxMesh)
    against JAX's at 'high' on the CPU (its emulation: exact f32): six
    stationary cycles within 1e-4 of |b| above 5e-3 and FCG(V) to 1e-5
    within 1; the split shows (the port's 'high' and 'highest' cycles
    differ)."""
    from pmg_dolfinx_tpu.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu.models.poisson import f_rhs
    from pmg_dolfinx_tpu.solvers.pmg import PMGHierarchy as JHier
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    box = operator == "kron_blocked"
    jm = (jx.BoxMesh if box else jx.Curved)(nc)
    tm = (TBox if box else TCurved)(nc)
    kw = dict(degrees=(1, 3, 6), kappa=2.0, coarse=coarse, operator=operator)
    b = np.asarray(assemble_rhs(jm, 6, f_rhs(2.0)), np.float32)
    jh = JHier(jm, dtype=jx.jnp.float32, precision="high", **kw)
    _, rn_j = jh.solve(jx.jnp.asarray(b), num_cycles=6)
    _, n_j = jh.solve_pcg(jx.jnp.asarray(b), rtol=1e-5)
    th = PMGHierarchy(tm, dtype=torch.float32, precision="high",
                      device="cpu", **kw)
    tb = torch.from_numpy(b)
    _, rn_t = th.solve(tb, num_cycles=6)
    _, n_t = th.solve_pcg(tb, rtol=1e-5)
    r0 = float(np.linalg.norm(b))
    assert _traj_within(rn_t, np.asarray(rn_j), r0)
    assert abs(n_t - n_j) <= 1
    ref = PMGHierarchy(tm, dtype=torch.float32, device="cpu", **kw)
    assert list(ref.solve(tb, num_cycles=6)[1]) != list(rn_t)


def test_hierarchy_high_matches_split_jax(jx, monkeypatch):
    """The flagship's form at 'high' against JAX's split itself: JAX's
    `PMGHierarchy(BoxMesh((4,)*3), (1, 3, 6), float32, kron_blocked, fdm,
    'high')` with its cycle ops on the Pallas kernels in interpret mode
    (their `high` branches, as on the TPU; off the TPU JAX's default is an
    exact-f32 emulation). Six stationary cycles within 1e-4 of |b| above
    5e-3 and FCG(V) to rtol 1e-6 within 1. The FCG solutions solve the
    bf16x3 operator: the port's within 1e-5 of JAX's, and each as far from
    the exact-f32 solution as the other (a factor 1.5; ~2.4e-4 here), so
    the L2 growth of FCG at 'high' is JAX's own."""
    from functools import partial

    from pmg_dolfinx_tpu.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu.models.poisson import f_rhs
    from pmg_dolfinx_tpu.solvers.pmg import PMGHierarchy as JHier
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    for name in ("blocked_kron_apply", "blocked_kron_residual",
                 "blocked_kron_cheb4"):
        monkeypatch.setattr(jx.jkb, name,
                            partial(getattr(jx.jkb, name), interpret=True))
    nc = (4, 4, 4)
    kw = dict(degrees=(1, 3, 6), kappa=2.0, coarse="fdm",
              operator="kron_blocked")
    b = np.asarray(assemble_rhs(jx.BoxMesh(nc), 6, f_rhs(2.0)), np.float32)
    jh = JHier(jx.BoxMesh(nc), dtype=jx.jnp.float32, precision="high", **kw)
    _, rn_j = jh.solve(jx.jnp.asarray(b), num_cycles=6)
    u_j, n_j = jh.solve_pcg(jx.jnp.asarray(b), rtol=1e-6)
    tb = torch.from_numpy(b)
    th = PMGHierarchy(TBox(nc), dtype=torch.float32, precision="high",
                      device="cpu", **kw)
    _, rn_t = th.solve(tb, num_cycles=6)
    u_t, n_t = th.solve_pcg(tb, rtol=1e-6)
    u_x, _ = PMGHierarchy(TBox(nc), dtype=torch.float32, device="cpu",
                          **kw).solve_pcg(tb, rtol=1e-6)
    assert _traj_within(rn_t, np.asarray(rn_j), float(np.linalg.norm(b)))
    assert abs(n_t - n_j) <= 1
    u_j, u_t, u_x = _np(u_j), _np(u_t), _np(u_x)
    dist = lambda u, v: np.linalg.norm(u - v) / np.linalg.norm(v)  # noqa: E731
    assert dist(u_t, u_j) <= 1e-5
    d_j, d_t = dist(u_j, u_x), dist(u_t, u_x)
    assert d_j > 1e-5, d_j    # JAX's split moves the solution
    assert d_j / 1.5 <= d_t <= 1.5 * d_j, (d_t, d_j)


def test_stationary_warning_as_jax():
    """The shared runtime guard (JAX's `tests/test_solvers.py`
    `test_high_precision_stationary_guard`): warns only for
    precision='high' above ~8M global dofs, with JAX's text."""
    from pmg_dolfinx_tpu_torch.solvers.pmg import (
        warn_high_precision_stationary,
    )

    with pytest.warns(UserWarning, match="stalls") as rec:
        warn_high_precision_stationary("high", 16_200_000)
    assert "solve_pcg / solve_refined" in str(rec[0].message)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        warn_high_precision_stationary("highest", 16_200_000)
        warn_high_precision_stationary("high", 2_000_000)


def test_stationary_warning_text_equals_jax(jx):
    from pmg_dolfinx_tpu.solvers.pmg import (
        warn_high_precision_stationary as jwarn,
    )
    from pmg_dolfinx_tpu_torch.solvers.pmg import (
        warn_high_precision_stationary as twarn,
    )

    msgs = []
    for fn in (jwarn, twarn):
        with pytest.warns(UserWarning) as rec:
            fn("high", 8_000_001)
        msgs.append(str(rec[0].message))
    assert msgs[0] == msgs[1]


def test_high_solve_leaves_tf32_off():
    """A 'high' solve switches no TF32 flag: bf16x3 is done by the split,
    the einsums stay true f32."""
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    h = PMGHierarchy(TBox((2, 2, 2)), degrees=(1, 3), kappa=2.0,
                     dtype=torch.float32, coarse="fdm",
                     operator="kron_blocked", precision="high", device="cpu")
    h.solve_pcg(torch.ones(h.levels[-1].ndofs), rtol=1e-5)
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision()) == before
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_serving_pair_and_steppers_refuse_high():
    """The serving kernels' `high` branch is not ported: `PackedKronBatch`,
    `PackedKronSingle` and the `solvers.transient` steppers refuse 'high'
    naming ROADMAP.md Queue 1 item 1; 'highest' builds."""
    from pmg_dolfinx_tpu_torch.ops import kron_packed as kp
    from pmg_dolfinx_tpu_torch.solvers import transient as tr

    mesh = TBox((2, 2, 2))
    for make in (lambda p: kp.PackedKronBatch(mesh, 2, B=2, precision=p,
                                              device="cpu"),
                 lambda p: kp.PackedKronSingle(mesh, 2, precision=p,
                                               device="cpu"),
                 lambda p: tr.heat_fdm_evolve(mesh, 2, dt=1e-3, precision=p,
                                              device="cpu")):
        with pytest.raises(NotImplementedError, match="item 1"):
            make("high")
        make("highest")
    with pytest.raises(ValueError, match="precision must be"):
        kp.check_serving_precision("default")


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _card_mats(shape, band, device, seed, masks=True):
    """Random symmetric banded ``K_a`` and positive masses (a box's face
    masks when ``masks``): the blocked kernels' operands at any band."""
    rng = np.random.default_rng(seed)
    Ks, fm = [], []
    for n in shape:
        A = rng.standard_normal((n, n))
        i, j = np.indices((n, n))
        A[np.abs(i - j) > band] = 0.0
        Ks.append(A + A.T)
        m = np.ones(n)
        m[0] = m[-1] = 0.0
        fm.append(m)
    ms = [rng.uniform(0.5, 2.0, n) for n in shape]
    return rng, tkb.symmetrized_mats(Ks, ms, torch.float32,
                                     fm if masks else None, band=band,
                                     device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,band", [((9, 40, 45), 3), ((33, 13, 70), 6),
                                        ((20, 21, 37), 14)])
def test_cuda_high_kron_kernels_match_plain(cuda_device, shape, band):
    """Each HIGH kron kernel (#1-#9, the tile above band 12) against its
    plain 'high' version at extents off the warp and chunk grids:
    <= 1e-5 relative max norm, and a gap to the 'highest' kernel."""
    rng, m = _card_mats(shape, band, cuda_device, band)
    mf = {k: v for k, v in m.items() if k not in _SEPARABLE}
    f = lambda s: torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                               device=cuda_device)
    x, r, dinv = f(shape), f(shape), f(shape).abs() + 0.5
    bc = torch.tensor(rng.random(shape) < 0.02, device=cuda_device)
    bc[0], bc[-1] = True, True
    cy, cz = f((shape[0], 2, shape[2])), f((shape[0], shape[1], 2))
    t1m, t1 = tkb.plain_t1_m(x, m, True), tkb.plain_t1(x, bc, mf, True)
    lm = torch.tensor(3.1, device=cuda_device)
    coefs = tkb.cheb_coefs(lm, 1, torch.float32, cuda_device)
    cases = (
        (lambda h: tkb.kron_t1_m(x, m, high=h), t1m),
        (lambda h: tkb.kron_t23_m(x, t1m, m, 0.5, high=h),
         tkb.plain_t23_m(x, t1m, m, 0.5, high=True)),
        (lambda h: tkb.kron_t23_m(x, t1m, m, 0.5, cy, cz, r3=r, high=h),
         r - tkb.plain_t23_m(x, t1m, m, 0.5, cy, cz, high=True)),
        (lambda h: tkb.kron_t1(x, bc, mf, high=h), t1),
        (lambda h: tkb.kron_t23(x, bc, t1, mf, 0.5, high=h),
         tkb.plain_t23(x, bc, t1, mf, 0.5, high=True)),
        (lambda h: tkb.kron_t23(x, bc, t1, mf, 0.5, cy, cz, r3=r, high=h),
         r - tkb.plain_t23(x, bc, t1, mf, 0.5, cy, cz, high=True)),
        (lambda h: tkb.kron_t23_cheb(x, bc, t1, mf, r, r, dinv, lm, 1,
                                     high=h)[2],
         tkb.plain_cheb_step(x, bc, r, r, dinv, coefs, mf, t1=t1,
                             high=True)[2]),
    )
    for i, (call, ref) in enumerate(cases):
        got = call(True)
        torch.cuda.synchronize()
        assert _rel(got.cpu(), ref.cpu()) <= TOL, i
        assert _rel(got.cpu(), call(False).cpu()) > 1e-7, i


@pytest.mark.cuda
@pytest.mark.parametrize("P,nc,variant", [(1, (5, 3, 4), "v1"),
                                          (3, (4, 5, 3), "yexp"),
                                          (6, (3, 2, 4), "v1"),
                                          (6, (3, 2, 4), "geom"),
                                          (3, (3, 2, 6), "zgrp")])
def test_cuda_high_lattice_kernels_match_plain(cuda_device, P, nc, variant):
    """K-A (with the 'v1' and 'yexp' splits), K-A on Gz and K-B at 'high'
    against `plain_lattice_apply_high`: <= 1e-5 relative max norm."""
    op = tlb.PallasLatticeBlocked(TCurved(nc), P, variant=variant,
                                  zb=2 if variant == "zgrp" else None,
                                  precision="high", device=cuda_device)
    x = torch.randn(op.ndofs, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(P))
    got = op(x)
    if variant == "geom":
        ref = tlb.plain_lattice_apply_geom(x, op.mats, op.co, op.bc_marker,
                                           nc, P, high=True)
    elif variant == "zgrp":
        ref = tlb.plain_lattice_apply_zgrp(x, op.mats, op.Gz, op.bc_marker,
                                           nc, P, 2, high=True)
    else:
        ref = tlb.plain_lattice_apply(x, op.mats, op.Gt, op.bc_marker,
                                      high=True, v1=variant == "v1")
    torch.cuda.synchronize()
    assert _rel(got.cpu(), ref.cpu()) <= TOL


@pytest.mark.cuda
def test_cuda_high_first_call_in_graph_capture(cuda_device):
    """First HIGH launches (#1, #2, #5 and K-A at a band / degree no other
    test of this file uses) inside a CUDA graph capture, replayed: the
    same bits as the launches outside the graph."""
    shape, band = (11, 35, 41), 5
    rng, m = _card_mats(shape, band, cuda_device, 7)
    mf = {k: v for k, v in m.items() if k not in _SEPARABLE}
    x = torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                     device=cuda_device)
    bc = torch.tensor(rng.random(shape) < 0.02, device=cuda_device)
    t1 = tkb.plain_t1_m(x, m, True)
    op = tlb.PallasLatticeBlocked(TCurved((2, 3, 2)), 5, precision="high",
                                  device=cuda_device)
    xl = torch.ones(op.ndofs, device=cuda_device)
    calls = (lambda: tkb.kron_t1_m(x, m, high=True),
             lambda: tkb.kron_t23_m(x, t1, m, high=True),
             lambda: tkb.kron_t23(x, bc, t1, mf, high=True),
             lambda: op(xl))
    tkb.load_kernels(high=True)
    tlb.load_kernels(high=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        in_graph = [call() for call in calls]
    graph.replay()
    torch.cuda.synchronize()
    for call, y_g in zip(calls, in_graph):
        assert torch.equal(y_g, call())
