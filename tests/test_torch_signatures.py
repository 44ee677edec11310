"""The port's functions and classes bind positional arguments as the JAX
package does.

Each test calls the JAX original and the port's counterpart with the same
positional argument list and compares the results (f64 to 1e-12 unless
the JAX function is f32 only, then f32 to 1e-5). The TPU-only knobs
(``precision``, ``interpret``, ``xp``, the tile sizes ``by``/``bx``/
``bcells``) keep their positions in the port and take JAX's default
only; anything else raises. ``kron_laplacian_apply`` also takes JAX's
``exchange`` hook, applied to the K_x term before the terms are summed.
"""

import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from pmg_dolfinx_tpu.fem.mesh import BoxMesh as JBox  # noqa: E402
from pmg_dolfinx_tpu.fem.mesh import PerturbedBoxMesh as JPert  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh as TBox  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import (  # noqa: E402
    PerturbedBoxMesh as TPert,
)

NC = (3, 3, 3)
P = 2
SIGMA = 0.5


def _rel(a, b):
    a = np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _kron_factors(nc, p, dtype=np.float64):
    from pmg_dolfinx_tpu_torch.ops.kron import axis_stiffness_mass

    mesh = TBox(nc)
    Ks, ms = [], []
    for nc_a, h_a in zip(mesh.nc, mesh.h_cells):
        K, m = axis_stiffness_mass(nc_a, p, h_a)
        Ks.append((2.0 * K).astype(dtype))
        ms.append(m.astype(dtype))
    return mesh, Ks, ms


@pytest.mark.parametrize("apply_bc", [False, True])
def test_kron_laplacian_apply_positional(apply_bc):
    """``(x, Ks, ms, bc, "highest", apply_bc, exchange, sigma)``: the
    silent fault bound "highest" to ``apply_bc`` and overwrote the
    Dirichlet rows where JAX returns ``A x``."""
    from pmg_dolfinx_tpu.ops import kron as jk
    from pmg_dolfinx_tpu_torch.ops import kron as tk

    mesh, Ks, ms = _kron_factors(NC, P)
    shape = mesh.lattice_shape(P)
    x = np.random.default_rng(0).standard_normal(shape)
    bc = mesh.boundary_dof_marker(P).reshape(shape)
    tt = lambda a: torch.from_numpy(np.asarray(a))
    y_t = tk.kron_laplacian_apply(tt(x), [tt(K) for K in Ks],
                                  [tt(m) for m in ms], tt(bc), "highest",
                                  apply_bc)
    y_j = jk.kron_laplacian_apply(jnp.asarray(x), [jnp.asarray(K) for K in Ks],
                                  [jnp.asarray(m) for m in ms],
                                  jnp.asarray(bc), "highest", apply_bc)
    assert _rel(y_t, y_j) <= 1e-12
    # exchange (on the K_x term) and sigma, positionally
    y_t = tk.kron_laplacian_apply(tt(x), [tt(K) for K in Ks],
                                  [tt(m) for m in ms], tt(bc), "highest",
                                  apply_bc, lambda t: 2.0 * t, SIGMA)
    y_j = jk.kron_laplacian_apply(jnp.asarray(x), [jnp.asarray(K) for K in Ks],
                                  [jnp.asarray(m) for m in ms],
                                  jnp.asarray(bc), "highest", apply_bc,
                                  lambda t: 2.0 * t, SIGMA)
    assert _rel(y_t, y_j) <= 1e-12


def test_poisson_problem_positional():
    """JAX's 13th positional ``smoother``, 14th ``u_exact`` (the fault
    bound "cheb" to ``u_exact``), with 'cheb' and 'line', and 15th
    ``robin_g``."""
    from pmg_dolfinx_tpu.models import poisson as jp
    from pmg_dolfinx_tpu_torch.models import poisson as tp

    u_ex = lambda x: np.sin(np.pi * x[0]) * x[1] * (1 - x[1]) * np.sin(
        np.pi * x[2])
    args = ((2, 2, 2), (1, 2), 2.0)
    rest = ("smoother", None, 2, "kron", "highest", None, None, 0.0, "cheb",
            u_ex)
    jprob = jp.PoissonProblem(*args, jnp.float64, *rest)
    tprob = tp.PoissonProblem(*args, torch.float64, *rest, device="cpu")
    uj, _ = jprob.solve(num_cycles=3)
    ut, _ = tprob.solve(num_cycles=3)
    assert _rel(ut, uj) <= 1e-12
    assert abs(tprob.error_l2(ut) - jprob.error_l2(np.asarray(uj))) <= (
        1e-12 * jprob.error_l2(np.asarray(uj)))
    jline = jp.PoissonProblem(*args, jnp.float64, *rest[:-2], "line")
    tline = tp.PoissonProblem(*args, torch.float64, *rest[:-2], "line",
                              device="cpu")
    assert tline.hierarchy.levels[-1].line_axis == (
        jline.hierarchy.levels[-1].line_axis)
    assert _rel(tline.solve(num_cycles=3)[0], jline.solve(num_cycles=3)[0]
                ) <= 1e-12
    # robin_g, 15th: the Robin data of a mesh with Robin faces
    faces = ((True, True), (False, False), (True, True))
    robin = ((0.0, 0.0), (2.0, 1.0), (0.0, 0.0))
    g = {(1, 0): lambda x: x[0] + x[2], (1, 1): 0.5}
    jr = jp.PoissonProblem(*args, jnp.float64, *rest[:6],
                           JBox((2, 2, 2), dirichlet_faces=faces,
                                robin=robin), *rest[7:], g)
    tr = tp.PoissonProblem(*args, torch.float64, *rest[:6],
                           TBox((2, 2, 2), dirichlet_faces=faces,
                                robin=robin), *rest[7:], g, device="cpu")
    assert _rel(tr.b, np.asarray(jr.b)) <= 1e-13


def test_kron_laplacian_class_positional():
    """``KronLaplacian(mesh, P, kappa, dtype, precision, sigma)``."""
    from pmg_dolfinx_tpu.ops.kron import KronLaplacian as JK
    from pmg_dolfinx_tpu_torch.ops.kron import KronLaplacian as TK

    x = np.random.default_rng(1).standard_normal(TBox(NC).num_dofs(P))
    jop = JK(JBox(NC), P, 2.0, jnp.float64, "highest", SIGMA)
    top = TK(TBox(NC), P, 2.0, torch.float64, "highest", SIGMA,
             device="cpu")
    assert _rel(top(torch.from_numpy(x)), jop(jnp.asarray(x))) <= 1e-12
    with pytest.raises(NotImplementedError, match="precision='high'"):
        TK(TBox(NC), P, 2.0, torch.float64, "high", device="cpu")


def test_fdm_positional():
    """``FastDiagonalizationSolver(mesh, P, kappa, dtype, precision,
    sigma)`` and ``fdm_solve(b, Vs, Vts, dinv, bc, shape, precision,
    trims)``."""
    from pmg_dolfinx_tpu.solvers import fdm as jf
    from pmg_dolfinx_tpu_torch.solvers import fdm as tf

    b = np.random.default_rng(2).standard_normal(TBox(NC).num_dofs(P))
    js = jf.FastDiagonalizationSolver(JBox(NC), P, 2.0, jnp.float64,
                                      "highest", SIGMA)
    ts = tf.FastDiagonalizationSolver(TBox(NC), P, 2.0, torch.float64,
                                      "highest", SIGMA, device="cpu")
    assert _rel(ts.solve(b), js.solve(jnp.asarray(b))) <= 1e-12
    shape = TBox(NC).lattice_shape(P)
    u_t = tf.fdm_solve(torch.from_numpy(b), ts.Vs, ts.Vts, ts.dinv,
                       ts.bc_marker, shape, "highest", ts.trims)
    u_j = jf.fdm_solve(jnp.asarray(b), js.Vs, js.Vts, js.dinv, js.bc_marker,
                       shape, "highest", js.trims)
    assert _rel(u_t, u_j) <= 1e-12


def test_lattice_laplacian_apply_positional():
    """``lattice_laplacian_apply(x, mats, G, bc, precision, apply_bc)``."""
    from pmg_dolfinx_tpu.ops import lattice as jl
    from pmg_dolfinx_tpu_torch.ops import lattice as tl

    top = tl.LatticeLaplacian(TPert(NC), P, kappa=2.0, dtype=torch.float64,
                              device="cpu")
    jop = jl.LatticeLaplacian(JPert(NC), P, kappa=2.0, dtype=jnp.float64)
    x = np.random.default_rng(3).standard_normal(TPert(NC).num_dofs(P))
    y_t = tl.lattice_laplacian_apply(torch.from_numpy(x), top.mats, top.G,
                                     top.bc_marker, "highest", False)
    y_j = jl.lattice_laplacian_apply(jnp.asarray(x), jop.mats, jop.G,
                                     jop.bc_marker, "highest", False)
    assert _rel(y_t, y_j) <= 1e-12


@pytest.mark.parametrize("family", ["heat", "wave"])
def test_packed_evolve_positional(family):
    """``heat_packed_evolve(mesh, P, kappa, dt, B, scheme, interpret, f,
    f_time)`` and ``wave_packed_evolve(..., scheme, beta, gamma,
    interpret, ...)``; ``interpret=True`` raises in the port."""
    from pmg_dolfinx_tpu.solvers import transient as jt
    from pmg_dolfinx_tpu_torch.solvers import transient as tt

    nc, p, B = (3, 3, 4), 3, 2
    mesh = TBox(nc)
    rng = np.random.default_rng(4)
    U0 = rng.standard_normal((B, mesh.num_dofs(p))).astype(np.float32)
    U0[:, mesh.boundary_dof_marker(p)] = 0.0
    if family == "heat":
        args = (2.0, 2e-3, B, "cn")
        Uj = jt.heat_packed_evolve(JBox(nc), p, *args, False, None, None)(
            U0, 4)
        Ut = tt.heat_packed_evolve(mesh, p, *args, False, None, None,
                                   device="cpu")(U0, 4)
        assert _rel(Ut, Uj) <= 1e-5
        with pytest.raises(ValueError, match="interpret=True"):
            tt.heat_packed_evolve(mesh, p, *args, True, device="cpu")
        return
    dt = float(0.5 * jt.wave_stable_dt(JBox(nc), p, kappa=2.0))
    args = (2.0, dt, B, "newmark", 0.25, 0.5)
    Uj, Vj = jt.wave_packed_evolve(JBox(nc), p, *args, False, None, None)(
        U0, 0.0 * U0, 4)
    Ut, Vt = tt.wave_packed_evolve(mesh, p, *args, False, None, None,
                                   device="cpu")(U0, 0.0 * U0, 4)
    assert _rel(Ut, Uj) <= 1e-5 and _rel(Vt, Vj) <= 1e-5
    with pytest.raises(ValueError, match="interpret=True"):
        tt.wave_packed_evolve(mesh, p, *args, True, device="cpu")


def test_geometry_factors_positional():
    """``geometry_factors(xgeom, dofmap, dphi, weights, xp, kappa)``; the
    port's ``xp`` is numpy only."""
    from pmg_dolfinx_tpu.fem import geometry as jg
    from pmg_dolfinx_tpu_torch.fem import geometry as tg

    mesh = TPert(NC)
    kappa = np.random.default_rng(5).uniform(0.5, 2.0, mesh.ncells)
    args = (mesh.geometry_x, mesh.geometry_dofmap,
            tg.tabulate_geometry_dphi(P), tg.quadrature_weights_3d(P))
    G_t, d_t = tg.geometry_factors(*args, np, kappa)
    G_j, d_j = jg.geometry_factors(*args, np, kappa)
    assert _rel(G_t, G_j) <= 1e-12 and _rel(d_t, d_j) <= 1e-12
    with pytest.raises(ValueError, match="numpy only"):
        tg.geometry_factors(*args, torch, kappa)


def test_blocked_lattice_apply_geom_positional():
    """``blocked_lattice_apply_geom(x, mats, co, geom, bc, nc, P, *, xi,
    wx)``: ``geom`` is the fourth parameter."""
    from pmg_dolfinx_tpu.ops import pallas_lattice_blocked as jlb
    from pmg_dolfinx_tpu_torch.ops import lattice_blocked as tlb

    mesh = TPert(NC)
    co = tlb.lattice_geom_coefficients(mesh, P, np.full(mesh.ncells, 2.0))
    x = np.random.default_rng(6).standard_normal(mesh.num_dofs(P)).astype(
        np.float32)
    bc = mesh.boundary_dof_marker(P)
    geom_t, xi, wx = tlb.lattice_geom_data(NC, P, device="cpu")
    geom_j, _, _ = jlb.lattice_geom_data(NC, P)
    y_t = tlb.blocked_lattice_apply_geom(
        torch.from_numpy(x), tlb.lattice_blocked_mats(NC, P, device="cpu"),
        torch.tensor(co, dtype=torch.float32), geom_t, torch.tensor(bc), NC,
        P, xi=xi, wx=wx)
    y_j = jlb.blocked_lattice_apply_geom(
        jnp.asarray(x), jlb.lattice_blocked_mats(NC, P),
        jnp.asarray(co, jnp.float32), geom_j, jnp.asarray(bc), NC, P, xi=xi,
        wx=wx)
    assert _rel(y_t, y_j) <= 1e-5


@pytest.mark.parametrize("masks", [False, True])
def test_symmetrized_mats_positional(masks):
    """``symmetrized_mats(Ks, ms, dtype, face_masks)``."""
    from pmg_dolfinx_tpu.ops import pallas_kron_blocked as jkb
    from pmg_dolfinx_tpu_torch.ops import kron_blocked as tkb

    mesh, Ks, ms = _kron_factors(NC, P)
    fm = tkb.checked_face_masks(mesh, P, mesh.boundary_dof_marker(P))
    fm = fm if masks else None
    m_t = tkb.symmetrized_mats(Ks, ms, torch.float64, fm, band=P,
                               device="cpu")
    m_j = jkb.symmetrized_mats(Ks, ms, jnp.float64, fm)
    assert set(m_j) == set(m_t) - {"band"}
    for k, v in m_j.items():
        assert m_t[k].dtype == torch.float64
        assert _rel(m_t[k], v) <= 1e-15, k


def test_operator_classes_positional():
    """``PallasKronBlocked(mesh, P, kappa, by, bx, interpret, precision,
    sigma)``, ``PallasLatticeBlocked(mesh, P, kappa, bcells, interpret,
    precision, variant, zb)`` and ``PallasKronLaplacian(mesh, P, kappa,
    interpret)``; their TPU knobs take JAX's defaults only."""
    from pmg_dolfinx_tpu.ops import pallas_kron as jkf
    from pmg_dolfinx_tpu.ops import pallas_kron_blocked as jkb
    from pmg_dolfinx_tpu.ops import pallas_lattice_blocked as jlb
    from pmg_dolfinx_tpu_torch.ops import kron_blocked as tkb
    from pmg_dolfinx_tpu_torch.ops import kron_fused as tkf
    from pmg_dolfinx_tpu_torch.ops import lattice_blocked as tlb

    x = np.random.default_rng(7).standard_normal(TBox(NC).num_dofs(P)).astype(
        np.float32)
    tx = torch.from_numpy(x)
    top = tkb.PallasKronBlocked(TBox(NC), P, 2.0, None, None, False,
                                "highest", SIGMA, device="cpu")
    jop = jkb.PallasKronBlocked(JBox(NC), P, 2.0, None, None, False,
                                "highest", SIGMA)
    assert _rel(top(tx), jop(jnp.asarray(x))) <= 1e-5
    top = tlb.PallasLatticeBlocked(TPert(NC), P, 2.0, 1, False, "highest",
                                   "geom", None, device="cpu")
    jop = jlb.PallasLatticeBlocked(JPert(NC), P, 2.0, 1, False, "highest",
                                   "geom", None)
    assert _rel(top(tx), jop(jnp.asarray(x))) <= 1e-5
    top = tkf.PallasKronLaplacian(TBox(NC), P, 2.0, False, device="cpu")
    # JAX's CPU run needs its interpret mode; the port's takes the default
    jop = jkf.PallasKronLaplacian(JBox(NC), P, 2.0, True)
    assert _rel(top(tx), jop(jnp.asarray(x))) <= 1e-5
    for call in (
            lambda: tkb.PallasKronBlocked(TBox(NC), P, 2.0, 8, device="cpu"),
            lambda: tkb.PallasKronBlocked(TBox(NC), P, 2.0, None, None, True,
                                          device="cpu"),
            lambda: tlb.PallasLatticeBlocked(TPert(NC), P, 2.0, 2,
                                             device="cpu"),
            lambda: tkf.PallasKronLaplacian(TBox(NC), P, 2.0, True,
                                            device="cpu")):
        with pytest.raises(ValueError, match="TPU tile or mode knob"):
            call()


# The JAX package's TPU knobs that the port lacked until its signature
# scan found them: a JAX-style call raised TypeError.
PACKED_ARGS = {"PackedKronBatch": (2.0, 2, "highest", SIGMA),
               "PackedFDMBatch": (2.0, 2, SIGMA),
               "PackedKronSingle": (2.0, "highest", SIGMA),
               "PackedFDMSingle": (2.0, SIGMA)}


@pytest.mark.parametrize("cls", sorted(PACKED_ARGS))
def test_packed_classes_interpret_positional(cls):
    """The packed classes' trailing positional ``interpret=False``
    (`pallas_kron_packed.py:190, 401, 674, 893`): the apply or solve of
    JAX and the port with the same positionals; ``True`` raises."""
    from pmg_dolfinx_tpu.ops import pallas_kron_packed as jkp
    from pmg_dolfinx_tpu_torch.ops import kron_packed as tkp

    nc, p = (2, 2, 2), 2
    args = PACKED_ARGS[cls]
    jop = getattr(jkp, cls)(JBox(nc), p, *args, False)
    top = getattr(tkp, cls)(TBox(nc), p, *args, False, device="cpu")
    n = TBox(nc).num_dofs(p)
    shape = (2, n) if "Batch" in cls else (n,)
    x = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    call = "solve" if "FDM" in cls else "__call__"
    y_t = getattr(top, call)(torch.from_numpy(x))
    assert _rel(y_t, getattr(jop, call)(jnp.asarray(x))) <= 1e-5
    with pytest.raises(ValueError, match="TPU tile or mode knob"):
        getattr(tkp, cls)(TBox(nc), p, *args, True, device="cpu")
    with pytest.raises(ValueError, match="TPU tile or mode knob"):
        getattr(tkp, cls)(TBox(nc), p, *args, interpret=True, device="cpu")


def test_geom_to_G_xp_positional():
    """``geom_to_G(co, nc, P, xp)``: numpy, JAX's default, positionally;
    any other module raises."""
    from pmg_dolfinx_tpu.ops import pallas_lattice_blocked as jlb
    from pmg_dolfinx_tpu_torch.ops import lattice_blocked as tlb

    mesh = TPert(NC)
    co = tlb.lattice_geom_coefficients(mesh, P, np.full(mesh.ncells, 2.0))
    G_t = tlb.geom_to_G(co, NC, P, np)
    assert _rel(G_t, jlb.geom_to_G(co, NC, P, np)) <= 1e-12
    assert _rel(tlb.geom_to_G(torch.tensor(co), NC, P, xp=np), G_t) <= 1e-12
    with pytest.raises(ValueError, match="xp="):
        tlb.geom_to_G(co, NC, P, torch)


KRON_KNOBS = [dict(by=8, bx=8, interpret=None), dict(by=16), dict(bx=4),
              dict(interpret=True)]


@pytest.mark.parametrize("entry", ["apply", "residual", "cheb4"])
def test_blocked_kron_entry_points_keyword_knobs(entry):
    """``blocked_kron_apply/residual/cheb4(..., *, by=8, bx=8,
    interpret=None)``: JAX's keywords at their defaults give JAX's result
    (its CPU emulation path); any other value raises."""
    from pmg_dolfinx_tpu.ops import pallas_kron_blocked as jkb
    from pmg_dolfinx_tpu_torch.ops import kron_blocked as tkb

    mesh, Ks, ms = _kron_factors(NC, P, np.float32)
    shape = mesh.lattice_shape(P)
    bc = mesh.boundary_dof_marker(P).reshape(shape)
    fm = tkb.checked_face_masks(mesh, P, bc)
    tm = tkb.symmetrized_mats(Ks, ms, torch.float32, fm, band=P,
                              device="cpu")
    jm = jkb.symmetrized_mats(Ks, ms, jnp.float32, fm)
    rng = np.random.default_rng(9)
    x, b = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    dinv = np.full(shape, 0.5, np.float32)
    lmax = np.asarray(6.0, np.float32)
    tt = lambda a: torch.from_numpy(a)
    calls = {
        "apply": (lambda m, c, **k: m.blocked_kron_apply(c(x), c(bc), mt(m),
                                                         **k)),
        "residual": (lambda m, c, **k: m.blocked_kron_residual(
            c(b), c(x), c(bc), mt(m), **k)),
        "cheb4": (lambda m, c, **k: m.blocked_kron_cheb4(
            c(b), c(x), c(bc), mt(m), c(dinv), c(lmax), 2, **k))}
    mt = lambda m: tm if m is tkb else jm
    call = calls[entry]
    knobs = KRON_KNOBS[0]
    y_t = call(tkb, tt, sigma=SIGMA, **knobs)
    y_j = call(jkb, jnp.asarray, sigma=SIGMA, **knobs)
    assert _rel(y_t, y_j) <= 1e-5
    for bad in KRON_KNOBS[1:]:
        with pytest.raises(ValueError, match="TPU tile or mode knob"):
            call(tkb, tt, **bad)


def test_blocked_transfer_keyword_knobs():
    """``blocked_transfer(x3, Mx, My, MzT, *, by=8, bx=8,
    interpret=None)``."""
    from pmg_dolfinx_tpu.ops import pallas_transfer as jt
    from pmg_dolfinx_tpu_torch.ops import transfer as tt
    from pmg_dolfinx_tpu_torch.ops.lattice import axis_interpolation_matrix

    I1s = [axis_interpolation_matrix(n, 1, P) for n in NC]
    Mt = tt.transfer_mats([torch.tensor(I) for I in I1s], "restrict")
    Mj = jt.transfer_mats(I1s, "restrict")
    x = np.random.default_rng(10).standard_normal(
        TBox(NC).lattice_shape(P)).astype(np.float32)
    y_t = tt.blocked_transfer(torch.from_numpy(x), *Mt, **KRON_KNOBS[0])
    y_j = jt.blocked_transfer(jnp.asarray(x), *Mj, **KRON_KNOBS[0])
    assert _rel(y_t, y_j) <= 1e-6
    for bad in KRON_KNOBS[1:]:
        with pytest.raises(ValueError, match="TPU tile or mode knob"):
            tt.blocked_transfer(torch.from_numpy(x), *Mt, **bad)


@pytest.mark.parametrize("entry", ["apply", "zgrp", "geom"])
def test_blocked_lattice_entry_points_keyword_knobs(entry):
    """``blocked_lattice_apply(_zgrp, _geom)(..., *, bcells=1,
    interpret=None)``: JAX's defaults accepted, anything else raises."""
    from pmg_dolfinx_tpu.ops import pallas_lattice_blocked as jlb
    from pmg_dolfinx_tpu_torch.ops import lattice_blocked as tlb

    nc, p = (2, 2, 2), 2
    jop = jlb.PallasLatticeBlocked(JPert(nc), p, 2.0, 1, True, "highest",
                                   "zgrp" if entry == "zgrp" else
                                   ("geom" if entry == "geom" else None), 1)
    top = tlb.PallasLatticeBlocked(TPert(nc), p, 2.0, 1, False, "highest",
                                   "zgrp" if entry == "zgrp" else
                                   ("geom" if entry == "geom" else None), 1,
                                   device="cpu")
    x = np.random.default_rng(11).standard_normal(
        TPert(nc).num_dofs(p)).astype(np.float32)
    mats_t = tlb.lattice_blocked_mats(nc, p, device="cpu")
    mats_j = jlb.lattice_blocked_mats(nc, p)
    bc_t = torch.tensor(TPert(nc).boundary_dof_marker(p))
    bc_j = jnp.asarray(np.asarray(bc_t))

    def call(bad=None):
        k = dict(bcells=1, interpret=None) if bad is None else bad
        if entry == "apply":
            return (tlb.blocked_lattice_apply(torch.from_numpy(x), mats_t,
                                              top.Gt, bc_t, nc, p, **k),
                    None if bad else jlb.blocked_lattice_apply(
                        jnp.asarray(x), mats_j, jnp.asarray(np.asarray(
                            top.Gt)), bc_j, nc, p, **k))
        if entry == "zgrp":
            return (tlb.blocked_lattice_apply_zgrp(
                torch.from_numpy(x), mats_t, top.zmats, top.Gz, bc_t, nc, p,
                1, **k),
                    None if bad else jlb.blocked_lattice_apply_zgrp(
                        jnp.asarray(x), mats_j, jop.zmats, jnp.asarray(
                            np.asarray(top.Gz)), bc_j, nc, p, 1, **k))
        return (tlb.blocked_lattice_apply_geom(
            torch.from_numpy(x), mats_t, top.co, top.geom, bc_t, nc, p,
            xi=top._xi, wx=top._wx, **k),
                None if bad else jlb.blocked_lattice_apply_geom(
                    jnp.asarray(x), mats_j, jnp.asarray(np.asarray(top.co)),
                    jop.geom, bc_j, nc, p, xi=top._xi, wx=top._wx, **k))

    y_t, y_j = call()
    assert _rel(y_t, y_j) <= 1e-5
    for bad in (dict(bcells=2), dict(interpret=True)):
        with pytest.raises(ValueError, match="TPU tile or mode knob"):
            call(bad)


@pytest.mark.parametrize("coarse,item", [("direct", None),
                                         ("hmg", None),
                                         ("amg", "item 8")])
def test_coarse_refusal_names_its_roadmap_item(coarse, item):
    """`PMGHierarchy`'s refusal of an unported coarse solver names the
    ROADMAP item that ports it (8 for 'amg'); 'direct' and 'hmg' (item
    7a, ported) bind JAX's positional ``(mesh, degrees, kappa, dtype,
    smoother_iters, coarse, coarse_cfg)`` and cycle as JAX's (f64,
    1e-12)."""
    from pmg_dolfinx_tpu.solvers.pmg import PMGHierarchy as JH
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    args = ((1, 2), 2.0)
    rest = (2, coarse, None)
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            PMGHierarchy(TBox((2, 2, 2)), *args, torch.float64, *rest,
                         device="cpu")
        return
    th = PMGHierarchy(TBox((2, 2, 2)), *args, torch.float64, *rest,
                      device="cpu")
    jh = JH(JBox((2, 2, 2)), *args, jnp.float64, *rest)
    assert th.coarse == jh.coarse == coarse
    b = np.random.default_rng(3).standard_normal(th.levels[-1].ndofs)
    assert _rel(th.apply(b, np.zeros_like(b)),
                jh.apply(jnp.asarray(b), jnp.zeros(b.shape))) <= 1e-12


@pytest.mark.parametrize("kind", ["BoxMesh", "PerturbedBoxMesh"])
def test_mesh_robin_spacing_positional(kind):
    """``BoxMesh(nc, extent, dirichlet_faces, robin, spacing)`` and
    ``PerturbedBoxMesh(nc, extent, warp, dirichlet_faces, robin,
    spacing)``: JAX's parameter lists, and the same mesh from the same
    positionals."""
    import inspect

    from pmg_dolfinx_tpu.fem import mesh as jm
    from pmg_dolfinx_tpu_torch.fem import mesh as tm

    jcls, tcls = getattr(jm, kind), getattr(tm, kind)
    assert (list(inspect.signature(tcls).parameters)
            == list(inspect.signature(jcls).parameters))
    faces = ((False, True), (True, True), (False, False))
    robin = ((1.0, 0.0), (0.0, 0.0), (0.5, 2.0))
    spacing = (None, (1.0, 2.0, 4.0), None)
    args = (NC, (1.0, 2.0, 0.5)) + ((None,) if kind != "BoxMesh" else ()) + (
        faces, robin, spacing)
    j, t = jcls(*args), tcls(*args)
    assert np.array_equal(t.robin_alpha, j.robin_alpha)
    assert np.array_equal(t.dof_coords(P), j.dof_coords(P))
    assert t.is_graded == j.is_graded and t.has_robin == j.has_robin


@pytest.mark.parametrize("name", [
    "resolve_kappa", "resolve_kappa_split", "resolve_kappa_axes",
    "resolve_sigma", "shifted_mass_np", "general_shift_np", "lifted_rhs",
    "robin_mass_np", "robin_rhs_np", "stiffness_diagonal_np",
    "assemble_stiffness", "ops_shift_scalar"])
def test_coefficient_helpers_positional(name):
    """The ported resolvers and boundary helpers keep JAX's parameter
    lists, and the same positionals give the same arrays."""
    import inspect

    from pmg_dolfinx_tpu.fem import assembly as ja
    from pmg_dolfinx_tpu_torch.fem import assembly as ta

    tf, jf = getattr(ta, name), getattr(ja, name)
    assert (list(inspect.signature(tf).parameters)
            == list(inspect.signature(jf).parameters))
    faces = ((True, True), (False, False), (True, True))
    mk = lambda cls: cls(NC, (1.0, 1.0, 1.0), faces,
                         ((0.0, 0.0), (2.0, 1.0), (0.0, 0.0)))
    jmesh, tmesh = mk(JBox), mk(TBox)
    field = lambda x: 1.0 + x[0]
    calls = {
        "resolve_kappa": (np.linspace(1.0, 2.0, 27),),
        "resolve_kappa_split": ((1.0, 2.0, 3.0),),
        "resolve_kappa_axes": (np.diag([1.0, 2.0, 3.0]), None),
        "resolve_sigma": None,
        "shifted_mass_np": (P, field, False),
        "general_shift_np": (P, 0.5, field),
        "lifted_rhs": (P, 2.0, field, lambda x: x[1]),
        "robin_mass_np": (P, False),
        "robin_rhs_np": (P, {(1, 0): field, (1, 1): 0.5}),
        "stiffness_diagonal_np": (P, (1.0, 2.0, 3.0)),
        "assemble_stiffness": (P, 2.0, False),
        "ops_shift_scalar": (0.5, False),
    }
    if calls[name] is None:
        assert tf(field) == jf(field) and tf(0.5) == jf(0.5)
        return
    got, want = tf(tmesh, *calls[name]), jf(jmesh, *calls[name])
    if name == "assemble_stiffness":
        got, want = got.toarray(), want.toarray()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        if g is None or np.ndim(g) == 0:
            assert g == w
        else:
            assert np.abs(np.asarray(g) - np.asarray(w)).max() <= (
                1e-13 * max(1.0, np.abs(np.asarray(w)).max()))
