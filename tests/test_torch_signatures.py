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
    # 'high' at the same position: the einsum path, exact in both on the
    # CPU (XLA's CPU backend; the port's rule for the XLA paths)
    jop = JK(JBox(NC), P, 2.0, jnp.float64, "high", SIGMA)
    top = TK(TBox(NC), P, 2.0, torch.float64, "high", SIGMA, device="cpu")
    assert _rel(top(torch.from_numpy(x)), jop(jnp.asarray(x))) <= 1e-12


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
    """The coarse solvers the port once refused, by the ROADMAP item that
    ported them ('direct' and 'hmg': item 7a; 'amg': item 8, which the
    refusal named): each binds JAX's positional ``(mesh, degrees, kappa,
    dtype, smoother_iters, coarse, coarse_cfg)`` and cycles as JAX's
    (f64, 1e-12), and no refusal names the item any more."""
    import inspect

    from pmg_dolfinx_tpu.solvers.pmg import PMGHierarchy as JH
    from pmg_dolfinx_tpu_torch.solvers import pmg as tpmg
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    args = ((1, 2), 2.0)
    rest = (2, coarse, None)
    if item is not None:
        assert item not in inspect.getsource(tpmg)
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


def _positional(fn):
    import inspect

    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind != p.KEYWORD_ONLY]


@pytest.mark.parametrize("mod,name", [
    ("fem.unstructured", "UnstructuredHexMesh"),
    ("fem.unstructured", "l_shaped_hex_mesh"),
    ("fem.unstructured", "load_hex_mesh_npz"),
    ("fem.unstructured", "read_gmsh_hex"),
    ("fem.unstructured", "gmsh_corner_permutation"),
    ("ops.unstructured", "DSSMeta"),
    ("ops.unstructured", "dss_meta"),
    ("ops.unstructured", "dss_device_tables"),
    ("ops.unstructured", "dss_gather"),
    ("ops.unstructured", "dss_scatter"),
    ("ops.unstructured", "apply_cells"),
    ("ops.unstructured", "dss_laplacian_apply"),
    ("ops.unstructured", "dss_prolongate"),
    ("ops.unstructured", "dss_restrict"),
    ("ops.csr", "MatrixOperator"),
    ("ops.csr", "InterpolationMatrixOperator"),
    ("solvers.amg", "aggregate"),
    ("solvers.amg", "build_amg"),
    ("solvers.amg", "amg_cycle"),
    ("solvers.schwarz_dss", "build_schwarz_dss"),
    ("solvers.schwarz_dss", "dss_schwarz_apply"),
    ("solvers.pmg", "csr_cycle_ops"),
    ("solvers.pmg", "dss_cycle_ops"),
])
def test_unstructured_family_signatures(mod, name):
    """The unstructured family keeps JAX's public names and positional
    orders; the port adds only the keyword-only ``device``."""
    import importlib

    jf = getattr(importlib.import_module(f"pmg_dolfinx_tpu.{mod}"), name)
    tf = getattr(importlib.import_module(f"pmg_dolfinx_tpu_torch.{mod}"),
                 name)
    assert _positional(tf) == _positional(jf)


def test_unstructured_positional_calls_match_jax():
    """The positional calls of JAX's unstructured tests bind the same
    arguments in the port: ``UnstructuredHexMesh(nodes, cells, dirichlet,
    tol, tagged_faces)``, ``build_amg(A0, bc_mask, dtype, theta,
    dense_cap)``, ``dss_laplacian_apply(x, lv, meta, precision, sigma,
    apply_bc)`` (f64, 1e-12)."""
    from pmg_dolfinx_tpu.fem import unstructured as ju
    from pmg_dolfinx_tpu.ops import unstructured as jus
    from pmg_dolfinx_tpu.solvers import amg as jamg
    from pmg_dolfinx_tpu_torch.fem import unstructured as tu
    from pmg_dolfinx_tpu_torch.fem.assembly import (
        assemble_stiffness,
        geometry_factors_np,
    )
    from pmg_dolfinx_tpu_torch.fem.gll import derivative_matrix
    from pmg_dolfinx_tpu_torch.ops import unstructured as tus
    from pmg_dolfinx_tpu_torch.solvers import amg as tamg

    base = ju.l_shaped_hex_mesh(2)
    sel = lambda x: x[2] < 0.5
    args = (base.geometry_x, base.geometry_dofmap, sel, 1e-7, None)
    mt, mj = tu.UnstructuredHexMesh(*args), ju.UnstructuredHexMesh(*args)
    assert mt.tol == mj.tol == 1e-7
    assert np.array_equal(mt.boundary_dof_marker(2),
                          mj.boundary_dof_marker(2))
    A = assemble_stiffness(mt, 1, kappa=2.0).tocsr()
    bc = mt.boundary_dof_marker(1)
    dt, metat = tamg.build_amg(A, bc, torch.float64, 0.0, 3, device="cpu")
    dj, metaj = jamg.build_amg(A, bc, jnp.float64, 0.0, 3)
    assert metat == metaj
    assert np.abs(dt["chol"].numpy() - np.asarray(dj["chol"])).max() <= 1e-12
    P = 2
    lt, lj = mt.dss_layout(P), mj.dss_layout(P)
    G = geometry_factors_np(mt, P)[0]
    D = derivative_matrix(P)
    bcm = mt.boundary_dof_marker(P)
    lvt = dict(tus.dss_device_tables(lt, device="cpu"), G=torch.tensor(G),
               coeff=torch.ones(mt.ncells, dtype=torch.float64),
               D=torch.tensor(D), bc_marker=torch.tensor(bcm),
               m3=torch.ones(mt.num_dofs(P), dtype=torch.float64))
    lvj = dict(jus.dss_device_tables(lj), G=jnp.asarray(G),
               coeff=jnp.ones(mt.ncells), D=jnp.asarray(D),
               bc_marker=jnp.asarray(bcm), m3=jnp.ones(mt.num_dofs(P)))
    x = np.random.default_rng(2).standard_normal(mt.num_dofs(P))
    yt = tus.dss_laplacian_apply(torch.tensor(x), lvt, tus.dss_meta(lt),
                                 "highest", 0.5, False)
    yj = jus.dss_laplacian_apply(jnp.asarray(x), lvj, jus.dss_meta(lj),
                                 "highest", 0.5, False)
    assert _rel(yt, yj) <= 1e-12


def test_vcycle_and_fmg_default_to_the_dofmap_ops():
    """``v_cycle(data, b, u, levels=...)`` and ``fmg_initial_guess(data, b,
    levels=...)`` without ``ops`` run the dofmap backend's cycle ops, as
    the JAX package's ``ops=None`` does (the port once required ``ops``);
    f64 to 1e-12 against JAX on a ``dofmap`` hierarchy."""
    from pmg_dolfinx_tpu.solvers import pmg as jpmg
    from pmg_dolfinx_tpu_torch.solvers import pmg as tpmg

    kw = dict(degrees=(1, 2, 3), kappa=2.0, coarse="cg", operator="dofmap")
    th = tpmg.PMGHierarchy(TBox(NC), device="cpu", **kw)
    jh = jpmg.PMGHierarchy(JBox(NC), **kw)
    b = np.random.default_rng(4).standard_normal(th.levels[-1].ndofs)
    b[TBox(NC).boundary_dof_marker(3)] = 0.0
    u = 0.1 * np.random.default_rng(5).standard_normal(b.size)
    args = dict(levels=th.levels, coarse="cg", coarse_cfg=th.coarse_cfg)
    jargs = dict(levels=jh.levels, coarse="cg", coarse_cfg=jh.coarse_cfg)
    yt = tpmg.v_cycle(th.data, torch.tensor(b), torch.tensor(u), **args)
    yj = jpmg.v_cycle(jh.data, jnp.asarray(b), jnp.asarray(u), **jargs)
    assert _rel(yt, yj) <= 1e-12
    gt = tpmg.fmg_initial_guess(th.data, torch.tensor(b), **args)
    gj = jpmg.fmg_initial_guess(jh.data, jnp.asarray(b), **jargs)
    assert _rel(gt, gj) <= 1e-12


@pytest.mark.parametrize("mod,name", [
    ("models.semilinear", "Nonlinearity"),
    ("models.semilinear", "cubic"),
    ("models.semilinear", "bratu"),
    ("models.semilinear", "f_rhs_semilinear"),
    ("solvers.bicgstab", "bicgstab_solve"),
    ("solvers.newton", "newton_solve"),
    ("solvers.convdiff", "sd_stabilized_kappa"),
    ("solvers.convdiff", "convdiff_solve"),
    ("solvers.shardwrap", "is_sharded"),
    ("solvers.shardwrap", "layout_converters"),
    ("solvers.shardwrap", "shards_of"),
    ("solvers.shardwrap", "axis_exchanges"),
    ("ops.kron", "axis_advection"),
    ("ops.kron", "kron_advection_terms"),
    ("ops.kron", "kron_convdiff_apply"),
    ("solvers.transient", "semilinear_packed_evolve"),
    ("solvers.transient", "semilinear_fdm_evolve"),
    ("solvers.transient", "semilinear_newton_evolve"),
    ("solvers.transient", "convdiff_fdm_evolve"),
    ("solvers.transient", "convdiff_advective_dt"),
    ("solvers.eig", "lowest_eigenpairs"),
    ("solvers.pmg", "v_cycle"),
    ("solvers.pmg", "fmg_initial_guess"),
])
def test_transient_and_extra_families_signatures(mod, name):
    """The transient and extra model families keep JAX's public names and
    positional orders; the port adds only keyword-only parameters
    (``device``, and ``dtype`` on `lowest_eigenpairs`)."""
    import importlib

    jf = getattr(importlib.import_module(f"pmg_dolfinx_tpu.{mod}"), name)
    tf = getattr(importlib.import_module(f"pmg_dolfinx_tpu_torch.{mod}"),
                 name)
    assert _positional(tf) == _positional(jf)


def test_lobpcg_matches_jax_signature():
    """`solvers.lobpcg.lobpcg_standard` keeps the parameters of
    `jax.experimental.sparse.linalg.lobpcg_standard`."""
    from jax.experimental.sparse.linalg import lobpcg_standard as jl
    from pmg_dolfinx_tpu_torch.solvers.lobpcg import lobpcg_standard as tl

    assert _positional(tl) == _positional(jl) == ["A", "X", "m", "tol"]


@pytest.mark.parametrize("mod,name", [
    ("parallel.dist", "DistPMG"),
    ("parallel.dist", "dist_cycle_ops"),
    ("parallel.dist", "dist_kron_cycle_ops"),
    ("parallel.dist", "dist_kron_blocked_cycle_ops"),
    ("parallel.dist", "dist_lattice_cycle_ops"),
    ("parallel.dist", "_exchange_partials"),
    ("parallel.dist", "_shifted_diag_np"),
    ("parallel.partition", "SlabPartition"),
    ("parallel.partition", "duplicate_planes"),
    ("solvers.shardwrap", "is_sharded"),
    ("solvers.shardwrap", "layout_converters"),
    ("solvers.shardwrap", "shards_of"),
    ("solvers.shardwrap", "axis_exchanges"),
])
def test_slab_layer_signatures(mod, name):
    """The 1D slab layer keeps JAX's public names and positional orders;
    the port adds only keyword-only parameters (``device`` on `DistPMG`,
    ``launch`` on the kron_blocked factory, ``inplace`` on
    `_exchange_partials`)."""
    import importlib

    jf = getattr(importlib.import_module(f"pmg_dolfinx_tpu.{mod}"), name)
    tf = getattr(importlib.import_module(f"pmg_dolfinx_tpu_torch.{mod}"),
                 name)
    assert _positional(tf) == _positional(jf)


@pytest.mark.parametrize("method", [
    "local_planes", "axis_starts", "local_shape", "local_ndofs",
    "local_dofmap", "to_dist", "from_dist", "ownership_weights",
    "cell_slab_slices"])
def test_slab_partition_method_signatures(method):
    """`SlabPartition`'s methods bind JAX's positional arguments."""
    from pmg_dolfinx_tpu.parallel.partition import SlabPartition as JS
    from pmg_dolfinx_tpu_torch.parallel.partition import SlabPartition as TS

    assert _positional(getattr(TS, method)) == _positional(getattr(JS,
                                                                   method))


@pytest.mark.parametrize("method", [
    "to_dist", "from_dist", "apply", "operator", "residual_norm", "solve",
    "solve_pcg", "solve_refined", "_fmg_guess_dist"])
def test_dist_pmg_method_signatures(method):
    """`DistPMG`'s public methods bind JAX's positional arguments."""
    from pmg_dolfinx_tpu.parallel.dist import DistPMG as JD
    from pmg_dolfinx_tpu_torch.parallel.dist import DistPMG as TD

    assert _positional(getattr(TD, method)) == _positional(getattr(JD,
                                                                   method))


@pytest.mark.parametrize("mod,name", [
    ("parallel.fdm_dist", "DistFDM"),
    ("parallel.fdm_dist", "fdm_solve_dist"),
    ("parallel.fdm_dist", "make_fdm_dist"),
    ("parallel.fdm_dist", "make_fdm_apply_dist"),
    ("parallel.fdm_dist", "dist_layout"),
    ("parallel.fdm_dist", "_embed_boundary"),
    ("parallel.fdm_dist", "_dedup"),
    ("parallel.fdm_dist", "_redup"),
    ("parallel.fdm_dist", "_transform_sharded"),
    ("parallel.fdm_dist", "_axis_transform"),
    ("parallel.dist", "build_hmg_dist"),
    ("parallel.grid2d", "build_hmg_grid"),
    ("parallel.grid2d", "build_hmg_grid_general"),
    ("parallel.grid2d", "_hmg_grid_scaffold"),
    ("parallel.transient_dist", "_dist_bundle"),
    ("parallel.transient_dist", "heat_dist_evolve"),
    ("parallel.transient_dist", "wave_leapfrog_dist_evolve"),
    ("parallel.transient_dist", "semilinear_dist_evolve"),
    ("parallel.transient_dist", "convdiff_dist_evolve"),
    ("parallel.transient_dist", "wave_newmark_dist_evolve"),
])
def test_gather_free_family_signatures(mod, name):
    """The gather-free coarse family and the sharded time loops keep JAX's
    public names and positional orders; the port adds only the
    keyword-only ``device``."""
    import importlib

    jf = getattr(importlib.import_module(f"pmg_dolfinx_tpu.{mod}"), name)
    tf = getattr(importlib.import_module(f"pmg_dolfinx_tpu_torch.{mod}"),
                 name)
    assert _positional(tf) == _positional(jf)


@pytest.mark.parametrize("method", ["to_dist", "from_dist", "solve"])
def test_dist_fdm_method_signatures(method):
    """`DistFDM`'s methods bind JAX's positional arguments."""
    from pmg_dolfinx_tpu.parallel.fdm_dist import DistFDM as JF
    from pmg_dolfinx_tpu_torch.parallel.fdm_dist import DistFDM as TF

    assert _positional(getattr(TF, method)) == _positional(getattr(JF,
                                                                   method))


def test_stacked_grid_all_to_all_keeps_jax_argument_order():
    """`StackedGrid.all_to_all(x, axis, split_axis, concat_axis)`: JAX's
    ``all_to_all(x, axis_name, split_axis, concat_axis)``."""
    from pmg_dolfinx_tpu_torch.parallel.grid2d import StackedGrid

    assert _positional(StackedGrid.all_to_all) == [
        "self", "st", "axis", "split_axis", "concat_axis"]


@pytest.mark.parametrize("mod,name", [
    ("parallel.dss_dist", "DSSDist"),
    ("parallel.dss_dist", "DSSPartition"),
    ("parallel.dss_dist", "_entity_partition"),
    ("parallel.dss_dist", "_pad_stack"),
    ("parallel.dss_dist", "dss_exchange"),
    ("parallel.dss_dist", "dss_dist_cycle_ops"),
])
def test_dss_dist_signatures(mod, name):
    """The distributed unstructured path keeps JAX's public names and
    positional orders; the port adds only keyword-only parameters
    (``device`` on `DSSDist`, ``grid`` on the exchange and the cycle
    ops)."""
    import importlib

    jf = getattr(importlib.import_module(f"pmg_dolfinx_tpu.{mod}"), name)
    tf = getattr(importlib.import_module(f"pmg_dolfinx_tpu_torch.{mod}"),
                 name)
    assert _positional(tf) == _positional(jf)


@pytest.mark.parametrize("cls,method", [
    ("DSSDist", "to_dist"), ("DSSDist", "from_dist"), ("DSSDist", "solve"),
    ("DSSDist", "solve_pcg"), ("DSSPartition", "tables"),
    ("DSSPartition", "to_dist"), ("DSSPartition", "from_dist")])
def test_dss_dist_method_signatures(cls, method):
    """`DSSDist`'s and `DSSPartition`'s methods bind JAX's positional
    arguments."""
    import pmg_dolfinx_tpu.parallel.dss_dist as jd
    import pmg_dolfinx_tpu_torch.parallel.dss_dist as td

    assert _positional(getattr(getattr(td, cls), method)) == _positional(
        getattr(getattr(jd, cls), method))


@pytest.mark.parametrize("cls,args", [
    ("DSSDist", ("mesh", 8, (1, 3, 6), 2.0, "dtype", 3, "direct", None,
                 None, 25, "highest", 0.8, "schwarz")),
    ("DSSPartition", ("mesh", 8)),
])
def test_dss_dist_positional_calls_match_jax(cls, args):
    """JAX's positional list (``mesh, n_devices, degrees, kappa, dtype,
    smoother_iters, coarse, coarse_cfg, devices, calibration_iters,
    precision, sigma, smoother``) binds every value to the parameter of
    the same name in the port."""
    import inspect

    import pmg_dolfinx_tpu.parallel.dss_dist as jd
    import pmg_dolfinx_tpu_torch.parallel.dss_dist as td

    bind = lambda c: dict(inspect.signature(getattr(c, cls)).bind(
        *args, **({"device": "cpu"} if c is td and cls == "DSSDist"
                  else {})).arguments)
    got = bind(td)
    got.pop("device", None)
    assert got == bind(jd)


@pytest.mark.parametrize("mod,name", [
    ("utils.logging", "init_logging"),
    ("utils.logging", "get_logger"),
    ("utils.checkpoint", "save_state"),
    ("utils.checkpoint", "load_state"),
    ("utils.io", "write_vtk"),
    ("utils.io", "write_npz"),
    ("utils.measure", "measure"),
    ("utils.timers", "reset_timings"),
    ("utils.timers", "list_timings"),
])
def test_item_11_utils_signatures(mod, name):
    """The rank-aware and rank-free utilities of item 11 keep JAX's names
    and positional orders."""
    import importlib

    jf = getattr(importlib.import_module(f"pmg_dolfinx_tpu.{mod}"), name)
    tf = getattr(importlib.import_module(f"pmg_dolfinx_tpu_torch.{mod}"),
                 name)
    assert _positional(tf) == _positional(jf)


@pytest.mark.parametrize("name", ["initialize", "put_global",
                                  "fetch_global", "process_index",
                                  "process_count"])
def test_multihost_names(name):
    """`parallel.multihost` has JAX's entry points (``initialize``,
    ``put_global``, ``fetch_global``) and the rank queries logging reads;
    ``initialize`` takes torch.distributed's arguments and a keyword-only
    ``device``."""
    import inspect

    import pmg_dolfinx_tpu_torch.parallel.multihost as tm

    fn = getattr(tm, name)
    assert callable(fn)
    if name == "initialize":
        params = inspect.signature(fn).parameters
        assert _positional(fn) == ["init_method", "world_size", "rank",
                                   "backend"]
        assert params["device"].kind is inspect.Parameter.KEYWORD_ONLY


@pytest.mark.parametrize("mod,name", [
    ("parallel.dist", "DistPMG"),
    ("parallel.grid2d", "GridPMG"),
    ("parallel.fdm_dist", "DistFDM"),
    ("parallel.fdm_dist", "dist_layout"),
    ("parallel.dss_dist", "DSSDist"),
    ("parallel.transient_dist", "heat_dist_evolve"),
    ("parallel.transient_dist", "wave_leapfrog_dist_evolve"),
    ("parallel.transient_dist", "semilinear_dist_evolve"),
    ("parallel.transient_dist", "convdiff_dist_evolve"),
    ("parallel.transient_dist", "wave_newmark_dist_evolve"),
])
def test_sharded_solvers_take_devices(mod, name):
    """Every sharded solver takes ``devices=`` at JAX's position, default
    None (the ranks' shards; tests/test_torch_multihost.py runs them)."""
    import importlib
    import inspect

    jf = getattr(importlib.import_module(f"pmg_dolfinx_tpu.{mod}"), name)
    tf = getattr(importlib.import_module(f"pmg_dolfinx_tpu_torch.{mod}"),
                 name)
    assert "devices" in _positional(tf)
    assert _positional(tf).index("devices") == _positional(jf).index(
        "devices")
    assert inspect.signature(tf).parameters["devices"].default is None
