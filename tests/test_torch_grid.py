"""The device-grid solve of the port (`parallel.grid2d`, the grid half of
`ops.kron_blocked`) against the JAX package on 8 virtual CPU devices.

- `GridPartition` (``to_dist`` / ``from_dist`` / ``ownership_weights``)
  and `grid_symmetrized_mats` (with and without face masks) equal JAX's
  for shards (2, 2), (2, 2, 2) and (1, 2, 4), to 1e-15; so do the setup
  helpers (`duplicate_planes`, `_shifted_diag_np`, `local_axis_K`,
  `stacked_local_K`), the distributed dots and norms, and
  `cg_solve(..., precond=)`;
- the stacked `_exchange_axis` / `_plane_exchange_pair` and the coarse
  gather / slice equal JAX's ``shard_map`` collectives, bit for bit;
- `plain_t23_grid` / `plain_t23_grid_m` (kernels #8 / #9) match JAX's
  Pallas kernels in interpret mode (f32, <= 1e-5 relative max-norm) and
  the JAX twin ``_emu_t23_grid`` in f64 (<= 1e-12), for the correction
  cases need_y / need_z in {(T, T), (T, F), (F, T)}, sigma in {0, 0.5},
  residual on and off, and #8 on random banded operands with a marker
  that stresses its y-march (marked rows at chunk borders, marked columns
  in a warp's z halo) at awkward shapes; `edge_partials` (stacked and per
  shard) equals JAX's;
- `GridPMG(operator="kron")` in f64 reproduces JAX's `GridPMG` for
  (2, 2, 2) and (1, 2, 4) with the ``cg`` and ``fdm`` coarse solves
  (trajectory 1e-10 relative, solution 1e-10, FCG count equal) and the
  port's single-device `PMGHierarchy`;
- `GridPMG(operator="kron_blocked")` in f32 for (2, 2, 2), (1, 2, 4) and
  (2, 4, 1) with ``cg``, and sigma=37 with ``fdm``: trajectories within
  5e-4 of JAX's on cycles above 5e-3 (JAX's own test tolerance),
  solutions within 1e-5; on JAX's state (`load_state`) 4 cycles within
  1e-5 of JAX's relative residuals;
- the grid apply against the scipy ``assemble_stiffness`` oracle
  (<= 1e-5, f32) and `examples/scaling_torch.py --grid` against
  `examples/scaling.py --grid` (f64, layout-invariant residuals).

Kernels #8 / #9 against their plain versions, on a GPU only, are in
`tests/test_torch_grid_cuda.py` (no JAX: the card has none).
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from jax.sharding import PartitionSpec as PS  # noqa: E402

from pmg_dolfinx_tpu.fem.assembly import assemble_rhs  # noqa: E402
from pmg_dolfinx_tpu.fem.mesh import BoxMesh as JBox  # noqa: E402
from pmg_dolfinx_tpu.models.poisson import f_rhs  # noqa: E402
from pmg_dolfinx_tpu.ops import pallas_kron_blocked as jkb  # noqa: E402
from pmg_dolfinx_tpu.parallel import grid2d as jg  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh as TBox  # noqa: E402
from pmg_dolfinx_tpu_torch.ops import kron_blocked as tkb  # noqa: E402
from pmg_dolfinx_tpu_torch.parallel import grid2d as tg  # noqa: E402
from pmg_dolfinx_tpu_torch.utils.convert import (  # noqa: E402
    grid_data_from_numpy,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
NC = (4, 4, 4)
KAPPA = 2.0
LAYOUTS = {(2, 2): (4, 4, 2), (2, 2, 2): (4, 4, 4), (1, 2, 4): (2, 4, 8)}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _rel_max(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _grid_inputs(nc, shards, P, masks):
    """JAX-built local stiffness, duplicated masses and face masks."""
    from pmg_dolfinx_tpu.ops.kron import axis_stiffness_mass, local_axis_K
    from pmg_dolfinx_tpu.parallel.partition import duplicate_planes

    mesh = JBox(nc)
    part = jg.GridPartition(mesh, shards)
    npls = part.local_shape(P)
    Ks, ms = [], []
    for a in range(3):
        K, _ = local_axis_K(mesh, a, part.cells_per_shard[a], P, KAPPA,
                            part.shards[a])
        _, mg = axis_stiffness_mass(nc[a], P, mesh.h_cells[a])
        Ks.append(K)
        ms.append(duplicate_planes(mg, npls[a], part.shards[a]))
    fm = None
    if masks:
        fm = tuple(duplicate_planes(m, npls[a], part.shards[a])
                   for a, m in enumerate(jkb.axis_interior_masks(mesh, P)))
    return part, Ks, ms, fm


@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("shards", list(LAYOUTS))
def test_partition_and_grid_mats_match_jax(shards, masks):
    nc, P = LAYOUTS[shards], 2
    jpart, Ks, ms, fm = _grid_inputs(nc, shards, P, masks)
    tpart = tg.GridPartition(TBox(nc), shards)
    assert tpart.shards == jpart.shards
    u = np.random.default_rng(0).standard_normal(JBox(nc).num_dofs(P))
    ud = tpart.to_dist(P, u)
    assert np.array_equal(ud, jpart.to_dist(P, u))
    assert np.array_equal(tpart.from_dist(P, ud), jpart.from_dist(P, ud))
    assert np.array_equal(tpart.ownership_weights(P),
                          jpart.ownership_weights(P))
    st = tg.stack_shards(torch.from_numpy(ud), tpart.shards)
    assert st.shape == tpart.shards + tpart.local_shape(P)
    assert np.array_equal(_np(tg.unstack_shards(st)), ud)
    m_j, axes_j = jkb.grid_symmetrized_mats(Ks, ms, tpart.shards,
                                            dtype=jnp.float64,
                                            face_masks_dup=fm)
    m_t, axes_t = tkb.grid_symmetrized_mats(Ks, ms, tpart.shards,
                                            torch.float64, fm, band=P,
                                            device="cpu")
    assert axes_t == axes_j and set(m_t) - {"band"} == set(m_j)
    for k, v in m_j.items():
        assert m_t[k].shape == v.shape, k
        assert _rel_max(m_t[k], v) <= 1e-15, k


@pytest.mark.parametrize("sigma", [0.0, 0.5])
def test_grid_setup_helpers_match_jax(sigma):
    """`duplicate_planes`, `_shifted_diag_np`, `local_axis_K` (sharded and
    not) and `stacked_local_K` against JAX's, f64."""
    from pmg_dolfinx_tpu.ops import kron as jk
    from pmg_dolfinx_tpu.parallel import dist as jd
    from pmg_dolfinx_tpu.parallel import partition as jp
    from pmg_dolfinx_tpu_torch.ops import kron as tk
    from pmg_dolfinx_tpu_torch.parallel import dist as td
    from pmg_dolfinx_tpu_torch.parallel import partition as tp

    nc, P = (4, 2, 6), 3
    mg = np.random.default_rng(1).standard_normal(nc[0] * P + 1)
    assert np.array_equal(tp.duplicate_planes(mg, 2 * P + 1, 2),
                          jp.duplicate_planes(mg, 2 * P + 1, 2))
    d_t = td._shifted_diag_np(TBox(nc), P, np.full(np.prod(nc), KAPPA),
                              sigma)
    d_j = jd._shifted_diag_np(JBox(nc), P, np.full(np.prod(nc), KAPPA),
                              sigma)
    assert np.abs(d_t - d_j).max() <= 1e-13 * np.abs(d_j).max()
    for a, S in ((0, 1), (0, 2), (2, 3)):
        K_t, st_t = tk.local_axis_K(TBox(nc), a, nc[a] // S, P, KAPPA, S)
        K_j, st_j = jk.local_axis_K(JBox(nc), a, nc[a] // S, P, KAPPA, S)
        assert st_t == st_j
        assert np.abs(K_t - K_j).max() <= 1e-15 * np.abs(K_j).max()
    assert np.array_equal(tk.stacked_local_K(K_t, 1.5, (0.25, 0.5), 3),
                          jk.stacked_local_K(K_j, 1.5, (0.25, 0.5), 3))


def test_dist_blas_and_cg_precond_match_jax():
    """`dist_inner_product` / `dist_norm` on the stacked layout against
    JAX's psum / pmax under ``shard_map`` on a (2, 2, 2) device mesh; and
    `cg_solve(..., precond=)` against JAX's on an SPD system (f64)."""
    from pmg_dolfinx_tpu.ops import blas as jb
    from pmg_dolfinx_tpu.solvers.cg import cg_solve as jcg
    from pmg_dolfinx_tpu_torch.ops import blas as tb
    from pmg_dolfinx_tpu_torch.solvers.cg import cg_solve as tcg

    shards, P = (2, 2, 2), 2
    part = tg.GridPartition(TBox(NC), shards)
    rng = np.random.default_rng(4)
    u, v = (part.to_dist(P, rng.standard_normal(TBox(NC).num_dofs(P)))
            for _ in range(2))
    w = part.ownership_weights(P)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(shards), ("x", "y", "z"))
    spec = PS("x", "y", "z")
    axes = ("x", "y", "z")

    def reduce_j(fn):
        return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(spec,) * 3,
                                     out_specs=PS()))(jnp.asarray(u),
                                                      jnp.asarray(v),
                                                      jnp.asarray(w))

    st = lambda a: tg.stack_shards(torch.from_numpy(a), shards)
    dot_j = reduce_j(lambda a, b, c: jb.dist_inner_product(a, b, c, axes))
    assert abs(float(tb.dist_inner_product(st(u), st(v), st(w), axes))
               - float(dot_j)) <= 1e-12 * abs(float(dot_j))
    for kind in ("l2", "linf"):
        n_j = reduce_j(lambda a, b, c: jb.dist_norm(a, c, axes, kind))
        assert abs(float(tb.dist_norm(st(u), st(w), axes, kind))
                   - float(n_j)) <= 1e-12 * float(n_j)
    with pytest.raises(ValueError):
        tb.dist_norm(st(u), st(w), axes, "l1")

    n = 30
    B = rng.standard_normal((n, n))
    A = B @ B.T + n * np.eye(n)
    M = np.linalg.inv(np.diag(np.diag(A)) + 0.1 * np.tril(A, -1)
                      @ np.diag(1.0 / np.diag(A)) @ np.triu(A, 1))
    M = 0.5 * (M + M.T)
    b = rng.standard_normal(n)
    x_t, i_t = tcg(lambda x: torch.from_numpy(A) @ x, torch.from_numpy(b),
                   torch.zeros(n, dtype=torch.float64),
                   torch.ones(n, dtype=torch.float64), rtol=1e-10,
                   maxiter=60, precond=lambda r: torch.from_numpy(M) @ r)
    x_j, i_j = jcg(lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
                   jnp.zeros(n), jnp.ones(n), rtol=1e-10, maxiter=60,
                   precond=lambda r: jnp.asarray(M) @ r)
    assert int(i_t["niter"]) == int(i_j["niter"])
    assert np.abs(_np(x_t) - np.asarray(x_j)).max() <= 1e-10
    assert np.abs(A @ _np(x_t) - b).max() <= 1e-8 * np.abs(b).max()


def _shard_map(fn, mesh, n_out=1):
    spec = PS("x", "y", "z")
    out = spec if n_out == 1 else (spec,) * n_out
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=spec,
                                 out_specs=out))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_exchanges_match_jax_shard_map(axis):
    """`_exchange_axis` and `_plane_exchange_pair` on the stacked layout
    against JAX's ppermutes on a (2, 2, 2) device mesh, bit for bit; the
    coarse gather / slice against JAX's all_gather / dynamic_slice."""
    shards, local = (2, 2, 2), (5, 4, 3)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(shards), ("x", "y", "z"))
    dup = np.random.default_rng(axis).standard_normal(
        tuple(s * n for s, n in zip(shards, local)))
    grid = tg.StackedGrid(shards)
    st = tg.stack_shards(torch.from_numpy(dup), shards)

    y_j = _shard_map(lambda v: jg._exchange_axis(v, 2, "xyz"[axis], axis),
                     mesh)(jnp.asarray(dup))
    y_t = tg._exchange_axis(st, grid, axis)
    assert np.array_equal(_np(tg.unstack_shards(y_t)), np.asarray(y_j))

    def pair(v):
        ex = jg._plane_exchange_pair("xyz"[axis], 2)
        first = jax.lax.index_in_dim(v, 0, axis, keepdims=True)
        last = jax.lax.index_in_dim(v, v.shape[axis] - 1, axis,
                                    keepdims=True)
        return ex(first, last)

    a_j, b_j = _shard_map(pair, mesh, 2)(jnp.asarray(dup))
    ex = tg._plane_exchange_pair(grid, axis)
    a_t, b_t = ex(st.narrow(3 + axis, 0, 1),
                  st.narrow(3 + axis, local[axis] - 1, 1))
    assert np.array_equal(_np(tg.unstack_shards(a_t)), np.asarray(a_j))
    assert np.array_equal(_np(tg.unstack_shards(b_t)), np.asarray(b_j))

    # coarse hooks: the gathered global lattice and the slice back
    jmesh = JBox((4, 6, 4))
    P0 = 1
    jpart = jg.GridPartition(jmesh, shards)
    gather_j, slice_j = jg.grid_coarse_hooks(jpart, P0)
    u = np.random.default_rng(9).standard_normal(jmesh.num_dofs(P0))
    ud = jpart.to_dist(P0, u)
    g_j = _shard_map(lambda v: slice_j(gather_j(v) * 3.0), mesh)(
        jnp.asarray(ud))
    gather_t, slice_t = tg.grid_coarse_hooks(
        tg.GridPartition(TBox((4, 6, 4)), shards), P0)
    stu = tg.stack_shards(torch.from_numpy(ud), shards)
    glob = gather_t(stu)
    assert np.array_equal(_np(glob).reshape(-1), u)
    assert np.array_equal(_np(tg.unstack_shards(slice_t(glob * 3.0))),
                          np.asarray(g_j))


NEEDS = [(True, True), (True, False), (False, True)]


def _kernel_inputs(dtype, masks, seed):
    """One shard's lattice, marker, local mats, kernel-1 output and random
    corrections on a mixed-Dirichlet (3, 4, 2) box at P=3."""
    from pmg_dolfinx_tpu.ops.kron import axis_stiffness_mass

    faces = ((True, False), (True, True), (False, True))
    mesh = JBox((3, 4, 2), dirichlet_faces=faces)
    P = 3
    shape = mesh.lattice_shape(P)
    rng = np.random.default_rng(seed)
    x3 = rng.standard_normal(shape).astype(dtype)
    bc3 = np.asarray(mesh.boundary_dof_marker(P)).reshape(shape)
    Ks, ms = [], []
    for nc_a, h_a in zip(mesh.nc, mesh.h_cells):
        K, m = axis_stiffness_mass(nc_a, P, h_a)
        Ks.append(KAPPA * K)
        ms.append(m)
    fm = tuple(jkb.axis_interior_masks(mesh, P)) if masks else None
    jdt = jnp.float32 if dtype == np.float32 else jnp.float64
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    m_j, _ = jkb.grid_symmetrized_mats(Ks, ms, (1, 1, 1), dtype=jdt,
                                       face_masks_dup=fm)
    m_t, _ = tkb.grid_symmetrized_mats(Ks, ms, (1, 1, 1), tdt, fm, band=P,
                                       device="cpu")
    t1 = np.asarray(jkb._emu_t1(jnp.asarray(x3), jnp.asarray(bc3), m_j))
    cy = rng.standard_normal((shape[0], 2, shape[2])).astype(dtype)
    cz = rng.standard_normal((shape[0], shape[1], 2)).astype(dtype)
    r3 = rng.standard_normal(shape).astype(dtype)
    return shape, x3, bc3, m_j, m_t, t1, cy, cz, r3


@pytest.mark.parametrize("sigma", [0.0, 0.5])
@pytest.mark.parametrize("need", NEEDS)
def test_plain_t23_grid_matches_pallas_interpret(need, sigma):
    """Kernels #8 / #9 (plain versions) against JAX's Pallas kernels in
    interpret mode, f32, apply and fused residual."""
    shape, x3, bc3, m_j, m_t, t1, cy, cz, r3 = _kernel_inputs(
        np.float32, True, 5)
    need_y, need_z = need
    cyj, czj = (jnp.asarray(cy) if need_y else None,
                jnp.asarray(cz) if need_z else None)
    cyt, czt = (torch.from_numpy(cy) if need_y else None,
                torch.from_numpy(cz) if need_z else None)
    xt, bt, t1t, rt = (torch.from_numpy(a) for a in (x3, bc3, t1, r3))
    for residual in (False, True):
        extra = [a for a in (cyj, czj) if a is not None]
        extra += [jnp.asarray(r3)] if residual else []
        call = jkb._build_t23_grid_call(shape, 8, False, True, (), sigma,
                                        need_y, need_z, residual=residual)
        y8 = call(jnp.asarray(x3), jnp.asarray(bc3), jnp.asarray(t1),
                  m_j["Kty"], m_j["KtzT"], m_j["sx2d"], m_j["sycol"],
                  m_j["s23"], *extra)
        callm = jkb._build_t23_grid_call_m(shape, 8, False, True, (), sigma,
                                           need_y, need_z, residual=residual)
        y9 = callm(jnp.asarray(x3), m_j["mx2"], jnp.asarray(t1), m_j["Kty"],
                   m_j["KtzT"], m_j["sx2d"], m_j["sycol"], m_j["s23m"],
                   m_j["myb"], m_j["mzrow"], *extra)
        r = rt if residual else None
        got8 = tkb.kron_t23_grid(xt, bt, t1t, m_t, sigma, cyt, czt, r3=r)
        got9 = tkb.kron_t23_grid_m(xt, t1t, m_t, sigma, cyt, czt, r3=r)
        assert got8.dtype == torch.float32 and got9.dtype == torch.float32
        assert _rel_max(got8, y8) <= 1e-5, ("#8", residual)
        assert _rel_max(got9, y9) <= 1e-5, ("#9", residual)


@pytest.mark.parametrize("need", NEEDS)
def test_plain_t23_grid_matches_emulation_f64(need):
    """f64: both plain versions against JAX's ``_emu_t23_grid`` (the twin
    of #8) to 1e-12; `edge_partials` against ``_edge_partials``."""
    shape, x3, bc3, m_j, m_t, t1, cy, cz, r3 = _kernel_inputs(
        np.float64, True, 6)
    need_y, need_z = need
    cyv = cy if need_y else None
    czv = cz if need_z else None
    tt = lambda a: None if a is None else torch.from_numpy(a)
    xt, bt, t1t = tt(x3), tt(bc3), tt(t1)
    for sigma in (0.0, 0.5):
        ref = jkb._emu_t23_grid(jnp.asarray(x3), jnp.asarray(bc3),
                                jnp.asarray(t1), m_j, sigma,
                                None if cyv is None else jnp.asarray(cyv),
                                None if czv is None else jnp.asarray(czv))
        assert _rel_max(tkb.plain_t23_grid(xt, bt, t1t, m_t, sigma, tt(cyv),
                                           tt(czv)), ref) <= 1e-12
        assert _rel_max(tkb.plain_t23_grid_m(xt, t1t, m_t, sigma, tt(cyv),
                                             tt(czv)), ref) <= 1e-12
    e_j = jkb._edge_partials(jnp.asarray(x3), jnp.asarray(bc3), m_j, need_y,
                             need_z)
    e_t = tkb.edge_partials(xt, bt, m_t, need_y, need_z)
    for a, b in zip(e_t, e_j):
        assert (a is None) == (b is None)
        if a is not None:
            assert _rel_max(a, b) <= 1e-12


# Kernel #8 (the y-march with the marker byte and a shard's corrections)
# at shapes that stress the march, each with the sigma its interpret-mode
# case runs (a Pallas build per shape and sigma).
MARCH_SHAPES = [((7, 3, 9), 1, 0.5), ((5, 37, 33), 3, 0.0),
                ((4, 70, 13), 6, 0.5)]


def _march_inputs(shape, band, dtype, seed):
    """One shard's operands for #8 with random symmetric banded ``K_a``:
    the port's f32/f64 arrays, a marker with whole y-rows marked at the
    march chunks' borders and columns marked around each 32-column warp
    border (the z halo), the lattice, kernel 1's output, corrections and
    a residual rhs, from ``seed``."""
    rng = np.random.default_rng(seed)
    Ks = []
    for n in shape:
        A = rng.standard_normal((n, n))
        i, j = np.indices((n, n))
        A[np.abs(i - j) > band] = 0.0
        Ks.append(A + A.T)
    ms = [rng.uniform(0.5, 2.0, n) for n in shape]
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    m = tkb.symmetrized_mats(Ks, ms, tdt, band=band, device="cpu")
    bc = rng.random(shape) < 0.03
    bc[0], bc[:, :, -1] = True, True
    for j in range(shape[1] - 2):
        bc[:, j] |= j % 16 in (0, 1, 15)
    for k in range(shape[2]):
        bc[:, :, k] |= k % 32 in (0, 1, 2, 29, 30, 31)
    x3, r3 = (rng.standard_normal(shape).astype(dtype) for _ in range(2))
    t1 = tkb.plain_t1(torch.from_numpy(x3), torch.from_numpy(bc), m)
    cy = rng.standard_normal((shape[0], 2, shape[2])).astype(dtype)
    cz = rng.standard_normal((shape[0], shape[1], 2)).astype(dtype)
    return m, bc, x3, t1.numpy(), cy, cz, r3


@pytest.mark.parametrize("shape,band,sigma", MARCH_SHAPES)
def test_plain_t23_grid_stress_markers_match_pallas_interpret(shape, band,
                                                              sigma):
    """f32: `plain_t23_grid` (kernel #8, apply and fused residual, both
    corrections) against JAX's `_kernel_t23_grid` in interpret mode on the
    same operands, on a marker that stresses the march: <= 1e-5."""
    m, bc, x3, t1, cy, cz, r3 = _march_inputs(shape, band, np.float32,
                                              7 * sum(shape))
    ops = [jnp.asarray(m[k].numpy()) for k in ("Kty", "KtzT", "sx2d",
                                               "sycol", "s23")]
    xt, bt, t1t = (torch.from_numpy(a) for a in (x3, bc, t1))
    for residual in (False, True):
        call = jkb._build_t23_grid_call(shape, 8, False, True, (), sigma,
                                        True, True, residual=residual)
        extra = [jnp.asarray(r3)] if residual else []
        want = call(jnp.asarray(x3), jnp.asarray(bc), jnp.asarray(t1), *ops,
                    jnp.asarray(cy), jnp.asarray(cz), *extra)
        got = tkb.kron_t23_grid(xt, bt, t1t, m, sigma, torch.from_numpy(cy),
                                torch.from_numpy(cz),
                                r3=torch.from_numpy(r3) if residual else None)
        assert _rel_max(got, want) <= 1e-5, residual


@pytest.mark.parametrize("shape,band", [c[:2] for c in MARCH_SHAPES])
def test_plain_t23_grid_stress_markers_match_emulation_f64(shape, band):
    """f64: `plain_t23_grid` against JAX's ``_emu_t23_grid`` on the
    stress marker, every correction case, sigma 0 and 0.5: <= 1e-12."""
    m, bc, x3, t1, cy, cz, r3 = _march_inputs(shape, band, np.float64,
                                              7 * sum(shape))
    jm = {k: jnp.asarray(v.numpy()) for k, v in m.items() if k != "band"}
    tt = lambda a: None if a is None else torch.from_numpy(a)
    for need_y, need_z in NEEDS:
        cyv, czv = (cy if need_y else None), (cz if need_z else None)
        for sg in (0.0, 0.5):
            want = jkb._emu_t23_grid(
                jnp.asarray(x3), jnp.asarray(bc), jnp.asarray(t1), jm, sg,
                None if cyv is None else jnp.asarray(cyv),
                None if czv is None else jnp.asarray(czv))
            got = tkb.plain_t23_grid(tt(x3), tt(bc), tt(t1), m, sg, tt(cyv),
                                     tt(czv))
            assert _rel_max(got, want) <= 1e-12, (need_y, need_z, sg)


def test_stacked_edge_partials_and_apply_match_per_shard():
    """On the stacked layout `edge_partials` and the grid apply equal the
    per-shard calls on `shard_mats` blocks (f64); a one-shard apply with
    no y/z exchange is `blocked_kron_apply` with ``exchange``."""
    shards, P = (2, 2, 2), 2
    jpart, Ks, ms, fm = _grid_inputs(NC, shards, P, True)
    m_t, _ = tkb.grid_symmetrized_mats(Ks, ms, shards, torch.float64, fm,
                                       band=P, device="cpu")
    part = tg.GridPartition(TBox(NC), shards)
    rng = np.random.default_rng(3)
    dup = part.to_dist(P, rng.standard_normal(TBox(NC).num_dofs(P)))
    x = tg.stack_shards(torch.from_numpy(dup), shards)
    bc = tg.stack_shards(torch.from_numpy(
        part.to_dist(P, TBox(NC).boundary_dof_marker(P)) > 0.5), shards)
    t2b, t3b = tkb.edge_partials(x, bc, m_t, True, True)
    for idx in np.ndindex(*shards):
        a, b = tkb.edge_partials(x[idx], bc[idx], tkb.shard_mats(m_t, idx),
                                 True, True)
        assert torch.allclose(t2b[idx], a, rtol=1e-13, atol=1e-13)
        assert torch.allclose(t3b[idx], b, rtol=1e-13, atol=1e-13)
    # one shard, x-exchange only: the single-device entry point with the
    # hook, equal to JAX's
    m1 = tkb.shard_mats(m_t, (0, 0, 0))
    x1, bc1 = x[0, 0, 0], bc[0, 0, 0]
    hook = lambda t: 2.0 * t
    y = tkb.blocked_kron_apply_grid(x1, bc1, m1, exchange_x=hook)
    m1_j = {k: jnp.asarray(_np(v)) for k, v in m1.items() if k != "band"}
    y_j = jkb.blocked_kron_apply(jnp.asarray(_np(x1)), jnp.asarray(_np(bc1)),
                                 m1_j, exchange=hook)
    assert _rel(y, y_j) <= 1e-12
    r = tkb.blocked_kron_apply_grid(x1, bc1, m1, exchange_x=hook, r3=x1)
    r_j = jkb.blocked_kron_residual(jnp.asarray(_np(x1)),
                                    jnp.asarray(_np(x1)),
                                    jnp.asarray(_np(bc1)), m1_j,
                                    exchange=hook)
    assert _rel(r, r_j) <= 1e-12


def test_shard_blocks_feed_the_stacked_apply():
    """`shard_blocks` holds every shard's `shard_mats`, and the stacked
    apply and residual on them equal the calls that cut the blocks
    themselves, bit for bit (f64)."""
    shards, P = (1, 2, 2), 2
    _, Ks, ms, fm = _grid_inputs(NC, shards, P, True)
    m_t, _ = tkb.grid_symmetrized_mats(Ks, ms, shards, torch.float64, fm,
                                       band=P, device="cpu")
    blocks = tkb.shard_blocks(m_t)
    assert list(blocks) == list(np.ndindex(*shards))
    for idx, m in blocks.items():
        want = tkb.shard_mats(m_t, idx)
        assert m.keys() == want.keys()
        assert all(torch.equal(m[k], want[k]) for k in m if k != "band")
    part = tg.GridPartition(TBox(NC), shards)
    rng = np.random.default_rng(4)
    x, b = (tg.stack_shards(torch.from_numpy(part.to_dist(
        P, rng.standard_normal(TBox(NC).num_dofs(P)))), shards)
        for _ in range(2))
    bc = tg.stack_shards(torch.from_numpy(
        part.to_dist(P, TBox(NC).boundary_dof_marker(P)) > 0.5), shards)
    grid = tg.StackedGrid(shards)
    kw = dict(ex_y=tg._plane_exchange_pair(grid, 1),
              ex_z=tg._plane_exchange_pair(grid, 2))
    for r3 in (None, b):
        assert torch.equal(
            tkb.blocked_kron_apply_grid(x, bc, m_t, r3=r3, blocks=blocks,
                                        **kw),
            tkb.blocked_kron_apply_grid(x, bc, m_t, r3=r3, **kw))


# -- the solve ----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_grid():
    """JAX's GridPMG solve, each configuration built once per module:
    ``get(shards, operator, coarse, sigma, cycles, state)`` returns (b, u,
    rnorms, FCG (u, n) in f64, numpy data when ``state``)."""
    cache = {}

    def get(shards, operator, coarse, sigma=0.0, cycles=5, state=False):
        key = (shards, operator, coarse, sigma, cycles, state)
        if key not in cache:
            f32 = operator == "kron_blocked"
            g = jg.GridPMG(JBox(NC), shards=shards, degrees=(1, 3),
                           kappa=KAPPA, coarse=coarse, sigma=sigma,
                           operator=operator,
                           dtype=jnp.float32 if f32 else jnp.float64)
            b = assemble_rhs(JBox(NC), 3, f_rhs(KAPPA, sigma=sigma))
            u, rn = g.solve(b, num_cycles=cycles)
            pcg = None if f32 else g.solve_pcg(b, rtol=1e-8)
            data = jax.tree.map(np.asarray, g.data) if state else None
            cache[key] = (b, np.asarray(u), np.array(rn), pcg, data)
        return cache[key]

    return get


@pytest.mark.parametrize("coarse", ["cg", "fdm"])
@pytest.mark.parametrize("shards", [(2, 2, 2), (1, 2, 4)])
def test_grid_kron_matches_jax_f64(jax_grid, shards, coarse):
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    b, u_j, rn_j, (up_j, n_j), _ = jax_grid(shards, "kron", coarse)
    grid = tg.GridPMG(TBox(NC), shards, (1, 3), KAPPA, torch.float64,
                      coarse=coarse, device="cpu")
    u, rn = grid.solve(b, num_cycles=5)
    assert u.dtype == torch.float64 and u.shape == (b.size,)
    assert np.max(np.abs(np.array(rn) - rn_j) / rn_j) <= 1e-10
    assert np.abs(_np(u) - u_j).max() <= 1e-10 * np.abs(u_j).max()
    up, n = grid.solve_pcg(b, rtol=1e-8)
    assert n == n_j
    assert np.abs(_np(up) - np.asarray(up_j)).max() <= 1e-10 * np.abs(
        np.asarray(up_j)).max()
    single = PMGHierarchy(TBox(NC), degrees=(1, 3), kappa=KAPPA,
                          coarse=coarse, operator="kron",
                          dtype=torch.float64, device="cpu")
    u_s, rn_s = single.solve(torch.from_numpy(b), num_cycles=5)
    assert np.max(np.abs(np.array(rn) - np.array(rn_s)) / rn_s) <= 1e-10
    assert torch.allclose(u, u_s, rtol=0, atol=1e-10)
    u_f, rn_f = grid.solve(b, num_cycles=2, fmg=True)
    u_fs, rn_fs = single.solve(torch.from_numpy(b), num_cycles=2, fmg=True)
    assert np.max(np.abs(np.array(rn_f) - np.array(rn_fs)) / rn_fs) <= 1e-10


def _traj_close(rn, rn_ref, r0, tol=5e-4, above=5e-3):
    rel, ref = np.array(rn) / r0, np.array(rn_ref) / r0
    keep = ref > above
    return np.max(np.abs(rel[keep] - ref[keep]) / ref[keep]) <= tol


@pytest.mark.parametrize("shards,coarse,sigma", [
    ((2, 2, 2), "cg", 0.0), ((1, 2, 4), "cg", 0.0), ((2, 4, 1), "cg", 0.0),
    ((2, 2, 2), "fdm", 37.0)])
def test_grid_kron_blocked_matches_jax_f32(jax_grid, shards, coarse, sigma):
    b, u_j, rn_j, _, _ = jax_grid(shards, "kron_blocked", coarse, sigma)
    grid = tg.GridPMG(TBox(NC), shards=shards, degrees=(1, 3), kappa=KAPPA,
                      coarse=coarse, sigma=sigma, operator="kron_blocked",
                      dtype=torch.float32, device="cpu")
    u, rn = grid.solve(b, num_cycles=5)
    r0 = np.linalg.norm(b)
    assert _traj_close(rn, rn_j, r0), (rn, rn_j)
    assert np.abs(_np(u) - u_j).max() <= 1e-5


@pytest.mark.parametrize("shards", [(2, 2, 2), (1, 2, 4)])
def test_grid_kron_blocked_on_jax_state(jax_grid, shards):
    """On JAX's state (calibrated lmax included) 4 cycles stay within 1e-5
    of JAX's relative residuals and solution."""
    b, u_j, rn_j, _, data = jax_grid(shards, "kron_blocked", "cg",
                                     cycles=4, state=True)
    grid = tg.GridPMG(TBox(NC), shards=shards, degrees=(1, 3), kappa=KAPPA,
                      coarse="cg", operator="kron_blocked",
                      dtype=torch.float32, device="cpu")
    grid.load_state(grid_data_from_numpy(data, grid, "cpu", torch.float32))
    assert float(grid.data["levels"][-1]["lmax"]) == float(
        data["levels"][-1]["lmax"])
    for lv in grid.data["levels"]:  # the per-shard blocks are cut anew
        for idx, m in lv["kb_blocks"].items():
            want = tkb.shard_mats(lv["kb_mats"], idx)
            assert all(torch.equal(m[k], want[k]) for k in m if k != "band")
    u, rn = grid.solve(b, num_cycles=4)
    r0 = np.linalg.norm(b)
    assert np.abs(np.array(rn) - rn_j).max() / r0 <= 1e-5
    assert np.abs(_np(u) - u_j).max() <= 1e-5


def test_grid_apply_matches_assembled_oracle():
    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_stiffness

    grid = tg.GridPMG(TBox(NC), shards=(2, 2, 2), degrees=(1, 3),
                      kappa=KAPPA, coarse="cg", dtype=torch.float32,
                      operator="kron_blocked", device="cpu")
    A = assemble_stiffness(TBox(NC), 3, kappa=KAPPA).toarray()
    x = np.random.default_rng(11).standard_normal(TBox(NC).num_dofs(3))
    y = grid.from_dist(grid.ops["apply"](grid.data["levels"][-1],
                                         grid.to_dist(x), grid.levels[-1]))
    assert _rel(y, A @ x) < 1e-5


def test_grid_pmg_refuses_what_is_not_ported():
    mesh = TBox(NC)
    kw = dict(degrees=(1, 2), device="cpu")
    for call, err, match in (
            (lambda: tg.GridPMG(mesh, (2, 2), operator="nope", **kw),
             ValueError, "operator"),
            (lambda: tg.GridPMG(mesh, (2, 2), coarse="nope", **kw),
             ValueError, "unsupported coarse"),
            (lambda: tg.GridPMG(TBox((3, 4, 4)), (2, 2), **kw),
             ValueError, "must divide"),
            (lambda: tg.GridPMG(mesh, (2, 2), operator="kron_blocked", **kw),
             ValueError, "f32-only"),
            (lambda: tg.GridPMG(TBox(NC, dirichlet_faces=((False, False),) * 3), (2, 2),
                                **kw), ValueError, "pure-Neumann"),
            (lambda: tg.GridPMG(mesh, (2, 2), operator="lattice", **kw),
             NotImplementedError, "item 10"),
            (lambda: tg.GridPMG(mesh, (2, 2), coarse="hmg", **kw),
             NotImplementedError, "item 10"),
            (lambda: tg.GridPMG(mesh, (2, 2), coarse="fdm",
                                coarse_cfg=dict(dist=True), **kw),
             NotImplementedError, "item 10"),
            (lambda: tg.GridPMG(mesh, (2, 2), devices=["cuda:0"], **kw),
             NotImplementedError, "item 10"),
            (lambda: tg.GridPMG(mesh, (2, 2), sigma=lambda x: x[0], **kw),
             ValueError, "sigma FIELD"),
            (lambda: tg.GridPMG(mesh, (2, 2), kappa=np.arange(1.0, 65.0),
                                **kw), NotImplementedError, "item 10"),
            (lambda: tg.GridPMG(TBox(NC, dirichlet_faces=(
                (False, False), (True, True), (True, True)),
                robin=((1.0, 1.0), (0.0, 0.0), (0.0, 0.0))), (2, 2), **kw),
             NotImplementedError, "item 10"),
            (lambda: tg.GridPMG(TBox(NC, spacing=(None, None, (1.0, 2.0, 3.0,
                                                              4.0))),
                                (2, 2), **kw), NotImplementedError, "item 10"),
            (lambda: tg.GridPMG(mesh, (2, 2), precision="high", **kw),
             NotImplementedError, "item 1"),
            (lambda: tg.GridPMG(mesh, (2, 2), **kw).solve_refined(None),
             NotImplementedError, "item 10")):
        with pytest.raises(err, match=match):
            call()


@pytest.mark.parametrize("kwargs", [dict(coarse="direct"),
                                    dict(smoother="schwarz")])
def test_grid_pmg_runs_what_was_refused(kwargs):
    """The cases `test_grid_pmg_refuses_what_is_not_ported` held until
    items 7a/7b were ported: the gathered ``direct`` coarse solve and the
    Schwarz smoother on a (2, 2) grid cycle as JAX's `GridPMG` (f64:
    eigenvalue estimates to 1e-12, 3 cycles to 1e-10)."""
    kw = dict(degrees=(1, 2), **kwargs)
    grid = tg.GridPMG(TBox(NC), (2, 2), device="cpu", **kw)
    jgrid = jg.GridPMG(JBox(NC), (2, 2), **kw)
    for e_t, e_j in zip(grid.eigs, jgrid.eigs):
        assert np.max(np.abs(e_t - e_j) / np.abs(e_j)) <= 1e-12
    b = np.random.default_rng(4).standard_normal(TBox(NC).num_dofs(2))
    _, rt = grid.solve(b, num_cycles=3)
    _, rj = jgrid.solve(jnp.asarray(b), num_cycles=3)
    assert np.max(np.abs(np.array(rt) - rj) / np.array(rj)) <= 1e-10


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def test_scaling_torch_grid_matches_jax_driver():
    """`examples/scaling_torch.py --grid --device cpu` prints the JAX
    driver's layout-invariant residuals (f64)."""
    args = ["--grid", "--ndofs", "3000", "--degrees", "1", "3", "--dtype",
            "f64", "--cycles", "3", "--max-devices", "4"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    t = subprocess.run([sys.executable, str(ROOT / "examples" /
                                            "scaling_torch.py"), *args,
                        "--device", "cpu"], capture_output=True, text=True,
                       env=env, timeout=300, check=True).stdout
    print(t)
    out_t = _last_json(t)
    assert [r["layout"] for r in out_t["rows"]] == ["1x1x1", "2x1x1", "2x2x1"]
    assert all(r["invariant"] for r in out_t["rows"][1:])
    # the JAX driver prints its table; its rel resid column is compared
    j = subprocess.run([sys.executable, str(ROOT / "examples" / "scaling.py"),
                        *args, "--cpu"], capture_output=True, text=True,
                       env=env, timeout=300, check=True).stdout
    rel_j = [float(line.split()[-1]) for line in j.splitlines()
             if line.split() and "x" in line.split()[0]
             and line.split()[0][0].isdigit()]
    rel_t = [r["rel_resid"] for r in out_t["rows"]]
    assert len(rel_j) == len(rel_t)
    assert np.allclose(rel_t, rel_j, rtol=1e-3, atol=0)
