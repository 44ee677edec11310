"""The Kronecker family on the sharded layouts (`parallel.dist.DistPMG` and
`parallel.grid2d.GridPMG` with ``operator="kron" | "kron_blocked"``) on
Robin-faced, graded and anisotropic boxes, against the JAX package's
`DistPMG` / `GridPMG` on the 8 virtual CPU devices of `tests/conftest.py`.
Every case feeds the same inputs (a rhs made from a numpy seed, or the
manufactured Robin rhs assembled on the host) to both packages.

- f64 (`test_kron_sharded_matches_jax`): the calibration eigenvalues within
  1e-12 relative, the stationary trajectory within 1e-10 relative and the
  solution within 1e-10 (relative max-norm). The cases mirror JAX's
  ``test_robin.py::test_dist_solve_matches_single`` / ``test_grid_solve_
  matches_single`` (``kron``: ``cg``, ``fdm``, ``hmg``; 4 slabs, (2, 2, 2),
  (2, 4)), ``::test_dist_hmg_distributed_robin_matches_single``,
  ``::test_grid_hmg_distributed_robin_matches_single``,
  ``::test_dist_fdm_dist_coarse_robin_matches_single``,
  ``::test_dist_smoothers_robin_match_single`` (``line-z``, ``schwarz``),
  ``test_graded.py::test_dist_slab_graded_matches_single``,
  ``::test_grid_graded_matches_single`` (``kron``),
  ``::test_hmg_gathered_sharded_graded_matches_single``,
  ``::test_hmg_dist_slab_graded_matches_single``,
  ``::test_hmg_dist_grid_graded_gather_free``, ``test_tensor_kappa.py::
  test_diag_tensor_kron_sharded_matches_single`` plus a per-axis kappa on
  the grid, and cases 10 (Robin, gather-free hmg with the fdm bottom) and
  11 (every sharded axis graded, fdm coarse) of JAX's multi-chip dry run
  on (2, 2, 2);
- the slab's Robin operator against the scipy ``assemble_stiffness``
  oracle within 1e-11 (``test_robin.py::test_dist_operator_matches_
  oracle``, scalar and per-axis kappa), and the grid's;
- f32 ``kron_blocked`` (the port's plain versions against JAX's Pallas
  kernels in interpret mode): five cycles within 1e-4 relative and the
  solution within 1e-5 (``::test_dist_kron_blocked_robin_matches_single``,
  ``::test_grid_kron_blocked_robin_matches_single``), also on the slab
  with a graded x and a Robin x end (the stacked ``Ktx`` with blocks that
  differ) and on the grid with Robin y and graded z;
- `solve_refined` on the Kronecker backends with Robin faces (slab and
  grid, f32 working dtype, ``::test_dist_refined_robin_matches_single
  [kron]``, ``::test_grid_refined_robin_matches_single``): the f64
  residual history within 1e-5 of JAX's relative to ``|b|`` and below
  1e-6 of ``|b|`` at the end;
- `DistFDM` on a graded grid (``test_graded.py::test_dist_fdm_graded_
  matches_single``) within 1e-12 of JAX's;
- `load_state` of JAX's state (`utils.convert.dist_data_from_numpy` /
  `grid_data_from_numpy`) of a Robin + graded grid hierarchy with the
  gather-free hmg (f64: 4 cycles within 1e-10) and of a Robin + graded
  ``kron_blocked`` slab (f32: 4 cycles within 1e-5).

The kernels on the card (#1 on the stacked ``Ktx``, #9 on per-shard
blocks that differ) are in `tests/test_torch_dist_cuda.py` and
`tests/test_torch_grid_cuda.py`.
"""

import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pmg_dolfinx_tpu.fem import assembly as jas  # noqa: E402
from pmg_dolfinx_tpu.fem import mesh as jm  # noqa: E402
from pmg_dolfinx_tpu.models import poisson as jpo  # noqa: E402
from pmg_dolfinx_tpu.parallel import dist as jd  # noqa: E402
from pmg_dolfinx_tpu.parallel import fdm_dist as jfd  # noqa: E402
from pmg_dolfinx_tpu.parallel import grid2d as jg  # noqa: E402
from pmg_dolfinx_tpu_torch.fem import mesh as tm  # noqa: E402
from pmg_dolfinx_tpu_torch.parallel import dist as td  # noqa: E402
from pmg_dolfinx_tpu_torch.parallel import fdm_dist as tfd  # noqa: E402
from pmg_dolfinx_tpu_torch.parallel import grid2d as tg  # noqa: E402
from pmg_dolfinx_tpu_torch.utils.convert import (  # noqa: E402
    dist_data_from_numpy,
    grid_data_from_numpy,
)

# JAX's test_robin.py faces: Robin on the x-high end and both y ends
# (the sharded axes' end shards differ), Dirichlet elsewhere.
DF = ((True, False), (False, False), (True, True))
ROBIN = ((0.0, 2.5), (1.7, 0.3), (0.0, 0.0))
KAPPA = 2.0


def _mesh(pkg, kind, nc):
    """``kind``: 'robin', 'box', 'graded-x' (x 4:1), 'graded-xz' (x 5:1, z
    3:1), 'graded-xz2' (x 5:1, z 2:1), 'graded-all' (every axis 4:1),
    'graded-all5' (5:1), 'robin-graded' (Robin faces, z 4:1) or
    'robin-x-graded' (x graded 8:1 with a Robin x-high end, the slab's
    stacked ``Ktx`` with blocks that differ)."""
    g = pkg.geometric_spacing
    if kind == "robin":
        return pkg.BoxMesh(nc, dirichlet_faces=DF, robin=ROBIN)
    if kind == "robin-graded":
        return pkg.BoxMesh(nc, dirichlet_faces=DF, robin=ROBIN,
                           spacing=(None, None, g(nc[2], 4.0)))
    if kind == "robin-x-graded":
        return pkg.BoxMesh(nc, dirichlet_faces=((True, False), (True, True),
                                                (True, True)),
                           robin=((0.0, 1.7), (0.0, 0.0), (0.0, 0.0)),
                           spacing=(g(nc[0], 8.0), None, None))
    ratios = {"graded-x": (4.0, None, None), "graded-xz": (5.0, None, 3.0),
              "graded-xz2": (5.0, None, 2.0), "graded-all": (4.0,) * 3,
              "graded-all5": (5.0,) * 3, "box": (None,) * 3}[kind]
    return pkg.BoxMesh(nc, spacing=tuple(
        None if r is None else g(n, r) for n, r in zip(nc, ratios)))


def _rhs(kind, nc, P, seed):
    """The rhs: JAX's manufactured Robin problem (body force plus Robin
    surface data, assembled on the host) on 'robin' meshes, else a seeded
    normal vector with the Dirichlet rows zeroed."""
    mesh = _mesh(jm, kind, nc)
    if kind == "robin":
        u = jpo.u_exact_mixed(DF)
        g = jpo.robin_data(KAPPA, u, jpo.grad_u_exact_mixed(DF), ROBIN)
        return (np.asarray(jas.assemble_rhs(mesh, P, jpo.f_rhs_mixed(
            KAPPA, DF))) + jas.robin_rhs_np(mesh, P, g))
    b = np.random.default_rng(seed).standard_normal(mesh.num_dofs(P))
    b[np.asarray(mesh.boundary_dof_marker(P))] = 0.0
    return b


# name: (layout, mesh kind, nc, shards, keywords, cycles)
CASES = {
    "dist-robin-cg-4": ("dist", "robin", (8, 4, 4), 4, {}, 8),
    "dist-robin-fdm-4": ("dist", "robin", (8, 4, 4), 4,
                         dict(coarse="fdm"), 8),
    "dist-robin-hmg-4": ("dist", "robin", (8, 4, 4), 4,
                         dict(coarse="hmg"), 8),
    "dist-robin-hmgdist-4": ("dist", "robin", (8, 4, 4), 4,
                             dict(coarse="hmg", coarse_cfg=dict(dist=True)),
                             6),
    "dist-robin-hmgdist-fdm-4": ("dist", "robin", (8, 4, 4), 4,
                                 dict(coarse="hmg", coarse_cfg=dict(
                                     dist=True, bottom="fdm")), 6),
    "dist-robin-fdmdist-4": ("dist", "robin", (8, 4, 4), 4,
                             dict(coarse="fdm", coarse_cfg=dict(dist=True)),
                             6),
    "dist-robin-line-z-4": ("dist", "robin", (8, 4, 4), 4,
                            dict(coarse="direct", smoother="line-z"), 6),
    "dist-robin-schwarz-4": ("dist", "robin", (8, 4, 4), 4,
                             dict(coarse="direct", smoother="schwarz"), 6),
    "grid-robin-fdm-222": ("grid", "robin", (4, 4, 4), (2, 2, 2),
                           dict(coarse="fdm"), 8),
    "grid-robin-hmg-24": ("grid", "robin", (4, 4, 4), (2, 4),
                          dict(coarse="hmg"), 8),
    "grid-robin-hmgdist-22": ("grid", "robin", (4, 4, 4), (2, 2),
                              dict(coarse="hmg", coarse_cfg=dict(dist=True)),
                              6),
    "grid-robin-hmgdist-fdm-22": ("grid", "robin", (4, 4, 4), (2, 2),
                                  dict(coarse="hmg", coarse_cfg=dict(
                                      dist=True, bottom="fdm")), 6),
    "dist-graded-fdm-4": ("dist", "graded-xz", (8, 4, 5), 4,
                          dict(coarse="fdm"), 6),
    "dist-graded-hmg-4": ("dist", "graded-x", (8, 4, 4), 4,
                          dict(coarse="hmg"), 6),
    "grid-graded-hmg-22": ("grid", "graded-x", (8, 4, 4), (2, 2),
                           dict(coarse="hmg"), 6),
    "dist-graded-hmgdist-4": ("dist", "graded-xz2", (16, 4, 4), 4,
                              dict(coarse="hmg", coarse_cfg=dict(dist=True)),
                              6),
    "grid-graded-hmgdist-fdm-222": ("grid", "graded-all", (8, 8, 8),
                                    (2, 2, 2), dict(coarse="hmg", coarse_cfg=
                                                    dict(dist=True,
                                                         bottom="fdm")), 6),
    "grid-graded-fdm-22": ("grid", "graded-all", (4, 4, 4), (2, 2),
                           dict(coarse="fdm"), 5),
    "grid-graded-fdm-222": ("grid", "graded-all", (4, 4, 4), (2, 2, 2),
                            dict(coarse="fdm"), 5),
    "dist-diagtensor-fdm-4": ("dist", "box", (8, 4, 4), 4,
                              dict(coarse="fdm", kappa=np.diag(
                                  [1.0, 2.0, 16.0])), 5),
    "grid-diagtensor-fdm-221": ("grid", "box", (8, 4, 4), (2, 2, 1),
                                dict(coarse="fdm", kappa=np.diag(
                                    [1.0, 2.0, 16.0])), 5),
    "grid-peraxis-fdmdist-222": ("grid", "robin-graded", (4, 4, 4),
                                 (2, 2, 2), dict(coarse="fdm", coarse_cfg=
                                                 dict(dist=True),
                                                 kappa=(1.0, 2.0, 4.0)), 5),
    # JAX's multi-chip dry run, cases 10 and 11, at shards (2, 2, 2).
    "graft10-robin-hmgdist-fdm-222": ("grid", "robin", (8, 8, 8), (2, 2, 2),
                                      dict(degrees=(1, 2), coarse="hmg",
                                           coarse_cfg=dict(dist=True,
                                                           bottom="fdm")),
                                      4),
    "graft11-graded-fdm-222": ("grid", "graded-all5", (8, 8, 8), (2, 2, 2),
                               dict(degrees=(1, 2), coarse="fdm"), 4),
}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _rel_max(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _build(layout, kind, nc, shards, kw, dtype=jnp.float64):
    """(JAX hierarchy, port hierarchy) of one layout on the same mesh."""
    kw = dict(dict(degrees=(1, 3), kappa=KAPPA, coarse="cg",
                   operator="kron"), **kw)
    tdt = torch.float32 if dtype == jnp.float32 else torch.float64
    if layout == "dist":
        j = jd.DistPMG(_mesh(jm, kind, nc), n_devices=shards, dtype=dtype,
                       **kw)
        t = td.DistPMG(_mesh(tm, kind, nc), n_devices=shards, dtype=tdt,
                       device="cpu", **kw)
    else:
        j = jg.GridPMG(_mesh(jm, kind, nc), shards, dtype=dtype, **kw)
        t = tg.GridPMG(_mesh(tm, kind, nc), shards, dtype=tdt, device="cpu",
                       **kw)
    return j, t


@pytest.mark.parametrize("name", list(CASES))
def test_kron_sharded_matches_jax(name):
    layout, kind, nc, shards, kw, cycles = CASES[name]
    j, t = _build(layout, kind, nc, shards, kw)
    for e_t, e_j in zip(t.eigs, j.eigs):
        e_t, e_j = np.asarray(e_t), np.asarray(e_j)
        assert np.max(np.abs(e_t - e_j) / np.abs(e_j)) <= 1e-12
    b = _rhs(kind, nc, t.degrees[-1], len(name))
    uj, rj = j.solve(jnp.asarray(b), num_cycles=cycles)
    ut, rt = t.solve(b, num_cycles=cycles)
    assert tuple(ut.shape) == (b.size,)
    assert np.max(np.abs(np.array(rt) - rj) / np.array(rj)) <= 1e-10
    assert _rel_max(ut, uj) <= 1e-10


@pytest.mark.parametrize("layout,kappa", [
    ("dist", KAPPA), ("dist", (2.0, 0.5, 3.0)), ("grid", (2.0, 0.5, 3.0))])
def test_robin_operator_matches_oracle(layout, kappa):
    """The sharded Robin operator (per-shard row-stacked end updates on
    the sharded axes) equals the assembled scipy stiffness."""
    nc, shards = ((8, 4, 4), 4) if layout == "dist" else ((4, 4, 4),
                                                         (2, 2, 2))
    A = jas.assemble_stiffness(_mesh(jm, "robin", nc), 3, kappa=kappa)
    mesh = _mesh(tm, "robin", nc)
    h = (td.DistPMG(mesh, n_devices=shards, degrees=(1, 3), kappa=kappa,
                    operator="kron", device="cpu") if layout == "dist"
         else tg.GridPMG(mesh, shards, degrees=(1, 3), kappa=kappa,
                         operator="kron", device="cpu"))
    x = np.random.default_rng(6).standard_normal(mesh.num_dofs(3))
    y = h.from_dist(h._fine_apply(h.to_dist(x)))
    np.testing.assert_allclose(_np(y), A @ x, rtol=0, atol=1e-11)


# name: (layout, mesh kind, nc, shards, keywords)
F32_CASES = {
    "dist-robin-cg-4": ("dist", "robin", (8, 4, 4), 4, {}),
    "grid-robin-cg-222": ("grid", "robin", (4, 4, 4), (2, 2, 2), {}),
    "dist-robin-x-graded-fdm-4": ("dist", "robin-x-graded", (8, 4, 4), 4,
                                  dict(coarse="fdm")),
    "grid-robin-graded-fdmdist-222": ("grid", "robin-graded", (4, 4, 4),
                                      (2, 2, 2), dict(coarse="fdm",
                                                      coarse_cfg=dict(
                                                          dist=True))),
}


@pytest.mark.parametrize("name", list(F32_CASES))
def test_kron_blocked_sharded_matches_jax(name):
    """f32 ``kron_blocked`` (the port's plain versions of #1-#3 / #9
    against JAX's kernels in interpret mode) on Robin-faced and graded
    meshes: per-shard operands that differ."""
    layout, kind, nc, shards, kw = F32_CASES[name]
    j, t = _build(layout, kind, nc, shards,
                  dict(kw, operator="kron_blocked"), dtype=jnp.float32)
    b = _rhs(kind, nc, 3, 11)
    uj, rj = j.solve(jnp.asarray(b), num_cycles=5)
    ut, rt = t.solve(b, num_cycles=5)
    assert np.max(np.abs(np.array(rt) - rj) / np.array(rj)) <= 1e-4
    assert float(np.abs(_np(ut) - np.asarray(uj)).max()) <= 1e-5


@pytest.mark.parametrize("layout", ["dist", "grid"])
def test_kron_refined_robin_matches_jax(layout):
    """`solve_refined` on the Kronecker backend with Robin faces: the f64
    residual apply carries the row-stacked Robin ends; the f32 V-cycle
    drives it below 1e-6 of ``|b|`` as JAX's does."""
    # JAX's meshes and counts: the all-Robin y axis contracts at ~0.55 a
    # cycle on the slab.
    nc, shards, kw, n = (((8, 8, 8), 8, dict(coarse="cg"), 25)
                         if layout == "dist"
                         else ((4, 4, 4), (2, 2, 2), dict(coarse="fdm"), 20))
    j, t = _build(layout, "robin", nc, shards, kw, dtype=jnp.float32)
    b = _rhs("robin", nc, 3, 0)
    r0 = np.linalg.norm(b)
    uj, rj = j.solve_refined(b, num_cycles=n)
    ut, rt = t.solve_refined(b, num_cycles=n)
    assert ut.dtype == torch.float64
    assert rt[-1] / r0 < 1e-6
    assert np.abs(np.array(rt) - np.array(rj)).max() / r0 <= 1e-5
    assert float(np.abs(_np(ut) - np.asarray(uj)).max()) <= 1e-5


def test_dist_fdm_graded_matches_jax():
    """`DistFDM` on a graded (2, 2) grid: the embedded transforms
    diagonalise the graded pencils, as JAX's."""
    mesh = _mesh(tm, "graded-all", (4, 4, 4))
    jmesh = _mesh(jm, "graded-all", (4, 4, 4))
    b = _rhs("graded-all", (4, 4, 4), 3, 3)
    uj = np.asarray(jfd.DistFDM(jmesh, 3, (2, 2), kappa=KAPPA,
                                dtype=jnp.float64).solve(b))
    ut = tfd.DistFDM(mesh, 3, (2, 2), kappa=KAPPA, dtype=torch.float64,
                     device="cpu").solve(b)
    assert _rel_max(ut, uj) <= 1e-12


@pytest.mark.parametrize("layout", ["grid", "dist"])
def test_kron_sharded_on_jax_state(layout):
    """JAX's calibrated state of a Robin + graded hierarchy carried into
    the port: the grid's gather-free hmg (f64, row-stacked ``K*`` on every
    h-level and per-shard transfer blocks on the graded axis) and the
    slab's ``kron_blocked`` with its per-slab ``Ktx`` blocks (f32)."""
    if layout == "grid":
        kind, nc, shards = "robin-graded", (4, 4, 4), (2, 2, 2)
        kw, dtype, tol = dict(coarse="hmg", coarse_cfg=dict(
            dist=True, bottom="fdm")), jnp.float64, 1e-10
        convert = grid_data_from_numpy
    else:
        kind, nc, shards = "robin-x-graded", (8, 4, 4), 4
        kw, dtype, tol = dict(coarse="fdm", operator="kron_blocked"), \
            jnp.float32, 1e-5
        convert = dist_data_from_numpy
    j, t = _build(layout, kind, nc, shards, kw, dtype=dtype)
    data = jax.tree.map(np.asarray, j.data)
    t.load_state(convert(data, t, "cpu", t.dtype))
    b = _rhs(kind, nc, 3, 5)
    uj, rj = j.solve(jnp.asarray(b), num_cycles=4)
    ut, rt = t.solve(b, num_cycles=4)
    assert np.abs(np.array(rt) - rj).max() / np.linalg.norm(b) <= tol
    assert _rel_max(ut, uj) <= tol
