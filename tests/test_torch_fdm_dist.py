"""The port's distributed FDM (`pmg_dolfinx_tpu_torch.parallel.fdm_dist`)
and its seam `StackedGrid.all_to_all`, against the JAX package on the
CPU in float64.

Mirrors the JAX package's `tests/test_fdm_dist.py` and the `DistFDM`
cases of `test_graded.py`, `test_mixed_bc.py` and `test_robin.py`:
- `StackedGrid.all_to_all` round-trips exactly and, followed by the
  interface-plane dedup, equals the gathered lattice's pencil (the
  gather-based transpose it replaces);
- `DistFDM.solve` and the forward apply of `make_fdm_apply_dist` equal
  the JAX package's on the same layout to 1e-12 (slab 4 and 8, grids
  (2, 2, 2), (4, 2, 1), (2, 2, 1), (2, 1, 2); graded, mixed-face and
  Robin meshes, per-axis kappa, a sigma shift) and the port's
  single-device `FastDiagonalizationSolver`;
- ``coarse="fdm", coarse_cfg=dict(dist=True)`` on `DistPMG` and
  `GridPMG`: five-cycle trajectories equal JAX's to 1e-10 and the port's
  gathered fdm coarse's;
- the refusals, with JAX's messages.
JAX runs on the 8 virtual CPU devices of `tests/conftest.py`; the port
with ``device="cpu"``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pmg_dolfinx_tpu.fem.mesh import BoxMesh as JBox
from pmg_dolfinx_tpu.fem.mesh import geometric_spacing as j_spacing
from pmg_dolfinx_tpu.parallel import fdm_dist as jfd
from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh as TBox
from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh as TPerturbed
from pmg_dolfinx_tpu_torch.fem.mesh import geometric_spacing as t_spacing
from pmg_dolfinx_tpu_torch.parallel import fdm_dist as tfd
from pmg_dolfinx_tpu_torch.parallel.grid2d import StackedGrid
from pmg_dolfinx_tpu_torch.solvers.fdm import FastDiagonalizationSolver

MIXED = ((True, False), (False, False), (True, True))
ROBIN = ((0.0, 2.5), (1.7, 0.3), (0.0, 0.0))


def _rel(a, b):
    a = np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a,
                   np.float64).reshape(-1)
    b = np.asarray(b.detach().cpu() if isinstance(b, torch.Tensor) else b,
                   np.float64).reshape(-1)
    return float(np.abs(a - b).max() / np.abs(b).max())


# -- the seam: StackedGrid.all_to_all ---------------------------------------

@pytest.mark.parametrize("shards,axis,split,concat", [
    ((4, 1, 1), 0, 1, 0), ((4, 1, 1), 0, 2, 0), ((2, 3, 1), 1, 0, 1),
    ((2, 2, 2), 2, 0, 2), ((1, 2, 3), 2, 1, 2)])
def test_all_to_all_round_trips_exactly(shards, axis, split, concat):
    S = shards[axis]
    local = [5, 7, 4]
    local[split] = 2 * S
    x = torch.tensor(np.random.default_rng(0).standard_normal(
        tuple(shards) + tuple(local)))
    grid = StackedGrid(shards)
    y = grid.all_to_all(x, axis, split, concat)
    want = list(x.shape)
    want[3 + split] //= S
    want[3 + concat] *= S
    assert list(y.shape) == want
    assert torch.equal(grid.all_to_all(y, axis, concat, split), x)


@pytest.mark.parametrize("shards,axis,buddy", [
    ((4, 1, 1), 0, 1), ((2, 2, 1), 1, 0), ((2, 2, 2), 2, 1)])
def test_all_to_all_equals_the_gathered_pencil(shards, axis, buddy):
    """Shard ``j`` of the transposed stack holds, after the dedup of the
    duplicated interface planes, chunk ``j`` (of the buddy axis) of the
    global lattice along ``axis``: what gathering the lattice and slicing
    it would give."""
    from pmg_dolfinx_tpu_torch.parallel.grid2d import GridPartition

    S = shards[axis]
    nc = [2 * s for s in shards]
    nc[buddy] = shards[buddy]     # one cell a shard: 4 planes at p=3
    mesh = TBox(tuple(nc))
    part, P = GridPartition(mesh, shards), 3
    grid = StackedGrid(shards)
    glob = torch.tensor(np.random.default_rng(1).standard_normal(
        mesh.lattice_shape(P)))
    st = grid.local_slices(glob, part.local_shape(P))
    npl = st.shape[3 + axis]
    loc_b = st.shape[3 + buddy]
    assert loc_b % S == 0
    t = tfd._dedup(grid.all_to_all(st, axis, buddy, axis), 3 + axis, S, npl)
    gathered = grid.all_gather(st)
    assert torch.equal(gathered, glob)
    for idx in np.ndindex(*shards):
        s_b = idx[buddy]
        start_b = s_b * (loc_b - 1)
        want = gathered.narrow(buddy, start_b, loc_b)
        for a in range(3):
            if a not in (axis, buddy):
                n = st.shape[3 + a]
                want = want.narrow(a, idx[a] * (n - 1), n)
        want = want.narrow(buddy, idx[axis] * (loc_b // S), loc_b // S)
        assert torch.equal(t[idx], want)
    # ... and the redup + inverse transpose give back the stack.
    back = grid.all_to_all(tfd._redup(t, 3 + axis, S, npl), axis, axis,
                           buddy)
    assert torch.equal(back, st)


# -- DistFDM against JAX ---------------------------------------------------

_SOLVE_CASES = {
    "slab4": (4, 2.0, 0.0, 3, dict(nc=(8, 5, 6))),
    "slab8-sigma": (8, 2.0, 7.5, 4, dict(nc=(8, 5, 6))),
    "grid222-axes": ((2, 2, 2), (1.0, 3.0, 64.0), 0.0, 3, dict(nc=(6, 4, 8))),
    "grid421-sigma": ((4, 2, 1), 2.0, 3.0, 2, dict(nc=(8, 6, 5))),
    "graded-22": ((2, 2), 2.0, 0.0, 3, dict(nc=(4, 4, 4), graded=3.0)),
    "mixed-212": ((2, 1, 2), 2.0, 0.0, 2, dict(nc=(6, 4, 8), faces=MIXED)),
    "robin-slab4": (4, (2.0, 0.5, 3.0), 0.3, 4,
                    dict(nc=(8, 4, 4), faces=MIXED, robin=ROBIN)),
}


def _meshes(nc, faces=None, robin=None, graded=None):
    out = []
    for Box, spacing in ((JBox, j_spacing), (TBox, t_spacing)):
        kw = {}
        if faces is not None:
            kw["dirichlet_faces"] = faces
        if robin is not None:
            kw["robin"] = robin
        if graded is not None:
            kw["spacing"] = tuple(spacing(n, graded) for n in nc)
        out.append(Box(nc, **kw))
    return out


@pytest.mark.parametrize("name", list(_SOLVE_CASES))
def test_dist_fdm_solve_matches_jax(name):
    shards, kappa, sigma, P, mk = _SOLVE_CASES[name]
    jm, tm = _meshes(**mk)
    b = np.random.default_rng(0).standard_normal(tm.num_dofs(P))
    uj = jfd.DistFDM(jm, P, shards, kappa=kappa, dtype=jnp.float64,
                     sigma=sigma).solve(b)
    d = tfd.DistFDM(tm, P, shards, kappa=kappa, dtype=torch.float64,
                    sigma=sigma, device="cpu")
    ut = d.solve(b)
    assert tuple(ut.shape) == (tm.num_dofs(P),)
    assert _rel(ut, uj) < 1e-12
    single = FastDiagonalizationSolver(tm, P, kappa=kappa,
                                       dtype=torch.float64, sigma=sigma,
                                       device="cpu")
    assert _rel(ut, single.solve(b)) < 1e-12


@pytest.mark.parametrize("shards", [2, (2, 2, 1)])
def test_dist_fdm_high_precision_matches_jax(shards):
    """`DistFDM` at precision='high': its einsums in f64 at either value
    (the XLA-path rule), so JAX's 'high' on the CPU to 1e-12 and the
    port's 'highest' bit for bit."""
    jm, tm = _meshes((4, 4, 4))
    b = np.random.default_rng(1).standard_normal(tm.num_dofs(2))
    uj = jfd.DistFDM(jm, 2, shards, kappa=2.0, dtype=jnp.float64,
                     precision="high").solve(b)
    ut, ur = (tfd.DistFDM(tm, 2, shards, kappa=2.0, dtype=torch.float64,
                          precision=p, device="cpu").solve(b)
              for p in ("high", "highest"))
    assert _rel(ut, uj) < 1e-12
    assert torch.equal(ut, ur)


def test_dist_fdm_solution_is_exact():
    """The distributed solve really solves (A u == b through the oracle
    operator), and nonzero Dirichlet rows pass through."""
    from pmg_dolfinx_tpu_torch.ops.laplacian import MatFreeLaplacian

    mesh = TBox((8, 4, 4))
    P, kappa = 3, 2.0
    b = np.random.default_rng(1).standard_normal(mesh.num_dofs(P))
    bc = np.asarray(mesh.boundary_dof_marker(P))
    u = tfd.DistFDM(mesh, P, 4, kappa=kappa, dtype=torch.float64,
                    device="cpu").solve(b)
    assert np.allclose(u.numpy()[bc], b[bc])
    op = MatFreeLaplacian(mesh, P, kappa=kappa, dtype=torch.float64,
                          device="cpu")
    r = op(u).numpy() - np.where(bc, u.numpy(), b)
    assert np.linalg.norm(r[~bc]) / np.linalg.norm(b[~bc]) < 1e-12


@pytest.mark.parametrize("shards", [4, (2, 2, 1)])
def test_fdm_apply_dist_matches_jax(shards):
    """The forward bundle of `make_fdm_apply_dist` against JAX's, applied
    through the same solve hook (mixed faces, per-axis kappa, sigma)."""
    import jax
    from jax.sharding import NamedSharding

    from pmg_dolfinx_tpu.parallel.multihost import fetch_global, put_global

    jm, tm = _meshes((4, 4, 2), faces=MIXED)
    P, kd, sigma = 2, (1.0, 2.0, 0.5), 3.0
    part, jmesh, axes_spec, lat_spec = jfd.dist_layout(jm, shards)
    data, spec, apply_j = jfd.make_fdm_apply_dist(
        jm, P, part, axes_spec, lat_spec, kd, np.float64, sigma=sigma)
    with jmesh:
        data = jax.tree.map(
            lambda a, s: put_global(a, NamedSharding(jmesh, s)), data, spec)
    run = jax.jit(jax.shard_map(apply_j, mesh=jmesh,
                                in_specs=(spec, lat_spec),
                                out_specs=lat_spec))
    x = np.random.default_rng(0).standard_normal(tm.num_dofs(P))
    yj = part.from_dist(P, fetch_global(run(data, put_global(
        part.to_dist(P, x), NamedSharding(jmesh, lat_spec))))).reshape(-1)
    tpart, grid, taxes, tlat = tfd.dist_layout(tm, shards)
    assert taxes == tuple(axes_spec)
    tdata, _, apply_t = tfd.make_fdm_apply_dist(
        tm, P, tpart, taxes, tlat, kd, torch.float64, sigma=sigma,
        device="cpu")
    xd = grid.local_slices(torch.tensor(x).reshape(tm.lattice_shape(P)),
                           tpart.local_shape(P))
    yt = grid.all_gather(apply_t(tdata, xd)).reshape(-1)
    assert _rel(yt, yj) < 1e-12


# -- the coarse solve: coarse="fdm", coarse_cfg=dict(dist=True) -------------

_COARSE = {
    "slab8-kron": ("slab", (8, 8, 8), 8, dict(operator="kron"), 0.0),
    "slab4-dofmap-sigma": ("slab", (8, 4, 4), 4, dict(operator="dofmap"),
                           0.6),
    "slab4-mixed": ("slab", (8, 4, 4), 4, dict(operator="kron"), 0.0),
    "grid222": ("grid", (4, 8, 4), (2, 2, 2), {}, 0.0),
    "grid24-sigma": ("grid", (4, 8, 4), (2, 4), {}, 37.0),
    "grid221-mixed": ("grid", (8, 4, 4), (2, 2, 1), {}, 0.0),
}


@pytest.mark.parametrize("name", list(_COARSE))
def test_dist_fdm_coarse_trajectory_matches_jax(name):
    """Five stationary V-cycles with the pencil-transpose coarse solve:
    the residual trajectory equals JAX's (1e-10) and the port's gathered
    fdm coarse's; the solutions agree to 1e-10."""
    from pmg_dolfinx_tpu.parallel.dist import DistPMG as JD
    from pmg_dolfinx_tpu.parallel.grid2d import GridPMG as JG
    from pmg_dolfinx_tpu_torch.parallel.dist import DistPMG as TD
    from pmg_dolfinx_tpu_torch.parallel.grid2d import GridPMG as TG

    kind, nc, lay, extra, sigma = _COARSE[name]
    faces = MIXED if name.endswith("mixed") else None
    jm, tm = _meshes(nc, faces=faces)
    kw = dict(degrees=(1, 3), kappa=2.0, coarse="fdm", sigma=sigma, **extra)
    J, T = (JD, TD) if kind == "slab" else (JG, TG)
    b = np.random.default_rng(2).standard_normal(tm.num_dofs(3))
    j = J(jm, lay, coarse_cfg=dict(dist=True), **kw)
    t = T(tm, lay, coarse_cfg=dict(dist=True), device="cpu", **kw)
    gathered = T(tm, lay, device="cpu", **kw)
    assert "fdm_dist" in t.ops and "fdm_dist" not in gathered.ops
    uj, rj = j.solve(b, num_cycles=5)
    ut, rt = t.solve(b, num_cycles=5)
    _, rg = gathered.solve(b, num_cycles=5)
    np.testing.assert_allclose(rt, rj, rtol=1e-10)
    np.testing.assert_allclose(rt, rg, rtol=1e-10)
    assert _rel(ut, np.asarray(uj)) < 1e-10


# -- refusals ---------------------------------------------------------------

def test_dist_fdm_refuses_what_jax_refuses():
    with pytest.raises(ValueError):
        tfd.DistFDM(TPerturbed((4, 4, 4)), 2, 4, device="cpu")
    neumann = TBox((4, 4, 4), dirichlet_faces=((False, False),) * 3)
    with pytest.raises(ValueError, match="singular"):
        tfd.DistFDM(neumann, 2, 2, device="cpu")
    with pytest.raises(ValueError, match="singular"):
        jfd.DistFDM(JBox((4, 4, 4), dirichlet_faces=((False, False),) * 3),
                    2, 2)
    with pytest.raises(ValueError, match="divisible"):
        tfd.DistFDM(TBox((6, 4, 4)), 2, 4, device="cpu")


def test_dist_fdm_refuses_unported_options():
    # devices= names ranks since item 10 (d) ported them: device names
    # are refused
    with pytest.raises(ValueError, match=r"devices=.*rank of each shard"):
        tfd.DistFDM(TBox((4, 4, 4)), 2, 2, devices=["cpu"], device="cpu")


def test_hmg_fdm_bottom_rejected_where_unsupported():
    """``bottom="fdm"`` is distributed-only (the gathered `build_hmg`
    refuses it) and constant-coefficient only (`build_hmg_general`), as in
    the JAX package."""
    from pmg_dolfinx_tpu_torch.solvers.hmg import build_hmg, build_hmg_general

    with pytest.raises(ValueError, match="bottom"):
        build_hmg(TBox((4, 4, 4)), 1, 2.0, torch.float64, bottom="fdm",
                  device="cpu")
    with pytest.raises(ValueError, match="bottom"):
        build_hmg_general(TPerturbed((4, 4, 4)), 1, 2.0, torch.float64,
                          bottom="fdm", device="cpu")
