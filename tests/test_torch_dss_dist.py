"""The port's distributed unstructured path (`parallel/dss_dist.py`) against
the JAX package's `DSSDist` on the 8 virtual CPU devices and against the
port's single-device ``dss`` hierarchy, float64.

- partition: `DSSPartition`'s ``l2g``, ``weights`` and ``bc`` and the
  per-kind entity tables of `_entity_partition` equal JAX's array for
  array (dummy-cell padding: 81 cells over 8 shards; 3 shards too); the
  round trip and single ownership;
- stacked apply: the one gather / scatter over all shards equals a loop
  over each shard's own tables, and after the exchange the single-device
  apply and restriction (1e-13), on a mesh with every cell's corner frame
  rotated;
- the mirrors of JAX's `tests/test_dss_dist.py` and of
  `__graft_entry__.py` dry-run case 13: trajectories and solutions to
  1e-10 / 1e-12 of JAX's `DSSDist` and of one device, FCG counts equal;
- `load_state` of JAX's state (`utils.convert.dss_dist_data_from_numpy`):
  four cycles within 1e-10 of JAX's own.

Each JAX `DSSDist` is built once per module. The card case (one f32
V-cycle on CUDA against the CPU) is in `tests/test_torch_dist_cuda.py`,
which imports no JAX.
"""

import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

from pmg_dolfinx_tpu.fem import unstructured as jfu  # noqa: E402
from pmg_dolfinx_tpu.fem.mesh import PerturbedBoxMesh  # noqa: E402
from pmg_dolfinx_tpu.parallel import dss_dist as jdd  # noqa: E402
from pmg_dolfinx_tpu_torch.fem import unstructured as tfu  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs  # noqa: E402
from pmg_dolfinx_tpu_torch.models.poisson import f_rhs  # noqa: E402
from pmg_dolfinx_tpu_torch.ops import unstructured as tus  # noqa: E402
from pmg_dolfinx_tpu_torch.parallel import dss_dist as tdd  # noqa: E402
from pmg_dolfinx_tpu_torch.parallel.grid2d import StackedGrid  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy  # noqa: E402
from pmg_dolfinx_tpu_torch.utils.convert import (  # noqa: E402
    dss_dist_data_from_numpy,
)
from test_torch_unstructured import _rotated_cells  # noqa: E402

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-virtual-device CPU mesh")

S = 8


def _meshes(n, rotate=None):
    """(port, JAX) L-shaped meshes; ``rotate`` a seed for rotated cell
    frames."""
    base = jfu.l_shaped_hex_mesh(n)
    if rotate is None:
        return tfu.l_shaped_hex_mesh(n), base
    cells = _rotated_cells(np.asarray(base.geometry_dofmap), rotate)
    return (tfu.UnstructuredHexMesh(base.geometry_x, cells),
            jfu.UnstructuredHexMesh(base.geometry_x, cells))


def _curved():
    pb = PerturbedBoxMesh((4, 4, 4))
    x, cells = pb.geometry_x, np.asarray(pb.geometry_dofmap)
    return (tfu.UnstructuredHexMesh(x, cells),
            jfu.UnstructuredHexMesh(x, cells))


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _traj(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.abs(b)))


# -- partition -----------------------------------------------------------


@pytest.mark.parametrize("n,shards", [(2, 8), (3, 8), (3, 3)])
@pytest.mark.parametrize("P", [1, 3])
def test_partition_tables_equal_jax(n, shards, P):
    mt, mj = _meshes(n)
    pt, pj = tdd.DSSPartition(mt, shards), jdd.DSSPartition(mj, shards)
    t, j = pt.tables(P), pj.tables(P)
    assert t["ndl"] == j["ndl"]
    assert tuple(t["meta"]) == tuple(j["meta"])
    for key in ("l2g", "weights", "bc"):
        assert t[key].dtype == j[key].dtype
        assert np.array_equal(t[key], j[key]), key
    lt = mj.dss_layout(P)
    for kind, nloc in (("face", 6), ("edge", 12), ("vert", 8)):
        if kind != "vert" and lt["m"] == 0:
            continue
        args = (lt[f"{kind}_id"], lt[f"{kind}_src"],
                lt["n" + kind[0].upper()], nloc, pj.cell_shard, shards)
        (per_t, nt), (per_j, nj) = (tdd._entity_partition(*args),
                                    jdd._entity_partition(*args))
        assert nt == nj
        for a, b in zip(per_t, per_j):
            assert set(a) == set(b)
            for key in b:
                assert a[key].shape == b[key].shape, (kind, key)
                assert np.array_equal(a[key], b[key]), (kind, key)
    # round trip, every dof owned exactly once
    u = np.random.default_rng(P).standard_normal(mt.num_dofs(P))
    ud = pt.to_dist(P, u)
    assert np.array_equal(ud, pj.to_dist(P, u))
    np.testing.assert_array_equal(pt.from_dist(P, ud), u)
    owned = np.zeros(mt.num_dofs(P))
    sel = t["l2g"] >= 0
    np.add.at(owned, t["l2g"][sel], t["weights"][sel])
    np.testing.assert_array_equal(owned, 1.0)


def test_pad_stack_matches_jax():
    arrs = [np.arange(6).reshape(3, 2), np.arange(2).reshape(1, 2),
            np.zeros((0, 2), dtype=int)]
    (a, sa), (b, sb) = tdd._pad_stack(arrs, -1), jdd._pad_stack(arrs, -1)
    assert sa == sb and np.array_equal(a, b)


# -- the stacked apply ---------------------------------------------------


def _stacked_level(mesh, P, shards, kappa=2.0):
    """The stacked tables and G / coeff of one degree, the JAX
    partition's layout, the global and the per-shard single-device
    arrays."""
    from pmg_dolfinx_tpu_torch.fem.assembly import geometry_factors_np
    from pmg_dolfinx_tpu_torch.fem.gll import derivative_matrix

    part = tdd.DSSPartition(mesh, shards)
    t = part.tables(P)
    G = geometry_factors_np(mesh, P)[0]
    kc = np.full(mesh.ncells, kappa)
    f64 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
    lv = dict(tdd.stacked_tables(t, device="cpu"), G=f64(part.per_cell(G)),
              coeff=f64(part.per_cell(kc)), D=f64(derivative_matrix(P)),
              bc_marker=torch.tensor(t["bc"].reshape(-1)))
    lay = mesh.dss_layout(P)
    glob = dict(tus.dss_device_tables(lay, device="cpu"), G=f64(G),
                coeff=f64(kc), D=lv["D"],
                bc_marker=torch.tensor(mesh.boundary_dof_marker(P)))
    return part, t, lv, glob, tus.dss_meta(lay)


@pytest.mark.parametrize("P", [1, 3])
def test_stacked_apply_matches_shard_loop_and_single_device(P):
    mt, _ = _meshes(3, rotate=5)
    part, t, lv, glob, meta_g = _stacked_level(mt, P, S)
    meta, ndl = t["meta"], t["ndl"]
    grid = StackedGrid((S,))
    rng = np.random.default_rng(P)
    x = torch.tensor(rng.standard_normal(S * ndl))
    # raw overlap-add of all shards at once against a loop over shards
    yc = tus.apply_cells(tus.dss_gather(x, lv, meta), lv["G"], lv["coeff"],
                         lv["D"])
    raw = tus.dss_scatter(yc, lv, meta)
    ncl = part.ncl
    for s, lay in enumerate(t["layouts"]):
        ts = tus.dss_device_tables(lay, device="cpu")
        sl = slice(s * ndl, (s + 1) * ndl)
        cs = slice(s * ncl, (s + 1) * ncl)
        ys = tus.dss_scatter(tus.apply_cells(
            tus.dss_gather(x[sl], ts, meta), lv["G"][cs], lv["coeff"][cs],
            lv["D"]), ts, meta)
        assert torch.equal(raw[sl], ys), s
    # the distributed apply against the single device through to_dist
    u = rng.standard_normal(mt.num_dofs(P))
    ops = tdd.dss_dist_cycle_ops(grid=grid)
    from pmg_dolfinx_tpu_torch.solvers.pmg import Level

    lev = Level(P=P, ndofs=ndl, dss=meta)
    y = ops["apply"](lv, torch.tensor(part.to_dist(P, u)), lev)
    ref = tus.dss_laplacian_apply(torch.tensor(u), glob, meta_g)
    sel = t["l2g"].reshape(-1) >= 0
    ref_d = torch.tensor(part.to_dist(P, ref.numpy()))
    assert _rel(y[torch.tensor(sel)], ref_d[torch.tensor(sel)]) < 1e-13
    assert _rel(torch.tensor(part.from_dist(P, y.numpy())), ref) < 1e-13


def test_stacked_transfers_match_single_device():
    from pmg_dolfinx_tpu_torch.fem.gll import interpolation_matrix_1d
    from pmg_dolfinx_tpu_torch.solvers.pmg import Level

    mt, _ = _meshes(3, rotate=7)
    grid = StackedGrid((S,))
    ops = tdd.dss_dist_cycle_ops(grid=grid)
    (pc, tc, lvc, gc, mgc), (pf, tf, lvf, gf, mgf) = (
        _stacked_level(mt, 1, S), _stacked_level(mt, 3, S))
    M1 = torch.tensor(interpolation_matrix_1d(1, 3))
    mult = mt.dof_multiplicity(3)
    sel = tf["l2g"] >= 0
    inv = np.zeros(sel.shape)
    inv[sel] = 1.0 / mult[tf["l2g"][sel]]
    tr = dict(M1=M1, tc=lvc, tf=lvf, inv_mult_f=torch.tensor(inv.reshape(-1)))
    lc, lf = (Level(P=1, ndofs=tc["ndl"], dss=tc["meta"]),
              Level(P=3, ndofs=tf["ndl"], dss=tf["meta"]))
    rng = np.random.default_rng(3)
    rf = rng.standard_normal(mt.num_dofs(3))
    uc = rng.standard_normal(mt.num_dofs(1))
    got_r = ops["restrict"](tr, torch.tensor(pf.to_dist(3, rf)), lc, lf)
    ref_r = tus.dss_restrict(torch.tensor(rf), M1, gf, mgf, gc, mgc,
                             torch.tensor(1.0 / mult))
    assert _rel(torch.tensor(pc.from_dist(1, got_r.numpy())), ref_r) < 1e-13
    got_p = ops["prolong"](tr, torch.tensor(pc.to_dist(1, uc)), lc, lf)
    ref_p = tus.dss_prolongate(torch.tensor(uc), M1, gc, mgc, gf, mgf)
    assert _rel(torch.tensor(pf.from_dist(3, got_p.numpy())), ref_p) < 1e-13
    # prolongation writes every duplicate of a dof the same value
    assert _rel(got_p[torch.tensor(sel.reshape(-1))],
                torch.tensor(pf.to_dist(3, ref_p.numpy()))[
                    torch.tensor(sel.reshape(-1))]) < 1e-13


def test_psum_sums_the_shard_axes():
    grid = StackedGrid((4,))
    buf = torch.arange(4 * 5, dtype=torch.float64).reshape(4, 1, 1, 5)
    assert torch.equal(grid.psum(buf), buf.sum(0).reshape(5))


# -- mirrors of JAX's tests ----------------------------------------------


@pytest.fixture(scope="module")
def padded():
    """JAX's `test_stationary_trajectory_exact_with_padding` setup: 81
    cells over 8 shards, (1, 3), kappa 2, cg coarse."""
    mt, mj = _meshes(3)
    b = assemble_rhs(mt, 3, f_rhs(2.0))
    jd = jdd.DSSDist(mj, n_devices=S, degrees=(1, 3), kappa=2.0,
                     coarse="cg")
    ju, jr = jd.solve(b, num_cycles=6)
    j4 = jd.solve(b, num_cycles=4)[1]
    data = jax.tree.map(np.asarray, jd.data)
    return mt, b, np.asarray(ju), np.asarray(jr), np.asarray(j4), data


def test_stationary_trajectory_exact_with_padding(padded):
    mt, b, ju, jr, _, _ = padded
    hs = PMGHierarchy(mt, degrees=(1, 3), kappa=2.0, coarse="cg",
                      operator="dss", device="cpu")
    us, rs = hs.solve(torch.tensor(b), num_cycles=6)
    td = tdd.DSSDist(mt, S, (1, 3), 2.0, coarse="cg", device="cpu")
    ud, rd = td.solve(b, num_cycles=6)
    assert _traj(rd, jr) < 1e-10
    assert _traj(rd, rs) < 1e-10
    assert _rel(ud, ju) < 1e-12
    assert _rel(ud, us) < 1e-12


def test_high_precision_matches_jax(padded):
    """`DSSDist` at precision='high' (its torch ops: f64 at either value)
    against JAX's `DSSDist` at 'high' on the CPU: the trajectory to 1e-10,
    the solution to 1e-12, and equal to the port's 'highest' bit for
    bit."""
    mt, mj = _meshes(3)
    b = padded[1]
    jd = jdd.DSSDist(mj, n_devices=S, degrees=(1, 3), kappa=2.0,
                     coarse="cg", precision="high")
    ju, jr = jd.solve(b, num_cycles=6)
    td = tdd.DSSDist(mt, S, (1, 3), 2.0, coarse="cg", precision="high",
                     device="cpu")
    ud, rd = td.solve(b, num_cycles=6)
    assert _traj(rd, jr) < 1e-10
    assert _rel(ud, np.asarray(ju)) < 1e-12
    ref = tdd.DSSDist(mt, S, (1, 3), 2.0, coarse="cg", device="cpu")
    assert torch.equal(ud, ref.solve(b, num_cycles=6)[0])


def test_load_state_cycles_as_jax(padded):
    mt, b, _, _, j4, data = padded
    td = tdd.DSSDist(mt, S, (1, 3), 2.0, coarse="cg", device="cpu")
    td.load_state(dss_dist_data_from_numpy(data, td, "cpu", torch.float64))
    for lv, jl in zip(td.data["levels"], data["levels"]):
        assert float(lv["lmax"]) == float(jl["lmax"])
        assert torch.equal(lv["diag_inv"], torch.tensor(jl["diag_inv"]))
    _, rd = td.solve(b, num_cycles=4)
    assert _traj(rd, j4) < 1e-10


@pytest.fixture(scope="module")
def direct_sigma():
    """JAX's `test_fcg_direct_sigma_dg0_exact` setup."""
    mt, mj = _meshes(2)
    kap = np.linspace(1.0, 2.5, mt.ncells)
    b = assemble_rhs(mt, 4, f_rhs(1.0, sigma=0.8))
    jd = jdd.DSSDist(mj, n_devices=S, degrees=(1, 2, 4), kappa=kap,
                     coarse="direct", sigma=0.8)
    ju, jit = jd.solve_pcg(b, rtol=1e-9)
    return mt, kap, b, np.asarray(ju), jit, jax.tree.map(np.asarray, jd.data)


def test_fcg_direct_sigma_dg0_exact(direct_sigma):
    mt, kap, b, ju, jit, _ = direct_sigma
    hs = PMGHierarchy(mt, degrees=(1, 2, 4), kappa=kap, coarse="direct",
                      operator="dss", sigma=0.8, device="cpu")
    us, its = hs.solve_pcg(torch.tensor(b), rtol=1e-9)
    td = tdd.DSSDist(mt, n_devices=S, degrees=(1, 2, 4), kappa=kap,
                     coarse="direct", sigma=0.8, device="cpu")
    ud, itd = td.solve_pcg(b, rtol=1e-9)
    assert itd == jit == its
    assert _rel(ud, ju) < 1e-12
    assert _rel(ud, us) < 1e-12


def test_direct_sigma_state_from_jax(direct_sigma):
    """The coarse factor, the shifted diagonal and the bc-zeroed ``m3``
    carry over and equal the port's own."""
    mt, kap, _, _, _, data = direct_sigma
    td = tdd.DSSDist(mt, n_devices=S, degrees=(1, 2, 4), kappa=kap,
                     coarse="direct", sigma=0.8, device="cpu")
    conv = dss_dist_data_from_numpy(data, td, "cpu", torch.float64)
    assert _rel(td.data["coarse_chol"], conv["coarse_chol"]) < 1e-13
    for lv, cv in zip(td.data["levels"], conv["levels"]):
        for key in ("diag_inv", "m3", "weights", "G", "coeff"):
            assert _rel(lv[key], cv[key]) < 1e-13, key
        assert torch.equal(lv["bc_marker"], cv["bc_marker"])
    for tr, cv in zip(td.data["transfer"], conv["transfer"]):
        assert torch.equal(tr["inv_mult_f"], cv["inv_mult_f"])


@pytest.fixture(scope="module")
def curved_schwarz():
    """JAX's `test_curved_schwarz_exact` setup."""
    mt, mj = _curved()
    b = assemble_rhs(mt, 3, f_rhs(1.0))
    jd = jdd.DSSDist(mj, n_devices=S, degrees=(1, 3), kappa=2.0,
                     coarse="cg", smoother="schwarz")
    _, jr = jd.solve(b, num_cycles=5)
    return mt, b, np.asarray(jr), jax.tree.map(np.asarray, jd.data)


def test_curved_schwarz_exact(curved_schwarz):
    mt, b, jr, _ = curved_schwarz
    hs = PMGHierarchy(mt, degrees=(1, 3), kappa=2.0, coarse="cg",
                      operator="dss", smoother="schwarz", device="cpu")
    _, rs = hs.solve(torch.tensor(b), num_cycles=5)
    td = tdd.DSSDist(mt, n_devices=S, degrees=(1, 3), kappa=2.0,
                     coarse="cg", smoother="schwarz", device="cpu")
    _, rd = td.solve(b, num_cycles=5)
    assert _traj(rd, jr) < 1e-10
    assert _traj(rd, rs) < 1e-10


def test_curved_schwarz_blocks_from_jax(curved_schwarz):
    """The sliced Schwarz blocks (zero on dummy cells) and the weight from
    the GLOBAL multiplicity equal JAX's."""
    mt, _, _, data = curved_schwarz
    td = tdd.DSSDist(mt, n_devices=S, degrees=(1, 3), kappa=2.0,
                     coarse="cg", smoother="schwarz", device="cpu")
    conv = dss_dist_data_from_numpy(data, td, "cpu", torch.float64)
    for lv, cv in zip(td.data["levels"], conv["levels"]):
        for key in ("V", "ginv", "w"):
            assert _rel(lv["schwarz"][key], cv["schwarz"][key]) < 1e-13, key


def test_graft_case_13_schwarz_cg():
    """`__graft_entry__.py` dry-run case 13: the n=3 L-shape on 8 shards
    with the Schwarz smoother and the cg coarse, against one device."""
    mt, _ = _meshes(3)
    b = assemble_rhs(mt, 3, f_rhs(2.0))
    hs = PMGHierarchy(mt, degrees=(1, 3), kappa=2.0, coarse="cg",
                      operator="dss", smoother="schwarz", device="cpu")
    _, rs = hs.solve(torch.tensor(b), num_cycles=6)
    td = tdd.DSSDist(mt, n_devices=S, degrees=(1, 3), kappa=2.0,
                     coarse="cg", smoother="schwarz", device="cpu")
    _, rd = td.solve(b, num_cycles=6)
    assert _traj(rd, rs) < 1e-10
    assert (td.solve_pcg(b, rtol=1e-8)[1]
            == hs.solve_pcg(torch.tensor(b), rtol=1e-8)[1])


@pytest.mark.parametrize("case", ["smoother", "tensor", "shards3"])
def test_more_options_match_single_device(case):
    """The ``smoother`` coarse solve, a tensor kappa (folded into G) and
    3 shards, each against one device: FCG equal, solution 1e-12."""
    mt, _ = _meshes(2, rotate=3)
    kw = dict(kappa=2.0, coarse="cg")
    shards = S
    if case == "smoother":
        kw["coarse"] = "smoother"
    elif case == "tensor":
        kw["kappa"] = np.array([[2.0, 0.3, 0.1], [0.3, 1.5, 0.2],
                                [0.1, 0.2, 1.0]])
    else:
        shards = 3
    b = assemble_rhs(mt, 3, f_rhs(1.0))
    hs = PMGHierarchy(mt, degrees=(1, 3), operator="dss", device="cpu", **kw)
    us, its = hs.solve_pcg(torch.tensor(b), rtol=1e-9)
    td = tdd.DSSDist(mt, n_devices=shards, degrees=(1, 3), device="cpu",
                     **kw)
    ud, itd = td.solve_pcg(b, rtol=1e-9)
    assert itd == its
    assert _rel(ud, us) < 1e-12


def test_rejects_unsupported():
    mt, _ = _meshes(2)
    with pytest.raises(ValueError, match="amg"):
        tdd.DSSDist(mt, n_devices=S, degrees=(1, 3), coarse="amg",
                    device="cpu")
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh

    with pytest.raises(ValueError, match="Unstructured"):
        tdd.DSSDist(BoxMesh((2, 2, 2)), n_devices=S, device="cpu")
    with pytest.raises(ValueError, match="scalar sigma"):
        tdd.DSSDist(mt, n_devices=S, sigma=lambda x: 1.0 + x[0],
                    device="cpu")
    # devices= names ranks since item 10 (d) ported them
    with pytest.raises(ValueError, match=r"devices=.*rank of each shard"):
        tdd.DSSDist(mt, n_devices=S, devices=["cpu"] * S, device="cpu")
