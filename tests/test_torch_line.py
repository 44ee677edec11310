"""The port's line smoother (`solvers/line.py`) against the JAX package.

- `line_block_inverses` (every axis, sigma 0 and 0.5, box and curved
  meshes) equals JAX's to 1e-13 relative; the size guard fires before
  the assembly; `shard_line_blocks` and `parse_line_smoother` equal JAX's;
- `line_precond_apply` on flat and lattice-shaped vectors equals JAX's
  to 1e-12 (f64);
- `PMGHierarchy(smoother="line-z" | "line")` on the ``kron``, ``lattice``
  and ``dofmap`` backends (f64): eigenvalue estimates to 1e-12, the
  6-cycle trajectory to 1e-10 relative, the FCG(V) count equal;
- `GridPMG(smoother="line-z")` on a (2, 2, 1) grid against JAX's and the
  port's single device (f64), and its refusal of a sharded line axis.
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
from pmg_dolfinx_tpu.solvers import line as jl  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh as TBox  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh as TPert  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers import line as tl  # noqa: E402


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else (
        np.asarray(a))


def _rel_max(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b) / np.abs(b))


@pytest.mark.parametrize("curved", [False, True])
@pytest.mark.parametrize("sigma", [0.0, 0.5])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_line_block_inverses_match_jax(axis, sigma, curved):
    nc, P = (3, 2, 4), 2
    tm, jm = (TPert(nc), JPert(nc)) if curved else (TBox(nc), JBox(nc))
    bt = tl.line_block_inverses(tm, P, 2.0, axis, sigma=sigma)
    bj = jl.line_block_inverses(jm, P, 2.0, axis, sigma=sigma)
    assert bt.shape == bj.shape == (tm.num_dofs(P) // tm.lattice_shape(P)[
        axis], tm.lattice_shape(P)[axis], tm.lattice_shape(P)[axis])
    assert _rel_max(bt, bj) <= 1e-13


def test_line_block_guard_runs_before_assembly(monkeypatch):
    from pmg_dolfinx_tpu_torch.fem import assembly

    def boom(*a, **k):
        raise AssertionError("assembled an oversized problem")

    monkeypatch.setattr(tl, "LINE_BLOCK_DOF_LIMIT", 100)
    monkeypatch.setattr(assembly, "assemble_stiffness", boom)
    with pytest.raises(ValueError, match="line smoother blocks would hold"):
        tl.line_block_inverses(TBox((2, 2, 2)), 2, 2.0, 0)
    assert tl.LINE_BLOCK_DOF_LIMIT == 100 and jl.LINE_BLOCK_DOF_LIMIT == (
        200_000_000)


@pytest.mark.parametrize("flat", [True, False])
@pytest.mark.parametrize("axis", [0, 2])
def test_line_precond_apply_matches_jax(axis, flat):
    nc, P = (2, 3, 2), 2
    mesh = TBox(nc)
    shape = mesh.lattice_shape(P)
    blocks = tl.line_block_inverses(mesh, P, 2.0, axis)
    r = np.random.default_rng(axis).standard_normal(mesh.num_dofs(P))
    if not flat:
        r = r.reshape(shape)
    yt = tl.line_precond_apply(torch.from_numpy(blocks), torch.from_numpy(r),
                               shape, axis)
    yj = jl.line_precond_apply(jnp.asarray(blocks), jnp.asarray(r), shape,
                               axis)
    assert tuple(yt.shape) == r.shape
    assert _rel_max(yt, yj) <= 1e-12


def test_shard_line_blocks_and_parse_match_jax():
    from pmg_dolfinx_tpu.parallel.grid2d import GridPartition

    nc, P, axis = (4, 4, 2), 1, 2
    blocks = tl.line_block_inverses(TBox(nc), P, 2.0, axis)
    part = GridPartition(JBox(nc), (2, 2, 1))
    starts = [part._axis_starts(P, a) for a in (0, 1)]
    gshape = TBox(nc).lattice_shape(P)
    assert np.array_equal(tl.shard_line_blocks(blocks, gshape, axis, starts),
                          jl.shard_line_blocks(blocks, gshape, axis, starts))
    assert np.array_equal(
        tl.shard_line_blocks(blocks, gshape, axis, [None, starts[1]]),
        jl.shard_line_blocks(blocks, gshape, axis, [None, starts[1]]))
    stretched = dict(nc=(4, 4, 8), extent=(1.0, 1.0, 0.25))
    for spec in ("cheb", None, "line", "line-x", "line-y", "line-z"):
        for kw, allowed in ((dict(nc=(3, 3, 3)), None),
                            (dict(nc=(3, 3, 3)), (2,)), (stretched, (0, 1))):
            assert tl.parse_line_smoother(spec, TBox(**kw), 2.0, allowed) == (
                jl.parse_line_smoother(spec, JBox(**kw), 2.0, allowed))
    with pytest.raises(ValueError, match="unknown hmg smoother"):
        tl.parse_line_smoother("line-w", TBox((2, 2, 2)), 2.0)


@pytest.mark.parametrize("operator,smoother,coarse,sigma", [
    ("kron", "line-z", "fdm", 0.0),
    ("kron", "line", "cg", 0.5),
    ("lattice", "line-x", "cg", 0.0),
    ("dofmap", "line-y", "direct", 0.0),
])
def test_pmg_line_smoother_f64_matches_jax(operator, smoother, coarse, sigma):
    from pmg_dolfinx_tpu.models.poisson import PoissonProblem as JP
    from pmg_dolfinx_tpu_torch.models.poisson import PoissonProblem as TP

    nc = (3, 4, 5)
    kw = dict(degrees=(1, 3), kappa=2.0, coarse=coarse, operator=operator,
              sigma=sigma, smoother=smoother)
    jp = JP(dtype=jnp.float64, mesh=JBox(nc), **kw)
    tp = TP(dtype=torch.float64, device="cpu", mesh=TBox(nc), **kw)
    assert tp.hierarchy.levels[-1].line_axis == jp.hierarchy.levels[-1].line_axis
    assert tp.hierarchy.levels[-1].shape == jp.hierarchy.levels[-1].shape
    for lv_t, lv_j in zip(tp.hierarchy.data["levels"],
                          jp.hierarchy.data["levels"]):
        assert _rel_max(lv_t["line_inv"], lv_j["line_inv"]) <= 1e-13
    for et, ej in zip(tp.hierarchy.eigs, jp.hierarchy.eigs):
        assert _rel(et, ej) <= 1e-12
    _, rj = jp.solve(num_cycles=6)
    _, rt = tp.solve(num_cycles=6)
    assert _rel(rt, rj) <= 1e-10
    _, nj = jp.hierarchy.solve_pcg(jp.b, rtol=1e-6)
    _, nt = tp.hierarchy.solve_pcg(tp.b, rtol=1e-6)
    assert nt == nj


def test_grid_line_matches_jax_and_single_device():
    from pmg_dolfinx_tpu.parallel import grid2d as jg
    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu_torch.models.poisson import f_rhs
    from pmg_dolfinx_tpu_torch.parallel import grid2d as tg
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    nc, shards = (4, 4, 4), (2, 2, 1)
    b = assemble_rhs(TBox(nc), 3, f_rhs(2.0))
    kw = dict(degrees=(1, 3), smoother="line-z", coarse="cg")
    grid = tg.GridPMG(TBox(nc), shards, dtype=torch.float64, device="cpu",
                      **kw)
    assert grid.data["levels"][-1]["line_inv"].shape == (2, 2, 1, 7, 7, 13,
                                                         13)
    hier = PMGHierarchy(TBox(nc), dtype=torch.float64, device="cpu", **kw)
    jgrid = jg.GridPMG(JBox(nc), shards, dtype=jnp.float64, **kw)
    for e_t, e_h, e_j in zip(grid.eigs, hier.eigs, jgrid.eigs):
        assert _rel(e_t, e_j) <= 1e-12 and _rel(e_t, e_h) <= 1e-12
    u, rn = grid.solve(b, num_cycles=4)
    _, rh = hier.solve(b, num_cycles=4)
    uj, rj = jgrid.solve(jnp.asarray(b), num_cycles=4)
    assert _rel(rn, rj) <= 1e-10 and _rel(rn, rh) <= 1e-10
    assert _rel_max(u, uj) <= 1e-10
    assert grid.solve_pcg(b, rtol=1e-6)[1] == jgrid.solve_pcg(
        jnp.asarray(b), rtol=1e-6)[1]
    with pytest.raises(ValueError, match="lines must not span shards"):
        tg.GridPMG(TBox(nc), (2, 2, 2), degrees=(1, 2), smoother="line-z",
                   device="cpu")


def test_line_and_fused_smoother_refuse_together():
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    for smoother in ("line", "schwarz"):
        with pytest.raises(ValueError, match="fuse_smoother"):
            PMGHierarchy(TBox((2, 2, 2)), degrees=(1, 2), smoother=smoother,
                         operator="kron_blocked", dtype=torch.float32,
                         fuse_smoother=True, device="cpu")
