"""The port's multi-process backend (`parallel.multihost`): the sharded
solvers across ranks under gloo on the CPU.

Each case launches tests/torch_multihost_worker.py on 2 ranks (blocks of
4 shards) and on 4 ranks (blocks of 2), every rank a process with a gloo
process group, the same 8-shard solves as JAX's tests/multihost_worker.py
plus a distributed FDM coarse on an explicit ``devices=`` map whose rank
boundary is along y (the pencil transposes cross ranks there), the
slab's default dofmap backend with the distributed hmg and the direct
coarse, `GridPMG`'s ``lattice_blocked`` backend, `DSSDist` on an
L-shaped mesh, `GridPMG.solve_refined`, and the Crank-Nicolson heat,
leapfrog and CNAB convection-diffusion steppers on 2 x 3 slabs. The runs
must match:

- each other, rank for rank (the same trajectories on every rank);
- the port's single-process run with every shard stacked (f64 to
  1e-10, the f32 ``kron_blocked`` and ``lattice_blocked`` runs to 5e-4 as
  JAX's own test allows: the cross-rank sums change the reduction
  order);
- JAX's single-process run on the 8 virtual CPU devices of
  tests/conftest.py, with the same tolerances (all but the
  ``lattice_blocked`` run, which the stacked run holds).

The worker's ``unit`` mode holds every `RankGrid` method, gathered to
the whole stack, to `StackedGrid`'s on five layouts per rank count
(default blocks and explicit maps with the rank boundary on each axis).
The ``devices=`` resolution and its ValueErrors, and the single-process
behaviour with no process group, are checked here in one process. On a
GPU (marked ``cuda``) two ranks hold their tensors on ``cuda:0`` and are
held to the same solves stacked on the card.

Every worker runs with two torch threads and a 120 s gloo timeout, and
the ``communicate`` calls share one deadline, so a hang fails the
fixture within it and leaves the rest of the suite its time.
"""

import json
import os
import socket
import subprocess
import sys
import time
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(__file__))

import torch_multihost_worker as worker  # noqa: E402
from pmg_dolfinx_tpu_torch.parallel import multihost  # noqa: E402
from pmg_dolfinx_tpu_torch.parallel.grid2d import AXES, StackedGrid  # noqa: E402

_WORKER = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")
_LIMIT_S = 300      # all the workers together; they take ~40 s alone
NPROCS = (2, 4)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(nprocs, mode, outdir, device="cpu"):
    init = f"tcp://localhost:{_free_port()}"
    paths = [str(outdir / f"{mode}_{nprocs}_{r}.json") for r in range(nprocs)]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, init, str(nprocs), str(r), paths[r], mode,
         device],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=os.path.dirname(_WORKER)) for r in range(nprocs)]
    return procs, paths


def _collect(procs, paths, deadline):
    for p in procs:
        out, err = p.communicate(
            timeout=max(1.0, deadline - time.monotonic()))
        if p.returncode != 0:
            raise RuntimeError(f"worker rc={p.returncode}:\n{out[-2000:]}"
                               f"\n{err[-4000:]}")
    res = []
    for path in paths:
        with open(path) as f:
            res.append(json.load(f))
    return sorted(res, key=lambda r: r["rank"])


def _stop(procs):
    """Kill any of ``procs`` still running."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def _jax_runs():
    """JAX's single-process 8-device runs of the worker's solves."""
    import jax.numpy as jnp

    from pmg_dolfinx_tpu.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu.fem.mesh import BoxMesh, PerturbedBoxMesh
    from pmg_dolfinx_tpu.fem.unstructured import l_shaped_hex_mesh
    from pmg_dolfinx_tpu.models.poisson import f_rhs, f_rhs_tensor
    from pmg_dolfinx_tpu.parallel.dist import DistPMG
    from pmg_dolfinx_tpu.parallel.dss_dist import DSSDist
    from pmg_dolfinx_tpu.parallel.grid2d import GridPMG

    K, C = worker.KAPPA, worker.CYCLES
    out = {}
    mesh = BoxMesh((8, 4, 4))
    b = assemble_rhs(mesh, 3, f_rhs(K))
    u, out["rn_dist"] = DistPMG(mesh, n_devices=8, degrees=(1, 3), kappa=K,
                                coarse="fdm", operator="kron").solve(
                                    b, num_cycles=C)
    out["u_d_norm"] = float(np.linalg.norm(np.asarray(u)))
    mesh_g = BoxMesh((4, 4, 4))
    b_g = assemble_rhs(mesh_g, 3, f_rhs(K))
    u, out["rn_grid"] = GridPMG(mesh_g, shards=(2, 2, 2), degrees=(1, 3),
                                kappa=K, coarse="cg").solve(b_g,
                                                            num_cycles=C)
    out["u_g_norm"] = float(np.linalg.norm(np.asarray(u)))
    mesh_l = PerturbedBoxMesh((4, 4, 4))
    b_l = assemble_rhs(mesh_l, 3, f_rhs(K))
    _, out["rn_lat"] = GridPMG(mesh_l, shards=(2, 2, 2), degrees=(1, 3),
                               kappa=K, coarse="cg",
                               operator="lattice").solve(b_l, num_cycles=C)
    _, out["rn_kb"] = GridPMG(mesh_g, shards=(2, 2, 2), degrees=(1, 3),
                              kappa=K, coarse="cg", operator="kron_blocked",
                              dtype=jnp.float32).solve(b_g, num_cycles=C)
    mesh_h = BoxMesh((4, 8, 4))
    b_h = assemble_rhs(mesh_h, 3, f_rhs(K))
    _, out["rn_hmg"] = GridPMG(mesh_h, shards=(2, 2, 2), degrees=(1, 3),
                               kappa=K, coarse="hmg",
                               coarse_cfg=dict(dist=True)).solve(
                                   b_h, num_cycles=C)
    b_t = assemble_rhs(mesh, 3, f_rhs_tensor(np.diag(worker.KDIAG)))
    _, out["rn_aniso"] = DistPMG(mesh, n_devices=8, degrees=(1, 3),
                                 kappa=worker.KDIAG, coarse="fdm",
                                 operator="kron").solve(b_t, num_cycles=C)
    b_ln = assemble_rhs(mesh, 3, f_rhs_tensor(worker.KLINE))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, out["rn_line"] = DistPMG(
            mesh, n_devices=8, degrees=(1, 3), kappa=worker.KLINE,
            coarse="cg", operator="lattice", smoother="line").solve(
                b_ln, num_cycles=C)
    _, out["rn_fdmdist"] = GridPMG(mesh_g, shards=(2, 2, 2), degrees=(1, 3),
                                   kappa=K, coarse="fdm",
                                   coarse_cfg=dict(dist=True)).solve(
                                       b_g, num_cycles=C)
    # the explicit devices= map changes which rank holds a shard, not the
    # program: JAX's run is the same solve
    out["rn_fdmdist_y"] = out["rn_fdmdist"]
    mesh_16 = BoxMesh((16, 4, 4))
    _, out["rn_dofmap_hmg"] = DistPMG(
        mesh_16, n_devices=8, degrees=(1, 3), kappa=K, coarse="hmg",
        coarse_cfg=dict(dist=True)).solve(assemble_rhs(mesh_16, 3, f_rhs(K)),
                                          num_cycles=C)
    _, out["rn_dofmap_direct"] = DistPMG(mesh, n_devices=8, degrees=(1, 3),
                                         kappa=K, coarse="direct").solve(
                                             b, num_cycles=C)
    b_sw = assemble_rhs(mesh_g, 3, f_rhs_tensor(worker.KLINE))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, out["rn_schwarz"] = GridPMG(
            mesh_g, shards=(2, 2, 2), degrees=(1, 3), kappa=worker.KLINE,
            coarse="cg", operator="kron", smoother="schwarz").solve(
                b_sw, num_cycles=C)
    mesh_u = l_shaped_hex_mesh(2)
    b_u = assemble_rhs(mesh_u, 3, f_rhs(K))
    u, out["rn_dss"] = DSSDist(mesh_u, n_devices=8, degrees=(1, 3), kappa=K,
                               coarse="direct").solve(b_u, num_cycles=C)
    out["u_dss_norm"] = float(np.linalg.norm(np.asarray(u)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The workers' results (solvers and unit mode, 2 and 4 ranks, all
    launched at once) with the port's stacked run and JAX's run, made
    while the workers run."""
    outdir = tmp_path_factory.mktemp("torch_multihost")
    launched = {(n, mode): _launch(n, mode, outdir)
                for n in NPROCS for mode in ("solvers", "unit")}
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(2)
        stacked = worker.run_solvers(2)
        jax_ref = _jax_runs()
    finally:
        torch.set_num_threads(threads)
        deadline = time.monotonic() + _LIMIT_S
        try:
            got = {key: _collect(*pl, deadline)
                   for key, pl in launched.items()}
        finally:     # a failed or late group: stop every worker
            for procs, _ in launched.values():
                _stop(procs)
    return dict(got=got, stacked=stacked, jax=jax_ref)


_STEPPERS = ("heat_cn", "leapfrog", "convdiff_cnab")   # 2 x 3 slabs only


def _keys(nprocs):
    keys = [k for k in worker_keys() if not (k in _STEPPERS and nprocs == 4)]
    return [(nprocs, k) for k in keys]


def worker_keys():
    return ("rn_dist", "u_d_norm", "fcg_dist", "u_d_pcg_norm", "rn_grid",
            "u_g_norm", "rn_lat", "rn_kb", "rn_hmg", "rn_aniso", "rn_line",
            "rn_fdmdist", "rn_schwarz", "rn_fdmdist_y", "rn_dofmap_hmg",
            "rn_dofmap_direct", "rn_lat_blocked", "rn_dss", "u_dss_norm",
            "fcg_dss", "rn_refined") + _STEPPERS


_CASES = _keys(2) + _keys(4)
_IDS = [f"{n}procs-{k}" for n, k in _CASES]


def _rtol(key):
    # f32 V-cycles (kron_blocked, lattice_blocked; the refinement's inner
    # cycles): the cross-rank sums change the reduction order
    return 5e-4 if key in ("rn_kb", "rn_refined", "rn_lat_blocked",
                           "rn_slab_kb", "rn_grid_kb") else 1e-10


@pytest.mark.parametrize("nprocs,key", _CASES, ids=_IDS)
def test_ranks_match_each_other(runs, nprocs, key):
    res = runs["got"][(nprocs, "solvers")]
    assert len(res) == nprocs
    for r in res[1:]:
        np.testing.assert_allclose(r[key], res[0][key], rtol=1e-12, atol=0)


@pytest.mark.parametrize("nprocs,key", _CASES, ids=_IDS)
def test_ranks_match_single_process(runs, nprocs, key):
    """Process-count invariance: every rank's result equals the port's
    single-process run with all 8 shards stacked on one device."""
    got = runs["got"][(nprocs, "solvers")][0][key]
    ref = runs["stacked"][key]
    if key.startswith("fcg"):
        assert got == ref
    else:
        np.testing.assert_allclose(got, ref, rtol=_rtol(key), atol=0)


_JAX_KEYS = ("rn_dist", "u_d_norm", "rn_grid", "u_g_norm", "rn_lat", "rn_kb",
             "rn_hmg", "rn_aniso", "rn_line", "rn_fdmdist", "rn_schwarz",
             "rn_fdmdist_y", "rn_dofmap_hmg", "rn_dofmap_direct", "rn_dss",
             "u_dss_norm")


@pytest.mark.parametrize("nprocs", NPROCS, ids=["2procs", "4procs"])
@pytest.mark.parametrize("key", _JAX_KEYS)
def test_ranks_match_jax(runs, nprocs, key):
    """The ranks' runs against JAX's single-process 8-device run."""
    got = runs["got"][(nprocs, "solvers")][0][key]
    np.testing.assert_allclose(got, runs["jax"][key], rtol=_rtol(key),
                               atol=0)


@pytest.mark.parametrize("nprocs", NPROCS, ids=["2procs", "4procs"])
def test_blocks_follow_the_rank_layout(runs, nprocs):
    """``devices=None`` spans every rank in row-major blocks (JAX's
    ``np.array(devices).reshape(shards)``); the explicit map splits y."""
    r = runs["got"][(nprocs, "solvers")][0]
    assert r["dist_block"] == [8 // nprocs, 1, 1]
    assert r["grid_block"] == ([1, 2, 2] if nprocs == 2 else [1, 1, 2])
    assert r["fdmdist_y_block"] == ([2, 1, 2] if nprocs == 2 else [2, 1, 1])


_UNIT = [(n, name, m) for n in NPROCS
         for name, _, _ in worker.unit_layouts(n)
         for m in worker.UNIT_METHODS]


@pytest.mark.parametrize("nprocs,layout,method", _UNIT,
                         ids=[f"{n}procs-{l}-{m}" for n, l, m in _UNIT])
def test_rank_grid_method(runs, nprocs, layout, method):
    """A `RankGrid` method on each rank's block, gathered, against
    `StackedGrid` on the whole stack: exact for the data movements, to
    rounding for the sums (their order changes)."""
    for r in runs["got"][(nprocs, "unit")]:
        tol = 1e-14 if method in ("dot", "psum") else 0.0
        assert r[layout][method] <= tol, (r["rank"], r[layout])


def test_unit_layouts_cross_every_axis():
    """The unit layouts put a rank boundary on every grid axis."""
    for n in NPROCS:
        crossed = set()
        for _, shards, devices in worker.unit_layouts(n):
            ranks, block = multihost.rank_layout(shards, devices,
                                                 world_size=n)
            crossed |= {a for a in range(3) if block[a] < shards[a]}
            assert ranks.max() == n - 1
        assert crossed == {0, 1, 2}


# -- devices= resolution, one process ------------------------------------


@pytest.mark.parametrize("shards,world,block", [
    ((2, 2, 2), 2, (1, 2, 2)), ((2, 2, 2), 4, (1, 1, 2)),
    ((8, 1, 1), 2, (4, 1, 1)), ((6, 1, 1), 2, (3, 1, 1)),
    ((4, 2, 1), 2, (2, 2, 1)), ((2, 2, 2), 8, (1, 1, 1))])
def test_rank_layout_default_blocks(shards, world, block):
    ranks, got = multihost.rank_layout(shards, None, world_size=world)
    assert got == block
    assert ranks.reshape(-1).tolist() == sorted(ranks.reshape(-1).tolist())


@pytest.mark.parametrize("shards,devices,world,match", [
    ((2, 2, 2), None, 3, "do not split"),
    ((2, 3, 2), None, 3, "not a box"),
    ((2, 2, 2), [0, 1, 1, 0, 0, 1, 1, 0], 2, "not a sub-box"),
    ((4, 2, 1), [0, 0, 0, 0, 1, 2, 1, 2], 3, "differ in shape"),
    ((2, 2, 2), [0] * 4 + [2] * 4, 3, "every rank"),
    ((2, 2, 2), [0, 1], 2, "one rank per shard")],
    ids=["count", "run-not-box", "not-sub-box", "unequal", "missing",
         "length"])
def test_rank_layout_value_errors(shards, devices, world, match):
    with pytest.raises(ValueError, match=match):
        multihost.rank_layout(shards, devices, world_size=world)


def test_no_process_group_is_the_stacked_layout():
    """Without a process group: rank 0 of 1, ``devices=None`` (or every
    shard on rank 0) is `StackedGrid`, any other rank a ValueError, and
    the solvers' grids are the stacked ones, as before."""
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.parallel.dist import DistPMG
    from pmg_dolfinx_tpu_torch.parallel.grid2d import GridPMG

    assert not multihost.is_up()
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    for devices in (None, [0] * 8):
        g = multihost.layout_grid((2, 2, 2), devices, device="cpu")
        assert type(g) is StackedGrid and g.block == (2, 2, 2)
    with pytest.raises(ValueError, match="no process group"):
        multihost.layout_grid((2, 2, 2), [0, 1] * 4, device="cpu")
    with pytest.raises(ValueError, match="one rank per shard"):
        multihost.layout_grid((2, 2, 2), [0] * 4, device="cpu")
    grid = GridPMG(BoxMesh((4, 4, 4)), (2, 2, 2), degrees=(1, 2),
                   device="cpu")
    assert type(grid.grid) is StackedGrid
    dist = DistPMG(BoxMesh((4, 2, 2)), n_devices=2, degrees=(1, 2),
                   operator="kron", device="cpu")
    assert type(dist.grid) is StackedGrid and dist.grid.block == (2, 1, 1)


@pytest.mark.parametrize("spec,shape,want", [
    (AXES, (2, 2, 2, 3), (slice(1, 2), slice(0, 2), slice(0, 2))),
    (("x",), (8, 5), (slice(4, 8),)),
    (("x", "x"), (8, 8), (slice(4, 8), slice(4, 8))),
    ((None, "x"), (3, 8), (slice(None), slice(4, 8))),
    ((), (8, 5), ())], ids=["axes", "rows", "rows-cols", "cols", "repl"])
def test_take_block(spec, shape, want):
    """`take_block` keeps the block's chunks of every stacked dim (the
    second rank of 2 on a (2, 2, 2) grid: origin (1, 0, 0))."""
    g = types.SimpleNamespace(shards=(2, 2, 2), block=(1, 2, 2),
                              origin=(1, 0, 0))
    a = np.arange(int(np.prod(shape))).reshape(shape)
    np.testing.assert_array_equal(multihost.take_block(a, spec, g), a[want])
    t = multihost.put_global(a, g, spec, device="cpu")
    assert isinstance(t, torch.Tensor) and t.is_contiguous()
    np.testing.assert_array_equal(t.numpy(), a[want])


def test_put_and_fetch_global_on_the_stacked_layout():
    g = StackedGrid((2, 2, 2))
    a = np.random.default_rng(0).standard_normal((2, 2, 2, 3))
    t = multihost.put_global(a, g, device="cpu")
    np.testing.assert_array_equal(multihost.fetch_global(t, g), a)


def test_put_global_defaults_to_the_card():
    """With no process group (no rank device recorded) and no
    ``device=``, `put_global` targets CUDA, as every entry point of the
    port does: it never returns a CPU tensor unasked (without a GPU the
    upload raises)."""
    assert multihost.rank_device() is None
    a = np.arange(8.0).reshape(2, 4)
    g = StackedGrid((2, 1, 1))
    if torch.cuda.is_available():
        assert multihost.put_global(a, g).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            multihost.put_global(a, g)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the ranks' tensors live on it)")
    return "cuda:0"


@pytest.mark.cuda
def test_two_ranks_on_one_card(cuda_device, tmp_path):
    """Two gloo ranks with their tensors on ``cuda:0`` (the collective
    buffers staged through pinned host memory): each builds the set-up
    arrays on the host and uploads its block, runs kernels #1-#3 (slab)
    and #1 / #9 (grid) on it, and matches the same solves with every
    shard stacked on the card."""
    ref = worker.run_cuda(cuda_device)      # builds the kernels first
    procs, paths = _launch(2, "cuda", tmp_path, device=cuda_device)
    try:
        res = _collect(procs, paths, time.monotonic() + _LIMIT_S)
    finally:
        _stop(procs)
    assert ref["u_device"] == "cuda" and not ref["staged"]
    for r in res:
        assert r["u_device"] == "cuda" and r["staged"]
        for key in worker.CUDA_KEYS:
            np.testing.assert_allclose(r[key], ref[key], rtol=_rtol(key),
                                       atol=0)
