"""Worker of the port's multi-process tests (not a test module).

Launched ``nprocs`` times by tests/test_torch_multihost.py::

    python torch_multihost_worker.py <init_method> <nprocs> <rank> <out_json> <mode> [<device>]

Each rank brings up a gloo process group with its tensors on ``device``
(default ``cpu``; `parallel.multihost.initialize`), builds the same
solves with ``devices=None`` (the shards span every rank) and writes one
JSON file of results for the parent to compare, as the JAX package's
tests/multihost_worker.py does. ``mode``:

- ``solvers``: JAX's nine multi-host configurations (8 shards), a
  distributed FDM coarse on an explicit ``devices=`` layout that splits
  along y, the slab's default dofmap backend with the distributed hmg
  and the direct coarse, `GridPMG`'s ``lattice_blocked`` backend,
  `DSSDist` on an L-shaped mesh, `GridPMG.solve_refined` and, on 2
  ranks, the Crank-Nicolson heat, leapfrog and CNAB convection-diffusion
  steppers on 2 x 3 slabs;
- ``unit``: every `RankGrid` method against `StackedGrid` on the whole
  stack, for each layout of `unit_layouts`;
- ``cuda``: `run_cuda` on ``device`` (a GPU; the collective buffers
  staged through pinned host memory).

Imports torch, numpy and the port only. Results go to a file (not
stdout), so interleaved log output cannot corrupt them.
"""

import json
import os
import sys
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from pmg_dolfinx_tpu_torch.parallel import multihost  # noqa: E402

KAPPA = 2.0
KDIAG = (1.0, 2.0, 8.0)
KLINE = np.diag([1.0, 1.0, 16.0])
CYCLES = 5


def unit_layouts(nprocs):
    """``(name, shards, devices)`` of the unit checks on ``nprocs`` ranks:
    the default row-major blocks and explicit ``devices=`` maps that put
    the rank boundary on each axis in turn."""
    idx = np.indices((2, 2, 2)).reshape(3, -1)
    if nprocs == 2:
        return [("xyz_default", (2, 2, 2), None),
                ("xyz_split_y", (2, 2, 2), list(idx[1])),
                ("xyz_split_z", (2, 2, 2), list(idx[2])),
                ("slab8", (8, 1, 1), None),
                ("x4y2_default", (4, 2, 1), None)]
    return [("xyz_default", (2, 2, 2), None),
            ("xyz_split_yz", (2, 2, 2), list(2 * idx[1] + idx[2])),
            ("xyz_split_xz", (2, 2, 2), list(2 * idx[0] + idx[2])),
            ("slab8", (8, 1, 1), None),
            ("x4y2_default", (4, 2, 1), None)]


UNIT_METHODS = ("ppermute_x", "ppermute_y", "ppermute_z", "dot", "psum",
                "all_gather", "local_slices", "all_to_all_x",
                "all_to_all_y", "all_to_all_z")


def run_unit(nprocs):
    """The largest difference between each `RankGrid` method's result
    (gathered to the whole stack) and `StackedGrid`'s on the same inputs."""
    from pmg_dolfinx_tpu_torch.parallel.grid2d import StackedGrid

    out = {}
    for name, shards, devices in unit_layouts(nprocs):
        rg = multihost.layout_grid(shards, devices, device="cpu")
        sg = StackedGrid(shards)
        assert rg.block != rg.shards, (name, rg.block)
        loc = (4, 8, 6)                       # local lattice of a shard
        rng = np.random.default_rng(7)
        st = torch.as_tensor(rng.standard_normal(shards + loc))
        w = torch.as_tensor(rng.uniform(0.5, 1.5, shards + loc))
        mine = lambda t: multihost.take_block(t, multihost.AXES, rg)
        whole = lambda t: torch.as_tensor(multihost.fetch_global(t, rg))
        err = {}
        for a, ax in enumerate("xyz"):
            first, last = st.select(3 + a, 0), st.select(3 + a, loc[a] - 1)
            ref = sg.ppermute_planes(first, last, a)
            got = rg.ppermute_planes(mine(first).contiguous(),
                                     mine(last).contiguous(), a)
            err[f"ppermute_{ax}"] = max(
                float((whole(g) - r).abs().max()) for g, r in zip(got, ref))
            # cut another local axis into S chunks
            split = next(k for k in range(3)
                         if k != a and loc[k] % shards[a] == 0)
            ref = sg.all_to_all(st, a, split, a)
            got = rg.all_to_all(mine(st).contiguous(), a, split, a)
            err[f"all_to_all_{ax}"] = float((whole(got) - ref).abs().max())
        d_ref = sg.dot(st, st, w)
        err["dot"] = float(abs(rg.dot(mine(st), mine(st), mine(w)) - d_ref)
                           / d_ref)
        p_ref = sg.psum(st)
        err["psum"] = float((rg.psum(mine(st)) - p_ref).abs().max())
        g_ref = sg.all_gather(st)
        err["all_gather"] = float((rg.all_gather(mine(st).contiguous())
                                   - g_ref).abs().max())
        err["local_slices"] = float((whole(rg.local_slices(g_ref, loc))
                                     - sg.local_slices(g_ref, loc))
                                    .abs().max())
        out[name] = dict(err, block=list(rg.block), origin=list(rg.origin),
                         calls=rg.stats["calls"])
    return out


def _norm(u):
    return float(torch.linalg.vector_norm(torch.as_tensor(u).double()))


def run_solvers(nprocs):
    """JAX's nine multi-host configurations and the port's additions:
    residual lists, FCG counts and solution norms."""
    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh, PerturbedBoxMesh
    from pmg_dolfinx_tpu_torch.fem.unstructured import l_shaped_hex_mesh
    from pmg_dolfinx_tpu_torch.models.poisson import f_rhs, f_rhs_tensor
    from pmg_dolfinx_tpu_torch.parallel.dist import DistPMG
    from pmg_dolfinx_tpu_torch.parallel.dss_dist import DSSDist
    from pmg_dolfinx_tpu_torch.parallel.grid2d import GridPMG

    cpu = dict(device="cpu")
    out = {}
    mesh = BoxMesh((8, 4, 4))
    b = assemble_rhs(mesh, 3, f_rhs(KAPPA))
    dist = DistPMG(mesh, n_devices=8, degrees=(1, 3), kappa=KAPPA,
                   coarse="fdm", operator="kron", **cpu)
    u, out["rn_dist"] = dist.solve(b, num_cycles=CYCLES)
    out["u_d_norm"] = _norm(u)
    u, out["fcg_dist"] = dist.solve_pcg(b, rtol=1e-8)
    out["u_d_pcg_norm"] = _norm(u)
    out["dist_block"] = list(dist.grid.block)

    mesh_g = BoxMesh((4, 4, 4))
    b_g = assemble_rhs(mesh_g, 3, f_rhs(KAPPA))
    grid = GridPMG(mesh_g, shards=(2, 2, 2), degrees=(1, 3), kappa=KAPPA,
                   coarse="cg", **cpu)
    u, out["rn_grid"] = grid.solve(b_g, num_cycles=CYCLES)
    out["u_g_norm"] = _norm(u)
    out["grid_block"] = list(grid.grid.block)

    mesh_l = PerturbedBoxMesh((4, 4, 4))
    b_l = assemble_rhs(mesh_l, 3, f_rhs(KAPPA))
    grid_l = GridPMG(mesh_l, shards=(2, 2, 2), degrees=(1, 3), kappa=KAPPA,
                     coarse="cg", operator="lattice", **cpu)
    _, out["rn_lat"] = grid_l.solve(b_l, num_cycles=CYCLES)

    grid_kb = GridPMG(mesh_g, shards=(2, 2, 2), degrees=(1, 3), kappa=KAPPA,
                      coarse="cg", operator="kron_blocked",
                      dtype=torch.float32, **cpu)
    _, out["rn_kb"] = grid_kb.solve(b_g, num_cycles=CYCLES)

    mesh_h = BoxMesh((4, 8, 4))
    b_h = assemble_rhs(mesh_h, 3, f_rhs(KAPPA))
    grid_h = GridPMG(mesh_h, shards=(2, 2, 2), degrees=(1, 3), kappa=KAPPA,
                     coarse="hmg", coarse_cfg=dict(dist=True), **cpu)
    _, out["rn_hmg"] = grid_h.solve(b_h, num_cycles=CYCLES)

    b_t = assemble_rhs(mesh, 3, f_rhs_tensor(np.diag(KDIAG)))
    dist_t = DistPMG(mesh, n_devices=8, degrees=(1, 3), kappa=KDIAG,
                     coarse="fdm", operator="kron", **cpu)
    _, out["rn_aniso"] = dist_t.solve(b_t, num_cycles=CYCLES)

    b_ln = assemble_rhs(mesh, 3, f_rhs_tensor(KLINE))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dist_ln = DistPMG(mesh, n_devices=8, degrees=(1, 3), kappa=KLINE,
                          coarse="cg", operator="lattice", smoother="line",
                          **cpu)
        _, out["rn_line"] = dist_ln.solve(b_ln, num_cycles=CYCLES)

    # the default dofmap backend: the slab spec's per-cell arrays, the
    # distributed hmg's spec tree and the gathered direct coarse
    mesh_16 = BoxMesh((16, 4, 4))
    dist_h = DistPMG(mesh_16, n_devices=8, degrees=(1, 3), kappa=KAPPA,
                     coarse="hmg", coarse_cfg=dict(dist=True), **cpu)
    _, out["rn_dofmap_hmg"] = dist_h.solve(
        assemble_rhs(mesh_16, 3, f_rhs(KAPPA)), num_cycles=CYCLES)
    dist_dc = DistPMG(mesh, n_devices=8, degrees=(1, 3), kappa=KAPPA,
                      coarse="direct", **cpu)
    _, out["rn_dofmap_direct"] = dist_dc.solve(b, num_cycles=CYCLES)
    # K-A per shard on each rank's block of the quadrature geometry
    grid_lb = GridPMG(mesh_l, shards=(2, 2, 2), degrees=(1, 3), kappa=KAPPA,
                      coarse="cg", operator="lattice_blocked",
                      dtype=torch.float32, **cpu)
    _, out["rn_lat_blocked"] = grid_lb.solve(b_l, num_cycles=CYCLES)

    grid_fd = GridPMG(mesh_g, shards=(2, 2, 2), degrees=(1, 3), kappa=KAPPA,
                      coarse="fdm", coarse_cfg=dict(dist=True), **cpu)
    _, out["rn_fdmdist"] = grid_fd.solve(b_g, num_cycles=CYCLES)

    b_sw = assemble_rhs(mesh_g, 3, f_rhs_tensor(KLINE))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        grid_sw = GridPMG(mesh_g, shards=(2, 2, 2), degrees=(1, 3),
                          kappa=KLINE, coarse="cg", operator="kron",
                          smoother="schwarz", **cpu)
        _, out["rn_schwarz"] = grid_sw.solve(b_sw, num_cycles=CYCLES)

    # The pencil transposes across ranks on y (and z on 4 ranks): an
    # explicit devices= map whose rank boundary is not along x (None in
    # the single-process reference run).
    idx = np.indices((2, 2, 2)).reshape(3, -1)
    ranks = idx[1] if nprocs == 2 else 2 * idx[1] + idx[2]
    grid_fy = GridPMG(mesh_g, shards=(2, 2, 2), degrees=(1, 3), kappa=KAPPA,
                      coarse="fdm", coarse_cfg=dict(dist=True),
                      devices=([int(r) for r in ranks]
                               if multihost.process_count() > 1 else None),
                      **cpu)
    _, out["rn_fdmdist_y"] = grid_fy.solve(b_g, num_cycles=CYCLES)
    out["fdmdist_y_block"] = list(grid_fy.grid.block)

    mesh_u = l_shaped_hex_mesh(2)
    b_u = assemble_rhs(mesh_u, 3, f_rhs(KAPPA))
    dss = DSSDist(mesh_u, n_devices=8, degrees=(1, 3), kappa=KAPPA,
                  coarse="direct", **cpu)
    u, out["rn_dss"] = dss.solve(b_u, num_cycles=CYCLES)
    out["u_dss_norm"] = _norm(u)
    _, out["fcg_dss"] = dss.solve_pcg(b_u, rtol=1e-8)

    if nprocs == 2:
        from pmg_dolfinx_tpu_torch.parallel.transient_dist import (
            convdiff_dist_evolve, heat_dist_evolve,
            wave_leapfrog_dist_evolve)

        mesh_t = BoxMesh((6, 4, 4))
        x = mesh_t.dof_coords(2)
        u0 = np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1]) * np.sin(
            np.pi * x[:, 2])
        ev = heat_dist_evolve(mesh_t, 2, 6, kappa=KAPPA, dt=1e-2,
                              scheme="cn", **cpu)
        out["heat_cn"] = ev(u0, 10).tolist()
        # the forward-apply bundle and the advection masses, cut per rank
        ev = wave_leapfrog_dist_evolve(mesh_t, 2, 6, kappa=KAPPA, dt=2e-3,
                                       **cpu)
        out["leapfrog"] = torch.cat(ev(u0, 0.0 * u0, 10)).tolist()
        ev = convdiff_dist_evolve(mesh_t, 2, 6, (1.0, 0.5, 0.25),
                                  kappa=KAPPA, dt=1e-3, scheme="cnab", **cpu)
        out["convdiff_cnab"] = ev(u0, 10).tolist()

    # mixed-precision refinement: the f64 residual's dot across ranks
    grid_r = GridPMG(mesh_g, shards=(2, 2, 2), degrees=(1, 3), kappa=KAPPA,
                     coarse="fdm", operator="kron", dtype=torch.float32,
                     **cpu)
    _, out["rn_refined"] = grid_r.solve_refined(b_g, num_cycles=4)
    return out


CUDA_KEYS = ("rn_slab_kb", "rn_grid_kb", "rn_dofmap_direct")


def run_cuda(device):
    """The ``kron_blocked`` slab (kernels #1-#3) and grid (#1 and #9,
    ``fdm`` dist coarse) and the default dofmap slab with the direct
    coarse, every tensor on ``device``: the set-up arrays built on the
    host and placed per rank off the CPU. Residual lists, where the
    solution lives and whether the grid stages its buffers."""
    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import f_rhs
    from pmg_dolfinx_tpu_torch.parallel.dist import DistPMG
    from pmg_dolfinx_tpu_torch.parallel.grid2d import GridPMG

    kw = dict(degrees=(1, 3), kappa=KAPPA, device=device)
    f32 = dict(kw, operator="kron_blocked", dtype=torch.float32)
    out = {}
    mesh = BoxMesh((8, 4, 4))
    b = assemble_rhs(mesh, 3, f_rhs(KAPPA))
    slab = DistPMG(mesh, n_devices=8, coarse="fdm", **f32)
    u, out["rn_slab_kb"] = slab.solve(b, num_cycles=CYCLES)
    out["u_device"] = u.device.type
    out["staged"] = bool(getattr(slab.grid, "staged", False))
    mesh_g = BoxMesh((4, 4, 4))
    grid = GridPMG(mesh_g, (2, 2, 2), coarse="fdm",
                   coarse_cfg=dict(dist=True), **f32)
    _, out["rn_grid_kb"] = grid.solve(assemble_rhs(mesh_g, 3, f_rhs(KAPPA)),
                                      num_cycles=CYCLES)
    dofmap = DistPMG(mesh, n_devices=8, coarse="direct", **kw)
    _, out["rn_dofmap_direct"] = dofmap.solve(b, num_cycles=CYCLES)
    return out


def main():
    init, nprocs, rank, path, mode = sys.argv[1:6]
    device = sys.argv[6] if len(sys.argv) > 6 else "cpu"
    nprocs, rank = int(nprocs), int(rank)
    torch.set_num_threads(2)
    multihost.initialize(init, nprocs, rank, backend="gloo", device=device,
                         timeout_s=120)
    assert multihost.process_count() == nprocs
    assert multihost.process_index() == rank
    run = dict(unit=run_unit, solvers=run_solvers,
               cuda=lambda n: run_cuda(device))[mode]
    res = run(nprocs)
    res["rank"] = rank
    with open(path, "w") as f:
        json.dump(res, f)
    multihost.shutdown()


if __name__ == "__main__":
    main()
