"""Weak/strong sweep over stacked shard counts of the PyTorch/CUDA port (the
twin of `examples/scaling.py`).

    python examples/scaling_torch.py [--device cpu] [--ndofs N]
        [--mode strong|weak] [--degrees 1 3]
        [--operator dofmap|lattice|lattice_blocked|kron|kron_blocked]
        [--coarse cg|smoother|fdm|direct|hmg] [--dist-coarse]
        [--bottom direct|cg|smoother|fdm] [--smoother cheb|line-y|schwarz]
        [--max-devices 8]
    python examples/scaling_torch.py --grid [...]

The default is the 1D slab sweep: `parallel.dist.DistPMG` on 1, 2, 4, 8
slabs (those at most ``--max-devices``), with JAX's mesh rule (strong
mode: one mesh whose x cells divide by the largest count; weak mode:
``--ndofs`` per slab) and JAX's invariance line (strong mode: the
residual trajectory equals the 1-slab one, rtol 1e-9 in f64, 1e-3 in
f32). ``--grid`` sweeps `parallel.grid2d.GridPMG` on ONE fixed mesh for
the shard layouts 1x1x1, 2x1x1, 2x2x1, 2x2x2, 4x2x2, 4x4x2 (operators
kron, kron_blocked, lattice and lattice_blocked; the last runs K-A once
per shard). ``--coarse hmg`` is the h-multigrid coarse solve
(``--bottom`` its bottom), ``--dist-coarse`` its non-gathered form
(``coarse_cfg=dict(dist=True)``: every h-level in the sharded layout, the
hierarchy pinned by JAX's ``divisors`` so the trajectory stays invariant
in the shard count; ``--bottom fdm`` makes it gather-free) or, with
``--coarse fdm``, the pencil-transpose distributed FDM. Each row prints the setup seconds, the seconds per
stationary V-cycle and the final relative residual; in strong mode the
counts share one mesh, so only the first count's setup computes its
host geometry factors.

Every count's or layout's shards are stacked on ONE device (the port's
single-device backend of the SPMD program), so the s/cycle column
measures the cost of the decomposition on one card, NOT a scaling
measurement: there is no second device. The last line is a JSON object
with every row.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LAYOUTS = [(1, 1, 1), (2, 1, 1), (2, 2, 1), (2, 2, 2), (4, 2, 2),
           (4, 4, 2)]


def main():
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--grid", action="store_true",
                   help="sweep multi-axis (x,y,z) GridPMG layouts instead "
                        "of the 1D slab")
    p.add_argument("--mode", choices=["weak", "strong"], default="strong")
    p.add_argument("--ndofs", type=int, default=50000,
                   help="target number of dofs (global; per slab in weak "
                        "mode)")
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument("--operator",
                   choices=["dofmap", "lattice", "lattice_blocked", "kron",
                            "kron_blocked"],
                   default="kron")
    p.add_argument("--kappa", type=float, default=2.0)
    p.add_argument("--degrees", type=int, nargs="+", default=[1, 3])
    p.add_argument("--cycles", type=int, default=5)
    p.add_argument("--max-devices", type=int, default=0,
                   help="largest shard count (default 8)")
    p.add_argument("--coarse", choices=["cg", "smoother", "fdm", "direct",
                                        "hmg"], default="cg")
    p.add_argument("--dist-coarse", action="store_true",
                   help="with --coarse hmg/fdm: the distributed (non-"
                        "gathered) coarse solve (coarse_cfg dist=True; "
                        "fdm = pencil-transpose distributed direct "
                        "solve, parallel/fdm_dist.py)")
    p.add_argument("--bottom", choices=["direct", "cg", "smoother", "fdm"],
                   default="direct",
                   help="h-MG bottom solve (coarse_cfg['bottom']); "
                        "'fdm' needs --dist-coarse and makes the whole "
                        "hierarchy gather-free")
    p.add_argument("--smoother", type=str, default="cheb",
                   help="p-level smoother preconditioner: 'cheb' (point "
                        "Jacobi), 'line'/'line-x|y|z' (unsharded axis "
                        "only), or 'schwarz' (any layout)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default 'cuda')")
    args = p.parse_args()

    import numpy as np
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False")
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    sync = ((lambda: torch.cuda.synchronize(device))
            if device.type == "cuda" else (lambda: None))
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    sweep = _grid_sweep if args.grid else _slab_sweep
    rows, info = sweep(args, np, device, dtype, sync, name)
    print(json.dumps(dict(device=name, operator=args.operator,
                          coarse=args.coarse, dist_coarse=args.dist_coarse,
                          bottom=args.bottom, smoother=args.smoother,
                          dtype=args.dtype, mode=args.mode, rows=rows,
                          **info)))


def _coarse_cfg(args, divisors):
    """JAX's ``coarse_cfg`` of the sweep: the distributed h-hierarchy
    pinned by ``divisors`` across shard counts (its depth depends on the
    alignment constraint), the distributed FDM, or the gathered hmg's
    bottom."""
    if args.dist_coarse and args.coarse == "hmg":
        return dict(dist=True, bottom=args.bottom, divisors=divisors)
    if args.dist_coarse:
        return dict(dist=True)
    if args.coarse == "hmg":
        return dict(bottom=args.bottom)
    return None


def _slab_sweep(args, np, device, dtype, sync, name):
    """The 1D slab sweep over 1, 2, 4, 8, ... stacked slabs."""
    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import f_rhs, fit_box_cells
    from pmg_dolfinx_tpu_torch.parallel.dist import DistPMG

    n_max = args.max_devices or 8
    counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_max]
    pmax = max(args.degrees)
    rtol = 1e-9 if args.dtype == "f64" else 1e-3
    lcm = max(counts)
    print(f"device {name}; every count's slabs on this one device (not a "
          "scaling measurement)")
    print(f"{'devices':>8} {'ndofs':>12} {'setup[s]':>9} {'s/cycle':>10} "
          f"{'rel resid':>11}")
    rows, ref, meshes = [], None, {}
    for nd in counts:
        target = args.ndofs * (nd if args.mode == "weak" else 1)
        nc = fit_box_cells(target, pmax)
        div = lcm if args.mode == "strong" else nd
        if args.dist_coarse and args.coarse == "hmg":
            # The pinned h-hierarchy needs one factor-2 coarsening with
            # x-cells still divisible by max(counts), and even y/z cells.
            div = 2 * lcm
            nc = (nc[0], (nc[1] + 1) // 2 * 2, (nc[2] + 1) // 2 * 2)
        nx = max(div, (nc[0] + div - 1) // div * div)
        # One mesh object per cell count: the strong sweep's counts share
        # it, and with it its host geometry factors (cached on the mesh).
        cells = (nx, nc[1], nc[2])
        if cells not in meshes:
            meshes[cells] = BoxMesh(cells)
        mesh = meshes[cells]
        t0 = time.time()
        dist = DistPMG(mesh, n_devices=nd, degrees=tuple(args.degrees),
                       kappa=args.kappa, dtype=dtype, coarse=args.coarse,
                       coarse_cfg=_coarse_cfg(args, (lcm, 1, 1)),
                       operator=args.operator, smoother=args.smoother,
                       device=device)
        sync()
        setup = time.time() - t0
        b = assemble_rhs(mesh, pmax, f_rhs(args.kappa))
        bd = dist.to_dist(b)
        ud = bd * 0
        dist.apply(bd, ud)  # warm-up
        sync()
        t0 = time.time()
        rnorms = []
        for _ in range(args.cycles):
            ud = dist.apply(bd, ud)
            rnorms.append(dist.residual_norm(bd, ud))
        per = (time.time() - t0) / args.cycles
        rel = rnorms[-1] / float(np.linalg.norm(b))
        print(f"{nd:>8} {mesh.num_dofs(pmax):>12} {setup:>9.1f} "
              f"{per:>10.4f} {rel:>11.3e}")
        invariant = None
        if args.mode == "strong":
            if ref is None:
                ref = rnorms
            else:
                invariant = bool(np.allclose(rnorms, ref, rtol=rtol))
                print(f"{'':>8} residual trajectory invariant vs 1 device: "
                      f"{invariant}")
        rows.append(dict(devices=nd, mesh=list(mesh.nc),
                         ndofs=mesh.num_dofs(pmax), setup_s=setup,
                         s_per_cycle=per, rel_resid=rel, rnorms=rnorms,
                         invariant=invariant))
    return rows, {}


def _grid_sweep(args, np, device, dtype, sync, name):
    """Strong sweep over the GridPMG shard layouts on one fixed mesh."""
    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import f_rhs, fit_box_cells
    from pmg_dolfinx_tpu_torch.parallel.grid2d import GridPMG

    if args.operator not in ("kron", "kron_blocked", "lattice",
                             "lattice_blocked"):
        raise SystemExit(
            f"--grid supports operators kron/kron_blocked/lattice/"
            f"lattice_blocked, got {args.operator!r}")
    n_max = args.max_devices or 8
    layouts = [s for s in LAYOUTS if s[0] * s[1] * s[2] <= n_max]
    pmax = max(args.degrees)
    nc = fit_box_cells(args.ndofs, pmax)
    div_all = tuple(max(s[a] for s in layouts) for a in range(3))
    if args.dist_coarse and args.coarse == "hmg":
        # One factor-2 coarsening must stay divisible by every layout.
        per_axis = tuple(2 * d for d in div_all)
    else:
        per_axis = (max(div_all),) * 3
    nc = tuple((c + d - 1) // d * d for c, d in zip(nc, per_axis))
    mesh = BoxMesh(nc)
    b = assemble_rhs(mesh, pmax, f_rhs(args.kappa))
    r0 = float(np.linalg.norm(b))
    rtol = 1e-9 if args.dtype == "f64" else 1e-3
    print(f"device {name}; every layout's shards on this one device (not a "
          "scaling measurement)")
    print(f"mesh {nc}, {mesh.num_dofs(pmax)} dofs, operator {args.operator}")
    print(f"{'layout':>10} {'setup[s]':>9} {'s/cycle':>10} {'rel resid':>11}")
    rows, ref = [], None
    for shards in layouts:
        t0 = time.time()
        grid = GridPMG(mesh, shards=shards, degrees=tuple(args.degrees),
                       kappa=args.kappa, dtype=dtype, coarse=args.coarse,
                       coarse_cfg=_coarse_cfg(args, div_all),
                       operator=args.operator, smoother=args.smoother,
                       device=device)
        sync()
        setup = time.time() - t0
        grid.solve(b, num_cycles=1)  # warm-up
        sync()
        t0 = time.time()
        _, rnorms = grid.solve(b, num_cycles=args.cycles)
        sync()
        per = (time.time() - t0) / args.cycles
        rel = rnorms[-1] / r0
        tag = "x".join(map(str, shards))
        print(f"{tag:>10} {setup:>9.1f} {per:>10.4f} {rel:>11.3e}")
        invariant = None
        if ref is None:
            ref = rnorms
        else:
            invariant = bool(np.allclose(rnorms, ref, rtol=rtol))
            print(f"{'':>10} trajectory invariant vs 1x1x1: {invariant}")
        rows.append(dict(layout=tag, setup_s=setup, s_per_cycle=per,
                         rel_resid=rel, rnorms=rnorms, invariant=invariant))
    return rows, dict(mesh=list(nc), ndofs=mesh.num_dofs(pmax))

if __name__ == "__main__":
    main()
