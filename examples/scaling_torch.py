"""Device-grid layout sweep of the PyTorch/CUDA port (the twin of
`examples/scaling.py --grid`).

    python examples/scaling_torch.py --grid [--device cpu] [--ndofs N]
        [--degrees 1 3] [--operator kron|kron_blocked]
        [--coarse cg|smoother|fdm] [--max-devices 8]

Builds `parallel.grid2d.GridPMG` on ONE fixed mesh for the shard layouts
1x1x1, 2x1x1, 2x2x1, 2x2x2, 4x2x2, 4x4x2 (those with at most
``--max-devices`` shards) and prints, per layout, the setup seconds, the
seconds per stationary V-cycle and the final relative residual, then
whether the residual trajectory equals the 1x1x1 one (rtol 1e-9 in f64,
1e-3 in f32): the layout-invariance contract of the decomposition.

Every layout's shards are stacked on ONE device (the port's single-device
backend of the grid program), so the s/cycle column measures the cost
of the decomposition on one card, NOT a scaling measurement: there is no
second device. The 1D slab sweep (`DistPMG`) is not ported (ROADMAP.md
Queue 1 item 10). The last line is a JSON object with every row.
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
                   help="sweep multi-axis (x,y,z) GridPMG layouts (the only "
                        "mode the port has)")
    p.add_argument("--ndofs", type=int, default=50000,
                   help="target number of dofs (global)")
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument("--operator", choices=["kron", "kron_blocked"],
                   default="kron")
    p.add_argument("--kappa", type=float, default=2.0)
    p.add_argument("--degrees", type=int, nargs="+", default=[1, 3])
    p.add_argument("--cycles", type=int, default=5)
    p.add_argument("--max-devices", type=int, default=0,
                   help="largest shard count of a layout (default 8)")
    p.add_argument("--coarse", choices=["cg", "smoother", "fdm"],
                   default="cg")
    p.add_argument("--device", default="cuda",
                   help="torch device (default 'cuda')")
    args = p.parse_args()
    if not args.grid:
        raise SystemExit("the 1D slab sweep (DistPMG) is not ported yet "
                         "(ROADMAP.md Queue 1 item 10); pass --grid")

    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import f_rhs, fit_box_cells
    from pmg_dolfinx_tpu_torch.parallel.grid2d import GridPMG

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False")
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    sync = ((lambda: torch.cuda.synchronize(device))
            if device.type == "cuda" else (lambda: None))
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    n_max = args.max_devices or 8
    layouts = [s for s in LAYOUTS if s[0] * s[1] * s[2] <= n_max]
    pmax = max(args.degrees)
    nc = fit_box_cells(args.ndofs, pmax)
    div = max(max(s[a] for s in layouts) for a in range(3))
    nc = tuple((c + div - 1) // div * div for c in nc)
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
                       operator=args.operator, device=device)
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
    print(json.dumps(dict(device=name, mesh=list(nc),
                          ndofs=mesh.num_dofs(pmax), operator=args.operator,
                          coarse=args.coarse, dtype=args.dtype, rows=rows)))


if __name__ == "__main__":
    main()
