"""Halo-exchange micro-benchmark of the PyTorch/CUDA port on the slab layout
(the twin of `examples/vector_update.py`).

    python examples/vector_update_torch.py [--device cpu] [--ndofs N]
        [--degree 2] [--rounds 100] [--devices 8]
        [--operator dofmap|lattice|kron|kron_blocked] [--dtype f32|f64]

Builds `parallel.dist.DistPMG` on ``--devices`` x-slabs and runs
``--rounds`` rounds of the reference's per-round pattern: the fine
operator apply (which holds the interface-plane partial-sum exchange), a
global ownership-weighted dot and an axpy, ``u <- u + 0.25 y / (1 + <u,
y>)`` from ``u = 1``. The rounds run twice from the same start; the dot
trajectory must repeat bit for bit (``deterministic``) and be finite.
Prints the seconds per round (the first pass, one device sync at its
end) and the first and last dot.

The slabs are stacked on ONE device (the port's single-device backend
of the SPMD program), so the time measures the cost of the decomposition
(the stacked exchange and the batched slab apply), not scaling. The last
line is a JSON object.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ndofs", type=int, default=50000,
                   help="target number of dofs (global)")
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument("--operator",
                   choices=["dofmap", "lattice", "kron", "kron_blocked"],
                   default="kron")
    p.add_argument("--kappa", type=float, default=2.0)
    p.add_argument("--degree", type=int, default=2)
    p.add_argument("--rounds", type=int, default=100)
    p.add_argument("--devices", type=int, default=8,
                   help="number of stacked x-slabs")
    p.add_argument("--device", default="cuda",
                   help="torch device (default 'cuda')")
    args = p.parse_args()

    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import fit_box_cells
    from pmg_dolfinx_tpu_torch.parallel.dist import DistPMG

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False")
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    n_dev = args.devices
    nc = fit_box_cells(args.ndofs, args.degree)
    nx = max(n_dev, (nc[0] // n_dev) * n_dev)
    mesh = BoxMesh((nx, nc[1], nc[2]))
    dist = DistPMG(mesh, n_devices=n_dev, degrees=(1, args.degree),
                   kappa=args.kappa, dtype=dtype, operator=args.operator,
                   device=device)
    print(f"device {name}; {n_dev} slabs stacked on it, mesh {mesh.nc}, "
          f"p={args.degree}, ndofs={mesh.num_dofs(args.degree)}")

    ops = dist.ops
    fine = dist.levels[-1]
    lv = dist.data["levels"][-1]

    def round_fn(u):
        # operator apply (with the halo partial-sum exchange), a global
        # dot, and an axpy: the reference's per-round pattern
        y = ops["apply"](lv, u, fine)
        d = ops["dot"](u, y, lv)
        return u + 0.25 * y / (1.0 + d), d

    def run():
        u = dist.to_dist(np.ones(mesh.num_dofs(args.degree)))
        dots = []
        for _ in range(args.rounds):
            u, d = round_fn(u)
            dots.append(d)
        return torch.stack(dots)

    run()  # warm-up
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    dots = run().cpu().numpy()
    dt = time.perf_counter() - t0
    again = run().cpu().numpy()
    deterministic = bool(np.array_equal(dots, again))
    print(f"{args.rounds} rounds in {dt:.3f}s "
          f"({dt / args.rounds * 1e3:.3f} ms/round)")
    print(f"dot trajectory: first={dots[0]:.6e} last={dots[-1]:.6e}")
    print(f"deterministic: {deterministic}")
    if not np.all(np.isfinite(dots)):
        raise SystemExit("non-finite dot encountered")
    print(json.dumps(dict(device=name, slabs=n_dev, mesh=list(mesh.nc),
                          ndofs=mesh.num_dofs(args.degree),
                          operator=args.operator, rounds=args.rounds,
                          s_per_round=dt / args.rounds,
                          dot_first=float(dots[0]), dot_last=float(dots[-1]),
                          deterministic=deterministic)))


if __name__ == "__main__":
    main()
