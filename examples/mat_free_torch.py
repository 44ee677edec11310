"""Operator micro-benchmark on PyTorch/CUDA: repeated applies + oracle.

The port's counterpart of `examples/mat_free.py` (the reference's
`examples/mat_free`, ``./mat_free --ndofs N [--mat_comp]``): times
``--reps`` back-to-back applies of one operator with CUDA events (ms per
apply and GDOF/s, beside the card's name) and, with ``--mat_comp``,
checks the operator against the assembled scipy stiffness matrix.

    python examples/mat_free_torch.py --ndofs 16000000 --degree 6 \\
        --operator lattice_blocked --mesh perturbed
    python examples/mat_free_torch.py --device cpu --ndofs 20000 \\
        --degree 3 --operator lattice_blocked --variant geom --mat_comp

``kron_blocked`` and ``lattice_blocked`` run the hand-written CUDA
kernels (float32); on ``--device cpu`` they run their plain torch
versions and the time is the host clock's, a CPU number.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ndofs", type=int, default=50000,
                   help="target number of dofs (global)")
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument("--operator",
                   choices=["dofmap", "lattice", "lattice_blocked", "kron",
                            "kron_blocked"],
                   default="kron")
    p.add_argument("--variant", choices=["yexp", "v1", "ym", "geom", ""],
                   default="",
                   help="lattice_blocked variant: 'yexp'/'v1'/'ym' stream "
                        "G (one CUDA kernel), 'geom' rebuilds G in the "
                        "kernel")
    p.add_argument("--mesh", choices=["box", "perturbed"], default="box")
    p.add_argument("--kappa", type=float, default=2.0)
    p.add_argument("--degree", type=int, default=4)
    p.add_argument("--reps", type=int, default=100)
    p.add_argument("--mat_comp", action="store_true",
                   help="verify against the assembled scipy matrix (host "
                        "dense-per-cell assembly; use moderate --ndofs)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh, PerturbedBoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import fit_box_cells

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False")
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    if args.operator in ("kron_blocked", "lattice_blocked"):
        dtype = torch.float32
    nc = fit_box_cells(args.ndofs, args.degree)
    mesh = (PerturbedBoxMesh if args.mesh == "perturbed" else BoxMesh)(nc)
    P = args.degree
    nd = mesh.num_dofs(P)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"mesh {args.mesh} {nc}, p={P}, ndofs={nd / 1e6:.3f}M, device "
          f"{name}, operator {args.operator}"
          + (f" ({args.variant})" if args.variant else ""))

    kw = dict(kappa=args.kappa, device=device)
    if args.operator == "kron":
        from pmg_dolfinx_tpu_torch.ops.kron import KronLaplacian

        op = KronLaplacian(mesh, P, dtype=dtype, **kw)
    elif args.operator == "kron_blocked":
        from pmg_dolfinx_tpu_torch.ops.kron_blocked import PallasKronBlocked

        op = PallasKronBlocked(mesh, P, **kw)
    elif args.operator == "lattice_blocked":
        from pmg_dolfinx_tpu_torch.ops.lattice_blocked import (
            PallasLatticeBlocked,
        )

        op = PallasLatticeBlocked(mesh, P, variant=args.variant or None, **kw)
    elif args.operator == "lattice":
        from pmg_dolfinx_tpu_torch.ops.lattice import LatticeLaplacian

        op = LatticeLaplacian(mesh, P, dtype=dtype, **kw)
    else:
        from pmg_dolfinx_tpu_torch.ops.laplacian import MatFreeLaplacian

        op = MatFreeLaplacian(mesh, P, dtype=dtype, **kw)

    x = torch.ones(nd, dtype=dtype, device=device)
    for _ in range(3):
        op(x)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            op(x)
        end.record()
        torch.cuda.synchronize(device)
        ms = start.elapsed_time(end) / args.reps
        clock = "CUDA events"
    else:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            op(x)
        ms = (time.perf_counter() - t0) * 1e3 / args.reps
        clock = "host clock"
    print(f"mat-free matvec: {ms:.4f} ms/apply -> {nd / ms / 1e6:.3f} "
          f"GDOF/s ({args.reps} reps, {clock}, {name})")

    err = None
    if args.mat_comp:
        from pmg_dolfinx_tpu_torch.fem.assembly import assemble_stiffness

        A = assemble_stiffness(mesh, P, kappa=args.kappa)
        xr = np.random.default_rng(0).standard_normal(nd)
        y = op(torch.tensor(xr, dtype=dtype, device=device))
        y = y.to("cpu", torch.float64).numpy()
        ref = A @ xr
        err = float(np.linalg.norm(y - ref) / np.linalg.norm(ref))
        print(f"|y_matfree - y_assembled| / |y| = {err:.3e}")
    print(json.dumps({"ms_per_apply": ms, "gdofs": nd / ms / 1e6,
                      "clock": clock, "device": name, "mat_comp": err}))


if __name__ == "__main__":
    main()
