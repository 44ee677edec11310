"""PMG driver on PyTorch/CUDA: the p-multigrid Poisson solve.

The port's counterpart of `examples/pmg.py` (same flag names for the
ported subset): builds the fitted unit-cube mesh and the p-hierarchy with
CG/Lanczos-calibrated fourth-kind Chebyshev smoothers, runs the
stationary V-cycles (or FCG(V) with ``--pcg``), and prints the
per-cycle residuals, the L2 error against the manufactured solution,
the timing table and a final JSON line.

    python examples/pmg_torch.py --ndofs 16000000 --degrees 1 3 6 \\
        --coarse fdm --operator kron_blocked --pcg
    python examples/pmg_torch.py --ndofs 16000000 --degrees 1 3 6 \\
        --mesh perturbed --coarse cg --pcg

``--operator kron_blocked`` and ``lattice_blocked`` run the hand-written
CUDA kernels (`pmg_dolfinx_tpu_torch/csrc/`, float32); ``kron``,
``lattice`` and ``dofmap`` are plain torch. ``--mesh perturbed`` builds
the curved-hex `PerturbedBoxMesh` and switches a Kronecker operator to
``lattice_blocked`` (f32) or ``lattice`` (f64). ``--device cpu`` runs
everything on the CPU, where the kernels' plain torch versions run.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def profile_vcycles(hier, b, n):
    """Trace ``n`` back-to-back V-cycles with `torch.profiler`; print the
    device time by kernel and the device busy time (the sum of the
    kernels' durations; one stream, so they do not overlap) against the
    wall clock."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if hier.device.type != "cuda":
        raise SystemExit("--profile traces the card: needs --device cuda")
    u0 = torch.zeros_like(b)
    for _ in range(2):
        hier.apply(b, u0)
    torch.cuda.synchronize(hier.device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            hier.apply(b, u0)
        torch.cuda.synchronize(hier.device)
        wall = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=20))
    print(f"profile: {n} V-cycles on {torch.cuda.get_device_name(hier.device)}"
          f": wall {wall:.3f} ms, device busy {busy:.3f} ms per V-cycle "
          f"({len(kernels) / n:.0f} kernels; idle "
          f"{max(0.0, 1 - busy / wall):.1%})")


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ndofs", type=int, default=50000,
                   help="target number of dofs (global)")
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument("--operator",
                   choices=["kron", "kron_blocked", "lattice",
                            "lattice_blocked", "dofmap"],
                   default="kron",
                   help="'kron_blocked'/'lattice_blocked' = hand-written "
                        "CUDA kernels (f32)")
    p.add_argument("--mesh", choices=["box", "perturbed"], default="box",
                   help="'perturbed' = curved hexes (general-hex "
                        "operators only)")
    p.add_argument("--kappa", type=float, default=2.0)
    p.add_argument("--degrees", type=int, nargs="+", default=[1, 3])
    p.add_argument("--cycles", type=int, default=10)
    p.add_argument("--coarse", choices=["smoother", "cg", "fdm"],
                   default="cg")
    p.add_argument("--pcg", action="store_true",
                   help="V-cycle-preconditioned flexible CG outer solver")
    p.add_argument("--warm", action="store_true",
                   help="run one throwaway solve first so the timed solve "
                        "excludes the kernel build and first launches")
    p.add_argument("--device", default="cuda",
                   help="torch device (default 'cuda')")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="after the solve, trace N V-cycles with "
                        "torch.profiler and print the device time by "
                        "kernel (CUDA only)")
    args = p.parse_args()

    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import (
        PoissonProblem,
        fit_box_cells,
    )
    from pmg_dolfinx_tpu_torch.utils.timers import Timer, list_timings

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False")
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    nc = fit_box_cells(args.ndofs, max(args.degrees))
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    mesh = None
    if args.mesh == "perturbed":
        if args.coarse == "fdm":
            raise SystemExit(
                "--mesh perturbed --coarse fdm: the FDM coarse solve is "
                "axis-aligned only, and the curved-hex h-multigrid coarse "
                "solver 'hmg' is not ported yet (ROADMAP.md Queue 1 item "
                "7); use --coarse cg")
        mesh = PerturbedBoxMesh(nc)
        if args.operator in ("kron", "kron_blocked"):
            args.operator = ("lattice_blocked" if args.dtype == "f32"
                             else "lattice")
            print("perturbed (general-hex) mesh: switching operator "
                  f"backend to '{args.operator}'")
    print(f"mesh {args.mesh} {nc[0]}x{nc[1]}x{nc[2]}, degrees "
          f"{args.degrees}, operator {args.operator}, device {name}, "
          f"dtype {args.dtype}")

    with Timer("setup (operators+calibration+rhs)", sync=True):
        prob = PoissonProblem(
            nc=nc, degrees=tuple(args.degrees), kappa=args.kappa,
            dtype=dtype, coarse=args.coarse, operator=args.operator,
            mesh=mesh, device=device,
        )
    ndofs = [prob.mesh.num_dofs(P) for P in args.degrees]
    print("hierarchy:", " -> ".join(f"p={P}: {n}"
                                    for P, n in zip(args.degrees, ndofs)))
    for P, eig in zip(args.degrees, prob.hierarchy.eigs):
        print(f"  level p={P}: eig range estimate "
              f"[{eig[0]:.4f}, {eig[-1]:.4f}]")

    def _solve():
        if args.pcg:
            u, niter = prob.hierarchy.solve_pcg(prob.b, rtol=1e-8,
                                                maxiter=args.cycles)
            return u, [], niter
        return (*prob.solve(num_cycles=args.cycles),)

    if args.warm:
        with Timer("pmg solve warmup", sync=True):
            _solve()
    with Timer("pmg solve (%d cycles)" % args.cycles, sync=True):
        u, rnorms, *extra = _solve()
    if args.pcg:
        print(f"FCG(V-cycle) converged in {extra[0]} iterations")
    r0 = float(torch.linalg.vector_norm(prob.b))
    for i, r in enumerate(rnorms):
        print(f"cycle {i + 1:2d}: |r| = {r:.4e}   rel = {r / r0:.4e}")
    err = prob.error_l2(u)
    print(f"L2 error vs manufactured solution: {err:.4e}")

    if args.profile:
        profile_vcycles(prob.hierarchy, prob.b, args.profile)
    list_timings()
    rel = rnorms[-1] / r0 if rnorms else None
    print(json.dumps({"rel_residual": rel, "l2_error": err}))


if __name__ == "__main__":
    main()
