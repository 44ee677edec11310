"""Transient heat-equation driver on PyTorch/CUDA: ``u_t - div(kappa grad
u) = 0``.

The port's counterpart of `examples/heat.py` (same flags for the ported
subset). On an axis-aligned box every step is one exact FDM direct solve
(`solvers.transient.heat_fdm_evolve`); ``--batch B`` is the serving mode:
B trajectories stepped together through the kernels of
`ops/kron_packed.py` (float32, NZ <= 64; the CUDA kernels on a CUDA
device). ``--mesh perturbed`` steps curved hexes through a shifted PMG
hierarchy, one FCG(V) solve per step (``--fixed-iters N``: N FCG
iterations per step, no host sync in the step loop). ``--shards N`` or
``sx,sy,sz`` shards the box time loop (`parallel.transient_dist.
heat_dist_evolve`: one distributed FDM solve per step, every shard stacked
on the one device).

Accuracy check: the separable mode ``u = exp(-3 kappa pi^2 t) sin(pi x)
sin(pi y) sin(pi z)``; prints the final-time L2 error, the throughput and
a final JSON line.

    python examples/heat_torch.py --ndofs 227000 --degree 6 --batch 1 \\
        --steps 2000
    python examples/heat_torch.py --device cpu --ndofs 3000 --degree 3 \\
        --batch 3 --steps 20
    python examples/heat_torch.py --device cpu --ndofs 3000 --shards 4 \\
        --dtype f64
"""

import json
import time

import numpy as np

from _common_torch import base_parser, parse_shards, setup, sync


def parse_args(argv=None):
    """The command line (JAX `examples/heat.py`'s ported subset)."""
    p = base_parser(__doc__)
    p.add_argument("--dt", type=float, default=1e-3)
    p.add_argument("--scheme", choices=["be", "cn"], default="cn")
    p.add_argument("--fixed-iters", type=int, default=0,
                   help="perturbed mesh: >0 runs this fixed per-step FCG "
                        "count (heat_pcg_evolve_scanned, smoother coarse) "
                        "instead of the adaptive host loop")
    p.add_argument("--save-series", type=str, default="",
                   help="trajectory snapshots (not ported)")
    p.add_argument("--snap-every", type=int, default=10)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    shards = parse_shards(args.shards) if args.shards else None
    if shards is not None and (args.mesh == "perturbed" or args.batch):
        raise SystemExit("--shards rides the distributed FDM step solve "
                         "(axis-aligned box, unbatched)")
    torch, device, dtype, mesh = setup(args)

    from pmg_dolfinx_tpu_torch.fem.assembly import l2_error
    from pmg_dolfinx_tpu_torch.utils.timers import Timer, list_timings

    P, kappa = args.degree, args.kappa
    nc = mesh.nc
    print(f"mesh {nc[0]}x{nc[1]}x{nc[2]} p={P} ({mesh.num_dofs(P)} dofs), "
          f"{args.scheme} dt={args.dt:g} x {args.steps} steps")
    c = mesh.dof_coords(P)
    u0 = (np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
          * np.sin(np.pi * c[:, 2]))
    T = args.dt * args.steps
    lam = 3.0 * np.pi**2 * kappa

    def u_exact(x):
        return (np.exp(-lam * T) * np.sin(np.pi * x[0])
                * np.sin(np.pi * x[1]) * np.sin(np.pi * x[2]))

    if args.batch:
        if args.mesh == "perturbed":
            raise SystemExit("--batch rides the kron_packed kernels "
                             "(axis-aligned box only)")
        from pmg_dolfinx_tpu_torch.solvers.transient import heat_packed_evolve

        B = args.batch
        with Timer("setup", sync=True):
            evolve = heat_packed_evolve(mesh, P, kappa=kappa, dt=args.dt, B=B,
                                        scheme=args.scheme, device=device)
        U0 = np.broadcast_to(u0, (B, u0.size)).astype(np.float32)
        with Timer(f"warmup ({args.steps} steps)", sync=True):
            evolve(U0, args.steps)
        with Timer(f"evolve ({args.steps} steps x batch {B})", sync=True):
            t0 = time.perf_counter()
            UT = evolve(U0, args.steps)
            sync(torch, device)
            wall = time.perf_counter() - t0
        UT = UT.cpu().numpy()
        err = l2_error(mesh, P, UT[0].astype(np.float64), u_exact)
        rate = args.steps * B / wall
        print(f"L2 error at T={T:g} (col 0): {err:.4e}")
        print(f"throughput: {rate:.1f} column-steps/s "
              f"({args.steps / wall:.1f} batch-steps/s)")
        list_timings()
        print(json.dumps({"l2_error": float(err),
                          "column_steps_per_s": rate}))
        return

    with Timer("setup", sync=True):
        if args.mesh == "perturbed":
            from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy
            from pmg_dolfinx_tpu_torch.solvers.transient import (
                heat_pcg_evolve, heat_pcg_evolve_scanned)

            kap_op = kappa / 2 if args.scheme == "cn" else kappa
            # The fixed-count stepper uses the smoother coarse: the cg
            # coarse solve reads its convergence flag on the host.
            coarse = "smoother" if args.fixed_iters else "cg"
            hier = PMGHierarchy(mesh, degrees=(1, P), kappa=kap_op,
                                sigma=1.0 / args.dt, dtype=dtype,
                                coarse=coarse, operator="lattice",
                                device=device)
            if args.fixed_iters:
                evolve = heat_pcg_evolve_scanned(
                    hier, mesh, P, args.dt, scheme=args.scheme,
                    inner_iters=args.fixed_iters)
            else:
                evolve = heat_pcg_evolve(hier, mesh, P, args.dt,
                                         scheme=args.scheme, rtol=args.rtol)
        elif shards is not None:
            from pmg_dolfinx_tpu_torch.parallel.transient_dist import (
                heat_dist_evolve)

            print(f"sharded time loop: shards {shards} "
                  "(distributed FDM step solves, gather-free)")
            evolve = heat_dist_evolve(mesh, P, shards, kappa=kappa,
                                      dt=args.dt, scheme=args.scheme,
                                      dtype=dtype, device=device)
        else:
            from pmg_dolfinx_tpu_torch.solvers.transient import heat_fdm_evolve

            evolve = heat_fdm_evolve(mesh, P, kappa=kappa, dt=args.dt,
                                     scheme=args.scheme, dtype=dtype,
                                     device=device)

    adaptive = args.mesh == "perturbed" and not args.fixed_iters
    with Timer("warmup (1 step)", sync=True):
        evolve(u0, 1)
    with Timer(f"evolve ({args.steps} steps)", sync=True):
        t0 = time.perf_counter()
        out = evolve(u0, args.steps)
        sync(torch, device)
        wall = time.perf_counter() - t0
    if adaptive:
        uT, iters = out
        print(f"FCG iterations/step: min {min(iters)} max {max(iters)}")
    else:
        uT = out
    uT = uT.cpu().numpy().reshape(-1).astype(np.float64)
    err = l2_error(mesh, P, uT, u_exact)
    print(f"L2 error at T={T:g}: {err:.4e} "
          f"(analytic decay exp(-{lam:.3f} T) = {np.exp(-lam * T):.4e})")
    print(f"throughput: {args.steps / wall:.1f} steps/s")
    list_timings()
    print(json.dumps({"l2_error": float(err),
                      "steps_per_s": args.steps / wall}))


if __name__ == "__main__":
    main()
