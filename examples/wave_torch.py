"""Wave-equation driver on PyTorch/CUDA: ``u_tt - div(kappa grad u) = 0``.

The port's counterpart of `examples/wave.py` (same flags for the ported
subset). Integrators:
- ``--scheme newmark`` (default): implicit Newmark-beta, average
  acceleration (1/4, 1/2); one exact FDM direct solve per step;
  ``--gamma > 0.5`` damps.
- ``--scheme leapfrog``: explicit central difference, one kron apply per
  step; ``--dt 0`` picks 0.72x the spectral bound `wave_stable_dt`.
``--batch B`` is the serving mode through the kernels of
`ops/kron_packed.py` (float32, NZ <= 64; the CUDA kernels on a CUDA
device); ``--mesh perturbed`` steps curved hexes (Newmark) with one
FCG(V) solve per step; ``--pulse F0`` drives the medium from rest with a
Ricker wavelet at the centre (box mesh). ``--shards N`` or ``sx,sy,sz``
shards the box time loop, every shard stacked on the one device
(`parallel.transient_dist`: Newmark one distributed FDM solve per step,
leapfrog one distributed forward transform apply).

Accuracy check: the standing wave ``u = cos(omega t) sin(pi x) sin(pi y)
sin(pi z)``, ``omega = pi sqrt(3 kappa)``; prints the final-time L2 error,
the relative energy drift, the throughput and a final JSON line.

    python examples/wave_torch.py --ndofs 227000 --degree 6 --batch 8 \\
        --scheme leapfrog --dt 0 --steps 2000
    python examples/wave_torch.py --device cpu --ndofs 3000 --degree 3 \\
        --batch 1 --scheme leapfrog --dt 0 --steps 20
"""

import json
import time

import numpy as np

from _common_torch import base_parser, parse_shards, setup, sync


def parse_args(argv=None):
    """The command line (JAX `examples/wave.py`'s ported subset)."""
    p = base_parser(__doc__)
    p.add_argument("--dt", type=float, default=1e-3,
                   help="time step; 0 = auto (0.72x the spectral "
                        "stability bound)")
    p.add_argument("--scheme", choices=["newmark", "leapfrog"],
                   default="newmark")
    p.add_argument("--gamma", type=float, default=0.5,
                   help="Newmark gamma (>1/2: algorithmic damping)")
    p.add_argument("--pulse", type=float, default=0.0,
                   help="drive the medium from rest with a Ricker wavelet "
                        "of peak frequency F0 at the domain centre (box "
                        "mesh) instead of the standing-wave test")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    shards = parse_shards(args.shards) if args.shards else None
    if shards is not None and args.mesh == "perturbed":
        raise SystemExit("--shards rides the distributed FDM/transform "
                         "step programs (box mesh)")
    torch, device, dtype, mesh = setup(args)

    from pmg_dolfinx_tpu_torch.fem.assembly import l2_error, lumped_mass_np
    from pmg_dolfinx_tpu_torch.ops.kron import KronLaplacian
    from pmg_dolfinx_tpu_torch.solvers.transient import (
        wave_leapfrog_evolve, wave_newmark_evolve, wave_pcg_evolve,
        wave_stable_dt)
    from pmg_dolfinx_tpu_torch.utils.timers import Timer, list_timings

    P, kappa = args.degree, args.kappa
    nc = mesh.nc
    dt = args.dt
    if dt == 0.0:
        if args.mesh == "perturbed":
            raise SystemExit("--dt 0 (spectral auto-dt) needs the "
                             "axis-aligned FDM eigenvalues")
        dt = 0.72 * wave_stable_dt(mesh, P, kappa=kappa)
        print(f"auto dt = {dt:.3e} (0.72 x spectral bound)")
    print(f"mesh {nc[0]}x{nc[1]}x{nc[2]} p={P} ({mesh.num_dofs(P)} dofs), "
          f"{args.scheme} dt={dt:g} x {args.steps} steps")

    c = mesh.dof_coords(P)
    u0 = (np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
          * np.sin(np.pi * c[:, 2]))
    v0 = np.zeros_like(u0)
    T = dt * args.steps
    omega = np.pi * np.sqrt(3.0 * kappa)

    f_src, f_time = None, None
    if args.pulse > 0.0:
        if args.mesh == "perturbed":
            raise SystemExit("--pulse rides the box-mesh evolvers")
        from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs

        # The pulse parameters are bound as defaults: the closure must not
        # read names the timing code below rebinds.
        def f_time(t, _f0=args.pulse, _t0=1.0 / args.pulse):
            a = (np.pi * _f0 * (t - _t0)) ** 2
            return (1.0 - 2.0 * a) * np.exp(-a)

        def blob(x):
            r2 = sum((x[a] - 0.5) ** 2 for a in range(3))
            return np.exp(-r2 / (2.0 * 0.05 ** 2))

        f_src = assemble_rhs(mesh, P, blob)
        u0, v0 = np.zeros_like(u0), np.zeros_like(v0)
        print(f"Ricker pulse f0={args.pulse:g} "
              f"(delay t0={1.0 / args.pulse:g}) at the center")

    def u_exact(x):
        return (np.cos(omega * T) * np.sin(np.pi * x[0])
                * np.sin(np.pi * x[1]) * np.sin(np.pi * x[2]))

    if args.batch:
        if args.mesh == "perturbed" or shards is not None:
            raise SystemExit("--batch rides the kron_packed kernels "
                             "(axis-aligned box, unsharded)")
        from pmg_dolfinx_tpu_torch.solvers.transient import wave_packed_evolve

        B = args.batch
        with Timer("setup", sync=True):
            evolve = wave_packed_evolve(mesh, P, kappa=kappa, dt=dt, B=B,
                                        scheme=args.scheme, gamma=args.gamma,
                                        f=f_src, f_time=f_time, device=device)
        U0 = np.broadcast_to(u0, (B, u0.size)).astype(np.float32)
        V0 = np.zeros_like(U0)
        with Timer(f"warmup ({args.steps} steps)", sync=True):
            evolve(U0, V0, args.steps)
        with Timer(f"evolve ({args.steps} steps x batch {B})", sync=True):
            t0 = time.perf_counter()
            UT, VT = evolve(U0, V0, args.steps)
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

    m3 = lumped_mass_np(mesh, P, bc_zero=True)
    op64 = (KronLaplacian(mesh, P, kappa=kappa, dtype=torch.float64,
                          device="cpu") if args.mesh == "box" else None)

    def energy(u, v):
        if op64 is None:
            return float("nan")
        u = np.asarray(u, np.float64).reshape(-1)
        v = np.asarray(v, np.float64).reshape(-1)
        Ku = op64(torch.from_numpy(u)).numpy()
        return 0.5 * (v @ (m3 * v) + u @ Ku)

    with Timer("setup", sync=True):
        if args.mesh == "perturbed":
            from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

            if args.scheme == "leapfrog":
                raise SystemExit("leapfrog is kron-family only "
                                 "(needs the lumped-mass box apply)")
            beta = 0.25
            hier = PMGHierarchy(mesh, degrees=(1, P), kappa=kappa,
                                sigma=1.0 / (beta * dt * dt), dtype=dtype,
                                coarse="cg", operator="lattice",
                                device=device)
            evolve = wave_pcg_evolve(hier, mesh, P, dt, gamma=args.gamma,
                                     rtol=args.rtol)
        elif shards is not None:
            from pmg_dolfinx_tpu_torch.parallel.transient_dist import (
                wave_leapfrog_dist_evolve, wave_newmark_dist_evolve)

            if args.scheme == "newmark":
                print(f"sharded time loop: shards {shards} "
                      "(distributed FDM step solves, gather-free)")
                evolve = wave_newmark_dist_evolve(
                    mesh, P, shards, kappa=kappa, dt=dt, gamma=args.gamma,
                    dtype=dtype, f=f_src, f_time=f_time, device=device)
            else:
                print(f"sharded time loop: shards {shards} "
                      "(distributed forward transform apply per step)")
                evolve = wave_leapfrog_dist_evolve(
                    mesh, P, shards, kappa=kappa, dt=dt, dtype=dtype,
                    f=f_src, f_time=f_time, device=device)
        elif args.scheme == "newmark":
            evolve = wave_newmark_evolve(mesh, P, kappa=kappa, dt=dt,
                                         gamma=args.gamma, dtype=dtype,
                                         f=f_src, f_time=f_time,
                                         device=device)
        else:
            evolve = wave_leapfrog_evolve(mesh, P, kappa=kappa, dt=dt,
                                          dtype=dtype, f=f_src,
                                          f_time=f_time, device=device)

    E0 = energy(u0, v0)
    with Timer("warmup (1 step)", sync=True):
        evolve(u0, v0, 1)
    with Timer(f"evolve ({args.steps} steps)", sync=True):
        t0 = time.perf_counter()
        out = evolve(u0, v0, args.steps)
        sync(torch, device)
        wall = time.perf_counter() - t0
    uT, vT = (a.cpu().numpy().reshape(-1) for a in out[:2])
    if args.mesh == "perturbed":
        iters = out[2]
        print(f"FCG iterations/step: min {min(iters)} max {max(iters)}")

    ET = energy(uT, vT)
    if args.pulse > 0.0:
        # Driven from rest: the injected energy and amplitude (no analytic
        # standing-wave error applies).
        print(f"T={T:g}: radiated field max|u| = "
              f"{float(np.max(np.abs(uT))):.4e}, energy E_T = {ET:.4e}")
        print(f"throughput: {args.steps / wall:.1f} steps/s")
        list_timings()
        print(json.dumps({"energy_T": float(ET),
                          "max_abs_u": float(np.max(np.abs(uT))),
                          "steps_per_s": args.steps / wall}))
        return
    err = l2_error(mesh, P, uT.astype(np.float64), u_exact)
    drift = abs(ET - E0) / E0 if np.isfinite(E0) and E0 > 0 else float("nan")
    print(f"L2 error at T={T:g}: {err:.4e} "
          f"(analytic cos({omega:.3f} T) = {np.cos(omega * T):+.4f})")
    if np.isfinite(drift):
        print(f"energy drift |E_T - E_0|/E_0 = {drift:.3e}")
    print(f"throughput: {args.steps / wall:.1f} steps/s")
    list_timings()
    print(json.dumps({"l2_error": float(err),
                      "energy_drift": float(drift),
                      "steps_per_s": args.steps / wall}))


if __name__ == "__main__":
    main()
