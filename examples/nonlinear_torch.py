"""Semilinear reaction-diffusion driver on PyTorch/CUDA: inexact
Newton-Krylov.

The port's counterpart of `examples/nonlinear.py` (same flags). Solves
``-div(kappa grad u) + sigma u + N(u) = f`` on the unit cube with ``N(u)
= c u^3`` (manufactured solution) or the Bratu problem ``-lap u = lam
e^u`` (``--model bratu``) by `solvers.newton.newton_solve`: every Newton
step an FCG(V) solve of the matrix-free Jacobian, Eisenstat-Walker
forcing. ``--operator kron_blocked`` runs the flagship's CUDA kernels
(float32); ``--transient`` time-steps instead (IMEX: one FDM solve per
step; ``--implicit``: per-step Newton; ``--batch B``: B trajectories
through the serving kernels of `ops/kron_packed.py`).

    python examples/nonlinear_torch.py --ndofs 16000000 --degrees 1 3 6 \\
        --operator kron_blocked --model cubic --c 5 --rtol 1e-3
    python examples/nonlinear_torch.py --model bratu --lam 5 --dtype f64
    python examples/nonlinear_torch.py --transient --batch 8 --degrees 6 \\
        --ndofs 227000
    python examples/nonlinear_torch.py --device cpu --ndofs 3000 \\
        --dtype f64 --transient --implicit
"""

import json
import time

import numpy as np

from _common_torch import model_parser, sync, torch_device


def main():
    p = model_parser(__doc__)
    p.add_argument("--degrees", type=int, nargs="+", default=[1, 3])
    p.add_argument("--model", choices=["cubic", "bratu"], default="cubic")
    p.add_argument("--c", type=float, default=5.0,
                   help="cubic coefficient N(u) = c u^3")
    p.add_argument("--lam", type=float, default=5.0,
                   help="Bratu parameter (keep below the 3D fold ~6.8)")
    p.add_argument("--sigma", type=float, default=0.0,
                   help="additional linear reaction shift")
    p.add_argument("--coarse", choices=["smoother", "cg", "direct",
                                        "hmg", "fdm"], default="fdm")
    p.add_argument("--mesh", choices=["box", "perturbed"], default="box")
    p.add_argument("--kappa-field", choices=["const", "linear"],
                   default="const")
    p.add_argument("--rtol", type=float, default=1e-9)
    p.add_argument("--maxiter", type=int, default=20)
    p.add_argument("--lin-maxiter", type=int, default=60)
    p.add_argument("--warm", action="store_true",
                   help="run one throwaway solve first (kernel builds, "
                        "allocator warm-up)")
    p.add_argument("--transient", action="store_true",
                   help="time-step u_t - div(k grad u) + sigma u + N(u) = f "
                        "instead: IMEX (explicit reaction, one FDM solve a "
                        "step; box + cubic) or --implicit Newton-BE")
    p.add_argument("--implicit", action="store_true",
                   help="fully implicit BE (per-step warm Newton)")
    p.add_argument("--dt", type=float, default=5e-3)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--scheme", choices=["be", "cnab"], default="cnab")
    p.add_argument("--batch", type=int, default=0,
                   help="with --transient: step B trajectories through the "
                        "serving kernels (f32, NZ <= 64; B=1 uses the "
                        "single-RHS classes)")
    args = p.parse_args()
    torch, device, dtype = torch_device(args)

    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs, l2_error
    from pmg_dolfinx_tpu_torch.models import semilinear
    from pmg_dolfinx_tpu_torch.models.poisson import fit_box_cells, u_exact
    from pmg_dolfinx_tpu_torch.solvers.newton import newton_solve
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy
    from pmg_dolfinx_tpu_torch.utils.timers import Timer, list_timings

    nc = fit_box_cells(args.ndofs, max(args.degrees))
    kappa = args.kappa
    if args.kappa_field == "linear":
        from pmg_dolfinx_tpu_torch.models.poisson import kappa_linear

        kappa = kappa_linear
        if args.operator in ("kron", "kron_blocked"):
            args.operator = "lattice"
            print("variable kappa: switching operator backend to 'lattice'")
    if args.mesh == "perturbed":
        from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh

        mesh = PerturbedBoxMesh(nc)
        if args.operator in ("kron", "kron_blocked"):
            args.operator = "lattice"
            print("perturbed mesh: switching operator backend to 'lattice'")
        if args.coarse == "fdm":
            args.coarse = "hmg"
            print("perturbed mesh: switching coarse solver to 'hmg'")
    else:
        from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh

        mesh = BoxMesh(nc)
    P = max(args.degrees)
    print(f"mesh {nc}, {mesh.num_dofs(P)} dofs, degrees {args.degrees}, "
          f"operator {args.operator}, coarse {args.coarse}")

    if args.model == "cubic":
        nonlin = semilinear.cubic(args.c)
        if args.kappa_field == "const" and args.mesh == "box":
            f = semilinear.f_rhs_semilinear(args.kappa, nonlin,
                                            sigma=args.sigma)
        else:
            # No manufactured source for the variable/curved cases: the
            # linear family's source (solution unknown, report |F|).
            from pmg_dolfinx_tpu_torch.models.poisson import f_rhs

            f = f_rhs(2.0, sigma=args.sigma)
        b = assemble_rhs(mesh, P, f)
    else:
        nonlin = semilinear.bratu(args.lam)
        b = np.zeros(mesh.num_dofs(P))

    if args.transient:
        transient(args, torch, device, dtype, mesh, P, kappa, nonlin, b)
        return

    with Timer("setup (hierarchy build + calibration)", sync=True):
        hier = PMGHierarchy(mesh, degrees=tuple(args.degrees), kappa=kappa,
                            dtype=dtype, coarse=args.coarse,
                            operator=args.operator, sigma=args.sigma,
                            device=device)

    atol = 0.0
    if args.model == "bratu":
        # |F(0)| = lam |M e^0| is O(1); converge on the absolute norm.
        args.rtol, atol = 0.0, 1e-10 if args.dtype == "f64" else 1e-5

    kw = dict(rtol=args.rtol, atol=atol, maxiter=args.maxiter,
              lin_maxiter=args.lin_maxiter)
    if args.warm:
        newton_solve(hier, b, nonlin, **kw)
    with Timer("newton solve", sync=True):
        t0 = time.perf_counter()
        u, info = newton_solve(hier, b, nonlin, **kw)
        sync(torch, device)
        wall = time.perf_counter() - t0

    status = "converged" if info["converged"] else "NOT CONVERGED"
    print(f"{nonlin.name}: {status} in {info['niter']} Newton steps")
    for k, fn in enumerate(info["fnorms"]):
        lin = (f"  (lin iters {info['lin_iters'][k]})"
               if k < len(info["lin_iters"]) else "")
        print(f"  |F_{k}| = {fn:.3e}{lin}")
    out = dict(niter=info["niter"], lin_iters=info["lin_iters"],
               converged=bool(info["converged"]),
               ms_per_newton_step=1e3 * wall / max(info["niter"], 1))
    u = u.double().cpu().numpy()
    if args.model == "cubic" and args.kappa_field == "const" \
            and args.mesh == "box":
        err = l2_error(mesh, P, u, u_exact)
        print(f"L2 error vs manufactured solution: {err:.3e}")
        out["l2_error"] = float(err)
    else:
        umax = float(np.max(u))
        print(f"max(u) = {umax:.6f}")
        out["max_u"] = umax
    list_timings()
    print(json.dumps(out))


def transient(args, torch, device, dtype, mesh, P, kappa, nonlin, b):
    """The ``--transient`` modes: IMEX box stepper, packed serving batch or
    the implicit Newton-BE host loop; prints the steady-state L2 error and
    the steps/s."""
    from pmg_dolfinx_tpu_torch.fem.assembly import l2_error
    from pmg_dolfinx_tpu_torch.models.poisson import u_exact
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy
    from pmg_dolfinx_tpu_torch.utils.timers import Timer, list_timings

    if args.model != "cubic" or args.mesh != "box" \
            or args.kappa_field != "const":
        raise SystemExit("--transient: box + cubic + constant kappa (the "
                         "manufactured steady state)")
    if args.implicit and args.batch:
        raise SystemExit("--batch rides the IMEX packed stepper; --implicit "
                         "is the per-step Newton host loop: pick one")
    n = mesh.num_dofs(P)
    if args.implicit:
        from pmg_dolfinx_tpu_torch.solvers.transient import (
            semilinear_newton_evolve)

        with Timer("setup (shifted hierarchy)", sync=True):
            hier = PMGHierarchy(mesh, degrees=tuple(args.degrees),
                                kappa=kappa, dtype=dtype, coarse=args.coarse,
                                operator=args.operator,
                                sigma=args.sigma + 1.0 / args.dt,
                                device=device)
            evolve = semilinear_newton_evolve(hier, mesh, P, nonlin, args.dt,
                                              rtol=args.rtol, f=b)
        t0 = time.perf_counter()
        uT, iters = evolve(np.zeros(n), args.steps)
        sync(torch, device)
        wall = time.perf_counter() - t0
        print(f"implicit BE: Newton/step min {min(iters)} max {max(iters)}")
    elif args.batch:
        from pmg_dolfinx_tpu_torch.solvers.transient import (
            semilinear_packed_evolve)

        B = args.batch
        with Timer("setup (serving kernels)", sync=True):
            evolve = semilinear_packed_evolve(
                mesh, P, nonlin, kappa=args.kappa, dt=args.dt, B=B,
                scheme=args.scheme, sigma=args.sigma, f=b, device=device)
        U0 = np.zeros((B, n), np.float32)
        with Timer(f"warmup ({args.steps} steps)", sync=True):
            evolve(U0, args.steps)
        t0 = time.perf_counter()
        uT = evolve(U0, args.steps)[0]
        sync(torch, device)
        wall = time.perf_counter() - t0
        print(f"serving batch {B} ({args.steps * B / wall:.1f} "
              "column-steps/s)")
    else:
        from pmg_dolfinx_tpu_torch.solvers.transient import (
            semilinear_fdm_evolve)

        with Timer("setup (FDM factorization)", sync=True):
            evolve = semilinear_fdm_evolve(
                mesh, P, nonlin, kappa=args.kappa, dt=args.dt,
                scheme=args.scheme, sigma=args.sigma, dtype=dtype, f=b,
                device=device)
        u0 = np.zeros(n)
        with Timer(f"warmup ({args.steps} steps)", sync=True):
            evolve(u0, args.steps)
        t0 = time.perf_counter()
        uT = evolve(u0, args.steps)
        sync(torch, device)
        wall = time.perf_counter() - t0
    err = l2_error(mesh, P, uT.double().cpu().numpy().reshape(-1), u_exact)
    mode = "implicit-be" if args.implicit else args.scheme
    print(f"{mode} dt={args.dt:g} T={args.dt * args.steps:g}: steady-state "
          f"L2 err {err:.3e}")
    print(f"throughput: {args.steps / wall:.1f} steps/s")
    list_timings()
    print(json.dumps({"l2_error": float(err),
                      "steps_per_s": args.steps / wall}))


if __name__ == "__main__":
    main()
