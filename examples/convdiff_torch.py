"""Convection-diffusion driver on PyTorch/CUDA: nonsymmetric steady
transport.

The port's counterpart of `examples/convdiff.py` (same flags). Solves
``-div(kappa grad u) + c . grad u + sigma u = f`` on the unit cube with a
constant velocity ``c`` (`solvers/convdiff.py`): the advection rides the
Kronecker separability (three contractions per apply, `ops.kron`), and
BiCGStab, preconditioned by the V-cycle of the symmetric part, solves the
system. The operator is ``kron`` (torch einsums, as JAX runs it on XLA).
``--transient`` steps to the steady state instead (implicit FDM
diffusion, explicit advection). ``--shards N`` runs the steady solve on
the slab `DistPMG` (N x-slabs), ``--shards sx,sy,sz`` on the grid
`GridPMG`: every shard is stacked on the one device, so the times
measure the cost of the decomposition, not scaling. ``--transient
--shards`` runs the sharded IMEX loop (`parallel.transient_dist.
convdiff_dist_evolve`: one distributed FDM solve per step, gather-free).

    python examples/convdiff_torch.py --ndofs 16000000 --degrees 1 3 6
    python examples/convdiff_torch.py --peclet-sweep --device cpu --dtype f64
    python examples/convdiff_torch.py --transient --steps 500
    python examples/convdiff_torch.py --velocity 1680,0,0 --stabilize p
    python examples/convdiff_torch.py --shards 4 --device cpu --dtype f64
    python examples/convdiff_torch.py --transient --shards 4 --device cpu \\
        --dtype f64
"""

import json
import time

import numpy as np

from _common_torch import model_parser, sync, torch_device


def _f(kappa, sigma, cvel):
    pi = np.pi

    def f(x):
        sx, sy, sz = (np.sin(pi * x[a]) for a in range(3))
        cx, cy, cz = (np.cos(pi * x[a]) for a in range(3))
        g = (pi * cx * sy * sz, pi * sx * cy * sz, pi * sx * sy * cz)
        return ((3.0 * pi**2 * kappa + sigma) * sx * sy * sz
                + sum(c_ * g_ for c_, g_ in zip(cvel, g)))

    return f


def main():
    p = model_parser(__doc__)
    p.add_argument("--degrees", type=int, nargs="+", default=[1, 3])
    p.add_argument("--velocity", type=str, default="3,-1.5,0.8",
                   help="constant advection velocity 'cx,cy,cz'")
    p.add_argument("--sigma", type=float, default=0.0)
    p.add_argument("--coarse", choices=["smoother", "cg", "direct",
                                        "hmg", "fdm"], default="fdm")
    p.add_argument("--rtol", type=float, default=1e-9)
    p.add_argument("--maxiter", type=int, default=200)
    p.add_argument("--peclet-sweep", action="store_true",
                   help="sweep |c| over a decade ladder and report the "
                        "BiCGStab iteration counts")
    p.add_argument("--warm", action="store_true")
    p.add_argument("--transient", action="store_true",
                   help="IMEX time stepping (implicit FDM diffusion, "
                        "explicit advection) to the steady state")
    p.add_argument("--dt", type=float, default=0.0,
                   help="IMEX step size (default: advective CFL / 4)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--scheme", choices=["be", "cnab"], default="cnab")
    p.add_argument("--stabilize", choices=["p", "cell"], default="",
                   help="streamline-diagonal artificial diffusion for cell "
                        "Pe > 1 (sd_stabilized_kappa): 'p' = h/P scale, "
                        "'cell' = h scale")
    p.add_argument("--shards", type=str, default="",
                   help="shard the steady solve: 'N' (x-slab DistPMG) or "
                        "'sx,sy,sz' (GridPMG), stacked on the one device; "
                        "with --transient the IMEX loop (transient_dist)")
    args = p.parse_args()
    shards = None
    if args.shards:
        parts = [int(v) for v in args.shards.split(",")]
        if len(parts) not in (1, 3):
            raise SystemExit("--shards expects 'N' or 'sx,sy,sz'")
        shards = parts[0] if len(parts) == 1 else tuple(parts)
    torch, device, dtype = torch_device(args)

    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs, l2_error
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import fit_box_cells, u_exact
    from pmg_dolfinx_tpu_torch.solvers.convdiff import (convdiff_solve,
                                                        sd_stabilized_kappa)
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy
    from pmg_dolfinx_tpu_torch.utils.timers import Timer, list_timings

    if args.operator != "kron":
        print("convection-diffusion rides the kron level data: forcing "
              "--operator kron")
        args.operator = "kron"
    nc = fit_box_cells(args.ndofs, max(args.degrees))
    if shards is not None:
        sh3 = (shards, 1, 1) if np.ndim(shards) == 0 else shards
        nc = tuple((c + s - 1) // s * s for c, s in zip(nc, sh3))
    mesh = BoxMesh(nc)
    P = max(args.degrees)
    cvel = np.array([float(s) for s in args.velocity.split(",")])
    if cvel.shape != (3,):
        raise SystemExit("--velocity expects 'cx,cy,cz'")
    print(f"mesh {nc}, {mesh.num_dofs(P)} dofs, degrees {args.degrees}, "
          f"kappa {args.kappa}, velocity {tuple(float(c) for c in cvel)}")
    f = _f(args.kappa, args.sigma, cvel)

    if args.transient:
        from pmg_dolfinx_tpu_torch.solvers.transient import (
            convdiff_advective_dt, convdiff_fdm_evolve)

        kap = args.kappa
        if args.stabilize:
            kap, _ = sd_stabilized_kappa(mesh, P, cvel, args.kappa,
                                         h_eff=args.stabilize)
            print(f"SD stabilization ({args.stabilize}): kappa_eff "
                  f"{tuple(round(float(k), 6) for k in kap)}")
        dt_adv = convdiff_advective_dt(mesh, P, cvel)
        dt = args.dt if args.dt > 0 else 0.25 * dt_adv
        if dt >= dt_adv:
            print(f"WARNING: dt {dt:g} >= advective CFL {dt_adv:g}: the "
                  "explicit advection term will blow up")
        with Timer("setup (assembly + FDM factorization)", sync=True):
            b = assemble_rhs(mesh, P, f)
            if shards is not None:
                from pmg_dolfinx_tpu_torch.parallel.transient_dist import (
                    convdiff_dist_evolve)

                print(f"sharded IMEX loop: shards {shards}")
                evolve = convdiff_dist_evolve(
                    mesh, P, shards, cvel, kappa=kap, dt=dt,
                    scheme=args.scheme, sigma=args.sigma, dtype=dtype, f=b,
                    device=device)
            else:
                evolve = convdiff_fdm_evolve(
                    mesh, P, cvel, kappa=kap, dt=dt, scheme=args.scheme,
                    sigma=args.sigma, dtype=dtype, f=b, device=device)
        u0 = np.zeros(mesh.num_dofs(P))
        with Timer(f"warmup ({args.steps} steps)", sync=True):
            evolve(u0, args.steps)
        with Timer(f"evolve ({args.steps} steps)", sync=True):
            t0 = time.perf_counter()
            uT = evolve(u0, args.steps)
            sync(torch, device)
            wall = time.perf_counter() - t0
        err = l2_error(mesh, P, uT.double().cpu().numpy().reshape(-1),
                       u_exact)
        print(f"{args.scheme} dt={dt:g} (advective CFL {dt_adv:g}), "
              f"T={dt * args.steps:g}: steady-state L2 err {err:.3e}")
        print(f"throughput: {args.steps / wall:.1f} steps/s")
        list_timings()
        print(json.dumps({"l2_error": float(err),
                          "steps_per_s": args.steps / wall}))
        return

    def make_hier(cv):
        kap = args.kappa
        if args.stabilize:
            kap, _ = sd_stabilized_kappa(mesh, P, cv, args.kappa,
                                         h_eff=args.stabilize)
            print(f"SD stabilization ({args.stabilize}): kappa_eff "
                  f"{tuple(round(float(k), 6) for k in kap)}")
        kw = dict(degrees=tuple(args.degrees), kappa=kap, dtype=dtype,
                  coarse=args.coarse, operator="kron", sigma=args.sigma,
                  device=device)
        if shards is None:
            return PMGHierarchy(mesh, **kw)
        if np.ndim(shards) == 0:
            from pmg_dolfinx_tpu_torch.parallel.dist import DistPMG

            return DistPMG(mesh, n_devices=int(shards), **kw)
        from pmg_dolfinx_tpu_torch.parallel.grid2d import GridPMG

        return GridPMG(mesh, shards=tuple(shards), **kw)

    with Timer("setup (hierarchy build + calibration + rhs)", sync=True):
        hier = make_hier(cvel)
        b = assemble_rhs(mesh, P, f)

    h_min = min(float(np.min(mesh.h_cells[a])) for a in range(3))
    if args.peclet_sweep:
        base = cvel / max(np.linalg.norm(cvel), 1e-300)
        print(f"{'|c|':>10} {'cell Pe':>10} {'iters':>6} {'rel resid':>11} "
              f"{'L2 err':>10}")
        rows = []
        for mag in (1.0, 10.0, 100.0, 1000.0):
            cv = base * mag
            bs = assemble_rhs(mesh, P, _f(args.kappa, args.sigma, cv))
            hs = make_hier(cv) if args.stabilize else hier
            u, info = convdiff_solve(hs, bs, cv, rtol=args.rtol,
                                     maxiter=args.maxiter)
            err = l2_error(mesh, P, u.double().cpu().numpy(), u_exact)
            pe = mag * h_min / (2.0 * args.kappa)
            print(f"{mag:10.1f} {pe:10.3f} {info['niter']:6d} "
                  f"{info['rel_resid']:11.2e} {err:10.2e}")
            rows.append(dict(cell_pe=pe, niter=info["niter"],
                             rel_resid=info["rel_resid"], l2_error=err))
        list_timings()
        print(json.dumps({"sweep": rows}))
        return

    pe = float(np.linalg.norm(cvel)) * h_min / (2.0 * args.kappa)
    if pe > 1.0 and not args.stabilize:
        print(f"WARNING: cell Peclet {pe:.2f} > 1: the unstabilized "
              "Galerkin form is under-resolved and the symmetric V-cycle "
              "preconditioner degrades; refine, raise kappa, or pass "
              "--stabilize p|cell")
    kw = dict(rtol=args.rtol, maxiter=args.maxiter)
    if args.warm:
        convdiff_solve(hier, b, cvel, **kw)
    with Timer("bicgstab solve", sync=True):
        t0 = time.perf_counter()
        u, info = convdiff_solve(hier, b, cvel, **kw)
        sync(torch, device)
        wall = time.perf_counter() - t0
    err = l2_error(mesh, P, u.double().cpu().numpy(), u_exact)
    print(f"cell Peclet {pe:.3f}: {info['niter']} BiCGStab iterations, "
          f"rel resid {info['rel_resid']:.2e}, L2 err {err:.3e}")
    list_timings()
    print(json.dumps({"cell_pe": pe, "niter": info["niter"],
                      "rel_resid": info["rel_resid"], "l2_error": float(err),
                      "ms_per_iteration":
                      1e3 * wall / max(info["niter"], 1)}))


if __name__ == "__main__":
    main()
