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
    python examples/pmg_torch.py --ndofs 2000000 --degrees 1 3 6 \\
        --coarse fdm --operator kron_blocked --refined --fmg
    python examples/pmg_torch.py --ndofs 16000000 --degrees 1 3 6 \\
        --coarse fdm --operator kron_blocked --smoother schwarz --pcg
    python examples/pmg_torch.py --ndofs 16200000 --degrees 1 3 6 \\
        --mesh perturbed --coarse fdm --pcg     # switches to --coarse hmg

``--gamma 2`` runs W-cycles, ``--fmg`` starts from the full-multigrid
guess, ``--refined`` wraps the working-dtype V-cycle in float64
iterative refinement, ``--fdm`` solves directly by fast diagonalization
(with ``--refined``: f64 refinement around it), ``--smoother-iters``
sets the Chebyshev iterations per smoothing pass. ``--smoother``
picks the p-levels' Chebyshev preconditioner: point Jacobi ('cheb'),
line relaxation ('line' along the strongest coupling, or 'line-x|y|z';
moderate sizes) or the cell-wise FDM Schwarz blocks ('schwarz', any
size). ``--coarse direct`` is the dense Cholesky coarse solve (moderate
sizes), ``--coarse hmg`` nested geometric h-multigrid cycles, with
``--hmg-smoother`` for the h-levels and ``--semicoarsen AXES|auto`` to
coarsen the strongly-coupled axes first.

The model family: ``--kappa-field linear`` (the DG-0 kappa ``1 + x``,
switches a Kronecker operator to ``lattice``), ``aniso`` (a 100:1 tensor
rotated 30 degrees, folded into the geometry factors: ``lattice_blocked``
in f32) or ``aniso-diag`` (``diag(1, 1, 100)``, per-axis: the Kronecker
family and ``--fdm`` stay); ``--sigma S`` (a lumped-mass shift) or
``--sigma-field`` (``10 (1 + x + y)``, general backends); ``--grade
AXES:RATIO`` (geometric grading); ``--neumann AXES`` / ``--robin AXES``
(homogeneous Neumann or Robin ``alpha = 2`` on both faces of the axes,
with the matching manufactured solution), as in the JAX driver:

    python examples/pmg_torch.py --ndofs 16000000 --degrees 1 3 6 \\
        --coarse fdm --operator kron_blocked --pcg \\
        --grade z:8 --neumann x --robin y

``--operator kron_blocked`` and ``lattice_blocked`` run the hand-written
CUDA kernels (`pmg_dolfinx_tpu_torch/csrc/`, float32); ``kron``,
``lattice`` and ``dofmap`` are plain torch. ``--mesh perturbed`` builds
the curved-hex `PerturbedBoxMesh` and switches a Kronecker operator to
``lattice_blocked`` (f32) or ``lattice`` (f64), and ``--coarse fdm`` to
``hmg`` (the curved operator rediscretised per h-level). ``--device cpu`` runs
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


def model_family(args, nc):
    """The JAX driver's model-family flags, resolved as it resolves them:
    ``(kappa, f, sigma, u_exact, robin_g, robin, faces, spacing)``, with
    the operator switched to a general backend where a coefficient needs
    one (``args.operator`` is updated)."""
    import numpy as np

    from pmg_dolfinx_tpu_torch.models import poisson as pm

    kappa, f, sigma = args.kappa, None, args.sigma
    if args.sigma_field:
        if (args.sigma or args.kappa_field != "const" or args.neumann
                or args.robin or args.fdm):
            raise SystemExit("--sigma-field: use alone (constant kappa, "
                             "no --sigma/--neumann/--robin/--fdm — the "
                             "manufactured source is built for that "
                             "combination, and the FDM shift must be "
                             "separable)")
        sigma = pm.sigma_linear
        f = pm.f_rhs_sigma_field(args.kappa)
        if args.operator in ("kron", "kron_blocked"):
            args.operator = "lattice"
            print("sigma field: switching operator backend to 'lattice'")
    if args.kappa_field == "linear":
        kappa, f = pm.kappa_linear, pm.f_rhs_variable(sigma=args.sigma)
        if args.operator in ("kron", "kron_blocked"):
            args.operator = "lattice"
            print("variable kappa: switching operator backend to 'lattice'")
    elif args.kappa_field == "aniso":
        kappa = pm.kappa_aniso()
        f = pm.f_rhs_tensor(kappa, sigma=args.sigma)
        if args.operator in ("kron", "kron_blocked"):
            args.operator = ("lattice_blocked" if args.dtype == "f32"
                             else "lattice")
            print("tensor kappa: switching operator backend to "
                  f"'{args.operator}'")
    elif args.kappa_field == "aniso-diag":
        # per-axis: the Kronecker family and the FDM solve stay
        kappa = np.diag([1.0, 1.0, 100.0])
        f = pm.f_rhs_tensor(kappa, sigma=args.sigma)
    u_exact = robin_g = robin = None
    faces = True
    if args.neumann or args.robin:
        if args.kappa_field != "const":
            raise SystemExit("--neumann/--robin support --kappa-field "
                             "const only (the manufactured mixed-BC "
                             "solution is constant-kappa)")
        if set(args.neumann) & set(args.robin):
            raise SystemExit("--neumann and --robin must name disjoint "
                             "axes")
        faces = tuple(
            ((False, False)
             if "xyz"[a] in args.neumann or "xyz"[a] in args.robin
             else (True, True))
            for a in range(3)
        )
        f = pm.f_rhs_mixed(args.kappa, faces, sigma=args.sigma)
        u_exact = pm.u_exact_mixed(faces)
        if args.robin:
            if args.mesh == "perturbed":
                raise SystemExit("--robin manufactures the surface data "
                                 "g on flat faces (axis-aligned box "
                                 "only)")
            robin = tuple(
                (2.0, 2.0) if "xyz"[a] in args.robin else (0.0, 0.0)
                for a in range(3)
            )
            robin_g = pm.robin_data(args.kappa, u_exact,
                                    pm.grad_u_exact_mixed(faces), robin)
            print(f"Robin faces (alpha=2) on axes '{args.robin}'"
                  + (f", Neumann on '{args.neumann}'" if args.neumann
                     else "") + f": dirichlet_faces={faces}")
        else:
            print(f"Neumann faces on axes '{args.neumann}': "
                  f"dirichlet_faces={faces}")
    spacing = None
    if args.grade:
        from pmg_dolfinx_tpu_torch.fem.mesh import geometric_spacing

        try:
            axes_s, ratio_s = args.grade.split(":")
            ratio = float(ratio_s)
            grade_axes = tuple(sorted("xyz".index(a) for a in axes_s))
        except (ValueError, IndexError):
            raise SystemExit("--grade expects 'AXES:RATIO', e.g. 'z:8' "
                             "or 'xyz:4'")
        spacing = tuple(
            geometric_spacing(nc[a], ratio) if a in grade_axes else None
            for a in range(3)
        )
        print(f"graded spacing on axes '{axes_s}' (geometric, ratio "
              f"{ratio:g})")
    return kappa, f, sigma, u_exact, robin_g, robin, faces, spacing


def main(argv=None):
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
    p.add_argument("--coarse",
                   choices=["smoother", "cg", "direct", "hmg", "fdm"],
                   default="cg")
    p.add_argument("--semicoarsen", type=str, default="",
                   help="h-MG semi-coarsening axes, e.g. 'z' or 'xy', or "
                        "'auto' (with --coarse hmg: coarsen the "
                        "strongly-coupled axes first; "
                        "solvers.hmg.semicoarsen_sizes)")
    p.add_argument("--smoother", type=str, default="cheb",
                   choices=["cheb", "line", "line-x", "line-y", "line-z",
                            "schwarz"],
                   help="p-level smoother preconditioner: point Jacobi, "
                        "line relaxation ('line' = the axis of the "
                        "strongest kappa_aa/h_a^2; moderate sizes) or "
                        "cell-wise FDM Schwarz (any size)")
    p.add_argument("--hmg-smoother", type=str, default="cheb",
                   choices=["cheb", "line", "line-x", "line-y", "line-z",
                            "schwarz"],
                   help="h-level smoother preconditioner (with --coarse "
                        "hmg)")
    p.add_argument("--smoother-iters", type=int, default=2,
                   help="Chebyshev iterations per smoothing pass")
    p.add_argument("--gamma", type=int, default=1,
                   help="cycle index: 1 = V-cycle, 2 = W-cycle")
    p.add_argument("--refined", action="store_true",
                   help="mixed-precision refinement: f64 outer residual + "
                        "working-dtype V-cycle")
    p.add_argument("--pcg", action="store_true",
                   help="V-cycle-preconditioned flexible CG outer solver")
    p.add_argument("--fdm", action="store_true",
                   help="fast-diagonalization direct solve (box mesh); "
                        "with --refined, f64 refinement around it")
    p.add_argument("--fmg", action="store_true",
                   help="full-multigrid initial guess")
    p.add_argument("--warm", action="store_true",
                   help="run one throwaway solve first so the timed solve "
                        "excludes the kernel build and first launches")
    p.add_argument("--device", default="cuda",
                   help="torch device (default 'cuda')")
    p.add_argument("--kappa-field",
                   choices=["const", "linear", "aniso", "aniso-diag"],
                   default="const",
                   help="'linear': kappa(x) = 1 + x (DG-0; a general "
                        "backend); 'aniso': a 100:1 tensor rotated 30 "
                        "degrees off the grid (folded into the geometry "
                        "factors); 'aniso-diag': diag(1, 1, 100), per-axis "
                        "(the Kronecker family and --fdm apply)")
    p.add_argument("--sigma", type=float, default=0.0,
                   help="lumped-mass shift: -div(kappa grad u) + sigma u "
                        "= f")
    p.add_argument("--sigma-field", action="store_true",
                   help="reaction field sigma(x) = 10 (1 + x + y) "
                        "(models.poisson.sigma_linear; general backends)")
    p.add_argument("--grade", type=str, default="",
                   help="graded spacing 'AXES:RATIO', e.g. 'z:8' or "
                        "'xyz:4' (geometric, largest cell RATIO times the "
                        "smallest); the whole Kronecker family and --fdm "
                        "carry it")
    p.add_argument("--neumann", type=str, default="",
                   help="axes whose both faces carry the homogeneous "
                        "Neumann condition instead of Dirichlet, e.g. 'x'")
    p.add_argument("--robin", type=str, default="",
                   help="axes whose both faces carry the Robin condition "
                        "kappa du/dn + alpha u = g (alpha = 2), e.g. 'y' "
                        "(axis-aligned box, constant kappa)")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="after the solve, trace N V-cycles with "
                        "torch.profiler and print the device time by "
                        "kernel (CUDA only)")
    args = p.parse_args(argv)

    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh, PerturbedBoxMesh
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
    kappa, f, sigma, u_exact, robin_g, robin, faces, spacing = (
        model_family(args, nc))
    mesh = None
    if args.mesh == "perturbed":
        mesh = PerturbedBoxMesh(nc, dirichlet_faces=faces, spacing=spacing)
        if args.operator in ("kron", "kron_blocked"):
            args.operator = ("lattice_blocked" if args.dtype == "f32"
                             else "lattice")
            print("perturbed (general-hex) mesh: switching operator "
                  f"backend to '{args.operator}'")
        if args.coarse == "fdm":
            args.coarse = "hmg"
            print("perturbed mesh: switching coarse solver to 'hmg' "
                  "(fdm is axis-aligned only; hmg rediscretizes the "
                  "curved operator per h-level)")
    elif faces is not True or spacing is not None:
        mesh = BoxMesh(nc, dirichlet_faces=faces, robin=robin,
                       spacing=spacing)
    print(f"mesh {args.mesh} {nc[0]}x{nc[1]}x{nc[2]}, degrees "
          f"{args.degrees}, operator {args.operator}, device {name}, "
          f"dtype {args.dtype}")

    with Timer("setup (operators+calibration+rhs)", sync=True):
        coarse_cfg = {}
        if args.gamma > 1:
            coarse_cfg["gamma"] = args.gamma
        if args.hmg_smoother != "cheb":
            if args.coarse != "hmg":
                raise SystemExit("--hmg-smoother requires --coarse hmg")
            coarse_cfg["smoother"] = args.hmg_smoother
        if args.semicoarsen:
            from pmg_dolfinx_tpu_torch.solvers.hmg import (
                semicoarsen_axes,
                semicoarsen_sizes,
            )

            if args.coarse != "hmg":
                raise SystemExit("--semicoarsen requires --coarse hmg")
            if args.semicoarsen == "auto":
                axes = semicoarsen_axes(mesh or BoxMesh(nc), kappa)
                print(f"semi-coarsening axes (auto): "
                      f"{''.join('xyz'[a] for a in axes) or '(none)'}")
            else:
                axes = tuple(sorted("xyz".index(a)
                                    for a in args.semicoarsen))
            coarse_cfg["sizes"] = semicoarsen_sizes(nc, axes)
            print(f"semi-coarsened h-levels: {coarse_cfg['sizes']}")
        prob = PoissonProblem(
            nc=nc, degrees=tuple(args.degrees), kappa=kappa,
            dtype=dtype, coarse=args.coarse, operator=args.operator, f=f,
            mesh=mesh, sigma=sigma, coarse_cfg=coarse_cfg or None,
            smoother_iters=args.smoother_iters, smoother=args.smoother,
            u_exact=u_exact, robin_g=robin_g, device=device,
        )
    ndofs = [prob.mesh.num_dofs(P) for P in args.degrees]
    print("hierarchy:", " -> ".join(f"p={P}: {n}"
                                    for P, n in zip(args.degrees, ndofs)))
    for P, eig in zip(args.degrees, prob.hierarchy.eigs):
        print(f"  level p={P}: eig range estimate "
              f"[{eig[0]:.4f}, {eig[-1]:.4f}]")

    if args.fdm:
        if args.fmg:
            raise SystemExit("--fmg is an initial guess for the iterative "
                             "solvers; --fdm is a direct solve: drop one")
        if args.kappa_field not in ("const", "aniso-diag"):
            raise SystemExit("--fdm is a constant-coefficient (or diagonal-"
                             "tensor) direct solve; use --pcg for variable "
                             "kappa")
        from pmg_dolfinx_tpu_torch.solvers.fdm import (
            FastDiagonalizationSolver,
        )

        fdm = FastDiagonalizationSolver(
            prob.mesh, args.degrees[-1],
            kappa=kappa if args.kappa_field == "aniso-diag" else args.kappa,
            dtype=dtype, sigma=args.sigma, device=device)
        with Timer("fdm solve", sync=True):
            if args.refined:
                u, rnorms = fdm.refine(prob.b, cycles=min(args.cycles, 4))
            else:
                u, rnorms = fdm.solve(prob.b), []
        r0 = float(torch.linalg.vector_norm(prob.b))
        for i, r in enumerate(rnorms):
            print(f"refine {i}: rel = {r / r0:.4e}")
        err = prob.error_l2(u)
        print(f"L2 error vs manufactured solution: {err:.4e}")
        list_timings()
        rel = rnorms[-1] / r0 if rnorms else None
        print(json.dumps({"rel_residual": rel, "l2_error": err}))
        return

    def _solve():
        if args.refined:
            return prob.hierarchy.solve_refined(prob.b,
                                                num_cycles=args.cycles,
                                                fmg=args.fmg)
        if args.pcg:
            u, niter = prob.hierarchy.solve_pcg(prob.b, rtol=1e-8,
                                                maxiter=args.cycles,
                                                fmg=args.fmg)
            return u, [], niter
        return (*prob.solve(num_cycles=args.cycles, fmg=args.fmg),)

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
