"""Coarse-level (p=1) solver driver on PyTorch/CUDA: the AMG replacement.

The port's counterpart of `examples/amg.py` (the reference's
`examples/amg/main.cpp`: KSPCG preconditioned by hypre BoomerAMG on a
p=1 Poisson problem with a Gaussian source). The preconditioners:

- ``--pc jacobi``: Jacobi-CG (the coarse solve used inside PMG);
- ``--pc cheb``: CG preconditioned by a fixed fourth-kind Chebyshev sweep;
- ``--pc hmg``: CG preconditioned by one geometric h-multigrid V-cycle
  (`solvers.hmg`: Kronecker-sum levels on the box, the rediscretised
  lattice levels with ``--mesh perturbed``). With a dense ``direct``
  bottom the V-cycle is a fixed SPD operator and plain PCG applies; a
  ``cg`` bottom (coarsest level above 4096 dofs) is an inner Krylov solve,
  so the outer loop is flexible CG.

    python examples/amg_torch.py --ndofs 2000000 --pc hmg
    python examples/amg_torch.py --ndofs 2000000 --pc hmg --mesh perturbed
    python examples/amg_torch.py --ndofs 2000000 --pc hmg --kappa-field linear

Every operator here is plain torch (the p=1 lattice apply and the h-levels'
einsums), as the JAX package runs XLA there. ``--device cpu`` runs on the
CPU.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None, mesh=None):
    """Run the driver on ``argv``; ``mesh`` (optional) is a prebuilt mesh
    of the fitted cells and kind to use, so a caller running several
    preconditioners on one mesh computes its host geometry once. Returns
    the CG iteration count."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ndofs", type=int, default=50000,
                   help="target number of dofs (global)")
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument("--kappa", type=float, default=2.0)
    p.add_argument("--pc", choices=["jacobi", "cheb", "hmg"],
                   default="jacobi")
    p.add_argument("--rtol", type=float, default=1e-8)
    p.add_argument("--max-iters", type=int, default=500)
    p.add_argument("--mesh", choices=["box", "perturbed"], default="box",
                   help="'perturbed': curved hexahedra (with --pc hmg the "
                        "rediscretised curved h-levels)")
    p.add_argument("--kappa-field", choices=["const", "linear"],
                   default="const",
                   help="'linear': the variable DG-0 coefficient "
                        "kappa(x) = 1 + x (models.poisson.kappa_linear; "
                        "with --pc hmg the rediscretised lattice h-levels)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default 'cuda')")
    args = p.parse_args(argv)

    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh, PerturbedBoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import f_gauss, fit_box_cells
    from pmg_dolfinx_tpu_torch.ops.lattice import LatticeLaplacian
    from pmg_dolfinx_tpu_torch.solvers.cg import cg_solve, fcg_solve
    from pmg_dolfinx_tpu_torch.utils.timers import Timer, list_timings

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False")
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    nc = fit_box_cells(args.ndofs, 1)
    if args.pc == "hmg":
        # multiples of 4, so the geometric hierarchy can coarsen
        nc = tuple((c + 3) // 4 * 4 for c in nc)
    kind = PerturbedBoxMesh if args.mesh == "perturbed" else BoxMesh
    if mesh is None:
        mesh = kind(nc)
    elif tuple(mesh.nc) != nc or type(mesh) is not kind:
        raise ValueError(f"mesh {mesh} is not the fitted {kind.__name__} on "
                         f"{nc} cells")
    kappa = args.kappa
    if args.kappa_field == "linear":
        from pmg_dolfinx_tpu_torch.models.poisson import kappa_linear

        kappa = kappa_linear
    general = args.mesh == "perturbed" or args.kappa_field != "const"
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"mesh {nc} ({args.mesh}), p=1, ndofs={mesh.num_dofs(1)}, "
          f"kappa {args.kappa_field}, device {name}")

    op = LatticeLaplacian(mesh, 1, kappa=kappa, dtype=dtype, device=device)
    b = torch.as_tensor(assemble_rhs(mesh, 1, f_gauss), dtype=dtype,
                        device=device)

    precond = None
    if args.pc == "cheb":
        from pmg_dolfinx_tpu_torch.solvers.chebyshev import chebyshev4_solve
        from pmg_dolfinx_tpu_torch.solvers.tridiag import (
            lanczos_eigenvalue_estimates,
        )

        _, info = cg_solve(op, torch.ones_like(b), torch.zeros_like(b),
                           op.diag_inv, rtol=1e-6, maxiter=20, record=True)
        eigs = lanczos_eigenvalue_estimates(
            info["alphas"].cpu().numpy(), info["betas"].cpu().numpy(),
            info["stored"].cpu().numpy())
        lmax = 1.1 * eigs[-1]
        print(f"Chebyshev preconditioner with lmax = {lmax:.4f}")

        def precond(r):
            return chebyshev4_solve(op, r, torch.zeros_like(r), op.diag_inv,
                                    lmax, 3)
    flexible = False
    if args.pc == "hmg":
        from pmg_dolfinx_tpu_torch.solvers.pmg import v_cycle

        if general:
            # the curved operator or the DG-0 kappa rediscretised on
            # every h-level
            from pmg_dolfinx_tpu_torch.solvers.hmg import build_hmg_general

            levels, data, bottom, hops = build_hmg_general(
                mesh, 1, kappa, dtype, device=device)
        else:
            from pmg_dolfinx_tpu_torch.solvers.hmg import build_hmg
            from pmg_dolfinx_tpu_torch.solvers.pmg import kron_cycle_ops

            levels, data, bottom = build_hmg(mesh, 1, kappa, dtype,
                                             device=device)
            hops = kron_cycle_ops("highest")
        flexible = bottom != "direct"
        print(f"h-MG preconditioner: {len(levels)} levels "
              f"{[lv.shape for lv in levels]}, bottom '{bottom}'"
              f"{' -> flexible CG outer' if flexible else ''}")

        def precond(r):
            u0 = hops["zeros"](levels[-1], r)
            u = v_cycle(data, r.reshape(u0.shape), u0, levels=levels,
                        coarse=bottom, coarse_cfg={}, ops=hops)
            return u.reshape(r.shape)

    with Timer("ZZZ Solve", sync=True):
        if flexible:
            x, info = fcg_solve(op, b, torch.zeros_like(b), precond,
                                rtol=args.rtol, maxiter=args.max_iters)
        else:
            x, info = cg_solve(op, b, torch.zeros_like(b), op.diag_inv,
                               rtol=args.rtol, maxiter=args.max_iters,
                               precond=precond)
    print(f"CG iterations: {int(info['niter'])}, "
          f"|r|_M = {float(info['rnorm'])**0.5:.4e}")
    r = b - op(x)
    print(f"final true |r| = {float(torch.linalg.vector_norm(r)):.4e}")
    list_timings()
    return int(info["niter"])


if __name__ == "__main__":
    main()
