"""Modal-analysis driver on PyTorch/CUDA: smallest eigenmodes of the
diffusion pencil.

The port's counterpart of `examples/modes.py` (same flags). ``K u = lam M
u`` (GLL-lumped mass) by shift-invert LOBPCG on the framework's inverses
(`solvers/eig.py`): the FDM direct solve for axis-aligned constant or
per-axis kappa, the FCG(V) solve for curved hexes or a variable kappa. On
the constant-kappa unit cube the spectrum is printed beside the analytic
``kappa pi^2 (i^2+j^2+k^2)`` values. Runs in float64, on the card unless
``--device cpu`` (the JAX driver always runs on the CPU).

    python examples/modes_torch.py --ndofs 100000 --kmodes 6 --neumann x \\
        --sigma 5
    python examples/modes_torch.py --ndofs 30000 --mesh perturbed
"""

import json
import time

import numpy as np

from _common_torch import model_parser, sync, torch_device


def _analytic(kappa, faces, kmodes, sigma=0.0):
    """Lowest continuum eigenvalues on the unit cube for separable BC sets:
    per axis (pi n)^2 with n >= 1 (D,D), n >= 0 (N,N), or (pi (n +
    1/2))^2 with n >= 0 (mixed)."""
    per_axis = []
    for lo, hi in faces:
        if lo and hi:
            w = [(np.pi * n) ** 2 for n in range(1, kmodes + 2)]
        elif not lo and not hi:
            w = [(np.pi * n) ** 2 for n in range(0, kmodes + 2)]
        else:
            w = [(np.pi * (n + 0.5)) ** 2 for n in range(0, kmodes + 2)]
        per_axis.append(w)
    sums = sorted(a + b + c for a in per_axis[0] for b in per_axis[1]
                  for c in per_axis[2])
    return [kappa * s + sigma for s in sums[:kmodes]]


def run(argv=None):
    """Parse ``argv`` (``sys.argv`` when None), solve and print; returns
    ``(result, mesh, lams, U)``, ``result`` the final JSON line's dict."""
    p = model_parser(__doc__)
    p.add_argument("--kmodes", type=int, default=4,
                   help="number of lowest eigenpairs")
    p.add_argument("--sigma", type=float, default=0.0,
                   help="lumped-mass shift (screened pencil)")
    p.add_argument("--degree", type=int, default=3)
    p.add_argument("--neumann", type=str, default="",
                   help="axes whose BOTH faces are natural-Neumann")
    p.add_argument("--mesh", choices=["box", "perturbed"], default="box")
    p.add_argument("--kappa-field", choices=["const", "linear"],
                   default="const")
    args = p.parse_args(argv)
    args.dtype = "f64"  # modal analysis runs in f64
    torch, device, _ = torch_device(args)

    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh, PerturbedBoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import (fit_box_cells,
                                                      kappa_linear)
    from pmg_dolfinx_tpu_torch.solvers.eig import lowest_eigenpairs
    from pmg_dolfinx_tpu_torch.utils.timers import Timer, list_timings

    nc = fit_box_cells(args.ndofs, args.degree)
    faces = tuple((False, False) if "xyz"[a] in args.neumann
                  else (True, True) for a in range(3))
    if args.neumann and not any(any(f) for f in faces) and not args.sigma:
        raise SystemExit("all-Neumann with sigma=0 is singular; add --sigma "
                         "or keep one Dirichlet axis")
    mk = PerturbedBoxMesh if args.mesh == "perturbed" else BoxMesh
    mesh = mk(nc, dirichlet_faces=faces)
    kappa = kappa_linear if args.kappa_field == "linear" else args.kappa
    print(f"mesh {nc[0]}x{nc[1]}x{nc[2]} ({args.mesh}), p={args.degree}, "
          f"{mesh.num_dofs(args.degree)} dofs, device {device}")
    with Timer(f"lowest {args.kmodes} eigenpairs (LOBPCG)", sync=True):
        t0 = time.perf_counter()
        lams, U, iters = lowest_eigenpairs(
            mesh, args.degree, kappa=kappa, k=args.kmodes, sigma=args.sigma,
            device=device)
        sync(torch, device)
        wall = time.perf_counter() - t0
    print(f"LOBPCG iterations: {iters}")
    print("eigenvalues:", " ".join(f"{l:.6f}" for l in lams))
    if args.mesh == "box" and args.kappa_field == "const":
        ana = _analytic(args.kappa, faces, args.kmodes, sigma=args.sigma)
        print("analytic:   ", " ".join(f"{l:.6f}" for l in ana))
        rel = np.abs(np.asarray(lams) - ana) / np.asarray(ana)
        print("rel deviation (discretization):",
              " ".join(f"{r:.2e}" for r in rel))
    list_timings()
    result = {"eigenvalues": [float(l) for l in lams], "iters": iters,
              "seconds": wall}
    print(json.dumps(result))
    return result, mesh, lams, U


def main():
    run()


if __name__ == "__main__":
    main()
