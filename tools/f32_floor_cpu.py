#!/usr/bin/env python3
"""The f32 L2 floor of the Kronecker and the lattice operator forms, in
the JAX package and in the port, side by side on the CPU.

    python3 tools/f32_floor_cpu.py [--nc 8] [--degrees 1 3 6]

Solves the flagship's manufactured problem (`PoissonProblem`, kappa 2,
``sin(pi x) sin(pi y) sin(pi z)``) on one `BoxMesh` with FCG(V) to rtol
1e-6, in float32 with `kron` + `fdm` and with `lattice` + `cg` (the two
configurations whose 16.2M-dof L2 errors differ by three orders), and in
float64 with both for the discretization error. Each run goes through
the JAX package and through the port (``device="cpu"``: the kernels'
plain versions), and the script prints one line per run: package,
operator, dtype, FCG count and L2 error. A CPU-only parity tool: it
imports both packages, as the tests do.
"""

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--nc", type=int, default=8)
    p.add_argument("--degrees", type=int, nargs="+", default=[1, 3, 6])
    p.add_argument("--rtol", type=float, default=1e-6)
    args = p.parse_args()

    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import torch

    from pmg_dolfinx_tpu.models.poisson import PoissonProblem as JP
    from pmg_dolfinx_tpu_torch.models.poisson import PoissonProblem as TP

    nc = (args.nc,) * 3
    degrees = tuple(args.degrees)
    configs = (("kron", "fdm"), ("lattice", "cg"))
    print(f"BoxMesh {nc}, degrees {degrees}, "
          f"{(nc[0] * degrees[-1] + 1) ** 3} dofs, FCG(V) to {args.rtol:g}")
    for dname, jd, td in (("f32", jnp.float32, torch.float32),
                          ("f64", jnp.float64, torch.float64)):
        for op, coarse in configs:
            jp = JP(nc=nc, degrees=degrees, kappa=2.0, dtype=jd,
                    coarse=coarse, operator=op)
            u, it = jp.hierarchy.solve_pcg(jp.b, rtol=args.rtol, maxiter=50)
            print(f"jax   {op:8s} + {coarse:3s} {dname}: FCG {it:2d}, "
                  f"L2 {jp.error_l2(np.asarray(u, np.float64)):.4e}")
            tp = TP(nc=nc, degrees=degrees, kappa=2.0, dtype=td,
                    coarse=coarse, operator=op, device="cpu")
            u, it = tp.hierarchy.solve_pcg(tp.b, rtol=args.rtol, maxiter=50)
            print(f"torch {op:8s} + {coarse:3s} {dname}: FCG {it:2d}, "
                  f"L2 {tp.error_l2(u):.4e}")


if __name__ == "__main__":
    main()
