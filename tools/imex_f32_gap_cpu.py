#!/usr/bin/env python3
"""The float32 accuracy of the IMEX CNAB steppers, JAX package and port, on
the CPU: each package's f32 run against its own f64 run.

    python3 tools/imex_f32_gap_cpu.py [--nc 42] [--steps 200]

`convdiff_fdm_evolve` (velocity (3,-1.5,0.8), kappa 2, the convdiff
driver's manufactured source, dt a quarter of `convdiff_advective_dt`) and
`semilinear_fdm_evolve` (cubic(5), its manufactured source, dt 1e-4) on
``BoxMesh((nc,)*3)`` at p=3 from zero: `chip_smoke.py` phase 25d's
configuration at the default ``--nc 42`` (2,048,383 dofs). Prints, per
stepper, the relative 2-norm and max-norm of f32 - f64 for each package.
"""

import argparse
import os

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nc", type=int, default=42)
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args()
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    from pmg_dolfinx_tpu.fem.mesh import BoxMesh as JBox
    from pmg_dolfinx_tpu.models import semilinear as js
    from pmg_dolfinx_tpu.solvers import transient as jt
    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.models import semilinear as ts
    from pmg_dolfinx_tpu_torch.solvers import transient as tt

    nc, P, cvel = (args.nc,) * 3, 3, (3.0, -1.5, 0.8)
    mesh = BoxMesh(nc)
    pi = np.pi

    def f_cd(x):
        sx, sy, sz = (np.sin(pi * x[a]) for a in range(3))
        cx, cy, cz = (np.cos(pi * x[a]) for a in range(3))
        g = (pi * cx * sy * sz, pi * sx * cy * sz, pi * sx * sy * cz)
        return (3.0 * pi**2 * 2.0 * sx * sy * sz
                + sum(c_ * g_ for c_, g_ in zip(cvel, g)))

    dt_cd = 0.25 * tt.convdiff_advective_dt(mesh, P, cvel)
    b_cd = assemble_rhs(mesh, P, f_cd)
    b_sl = assemble_rhs(mesh, P, ts.f_rhs_semilinear(2.0, ts.cubic(5.0)))
    u0 = np.zeros(mesh.num_dofs(P))
    jobs = {
        "convdiff cnab": (
            lambda d: jt.convdiff_fdm_evolve(JBox(nc), P, cvel, kappa=2.0,
                                             dt=dt_cd, f=b_cd, dtype=d),
            lambda d: tt.convdiff_fdm_evolve(mesh, P, cvel, kappa=2.0,
                                             dt=dt_cd, f=b_cd, dtype=d,
                                             device="cpu")),
        "semilinear cnab": (
            lambda d: jt.semilinear_fdm_evolve(JBox(nc), P, js.cubic(5.0),
                                               kappa=2.0, dt=1e-4, f=b_sl,
                                               dtype=d),
            lambda d: ts_evolve(tt, mesh, P, ts, b_sl, d)),
    }
    for tag, (jmake, tmake) in jobs.items():
        for pkg, make, f32, f64 in (
                ("jax", jmake, jnp.float32, jnp.float64),
                ("port", tmake, torch.float32, torch.float64)):
            a = np.asarray(make(f32)(u0, args.steps), np.float64).reshape(-1)
            b = np.asarray(make(f64)(u0, args.steps), np.float64).reshape(-1)
            print(f"{tag} {pkg}: f32 vs f64 after {args.steps} steps: rel "
                  f"2-norm {np.linalg.norm(a - b) / np.linalg.norm(b):.3e}, "
                  f"rel max {np.abs(a - b).max() / np.abs(b).max():.3e}",
                  flush=True)


def ts_evolve(tt, mesh, P, ts, f, dtype):
    return tt.semilinear_fdm_evolve(mesh, P, ts.cubic(5.0), kappa=2.0,
                                    dt=1e-4, f=f, dtype=dtype, device="cpu")


if __name__ == "__main__":
    main()
