#!/usr/bin/env python3
"""FCG(V) iterations per inverse solve of the general-family modal
analysis, JAX package and port, on the CPU.

    python3 tools/modes_fcg_cpu.py [--ndofs 30000] [--kmodes 4] [--lobpcg 3]

The modes drivers' general family (``--mesh perturbed``: `PerturbedBoxMesh`
fitted to ``--ndofs`` at p=3, kappa 2, the default ``lattice`` hierarchy
with the ``cg`` coarse solve, inner rtol 1e-11 and the 100-iteration cap
of `lowest_eigenpairs`) in float64, for ``--lobpcg`` LOBPCG iterations in
each package. Prints, per inverse action (one batched solve of ``--kmodes``
columns), each column's FCG count in both packages, and the share of
solves at the cap. The JAX counts are read from inside its traced LOBPCG
loop through ``jax.debug.callback``.
"""

import argparse
import os
import sys
import time

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CAP = 100   # lowest_eigenpairs' FCG maxiter, both packages


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ndofs", type=int, default=30000)
    ap.add_argument("--kmodes", type=int, default=4)
    ap.add_argument("--lobpcg", type=int, default=3,
                    help="LOBPCG iterations (maxiter of lowest_eigenpairs)")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    from pmg_dolfinx_tpu.fem.mesh import PerturbedBoxMesh as JPert
    from pmg_dolfinx_tpu.solvers.eig import lowest_eigenpairs as jeig
    from pmg_dolfinx_tpu.solvers.pmg import PMGHierarchy as JHier
    from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import fit_box_cells
    from pmg_dolfinx_tpu_torch.solvers.eig import lowest_eigenpairs
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    P = 3
    nc = fit_box_cells(args.ndofs, P)
    kw = dict(degrees=(1, P), kappa=2.0, coarse="cg", operator="lattice")
    eig_kw = dict(k=args.kmodes, maxiter=args.lobpcg, tol=1e-14)
    print(f"PerturbedBoxMesh {nc}, p={P}, {JPert(nc).num_dofs(P)} dofs, "
          f"k={args.kmodes}, {args.lobpcg} LOBPCG iterations")

    jcounts = []
    jh = JHier(JPert(nc), dtype=jnp.float64, **kw)
    fn = jh._pcg_many_fn()

    def counted(data, Bw, U0w, rtol, maxiter):
        U, info = fn(data, Bw, U0w, rtol, maxiter)
        jax.debug.callback(lambda n: jcounts.append(np.asarray(n).tolist()),
                           info["niter"])
        return U, info

    jh._pcg_many = counted
    t0 = time.perf_counter()
    jl, _, jit = jeig(JPert(nc), P, hierarchy=jh, **eig_kw)
    jsec = time.perf_counter() - t0

    tcounts = []
    th = PMGHierarchy(PerturbedBoxMesh(nc), dtype=torch.float64,
                      device="cpu", **kw)
    solve = th.solve_pcg_many

    def counted_t(B, rtol=1e-8, maxiter=50):
        U, n = solve(B, rtol=rtol, maxiter=maxiter)
        tcounts.append(n.tolist())
        return U, n

    th.solve_pcg_many = counted_t
    t0 = time.perf_counter()
    tl, _, tit = lowest_eigenpairs(PerturbedBoxMesh(nc), P, hierarchy=th,
                                   device="cpu", **eig_kw)
    tsec = time.perf_counter() - t0

    print(f"JAX:  {jit} LOBPCG iterations, {len(jcounts)} inverse actions, "
          f"{jsec:.1f} s (CPU); eigenvalues {np.round(jl, 6).tolist()}")
    print(f"port: {tit} LOBPCG iterations, {len(tcounts)} inverse actions, "
          f"{tsec:.1f} s (CPU); eigenvalues {np.round(tl, 6).tolist()}")
    print("FCG(V) iterations per column, per inverse action (JAX | port):")
    for i in range(max(len(jcounts), len(tcounts))):
        jc = jcounts[i] if i < len(jcounts) else None
        tc = tcounts[i] if i < len(tcounts) else None
        print(f"  action {i}: {jc} | {tc}")
    for name, c in (("JAX", jcounts), ("port", tcounts)):
        flat = np.concatenate([np.ravel(x) for x in c]) if c else np.zeros(0)
        print(f"{name}: {flat.size} solves, {int((flat >= CAP).sum())} at the "
              f"cap of {CAP}, mean {flat.mean():.1f}")


if __name__ == "__main__":
    main()
