"""Poisson on an EXTERNAL unstructured hex mesh on PyTorch/CUDA.

The port's counterpart of `examples/unstructured.py` (same flags and
defaults, plus ``--device``): the reference ingests arbitrary DOLFINx hex
meshes (src/mesh.hpp:17-98, examples/cg/main.cpp:39's ``--file``); this
driver loads one, builds the p-hierarchy on the unstructured backends and
solves with FCG(V):

    python examples/unstructured_torch.py --mesh-file mesh.npz   # or .msh
    python examples/unstructured_torch.py --demo-n 4             # L-shape
    python examples/unstructured_torch.py --demo-n 29 --degrees 1 3 6 \\
        --coarse amg --rtol 1e-6                                 # 16.0M dofs

npz files carry ``nodes`` (n, 3) float and ``cells`` (ncells, 8) int
(package corner order; ``corner_order='gmsh'`` marks Gmsh ordering);
``.msh`` files are Gmsh ASCII v2.2 or v4.1 (``--dirichlet-groups`` picks
physical surface groups as the Dirichlet boundary). The demo mode solves
the manufactured problem on the L-shaped extrusion (``3 n^3`` cells) and
reports the L2 error; file mode solves with f = 1. ``--operator`` other
than ``dofmap``, ``csr`` and ``dss`` needs per-axis structure and is
forced to ``dss`` (the fast unstructured backend, `ops/unstructured.py`).
``--coarse amg`` is the smoothed-aggregation coarse solve that scales
with the mesh (`solvers/amg.py`); ``--smoother schwarz`` the per-cell FDM
blocks of `solvers/schwarz_dss.py`. Every operator here is torch (index
gathers, einsums, cuSPARSE for ``csr``), as the JAX package runs XLA.
``--device cpu`` runs on the CPU. The last line is a JSON object:
``niter`` and, in the demo mode, ``l2_error``.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ndofs", type=int, default=50000,
                   help="accepted as in the JAX driver; the mesh sets the "
                        "size")
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument("--operator",
                   choices=["kron", "kron_blocked", "lattice",
                            "lattice_blocked", "dofmap", "csr", "dss"],
                   default="kron",
                   help="'dss' (forced for the box-only backends), "
                        "'dofmap' or 'csr' (assembled sparse matvec)")
    p.add_argument("--kappa", type=float, default=2.0)
    p.add_argument("--mesh-file", default=None,
                   help=".npz (nodes+cells) or Gmsh ASCII v2.2/v4.1 .msh")
    p.add_argument("--demo-n", type=int, default=0,
                   help="L-shaped demo mesh with 3*n^3 cells")
    p.add_argument("--degrees", type=int, nargs="+", default=[1, 3])
    p.add_argument("--coarse", choices=["direct", "cg", "smoother", "amg"],
                   default="direct",
                   help="'amg' = smoothed-aggregation multilevel coarse "
                        "(the scalable choice when the p=1 level outgrows "
                        "the dense 'direct' factor)")
    p.add_argument("--smoother", choices=["cheb", "schwarz"], default="cheb",
                   help="'schwarz' = per-cell FDM blocks from each cell's "
                        "own edge geometry")
    p.add_argument("--dirichlet-groups", nargs="+", default=None,
                   help="Gmsh physical surface group names to mark "
                        "Dirichlet (mesh-file mode; untagged faces stay "
                        "natural)")
    p.add_argument("--rtol", type=float, default=1e-8)
    p.add_argument("--maxiter", type=int, default=50)
    p.add_argument("--device", default="cuda",
                   help="torch device (default 'cuda')")
    return p.parse_args(argv)


def build(args, mesh=None):
    """The mesh, the demo's exact solution (or None), the rhs (host numpy)
    and the hierarchy for parsed ``args``; ``mesh`` (optional) is a
    prebuilt mesh to use instead of the demo / file one."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu_torch.fem.unstructured import (
        l_shaped_hex_mesh,
        load_hex_mesh_npz,
        read_gmsh_hex,
    )
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy
    from pmg_dolfinx_tpu_torch.utils.timers import Timer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False")
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    if args.operator not in ("dofmap", "csr", "dss"):
        print(f"unstructured topology: --operator {args.operator} needs "
              "per-axis structure; forcing 'dss' (the fast unstructured "
              "backend)")
        args.operator = "dss"

    demo = args.mesh_file is None
    if mesh is None:
        if demo:
            mesh = l_shaped_hex_mesh(args.demo_n or 4)
        elif args.mesh_file.endswith(".msh"):
            mesh = read_gmsh_hex(args.mesh_file,
                                 dirichlet=args.dirichlet_groups or True)
            if mesh.tagged_faces:
                print(f"physical surface groups: "
                      f"{sorted(mesh.tagged_faces)}")
        else:
            mesh = load_hex_mesh_npz(args.mesh_file)
    P = max(args.degrees)
    print(f"{mesh}, degree {P}: {mesh.num_dofs(P)} dofs "
          f"(backend {args.operator}, device {device})")

    pi = np.pi
    u_exact = None
    if demo:
        u_exact = lambda x: (np.sin(pi * x[0]) * np.sin(pi * x[1])
                             * np.sin(pi * x[2]))
        f = lambda x: 3.0 * pi**2 * args.kappa * u_exact(x)
    else:
        f = lambda x: np.ones(x.shape[1])

    with Timer("setup (dofmap merge + hierarchy + rhs)", sync=True):
        b = assemble_rhs(mesh, P, f)
        hier = PMGHierarchy(mesh, degrees=tuple(args.degrees),
                            kappa=args.kappa, dtype=dtype,
                            coarse=args.coarse, operator=args.operator,
                            smoother=args.smoother, device=device)
    return mesh, u_exact, b, hier


def run(argv=None, mesh=None):
    """Run the driver on ``argv``; returns ``(out, mesh, hier, b, u)``:
    the last line's dict, the mesh, the hierarchy, the rhs (on the
    device) and the FCG solution."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import l2_error_collocated
    from pmg_dolfinx_tpu_torch.utils.timers import Timer, list_timings

    args = parse(argv)
    mesh, u_exact, b, hier = build(args, mesh)
    b = torch.as_tensor(b, dtype=hier.dtype, device=hier.device)
    with Timer("fcg solve", sync=True):
        u, niter = hier.solve_pcg(b, rtol=args.rtol, maxiter=args.maxiter)
    out = {"niter": int(niter)}
    print(f"FCG(V): {niter} iterations to rtol {args.rtol:g}")
    if u_exact is not None:
        err = l2_error_collocated(mesh, max(args.degrees),
                                  u.double().cpu().numpy().astype(np.float64),
                                  u_exact)
        out["l2_error"] = float(err)
        print(f"L2 error vs manufactured solution: {err:.4e}")
    list_timings()
    return out, mesh, hier, b, u


def main(argv=None):
    out = run(argv)[0]
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
