"""Shared CLI plumbing of the port's transient drivers (`heat_torch.py`,
`wave_torch.py`)."""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def base_parser(doc):
    """The flags every transient driver of the port shares."""
    p = argparse.ArgumentParser(description=doc,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ndofs", type=int, default=50000,
                   help="target number of dofs (global)")
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument("--kappa", type=float, default=2.0)
    p.add_argument("--degree", type=int, default=3)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--mesh", choices=["box", "perturbed"], default="box")
    p.add_argument("--rtol", type=float, default=1e-9,
                   help="per-step FCG tolerance (perturbed mesh only)")
    p.add_argument("--batch", type=int, default=0,
                   help="serving mode: step BATCH trajectories through the "
                        "kron_packed kernels (f32, NZ <= 64; B=1 uses the "
                        "single-RHS classes)")
    p.add_argument("--grade", type=str, default="",
                   help="graded spacing (not ported)")
    p.add_argument("--shards", type=str, default="",
                   help="distributed time loop (not ported)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default 'cuda')")
    return p


def refuse_unported(args):
    """The JAX driver's flags whose layers the port does not have yet."""
    if args.grade:
        raise SystemExit("--grade: graded spacing is not ported yet "
                         "(ROADMAP.md Queue 1 item 7c)")
    if args.shards:
        raise SystemExit("--shards: the distributed steppers "
                         "(transient_dist) are not ported yet (ROADMAP.md "
                         "Queue 1 item 10)")
    if getattr(args, "save_series", ""):
        raise SystemExit("--save-series: utils/io is not ported yet "
                         "(ROADMAP.md Queue 1 item 11)")


def setup(args):
    """``(torch, device, dtype, mesh)`` for the fitted unit cube."""
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh, PerturbedBoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import fit_box_cells

    refuse_unported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False")
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    nc = fit_box_cells(args.ndofs, args.degree)
    mesh = PerturbedBoxMesh(nc) if args.mesh == "perturbed" else BoxMesh(nc)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device {name}")
    return torch, device, dtype, mesh


def sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
