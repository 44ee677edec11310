"""Shared CLI plumbing of the port's transient and model-family drivers
(`heat_torch.py`, `wave_torch.py`; `nonlinear_torch.py`,
`convdiff_torch.py`, `modes_torch.py`)."""

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
                   help="graded spacing 'AXES:RATIO' (e.g. 'z:8'); the "
                        "FDM step solve stays exact on graded meshes")
    p.add_argument("--shards", type=str, default="",
                   help="shard the time loop: 'N' (x-slab) or 'sx,sy,sz' "
                        "(device grid), every shard stacked on the one "
                        "device; one distributed FDM solve per step, "
                        "gather-free (box mesh, parallel/transient_dist.py)")
    add_operator_flag(p, "accepted for the JAX twin's command line and "
                      "left unread, as there: each stepper picks its own "
                      "operator")
    p.add_argument("--device", default="cuda",
                   help="torch device (default 'cuda')")
    return p


# The operator backends of the JAX examples' ``--operator``
# (``examples/_common.py``).
OPERATORS = ["kron", "kron_blocked", "lattice", "lattice_blocked", "dofmap",
             "csr", "dss"]


def add_operator_flag(p, help):
    """``--operator`` with the JAX examples' choices."""
    p.add_argument("--operator", choices=OPERATORS, default="kron",
                   help=help)


def model_parser(doc):
    """The flags of the JAX package's ``examples/_common.py`` parser for the
    model-family drivers (``--ndofs``, ``--dtype``, ``--operator``,
    ``--kappa``), with ``--device`` in place of ``--cpu``."""
    p = argparse.ArgumentParser(description=doc,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ndofs", type=int, default=50000,
                   help="target number of dofs (global)")
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    add_operator_flag(p, "operator backend ('kron_blocked' and "
                      "'lattice_blocked' run the CUDA kernels, float32)")
    p.add_argument("--kappa", type=float, default=2.0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default 'cuda')")
    return p


def torch_device(args):
    """``(torch, device, dtype)`` from ``--device`` and ``--dtype``; a CUDA
    device without a card refuses."""
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False")
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device {name}")
    return torch, device, dtype


def parse_shards(s):
    """'4' -> 4 (x-slab), '2,2,1' -> (2, 2, 1) (device grid)."""
    parts = [int(v) for v in s.split(",")]
    if len(parts) == 1:
        return parts[0]
    if len(parts) != 3:
        raise SystemExit("--shards expects 'N' or 'sx,sy,sz'")
    return tuple(parts)


def shard_cells(nc, shards):
    """``nc`` rounded up per axis to a multiple of the shard layout."""
    import numpy as np

    if shards is None:
        return tuple(nc)
    sh3 = (shards, 1, 1) if np.ndim(shards) == 0 else shards
    return tuple((c + s - 1) // s * s for c, s in zip(nc, sh3))


def refuse_unported(args):
    """The transient drivers' flag whose layer the port does not have
    yet: ``--save-series``."""
    if getattr(args, "save_series", ""):
        raise SystemExit("--save-series: utils/io is not ported yet "
                         "(ROADMAP.md Queue 1 item 11)")


def setup(args):
    """``(torch, device, dtype, mesh)`` for the fitted unit cube (graded
    with ``--grade``; its cell counts rounded up to the ``--shards``
    layout)."""
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh, PerturbedBoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import fit_box_cells

    refuse_unported(args)
    _, device, dtype = torch_device(args)
    nc = shard_cells(fit_box_cells(args.ndofs, args.degree),
                     parse_shards(args.shards) if args.shards else None)
    spacing = None
    if args.grade:
        from pmg_dolfinx_tpu_torch.fem.mesh import geometric_spacing

        axes_s, ratio_s = args.grade.split(":")
        spacing = tuple(
            geometric_spacing(nc[a], float(ratio_s))
            if "xyz"[a] in axes_s else None
            for a in range(3)
        )
    kind = PerturbedBoxMesh if args.mesh == "perturbed" else BoxMesh
    mesh = kind(nc, spacing=spacing)
    return torch, device, dtype, mesh


def sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
