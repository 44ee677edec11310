"""Solution output: legacy-VTK structured grid and npz writers.

Port of `pmg_dolfinx_tpu.utils.io` (the reference's optional ``--output``
counterpart): the structured dof lattice as an ASCII VTK STRUCTURED_GRID
(ParaView, VisIt) or an ``.npz`` of the lattice and its coordinates, the
same bytes as the JAX package's. ``u`` is numpy or a tensor on any
device.
"""

import numpy as np

from .checkpoint import _host


def write_vtk(path, mesh, P, u, name="u"):
    """Write the dof lattice as an ASCII legacy-VTK structured grid."""
    NX, NY, NZ = mesh.lattice_shape(P)
    coords = mesh.dof_coords(P)
    u = _host(u).reshape(-1)
    if u.size != NX * NY * NZ:
        raise ValueError(f"u has {u.size} values for a {NX}x{NY}x{NZ} "
                         "lattice")
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write("pmg_dolfinx_tpu solution\nASCII\n")
        f.write("DATASET STRUCTURED_GRID\n")
        # VTK expects x fastest; the lattice is z fastest -> reorder.
        f.write(f"DIMENSIONS {NX} {NY} {NZ}\n")
        f.write(f"POINTS {NX * NY * NZ} double\n")
        pts = coords.reshape(NX, NY, NZ, 3).transpose(2, 1, 0, 3).reshape(-1, 3)
        np.savetxt(f, pts, fmt="%.10g")
        f.write(f"POINT_DATA {NX * NY * NZ}\n")
        f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
        vals = u.reshape(NX, NY, NZ).transpose(2, 1, 0).reshape(-1)
        np.savetxt(f, vals, fmt="%.10g")


def write_npz(path, mesh, P, u, **extra):
    """Write the solution lattice and its coordinates to an .npz
    archive (``extra`` arrays alongside)."""
    NX, NY, NZ = mesh.lattice_shape(P)
    np.savez(
        path,
        u=_host(u).reshape(NX, NY, NZ),
        coords=mesh.dof_coords(P).reshape(NX, NY, NZ, 3),
        **extra,
    )
