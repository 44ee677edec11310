"""Host-side setup shared by the distributed layouts.

Port of `pmg_dolfinx_tpu.parallel.dist._shifted_diag_np`. The rest of
`DistPMG` (the 1D slab layout) is ROADMAP.md Queue 1 item 10.
"""


def _shifted_diag_np(mesh, Pdeg, kappa_cells, sigma, sigma_field=None):
    """Global operator diagonal with the optional lumped-mass shift
    ``sigma`` (a sigma field scales the mass, `shifted_mass_np`) and the
    Robin faces' boundary mass (`robin_mass_np`)."""
    from ..fem.assembly import (robin_mass_np, shifted_mass_np,
                                stiffness_diagonal_np)

    d = stiffness_diagonal_np(mesh, Pdeg, kappa_cells)
    if sigma:
        d = d + sigma * shifted_mass_np(mesh, Pdeg, sigma_field)
    if getattr(mesh, "has_robin", False):
        d = d + robin_mass_np(mesh, Pdeg)
    return d
