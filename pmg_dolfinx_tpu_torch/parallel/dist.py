"""Host-side setup shared by the distributed layouts.

Port of `pmg_dolfinx_tpu.parallel.dist._shifted_diag_np` for a scalar
coefficient and a scalar shift. The rest of `DistPMG` (the 1D slab
layout) is ROADMAP.md Queue 1 item 10.
"""


def _shifted_diag_np(mesh, Pdeg, kappa_cells, sigma, sigma_field=None):
    """Global operator diagonal with the optional lumped-mass shift
    ``sigma`` (a scalar). A sigma field and Robin faces raise
    NotImplementedError (ROADMAP.md Queue 1 item 7c)."""
    from ..fem.assembly import cell_scalar, lumped_mass_np, stiffness_diagonal_np

    if sigma_field is not None or getattr(mesh, "has_robin", False):
        raise NotImplementedError(
            "sigma fields and Robin faces on the device grid are not ported "
            "yet (ROADMAP.md Queue 1 item 7c)")
    d = stiffness_diagonal_np(mesh, Pdeg, cell_scalar(kappa_cells))
    if sigma:
        d = d + sigma * lumped_mass_np(mesh, Pdeg, bc_zero=True)
    return d
