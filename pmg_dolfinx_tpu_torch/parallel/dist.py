"""Host-side setup shared by the distributed layouts.

Port of `pmg_dolfinx_tpu.parallel.dist._shifted_diag_np` for a scalar
coefficient and a scalar shift. The rest of `DistPMG` (the 1D slab
layout) is ROADMAP.md Queue 1 item 10.
"""

import numpy as np


def _stiffness_diagonal_np(mesh, Pdeg, kappa_cells):
    """The exact stiffness diagonal in float64 on the host (the dofmap
    formula of `ops.laplacian.laplacian_diagonal`, summed in cell order);
    Dirichlet rows get 1."""
    from ..fem.assembly import geometry_factors_np
    from ..fem.gll import derivative_matrix

    G, _ = geometry_factors_np(mesh, Pdeg)
    n = Pdeg + 1
    g = G.reshape(mesh.ncells, n, n, n, 6)
    kappa = np.broadcast_to(np.asarray(kappa_cells, np.float64),
                            (mesh.ncells,))[:, None, None, None]
    D = derivative_matrix(Pdeg)
    D2 = D * D
    d = np.diagonal(D)
    diag = (
        np.einsum("mi,cmjk->cijk", D2, g[..., 0])
        + np.einsum("mj,cimk->cijk", D2, g[..., 3])
        + np.einsum("mk,cijm->cijk", D2, g[..., 5])
        + 2.0
        * (
            d[:, None, None] * d[None, :, None] * g[..., 1]
            + d[:, None, None] * d[None, None, :] * g[..., 2]
            + d[None, :, None] * d[None, None, :] * g[..., 4]
        )
    ) * kappa
    out = np.bincount(mesh.dofmap(Pdeg).ravel(), weights=diag.ravel(),
                      minlength=mesh.num_dofs(Pdeg))
    out[mesh.boundary_dof_marker(Pdeg)] = 1.0
    return out


def _shifted_diag_np(mesh, Pdeg, kappa_cells, sigma, sigma_field=None):
    """Global operator diagonal with the optional lumped-mass shift
    ``sigma`` (a scalar). A sigma field and Robin faces raise
    NotImplementedError (ROADMAP.md Queue 1 item 7c)."""
    from ..fem.assembly import lumped_mass_np

    if sigma_field is not None or getattr(mesh, "has_robin", False):
        raise NotImplementedError(
            "sigma fields and Robin faces on the device grid are not ported "
            "yet (ROADMAP.md Queue 1 item 7c)")
    d = _stiffness_diagonal_np(mesh, Pdeg, kappa_cells)
    if sigma:
        d = d + sigma * lumped_mass_np(mesh, Pdeg, bc_zero=True)
    return d
