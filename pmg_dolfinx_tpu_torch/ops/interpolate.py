"""Inter-degree (p-level) transfers through the cell dofmaps.

Port of `pmg_dolfinx_tpu.ops.interpolate` (the reference's
`Interpolator`, src/interpolate.hpp): per cell the transfer is the triple
Kronecker product of the 1D interpolation matrix ``M1[f, c] =
l_c^{coarse}(x_f^{fine})``, applied sum-factorised. These are the
``operator="dofmap"`` transfers; the lattice families use the per-axis
contractions of `ops.lattice`.

- prolongation: ``v_f[dofmap_f] = (M (x) M (x) M) v_c[dofmap_c]``, a
  direct write (cells sharing a dof write identical values);
- restriction: ``v_c[dofmap_c] += (M^T)^(x)3 (v_f[dofmap_f] / mult_f)``,
  the multiplicity-weighted transpose (`index_add_`).
"""

import torch


def prolongate(x_coarse, dofmap_c, dofmap_f, M1, ndofs_f):
    """Coarse->fine interpolation on flat dof vectors (int64 dofmaps)."""
    nc = M1.shape[1]
    ncells = dofmap_c.shape[0]
    u = x_coarse.index_select(0, dofmap_c.reshape(-1)).reshape(
        ncells, nc, nc, nc)
    v = torch.einsum("ai,bj,ck,xijk->xabc", M1, M1, M1, u)
    out = torch.zeros(ndofs_f, dtype=x_coarse.dtype, device=x_coarse.device)
    # Duplicate indices carry identical values; any write order is exact.
    out[dofmap_f.reshape(-1)] = v.reshape(-1)
    return out


def restrict(x_fine, dofmap_c, dofmap_f, M1, mult_f, ndofs_c):
    """Fine->coarse multiplicity-weighted transpose transfer."""
    nf = M1.shape[0]
    ncells = dofmap_c.shape[0]
    xw = x_fine / mult_f
    u = xw.index_select(0, dofmap_f.reshape(-1)).reshape(ncells, nf, nf, nf)
    v = torch.einsum("ai,bj,ck,xabc->xijk", M1, M1, M1, u)
    out = torch.zeros(ndofs_c, dtype=x_fine.dtype, device=x_fine.device)
    return out.index_add_(0, dofmap_c.reshape(-1), v.reshape(-1))
