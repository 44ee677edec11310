"""Per-axis lattice matrices and the p-transfers between degrees.

Port of the transfer half of `pmg_dolfinx_tpu.ops.lattice`: the axis
matrices are host numpy (float64, copied from the JAX package), the
transfers are three `torch.einsum` contractions along x, y and z — the
JAX package leaves them to XLA, so they are plain torch here too. The
general-hex apply of that module is not ported yet (ROADMAP.md, Queue 1
item 6).
"""

import numpy as np
import torch

from ..fem.gll import derivative_matrix, interpolation_matrix_1d


def axis_matrices(nc: int, P: int, dtype=np.float64):
    """Global per-axis (E, Dg) matrices of shape ``(nc*(P+1), nc*P+1)``."""
    n = P + 1
    N = nc * P + 1
    Q = nc * n
    D1 = derivative_matrix(P)
    E = np.zeros((Q, N), dtype=dtype)
    Dg = np.zeros((Q, N), dtype=dtype)
    for c in range(nc):
        for q in range(n):
            E[c * n + q, c * P + q] = 1.0
            Dg[c * n + q, c * P: c * P + n] = D1[q]
    return E, Dg


def axis_interpolation_matrix(nc: int, P_coarse: int, P_fine: int, dtype=np.float64):
    """Global per-axis inter-degree interpolation ``(nc*Pf+1, nc*Pc+1)``;
    its plain transpose is the restriction."""
    M1 = interpolation_matrix_1d(P_coarse, P_fine)
    Nf, Nc = nc * P_fine + 1, nc * P_coarse + 1
    I1 = np.zeros((Nf, Nc), dtype=dtype)
    for c in range(nc):
        # Overlapping interface rows receive identical values (C0 nodal).
        I1[c * P_fine: c * P_fine + P_fine + 1,
           c * P_coarse: c * P_coarse + P_coarse + 1] = M1
    return I1


def along_x(M, t):
    return torch.einsum("ax,xyz->ayz", M, t)


def along_y(M, t):
    return torch.einsum("by,xyz->xbz", M, t)


def along_z(M, t):
    return torch.einsum("cz,xyz->xyc", M, t)


def lattice_prolongate(x_c, I1s, shape_c):
    """Coarse->fine transfer via three per-axis dense contractions.
    Shape-preserving: lattice-shaped in -> lattice-shaped out, flat in ->
    flat out."""
    Ix, Iy, Iz = I1s
    t = x_c.reshape(shape_c)
    t = along_x(Ix, t)
    t = along_y(Iy, t)
    t = along_z(Iz, t)
    return t if x_c.ndim == 3 else t.reshape(-1)


def lattice_restrict(x_f, I1s, shape_f):
    """Fine->coarse transfer: the transposed per-axis contractions."""
    Ix, Iy, Iz = I1s
    t = x_f.reshape(shape_f)
    t = along_x(Ix.T, t)
    t = along_y(Iy.T, t)
    t = along_z(Iz.T, t)
    return t if x_f.ndim == 3 else t.reshape(-1)
