"""Assembled sparse device operator (the reference's CSR path).

Port of `pmg_dolfinx_tpu.ops.csr`: the counterpart of `acc::MatrixOperator`
(src/csr.hpp:59-296), an explicitly assembled sparse matrix on the device
applied with sparse matvecs. The reference uses it as the oracle of the
matrix-free kernels, as an alternative fine operator for the whole PMG
solve (examples/pmg/main.cpp:40-43), for the Jacobi diagonal and as the
assembled global interpolation matrix between two spaces
(csr.hpp:133-203).

Assembly happens on the host (scipy, float64: `fem.assembly` is the
golden model) and the matrix moves to the device as a torch sparse CSR
tensor (JAX keeps a BCOO); ``A @ x`` is the library's sparse matvec
(cuSPARSE on the card), as JAX computes it with a library sparse product
and no Pallas kernel. The two-space constructor builds the global
interpolation matrix as the sparse Kronecker product of the per-axis 1D
interpolation matrices.
"""

import warnings

import numpy as np
import scipy.sparse as sp
import torch

from ..fem.assembly import assemble_stiffness
from .lattice import axis_interpolation_matrix


def to_sparse_csr(M, dtype, device):
    """A scipy sparse matrix as a torch sparse CSR tensor of ``dtype`` on
    ``device`` (column indices sorted, explicit zeros kept)."""
    C = sp.csr_matrix(M)
    C.sort_indices()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.as_tensor(C.indptr.astype(np.int64), device=device),
            torch.as_tensor(C.indices.astype(np.int64), device=device),
            torch.as_tensor(C.data, dtype=dtype, device=device),
            size=C.shape)


class MatrixOperator:
    """Assembled stiffness operator on the device (sparse CSR).

    Same call contract as the matrix-free operators: ``op(x) -> A x`` with
    Dirichlet rows/columns eliminated and unit diagonal."""

    def __init__(self, mesh, P, kappa=1.0, dtype=torch.float64,
                 shift_diag=None, *, device):
        """``shift_diag`` (optional, host array of length ndofs) is added
        to the assembled diagonal: the GLL-lumped shift ``sigma * m3``
        (and the baked Robin boundary mass) the matrix-free backends
        apply at runtime."""
        self.P = int(P)
        self.mesh = mesh
        self.device = torch.device(device)
        A = assemble_stiffness(mesh, self.P, kappa=kappa, bc=True).tocsr()
        if shift_diag is not None:
            A = (A + sp.diags(np.asarray(shift_diag,
                                         dtype=np.float64))).tocsr()
        self.shape = A.shape
        self._A = to_sparse_csr(A, dtype, self.device)
        self._AT = to_sparse_csr(A.T, dtype, self.device)
        self.diag = torch.as_tensor(A.diagonal(), dtype=dtype,
                                    device=self.device)
        self.diag_inv = 1.0 / self.diag

    def __call__(self, x):
        return torch.mv(self._A, x)

    def transpose_apply(self, x):
        return torch.mv(self._AT, x)


class InterpolationMatrixOperator:
    """Assembled global inter-degree interpolation matrix (sparse CSR) on a
    box mesh: ``apply`` prolongates (coarse -> fine), ``transpose_apply``
    restricts (fine -> coarse)."""

    def __init__(self, mesh, P_coarse, P_fine, dtype=torch.float64, *,
                 device):
        Is = [
            sp.csr_matrix(axis_interpolation_matrix(nc_a, P_coarse, P_fine))
            for nc_a in mesh.nc
        ]
        I = sp.kron(sp.kron(Is[0], Is[1]), Is[2]).tocsr()
        self.shape = I.shape
        self.device = torch.device(device)
        self._I = to_sparse_csr(I, dtype, self.device)
        self._IT = to_sparse_csr(I.T, dtype, self.device)

    def apply(self, x_coarse):
        return torch.mv(self._I, x_coarse)

    def transpose_apply(self, x_fine):
        return torch.mv(self._IT, x_fine)
