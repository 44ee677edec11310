"""Operators: the Kronecker-sum Laplacian (plain torch and the blocked
CUDA kernels), the general-hex lattice and dofmap Laplacians (plain torch
and the lattice CUDA kernels), the p-transfers and the dot product."""
