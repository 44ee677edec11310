"""Operators: the Kronecker-sum Laplacian (plain torch and the blocked
CUDA kernels), the lattice p-transfers and the dot product."""
