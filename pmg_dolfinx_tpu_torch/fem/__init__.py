"""FEM infrastructure (numpy, host-side): 1D GLL rules, the box mesh,
geometry factors, RHS assembly and error norms."""

from .gll import (
    derivative_matrix,
    gauss_legendre,
    gauss_lobatto,
    lagrange_tabulate,
)
from .mesh import BoxMesh
