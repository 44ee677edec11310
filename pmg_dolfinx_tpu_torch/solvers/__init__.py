"""Solvers: CG with coefficient recording, FCG, the fourth-kind
Chebyshev smoother, Lanczos eigenvalue estimates, the FDM direct solve
and the p-multigrid V-cycle."""

from .cg import cg_solve, fcg_solve
from .chebyshev import chebyshev4_solve
from .fdm import FastDiagonalizationSolver
from .pmg import Level, PMGHierarchy, v_cycle
from .tridiag import lanczos_eigenvalue_estimates, tqli
