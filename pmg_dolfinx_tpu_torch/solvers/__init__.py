"""Solvers: CG with coefficient recording, FCG, the fourth-kind
Chebyshev smoother, Lanczos eigenvalue estimates, the FDM direct solve,
the p-multigrid V-cycle and the geometric h-multigrid coarse solver."""

from .cg import cg_solve, fcg_solve
from .chebyshev import chebyshev4_solve
from .fdm import FastDiagonalizationSolver
from .hmg import build_hmg
from .pmg import Level, PMGHierarchy, v_cycle
from .tridiag import lanczos_eigenvalue_estimates, tqli
