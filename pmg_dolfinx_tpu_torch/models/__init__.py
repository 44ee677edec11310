"""Problem definitions: the Poisson model with its manufactured solution."""

from .poisson import PoissonProblem, fit_box_cells
