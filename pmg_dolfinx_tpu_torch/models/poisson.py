"""The Poisson model: ``-div(kappa grad u) = f`` on the unit cube.

Port of `pmg_dolfinx_tpu.models.poisson` for the flagship and curved-hex
solves: manufactured solution ``u_e = sin(pi x) sin(pi y) sin(pi z)``,
``f = 3 pi^2 kappa u_e``, the AMG driver's Gaussian source `f_gauss`,
the cube-fitting cell search, and the
`PoissonProblem` bundle with an explicit ``device`` (on a `BoxMesh`, or
on a prebuilt ``mesh=`` such as `fem.mesh.PerturbedBoxMesh`).
"""

import numpy as np
import torch

from ..fem.assembly import assemble_rhs, l2_error, l2_error_collocated
from ..fem.mesh import BoxMesh
from ..solvers.pmg import PMGHierarchy


def u_exact(x):
    """Manufactured solution evaluated at points ``x[(3, npts)]``."""
    return np.sin(np.pi * x[0]) * np.sin(np.pi * x[1]) * np.sin(np.pi * x[2])


def f_rhs(kappa, sigma=0.0):
    """Source term ``f = (3 pi^2 kappa + sigma) u_e``."""

    def f(x):
        return (3.0 * np.pi**2 * kappa + sigma) * u_exact(x)

    return f


def f_gauss(x):
    """The reference AMG driver's Gaussian point source
    ``1000 exp(-((x-.5)^2+(y-.5)^2)/.02)``: not the manufactured sine,
    which on a uniform p=1 grid is an exact eigenvector of every
    tensor-product operator (CG would converge in one iteration)."""
    return 1000.0 * np.exp(-((x[0] - 0.5) ** 2 + (x[1] - 0.5) ** 2) / 0.02)


def fit_box_cells(ndofs_target: int, max_degree: int, search: int = 5):
    """Pick (nx, ny, nz) so the finest space has ~``ndofs_target`` dofs:
    the cube-root estimate, then a local search of +/- ``search`` cells
    per direction for the best misfit."""
    n0 = max(1, int(round((ndofs_target ** (1.0 / 3.0) - 1) / max_degree)))
    best = (n0, n0, n0)
    best_misfit = abs((n0 * max_degree + 1) ** 3 - ndofs_target)
    if n0 > search:
        rng = range(n0 - search, n0 + search + 1)
        for nx in rng:
            for ny in rng:
                for nz in rng:
                    nd = (
                        (nx * max_degree + 1)
                        * (ny * max_degree + 1)
                        * (nz * max_degree + 1)
                    )
                    if abs(nd - ndofs_target) < best_misfit:
                        best_misfit = abs(nd - ndofs_target)
                        best = (nx, ny, nz)
    return best


class PoissonProblem:
    """Bundle: mesh + p-hierarchy + RHS + error evaluation, on ``device``."""

    def __init__(self, nc=(10, 10, 10), degrees=(1, 3), kappa=2.0,
                 dtype=torch.float64, coarse="smoother", coarse_cfg=None,
                 smoother_iters=2, operator="kron", precision="highest",
                 f=None, mesh=None, sigma=0.0, smoother="cheb",
                 u_exact=None, robin_g=None, *, device):
        """``mesh`` (optional) replaces ``BoxMesh(nc)``, e.g. a
        `PerturbedBoxMesh` with ``operator='lattice_blocked'``;
        ``u_exact`` overrides the manufactured solution `error_l2` uses
        (pass the matching ``f``). The parameters keep the JAX package's
        order: ``smoother`` is 'cheb', 'line', 'line-x|y|z' or 'schwarz'
        (see `PMGHierarchy`) and ``robin_g`` None (Robin data is ROADMAP.md
        Queue 1 item 7c)."""
        if robin_g is not None:
            raise NotImplementedError(
                "robin_g (Robin boundary data) is not ported yet (ROADMAP.md "
                "Queue 1 item 7c)")
        self.mesh = mesh if mesh is not None else BoxMesh(nc)
        self.degrees = tuple(degrees)
        self.kappa = kappa
        self._u_exact = u_exact if u_exact is not None else globals()["u_exact"]
        self.hierarchy = PMGHierarchy(
            self.mesh, degrees=self.degrees, kappa=kappa, dtype=dtype,
            coarse=coarse, coarse_cfg=coarse_cfg,
            smoother_iters=smoother_iters, operator=operator,
            precision=precision, sigma=sigma, smoother=smoother,
            device=device,
        )
        if f is None:
            f = f_rhs(self.hierarchy.kappa, sigma=sigma)
        b = assemble_rhs(self.mesh, self.degrees[-1], f)
        self.b = torch.as_tensor(b, dtype=dtype, device=self.hierarchy.device)

    def solve(self, num_cycles=10, residuals=True, u0=None, fmg=False):
        """Run the stationary V-cycle iteration; ``u0`` resumes from an
        iterate, ``fmg`` starts from the full-multigrid guess."""
        return self.hierarchy.solve(self.b, num_cycles=num_cycles,
                                    residuals=residuals, u0=u0, fmg=fmg)

    def error_l2(self, u):
        """L2 error of the discrete solution (flat, any device) vs the
        manufactured solution: the Gauss-Legendre rule of `l2_error` on
        axis-aligned meshes, the geometry-general collocated GLL rule on
        general (perturbed) ones."""
        u = np.asarray(torch.as_tensor(u).detach().to("cpu", torch.float64))
        if getattr(self.mesh, "is_axis_aligned", True):
            return l2_error(self.mesh, self.degrees[-1], u, self._u_exact)
        return l2_error_collocated(self.mesh, self.degrees[-1], u,
                                   self._u_exact)

    def interpolate_exact(self):
        """u_e sampled at the fine-space dofs (numpy, for initial guesses
        and tests)."""
        coords = self.mesh.dof_coords(self.degrees[-1])
        return self._u_exact(coords.T)
