"""The Poisson model: ``-div(kappa grad u) = f`` on the unit cube.

Port of `pmg_dolfinx_tpu.models.poisson`: manufactured solution ``u_e =
sin(pi x) sin(pi y) sin(pi z)``, ``f = 3 pi^2 kappa u_e``, the mixed
Dirichlet/Neumann/Robin family (`u_exact_mixed`, `f_rhs_mixed`,
`robin_data`), the variable-coefficient, sigma-field and tensor sources
(`kappa_linear`, `f_rhs_variable`, `sigma_linear`, `f_rhs_sigma_field`,
`kappa_aniso`, `f_rhs_tensor`), the AMG driver's Gaussian source
`f_gauss`, the cube-fitting cell search, and the `PoissonProblem` bundle
with an explicit ``device`` (on a `BoxMesh`, or on a prebuilt ``mesh=``
such as `fem.mesh.PerturbedBoxMesh`).
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


def u_exact_mixed(dirichlet_faces):
    """Manufactured solution honoring a per-face Dirichlet/Neumann set
    (`BoxMesh(dirichlet_faces=...)`, unit extent): per axis,

    - (D, D): ``sin(pi t)``            (both ends zero)
    - (N, N): ``cos(pi t)``            (both end derivatives zero)
    - (D, N): ``sin(pi t / 2)``        (zero at 0, flat at 1)
    - (N, D): ``cos(pi t / 2)``        (flat at 0, zero at 1)

    Every factor is a 1D Laplace eigenfunction of the matching BC pair,
    so ``-lap u = (sum_a w_a^2) u`` stays separable (`f_rhs_mixed`).
    """
    facs = _mixed_axis_factors(dirichlet_faces)

    def u(x):
        return facs[0][0](x[0]) * facs[1][0](x[1]) * facs[2][0](x[2])

    return u


def _mixed_axis_factors(dirichlet_faces):
    """Per axis: (factor function, angular frequency w_a, derivative)."""
    out = []
    for lo, hi in dirichlet_faces:
        if lo and hi:
            out.append((lambda t: np.sin(np.pi * t), np.pi,
                        lambda t: np.pi * np.cos(np.pi * t)))
        elif not lo and not hi:
            out.append((lambda t: np.cos(np.pi * t), np.pi,
                        lambda t: -np.pi * np.sin(np.pi * t)))
        elif lo:  # Dirichlet low, Neumann high
            out.append((lambda t: np.sin(0.5 * np.pi * t), 0.5 * np.pi,
                        lambda t: 0.5 * np.pi * np.cos(0.5 * np.pi * t)))
        else:  # Neumann low, Dirichlet high
            out.append((lambda t: np.cos(0.5 * np.pi * t), 0.5 * np.pi,
                        lambda t: -0.5 * np.pi * np.sin(0.5 * np.pi * t)))
    return out


def grad_u_exact_mixed(dirichlet_faces):
    """Gradient of `u_exact_mixed` at points ``x[(3, npts)]``."""
    facs = _mixed_axis_factors(dirichlet_faces)

    def grad(x):
        v = [f(x[a]) for a, (f, _, _) in enumerate(facs)]
        d = [df(x[a]) for a, (_, _, df) in enumerate(facs)]
        return np.stack([d[0] * v[1] * v[2], v[0] * d[1] * v[2],
                         v[0] * v[1] * d[2]])

    return grad


def robin_data(kappa, u, grad_u, robin_alpha):
    """Robin boundary data ``g = kappa du/dn + alpha u`` per Robin face
    for a manufactured solution ``u`` with gradient ``grad_u`` on an
    axis-aligned box (outward normal ``-/+ e_axis``). ``kappa`` is a
    scalar or per-axis ``(kx, ky, kz)``. Returns the per-face dict
    `fem.assembly.robin_rhs_np` consumes."""
    ra = np.asarray(robin_alpha, dtype=np.float64)
    kax = (kappa if isinstance(kappa, (tuple, list))
           else (kappa, kappa, kappa))
    out = {}
    for axis in range(3):
        for side in range(2):
            a = float(ra[axis, side])
            if a == 0.0:
                continue
            sgn = -1.0 if side == 0 else 1.0

            def g(x, axis=axis, sgn=sgn, a=a, k=float(kax[axis])):
                return k * sgn * grad_u(x)[axis] + a * u(x)

            out[(axis, side)] = g
    return out


def f_rhs_mixed(kappa, dirichlet_faces, sigma=0.0):
    """Source for `u_exact_mixed`:
    ``f = (kappa sum_a w_a^2 + sigma) u_e``."""
    facs = _mixed_axis_factors(dirichlet_faces)
    lam = sum(w * w for _, w, _ in facs)
    u = u_exact_mixed(dirichlet_faces)

    def f(x):
        return (kappa * lam + sigma) * u(x)

    return f


def f_gauss(x):
    """The reference AMG driver's Gaussian point source
    ``1000 exp(-((x-.5)^2+(y-.5)^2)/.02)``: not the manufactured sine,
    which on a uniform p=1 grid is an exact eigenvector of every
    tensor-product operator (CG would converge in one iteration)."""
    return 1000.0 * np.exp(-((x[0] - 0.5) ** 2 + (x[1] - 0.5) ** 2) / 0.02)


def grad_u_exact(x):
    """Gradient of the manufactured solution at ``x[(3, npts)]``."""
    sx, sy, sz = (np.sin(np.pi * x[i]) for i in range(3))
    cx, cy, cz = (np.cos(np.pi * x[i]) for i in range(3))
    return np.pi * np.stack([cx * sy * sz, sx * cy * sz, sx * sy * cz])


def kappa_linear(x):
    """Smooth model coefficient ``kappa = 1 + x`` (variable-coefficient
    family; DG-0 sampled at cell centroids by `resolve_kappa`)."""
    return 1.0 + x[0]


def sigma_linear(x):
    """Smooth model reaction field ``sigma = 10 (1 + x + y)`` (the
    variable-sigma family; pointwise at dof coordinates — see
    `fem.assembly.resolve_sigma`)."""
    return 10.0 * (1.0 + x[0] + x[1])


def f_rhs_sigma_field(kappa, sigma_fn=sigma_linear):
    """Source for constant kappa + a reaction FIELD:
    ``f = 3 pi^2 kappa u_e + sigma(x) u_e``."""

    def f(x):
        return (3.0 * np.pi**2 * kappa + sigma_fn(x)) * u_exact(x)

    return f


def grad_kappa_linear(x):
    """Gradient of `kappa_linear`."""
    return np.stack([np.ones_like(x[0]), np.zeros_like(x[0]),
                     np.zeros_like(x[0])])


def f_rhs_variable(kappa_fn=kappa_linear, grad_kappa_fn=grad_kappa_linear,
                   sigma=0.0):
    """Source for the manufactured ``u_e`` under a smooth coefficient:
    ``f = -div(kappa grad u_e) + sigma u_e``
    ``  = kappa 3 pi^2 u_e - grad(kappa).grad(u_e) + sigma u_e``.

    ``sigma`` extends it to the shifted reaction-diffusion family.
    """

    def f(x):
        gk = grad_kappa_fn(x)
        gu = grad_u_exact(x)
        return ((3.0 * np.pi**2 * kappa_fn(x) + sigma) * u_exact(x)
                - (gk * gu).sum(axis=0))

    return f


def kappa_aniso(theta=np.pi / 6.0, ratio=100.0):
    """Constant anisotropic diffusion TENSOR: the classic
    strength-``ratio`` anisotropy rotated by ``theta`` in the x-z plane
    (so the strong direction is NOT grid-aligned — cross-derivative
    terms are exercised)."""
    c, s = np.cos(theta), np.sin(theta)
    R = np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])
    return R @ np.diag([1.0, 1.0, ratio]) @ R.T


def f_rhs_tensor(K, sigma=0.0):
    """Source for the manufactured ``u_e`` under a CONSTANT symmetric
    diffusion tensor: ``f = -div(K grad u_e) + sigma u_e
    = -sum_ab K_ab d_a d_b u_e + sigma u_e``.

    For ``u_e = sin(pi x) sin(pi y) sin(pi z)``:
    ``d_a^2 u_e = -pi^2 u_e`` and the cross terms are
    ``d_a d_b u_e = pi^2 cos_a cos_b sin_c`` (a != b).
    """
    K = np.asarray(K, dtype=np.float64)

    def f(x):
        sx, sy, sz = (np.sin(np.pi * x[i]) for i in range(3))
        cx, cy, cz = (np.cos(np.pi * x[i]) for i in range(3))
        tr = (K[0, 0] + K[1, 1] + K[2, 2]) * sx * sy * sz
        cross = 2.0 * (K[0, 1] * cx * cy * sz + K[0, 2] * cx * sy * cz
                       + K[1, 2] * sx * cy * cz)
        return np.pi**2 * (tr - cross) + sigma * sx * sy * sz

    return f


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
        """``kappa`` is any coefficient `PMGHierarchy` takes; for a
        non-constant kappa or a sigma field pass the matching source ``f``
        (e.g. `f_rhs_variable`). ``mesh`` (optional) replaces
        ``BoxMesh(nc)``, e.g. a `PerturbedBoxMesh` with
        ``operator='lattice_blocked'``; ``u_exact`` overrides the
        manufactured solution `error_l2` uses (pass the matching ``f``).
        ``robin_g`` (the per-face dict of `robin_data`, or a callable)
        adds the Robin data ``integral g v ds`` to ``b``. The parameters
        keep the JAX package's order: ``smoother`` is 'cheb', 'line',
        'line-x|y|z' or 'schwarz' (see `PMGHierarchy`)."""
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
            if self.hierarchy.kappa is None or callable(sigma):
                raise ValueError(
                    "non-constant kappa or a sigma field: pass the "
                    "matching source term f "
                    "(e.g. models.poisson.f_rhs_variable(...))"
                )
            f = f_rhs(self.hierarchy.kappa, sigma=sigma)
        b = assemble_rhs(self.mesh, self.degrees[-1], f)
        if robin_g is not None:
            from ..fem.assembly import robin_rhs_np

            b = b + robin_rhs_np(self.mesh, self.degrees[-1], robin_g)
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
