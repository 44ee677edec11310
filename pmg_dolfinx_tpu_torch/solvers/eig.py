"""Matrix-free modal analysis: lowest eigenpairs of the diffusion pencil.

Port of `pmg_dolfinx_tpu.solvers.eig`. The smallest ``k`` generalized
eigenpairs of ``(K + sigma M) u = lam M u`` (stiffness against the
GLL-lumped mass) by shift-invert LOBPCG: with the diagonal mass the
standard form is ``C = M^-1/2 K M^-1/2``, whose smallest eigenvalues are
the largest of ``C^-1 = M^1/2 K^-1 M^1/2``, the action `lobpcg_standard`
iterates on (`solvers.lobpcg`, a torch copy of the JAX package's LOBPCG,
so both take the same iterations). ``K^-1`` is

- the FDM direct solve (`FastDiagonalizationSolver.solve_many`) for an
  axis-aligned box with a constant scalar, per-axis or diagonal kappa;
- the V-cycle-preconditioned FCG solve to a fixed tolerance
  (`PMGHierarchy.solve_pcg_many`) for the general family (curved hexes,
  variable or tensor kappa, sigma fields), by default on a ``lattice``
  hierarchy.

Dirichlet rows are masked to eigenvalue 0 in the inverse action, so the
identity rows never enter the top-k block. Modal analysis runs in
float64.
"""

import numpy as np
import torch


def lowest_eigenpairs(mesh, P, kappa=2.0, k=4, sigma=0.0,
                      hierarchy=None, degrees=None, inner_rtol=1e-11,
                      maxiter=200, tol=None, seed=0, *,
                      dtype=torch.float64, device):
    """Smallest ``k`` eigenpairs of ``(K + sigma M) u = lam M u``.

    Returns ``(lams, U, iters)``: the eigenvalues ascending (numpy
    ``(k,)``), M-orthonormal eigenvectors ``(ndofs, k)`` on ``device``
    (zero at Dirichlet dofs) and the LOBPCG iteration count.
    ``hierarchy`` supplies a built float64 `PMGHierarchy` for the
    general-family inverse; otherwise one is built from ``degrees``
    (default ``(1, P)``) when the mesh or kappa is outside the FDM's
    domain. ``dtype`` must be float64 (the JAX package requires x64); the
    start block is ``np.random.default_rng(seed)``'s, as in the JAX
    package.
    """
    from ..fem.assembly import lumped_mass_np, resolve_kappa_axes
    from .lobpcg import lobpcg_standard

    if dtype != torch.float64:
        raise RuntimeError("lowest_eigenpairs requires dtype=torch.float64")
    ndofs = mesh.num_dofs(P)
    if 5 * k >= ndofs:
        raise ValueError(f"need 5*k < ndofs (k={k}, ndofs={ndofs})")
    f64 = dict(dtype=torch.float64, device=device)
    bc = torch.tensor(np.asarray(mesh.boundary_dof_marker(P)), device=device)
    sm = torch.tensor(np.sqrt(lumped_mass_np(mesh, P)), **f64)

    use_fdm = (getattr(mesh, "is_axis_aligned", True)
               and hierarchy is None
               and not callable(sigma))  # a sigma field: general inverse
    if use_fdm:
        try:
            resolve_kappa_axes(mesh, kappa)
        except ValueError:
            use_fdm = False
    if use_fdm:
        from .fdm import FastDiagonalizationSolver

        fd = FastDiagonalizationSolver(mesh, P, kappa=kappa,
                                       dtype=torch.float64, sigma=sigma,
                                       device=device)
        solve_many = fd.solve_many
    else:
        from .pmg import PMGHierarchy

        hier = hierarchy
        if hier is None:
            # Reached only for the general family (a curved mesh, or a
            # coefficient the FDM rejected): the lattice backend.
            hier = PMGHierarchy(
                mesh, degrees=tuple(degrees or (1, P)), kappa=kappa,
                dtype=torch.float64, coarse="cg", operator="lattice",
                sigma=sigma, device=device,
            )

        def solve_many(B):
            U, _ = hier.solve_pcg_many(B, rtol=float(inner_rtol),
                                       maxiter=100)
            return U.reshape(B.shape)

    def inv_action(X):
        # (n, k) -> (n, k): C^-1 X = M^1/2 K^-1 M^1/2 X, bc rows masked.
        B = torch.where(bc[None, :], 0.0, (sm[:, None] * X).T)
        U = solve_many(B)
        return sm[:, None] * torch.where(bc[None, :], 0.0, U).T

    X0 = torch.tensor(np.random.default_rng(seed).standard_normal((ndofs, k)),
                      **f64)
    X0 = torch.where(bc[:, None], 0.0, X0)
    theta, Y, iters = lobpcg_standard(inv_action, X0, m=maxiter, tol=tol)
    lams = 1.0 / theta
    order = torch.argsort(lams)
    lams = lams[order]
    # Back to the generalized problem: u = M^-1/2 y (M-orthonormal).
    U = torch.where(bc[:, None], 0.0, Y[:, order] / sm[:, None])
    return lams.cpu().numpy(), U, int(iters)
