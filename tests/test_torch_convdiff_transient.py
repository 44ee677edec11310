"""The port's transient convection-diffusion (`convdiff_fdm_evolve`,
`convdiff_advective_dt`) against the JAX package, float64 on the CPU.

- BE and CNAB trajectories on a graded box with mixed faces, a sigma
  reaction, a source and a time factor: to 1e-12 relative in max-norm;
  `convdiff_advective_dt` equal to 1e-14 (graded included).
- JAX's oracle: the BE fixed point is the steady system, the port's own
  `convdiff_solve` answer (with and without sigma), to 1e-8.
- Bad schemes and velocities raise as in JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pmg_dolfinx_tpu.fem.mesh import BoxMesh as JBox  # noqa: E402
from pmg_dolfinx_tpu.solvers import transient as jt  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh, geometric_spacing  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers import transient as tt  # noqa: E402

KAPPA = 1.0
CVEL = (1.2, -0.6, 0.3)


def _relmax(a, b):
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _f_convdiff(sigma):
    pi = np.pi

    def f(x):
        sx, sy, sz = (np.sin(pi * x[a]) for a in range(3))
        cx, cy, cz = (np.cos(pi * x[a]) for a in range(3))
        g = (pi * cx * sy * sz, pi * sx * cy * sz, pi * sx * sy * cz)
        return ((3.0 * pi**2 * KAPPA + sigma) * sx * sy * sz
                + sum(c_ * g_ for c_, g_ in zip(CVEL, g)))

    return f


@pytest.mark.parametrize("scheme", ["be", "cnab"])
def test_convdiff_fdm_evolve_matches_jax(scheme):
    faces = ((True, True), (True, False), (True, True))
    spacing = (None, geometric_spacing(4, 2.0), None)
    nc, P, sigma = (3, 4, 3), 3, 4.0
    mesh = BoxMesh(nc, dirichlet_faces=faces, spacing=spacing)
    jmesh = JBox(nc, dirichlet_faces=faces, spacing=spacing)
    c = mesh.dof_coords(P)
    u0 = np.where(mesh.boundary_dof_marker(P), 0.0,
                  np.cos(np.pi * c[:, 0]) * (1.0 + c[:, 1]) * c[:, 2])
    f = assemble_rhs(mesh, P, _f_convdiff(sigma))
    dt = 0.25 * tt.convdiff_advective_dt(mesh, P, CVEL)
    assert abs(dt / (0.25 * jt.convdiff_advective_dt(jmesh, P, CVEL))
               - 1) <= 1e-14
    kw = dict(kappa=KAPPA, dt=dt, scheme=scheme, sigma=sigma, f=f,
              f_time=lambda t: 1.0 + 0.3 * np.cos(15.0 * t))
    ut = tt.convdiff_fdm_evolve(mesh, P, CVEL, device="cpu", **kw)(u0, 6)
    uj = jt.convdiff_fdm_evolve(jmesh, P, CVEL, **kw)(u0, 6)
    assert ut.dtype == torch.float64 and tuple(ut.shape) == uj.shape
    assert _relmax(ut, uj) <= 1e-12


@pytest.mark.parametrize("sigma", [0.0, 3.0])
def test_be_steady_state_matches_convdiff_solve(sigma):
    from pmg_dolfinx_tpu_torch.solvers.convdiff import convdiff_solve
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    mesh, P = BoxMesh((4, 4, 4)), 3
    b = assemble_rhs(mesh, P, _f_convdiff(sigma))
    uT = tt.convdiff_fdm_evolve(mesh, P, CVEL, kappa=KAPPA, dt=0.02,
                                scheme="be", sigma=sigma, f=b,
                                device="cpu")(np.zeros(mesh.num_dofs(P)),
                                              400).reshape(-1)
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=KAPPA, coarse="fdm",
                        operator="kron", sigma=sigma, device="cpu")
    u_star, _ = convdiff_solve(hier, b, CVEL, rtol=1e-12)
    assert np.linalg.norm(uT - u_star) <= 1e-8 * np.linalg.norm(u_star)


def test_rejects_bad_scheme_and_velocity():
    mesh = BoxMesh((3, 3, 3))
    with pytest.raises(ValueError, match="scheme"):
        tt.convdiff_fdm_evolve(mesh, 2, CVEL, scheme="rk4", device="cpu")
    with pytest.raises(ValueError, match="3-vector"):
        tt.convdiff_fdm_evolve(mesh, 2, (1.0, 2.0), device="cpu")
