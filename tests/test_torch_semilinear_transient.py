"""The port's semilinear evolvers (`solvers.transient`) against the JAX
package on the CPU.

- `semilinear_fdm_evolve`, BE and CNAB, float64 on a graded box with a
  sigma shift, a source and a time factor: trajectories to 1e-12
  relative in max-norm. JAX's oracle: the BE fixed point is the steady
  `newton_solve` answer.
- `semilinear_newton_evolve` (implicit BE, kron + fdm hierarchy with the
  BE shift): the same per-step Newton counts, the state to 1e-10.
- `semilinear_packed_evolve` (float32, the kernels' plain versions on the
  CPU) against JAX's Pallas kernels in interpret mode, B = 1 and 3, BE
  and CNAB, cubic with a source, and Bratu (``N(0) != 0``): to 1e-5.
- The sharded JAX case ``test_dist_matches_single`` (transient_dist) is
  ROADMAP.md Queue 1 item 10 and is not ported here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pmg_dolfinx_tpu.fem.mesh import BoxMesh as JBox  # noqa: E402
from pmg_dolfinx_tpu.models import semilinear as js  # noqa: E402
from pmg_dolfinx_tpu.solvers import transient as jt  # noqa: E402
from pmg_dolfinx_tpu.solvers.pmg import PMGHierarchy as JHier  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs, l2_error  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh, geometric_spacing  # noqa: E402
from pmg_dolfinx_tpu_torch.models import semilinear as ts  # noqa: E402
from pmg_dolfinx_tpu_torch.models.poisson import u_exact  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers import transient as tt  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy  # noqa: E402

KAPPA, SIGMA, DT, NSTEPS = 1.2, 0.7, 2e-3, 6


def _relmax(a, b):
    a, b = np.asarray(a, np.float64).reshape(-1), np.asarray(b, np.float64)
    b = b.reshape(-1)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _mode(mesh, P):
    c = mesh.dof_coords(P)
    return np.where(mesh.boundary_dof_marker(P), 0.0,
                    np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
                    * np.sin(np.pi * c[:, 2]))


def _g(t):
    return 1.0 + 0.3 * np.cos(15.0 * t)


@pytest.mark.parametrize("scheme", ["be", "cnab"])
def test_semilinear_fdm_evolve_matches_jax(scheme):
    spacing = (None, geometric_spacing(4, 2.0), None)
    nc, P = (3, 4, 3), 3
    mesh, jmesh = BoxMesh(nc, spacing=spacing), JBox(nc, spacing=spacing)
    u0 = _mode(mesh, P)
    f = assemble_rhs(mesh, P, ts.f_rhs_semilinear(KAPPA, ts.cubic(2.0),
                                                   SIGMA))
    kw = dict(kappa=KAPPA, dt=DT, scheme=scheme, sigma=SIGMA, f=f,
              f_time=_g)
    ut = tt.semilinear_fdm_evolve(mesh, P, ts.cubic(2.0), device="cpu",
                                  **kw)(u0, NSTEPS)
    uj = jt.semilinear_fdm_evolve(jmesh, P, js.cubic(2.0), **kw)(u0, NSTEPS)
    assert ut.dtype == torch.float64 and tuple(ut.shape) == uj.shape
    assert _relmax(ut, uj) <= 1e-12
    with pytest.raises(ValueError, match="scheme"):
        tt.semilinear_fdm_evolve(mesh, P, ts.cubic(2.0), scheme="cn",
                                 device="cpu")


def test_be_steady_state_matches_newton_solve():
    """JAX's oracle: the IMEX BE fixed point is the steady semilinear
    system (400 steps of 0.02 land on the `newton_solve` answer)."""
    from pmg_dolfinx_tpu_torch.solvers.newton import newton_solve

    nc, P, nl = (3, 4, 3), 3, ts.cubic(2.0)
    mesh = BoxMesh(nc)
    b = assemble_rhs(mesh, P, ts.f_rhs_semilinear(KAPPA, nl, sigma=SIGMA))
    uT = tt.semilinear_fdm_evolve(mesh, P, nl, kappa=KAPPA, dt=0.02,
                                  scheme="be", sigma=SIGMA, f=b,
                                  device="cpu")(np.zeros(mesh.num_dofs(P)),
                                                400).reshape(-1)
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=KAPPA, coarse="fdm",
                        operator="kron", sigma=SIGMA, device="cpu")
    u_star, info = newton_solve(hier, b, nl, rtol=1e-12)
    assert info["converged"]
    assert np.linalg.norm(uT - u_star) <= 1e-7 * np.linalg.norm(u_star)
    assert l2_error(mesh, P, uT.numpy(), u_exact) < 5e-4


def test_semilinear_newton_evolve_matches_jax():
    nc, P = (3, 4, 3), 3
    mesh = BoxMesh(nc)
    u0 = _mode(mesh, P)
    f = assemble_rhs(mesh, P, ts.f_rhs_semilinear(KAPPA, ts.cubic(2.0),
                                                   SIGMA))
    kw = dict(degrees=(1, 3), kappa=KAPPA, coarse="fdm", operator="kron",
              sigma=SIGMA + 1.0 / DT)
    th = PMGHierarchy(mesh, device="cpu", **kw)
    jh = JHier(JBox(nc), **kw)
    ut, it = tt.semilinear_newton_evolve(th, mesh, P, ts.cubic(2.0), DT,
                                         rtol=1e-11, f=f, f_time=_g)(u0, 4)
    uj, ij = jt.semilinear_newton_evolve(jh, JBox(nc), P, js.cubic(2.0), DT,
                                         rtol=1e-11, f=f, f_time=_g)(u0, 4)
    assert it == ij and max(it) <= 5
    assert ut.dtype == torch.float64 and tuple(ut.shape) == uj.shape
    assert _relmax(ut, uj) <= 1e-10


def _batch0(mesh, P, B, seed=0):
    U0 = np.random.default_rng(seed).standard_normal(
        (B, mesh.num_dofs(P))).astype(np.float32)
    U0[:, mesh.boundary_dof_marker(P)] = 0.0
    return U0


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("scheme", ["be", "cnab"])
def test_semilinear_packed_evolve_matches_jax(scheme, B):
    nc, P = (4, 4, 4), 3
    mesh = BoxMesh(nc)
    U0 = 0.5 * _batch0(mesh, P, B)
    f = assemble_rhs(mesh, P, ts.f_rhs_semilinear(KAPPA, ts.cubic(2.0),
                                                   SIGMA))
    kw = dict(kappa=KAPPA, dt=DT, B=B, scheme=scheme, sigma=SIGMA, f=f,
              f_time=_g)
    Ut = tt.semilinear_packed_evolve(mesh, P, ts.cubic(2.0), device="cpu",
                                     **kw)(U0, 5)
    Uj = jt.semilinear_packed_evolve(JBox(nc), P, js.cubic(2.0),
                                     interpret=True, **kw)(U0, 5)
    assert Ut.dtype == torch.float32 and tuple(Ut.shape) == (B, U0.shape[1])
    assert _relmax(Ut, Uj) <= 1e-5


def test_semilinear_packed_bratu_matches_jax():
    """Bratu's ``N(0) = -lam``: the reaction's ``m3`` factor keeps the
    Dirichlet rows at zero."""
    nc, P, B = (4, 4, 4), 3, 3
    mesh = BoxMesh(nc)
    U0 = 0.1 * _batch0(mesh, P, B, seed=2)
    kw = dict(kappa=1.0, dt=DT, B=B, scheme="cnab")
    Ut = tt.semilinear_packed_evolve(mesh, P, ts.bratu(3.0), device="cpu",
                                     **kw)(U0, 5)
    Uj = jt.semilinear_packed_evolve(JBox(nc), P, js.bratu(3.0),
                                     interpret=True, **kw)(U0, 5)
    assert _relmax(Ut, Uj) <= 1e-5
    assert torch.all(Ut[:, torch.tensor(mesh.boundary_dof_marker(P))] == 0)
    with pytest.raises(ValueError, match="interpret"):
        tt.semilinear_packed_evolve(mesh, P, ts.bratu(3.0), B=B,
                                    interpret=True, device="cpu")
