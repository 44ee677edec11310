"""The port's assembled sparse operator (`ops/csr.py`, ``operator='csr'``)
against the JAX package (JAX keeps BCOO, the port torch sparse CSR).

The reference's own test builds the global interpolation matrix between
Q_p and Q_{p+1} and checks a linear function to 1e-9
(test/test_csr.cpp:78-117); the same gates here, the matvecs against the
matrix-free operator and JAX's, and the ``csr`` hierarchy against the
``dofmap`` one (trajectories, FCG counts, a sigma field, the assembled
shift) and against JAX's ``csr`` hierarchy (f64).
"""

import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from pmg_dolfinx_tpu.fem.mesh import BoxMesh as JBox  # noqa: E402
from pmg_dolfinx_tpu.fem.mesh import PerturbedBoxMesh as JPert  # noqa: E402
from pmg_dolfinx_tpu.ops import csr as jcsr  # noqa: E402
from pmg_dolfinx_tpu.solvers.pmg import PMGHierarchy as JH  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.assembly import (  # noqa: E402
    assemble_rhs,
    assemble_stiffness,
    lumped_mass_np,
)
from pmg_dolfinx_tpu_torch.fem.gll import interpolation_matrix_1d  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh  # noqa: E402
from pmg_dolfinx_tpu_torch.ops.csr import (  # noqa: E402
    InterpolationMatrixOperator,
    MatrixOperator,
)
from pmg_dolfinx_tpu_torch.ops.interpolate import (  # noqa: E402
    prolongate,
    restrict,
)
from pmg_dolfinx_tpu_torch.ops.laplacian import MatFreeLaplacian  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy  # noqa: E402


def test_matrix_operator_matches_matfree_and_jax():
    mesh = BoxMesh((3, 2, 3))
    P = 3
    mf = MatFreeLaplacian(mesh, P, kappa=2.0, device="cpu")
    mo = MatrixOperator(mesh, P, kappa=2.0, device="cpu")
    x = np.random.default_rng(0).standard_normal(mesh.num_dofs(P))
    y = mo(torch.tensor(x)).numpy()
    assert np.allclose(y, mf(torch.tensor(x)).numpy(), atol=1e-11)
    assert np.allclose(mo.diag.numpy(), mf.diag.numpy(), atol=1e-11)
    jmo = jcsr.MatrixOperator(JBox((3, 2, 3)), P, kappa=2.0)
    assert np.abs(y - np.asarray(jmo(jnp.asarray(x)))).max() <= 1e-12 * (
        np.abs(y).max())
    assert np.array_equal(mo.diag.numpy(), np.asarray(jmo.diag))
    yt = mo.transpose_apply(torch.tensor(x)).numpy()
    assert np.abs(yt - np.asarray(jmo.transpose_apply(jnp.asarray(x)))).max() \
        <= 1e-12 * np.abs(yt).max()


def test_interpolation_matrix_linear_exact():
    mesh = BoxMesh((3, 3, 3))
    Pc, Pf = 2, 3
    I = InterpolationMatrixOperator(mesh, Pc, Pf, device="cpu")
    lin = lambda c: 1.0 + 2 * c[:, 0] - 0.5 * c[:, 1] + 0.25 * c[:, 2]
    u_f = I.apply(torch.tensor(lin(mesh.dof_coords(Pc)))).numpy()
    assert np.linalg.norm(u_f - lin(mesh.dof_coords(Pf))) < 1e-9


def test_interpolation_matrix_matches_matfree_transfer_and_jax():
    mesh = BoxMesh((2, 3, 2))
    Pc, Pf = 1, 3
    I = InterpolationMatrixOperator(mesh, Pc, Pf, device="cpu")
    Ij = jcsr.InterpolationMatrixOperator(JBox((2, 3, 2)), Pc, Pf)
    M1 = torch.tensor(interpolation_matrix_1d(Pc, Pf))
    dmc, dmf = (torch.tensor(mesh.dofmap(P)).long() for P in (Pc, Pf))
    rng = np.random.default_rng(1)
    xc = rng.standard_normal(mesh.num_dofs(Pc))
    up = I.apply(torch.tensor(xc)).numpy()
    assert np.allclose(up, prolongate(torch.tensor(xc), dmc, dmf, M1,
                                      mesh.num_dofs(Pf)).numpy(), atol=1e-12)
    assert np.allclose(up, np.asarray(Ij.apply(jnp.asarray(xc))), atol=1e-13)
    xf = rng.standard_normal(mesh.num_dofs(Pf))
    ur = I.transpose_apply(torch.tensor(xf)).numpy()
    mult = torch.tensor(mesh.dof_multiplicity(Pf))
    assert np.allclose(ur, restrict(torch.tensor(xf), dmc, dmf, M1, mult,
                                    mesh.num_dofs(Pc)).numpy(), atol=1e-12)
    assert np.allclose(ur, np.asarray(Ij.transpose_apply(jnp.asarray(xf))),
                       atol=1e-13)


def test_csr_pmg_backend_matches_dofmap_and_jax_curved():
    """Curved mesh, per-cell kappa, sigma 2: the ``csr`` trajectory equals
    the port's ``dofmap`` one's and JAX's ``csr`` hierarchy's."""
    rng = np.random.default_rng(0)
    kap = 1.0 + 0.5 * rng.random(64)
    mesh = PerturbedBoxMesh((4, 4, 4))
    b = assemble_rhs(mesh, 3, lambda x: np.sin(np.pi * x[0]) * np.cos(x[1])
                     * (1.0 + x[2]))
    kw = dict(degrees=(1, 3), kappa=kap, coarse="direct", sigma=2.0)
    out = {}
    for op in ("dofmap", "csr"):
        u, res = PMGHierarchy(mesh, operator=op, device="cpu", **kw).solve(
            torch.tensor(b), num_cycles=8)
        out[op] = (u.numpy(), np.array(res))
    ud, rd = out["dofmap"]
    uc, rc = out["csr"]
    assert np.linalg.norm(uc - ud) < 1e-12 * np.linalg.norm(ud)
    assert np.max(np.abs(rc - rd) / rd) < 1e-12
    assert rc[-1] < 1e-2 * rc[0]
    uj, rj = JH(JPert((4, 4, 4)), operator="csr", **kw).solve(
        jnp.asarray(b), num_cycles=8)
    assert np.max(np.abs(rc - np.asarray(rj)) / np.asarray(rj)) <= 1e-10
    assert np.linalg.norm(uc - np.asarray(uj)) <= 1e-10 * np.linalg.norm(uc)


def test_csr_pmg_backend_fcg_and_sigma_field():
    mesh = BoxMesh((4, 4, 4))
    sig = lambda x: 1.0 + 3.0 * x[0] * x[1]
    b = torch.tensor(assemble_rhs(mesh, 3, lambda x: np.cos(np.pi * x[0])
                                  + x[2]))
    res = {}
    for op in ("dofmap", "csr"):
        h = PMGHierarchy(mesh, degrees=(1, 3), kappa=1.5, coarse="direct",
                         operator=op, sigma=sig, device="cpu")
        u, niter = h.solve_pcg(b, rtol=1e-10)
        res[op] = (u.numpy(), niter)
    assert res["csr"][1] == res["dofmap"][1]
    assert np.linalg.norm(res["csr"][0] - res["dofmap"][0]) < \
        1e-9 * np.linalg.norm(res["dofmap"][0])


def test_csr_fine_operator_matches_assembled_shift():
    mesh = BoxMesh((3, 4, 3))
    P, sigma = 3, 4.0
    h = PMGHierarchy(mesh, degrees=(1, P), kappa=2.0, coarse="smoother",
                     operator="csr", sigma=sigma, device="cpu")
    assert h.data["levels"][-1]["A"].layout == torch.sparse_csr
    A = assemble_stiffness(mesh, P, kappa=2.0, bc=True).tocsr()
    m3 = lumped_mass_np(mesh, P, bc_zero=True)
    x = np.random.default_rng(7).standard_normal(mesh.num_dofs(P))
    y = h.operator()(torch.tensor(x)).numpy()
    ref = A @ x + sigma * m3 * x
    assert np.linalg.norm(y - ref) < 1e-12 * np.linalg.norm(ref)
