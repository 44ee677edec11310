"""Parity of the port's host-side numpy layer with the JAX package.

Both sides are float64 numpy computed by the same formulas, so the
arrays must be bit-identical (``np.array_equal``); where an ``eigh`` is
involved the bound is 1e-14 relative. Non-cubic meshes catch mixed-up
axes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pmg_dolfinx_tpu.fem import assembly as j_asm  # noqa: E402
from pmg_dolfinx_tpu.fem import geometry as j_geo  # noqa: E402
from pmg_dolfinx_tpu.fem import gll as j_gll  # noqa: E402
from pmg_dolfinx_tpu.fem.mesh import BoxMesh as JBoxMesh  # noqa: E402
from pmg_dolfinx_tpu.ops import kron as j_kron  # noqa: E402
from pmg_dolfinx_tpu.ops import lattice as j_lat  # noqa: E402
from pmg_dolfinx_tpu.solvers import fdm as j_fdm  # noqa: E402
from pmg_dolfinx_tpu_torch.fem import assembly as t_asm  # noqa: E402
from pmg_dolfinx_tpu_torch.fem import geometry as t_geo  # noqa: E402
from pmg_dolfinx_tpu_torch.fem import gll as t_gll  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh as TBoxMesh  # noqa: E402
from pmg_dolfinx_tpu_torch.ops import kron as t_kron  # noqa: E402
from pmg_dolfinx_tpu_torch.ops import lattice as t_lat  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers import fdm as t_fdm  # noqa: E402

NC = (3, 4, 5)
MIXED = ((True, False), (True, True), (False, True))


def _u(x):
    return np.sin(np.pi * x[0]) * np.sin(np.pi * x[1]) * np.cos(x[2])


@pytest.mark.parametrize("P", [1, 2, 3, 6])
def test_gll_tables_equal(P):
    for a, b in zip(t_gll.gauss_lobatto(P + 1), j_gll.gauss_lobatto(P + 1)):
        assert np.array_equal(a, b)
    for a, b in zip(t_gll.gauss_legendre(P + 3), j_gll.gauss_legendre(P + 3)):
        assert np.array_equal(a, b)
    assert np.array_equal(t_gll.derivative_matrix(P), j_gll.derivative_matrix(P))
    assert np.array_equal(t_gll.interpolation_matrix_1d(1, P),
                          j_gll.interpolation_matrix_1d(1, P))
    x = np.linspace(0.0, 1.0, 7)
    nodes = j_gll.gauss_lobatto(P + 1)[0]
    assert np.array_equal(t_gll.lagrange_tabulate(nodes, x, 1),
                          j_gll.lagrange_tabulate(nodes, x, 1))


@pytest.mark.parametrize("faces", [True, MIXED])
@pytest.mark.parametrize("P", [1, 3])
def test_box_mesh_equal(faces, P):
    tm, jm = TBoxMesh(NC, dirichlet_faces=faces), JBoxMesh(NC, dirichlet_faces=faces)
    assert tm.lattice_shape(P) == jm.lattice_shape(P) == tuple(n * P + 1 for n in NC)
    assert tm.num_dofs(P) == jm.num_dofs(P)
    assert tm.dirichlet_faces == jm.dirichlet_faces
    for name in ("boundary_dof_marker", "dof_coords", "dofmap"):
        assert np.array_equal(getattr(tm, name)(P), getattr(jm, name)(P)), name
    assert np.array_equal(tm.geometry_x, jm.geometry_x)
    assert np.array_equal(tm.geometry_dofmap, jm.geometry_dofmap)
    for a in range(3):
        assert np.array_equal(tm.h_cells[a], jm.h_cells[a])
        assert np.array_equal(tm.axis_nodes(a), jm.axis_nodes(a))


@pytest.mark.parametrize("P", [1, 3])
def test_geometry_and_rhs_equal(P):
    tm, jm = TBoxMesh(NC), JBoxMesh(NC)
    assert np.array_equal(t_geo.tabulate_geometry_dphi(P),
                          j_geo.tabulate_geometry_dphi(P))
    assert np.array_equal(t_geo.quadrature_weights_3d(P),
                          j_geo.quadrature_weights_3d(P))
    for a, b in zip(t_asm.geometry_factors_np(tm, P),
                    j_asm.geometry_factors_np(jm, P)):
        assert np.array_equal(a, b)
    assert np.array_equal(t_asm.assemble_rhs(tm, P, _u),
                          j_asm.assemble_rhs(jm, P, _u))
    u_h = np.random.default_rng(P).standard_normal(tm.num_dofs(P))
    assert t_asm.l2_error(tm, P, u_h, _u) == j_asm.l2_error(jm, P, u_h, _u)


def test_coefficient_helpers():
    tm, jm = TBoxMesh(NC), JBoxMesh(NC)
    assert t_asm.resolve_kappa_axes(tm, 2.5) == j_asm.resolve_kappa_axes(jm, 2.5)
    for a, b in zip(t_asm.resolve_kappa_split(tm, 2.5),
                    j_asm.resolve_kappa_split(jm, 2.5)):
        assert np.array_equal(a, b) if a is not None else b is None
    assert t_asm.resolve_sigma(0.5) == j_asm.resolve_sigma(0.5)
    assert t_asm.ops_shift_scalar(tm, 0.5, True) == j_asm.ops_shift_scalar(jm, 0.5, True)
    kc = np.linspace(1.0, 2.0, tm.ncells)
    for a, b in zip(t_asm.resolve_kappa(tm, kc), j_asm.resolve_kappa(jm, kc)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="per-cell kappa"):
        t_asm.resolve_kappa(tm, np.ones(tm.ncells + 1))


@pytest.mark.parametrize("P", [1, 3, 6])
def test_axis_matrices_equal(P):
    for nc in NC:
        h = 1.0 / nc
        for a, b in zip(t_kron.axis_stiffness_mass(nc, P, h),
                        j_kron.axis_stiffness_mass(nc, P, h)):
            assert np.array_equal(a, b)
        for a, b in zip(t_lat.axis_matrices(nc, P), j_lat.axis_matrices(nc, P)):
            assert np.array_equal(a, b)
        if P > 1:
            assert np.array_equal(t_lat.axis_interpolation_matrix(nc, 1, P),
                                  j_lat.axis_interpolation_matrix(nc, 1, P))


@pytest.mark.parametrize("ends", [(True, True), (True, False), (False, True)])
def test_axis_eig_close(ends):
    for nc in NC:
        Vt, lt = t_fdm._axis_eig(nc, 3, 1.0 / nc, ends=ends)
        Vj, lj = j_fdm._axis_eig(nc, 3, 1.0 / nc, ends=ends)
        assert np.abs(lt - lj).max() <= 1e-14 * np.abs(lj).max()
        assert np.abs(Vt - Vj).max() <= 1e-14 * np.abs(Vj).max()
