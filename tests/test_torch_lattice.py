"""Parity of the port's general-hex (curved) modules with the JAX package.

- Bit for bit (f64, equal arrays): `PerturbedBoxMesh` (``geometry_x``,
  ``dof_coords``, ``boundary_dof_marker``, ``dof_multiplicity``) and the
  host setup of the lattice kernels (`lattice_geom_coefficients`,
  `lattice_blocked_mats`, `geometry_to_gfirst`, `geometry_to_qlattice`,
  `lattice_geom_data`).
- Relative 1e-12 (f64): `scale_G`, `lumped_mass_np`,
  `l2_error_collocated`, `assemble_stiffness`; the dofmap operator
  (`laplacian_apply`, `laplacian_diagonal`, `MatFreeLaplacian`) and
  transfers (`prolongate`, `restrict`); `expand_axis0` / `fold_axis0` and
  `lattice_laplacian_apply`; `geom_to_G` against JAX's and against
  ``geometry_to_qlattice(scale_G(...))``.
- The kernel modules against the Pallas kernels run in interpret mode,
  f32, relative 2-norm <= 1e-5 (the JAX package's own bound): variants
  'yexp', 'v1', 'ym' and 'geom', scalar kappa through the operator
  classes and a per-cell positive kappa fed directly as G and ``co``.
- On the card, K-A and K-B against their plain versions (marked ``cuda``;
  skipped without a GPU). Those tests need no JAX, so on a GPU machine
  without JAX they run as
  ``python -m pytest --noconftest -m cuda tests/test_torch_lattice.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pmg_dolfinx_tpu_torch.fem import assembly as tasm  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh as TMesh  # noqa: E402
from pmg_dolfinx_tpu_torch.ops import interpolate as tip  # noqa: E402
from pmg_dolfinx_tpu_torch.ops import laplacian as tlap  # noqa: E402
from pmg_dolfinx_tpu_torch.ops import lattice as tlat  # noqa: E402
from pmg_dolfinx_tpu_torch.ops import lattice_blocked as tlb  # noqa: E402

NC = (4, 3, 5)
P = 3
MIXED = ((True, False), (True, True), (False, True))


@pytest.fixture
def jx():
    """The JAX reference modules, imported here so that the card tests of
    this file do not need JAX."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from pmg_dolfinx_tpu.fem import assembly
    from pmg_dolfinx_tpu.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_tpu.ops import interpolate, laplacian, lattice
    from pmg_dolfinx_tpu.ops import pallas_lattice_blocked

    return SimpleNamespace(jnp=jnp, Mesh=PerturbedBoxMesh, asm=assembly,
                           lap=laplacian, lat=lattice, ip=interpolate,
                           jlb=pallas_lattice_blocked)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _kappa_cells(mesh):
    """A positive per-cell coefficient, from a seed."""
    return np.random.default_rng(3).uniform(0.5, 4.0, mesh.ncells)


@pytest.mark.parametrize("faces", [True, MIXED])
def test_perturbed_mesh_bitwise(jx, faces):
    jm, tm = jx.Mesh(NC, dirichlet_faces=faces), TMesh(NC, dirichlet_faces=faces)
    assert np.array_equal(tm.geometry_x, jm.geometry_x)
    assert np.array_equal(tm.geometry_dofmap, jm.geometry_dofmap)
    assert np.array_equal(tm.cell_centroids(), jm.cell_centroids())
    assert not tm.is_axis_aligned
    for p in (1, 2, 3):
        assert np.array_equal(tm.dof_coords(p), jm.dof_coords(p))
        assert np.array_equal(tm.boundary_dof_marker(p),
                              jm.boundary_dof_marker(p))
        assert np.array_equal(tm.dof_multiplicity(p), jm.dof_multiplicity(p))


def test_host_setup_bitwise(jx):
    jm, tm = jx.Mesh(NC), TMesh(NC)
    kc = _kappa_cells(tm)
    assert np.array_equal(tlb.lattice_geom_coefficients(tm, P, kc),
                          jx.jlb.lattice_geom_coefficients(jm, P, kc))
    tmats = tlb.lattice_blocked_mats(NC, P, torch.float64, device="cpu")
    jmats = jx.jlb.lattice_blocked_mats(NC, P, jx.jnp.float64)
    assert tmats.keys() == jmats.keys()
    for k in tmats:
        assert np.array_equal(tmats[k].numpy(), np.asarray(jmats[k])), k
    G_cells, _ = tasm.geometry_factors_np(tm, P)
    Gq_t = tlat.geometry_to_qlattice(G_cells, NC, P)
    Gq_j = jx.lat.geometry_to_qlattice(G_cells, NC, P)
    assert np.array_equal(Gq_t, Gq_j)
    assert np.array_equal(tlb.geometry_to_gfirst(Gq_t),
                          jx.jlb.geometry_to_gfirst(Gq_j))
    tgeom, txi, twx = tlb.lattice_geom_data(NC, P, torch.float64,
                                            device="cpu")
    jgeom, jxi, jwx = jx.jlb.lattice_geom_data(NC, P, jx.jnp.float64)
    assert (txi, twx) == (jxi, jwx)
    for k in jgeom:
        assert np.array_equal(tgeom[k].numpy(), np.asarray(jgeom[k])), k


@pytest.mark.parametrize("faces", [True, MIXED])
def test_assembly_f64(jx, faces):
    jm, tm = jx.Mesh(NC, dirichlet_faces=faces), TMesh(NC, dirichlet_faces=faces)
    G_t, detJ_t = tasm.geometry_factors_np(tm, P)
    G_j, detJ_j = jx.asm.geometry_factors_np(jm, P)
    assert np.array_equal(G_t, G_j) and np.array_equal(detJ_t, detJ_j)
    kc = _kappa_cells(tm)
    assert _rel(tasm.scale_G(G_t, kc, None), jx.asm.scale_G(G_j, kc, None)) <= 1e-12
    for bc_zero in (False, True):
        assert _rel(tasm.lumped_mass_np(tm, P, bc_zero),
                    jx.asm.lumped_mass_np(jm, P, bc_zero)) <= 1e-12
    u = np.random.default_rng(0).standard_normal(tm.num_dofs(P))
    ue = lambda x: np.sin(np.pi * x[0]) * x[1] * (1.0 + x[2])
    assert _rel(tasm.l2_error_collocated(tm, P, u, ue),
                jx.asm.l2_error_collocated(jm, P, u, ue)) <= 1e-12
    A_t = tasm.assemble_stiffness(tm, P, kappa=2.0)
    A_j = jx.asm.assemble_stiffness(jm, P, kappa=2.0)
    assert _rel(A_t @ u, A_j @ u) <= 1e-12
    assert abs(A_t - A_j).max() <= 1e-12 * abs(A_j).max()


def _dofmap_operands(jx, tm, jm, p):
    G, _ = tasm.geometry_factors_np(tm, p)
    kc = _kappa_cells(tm)
    from pmg_dolfinx_tpu_torch.fem.gll import derivative_matrix

    D = derivative_matrix(p)
    t = dict(dofmap=torch.tensor(tm.dofmap(p), dtype=torch.int64),
             G=torch.tensor(G), coeff=torch.tensor(kc), D=torch.tensor(D),
             bc=torch.tensor(tm.boundary_dof_marker(p)))
    j = dict(dofmap=jx.jnp.asarray(jm.dofmap(p)), G=jx.jnp.asarray(G),
             coeff=jx.jnp.asarray(kc), D=jx.jnp.asarray(D),
             bc=jx.jnp.asarray(jm.boundary_dof_marker(p)))
    return t, j


@pytest.mark.parametrize("faces", [True, MIXED])
def test_dofmap_operator_f64(jx, faces):
    jm, tm = jx.Mesh(NC, dirichlet_faces=faces), TMesh(NC, dirichlet_faces=faces)
    t, j = _dofmap_operands(jx, tm, jm, P)
    x = np.random.default_rng(1).standard_normal(tm.num_dofs(P))
    y_t = tlap.laplacian_apply(torch.tensor(x), t["dofmap"], t["G"],
                               t["coeff"], t["D"], t["bc"])
    y_j = jx.lap.laplacian_apply(jx.jnp.asarray(x), j["dofmap"], j["G"],
                                 j["coeff"], j["D"], j["bc"])
    assert _rel(y_t.numpy(), y_j) <= 1e-12
    n = tm.num_dofs(P)
    d_t = tlap.laplacian_diagonal(t["dofmap"], t["G"], t["coeff"], t["D"],
                                  t["bc"], n)
    d_j = jx.lap.laplacian_diagonal(j["dofmap"], j["G"], j["coeff"],
                                    j["D"], j["bc"], n)
    assert _rel(d_t.numpy(), d_j) <= 1e-12
    op_t = tlap.MatFreeLaplacian(tm, P, kappa=2.0, device="cpu")
    op_j = jx.lap.MatFreeLaplacian(jm, P, kappa=2.0)
    assert _rel(op_t(torch.tensor(x)).numpy(), op_j(jx.jnp.asarray(x))) <= 1e-12
    assert _rel(op_t.diag.numpy(), op_j.diag) <= 1e-12
    # the operator is the assembled oracle's
    A = tasm.assemble_stiffness(tm, P, kappa=2.0)
    assert _rel(op_t(torch.tensor(x)).numpy(), A @ x) <= 1e-12


@pytest.mark.parametrize("pc,pf", [(1, 3), (3, 6), (1, 2)])
def test_dofmap_transfers_f64(jx, pc, pf):
    from pmg_dolfinx_tpu_torch.fem.gll import interpolation_matrix_1d

    jm, tm = jx.Mesh(NC), TMesh(NC)
    M1 = interpolation_matrix_1d(pc, pf)
    dc, df = tm.dofmap(pc), tm.dofmap(pf)
    mult = tm.dof_multiplicity(pf)
    rng = np.random.default_rng(2)
    xc = rng.standard_normal(tm.num_dofs(pc))
    xf = rng.standard_normal(tm.num_dofs(pf))
    ti = lambda a: torch.tensor(a, dtype=torch.int64)
    u_t = tip.prolongate(torch.tensor(xc), ti(dc), ti(df), torch.tensor(M1),
                         tm.num_dofs(pf))
    u_j = jx.ip.prolongate(jx.jnp.asarray(xc), jx.jnp.asarray(dc),
                           jx.jnp.asarray(df), jx.jnp.asarray(M1),
                           jm.num_dofs(pf))
    assert _rel(u_t.numpy(), u_j) <= 1e-12
    r_t = tip.restrict(torch.tensor(xf), ti(dc), ti(df), torch.tensor(M1),
                       torch.tensor(mult), tm.num_dofs(pc))
    r_j = jx.ip.restrict(jx.jnp.asarray(xf), jx.jnp.asarray(dc),
                         jx.jnp.asarray(df), jx.jnp.asarray(M1),
                         jx.jnp.asarray(mult), jm.num_dofs(pc))
    assert _rel(r_t.numpy(), r_j) <= 1e-12


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_expand_fold_f64(jx, axis):
    shape = [tm_n * P + 1 for tm_n in NC]
    t = np.random.default_rng(4).standard_normal(shape)
    nc = NC[axis]
    e_t = tlat._expand(torch.tensor(t), axis, nc, P)
    e_j = jx.lat._expand(jx.jnp.asarray(t), axis, nc, P)
    assert np.array_equal(e_t.numpy(), np.asarray(e_j))
    s = np.random.default_rng(5).standard_normal(e_t.shape)
    f_t = tlat._fold(torch.tensor(s), axis, nc, P)
    f_j = jx.lat._fold(jx.jnp.asarray(s), axis, nc, P)
    assert _rel(f_t.numpy(), f_j) <= 1e-12
    if axis == 0:
        assert _rel(tlat.fold_axis0(torch.tensor(s), nc, P).numpy(),
                    jx.lat.fold_axis0(jx.jnp.asarray(s), nc, P)) <= 1e-12


@pytest.mark.parametrize("apply_bc", [True, False])
@pytest.mark.parametrize("faces", [True, MIXED])
def test_lattice_apply_f64(jx, faces, apply_bc):
    jm, tm = jx.Mesh(NC, dirichlet_faces=faces), TMesh(NC, dirichlet_faces=faces)
    op_t = tlat.LatticeLaplacian(tm, P, kappa=2.0, dtype=torch.float64,
                                 device="cpu")
    op_j = jx.lat.LatticeLaplacian(jm, P, kappa=2.0, dtype=jx.jnp.float64)
    x = np.random.default_rng(6).standard_normal(tm.num_dofs(P))
    y_t = tlat.lattice_laplacian_apply(torch.tensor(x), op_t.mats, op_t.G,
                                       op_t.bc_marker, apply_bc=apply_bc)
    y_j = jx.lat.lattice_laplacian_apply(jx.jnp.asarray(x), op_j.mats,
                                         op_j.G, op_j.bc_marker,
                                         apply_bc=apply_bc)
    assert _rel(y_t.numpy(), y_j) <= 1e-12
    assert _rel(op_t.diag.numpy(), op_j.diag) <= 1e-12
    # lattice-shaped input gives the lattice-shaped result
    x3 = torch.tensor(x).reshape(tm.lattice_shape(P))
    y3 = tlat.lattice_laplacian_apply(
        x3, op_t.mats, op_t.G, op_t.bc_marker.reshape(x3.shape))
    assert torch.allclose(y3.reshape(-1), op_t(torch.tensor(x)), rtol=0,
                          atol=1e-13)


def test_geom_to_G_f64(jx):
    tm = TMesh(NC)
    kc = _kappa_cells(tm)
    co = tlb.lattice_geom_coefficients(tm, P, kc)
    G_np = tlb.geom_to_G(co, NC, P)
    assert _rel(G_np, jx.jlb.geom_to_G(co, NC, P)) <= 1e-12
    G_cells, _ = tasm.geometry_factors_np(tm, P)
    Gq = tlat.geometry_to_qlattice(tasm.scale_G(G_cells, kc, None), NC, P)
    assert _rel(G_np, Gq) <= 1e-12
    G_torch = tlb.geom_to_G(torch.tensor(co), NC, P)
    assert G_torch.dtype == torch.float64
    assert _rel(G_torch.numpy(), Gq) <= 1e-12


@pytest.mark.parametrize("variant", ["yexp", "v1", "ym", "geom"])
def test_blocked_matches_pallas_interpret_f32(jx, variant):
    """Scalar kappa through the operator classes (apply and diagonal), and
    a per-cell kappa fed directly as G / co to the entry points."""
    jnp, jlb = jx.jnp, jx.jlb
    jm, tm = jx.Mesh(NC), TMesh(NC)
    x = np.random.default_rng(7).standard_normal(tm.num_dofs(P)).astype(
        np.float32)
    op_t = tlb.PallasLatticeBlocked(tm, P, kappa=2.0, variant=variant,
                                    device="cpu")
    op_j = jlb.PallasLatticeBlocked(jm, P, kappa=2.0, bcells=1,
                                    interpret=True, variant=variant)
    y_t = op_t(torch.from_numpy(x))
    assert y_t.dtype == torch.float32
    assert _rel(y_t.numpy(), op_j(jnp.asarray(x))) <= 1e-5
    assert _rel(op_t.diag.numpy(), op_j.diag) <= 1e-6

    kc = _kappa_cells(tm)
    bc_t = torch.tensor(tm.boundary_dof_marker(P))
    bc_j = jnp.asarray(jm.boundary_dof_marker(P))
    mats_t = tlb.lattice_blocked_mats(NC, P, device="cpu")
    mats_j = jlb.lattice_blocked_mats(NC, P)
    if variant == "geom":
        co = tlb.lattice_geom_coefficients(tm, P, kc)
        _, xi, wx = tlb.lattice_geom_data(NC, P, device="cpu")
        geom_j, _, _ = jlb.lattice_geom_data(NC, P)
        y_t = tlb.blocked_lattice_apply_geom(
            torch.from_numpy(x), mats_t, torch.tensor(co, dtype=torch.float32),
            bc_t, NC, P, xi=xi, wx=wx)
        y_j = jlb.blocked_lattice_apply_geom(
            jnp.asarray(x), mats_j, jnp.asarray(co, jnp.float32), geom_j,
            bc_j, NC, P, xi=xi, wx=wx, bcells=1, interpret=True)
    else:
        G_cells, _ = tasm.geometry_factors_np(tm, P)
        Gt = tlb.geometry_to_gfirst(tlat.geometry_to_qlattice(
            tasm.scale_G(G_cells, kc, None), NC, P))
        y_t = tlb.blocked_lattice_apply(
            torch.from_numpy(x), mats_t, torch.tensor(Gt, dtype=torch.float32),
            bc_t, NC, P, variant=variant)
        y_j = jlb.blocked_lattice_apply(
            jnp.asarray(x), mats_j, jnp.asarray(Gt, jnp.float32), bc_j, NC,
            P, bcells=1, interpret=True, variant=variant)
    assert _rel(y_t.numpy(), y_j) <= 1e-5


def test_blocked_guards():
    tm = TMesh((2, 2, 2))
    mats = tlb.lattice_blocked_mats(tm.nc, 2, device="cpu")
    x = torch.zeros(tm.num_dofs(2))
    bc = torch.tensor(tm.boundary_dof_marker(2))
    Gt = torch.zeros((6,) + tuple(3 * n for n in tm.nc))
    with pytest.raises(NotImplementedError, match="Queue 2, kernel #16"):
        tlb.blocked_lattice_apply(x, mats, Gt, bc, tm.nc, 2, variant="zgrp")
    with pytest.raises(NotImplementedError, match="Queue 2, kernel #16"):
        tlb.blocked_lattice_apply_zgrp(x)
    with pytest.raises(NotImplementedError, match="Queue 2, kernel #16"):
        tlb.PallasLatticeBlocked(tm, 2, variant="zgrp", device="cpu")
    with pytest.raises(NotImplementedError, match="precision='high'"):
        tlb.blocked_lattice_apply(x, mats, Gt, bc, tm.nc, 2,
                                  precision="high")
    with pytest.raises(ValueError, match="unknown variant"):
        tlb.blocked_lattice_apply(x, mats, Gt, bc, tm.nc, 2, variant="geom")


# --- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rel_max(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 3, 6])
def test_cuda_lattice_kernels_match_plain(cuda_device, p):
    tm = TMesh((3, 4, 5), dirichlet_faces=MIXED)
    k_a = tlb.PallasLatticeBlocked(tm, p, kappa=2.0, device=cuda_device)
    k_b = tlb.PallasLatticeBlocked(tm, p, kappa=2.0, variant="geom",
                                   device=cuda_device)
    x = torch.tensor(np.random.default_rng(8).standard_normal(k_a.ndofs),
                     dtype=torch.float32, device=cuda_device)
    before = dict(tlb.LAUNCHES)
    for apply_bc in (True, False):
        y = tlb.blocked_lattice_apply(x, k_a.mats, k_a.Gt, k_a.bc_marker,
                                      tm.nc, p, apply_bc=apply_bc)
        ref = tlb.plain_lattice_apply(x, k_a.mats, k_a.Gt, k_a.bc_marker,
                                      apply_bc)
        assert _rel_max(y, ref) <= 1e-5
        y = tlb.blocked_lattice_apply_geom(
            x, k_b.mats, k_b.co, k_b.bc_marker, tm.nc, p, xi=k_b._xi,
            wx=k_b._wx, apply_bc=apply_bc)
        ref = tlb.plain_lattice_apply_geom(x, k_b.mats, k_b.co,
                                           k_b.bc_marker, tm.nc, p, apply_bc)
        assert _rel_max(y, ref) <= 1e-5
    # lattice-shaped operands, and the same result on every run
    shape = tm.lattice_shape(p)
    y3 = tlb.lattice_apply(x.reshape(shape), k_a.bc_marker.reshape(shape),
                           k_a.Gt, k_a.mats["D1"], tm.nc, p)
    assert torch.equal(y3.reshape(-1), k_a(x))
    assert tlb.LAUNCHES["lattice_apply"] == before["lattice_apply"] + 4
    assert tlb.LAUNCHES["lattice_apply_geom"] == before["lattice_apply_geom"] + 2
    with pytest.raises(TypeError, match="float32"):
        tlb.lattice_apply(x.double(), k_a.bc_marker, k_a.Gt,
                          k_a.mats["D1"], tm.nc, p)
    with pytest.raises(NotImplementedError, match="compiled for"):
        tlb.lattice_apply(x, k_a.bc_marker, k_a.Gt, k_a.mats["D1"], tm.nc, 7)
