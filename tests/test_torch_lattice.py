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
  classes and a per-cell positive kappa fed directly as G and ``co``;
  'zgrp' (``PerturbedBoxMesh((3, 2, 6))``, ``zb`` in {2, 3}, scalar
  kappa) through the class and its entry point, with the z-grouped setup
  (`geometry_to_zgrouped`, `zgroup_matrices`) bit for bit and
  `select_zgroup` as in JAX.
- On the card, K-A (on G and on the z-grouped Gz) and K-B against their
  plain versions (marked ``cuda``;
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
        geom_t, xi, wx = tlb.lattice_geom_data(NC, P, device="cpu")
        geom_j, _, _ = jlb.lattice_geom_data(NC, P)
        y_t = tlb.blocked_lattice_apply_geom(
            torch.from_numpy(x), mats_t, torch.tensor(co, dtype=torch.float32),
            geom_t, bc_t, NC, P, xi=xi, wx=wx)
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
    """The JAX package's errors: 'zgrp' has its own entry point, ``zb``
    must divide ``ncz``, a mesh without a usable z-group refuses 'zgrp'."""
    tm = TMesh((2, 2, 2))
    mats = tlb.lattice_blocked_mats(tm.nc, 2, device="cpu")
    x = torch.zeros(tm.num_dofs(2))
    bc = torch.tensor(tm.boundary_dof_marker(2))
    Gt = torch.zeros((6,) + tuple(3 * n for n in tm.nc))
    with pytest.raises(ValueError, match="'zgrp' variants have their own"):
        tlb.blocked_lattice_apply(x, mats, Gt, bc, tm.nc, 2, variant="zgrp")
    with pytest.raises(ValueError, match="must divide"):
        tlb.blocked_lattice_apply_zgrp(x, mats, None, Gt, bc, tm.nc, 2, 3)
    with pytest.raises(ValueError, match="z-group"):
        tlb.PallasLatticeBlocked(tm, 2, variant="zgrp", device="cpu")
    with pytest.raises(NotImplementedError, match="precision='high'"):
        tlb.blocked_lattice_apply(x, mats, Gt, bc, tm.nc, 2,
                                  precision="high")
    with pytest.raises(ValueError, match="unknown variant"):
        tlb.blocked_lattice_apply(x, mats, Gt, bc, tm.nc, 2, variant="geom")


ZG_NC = (3, 2, 6)


@pytest.mark.parametrize("zb", [2, 3])
def test_zgrp_matches_pallas_interpret(jx, zb):
    """'zgrp' with scalar kappa: the operator class against JAX's in
    interpret mode, and the entry point on the same ``Gz``; relative
    2-norm <= 1e-5 (the JAX package's own gate). The class holds only
    ``Gz``. Per-cell and tensor kappa: `tests/test_torch_coefficients.py`."""
    jnp, jlb = jx.jnp, jx.jlb
    jm, tm = jx.Mesh(ZG_NC), TMesh(ZG_NC)
    x = np.random.default_rng(5).standard_normal(tm.num_dofs(P)).astype(
        np.float32)
    op_j = jlb.PallasLatticeBlocked(jm, P, kappa=2.0, interpret=True,
                                    variant="zgrp", zb=zb)
    op_t = tlb.PallasLatticeBlocked(tm, P, kappa=2.0, variant="zgrp", zb=zb,
                                    device="cpu")
    assert op_t.Gt is None and op_t.co is None and op_t.zb == zb
    before = dict(tlb.LAUNCHES)
    y_t = op_t(torch.from_numpy(x))
    assert tlb.LAUNCHES == before  # the plain version; no kernel
    assert y_t.dtype == torch.float32
    assert _rel(y_t.numpy(), op_j(jnp.asarray(x))) <= 1e-5
    assert _rel(op_t.diag.numpy(), op_j.diag) <= 1e-6
    y_e = tlb.blocked_lattice_apply_zgrp(
        torch.from_numpy(x), op_t.mats, op_t.zmats, op_t.Gz, op_t.bc_marker,
        ZG_NC, P, zb, apply_bc=False)
    y_je = jlb.blocked_lattice_apply_zgrp(
        jnp.asarray(x), op_j.mats, op_j.zmats, op_j.Gz, op_j.bc_marker,
        ZG_NC, P, zb, interpret=True, apply_bc=False)
    assert _rel(y_e.numpy(), y_je) <= 1e-5


@pytest.mark.parametrize("zb", [2, 3])
def test_zgrouped_setup_bitwise(jx, zb):
    tm = TMesh(ZG_NC)
    G_cells, _ = tasm.geometry_factors_np(tm, P)
    Gq = tlat.geometry_to_qlattice(G_cells, ZG_NC, P)
    Gz = tlb.geometry_to_zgrouped(Gq, zb, P)
    assert np.array_equal(Gz, jx.jlb.geometry_to_zgrouped(Gq, zb, P))
    assert np.array_equal(
        tlb.zgrouped_to_qlattice(torch.from_numpy(Gz), ZG_NC, P, zb).numpy(),
        Gq)
    tz = tlb.zgroup_matrices(zb, P, torch.float64, device="cpu")
    jz = jx.jlb.zgroup_matrices(zb, P, jx.jnp.float64)
    assert tz.keys() == jz.keys()
    for k in tz:
        assert np.array_equal(tz[k].numpy(), np.asarray(jz[k])), k


def test_select_zgroup_as_in_jax(jx):
    assert tlb.select_zgroup(42, 6) == 14
    assert tlb.select_zgroup(3, 6) is None
    assert tlb.select_zgroup(41, 6) is None  # prime: no usable divisor
    for ncz in range(1, 49):
        for p in (1, 3, 6):
            assert tlb.select_zgroup(ncz, p) == jx.jlb.select_zgroup(ncz, p)


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
            x, k_b.mats, k_b.co, k_b.geom, k_b.bc_marker, tm.nc, p,
            xi=k_b._xi,
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


def _on_box(monkeypatch, P, box):
    """Make `lattice_plan` pick ``box`` ``(Sx, By, Bz)`` at degree ``P``
    (each fitted to the mesh as `BOX` and `MARCH` are): both patched, the
    launch records cleared."""
    monkeypatch.setattr(tlb, "BOX", {**tlb.BOX, P: tuple(box[1:])})
    monkeypatch.setattr(tlb, "MARCH", box[0])
    monkeypatch.setattr(tlb, "_RECORDS", {})


@pytest.mark.cuda
@pytest.mark.parametrize("zb", [1, 2, 3])
@pytest.mark.parametrize("p", [1, 3, 6])
def test_cuda_zgrp_matches_plain_and_gt(cuda_device, monkeypatch, p, zb):
    tm = TMesh((3, 4, 6), dirichlet_faces=MIXED)
    k_z = tlb.PallasLatticeBlocked(tm, p, kappa=2.0, variant="zgrp", zb=zb,
                                   device=cuda_device)
    k_a = tlb.PallasLatticeBlocked(tm, p, kappa=2.0, device=cuda_device)
    x = torch.tensor(np.random.default_rng(9).standard_normal(k_z.ndofs),
                     dtype=torch.float32, device=cuda_device)
    before = dict(tlb.LAUNCHES)
    for apply_bc in (True, False):
        y = tlb.blocked_lattice_apply_zgrp(x, k_z.mats, k_z.zmats, k_z.Gz,
                                           k_z.bc_marker, tm.nc, p, zb,
                                           apply_bc=apply_bc)
        ref = tlb.plain_lattice_apply_zgrp(x, k_z.mats, k_z.Gz,
                                           k_z.bc_marker, tm.nc, p, zb,
                                           apply_bc)
        assert _rel_max(y, ref) <= 1e-5
    # the same kernel on the same geometry, read in place, on the same
    # box (the box sets the order of the fold's sums): equal results
    y_z, plan = k_z(x), tlb.lattice_plan(tm.nc, p, zb)
    _on_box(monkeypatch, p, plan)
    assert tlb.lattice_plan(tm.nc, p) == plan
    assert torch.equal(y_z, k_a(x))
    assert tlb.LAUNCHES["lattice_apply_zgrp"] == \
        before["lattice_apply_zgrp"] + 3


# --- the one-launch march: host plan (CPU) and the kernels (card) -------------

def test_lattice_plan_at_the_vcycle_levels():
    """The box each block marches at the curved V-cycle's levels (nc=42,
    p=6, 3, 1), for 'zgrp' at zb=14, and on awkward extents; each fits
    its kernel's thread cap."""
    nc = (42, 42, 42)
    assert tlb.lattice_plan(nc, 6) == (6, 1, 3)
    assert tlb.lattice_plan(nc, 3) == (6, 2, 7)
    assert tlb.lattice_plan(nc, 1) == (6, 4, 14)
    assert tlb.lattice_plan(nc, 6, zb=14) == (6, 1, 7)   # Bz divides zb
    assert tlb.lattice_plan((5, 7, 11), 6) == (5, 1, 3)
    assert tlb.lattice_plan((3, 13, 9), 3) == (3, 2, 5)
    for P in tlb.DEGREES:
        _, By, Bz = tlb.lattice_plan(nc, P)
        for kernel in ("lattice_apply", "lattice_apply_geom"):
            assert By * Bz * (P + 1) ** 2 <= tlb.max_threads(P, kernel)
    assert tlb.max_threads(6) == 384
    assert tlb.max_threads(6, "lattice_apply_geom") == 256
    assert tlb.max_threads(3) == 256


@pytest.mark.parametrize("nc,P,zb", [((42, 42, 42), 6, 14),
                                     ((42, 42, 42), 6, 21),
                                     ((42, 42, 42), 1, 6),
                                     ((5, 7, 11), 2, None),
                                     ((1, 3, 2), 5, None),
                                     ((3, 5, 6), 6, 6),
                                     ((8, 10, 12), 4, 12),
                                     ((9, 1, 40), 1, None)])
def test_lattice_plan_fits_its_kernels(nc, P, zb):
    """On any extent the box splits each axis evenly (every box but the
    last is full, the last short by less than a box), a block stays within
    its kernel's thread cap, a 'zgrp' box within one z-group, and a list
    of cells plans as its tuple does."""
    plan = tlb.lattice_plan(nc, P, zb)
    assert plan == tlb.lattice_plan(list(nc), P, zb)
    for S, c in zip(plan, nc):
        nb = -(-c // S)
        assert 1 <= S <= c and (nb - 1) * S < c <= nb * S
    threads = plan[1] * plan[2] * (P + 1) ** 2
    if zb is None:
        assert plan == tlb.lattice_plan(nc, P, None)
        for kernel in ("lattice_apply", "lattice_apply_geom"):
            assert threads <= tlb.max_threads(P, kernel)
    else:
        assert zb % plan[2] == 0
        assert threads <= tlb.max_threads(P, "lattice_apply_zgrp")


@pytest.mark.cuda
@pytest.mark.parametrize("nc,P,plan", [((42, 42, 42), 6, (6, 1, 3)),
                                       ((42, 42, 42), 3, (6, 2, 7)),
                                       ((42, 42, 42), 1, (6, 4, 14)),
                                       ((5, 7, 11), 2, (2, 3, 4)),
                                       ((3, 1, 4), 1, (1, 1, 1))])
def test_lattice_face_scratch_holds_the_shared_dofs(cuda_device, nc, P,
                                                    plan):
    """`face_scratch_bytes` (the CUDA source's layout) and the face
    kernel's enumeration: for each set A of shared axes, its entries (A's
    boundaries at side 0, the other axes' dofs less those on a face
    between boxes, as ``lattice_faces`` skips them) are exactly the dofs
    shared along A, counted one by one, and each has a slot per sharing
    box."""
    nbytes, threads = tlb.face_scratch_bytes(nc, P, plan)
    N = [c * P + 1 for c in nc]
    S = [min(s, c) * P for s, c in zip(plan, nc)]
    nb = [-(-c // min(s, c)) for c, s in zip(nc, plan)]
    on = []
    for a in range(3):
        m = np.zeros(N[a], bool)
        m[S[a]:N[a] - 1:S[a]] = True       # faces between boxes
        on.append(m)
    grid = np.meshgrid(*on, indexing="ij")
    mask = grid[0].astype(int) | grid[1] << 1 | grid[2] << 2
    slots = entries = 0
    for A in range(1, 8):
        dims = [2 * (nb[a] - 1) if A >> a & 1 else N[a] for a in range(3)]
        slots += int(np.prod(dims))
        entries += int(np.prod(dims)) >> bin(A).count("1")
        kept = 1
        for a in range(3):
            kept *= nb[a] - 1 if A >> a & 1 else int((~on[a]).sum())
        assert kept == int((mask == A).sum()), A
    assert (nbytes, threads) == (4 * slots, entries)
    if nc == (42, 42, 42) and P == 6:
        assert (nbytes, threads) == (34295792, 4060559)
        assert int((mask > 0).sum()) == 3626917


def _march_cases():
    out = []
    for P in (1, 2, 3, 4, 5, 6):
        for nc in ((5, 7, 11), (3, 13, 9), (1, 3, 2)):
            out.append((P, nc))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("P,nc", _march_cases())
def test_cuda_march_awkward_shapes(cuda_device, monkeypatch, P, nc):
    """K-A on Gt and K-B against their plain versions (relative max-norm
    1e-5) at every degree, on extents off the box grid and an axis of one
    cell, mixed Dirichlet faces, apply_bc on and off, on the plan's box
    and on boxes that put faces between blocks along every axis."""
    tm = TMesh(nc, dirichlet_faces=MIXED)
    k_a = tlb.PallasLatticeBlocked(tm, P, kappa=2.0, device=cuda_device)
    k_b = tlb.PallasLatticeBlocked(tm, P, kappa=2.0, variant="geom",
                                   device=cuda_device)
    x = torch.tensor(np.random.default_rng(P).standard_normal(k_a.ndofs),
                     dtype=torch.float32, device=cuda_device)
    D1 = k_a.mats["D1"]
    ref = {bc: (tlb.plain_lattice_apply(x, k_a.mats, k_a.Gt, k_a.bc_marker,
                                        bc),
                tlb.plain_lattice_apply_geom(x, k_b.mats, k_b.co,
                                             k_b.bc_marker, nc, P, bc))
           for bc in (True, False)}
    for box in (None, (1, 1, 1), (2, 1, 2), (1, 2, 1), (2, 2, 2)):
        if box is not None:
            _on_box(monkeypatch, P, box)
        plan = tlb.lattice_plan(nc, P)
        for apply_bc in (True, False):
            before = dict(tlb.LAUNCHES)
            y = tlb.lattice_apply(x, k_a.bc_marker, k_a.Gt, D1, nc, P,
                                  apply_bc)
            assert _rel_max(y, ref[apply_bc][0]) <= 1e-5, (plan, apply_bc)
            if plan[1] * plan[2] * (P + 1) ** 2 <= tlb.max_threads(
                    P, "lattice_apply_geom"):
                y = tlb.lattice_apply_geom(x, k_b.bc_marker, k_b.co, D1, nc,
                                           P, k_b._xi, k_b._wx, apply_bc)
                assert _rel_max(y, ref[apply_bc][1]) <= 1e-5, (plan,
                                                               apply_bc)
            assert tlb.LAUNCHES["lattice_apply"] == \
                before["lattice_apply"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("zb", [1, 2, 3, 6])
@pytest.mark.parametrize("P", [1, 2, 3, 4, 5, 6])
def test_cuda_march_zgrp_shapes(cuda_device, monkeypatch, P, zb):
    """K-A on the z-grouped Gz against its plain version (1e-5) and
    bitwise against K-A on Gt on the same box, on the plan's box and on
    smaller ones (at zb=6 boxes shorter than the z-group), mixed faces,
    apply_bc on and off."""
    nc = (3, 5, 6)
    tm = TMesh(nc, dirichlet_faces=MIXED)
    k_z = tlb.PallasLatticeBlocked(tm, P, kappa=2.0, variant="zgrp", zb=zb,
                                   device=cuda_device)
    k_a = tlb.PallasLatticeBlocked(tm, P, kappa=2.0, device=cuda_device)
    x = torch.tensor(np.random.default_rng(10 + P).standard_normal(
        k_z.ndofs), dtype=torch.float32, device=cuda_device)
    D1 = k_a.mats["D1"]
    for box in (None, (1, 1, 1), (2, 2, 2)):
        if box is not None:
            _on_box(monkeypatch, P, box)
        plan = tlb.lattice_plan(nc, P, zb)
        assert zb % plan[2] == 0
        ys = {}
        for apply_bc in (True, False):
            ys[apply_bc] = tlb.lattice_apply_zgrp(x, k_z.bc_marker, k_z.Gz,
                                                  D1, nc, P, zb, apply_bc)
            ref = tlb.plain_lattice_apply_zgrp(x, k_z.mats, k_z.Gz,
                                               k_z.bc_marker, nc, P, zb,
                                               apply_bc)
            assert _rel_max(ys[apply_bc], ref) <= 1e-5, (plan, apply_bc)
        _on_box(monkeypatch, P, plan)
        assert tlb.lattice_plan(nc, P) == plan
        for apply_bc in (True, False):
            assert torch.equal(ys[apply_bc], tlb.lattice_apply(
                x, k_a.bc_marker, k_a.Gt, D1, nc, P, apply_bc)), plan


@pytest.mark.cuda
def test_cuda_march_same_bits_and_scratch_per_call(cuda_device,
                                                   monkeypatch):
    """Two applies of the same input give the same bits (the fold sums
    in a fixed order, no atomics); an apply keeps only its output (the
    face scratch comes from the caching allocator per call, never a
    cell-expanded lattice), so applies on two streams at once and a first
    apply inside a CUDA graph capture give the same bits too; a box over
    the kernel's thread cap is refused at launch."""
    nc, P = (6, 5, 7), 3
    tm = TMesh(nc, dirichlet_faces=MIXED)
    k_a = tlb.PallasLatticeBlocked(tm, P, kappa=2.0, device=cuda_device)
    k_b = tlb.PallasLatticeBlocked(tm, P, kappa=2.0, variant="geom",
                                   device=cuda_device)
    x = torch.tensor(np.random.default_rng(3).standard_normal(k_a.ndofs),
                     dtype=torch.float32, device=cuda_device)
    for op in (k_a, k_b):
        y1 = op(x)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        y2 = op(x)
        torch.cuda.synchronize()
        assert torch.equal(y1, y2)
        assert torch.cuda.memory_allocated() - base <= -(-4 * x.numel()
                                                         // 512) * 512
        streams = (torch.cuda.Stream(), torch.cuda.Stream())
        ys = []
        for s in streams:
            with torch.cuda.stream(s):
                ys.append(op(x))
        torch.cuda.synchronize()
        assert all(torch.equal(y, y1) for y in ys)
    y_a = k_a(x)
    monkeypatch.setattr(tlb, "_RECORDS", {})
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_g = k_a(x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y_g, y_a)
    _on_box(monkeypatch, P, (6, 7, 7))         # 5 x 7 cells: 560 threads
    with pytest.raises(RuntimeError, match="launch failed"):
        k_a(x)
