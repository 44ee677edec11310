"""Kernels #8 / #9 (`ops.kron_blocked.kron_t23_grid` / `kron_t23_grid_m`),
K-A (`ops.lattice_blocked.lattice_apply`) once per shard of the stacked
grid layout, and the device-grid solves (``kron_blocked``,
``lattice_blocked``) on an NVIDIA GPU, against the port's own plain
versions. Every test here carries the ``cuda`` marker and skips without
a card; the module imports no JAX (the card has none), so it runs there
with ``python -m pytest --noconftest -m cuda tests/test_torch_grid_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh  # noqa: E402
from pmg_dolfinx_tpu_torch.models.poisson import f_rhs  # noqa: E402
from pmg_dolfinx_tpu_torch.ops import kron_blocked as tkb  # noqa: E402
from pmg_dolfinx_tpu_torch.ops.kron import axis_stiffness_mass  # noqa: E402
from pmg_dolfinx_tpu_torch.parallel.grid2d import GridPMG  # noqa: E402

NEEDS = [(True, True), (True, False), (False, True)]
# Kernel #9 at awkward shapes: extents off the 32-lane and march-chunk
# grids, one axis no longer than 2 band + 1, bands 1, 3, 6 and 16.
AWKWARD = [((7, 3, 9), 1), ((37, 70, 5), 3), ((40, 13, 33), 6),
           ((20, 45, 97), 16)]
MIXED = ((True, False), (False, True), (True, True))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return "cuda"


def _rel_max(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _inputs(device, seed=8):
    """One shard's operands on a mixed-Dirichlet (3, 4, 2) box at P=3:
    the lattice, marker, local mats (with the separable masks), kernel
    1's output and random corrections, from a seed."""
    faces = ((True, False), (True, True), (False, True))
    mesh = BoxMesh((3, 4, 2), dirichlet_faces=faces)
    P = 3
    shape = mesh.lattice_shape(P)
    rng = np.random.default_rng(seed)
    Ks, ms = [], []
    for nc_a, h_a in zip(mesh.nc, mesh.h_cells):
        K, m = axis_stiffness_mass(nc_a, P, h_a)
        Ks.append(2.0 * K)
        ms.append(m)
    fm = tkb.axis_interior_masks(mesh, P)
    m, _ = tkb.grid_symmetrized_mats(Ks, ms, (1, 1, 1), torch.float32, fm,
                                     band=P, device=device)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    x = f32(rng.standard_normal(shape))
    bc = torch.tensor(mesh.boundary_dof_marker(P).reshape(shape),
                      device=device)
    return (x, bc, m, tkb.plain_t1_m(x, m),
            f32(rng.standard_normal((shape[0], 2, shape[2]))),
            f32(rng.standard_normal((shape[0], shape[1], 2))),
            f32(rng.standard_normal(shape)))


@pytest.mark.cuda
@pytest.mark.parametrize("need", NEEDS)
def test_grid_kernels_match_plain_on_cuda(cuda_device, need):
    """#8 / #9 against `plain_t23_grid` / `plain_t23_grid_m` for both
    sigmas, apply and fused residual: <= 1e-5 relative max-norm; each
    launch is counted."""
    x, bc, m, t1, cy, cz, r = _inputs(cuda_device)
    cy = cy if need[0] else None
    cz = cz if need[1] else None
    before = dict(tkb.LAUNCHES)
    for sigma in (0.0, 0.5):
        for rr in (None, r):
            ref8 = tkb.plain_t23_grid(x, bc, t1, m, sigma, cy, cz)
            ref9 = tkb.plain_t23_grid_m(x, t1, m, sigma, cy, cz)
            if rr is not None:
                ref8, ref9 = rr - ref8, rr - ref9
            got8 = tkb.kron_t23_grid(x, bc, t1, m, sigma, cy, cz, r3=rr)
            got9 = tkb.kron_t23_grid_m(x, t1, m, sigma, cy, cz, r3=rr)
            assert _rel_max(got8, ref8) <= 1e-5
            assert _rel_max(got9, ref9) <= 1e-5
    for k in ("t23_grid", "t23_grid_res", "t23_grid_m", "t23_grid_res_m"):
        assert tkb.LAUNCHES[k] == before[k] + 2


@pytest.mark.cuda
def test_grid_wrappers_refuse_bad_operands(cuda_device):
    x, bc, m, t1, cy, cz, r = _inputs(cuda_device)
    with pytest.raises(ValueError, match="cy has shape"):
        tkb.kron_t23_grid_m(x, t1, m, 0.0, cz, None)
    with pytest.raises(TypeError, match="float32"):
        tkb.kron_t23_grid(x.double(), bc, t1.double(), m)


@pytest.mark.cuda
def test_grid_pmg_on_cuda_matches_cpu(cuda_device):
    """The (2, 2, 2) kron_blocked grid solve on the card against the same
    solve on the CPU (plain versions): trajectories within 5e-4 above 5e-3
    of the initial residual; kernel #9 launches."""
    nc = (4, 4, 4)
    b = assemble_rhs(BoxMesh(nc), 3, f_rhs(2.0))
    kw = dict(shards=(2, 2, 2), degrees=(1, 3), kappa=2.0, coarse="fdm",
              operator="kron_blocked", dtype=torch.float32)
    before = tkb.LAUNCHES["t23_grid_m"]
    _, rn_c = GridPMG(BoxMesh(nc), device=cuda_device, **kw).solve(
        b, num_cycles=5)
    _, rn_h = GridPMG(BoxMesh(nc), device="cpu", **kw).solve(b, num_cycles=5)
    r0 = float(np.linalg.norm(b))
    rel_c, rel_h = np.array(rn_c) / r0, np.array(rn_h) / r0
    keep = rel_h > 5e-3
    assert np.max(np.abs(rel_c[keep] - rel_h[keep]) / rel_h[keep]) <= 5e-4
    assert tkb.LAUNCHES["t23_grid_m"] > before


def _banded(shape, band, device, seed):
    """One shard's operands with random symmetric banded ``K_a``, positive
    masses and mixed Dirichlet faces: the lattice, mats, kernel 1's
    output, both corrections and a residual rhs."""
    rng = np.random.default_rng(seed)
    Ks, fm = [], []
    for n, (lo, hi) in zip(shape, MIXED):
        A = rng.standard_normal((n, n))
        i, j = np.indices((n, n))
        A[np.abs(i - j) > band] = 0.0
        Ks.append(A + A.T)
        m = np.ones(n)
        m[0], m[-1] = (0.0 if lo else 1.0), (0.0 if hi else 1.0)
        fm.append(m)
    ms = [rng.uniform(0.5, 2.0, n) for n in shape]
    m = tkb.symmetrized_mats(Ks, ms, torch.float32, fm, band=band,
                             device=device)
    f32 = lambda s: torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                                 device=device)
    x = f32(shape)
    return (x, m, tkb.plain_t1_m(x, m), f32((shape[0], 2, shape[2])),
            f32((shape[0], shape[1], 2)), f32(shape))


@pytest.mark.cuda
@pytest.mark.parametrize("need", NEEDS)
@pytest.mark.parametrize("shape,band", AWKWARD)
def test_grid_kernel_9_awkward_shapes(cuda_device, shape, band, need):
    """#9 with ``cy`` only, ``cz`` only and both against
    `plain_t23_grid_m`, apply and fused residual, both sigmas: <= 1e-5
    relative max-norm; each launch is counted once."""
    x, m, t1, cy, cz, r = _banded(shape, band, cuda_device, sum(shape))
    cy = cy if need[0] else None
    cz = cz if need[1] else None
    before = dict(tkb.LAUNCHES)
    for sigma in (0.0, 0.5):
        for rr in (None, r):
            ref = tkb.plain_t23_grid_m(x, t1, m, sigma, cy, cz)
            if rr is not None:
                ref = rr - ref
            got = tkb.kron_t23_grid_m(x, t1, m, sigma, cy, cz, r3=rr)
            assert _rel_max(got, ref) <= 1e-5, (sigma, rr is None)
    for k in ("t23_grid_m", "t23_grid_res_m"):
        assert tkb.LAUNCHES[k] == before[k] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("need", NEEDS)
@pytest.mark.parametrize("shape,band", AWKWARD)
def test_grid_kernel_8_awkward_shapes(cuda_device, shape, band, need):
    """#8 (the y-march with the marker byte and a shard's corrections) on
    a random non-separable marker with ``cy`` only, ``cz`` only and both
    against `plain_t23_grid`, apply and fused residual, both sigmas: <=
    1e-5 relative max-norm; each launch is counted once, and a second
    call gives the same bits."""
    x, m, _, cy, cz, r = _banded(shape, band, cuda_device, 3 * sum(shape))
    rng = np.random.default_rng(band)
    bc_np = rng.random(shape) < 0.03
    bc_np[0], bc_np[:, -1], bc_np[:, :, 0] = True, True, True
    bc = torch.tensor(bc_np, device=cuda_device)
    t1 = tkb.plain_t1(x, bc, m)
    cy = cy if need[0] else None
    cz = cz if need[1] else None
    for sigma in (0.0, 0.5):
        for rr in (None, r):
            name = "t23_grid" if rr is None else "t23_grid_res"
            before = dict(tkb.LAUNCHES)
            ref = tkb.plain_t23_grid(x, bc, t1, m, sigma, cy, cz)
            if rr is not None:
                ref = rr - ref
            got = tkb.kron_t23_grid(x, bc, t1, m, sigma, cy, cz, r3=rr)
            assert _rel_max(got, ref) <= 1e-5, (sigma, rr is None)
            assert torch.equal(
                tkb.kron_t23_grid(x, bc, t1, m, sigma, cy, cz, r3=rr), got)
            assert tkb.LAUNCHES == dict(before, **{name: before[name] + 2})


# K-A once per shard on the stacked grid layout: (nc, shards) with a
# (2, 2, 2) grid and a (1, 2, 4) one at extents off the kernel's boxes.
KA_GRIDS = [((4, 4, 4), (2, 2, 2)), ((4, 8, 12), (1, 2, 4)),
            ((6, 10, 4), (2, 2, 2))]


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 3, 6])
@pytest.mark.parametrize("nc,shards", KA_GRIDS)
def test_grid_lattice_blocked_per_shard_matches_plain(cuda_device, nc,
                                                      shards, P):
    """`grid_lattice_blocked_cycle_ops`' raw apply launches K-A once per
    shard with ``apply_bc=False`` on the contiguous blocks of the stacked
    vector, marker and ``Gt``: each shard's output (interface planes left
    as raw partial sums, not marked) within 1e-5 of `plain_lattice_apply`
    on the same shard; the whole apply (exchanges, bc rows) within 1e-5 of
    the CPU's."""
    from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import kappa_linear
    from pmg_dolfinx_tpu_torch.ops import lattice_blocked as lb

    mesh = PerturbedBoxMesh(nc)
    kw = dict(degrees=(P,), kappa=kappa_linear, operator="lattice_blocked",
              dtype=torch.float32, sigma=3.0)
    g_c = GridPMG(mesh, shards, device=cuda_device, **kw)
    g_h = GridPMG(mesh, shards, device="cpu", **kw)
    lv, level = g_c.data["levels"][-1], g_c.levels[-1]
    x = torch.tensor(np.random.default_rng(P).standard_normal(
        mesh.num_dofs(P)), dtype=torch.float32)
    xd = g_c.to_dist(x)
    ncl = tuple((n - 1) // P for n in level.shape)
    before = lb.LAUNCHES["lattice_apply"]
    n_sh = shards[0] * shards[1] * shards[2]
    for idx in np.ndindex(*shards):
        y = lb.blocked_lattice_apply(xd[idx], lv["lb_mats"], lv["Gt"][idx],
                                     lv["bc_marker"][idx], ncl, P,
                                     apply_bc=False)
        ref = lb.plain_lattice_apply(xd[idx], lv["lb_mats"], lv["Gt"][idx],
                                     lv["bc_marker"][idx], apply_bc=False)
        assert _rel_max(y, ref) <= 1e-5
    assert lb.LAUNCHES["lattice_apply"] == before + n_sh
    y_c = g_c.from_dist(g_c.ops["apply"](lv, xd, level)).cpu()
    assert lb.LAUNCHES["lattice_apply"] == before + 2 * n_sh
    y_h = g_h.from_dist(g_h.ops["apply"](g_h.data["levels"][-1],
                                         g_h.to_dist(x), g_h.levels[-1]))
    assert _rel_max(y_c, y_h) <= 1e-5


@pytest.mark.cuda
def test_grid_lattice_blocked_pmg_on_cuda_matches_cpu(cuda_device):
    """The (2, 2, 2) ``lattice_blocked`` grid solve on a curved mesh with a
    DG-0 kappa and a sigma field on the card against the same solve on the
    CPU (plain versions): trajectories within 5e-4 above 5e-3 of the
    initial residual, solutions within 1e-5; K-A launches."""
    from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import (kappa_linear,
                                                      sigma_linear)
    from pmg_dolfinx_tpu_torch.ops import lattice_blocked as lb

    mesh = PerturbedBoxMesh((4, 4, 4))
    b = np.random.default_rng(3).standard_normal(mesh.num_dofs(3))
    b[mesh.boundary_dof_marker(3)] = 0.0
    kw = dict(shards=(2, 2, 2), degrees=(1, 3), kappa=kappa_linear,
              sigma=sigma_linear, coarse="cg", operator="lattice_blocked",
              dtype=torch.float32)
    before = lb.LAUNCHES["lattice_apply"]
    u_c, rn_c = GridPMG(mesh, device=cuda_device, **kw).solve(
        b, num_cycles=5)
    assert lb.LAUNCHES["lattice_apply"] > before
    u_h, rn_h = GridPMG(mesh, device="cpu", **kw).solve(b, num_cycles=5)
    r0 = float(np.linalg.norm(b))
    rel_c, rel_h = np.array(rn_c) / r0, np.array(rn_h) / r0
    keep = rel_h > 5e-3
    assert np.max(np.abs(rel_c[keep] - rel_h[keep]) / rel_h[keep]) <= 5e-4
    assert _rel_max(u_c.cpu(), u_h) <= 1e-5


def _robin_graded(nc):
    """A box with x Neumann, y Robin (alpha 2) on both faces, z Dirichlet
    and graded 8:1: on (2, 2, 2) the y shards' ``Kty`` / ``Ktye`` differ at
    their Robin ends and every z shard's ``KtzT`` / ``KtzTe`` differs."""
    from pmg_dolfinx_tpu_torch.fem.mesh import geometric_spacing

    return BoxMesh(nc, dirichlet_faces=((False, False), (False, False),
                                        (True, True)),
                   robin=((0.0, 0.0), (2.0, 2.0), (0.0, 0.0)),
                   spacing=(None, None, geometric_spacing(nc[2], 8.0)))


@pytest.mark.cuda
@pytest.mark.parametrize("P", [3, 6])
def test_grid_kernel_9_per_shard_blocks_that_differ(cuda_device, P):
    """Kernel #9 (apply and fused residual, both corrections, sigma 0 and
    0.5) and #1 on every shard of a (2, 2, 2) Robin + graded grid, each
    with its own `kb_blocks` entry, within 1e-5 of the plain versions on
    the same blocks; the blocks differ across y and across z."""
    grid = GridPMG(_robin_graded((4, 6, 8)), (2, 2, 2), degrees=(P,),
                   kappa=2.0, coarse="cg", operator="kron_blocked",
                   dtype=torch.float32, device=cuda_device)
    blocks = grid.data["levels"][-1]["kb_blocks"]
    assert not torch.equal(blocks[(0, 0, 0)]["Kty"], blocks[(0, 1, 0)]["Kty"])
    assert not torch.equal(blocks[(0, 0, 0)]["KtzT"],
                           blocks[(0, 0, 1)]["KtzT"])
    shape = tuple(grid.levels[-1].shape)
    rng = np.random.default_rng(29 + P)
    f32 = lambda s: torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                                 device=cuda_device)
    x, r = f32(shape), f32(shape)
    cy, cz = f32((shape[0], 2, shape[2])), f32((shape[0], shape[1], 2))
    for m in blocks.values():
        t1 = tkb.plain_t1_m(x, m)
        assert _rel_max(tkb.kron_t1_m(x, m), t1) <= 1e-5
        for sigma in (0.0, 0.5):
            ref = tkb.plain_t23_grid_m(x, t1, m, sigma, cy, cz)
            assert _rel_max(tkb.kron_t23_grid_m(x, t1, m, sigma, cy, cz),
                            ref) <= 1e-5
            assert _rel_max(tkb.kron_t23_grid_m(x, t1, m, sigma, cy, cz,
                                                r3=r), r - ref) <= 1e-5


@pytest.mark.cuda
def test_grid_robin_graded_vcycle_on_cuda_matches_cpu(cuda_device):
    """One (2, 2, 2) ``kron_blocked`` V-cycle on the Robin + graded box on
    the card against the same V-cycle on the CPU (plain versions) at the
    CPU run's smoother bounds, on a seeded rhs and iterate: within 1e-5
    relative max-norm; #9 launches."""
    mesh = _robin_graded((4, 4, 4))
    kw = dict(degrees=(1, 3), kappa=2.0, coarse="fdm",
              operator="kron_blocked", dtype=torch.float32)
    g_h = GridPMG(mesh, (2, 2, 2), device="cpu", **kw)
    g_c = GridPMG(mesh, (2, 2, 2), device=cuda_device, **kw)
    g_c.load_state({"levels": [{"lmax": lv["lmax"].to(cuda_device)}
                               for lv in g_h.data["levels"]]})
    rng = np.random.default_rng(30)
    b, u = (rng.standard_normal(mesh.num_dofs(3)) for _ in range(2))
    before = tkb.LAUNCHES["t23_grid_m"]
    v_c = g_c.from_dist(g_c.apply(g_c.to_dist(b), g_c.to_dist(u)))
    torch.cuda.synchronize()
    assert tkb.LAUNCHES["t23_grid_m"] > before
    v_h = g_h.from_dist(g_h.apply(g_h.to_dist(b), g_h.to_dist(u)))
    assert _rel_max(v_c.cpu(), v_h) <= 1e-5
