"""The slab layer on an NVIDIA GPU, against the plain versions: the
``kron_blocked`` apply (`parallel.dist.dist_kron_blocked_cycle_ops`:
kernels #1-#3 with the x exchange between kernel 1 and kernel 2) against
the per-slab plain versions, and the gather-free coarse family (`DistFDM`,
the slab's ``fdm`` with ``dist=True`` and the gather-free ``hmg``) against
the same solve or cycle run on the CPU. Every test here carries the
``cuda`` marker and skips without a card; the module imports no JAX (the
card has none), so it runs there with ``python -m pytest --noconftest -m
cuda tests/test_torch_dist_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh  # noqa: E402
from pmg_dolfinx_tpu_torch.ops import kron_blocked as tkb  # noqa: E402
from pmg_dolfinx_tpu_torch.parallel.dist import (  # noqa: E402
    DistPMG,
    _exchange_partials,
    dist_kron_blocked_cycle_ops,
    slab_blocks,
)

# (cells, slabs, degree): extents off the kernels' 32-lane and chunk grids,
# one slab per shard and a slab of one cell, bands 1, 3 and 6.
CASES = [((8, 5, 7), 2, 3), ((12, 9, 4), 4, 6), ((6, 3, 11), 6, 1),
         ((10, 4, 4), 5, 6)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return "cuda"


def _rel_max(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _plain_per_slab(x, lv, S, sigma, r=None):
    """Kernels 1 and 2 (or 3) as the per-slab plain versions on each
    slab's own arrays, the plain exchange between them."""
    blocks = slab_blocks(lv["kb_mats"], S)
    t1 = torch.stack([tkb.plain_t1_m(x[s], blocks[s]) for s in range(S)])
    t1 = _exchange_partials(t1, S)
    y = torch.stack([tkb.plain_t23_m(x[s], t1[s], blocks[s], sigma)
                     for s in range(S)])
    return y if r is None else r - y


@pytest.mark.cuda
@pytest.mark.parametrize("nc,S,P", CASES)
def test_cuda_slab_apply_and_residual_match_per_slab_plain(cuda_device, nc,
                                                           S, P):
    """The apply and fused residual on the stacked slab lattice equal the
    per-slab plain versions to 1e-5 (relative max-norm, f32), sigma 0 and
    0.5, and launch #1-#3 each once per call over all the slabs."""
    mesh = BoxMesh(nc)
    rng = np.random.default_rng(17 + P)
    for sigma in (0.0, 0.5):
        dist = DistPMG(mesh, n_devices=S, degrees=(P,), dtype=torch.float32,
                       operator="kron_blocked", sigma=sigma, coarse="cg",
                       device=cuda_device)
        lv, level = dist.data["levels"][-1], dist.levels[-1]
        ops = dist_kron_blocked_cycle_ops(S, sigma=sigma)
        shape = (S,) + tuple(level.shape)
        x, b = (torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                             device=cuda_device) for _ in range(2))
        for k in tkb.LAUNCHES:
            tkb.LAUNCHES[k] = 0
        y = ops["apply"](lv, x, level)
        r = ops["residual"](lv, b, x, level)
        torch.cuda.synchronize()
        assert tkb.LAUNCHES["t1_m"] == 2
        assert tkb.LAUNCHES["t23_m"] == 1
        assert tkb.LAUNCHES["t23_res_m"] == 1
        assert _rel_max(y, _plain_per_slab(x, lv, S, sigma)) <= 1e-5
        assert _rel_max(r, _plain_per_slab(x, lv, S, sigma, r=b)) <= 1e-5


@pytest.mark.cuda
def test_cuda_slab_solve_matches_plain_on_the_card(cuda_device):
    """A slab V-cycle on the card equals the same cycle
    with its applies swapped for the per-slab plain versions (1e-5)."""
    mesh = BoxMesh((12, 7, 6))
    dist = DistPMG(mesh, n_devices=4, degrees=(1, 3), dtype=torch.float32,
                   operator="kron_blocked", coarse="fdm", device=cuda_device)
    S = dist.n_shards
    rng = np.random.default_rng(3)
    n = mesh.num_dofs(3)
    b, u = (dist.to_dist(rng.standard_normal(n)) for _ in range(2))
    v = dist.apply(b, u)
    kernels = dist._ops
    plain = dict(kernels,
                 apply=lambda lv, x, level: _plain_per_slab(x, lv, S, 0.0),
                 residual=lambda lv, bb, x, level: _plain_per_slab(
                     x, lv, S, 0.0, r=bb))
    dist._ops = plain
    try:
        v_plain = dist.apply(b, u)
    finally:
        dist._ops = kernels
    assert _rel_max(v, v_plain) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [6, (2, 2, 2)])
def test_cuda_dist_fdm_matches_the_cpu_run(cuda_device, shards):
    """`DistFDM` on the card (the pencil transposes of
    `StackedGrid.all_to_all` on CUDA tensors) equals the same solve on the
    CPU, f32, to 1e-5 relative max-norm."""
    from pmg_dolfinx_tpu_torch.parallel.fdm_dist import DistFDM

    mesh = BoxMesh((12, 6, 10))
    b = np.random.default_rng(8).standard_normal(mesh.num_dofs(3))
    kw = dict(kappa=2.0, dtype=torch.float32, sigma=0.5)
    u = DistFDM(mesh, 3, shards, device=cuda_device, **kw).solve(b)
    u_cpu = DistFDM(mesh, 3, shards, device="cpu", **kw).solve(b)
    assert _rel_max(u.cpu(), u_cpu) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("coarse,cfg,S", [
    ("fdm", dict(dist=True), 6), ("hmg", dict(dist=True, bottom="fdm"), 7)])
def test_cuda_gather_free_slab_cycle_matches_the_cpu_run(cuda_device, coarse,
                                                         cfg, S):
    """The slab's p-coarse ``fdm`` with ``dist=True`` and the gather-free
    ``hmg`` on ``kron_blocked`` (kernels #1-#3 on the card): one V-cycle on
    the card equals the same cycle of the CPU hierarchy (the kernels' plain
    versions) on the card's calibrated state, to 1e-5."""
    mesh = BoxMesh((S * 2, 6, 6))
    kw = dict(n_devices=S, degrees=(1, 3), dtype=torch.float32,
              operator="kron_blocked", coarse=coarse)
    card = DistPMG(mesh, coarse_cfg=dict(cfg), device=cuda_device, **kw)
    cpu = DistPMG(mesh, coarse_cfg=dict(cfg), device="cpu", **kw)
    cpu.load_state({"levels": [{"lmax": lv["lmax"]}
                               for lv in card.data["levels"]]})
    rng = np.random.default_rng(9)
    n = mesh.num_dofs(3)
    b, u = rng.standard_normal(n), rng.standard_normal(n)
    v = card.from_dist(card.apply(card.to_dist(b), card.to_dist(u)))
    v_cpu = cpu.from_dist(cpu.apply(cpu.to_dist(b), cpu.to_dist(u)))
    assert _rel_max(v.cpu(), v_cpu) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("P", [3, 6])
def test_cuda_stacked_ktx_with_blocks_that_differ(cuda_device, P):
    """Kernel #1 on the stacked block-diagonal ``Ktx`` of a slab whose x
    is graded 8:1 with a Robin x-high face (every slab's block its own),
    and the apply and fused residual (#1-#3), within 1e-5 of the per-slab
    plain versions on each slab's own arrays, sigma 0 and 0.5."""
    from pmg_dolfinx_tpu_torch.fem.mesh import geometric_spacing

    S = 4
    mesh = BoxMesh((12, 5, 7), dirichlet_faces=((True, False), (True, True),
                                                (True, True)),
                   robin=((0.0, 1.7), (0.0, 0.0), (0.0, 0.0)),
                   spacing=(geometric_spacing(12, 8.0), None, None))
    rng = np.random.default_rng(41 + P)
    for sigma in (0.0, 0.5):
        dist = DistPMG(mesh, n_devices=S, degrees=(P,), dtype=torch.float32,
                       operator="kron_blocked", sigma=sigma, coarse="cg",
                       device=cuda_device)
        lv, level = dist.data["levels"][-1], dist.levels[-1]
        blocks = slab_blocks(lv["kb_mats"], S)
        assert not any(torch.equal(blocks[0]["Ktx"], m["Ktx"])
                       for m in blocks[1:])
        shape = (S,) + tuple(level.shape)
        x, b = (torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                             device=cuda_device) for _ in range(2))
        t1 = torch.stack([tkb.plain_t1_m(x[s], blocks[s]) for s in range(S)])
        got = tkb.kron_t1_m(x.reshape((-1,) + shape[2:]), lv["kb_mats"])
        assert _rel_max(got.reshape(shape), t1) <= 1e-5
        ops = dist_kron_blocked_cycle_ops(S, sigma=sigma)
        assert _rel_max(ops["apply"](lv, x, level),
                        _plain_per_slab(x, lv, S, sigma)) <= 1e-5
        assert _rel_max(ops["residual"](lv, b, x, level),
                        _plain_per_slab(x, lv, S, sigma, r=b)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("smoother", ["cheb", "schwarz"])
def test_cuda_dss_dist_vcycle_matches_the_cpu_run(cuda_device, smoother):
    """One f32 `DSSDist` V-cycle (the stacked gather / scatter, the
    shared-entity exchange through `StackedGrid.psum`, the ``direct``
    coarse's gather) on the card against the same cycle on the CPU, both
    at the CPU run's smoother bounds, within 1e-5 relative; 375 cells
    over 8 shards, so dummy cells."""
    from pmg_dolfinx_tpu_torch.fem.unstructured import l_shaped_hex_mesh
    from pmg_dolfinx_tpu_torch.parallel.dss_dist import DSSDist

    mesh = l_shaped_hex_mesh(5)
    kw = dict(n_devices=8, degrees=(1, 3, 6), kappa=2.0,
              dtype=torch.float32, coarse="direct", smoother=smoother)
    cpu = DSSDist(mesh, device="cpu", **kw)
    card = DSSDist(mesh, device=cuda_device, **kw)
    card.load_state({"levels": [{"lmax": lv["lmax"]}
                                for lv in cpu.data["levels"]]})
    rng = np.random.default_rng(7)
    nd = mesh.num_dofs(6)
    b, u = (rng.standard_normal(nd).astype(np.float32) for _ in range(2))
    ref = cpu.from_dist(cpu.apply(cpu.to_dist(b), cpu.to_dist(u)))
    got = card.from_dist(card.apply(card.to_dist(b), card.to_dist(u)))
    assert _rel_max(got.cpu(), ref) <= 1e-5
