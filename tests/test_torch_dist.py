"""The 1D slab layer of the port (`parallel.partition.SlabPartition`,
`parallel.dist.DistPMG`) against the JAX package's `DistPMG` on 8 virtual
CPU devices.

- `SlabPartition` equals JAX's: layout round trip, ownership weights,
  local dofmap, starts and divisibility refusal, S in {1, 2, 4, 8};
- per case (backend, coarse solve, smoother, slab count; f64 unless
  ``kron_blocked``, whose JAX kernels run in interpret mode against the
  port's plain versions in f32): the fine operator (1e-12 relative; f32
  1e-5), the calibration eigenvalues (rtol 1e-8; f32 1e-4), five
  stationary cycles (rtol 1e-9; f32 JAX's grid tolerance, 5e-4 above
  5e-3), `solve_pcg` (the same count, the solution within 1e-10; f32
  1e-5) and one V-cycle on JAX's state (`dist_data_from_numpy` +
  `load_state`; 1e-13, f32 1e-6). The cases cover the four backends, the
  coarse solves ``cg``, ``smoother``, ``fdm``, ``direct``, the smoothers
  point Jacobi, ``line-y``, ``line-z`` and ``schwarz``, a scalar sigma,
  per-axis kappa and S in {2, 4, 8};
- the stacked ``kron_blocked`` launch design equals the per-slab plain
  versions, and `_exchange_partials` equals its definition;
- ``precision="high"``: ``kron_blocked`` (bf16x3, the plain versions
  here) against JAX's `DistPMG` at 'high' (its CPU emulation, exact f32):
  five cycles within 1e-4 of |b| above 5e-3, FCG within 1; ``kron`` on a
  Robin-faced slab (the einsum path: f64 at either value) equal to
  'highest' bit for bit;
- every refusal: a ValueError for a ``devices=`` that names no ranks
  (on `DistPMG`, on the distributed layout and on a graded Kronecker
  slab; the multi-process runs are tests/test_torch_multihost.py);
  JAX's ValueErrors for an off-diagonal tensor or a
  per-cell kappa on the Kronecker family (on `DistPMG` and on a graded
  mesh's `build_hmg_dist`), a sigma field on the Kronecker family,
  ``line-x``, an unknown backend, f64 ``kron_blocked`` and a slab count
  that does not divide. Robin faces, graded spacing and diagonal-tensor
  kappa on the Kronecker slabs run against JAX in
  `tests/test_torch_kron_sharded.py`.

The solve modes (`solve_refined`, ``fmg``, ``u0``), the shardwrap
programs and the drivers are in `tests/test_torch_dist_solvers.py` and
`tests/test_torch_shardwrap.py`; the card test of the stacked launches
is `tests/test_torch_dist_cuda.py`.
"""

import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from _slab_cases import (  # noqa: E402
    CASES,
    _rel,
    check_eigs,
    check_loaded,
    check_operator,
    check_pcg,
    check_trajectory,
)
from pmg_dolfinx_tpu.fem.mesh import BoxMesh as JBox  # noqa: E402
from pmg_dolfinx_tpu.parallel import dist as jd  # noqa: E402
from pmg_dolfinx_tpu.parallel.partition import (  # noqa: E402
    SlabPartition as JSlab,
)
from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh as TBox  # noqa: E402
from pmg_dolfinx_tpu_torch.parallel import dist as td  # noqa: E402
from pmg_dolfinx_tpu_torch.parallel.partition import (  # noqa: E402
    SlabPartition as TSlab,
)

# Half the parity cases here, half in tests/test_torch_dist_solvers.py (so
# no one test worker carries every JAX compile).
CASES_HERE = list(CASES)[::2]

@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("P", [1, 3])
def test_slab_partition_matches_jax(S, P):
    nc = (8, 4, 3)
    jp, tp = JSlab(JBox(nc), S), TSlab(TBox(nc), S)
    u = np.random.default_rng(S + P).standard_normal(TBox(nc).num_dofs(P))
    assert np.array_equal(tp.to_dist(P, u), jp.to_dist(P, u))
    assert np.array_equal(tp.from_dist(P, tp.to_dist(P, u)), u)
    assert np.array_equal(tp.ownership_weights(P), jp.ownership_weights(P))
    assert np.array_equal(tp.local_dofmap(P), jp.local_dofmap(P))
    assert tp.axis_starts(P) == jp.axis_starts(P)
    assert tp.local_shape(P) == jp.local_shape(P)
    assert tp.local_ndofs(P) == jp.local_ndofs(P)
    assert tp.cell_slab_slices() == jp.cell_slab_slices()
    w = tp.ownership_weights(P).reshape(-1)
    assert w.sum() == TBox(nc).num_dofs(P)


def test_slab_partition_refuses_what_jax_refuses():
    for cls, mesh in ((TSlab, TBox((6, 4, 4))), (JSlab, JBox((6, 4, 4)))):
        with pytest.raises(ValueError, match="divisible by n_shards=4"):
            cls(mesh, 4)


@pytest.mark.parametrize("name", CASES_HERE)
def test_fine_operator_matches_jax(name):
    check_operator(name)


@pytest.mark.parametrize("name", CASES_HERE)
def test_calibration_eigs_match_jax(name):
    check_eigs(name)


@pytest.mark.parametrize("name", CASES_HERE)
def test_five_cycle_trajectory_matches_jax(name):
    check_trajectory(name)


@pytest.mark.parametrize("name", CASES_HERE)
def test_solve_pcg_matches_jax(name):
    check_pcg(name)


@pytest.mark.parametrize("name", CASES_HERE)
def test_vcycle_on_jax_state(name):
    check_loaded(name)


@pytest.mark.parametrize("S", [1, 2, 4])
def test_kron_blocked_launch_designs_match_per_slab_plain(S):
    """The stacked design (one launch per kernel over the stacked lattice,
    block-diagonal Ktx) gives each slab its own apply and residual: equal
    to the per-slab plain versions on each slab's own arrays
    (`slab_blocks`) with the exchange between kernels 1 and 2."""
    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb

    mesh = TBox((8, 5, 3))
    rng = np.random.default_rng(S)
    t = td.DistPMG(mesh, n_devices=S, degrees=(3,), dtype=torch.float32,
                   operator="kron_blocked", sigma=0.5, device="cpu")
    lv, level = t.data["levels"][-1], t.levels[-1]
    ops = td.dist_kron_blocked_cycle_ops(S, sigma=0.5)
    shape = (S,) + tuple(level.shape)
    x, b = (torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
            for _ in range(2))
    blocks = td.slab_blocks(lv["kb_mats"], S)
    t1 = td._exchange_partials(torch.stack(
        [kb.plain_t1_m(x[s], blocks[s]) for s in range(S)]), S)
    ref = torch.stack([kb.plain_t23_m(x[s], t1[s], blocks[s], 0.5)
                       for s in range(S)])
    assert _rel(ops["apply"](lv, x, level), ref) <= 1e-6
    assert _rel(ops["residual"](lv, b, x, level), b - ref) <= 1e-6


def test_exchange_partials_adds_the_neighbour_planes():
    S = 4
    lat = torch.tensor(np.random.default_rng(0).standard_normal((S, 3, 2, 2)))
    out = td._exchange_partials(lat, S)
    ref = lat.clone()
    ref[1:, 0] += lat[:-1, -1]
    ref[:-1, -1] += lat[1:, 0]
    assert torch.equal(out, ref)
    td._exchange_partials(lat, S, inplace=True)
    assert torch.equal(lat, ref)


# An off-diagonal tensor kappa: the Kronecker-sum factorisation cannot
# express it (JAX's ValueError).
_ROTATED = np.array([[2.0, 0.5, 0.0], [0.5, 2.0, 0.0], [0.0, 0.0, 2.0]])


def _graded_hmg_dist():
    from pmg_dolfinx_tpu_torch.fem.mesh import geometric_spacing

    mesh = TBox((4, 4, 4), spacing=(geometric_spacing(4, 4.0), None, None))
    td.build_hmg_dist(mesh, 2, 1, _ROTATED, torch.float64, device="cpu")


def _dist_layout_devices():
    from pmg_dolfinx_tpu_torch.parallel.fdm_dist import dist_layout

    dist_layout(TBox((4, 4, 4)), 2, devices=["cpu"])


def _sigma_field_kron():
    td.DistPMG(TBox((4, 4, 4)), n_devices=2, operator="kron",
               sigma=lambda x: 1.0 + x[0], device="cpu")


# The first two cases were DistPMG's coarse="hmg" and coarse_cfg["dist"]
# until item 10 (a) ported them, the first then the distributed hmg on a
# graded mesh until item 10 (b) ported it; their ids stay, on what is
# still refused: a graded mesh's distributed hmg with an off-diagonal
# tensor kappa (JAX's ValueError) and the distributed layout's devices=
# (item 10 (d) until it ported the ranks: now a ValueError for a
# devices= that names devices, not ranks, with no process group up). The
# devices= case on DistPMG is the same. The kappa cases ran on the
# dofmap backend until the
# general family ported them, then as a tensor or per-cell kappa on the
# Kronecker family until item 10 (b) ported the diagonal tensor; they stay
# on what JAX refuses there for good: an off-diagonal tensor and a
# per-cell kappa. A sigma field on the Kronecker family is refused for
# good too.
_TODO = [
    (_graded_hmg_dist, "off-diagonal", ValueError),
    (_dist_layout_devices, "devices=", ValueError),
    (_sigma_field_kron, "sigma FIELD", ValueError),
    (dict(kappa=_ROTATED, operator="kron"), "off-diagonal", ValueError),
    (dict(kappa=np.linspace(1.0, 2.0, 64), operator="kron"), "per-cell",
     ValueError),
    (dict(devices=["cpu"]), "devices=", ValueError),
]


# The ids the cases have carried since they were written.
_TODO_IDS = ["_graded_hmg_dist-hmg", "_dist_layout_devices-dist",
             "kw2-sigma field", "kw3-tensor or per-cell kappa",
             "kw4-tensor or per-cell kappa", "kw5-devices="]


@pytest.mark.parametrize("kw,what,err_type", _TODO, ids=_TODO_IDS)
def test_unported_options_raise_naming_item_10(kw, what, err_type):
    """What the slab layer still refuses: a ``devices=`` that names no
    ranks raises ValueError, the rest JAX's own ValueError, which JAX's
    `DistPMG` raises on the same keywords."""
    ranks = what == "devices="
    match = "rank of each shard" if ranks else "Kronecker"
    with pytest.raises(err_type, match=match) as err:
        if callable(kw):
            kw()
        else:
            td.DistPMG(TBox((4, 4, 4)), n_devices=2, device="cpu", **kw)
    assert what in str(err.value)
    if not ranks and not callable(kw):
        with pytest.raises(ValueError, match=what):
            jd.DistPMG(JBox((4, 4, 4)), n_devices=2, **kw)


def test_robin_and_graded_meshes_raise_naming_item_10():
    """Robin faces and graded spacing on the Kronecker family's slabs run
    since item 10 (b) (tests/test_torch_kron_sharded.py); on such meshes
    the slabs refuse a ``devices=`` that names no ranks (ValueError; item
    10 (d) ported the ranks), and ``precision="high"`` runs (item 1): on
    the einsum path it equals 'highest' bit for bit."""
    from pmg_dolfinx_tpu_torch.fem.mesh import geometric_spacing

    robin = TBox((4, 4, 4), dirichlet_faces=((True, True), (False, False),
                                            (True, True)),
                 robin=((0.0, 0.0), (2.0, 2.0), (0.0, 0.0)))
    high, ref = (td.DistPMG(robin, n_devices=2, operator="kron",
                            precision=p, device="cpu")
                 for p in ("high", "highest"))
    x = np.random.default_rng(3).standard_normal(robin.num_dofs(3))
    assert torch.equal(high.from_dist(high.operator()(high.to_dist(x))),
                       ref.from_dist(ref.operator()(ref.to_dist(x))))
    graded = TBox((4, 4, 4), spacing=(geometric_spacing(4, 4.0), None, None))
    with pytest.raises(ValueError, match=r"devices=.*rank of each shard"):
        td.DistPMG(graded, n_devices=2, operator="kron_blocked",
                   dtype=torch.float32, devices=["cpu"], device="cpu")


def test_high_precision_matches_jax():
    """`DistPMG` kron_blocked at precision='high' on 2 slabs against JAX's
    at 'high' (its CPU emulation, exact f32): five cycles within 1e-4 of
    |b| above 5e-3 (the port's residual norms are bf16x3 residuals, ~1e-5
    |b| from exact), FCG(V) to 1e-5 (the 'high' contract's accuracy)
    within 1."""
    import jax.numpy as jnp

    from pmg_dolfinx_tpu.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu.models.poisson import f_rhs

    kw = dict(degrees=(1, 3), kappa=2.0, coarse="fdm",
              operator="kron_blocked", precision="high")
    j = jd.DistPMG(JBox((8, 4, 4)), n_devices=2, dtype=jnp.float32, **kw)
    t = td.DistPMG(TBox((8, 4, 4)), n_devices=2, dtype=torch.float32,
                   device="cpu", **kw)
    b = np.asarray(assemble_rhs(JBox((8, 4, 4)), 3, f_rhs(2.0)))
    rn_j, rn_t = (np.array(h.solve(b, num_cycles=5)[1]) for h in (j, t))
    r0 = np.linalg.norm(b)
    keep = rn_j / r0 > 5e-3
    assert np.max(np.abs(rn_t - rn_j)[keep]) / r0 <= 1e-4
    (_, n_j), (_, n_t) = (h.solve_pcg(b, rtol=1e-5) for h in (j, t))
    assert abs(n_t - n_j) <= 1


@pytest.mark.parametrize("kw,match", [
    (dict(smoother="line-x"), "cannot relax along x"),
    (dict(operator="lattice_blocked"), "unknown operator backend"),
    (dict(operator="kron_blocked"), "f32-only"),
    (dict(coarse="amg"), "unsupported coarse solver"),
])
def test_value_errors_as_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        td.DistPMG(TBox((4, 4, 4)), n_devices=2, device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        jd.DistPMG(JBox((4, 4, 4)), n_devices=2, **kw)
