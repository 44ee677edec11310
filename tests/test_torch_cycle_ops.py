"""The port's cycle-ops factories and lattice transfers bind positional
arguments as the JAX package does.

Each factory (`kron_cycle_ops`, `kron_blocked_cycle_ops`,
`lattice_cycle_ops`, `lattice_blocked_cycle_ops`) is called with the same
positional argument list in both packages, on the fine level of a JAX
hierarchy and of the port's hierarchy that loaded its state
(`utils.convert`, `load_state`):

- the same primitives (JAX's ``pvary`` is its device-sharding hook, not
  ported; ``zeros``, optional in JAX, is always supplied by the port);
- ``fuse_smoother`` visible as ``"smooth"``;
- the fine-level apply and restriction equal, to 1e-12 relative in f64
  (`kron`, `lattice`) and to 1e-5 in f32 (the blocked backends, whose
  JAX kernels are f32 only).

`lattice_restrict` / `lattice_prolongate` take JAX's fourth positional,
``precision``. Every factory at 'high' matches JAX's at 'high'. The TPU tile knobs (``by``, ``bx``, ``bcells``) keep their
positions and raise anything but JAX's default.
"""

from functools import lru_cache

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh as TBoxMesh  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import (  # noqa: E402
    PerturbedBoxMesh as TPerturbedBoxMesh,
)
from pmg_dolfinx_tpu_torch.ops import lattice as tlat  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers import pmg as tpmg  # noqa: E402

NC = (2, 3, 2)
DEGREES = (1, 2)
SIGMA = 0.5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@lru_cache(maxsize=None)
def _hierarchies(operator):
    """(JAX hierarchy, port hierarchy on its state, tolerance) with a
    scalar ``sigma`` (so the general levels carry ``m3``)."""
    import jax
    import jax.numpy as jnp

    from pmg_dolfinx_tpu.fem.mesh import BoxMesh, PerturbedBoxMesh
    from pmg_dolfinx_tpu.solvers.pmg import PMGHierarchy
    from pmg_dolfinx_tpu_torch.utils.convert import hierarchy_data_from_numpy

    f64 = operator in ("kron", "lattice")
    jdt, tdt = ((jnp.float64, torch.float64) if f64
                else (jnp.float32, torch.float32))
    box = operator.startswith("kron")
    jm = BoxMesh(NC) if box else PerturbedBoxMesh(NC)
    tm = TBoxMesh(NC) if box else TPerturbedBoxMesh(NC)
    kw = dict(degrees=DEGREES, kappa=2.0, operator=operator, sigma=SIGMA)
    jh = PMGHierarchy(jm, dtype=jdt, **kw)
    th = tpmg.PMGHierarchy(tm, dtype=tdt, device="cpu", **kw)
    th.load_state(hierarchy_data_from_numpy(
        jax.tree.map(np.asarray, jh.data), "cpu", tdt))
    return jh, th, (1e-12 if f64 else 1e-5)


CASES = [
    ("kron_cycle_ops", "kron", ("highest",)),
    ("kron_cycle_ops", "kron", ("highest", SIGMA)),
    ("kron_blocked_cycle_ops", "kron_blocked", ("highest", None, None, True)),
    ("kron_blocked_cycle_ops", "kron_blocked",
     ("highest", None, None, False, SIGMA)),
    ("kron_blocked_cycle_ops", "kron_blocked",
     ("highest", None, None, False, 0.0, False, True)),
    ("lattice_cycle_ops", "lattice", ("highest",)),
    ("lattice_cycle_ops", "lattice", ("highest", SIGMA)),
    ("lattice_blocked_cycle_ops", "lattice_blocked", ("highest", 1)),
    ("lattice_blocked_cycle_ops", "lattice_blocked", ("highest", 1, SIGMA)),
]


@pytest.mark.parametrize("factory,operator,args", CASES,
                         ids=[f"{f}{a}" for f, _, a in CASES])
def test_factory_binds_positionals_as_jax(factory, operator, args):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from pmg_dolfinx_tpu.solvers import pmg as jpmg

    jh, th, tol = _hierarchies(operator)
    ops_j = getattr(jpmg, factory)(*args)
    ops_t = getattr(tpmg, factory)(*args)
    assert set(ops_j) - {"pvary", "zeros"} == set(ops_t) - {"zeros"}
    assert "zeros" in ops_t
    fuse_smoother = factory == "kron_blocked_cycle_ops" and len(args) > 3 \
        and args[3]
    assert ("smooth" in ops_t) == bool(fuse_smoother)

    lj, lt = jh.levels[-1], th.levels[-1]
    dvj, dvt = jh.data["levels"][-1], th.data["levels"][-1]
    shape = lt.shape if operator.startswith("kron") else (lt.ndofs,)
    x = np.random.default_rng(4).standard_normal(shape)
    x = x.astype(np.float64 if tol < 1e-6 else np.float32)
    y_j = ops_j["apply"](dvj, jnp.asarray(x), lj)
    y_t = ops_t["apply"](dvt, torch.from_numpy(x), lt)
    assert y_t.dtype == torch.from_numpy(x).dtype
    assert _rel(y_t.numpy(), y_j) <= tol
    trj, trt = jh.data["transfer"][0], th.data["transfer"][0]
    r_j = ops_j["restrict"](trj, jnp.asarray(x), jh.levels[0], lj)
    r_t = ops_t["restrict"](trt, torch.from_numpy(x), th.levels[0], lt)
    assert _rel(r_t.numpy(), r_j) <= tol


@pytest.mark.parametrize("direction", ["restrict", "prolong"])
def test_lattice_transfers_take_precision_fourth(direction):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from pmg_dolfinx_tpu.ops import lattice as jlat

    p = 3 if direction == "restrict" else 1
    shape = tuple(n * p + 1 for n in NC)
    I1s = [tlat.axis_interpolation_matrix(n, 1, 3) for n in NC]
    x = np.random.default_rng(6).standard_normal(shape)
    name = "lattice_" + ("restrict" if direction == "restrict"
                         else "prolongate")
    y_j = getattr(jlat, name)(jnp.asarray(x),
                              tuple(jnp.asarray(I) for I in I1s), shape,
                              "highest")
    y_t = getattr(tlat, name)(torch.from_numpy(x),
                              tuple(torch.from_numpy(I) for I in I1s), shape,
                              "highest")
    assert _rel(y_t.numpy(), y_j) <= 1e-12
    # 'high' on an einsum path: exact in both (XLA's CPU backend, and the
    # port's rule for the XLA paths)
    y_j = getattr(jlat, name)(jnp.asarray(x),
                              tuple(jnp.asarray(I) for I in I1s), shape,
                              "high")
    y_t = getattr(tlat, name)(torch.from_numpy(x),
                              tuple(torch.from_numpy(I) for I in I1s), shape,
                              "high")
    assert _rel(y_t.numpy(), y_j) <= 1e-12


@pytest.mark.parametrize("call,match", [
    (lambda: tpmg.kron_blocked_cycle_ops("highest", 8), "by=8 is a TPU tile"),
    (lambda: tpmg.kron_blocked_cycle_ops("highest", None, 16),
     "bx=16 is a TPU tile"),
    (lambda: tpmg.lattice_blocked_cycle_ops("highest", 2),
     "bcells=2 is a TPU tile"),
])
def test_tpu_tile_knobs_raise(call, match):
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.parametrize("factory,operator", [
    ("kron_cycle_ops", "kron"), ("kron_blocked_cycle_ops", "kron_blocked"),
    ("lattice_cycle_ops", "lattice"),
    ("lattice_blocked_cycle_ops", "lattice_blocked")])
def test_precision_high_matches_jax(factory, operator):
    """Each factory at 'high' on the fine level against JAX's factory at
    'high' on the CPU (XLA's exact f32 / f64 there, and the blocked
    backends' emulation): the einsum backends to 1e-12, the bf16x3
    kernels' plain versions to the file's f32 bound; the restriction
    stays exact ('highest')."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from pmg_dolfinx_tpu.solvers import pmg as jpmg

    jh, th, tol = _hierarchies(operator)
    ops_j = getattr(jpmg, factory)("high")
    ops_t = getattr(tpmg, factory)("high")
    lj, lt = jh.levels[-1], th.levels[-1]
    dvj, dvt = jh.data["levels"][-1], th.data["levels"][-1]
    shape = lt.shape if operator.startswith("kron") else (lt.ndofs,)
    x = np.random.default_rng(5).standard_normal(shape)
    x = x.astype(np.float64 if tol < 1e-6 else np.float32)
    y_j = ops_j["apply"](dvj, jnp.asarray(x), lj)
    y_t = ops_t["apply"](dvt, torch.from_numpy(x), lt)
    assert _rel(y_t.numpy(), y_j) <= tol
    if tol > 1e-6:   # the split acts on the kernel backends
        y_h = tpmg.__dict__[factory]("highest")["apply"](
            dvt, torch.from_numpy(x), lt)
        assert _rel(y_t.numpy(), y_h.numpy()) > 1e-8
    trj, trt = jh.data["transfer"][0], th.data["transfer"][0]
    r_j = ops_j["restrict"](trj, jnp.asarray(x), jh.levels[0], lj)
    r_t = ops_t["restrict"](trt, torch.from_numpy(x), th.levels[0], lt)
    assert _rel(r_t.numpy(), r_j) <= tol
