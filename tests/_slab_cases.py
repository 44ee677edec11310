"""The slab parity cases shared by `tests/test_torch_dist.py` and
`tests/test_torch_dist_solvers.py`: each case builds the JAX package's
`DistPMG` (on the 8 virtual CPU devices of `tests/conftest.py`) and the
port's once per test process; the ``check_*`` functions hold the port to
JAX on it (tolerances in `tests/test_torch_dist.py`'s docstring)."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from pmg_dolfinx_tpu.fem.mesh import BoxMesh as JBox
from pmg_dolfinx_tpu.parallel import dist as jd
from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh as TBox
from pmg_dolfinx_tpu_torch.parallel import dist as td
from pmg_dolfinx_tpu_torch.utils.convert import dist_data_from_numpy

# name: (mesh cells, slabs, operator, coarse, smoother, sigma, kappa)
CASES = {
    "dofmap-cg-cheb-2": ((8, 4, 4), 2, "dofmap", "cg", "cheb", 0.0, 2.0),
    "dofmap-smoother-schwarz-8": ((8, 4, 4), 8, "dofmap", "smoother",
                                  "schwarz", 0.0, 2.0),
    "dofmap-direct-cheb-4-sigma": ((8, 8, 6), 4, "dofmap", "direct", "cheb",
                                   0.6, 2.0),
    "lattice-cg-cheb-8": ((8, 4, 4), 8, "lattice", "cg", "cheb", 0.0, 2.0),
    "lattice-fdm-linez-2": ((8, 4, 4), 2, "lattice", "fdm", "line-z", 0.0,
                            2.0),
    "kron-fdm-cheb-8": ((8, 4, 4), 8, "kron", "fdm", "cheb", 0.0, 2.0),
    "kron-direct-liney-4": ((8, 4, 4), 4, "kron", "direct", "line-y", 0.0,
                            2.0),
    "kron-smoother-schwarz-2-axes": ((8, 8, 6), 2, "kron", "smoother",
                                     "schwarz", 0.5, (1.0, 2.0, 3.0)),
    "kron_blocked-fdm-cheb-2": ((8, 4, 4), 2, "kron_blocked", "fdm", "cheb",
                                0.0, 2.0),
    "kron_blocked-cg-cheb-8-sigma": ((8, 4, 4), 8, "kron_blocked", "cg",
                                     "cheb", 0.5, 2.0),
}
_BUILT = {}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _f32(name):
    return CASES[name][2] == "kron_blocked"


def _pair(name):
    """(JAX DistPMG, port DistPMG, seeded rhs, seeded iterate), built once."""
    if name not in _BUILT:
        nc, S, op, coarse, sm, sigma, kappa = CASES[name]
        kw = dict(degrees=(1, 3), kappa=kappa, coarse=coarse, operator=op,
                  smoother=sm, sigma=sigma)
        f32 = _f32(name)
        j = jd.DistPMG(JBox(nc), n_devices=S,
                       dtype=jnp.float32 if f32 else jnp.float64, **kw)
        t = td.DistPMG(TBox(nc), n_devices=S,
                       dtype=torch.float32 if f32 else torch.float64,
                       device="cpu", **kw)
        n = TBox(nc).num_dofs(3)
        rng = np.random.default_rng(len(_BUILT))
        b = rng.standard_normal(n)
        b[TBox(nc).boundary_dof_marker(3)] = 0.0
        _BUILT[name] = (j, t, b, rng.standard_normal(n))
    return _BUILT[name]


def check_operator(name):
    j, t, b, x = _pair(name)
    yj = j.from_dist(j.operator()(j.to_dist(x)))
    yt = t.from_dist(t.operator()(t.to_dist(x)))
    assert _rel(yt, yj) <= (1e-5 if _f32(name) else 1e-12)


def check_eigs(name):
    j, t, _, _ = _pair(name)
    for ej, et in zip(j.eigs, t.eigs):
        np.testing.assert_allclose(np.asarray(et), np.asarray(ej),
                                   rtol=1e-4 if _f32(name) else 1e-8)


def check_trajectory(name):
    j, t, b, _ = _pair(name)
    _, rj = j.solve(b, num_cycles=5)
    ut, rt = t.solve(b, num_cycles=5)
    rj, rt = np.array(rj), np.array(rt)
    if _f32(name):
        keep = rj / np.linalg.norm(b) > 5e-3
        assert np.all(np.abs(rt - rj)[keep] / rj[keep] <= 5e-4)
    else:
        np.testing.assert_allclose(rt, rj, rtol=1e-9)
    assert tuple(ut.shape) == (b.size,)


def check_pcg(name):
    j, t, b, _ = _pair(name)
    rtol = 1e-5 if _f32(name) else 1e-8
    uj, nj = j.solve_pcg(b, rtol=rtol)
    ut, nt = t.solve_pcg(b, rtol=rtol)
    if _f32(name):
        assert abs(nt - nj) <= 1
        assert _rel(ut, uj) <= 1e-5
    else:
        assert nt == nj
        assert _rel(ut, uj) <= 1e-10


def check_loaded(name):
    """One V-cycle of the port on JAX's calibrated state equals JAX's."""
    j, t, b, x = _pair(name)
    t.load_state(dist_data_from_numpy(jax.tree.map(np.asarray, j.data), t,
                                      "cpu", t.dtype))
    vj = j.from_dist(j.apply(j.to_dist(b), j.to_dist(x)))
    vt = t.from_dist(t.apply(t.to_dist(b), t.to_dist(x)))
    assert _rel(vt, vj) <= (1e-6 if _f32(name) else 1e-13)
