"""Parity of the port's cycle modes and outer solvers with the JAX package.

- f64 (<= 1e-10 relative): the W-cycle (``coarse_cfg["gamma"] = 2``) and
  the V-cycle on degrees (1, 2, 3), `fmg_initial_guess`,
  ``solve/solve_pcg(fmg=True)``, ``solve_many``/``solve_pcg_many`` (each
  column's count equals its single-RHS count), the FDM ``solve_many`` and
  ``refine`` (with a sigma shift), ``chebyshev1_solve`` and
  ``PoissonProblem.interpolate_exact``.
- ``solve_refined`` with f32 cycles and the f64 outer residual: below
  1e-9 relative residual within 20 cycles on a box (``kron_blocked``,
  fused and not; JAX's gate, `tests/test_pmg.py`) and below 1e-6 within
  30 on a `PerturbedBoxMesh` (``lattice``, the f64 lattice residual;
  `tests/test_curved.py`), with the JAX solution on the same problem.
- The driver ``examples/pmg_torch.py --device cpu`` with each new flag:
  its last JSON line against ``examples/pmg.py --cpu``'s, in f64.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pmg_dolfinx_tpu.fem.assembly import assemble_rhs as j_assemble_rhs  # noqa: E402
from pmg_dolfinx_tpu.fem.mesh import BoxMesh as JBoxMesh  # noqa: E402
from pmg_dolfinx_tpu.fem.mesh import PerturbedBoxMesh as JPerturbedBoxMesh  # noqa: E402
from pmg_dolfinx_tpu.models.poisson import PoissonProblem as JProblem  # noqa: E402
from pmg_dolfinx_tpu.models.poisson import f_rhs  # noqa: E402
from pmg_dolfinx_tpu.solvers.pmg import PMGHierarchy as JHierarchy  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh, PerturbedBoxMesh  # noqa: E402
from pmg_dolfinx_tpu_torch.models.poisson import PoissonProblem as TProblem  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy, fmg_initial_guess  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
KAPPA = 2.0


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.abs(b)


def _reln(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _pair(nc, degrees, **kw):
    """The JAX and the port hierarchy of one f64 configuration, and the
    manufactured rhs."""
    jh = JHierarchy(JBoxMesh(nc), degrees=degrees, kappa=KAPPA,
                    dtype=jnp.float64, **kw)
    th = PMGHierarchy(BoxMesh(nc), degrees=degrees, kappa=KAPPA,
                      dtype=torch.float64, device="cpu", **kw)
    b = j_assemble_rhs(jh.mesh, degrees[-1], f_rhs(KAPPA))
    return jh, th, b


@pytest.mark.parametrize("operator,coarse,gamma", [
    ("kron", "fdm", 2),
    ("kron", "cg", 1),
    ("dofmap", "smoother", 2),
])
def test_cycles_and_fmg_match_jax_f64(operator, coarse, gamma):
    cfg = {"gamma": gamma} if gamma > 1 else None
    jh, th, b = _pair((3, 3, 3), (1, 2, 3), operator=operator,
                      coarse=coarse, coarse_cfg=cfg)
    for et, ej in zip(th.eigs, jh.eigs):
        assert np.max(_rel(et, ej)) <= 1e-10
    tb = torch.from_numpy(b)
    # per-cycle relative parity while the residual is well above the f64
    # rounding of b (the W-cycle reaches 1e-6 by cycle 5)
    _, rj = jh.solve(b, num_cycles=4)
    _, rt = th.solve(tb, num_cycles=4)
    assert np.max(_rel(rt, rj)) <= 1e-10
    # the FMG guess itself, then the solves started from it
    g_j = jh._from_work(jh._fmg_guess(jh._to_work(jnp.asarray(b))))
    g_t = fmg_initial_guess(th.data, th._to_work(tb), levels=th.levels,
                            coarse=th.coarse, coarse_cfg=th.coarse_cfg,
                            ops=th.ops).reshape(-1)
    assert _reln(g_t.numpy(), g_j) <= 1e-10
    _, rj = jh.solve(b, num_cycles=3, fmg=True)
    _, rt = th.solve(tb, num_cycles=3, fmg=True)
    assert np.max(_rel(rt, rj)) <= 1e-10
    uj, nj = jh.solve_pcg(b, rtol=1e-8, fmg=True)
    ut, nt = th.solve_pcg(tb, rtol=1e-8, fmg=True)
    assert nt == nj
    assert _reln(ut.numpy(), uj) <= 1e-10


def test_solve_many_matches_jax_and_single_rhs():
    jh, th, b = _pair((3, 3, 3), (1, 3), operator="kron", coarse="fdm")
    rng = np.random.default_rng(7)
    B = np.stack([b, 2.0 * b + 0.1 * rng.standard_normal(b.shape),
                  rng.standard_normal(b.shape)])
    Uj, Rj = jh.solve_many(B, num_cycles=4)
    Ut, Rt = th.solve_many(torch.from_numpy(B), num_cycles=4)
    assert Ut.shape == B.shape and Rt.shape == (3, 4)
    assert np.max(_rel(Rt, Rj)) <= 1e-10
    assert _reln(Ut.numpy(), Uj) <= 1e-10
    Uj, nj = jh.solve_pcg_many(B, rtol=1e-8)
    Ut, nt = th.solve_pcg_many(torch.from_numpy(B), rtol=1e-8)
    assert list(nt) == list(nj)
    assert list(nt) == [th.solve_pcg(torch.from_numpy(c), rtol=1e-8)[1]
                        for c in B]
    assert _reln(Ut.numpy(), Uj) <= 1e-10


def test_fdm_solve_many_and_refine_match_jax():
    from pmg_dolfinx_tpu.solvers.fdm import FastDiagonalizationSolver as JFDM
    from pmg_dolfinx_tpu_torch.solvers.fdm import FastDiagonalizationSolver

    nc, P, sigma = (3, 4, 2), 3, 3.0
    jf = JFDM(JBoxMesh(nc), P, kappa=KAPPA, dtype=jnp.float64, sigma=sigma)
    tf = FastDiagonalizationSolver(BoxMesh(nc), P, kappa=KAPPA,
                                   dtype=torch.float64, sigma=sigma,
                                   device="cpu")
    rng = np.random.default_rng(3)
    B = rng.standard_normal((3, BoxMesh(nc).num_dofs(P)))
    assert _reln(tf.solve_many(torch.from_numpy(B)).numpy(),
                 jf.solve_many(B)) <= 1e-10
    uj, rj = jf.refine(B[0], cycles=3)
    ut, rt = tf.refine(torch.from_numpy(B[0]), cycles=3)
    assert ut.dtype == torch.float64
    assert _reln(ut.numpy(), uj) <= 1e-10
    assert abs(rt[0] - rj[0]) <= 1e-12 * rj[0]
    assert rt[-1] < 1e-12 * rt[0]  # sigma rides the f64 residual
    # f32 solves refined in f64: the JAX contraction, to f32 rounding
    jf32 = JFDM(JBoxMesh(nc), P, kappa=KAPPA, dtype=jnp.float32, sigma=sigma)
    tf32 = FastDiagonalizationSolver(BoxMesh(nc), P, kappa=KAPPA,
                                     dtype=torch.float32, sigma=sigma,
                                     device="cpu")
    uj, rj = jf32.refine(B[0], cycles=4)
    ut, rt = tf32.refine(torch.from_numpy(B[0]), cycles=4)
    assert rt[-1] < 1e-12 * rt[0] and rj[-1] < 1e-12 * rj[0]
    assert _reln(ut.numpy(), uj) <= 1e-10


def test_chebyshev1_matches_jax_f64():
    from pmg_dolfinx_tpu.ops.kron import KronLaplacian as JKron
    from pmg_dolfinx_tpu.solvers.chebyshev import chebyshev1_solve as jcheb1
    from pmg_dolfinx_tpu_torch.ops.kron import KronLaplacian
    from pmg_dolfinx_tpu_torch.solvers.chebyshev import chebyshev1_solve

    jop = JKron(JBoxMesh((3, 3, 3)), 3, kappa=KAPPA, dtype=jnp.float64)
    top = KronLaplacian(BoxMesh((3, 3, 3)), 3, kappa=KAPPA,
                        dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(11)
    b, x0 = rng.standard_normal((2, top.ndofs))
    xj = jcheb1(jop, jnp.asarray(b), jnp.asarray(x0), jop.diag_inv,
                (0.2, 2.2), 5)
    xt = chebyshev1_solve(top, torch.from_numpy(b), torch.from_numpy(x0),
                          top.diag_inv, (0.2, 2.2), 5)
    assert _reln(xt.numpy(), xj) <= 1e-10


def test_interpolate_exact_matches_jax():
    jp = JProblem(nc=(2, 3, 2), degrees=(1, 2), dtype=jnp.float64)
    tp = TProblem(nc=(2, 3, 2), degrees=(1, 2), device="cpu")
    assert np.array_equal(tp.interpolate_exact(), jp.interpolate_exact())


@pytest.mark.parametrize("fuse", [False, True])
def test_solve_refined_box_matches_jax(fuse):
    kw = dict(degrees=(1, 3), kappa=KAPPA, coarse="fdm",
              operator="kron_blocked", fuse_smoother=fuse)
    jh = JHierarchy(JBoxMesh((6, 6, 6)), dtype=jnp.float32, **kw)
    th = PMGHierarchy(BoxMesh((6, 6, 6)), dtype=torch.float32, device="cpu",
                      **kw)
    b = j_assemble_rhs(jh.mesh, 3, f_rhs(KAPPA))
    uj, rj = jh.solve_refined(b, num_cycles=20)
    ut, rt = th.solve_refined(torch.from_numpy(b), num_cycles=20)
    r0 = np.linalg.norm(b)
    assert ut.dtype == torch.float64 and len(rt) == 20
    assert rt[-1] / r0 < 1e-9, np.array(rt) / r0
    assert rj[-1] / r0 < 1e-9
    assert _reln(ut.numpy(), uj) <= 1e-8


def test_solve_refined_curved_matches_jax():
    jh = JHierarchy(JPerturbedBoxMesh((5, 5, 5)), degrees=(1, 3),
                    kappa=KAPPA, coarse="cg", operator="lattice",
                    dtype=jnp.float32)
    th = PMGHierarchy(PerturbedBoxMesh((5, 5, 5)), degrees=(1, 3),
                      kappa=KAPPA, coarse="cg", operator="lattice",
                      dtype=torch.float32, device="cpu")
    b = j_assemble_rhs(jh.mesh, 3, f_rhs(KAPPA))
    uj, rj = jh.solve_refined(b, num_cycles=30)
    ut, rt = th.solve_refined(torch.from_numpy(b), num_cycles=30)
    r0 = np.linalg.norm(b)
    assert rt[-1] / r0 < 1e-6, np.array(rt) / r0
    assert all(b_ < a_ for a_, b_ in zip(rt, rt[1:]))
    assert rj[-1] / r0 < 1e-6
    assert _reln(ut.numpy(), uj) <= 1e-5


def _last_json(script, *args):
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), *args],
        capture_output=True, text=True, timeout=300, check=True,
        env=dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu"),
    ).stdout
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("flags", [
    ("--gamma", "2", "--smoother-iters", "3", "--fmg"),
    ("--refined", "--fmg", "--coarse", "fdm"),
    ("--fdm", "--refined"),
])
def test_driver_flags_match_jax_driver(flags):
    common = ("--ndofs", "3000", "--degrees", "1", "3", "--dtype", "f64",
              "--cycles", "6", *flags)
    got = _last_json("pmg_torch.py", "--device", "cpu", *common)
    want = _last_json("pmg.py", "--cpu", *common)
    assert set(got) == {"rel_residual", "l2_error"}
    assert abs(got["l2_error"] - want["l2_error"]) <= 1e-10 * want["l2_error"]
    if want["rel_residual"] is None:
        assert got["rel_residual"] is None
    elif want["rel_residual"] < 1e-12:  # both at f64 rounding
        assert got["rel_residual"] < 1e-12
    else:
        assert abs(got["rel_residual"] - want["rel_residual"]) <= \
            1e-8 * want["rel_residual"]
