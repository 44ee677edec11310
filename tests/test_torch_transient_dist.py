"""The port's sharded time loops (`pmg_dolfinx_tpu_torch.parallel.
transient_dist`) against the JAX package's, float64 on the CPU.

Mirrors the JAX package's `tests/test_transient_dist.py` and the
sharded case of `tests/test_semilinear_transient.py`: the same mesh
(graded y, one Neumann face, non-unit extent), layouts (slab 4 and the
grids (2, 2, 1), (1, 2, 2), (2, 1, 2)), loads and source factors. Each
port evolver runs with ``device="cpu"`` on the JAX package's inputs and
must equal the JAX sharded evolver to 1e-10 relative in the 2-norm (the
leapfrog, whose forward apply is an eigen-transform, to 1e-9), and the
port's own single-device evolver to the same bound. JAX runs on the 8
virtual CPU devices of `tests/conftest.py`. The sharded drivers
(`heat_torch.py --shards 4`, `wave_torch.py --shards 2,2,1` Newmark and
leapfrog, `convdiff_torch.py --transient --shards 4`) print their JAX
twins' L2 errors (f64, ~3000 dofs, 1e-8 relative).
"""

import numpy as np
import pytest
import torch

from pmg_dolfinx_tpu.fem.mesh import BoxMesh as JBox
from pmg_dolfinx_tpu.fem.mesh import geometric_spacing as j_spacing
from pmg_dolfinx_tpu.parallel import transient_dist as jtd
from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh as TBox
from pmg_dolfinx_tpu_torch.fem.mesh import geometric_spacing as t_spacing
from pmg_dolfinx_tpu_torch.parallel import transient_dist as ttd
from pmg_dolfinx_tpu_torch.solvers import transient as tsingle

KAPPA, DT, NSTEPS = 1.3, 2e-3, 5
F64 = dict(dtype=torch.float64, device="cpu")


def _meshes():
    kw = dict(extent=(1.0, 1.2, 0.9),
              dirichlet_faces=((True, True), (True, False), (True, True)))
    return (JBox((4, 4, 4), spacing=(None, j_spacing(4, 2.0), None), **kw),
            TBox((4, 4, 4), spacing=(None, t_spacing(4, 2.0), None), **kw))


def _u0(mesh, P):
    c = mesh.dof_coords(P)
    return (np.sin(np.pi * c[:, 0]) * np.cos(0.5 * np.pi * c[:, 1])
            * np.sin(np.pi * c[:, 2] / 0.9))


def _load(mesh, P, seed):
    rng = np.random.default_rng(seed)
    return np.where(np.asarray(mesh.boundary_dof_marker(P)), 0.0,
                    rng.standard_normal(mesh.num_dofs(P)))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().reshape(-1)
    return np.asarray(a).reshape(-1)


def _close(got, ref, tol):
    got, ref = _np(got), _np(ref)
    assert np.linalg.norm(got - ref) < tol * np.linalg.norm(ref)


@pytest.mark.parametrize("shards", [4, (2, 2, 1), (1, 2, 2)])
@pytest.mark.parametrize("scheme", ["be", "cn"])
def test_heat_dist_matches_jax(shards, scheme):
    jm, tm = _meshes()
    P = 3
    u0, f = _u0(tm, P), _load(tm, P, 3)
    ref = jtd.heat_dist_evolve(jm, P, shards, kappa=KAPPA, dt=DT,
                               scheme=scheme, f=f)(u0, NSTEPS)
    got = ttd.heat_dist_evolve(tm, P, shards, kappa=KAPPA, dt=DT,
                               scheme=scheme, f=f, **F64)(u0, NSTEPS)
    assert tuple(got.shape) == (tm.num_dofs(P),)
    _close(got, ref, 1e-10)
    single = tsingle.heat_fdm_evolve(tm, P, kappa=KAPPA, dt=DT,
                                     scheme=scheme, f=f, **F64)(u0, NSTEPS)
    _close(got, single, 1e-10)


@pytest.mark.parametrize("shards", [4, (2, 1, 2)])
def test_wave_newmark_dist_matches_jax(shards):
    jm, tm = _meshes()
    P = 3
    u0, v0 = _u0(tm, P), 0.3 * _u0(tm, P)
    uj, vj = jtd.wave_newmark_dist_evolve(jm, P, shards, kappa=KAPPA,
                                          dt=DT)(u0, v0, NSTEPS)
    ut, vt = ttd.wave_newmark_dist_evolve(tm, P, shards, kappa=KAPPA,
                                          dt=DT, **F64)(u0, v0, NSTEPS)
    _close(ut, uj, 1e-10)
    _close(vt, vj, 1e-10)
    us, vs = tsingle.wave_newmark_evolve(tm, P, kappa=KAPPA, dt=DT,
                                         **F64)(u0, v0, NSTEPS)
    _close(ut, us, 1e-10)
    _close(vt, vs, 1e-10)


@pytest.mark.parametrize("shards", [4, (2, 2, 1)])
def test_wave_leapfrog_dist_matches_jax(shards):
    jm, tm = _meshes()
    P, dt = 3, 2e-4
    u0, v0, f = _u0(tm, P), 0.2 * _u0(tm, P), _load(tm, P, 9)
    g = lambda t: 1.0 + 0.4 * np.sin(30.0 * t)
    uj, vj = jtd.wave_leapfrog_dist_evolve(jm, P, shards, kappa=KAPPA, dt=dt,
                                           f=f, f_time=g)(u0, v0, 8)
    ut, vt = ttd.wave_leapfrog_dist_evolve(tm, P, shards, kappa=KAPPA, dt=dt,
                                           f=f, f_time=g, **F64)(u0, v0, 8)
    _close(ut, uj, 1e-9)
    _close(vt, vj, 1e-9)
    us, vs = tsingle.wave_leapfrog_evolve(tm, P, kappa=KAPPA, dt=dt, f=f,
                                          f_time=g, **F64)(u0, v0, 8)
    _close(ut, us, 1e-9)
    _close(vt, vs, 1e-9)


@pytest.mark.parametrize("shards", [4, (2, 2, 1)])
@pytest.mark.parametrize("scheme", ["be", "cnab"])
def test_convdiff_dist_matches_jax(shards, scheme):
    jm, tm = _meshes()
    P, cvel = 3, (1.1, -0.5, 0.3)
    u0, f = _u0(tm, P), _load(tm, P, 5)
    g = lambda t: 1.0 + 0.5 * np.sin(20.0 * t)
    kw = dict(kappa=KAPPA, dt=5e-4, scheme=scheme, sigma=1.5, f=f, f_time=g)
    ref = jtd.convdiff_dist_evolve(jm, P, shards, cvel, **kw)(u0, NSTEPS)
    got = ttd.convdiff_dist_evolve(tm, P, shards, cvel, **kw, **F64)(
        u0, NSTEPS)
    _close(got, ref, 1e-10)
    single = tsingle.convdiff_fdm_evolve(tm, P, cvel, **kw, **F64)(u0,
                                                                  NSTEPS)
    _close(got, single, 1e-10)


@pytest.mark.parametrize("shards", [4, (2, 2, 1)])
@pytest.mark.parametrize("scheme", ["be", "cnab"])
def test_semilinear_dist_matches_jax(shards, scheme):
    from pmg_dolfinx_tpu.models.semilinear import cubic as jcubic
    from pmg_dolfinx_tpu_torch.models.semilinear import cubic as tcubic

    P, sigma = 2, 0.7
    jm, tm = JBox((4, 4, 4)), TBox((4, 4, 4))
    bc = np.asarray(tm.boundary_dof_marker(P))
    c = tm.dof_coords(P)
    u0 = np.where(bc, 0.0, np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
                  * np.sin(np.pi * c[:, 2]))
    f = _load(tm, P, 2)
    g = lambda t: 1.0 + 0.3 * np.cos(15.0 * t)
    kw = dict(kappa=KAPPA, dt=DT, scheme=scheme, sigma=sigma, f=f, f_time=g)
    ref = jtd.semilinear_dist_evolve(jm, P, shards, jcubic(2.0), **kw)(
        u0, NSTEPS)
    got = ttd.semilinear_dist_evolve(tm, P, shards, tcubic(2.0), **kw,
                                     **F64)(u0, NSTEPS)
    _close(got, ref, 1e-10)
    single = tsingle.semilinear_fdm_evolve(tm, P, tcubic(2.0), **kw, **F64)(
        u0, NSTEPS)
    _close(got, single, 1e-10)


def test_fdm_apply_dist_matches_assembled():
    """The forward transform apply ``(M V) d (V^T M)`` equals the assembled
    shifted operator on a grid layout (mixed faces, per-axis kappa), as in
    the JAX package's test."""
    import scipy.sparse as sp

    from pmg_dolfinx_tpu_torch.fem.assembly import (assemble_stiffness,
                                                    lumped_mass_np)
    from pmg_dolfinx_tpu_torch.parallel.fdm_dist import (
        dist_layout, make_fdm_apply_dist)

    mesh = TBox((4, 4, 2), dirichlet_faces=((True, True), (True, False),
                                            (True, True)))
    P, kd, sigma = 2, (1.0, 2.0, 0.5), 3.0
    part, grid, axes_spec, lat_spec = dist_layout(mesh, (2, 2, 1))
    data, spec, apply_local = make_fdm_apply_dist(
        mesh, P, part, axes_spec, lat_spec, kd, torch.float64, sigma=sigma,
        device="cpu")
    assert spec["dinv"] == lat_spec and spec["Vx"] == ()
    x = np.random.default_rng(0).standard_normal(mesh.num_dofs(P))
    xd = grid.local_slices(torch.tensor(x).reshape(mesh.lattice_shape(P)),
                           part.local_shape(P))
    y = grid.all_gather(apply_local(data, xd)).reshape(-1).numpy()
    A = (assemble_stiffness(mesh, P, kappa=np.diag(kd), bc=True).tocsr()
         + sigma * sp.diags(lumped_mass_np(mesh, P, bc_zero=True)))
    bc = np.asarray(mesh.boundary_dof_marker(P))
    ref = np.where(bc, x, np.asarray(A @ np.where(bc, 0.0, x)))
    assert np.linalg.norm(y - ref) < 1e-11 * np.linalg.norm(ref)


def test_dist_evolvers_reject_bad_arguments():
    mesh = TBox((3, 3, 3))
    with pytest.raises(ValueError, match="scheme"):
        ttd.heat_dist_evolve(mesh, 2, 3, scheme="rk4", device="cpu")
    with pytest.raises(ValueError, match="scheme"):
        ttd.semilinear_dist_evolve(mesh, 2, 3, None, scheme="cn",
                                   device="cpu")
    with pytest.raises(ValueError, match="velocity"):
        ttd.convdiff_dist_evolve(mesh, 2, 3, (1.0, 0.0), device="cpu")
    with pytest.raises(ValueError, match="beta"):
        ttd.wave_newmark_dist_evolve(mesh, 2, 3, beta=0.0, device="cpu")
    ev = ttd.wave_leapfrog_dist_evolve(mesh, 2, 3, device="cpu")
    u0 = np.zeros(mesh.num_dofs(2))
    with pytest.raises(ValueError, match="nsteps"):
        ev(u0, u0, 0)
    # devices= names ranks since item 10 (d) ported them
    with pytest.raises(ValueError, match=r"devices=.*rank of each shard"):
        ttd.heat_dist_evolve(mesh, 2, 3, devices=["cpu"], device="cpu")


def _driver_line(script, *args, torch_side=True):
    """The last JSON line of ``examples/<script> args`` (the port's with
    ``--device cpu``, JAX's with ``--cpu``)."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(root),
               OMP_NUM_THREADS="1")
    extra = ("--device", "cpu") if torch_side else ("--cpu",)
    out = subprocess.run([sys.executable, str(root / "examples" / script),
                          *args, *extra], capture_output=True, text=True,
                         env=env, timeout=600, check=True,
                         cwd=root / "examples").stdout
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("script,args", [
    ("heat_torch.py", ("--shards", "4")),
    ("wave_torch.py", ("--shards", "2,2,1")),
    ("wave_torch.py", ("--shards", "2,2,1", "--scheme", "leapfrog")),
    ("convdiff_torch.py", ("--transient", "--shards", "4")),
])
def test_sharded_drivers_print_the_jax_twins_line(script, args):
    """Each driver's sharded time loop, f64 at ~3000 dofs, prints its JAX
    twin's last line (the L2 error to 1e-8 relative: the same trajectory;
    the throughput is this host's)."""
    common = ("--ndofs", "3000", "--dtype", "f64", "--steps", "10")
    got = _driver_line(script, *args, *common)
    want = _driver_line(script.replace("_torch", ""), *args, *common,
                        torch_side=False)
    assert set(got) == set(want)
    assert abs(got["l2_error"] / want["l2_error"] - 1) <= 1e-8
