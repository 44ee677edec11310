"""The port's convection-diffusion family (`ops.kron` advection half,
`solvers.bicgstab`, `solvers.convdiff`) against the JAX package, float64
on the CPU.

- `axis_advection` equals JAX's to 1e-14 (uniform and any ``nc, P``) and
  keeps the integration-by-parts identity ``C + C^T = e_N e_N^T - e_0
  e_0^T``; `kron_advection_terms` and `kron_convdiff_apply` (graded
  spacing, sigma) equal JAX's to 1e-13.
- `bicgstab_solve` on a seeded nonsymmetric system with a Jacobi
  preconditioner: the same iteration count and ``x`` to 1e-10.
- `convdiff_solve` (kron + fdm, cell Pe below 1): equal BiCGStab counts,
  ``u`` to 1e-10, ``rel_resid`` to 1e-6 relative. The `sd_stabilized_kappa`
  case at cell Pe ~ 20: kappa and tau equal JAX's; both solves within
  1e-7 of JAX's spsolve oracle and 1e-8 of each other, the counts within
  5% (rounding is amplified there; see the test). A non-kron hierarchy
  and a non-3-vector velocity raise.
- `kron_advection_terms` applies JAX's per-axis ``exchanges`` hooks as
  JAX does. The sharded JAX case ``test_convdiff_sharded_matches_oracle``
  (slab and grid) is ported in `tests/test_torch_dist_solvers.py`; the
  driver's ``--transient --shards`` (transient_dist) still refuses.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from pmg_dolfinx_tpu.fem.mesh import BoxMesh as JBox  # noqa: E402
from pmg_dolfinx_tpu.ops import kron as jk  # noqa: E402
from pmg_dolfinx_tpu.solvers import convdiff as jcd  # noqa: E402
from pmg_dolfinx_tpu.solvers.bicgstab import bicgstab_solve as jbicg  # noqa: E402
from pmg_dolfinx_tpu.solvers.pmg import PMGHierarchy as JHier  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh, geometric_spacing  # noqa: E402
from pmg_dolfinx_tpu_torch.ops import kron as tk  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers import convdiff as tcd  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers.bicgstab import bicgstab_solve  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy  # noqa: E402

KAPPA = 2.0
CVEL = (3.0, -1.5, 0.8)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("nc,P", [(4, 3), (3, 6), (5, 1)])
def test_axis_advection_matches_jax_and_skew_identity(nc, P):
    C = tk.axis_advection(nc, P)
    assert np.max(np.abs(C - jk.axis_advection(nc, P))) <= 1e-14
    E = np.zeros_like(C)
    E[0, 0], E[-1, -1] = -1.0, 1.0
    assert np.max(np.abs(C + C.T - E)) <= 1e-13


def _operands(mesh, P):
    Ks, ms = zip(*(tk.axis_stiffness_mass(mesh.nc[a], P, mesh.h_cells[a])
                   for a in range(3)))
    Ks = tuple(KAPPA * K for K in Ks)
    Cs = tuple(tk.axis_advection(mesh.nc[a], P) for a in range(3))
    return Ks, ms, Cs


@pytest.mark.parametrize("graded", [False, True])
def test_convdiff_apply_matches_jax(graded):
    P, sigma = 3, 0.6
    spacing = (None, geometric_spacing(4, 3.0), None) if graded else None
    mesh = BoxMesh((3, 4, 5), extent=(1.0, 2.0, 0.7), spacing=spacing)
    Ks, ms, Cs = _operands(mesh, P)
    bc = np.asarray(mesh.boundary_dof_marker(P))
    x = np.random.default_rng(0).standard_normal(mesh.num_dofs(P))
    T = lambda seq: tuple(torch.tensor(a) for a in seq)
    J = lambda seq: tuple(jnp.asarray(a) for a in seq)
    yt = tk.kron_convdiff_apply(torch.tensor(x), T(Ks), T(Cs), T(ms),
                                torch.tensor(CVEL, dtype=torch.float64),
                                torch.tensor(bc),
                                sigma=sigma)
    yj = jk.kron_convdiff_apply(jnp.asarray(x), J(Ks), J(Cs), J(ms),
                                jnp.asarray(CVEL), jnp.asarray(bc),
                                sigma=sigma)
    assert tuple(yt.shape) == x.shape and _rel(yt, yj) <= 1e-13
    lat = mesh.lattice_shape(P)
    w = np.where(bc, 0.0, x).reshape(lat)
    at = tk.kron_advection_terms(torch.tensor(w), T(Cs), T(ms), CVEL)
    aj = jk.kron_advection_terms(jnp.asarray(w), J(Cs), J(ms),
                                 jnp.asarray(CVEL))
    assert _rel(at, aj) <= 1e-13
    # the per-axis exchange hooks apply to each axis' term, as in JAX
    ex = (lambda t: 2.0 * t, None, lambda t: -t)
    at = tk.kron_advection_terms(torch.tensor(w), T(Cs), T(ms), CVEL,
                                 exchanges=ex)
    aj = jk.kron_advection_terms(jnp.asarray(w), J(Cs), J(ms),
                                 jnp.asarray(CVEL), exchanges=ex)
    assert _rel(at, aj) <= 1e-13


def test_bicgstab_matches_jax():
    n = 60
    rng = np.random.default_rng(1)
    A = np.diag(np.linspace(2.0, 6.0, n)) + 0.3 * rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    dinv = 1.0 / np.diag(A)
    xt, it = bicgstab_solve(lambda v: torch.tensor(A) @ v, torch.tensor(b),
                            torch.zeros(n, dtype=torch.float64),
                            lambda r: torch.tensor(dinv) * r, rtol=1e-12)
    xj, ij = jbicg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                   jnp.zeros(n), lambda r: jnp.asarray(dinv) * r,
                   rtol=1e-12)
    assert it["niter"] == int(ij["niter"]) > 5
    assert _rel(xt, xj) <= 1e-10
    assert _rel(xt, np.linalg.solve(A, b)) <= 1e-10
    # a zero rhs stops at entry, as JAX's while_loop does
    _, i0 = bicgstab_solve(lambda v: v, torch.zeros(n, dtype=torch.float64),
                           torch.zeros(n, dtype=torch.float64), lambda r: r)
    assert i0["niter"] == 0


def _f_convdiff(kappa, cvel, sigma=0.0):
    pi = np.pi

    def f(x):
        sx, sy, sz = (np.sin(pi * x[a]) for a in range(3))
        cx, cy, cz = (np.cos(pi * x[a]) for a in range(3))
        g = (pi * cx * sy * sz, pi * sx * cy * sz, pi * sx * sy * cz)
        return ((3.0 * pi**2 * kappa + sigma) * sx * sy * sz
                + sum(c_ * g_ for c_, g_ in zip(cvel, g)))

    return f


@pytest.mark.parametrize("nc,sigma", [((4, 3, 4), 0.5), ((3, 4, 3), 0.0)])
def test_convdiff_solve_matches_jax(nc, sigma):
    """Cell Pe below 1, JAX's intended regime: the same BiCGStab count."""
    P = 3
    b = assemble_rhs(BoxMesh(nc), P, _f_convdiff(KAPPA, CVEL, sigma))
    kw = dict(degrees=(1, 3), kappa=KAPPA, coarse="fdm", operator="kron",
              sigma=sigma)
    ut, it = tcd.convdiff_solve(PMGHierarchy(BoxMesh(nc), device="cpu", **kw),
                                b, CVEL, rtol=1e-9)
    uj, ij = jcd.convdiff_solve(JHier(JBox(nc), **kw), b, CVEL, rtol=1e-9)
    assert it["niter"] == ij["niter"] and it["rel_resid"] < 1e-9
    assert abs(it["rel_resid"] / ij["rel_resid"] - 1) <= 1e-6
    assert tuple(ut.shape) == b.shape and _rel(ut, uj) <= 1e-10


def _assembled_convdiff(mesh, P, kappa, cvel):
    """JAX's scipy oracle: the assembled stiffness (bc identity rows) plus
    the separable advection with bc rows and columns masked."""
    import scipy.sparse as sp

    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_stiffness

    A = assemble_stiffness(mesh, P, kappa=kappa, bc=True).tocsr()
    Cs = [sp.csr_matrix(tk.axis_advection(mesh.nc[a], P)) for a in range(3)]
    ms = [sp.diags(tk.axis_stiffness_mass(mesh.nc[a], P, mesh.h_cells[a])[1])
          for a in range(3)]
    adv = (cvel[0] * sp.kron(Cs[0], sp.kron(ms[1], ms[2]))
           + cvel[1] * sp.kron(ms[0], sp.kron(Cs[1], ms[2]))
           + cvel[2] * sp.kron(ms[0], sp.kron(ms[1], Cs[2])))
    z = sp.diags((~np.asarray(mesh.boundary_dof_marker(P))).astype(float))
    return (A + z @ adv @ z).tocsc()


@pytest.mark.parametrize("h_eff", ["p", "cell"])
def test_sd_stabilized_pe20_matches_jax(h_eff):
    """Cell Pe ~ 20 (the JAX README's stabilized case): the stabilized
    kappa and tau equal JAX's bit for bit and both packages solve the
    stabilized system (JAX's spsolve oracle to 1e-7, each other to 1e-8).
    Their BiCGStab counts may differ by a few: at this Peclet number every
    iteration amplifies the last-bit differences of the torch and XLA
    contractions (on 5^3 cells, 'p' scale: 79 against 78), so the counts
    are held within 5% (at least 2)."""
    import scipy.sparse.linalg as spla

    nc, P, kappa, cvel = (5, 5, 5), 3, 0.004, (1.0, 0.4, 0.2)
    assert 1.0 / nc[0] / (2.0 * kappa) > 15
    keff, taus = tcd.sd_stabilized_kappa(BoxMesh(nc), P, cvel, kappa,
                                         h_eff=h_eff)
    assert (keff, taus) == jcd.sd_stabilized_kappa(JBox(nc), P, cvel, kappa,
                                                   h_eff=h_eff)
    b = assemble_rhs(BoxMesh(nc), P, _f_convdiff(kappa, cvel))
    kw = dict(degrees=(1, 3), kappa=keff, coarse="fdm", operator="kron")
    ut, it = tcd.convdiff_solve(PMGHierarchy(BoxMesh(nc), device="cpu", **kw),
                                b, cvel, rtol=1e-9)
    uj, ij = jcd.convdiff_solve(JHier(JBox(nc), **kw), b, cvel, rtol=1e-9)
    assert it["rel_resid"] < 1e-9 and ij["rel_resid"] < 1e-9
    assert abs(it["niter"] - ij["niter"]) <= max(2, 0.05 * ij["niter"])
    u_ref = spla.spsolve(_assembled_convdiff(BoxMesh(nc), P, np.diag(keff),
                                             cvel), b)
    assert _rel(ut, u_ref) <= 1e-7 and _rel(ut, uj) <= 1e-8


def test_convdiff_refusals():
    hier = PMGHierarchy(BoxMesh((2, 2, 2)), degrees=(1, 2), operator="dofmap",
                        device="cpu")
    b = np.zeros(BoxMesh((2, 2, 2)).num_dofs(2))
    with pytest.raises(ValueError, match="operator='kron'"):
        tcd.convdiff_solve(hier, b, CVEL)
    hk = PMGHierarchy(BoxMesh((2, 2, 2)), degrees=(1, 2), operator="kron",
                      device="cpu")
    with pytest.raises(ValueError, match="3-vector"):
        tcd.convdiff_solve(hk, b, (1.0, 2.0))
    with pytest.raises(ValueError, match="3-vector"):
        tcd.sd_stabilized_kappa(BoxMesh((2, 2, 2)), 2, (1.0,), 1.0)


def _driver(*args):
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, str(root / "examples" / "convdiff_torch.py"),
         "--device", "cpu", "--ndofs", "3000", *args],
        capture_output=True, text=True, timeout=600, cwd=root, env=env)


def test_convdiff_driver_f64_matches_jax_solve():
    import json

    from pmg_dolfinx_tpu.fem.assembly import l2_error
    from pmg_dolfinx_tpu.models.poisson import fit_box_cells, u_exact

    proc = _driver("--dtype", "f64")
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    nc = fit_box_cells(3000, 3)
    b = assemble_rhs(BoxMesh(nc), 3, _f_convdiff(KAPPA, CVEL))
    uj, ij = jcd.convdiff_solve(JHier(JBox(nc), degrees=(1, 3), kappa=KAPPA,
                                      coarse="fdm", operator="kron"),
                                b, CVEL, rtol=1e-9)
    assert out["niter"] == ij["niter"]
    want = l2_error(JBox(nc), 3, np.asarray(uj), u_exact)
    assert abs(out["l2_error"] / want - 1) <= 1e-8


@pytest.mark.parametrize("args,item", [
    (("--transient", "--steps", "100"), None),
    (("--peclet-sweep", "--dtype", "f64", "--stabilize", "cell"), None),
    # This id held ``--transient --shards`` until ROADMAP item 10 (a)
    # ported the sharded IMEX loop (tests/test_torch_transient_dist.py);
    # it keeps its id on a --shards layout the JAX driver refuses.
    pytest.param(("--transient", "--shards", "2,2"), "--shards expects",
                 id="args2-Queue 1 item 10"),
])
def test_convdiff_driver_modes(args, item):
    import json

    proc = _driver(*args)
    if item is not None:
        assert proc.returncode != 0 and item in proc.stderr
        return
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    if "sweep" in out:
        assert len(out["sweep"]) == 4
        assert all(r["rel_resid"] < 1e-9 for r in out["sweep"])
    else:
        assert np.isfinite(out["l2_error"]) and out["l2_error"] < 0.05
