"""`solvers.shardwrap` on the three hierarchy classes, the advection terms
on the stacked layouts, and the slab drivers against their JAX twins.

- `is_sharded` and `shards_of` agree with the JAX package's on the same
  single-device, slab and grid hierarchies; `layout_converters` round
  trip each class's working layout; `axis_exchanges` reconciles exactly
  what the class's own exchange does (the slab's single x exchange, the
  grid's per sharded axis).
- `ops.kron.kron_advection_terms` on the slab stack and on the grid stack
  (LOCAL advection matrices, duplicated-layout masses, the exchanges of
  `axis_exchanges`) equals the single-device terms on the global lattice
  (f64, 1e-13).
- `examples/vector_update_torch.py` prints `examples/vector_update.py`'s
  first and last dot (and a deterministic dot); `examples/convdiff_torch.py
  --shards` (slab and grid) prints `examples/convdiff.py --shards`'s
  BiCGStab count.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pmg_dolfinx_tpu.fem.mesh import BoxMesh as JBox  # noqa: E402
from pmg_dolfinx_tpu.solvers import shardwrap as jsw  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh as TBox  # noqa: E402
from pmg_dolfinx_tpu_torch.ops import kron as tk  # noqa: E402
from pmg_dolfinx_tpu_torch.parallel.dist import DistPMG  # noqa: E402
from pmg_dolfinx_tpu_torch.parallel.grid2d import GridPMG  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers import shardwrap as tsw  # noqa: E402
from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
NC = (4, 4, 4)
KW = dict(degrees=(1, 2), operator="kron", coarse="fdm")


def _port(kind, operator="kron"):
    kw = dict(KW, operator=operator)
    if kind == "single":
        return PMGHierarchy(TBox(NC), device="cpu", **kw)
    if kind == "slab":
        return DistPMG(TBox(NC), n_devices=2, device="cpu", **kw)
    return GridPMG(TBox(NC), shards=(2, 1, 2), device="cpu", **kw)


def _jax(kind):
    if kind == "single":
        from pmg_dolfinx_tpu.solvers.pmg import PMGHierarchy as J

        return J(JBox(NC), **KW)
    if kind == "slab":
        from pmg_dolfinx_tpu.parallel.dist import DistPMG as J

        return J(JBox(NC), n_devices=2, **KW)
    from pmg_dolfinx_tpu.parallel.grid2d import GridPMG as J

    return J(JBox(NC), shards=(2, 1, 2), **KW)


@pytest.mark.parametrize("kind", ["single", "slab", "grid"])
def test_is_sharded_and_shards_of_match_jax(kind):
    t, j = _port(kind), _jax(kind)
    assert tsw.is_sharded(t) == jsw.is_sharded(j)
    assert tsw.shards_of(t) == jsw.shards_of(j)
    assert [e is None for e in tsw.axis_exchanges(t)] == \
        [e is None for e in jsw.axis_exchanges(j)]


@pytest.mark.parametrize("kind,operator", [("single", "kron"),
                                           ("slab", "kron"),
                                           ("slab", "dofmap"),
                                           ("grid", "kron")])
def test_layout_converters_round_trip(kind, operator):
    h = _port(kind, operator)
    to_w, from_w = tsw.layout_converters(h)
    v = torch.arange(TBox(NC).num_dofs(2), dtype=torch.float64)
    w = to_w(v.numpy())
    if kind == "slab":
        S = h.n_shards
        assert tuple(w.shape) == (((S,) + tuple(h.levels[-1].shape))
                                  if operator == "kron"
                                  else (S * h.levels[-1].ndofs,))
    assert torch.equal(from_w(w), v)


@pytest.mark.parametrize("kind", ["slab", "grid"])
def test_axis_exchanges_match_the_class_exchange(kind):
    h = _port(kind)
    shape = ((h.n_shards,) if kind == "slab" else h.shards) + tuple(
        h.levels[-1].shape)
    lat = torch.tensor(np.random.default_rng(1).standard_normal(shape))
    out = lat
    for ex in tsw.axis_exchanges(h):
        if ex is not None:
            out = ex(out)
    assert torch.equal(out, h.ops["exchange"](lat))
    assert not torch.equal(out, lat)


@pytest.mark.parametrize("kind", ["slab", "grid"])
def test_advection_terms_on_stacked_layouts_match_global(kind):
    """Each shard's LOCAL advection contraction plus the per-axis
    exchanges equals the global terms, on the class's own masses."""
    single, h = _port("single"), _port(kind)
    P, cvel = 2, (3.0, -1.5, 0.8)
    mesh = TBox(NC)
    x = np.random.default_rng(2).standard_normal(mesh.num_dofs(P))
    x[mesh.boundary_dof_marker(P)] = 0.0
    lv = single.data["levels"][-1]
    glob = tk.kron_advection_terms(
        torch.tensor(x).reshape(mesh.lattice_shape(P)),
        tuple(torch.tensor(tk.axis_advection(mesh.nc[a], P))
              for a in range(3)), (lv["mx"], lv["my"], lv["mz"]), cvel)
    shards = tsw.shards_of(h)
    lv = h.data["levels"][-1]
    got = tk.kron_advection_terms(
        h.to_dist(x),
        tuple(torch.tensor(tk.axis_advection(mesh.nc[a] // shards[a], P))
              for a in range(3)), (lv["mx"], lv["my"], lv["mz"]), cvel,
        exchanges=tsw.axis_exchanges(h))
    d = h.from_dist(got) - glob.reshape(-1)
    assert float(d.abs().max() / glob.abs().max()) <= 1e-13


def _run(script, *args, torch_side=True):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    extra = ("--device", "cpu") if torch_side else ("--cpu",)
    return subprocess.run([sys.executable, str(ROOT / "examples" / script),
                           *args, *extra], capture_output=True, text=True,
                          env=env, timeout=600, check=True,
                          cwd=ROOT / "examples").stdout


def test_vector_update_torch_matches_jax_driver():
    args = ["--ndofs", "3000", "--dtype", "f64", "--rounds", "20",
            "--devices", "4"]
    out_t = json.loads(_run("vector_update_torch.py", *args).strip()
                       .splitlines()[-1])
    assert out_t["deterministic"] is True and out_t["slabs"] == 4
    j = _run("vector_update.py", *args, torch_side=False)
    line = [ln for ln in j.splitlines() if ln.startswith("dot trajectory")][0]
    first = float(line.split("first=")[1].split()[0])
    last = float(line.split("last=")[1].split()[0])
    assert out_t["dot_first"] == pytest.approx(first, rel=1e-6)
    assert out_t["dot_last"] == pytest.approx(last, rel=1e-6)


def test_convdiff_torch_shards_matches_jax_driver():
    """``--shards 4`` (slab) and ``--shards 2,2,1`` (grid) print JAX's
    BiCGStab count of the sharded steady solve."""
    args = ["--ndofs", "3000", "--dtype", "f64"]
    j = _run("convdiff.py", *args, "--shards", "4", torch_side=False)
    line = [ln for ln in j.splitlines() if "BiCGStab iterations" in ln][0]
    n_j = int(line.split(":")[1].split()[0])
    for shards in ("4", "2,2,1"):
        out = json.loads(_run("convdiff_torch.py", *args, "--shards",
                              shards).strip().splitlines()[-1])
        assert out["niter"] == n_j and out["rel_resid"] < 1e-9
