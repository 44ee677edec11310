"""The port's item-11 utilities against the JAX package's on the CPU:
checkpoint files that each package reads from the other (and the
fingerprint guard), `write_npz` / `write_vtk` output equal to JAX's,
`measure` on a scripted clock equal to JAX's, `reset_timings`, and the
rank-aware logging level (rank 0 at the requested level, other ranks at
WARNING)."""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pmg_dolfinx_tpu.fem.mesh import BoxMesh as JBox  # noqa: E402
from pmg_dolfinx_tpu.utils import checkpoint as jck  # noqa: E402
from pmg_dolfinx_tpu.utils import io as jio  # noqa: E402
from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh as TBox  # noqa: E402
from pmg_dolfinx_tpu_torch.utils import checkpoint as tck  # noqa: E402
from pmg_dolfinx_tpu_torch.utils import io as tio  # noqa: E402

NC, DEG, KAPPA = (3, 2, 4), (1, 3), 2.0


def _state(P=3):
    n = int(np.prod(TBox(NC).lattice_shape(P)))
    rng = np.random.default_rng(5)
    return rng.standard_normal(n), list(rng.uniform(1e-9, 1.0, 7)), 7


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax"),
                                           ("torch", "torch")])
def test_checkpoint_round_trip_across_packages(tmp_path, writer, reader):
    u, rn, cycle = _state()
    path = tmp_path / "state.npz"
    save = (jck.save_state, JBox) if writer == "jax" else (tck.save_state,
                                                           TBox)
    load = (jck.load_state, JBox) if reader == "jax" else (tck.load_state,
                                                           TBox)
    u_in = torch.as_tensor(u) if writer == "torch" else u
    save[0](path, save[1](NC), DEG, KAPPA, u_in, rn, cycle)
    u2, rn2, c2 = load[0](path, load[1](NC), DEG, KAPPA)
    np.testing.assert_array_equal(u2, u)
    assert rn2 == rn and c2 == cycle


def test_checkpoint_files_are_the_same(tmp_path):
    """Both packages write the same arrays under the same keys."""
    u, rn, cycle = _state()
    jck.save_state(tmp_path / "j.npz", JBox(NC), DEG, KAPPA, u, rn, cycle)
    tck.save_state(tmp_path / "t.npz", TBox(NC), DEG, KAPPA,
                   torch.as_tensor(u), rn, cycle)
    j, t = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(j.files) == sorted(t.files)
    for k in j.files:
        assert j[k].dtype == t[k].dtype
        np.testing.assert_array_equal(j[k], t[k])


@pytest.mark.parametrize("change", ["nc", "degrees", "kappa"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_fingerprint_mismatch_raises(tmp_path, change, writer):
    u, rn, cycle = _state()
    save = jck.save_state if writer == "jax" else tck.save_state
    save(tmp_path / "s.npz", (JBox if writer == "jax" else TBox)(NC), DEG,
         KAPPA, u, rn, cycle)
    nc = (3, 2, 2) if change == "nc" else NC
    deg = (1, 2) if change == "degrees" else DEG
    kap = 3.0 if change == "kappa" else KAPPA
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        tck.load_state(tmp_path / "s.npz", TBox(nc), deg, kap)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        jck.load_state(tmp_path / "s.npz", JBox(nc), deg, kap)


@pytest.mark.parametrize("P", [1, 3])
def test_write_vtk_equals_jax(tmp_path, P):
    u, _, _ = _state(P)
    jio.write_vtk(tmp_path / "j.vtk", JBox(NC), P, u, name="phi")
    tio.write_vtk(tmp_path / "t.vtk", TBox(NC), P, torch.as_tensor(u),
                  name="phi")
    assert (tmp_path / "t.vtk").read_bytes() == (tmp_path
                                                 / "j.vtk").read_bytes()


def test_write_vtk_refuses_a_wrong_length(tmp_path):
    with pytest.raises(ValueError, match="lattice"):
        tio.write_vtk(tmp_path / "t.vtk", TBox(NC), 1, np.zeros(3))


@pytest.mark.parametrize("P", [1, 3])
def test_write_npz_equals_jax(tmp_path, P):
    u, _, _ = _state(P)
    extra = dict(rnorms=np.arange(4.0))
    jio.write_npz(tmp_path / "j.npz", JBox(NC), P, u, **extra)
    tio.write_npz(tmp_path / "t.npz", TBox(NC), P, torch.as_tensor(u),
                  **extra)
    j, t = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(j.files) == sorted(t.files) == ["coords", "rnorms", "u"]
    for k in j.files:
        np.testing.assert_array_equal(j[k], t[k])


class _Clock:
    """A scripted clock: ``run(n)`` advances it by ``n * per + noise``
    (a fixed sequence), so both packages' `measure` see the same
    samples."""

    def __init__(self, per, noise):
        self.t, self.per, self.noise, self.i = 0.0, per, noise, 0

    def __call__(self):
        return self.t

    def run(self, n):
        self.t += n * self.per + self.noise[self.i % len(self.noise)]
        self.i += 1


@pytest.mark.parametrize("noise", [(0.0,), (1e-4, -3e-5, 2e-5, 5e-5)],
                         ids=["quiet", "jitter"])
def test_measure_equals_jax(monkeypatch, noise):
    import pmg_dolfinx_tpu.utils.measure as jm
    import pmg_dolfinx_tpu_torch.utils.measure as tm

    got = []
    for mod, attr in ((jm, "time"), (tm, "perf_counter")):
        clock = _Clock(1e-3, noise)
        monkeypatch.setattr(mod.time, attr, clock)
        got.append(mod.measure(clock.run, 2, 12))
        monkeypatch.undo()
    assert got[0] == got[1]
    assert got[1][0] == pytest.approx(1e-3, rel=0.05)


def test_measure_raises_without_signal(monkeypatch):
    """Slopes that are never positive carry no timing: RuntimeError after
    `MAX_SAMPLES`, as JAX's."""
    import pmg_dolfinx_tpu_torch.utils.measure as tm

    clock = _Clock(-1e-3, (0.0,))
    monkeypatch.setattr(tm.time, "perf_counter", clock)
    with pytest.raises(RuntimeError, match="positive slopes"):
        tm.measure(clock.run, 2, 12)


def test_reset_timings():
    from pmg_dolfinx_tpu_torch.utils import Timer, list_timings, reset_timings

    with Timer("test_torch_utils scope") as t:
        pass
    assert t.elapsed >= 0.0
    lines = []
    list_timings(lines.append)
    assert any("test_torch_utils scope" in ln for ln in lines)
    reset_timings()
    lines = []
    list_timings(lines.append)
    assert lines == ["no timings recorded"]


@pytest.mark.parametrize("rank,all_processes,level", [
    (0, False, logging.INFO), (1, False, logging.WARNING),
    (1, True, logging.INFO), (3, False, logging.WARNING)])
def test_logging_level_by_rank(monkeypatch, rank, all_processes, level):
    """Rank 0 logs at the requested level, the others at WARNING unless
    ``all_processes`` (the rank read through `multihost.process_index`);
    on one process JAX's `init_logging` sets the same level."""
    from pmg_dolfinx_tpu.utils.logging import init_logging as jinit
    from pmg_dolfinx_tpu_torch.parallel import multihost
    from pmg_dolfinx_tpu_torch.utils import get_logger, init_logging

    root = logging.getLogger()
    saved = (root.level, list(root.handlers))
    try:
        monkeypatch.setattr(multihost, "process_index", lambda: rank)
        init_logging(logging.INFO, all_processes=all_processes)
        assert root.level == level
        assert get_logger().name == "pmg_tpu"
        if rank == 0:
            jinit(logging.INFO, all_processes=all_processes)
            assert root.level == level
    finally:
        root.handlers[:] = saved[1]
        root.setLevel(saved[0])
