"""The port's example programs accept the JAX twins' flags.

Each JAX example's flag below is given to the twin's parser (each
example's ``parse_args``), which must take it; the values the port does
not run raise ``SystemExit`` naming the reason (a dead knob, or the
ROADMAP item that will port it); ``--precision high`` runs in both
drivers (`pmg_torch.py` held to JAX's `pmg.py` on the CPU). The JAX
examples' own parsers are read from their sources, so a flag added there
shows up here.
"""

import importlib.util
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
sys.path.insert(0, str(EXAMPLES))


def _example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_choices(path, flag):
    """The ``choices`` list of ``flag`` in a JAX example's source."""
    src = (EXAMPLES / path).read_text()
    m = re.search(r'add_argument\(\s*"' + re.escape(flag)
                  + r'"[^)]*?choices=\[([^\]]*)\]', src, re.S)
    assert m, f"{flag} not found in {path}"
    return re.findall(r'"([^"]+)"', m.group(1))


_OPERATORS = _jax_choices("_common.py", "--operator")


@pytest.mark.parametrize("name", ["heat_torch", "wave_torch", "amg_torch"])
@pytest.mark.parametrize("operator", _OPERATORS)
def test_operator_flag_accepted_and_unread(name, operator):
    args = _example(name).parse_args(["--operator", operator,
                                     "--device", "cpu"])
    assert args.operator == operator


@pytest.mark.parametrize("name", ["heat_torch", "wave_torch", "amg_torch"])
def test_operator_default_is_jax_default(name):
    assert _example(name).parse_args([]).operator == "kron"


def test_mat_free_bcells_and_precision_defaults():
    mod = _example("mat_free_torch")
    args = mod.parse_args(["--bcells", "1", "--precision", "highest"])
    assert (args.bcells, args.precision) == (1, "highest")
    args = mod.parse_args([])
    assert (args.bcells, args.precision) == (1, "highest")


@pytest.mark.parametrize("bcells", ["2", "4"])
def test_mat_free_bcells_refused_as_dead_knob(bcells):
    with pytest.raises(SystemExit, match="dead knob"):
        _example("mat_free_torch").parse_args(["--bcells", bcells])


@pytest.mark.parametrize(
    "precision",
    [v for v in _jax_choices("mat_free.py", "--precision")
     if v not in ("highest", "high")])
def test_mat_free_precision_refused_citing_item_1(precision):
    with pytest.raises(SystemExit, match="item 1"):
        _example("mat_free_torch").parse_args(["--precision", precision])


@pytest.mark.parametrize("operator", ["kron_blocked", "lattice_blocked",
                                      "kron"])
def test_mat_free_precision_high_runs(operator, capsys):
    """``--precision high`` runs the operator at 'high' (the bf16x3
    kernels' plain versions on the CPU, the einsum operator exactly) and
    stays within the 'high' contract of the assembled matrix."""
    _example("mat_free_torch").main(
        ["--device", "cpu", "--ndofs", "2000", "--degree", "3", "--operator",
         operator, "--precision", "high", "--reps", "1", "--mat_comp"]
        + (["--mesh", "perturbed"] if operator == "lattice_blocked" else []))
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mat_comp"] < 1e-4


def test_pmg_precision_accepted():
    mod = _example("pmg_torch")
    assert mod.parse_args(["--precision", "highest"]).precision == "highest"
    assert mod.parse_args([]).precision == "highest"
    assert mod.parse_args(["--precision", "high"]).precision == "high"


def _driver(script, *args):
    """(FCG count, last JSON line) of an example run in a subprocess."""
    out = subprocess.run(
        [sys.executable, str(EXAMPLES / script), *args], capture_output=True,
        text=True, timeout=300, check=True,
        env=dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu"),
    ).stdout
    n = int(re.search(r"converged in (\d+) iterations", out).group(1))
    return n, json.loads(out.strip().splitlines()[-1])


def test_pmg_precision_high_matches_jax_driver():
    """``--precision high --pcg`` on the flagship's flags at 3000 dofs:
    the port's driver (bf16x3 kernels' plain versions) against JAX's
    ``examples/pmg.py --cpu`` (exact f32 on the CPU): FCG(V) to 1e-8
    within 2 and the L2 error within 1e-5 (the solution of the 'high'
    operator, ~1e-5 from the exact one's), below the flagship's 1e-4."""
    common = ("--ndofs", "3000", "--degrees", "1", "3", "--coarse", "fdm",
              "--operator", "kron_blocked", "--precision", "high", "--pcg",
              "--cycles", "30")
    n_t, got = _driver("pmg_torch.py", "--device", "cpu", *common)
    n_j, want = _driver("pmg.py", "--cpu", *common)
    assert abs(n_t - n_j) <= 2
    assert abs(got["l2_error"] - want["l2_error"]) <= 1e-5
    assert got["l2_error"] < 1e-4
