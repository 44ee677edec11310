"""The port's example programs accept the JAX twins' flags.

Each JAX example's flag below is given to the twin's parser (each
example's ``parse_args``), which must take it; the values the port does
not run raise ``SystemExit`` naming the reason (a dead knob, or the
ROADMAP item that will port it). The JAX examples' own parsers are read
from their sources, so a flag added there shows up here.
"""

import importlib.util
import pathlib
import re
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
    [v for v in _jax_choices("mat_free.py", "--precision") if v != "highest"])
def test_mat_free_precision_refused_citing_item_1(precision):
    with pytest.raises(SystemExit, match="item 1"):
        _example("mat_free_torch").parse_args(["--precision", precision])


def test_pmg_precision_accepted():
    mod = _example("pmg_torch")
    assert mod.parse_args(["--precision", "highest"]).precision == "highest"
    assert mod.parse_args([]).precision == "highest"


@pytest.mark.parametrize(
    "precision",
    [v for v in _jax_choices("pmg.py", "--precision") if v != "highest"])
def test_pmg_precision_refused_citing_item_1(precision):
    with pytest.raises(SystemExit, match="item 1"):
        _example("pmg_torch").parse_args(["--precision", precision])
