"""Import hygiene and the kernel wrapper contract of the PyTorch port.

- `pmg_dolfinx_tpu_torch` and every submodule import without pulling in
  `jax` or the JAX package (checked in a fresh interpreter).
- On CPU tensors the blocked-apply wrappers run the plain torch versions;
  on any other non-CUDA device they raise instead of falling back.
- The kernel loader raises a clear error when there is no CUDA device or
  no ``nvcc``; it never hands back a stand-in.
"""

import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh  # noqa: E402
from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb  # noqa: E402
from pmg_dolfinx_tpu_torch.ops.kron import axis_stiffness_mass  # noqa: E402

_PROBE = """
import importlib, pkgutil, sys
import pmg_dolfinx_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "pmg_dolfinx_tpu.")))
bad += ["pmg_dolfinx_tpu"] if "pmg_dolfinx_tpu" in sys.modules else []
print(len(names), ",".join(bad))
"""


def test_port_imports_no_jax():
    root = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, check=True, timeout=300,
                         cwd=root).stdout.split()
    assert int(out[0]) >= 20, out  # every submodule was imported
    assert len(out) == 1, f"port pulled in JAX modules: {out[1]}"


def _mats(P=2, nc=(2, 3, 4)):
    mesh = BoxMesh(nc)
    Ks, ms = zip(*(axis_stiffness_mass(n, P, h)
                   for n, h in zip(mesh.nc, mesh.h_cells)))
    fm = kb.checked_face_masks(mesh, P, mesh.boundary_dof_marker(P))
    return mesh.lattice_shape(P), kb.symmetrized_mats(
        [2.0 * K for K in Ks], ms, fm, band=P, device="cpu")


def test_cpu_tensors_run_the_plain_version():
    shape, mats = _mats()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=g)
    b = torch.randn(shape, generator=g)
    before = dict(kb.LAUNCHES)
    assert torch.equal(kb.blocked_kron_apply(x, mats, sigma=0.5),
                       kb.plain_apply_m(x, mats, 0.5))
    assert torch.equal(kb.blocked_kron_residual(b, x, mats),
                       kb.plain_residual_m(b, x, mats))
    assert kb.LAUNCHES == before  # no kernel ran


def test_non_cuda_device_raises_instead_of_falling_back():
    shape, mats = _mats()
    x = torch.empty(shape, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        kb.blocked_kron_apply(x, mats)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kb.blocked_kron_residual(x, x, mats)


def test_loader_raises_without_cuda_or_nvcc(monkeypatch):
    monkeypatch.setattr(kb, "_lib", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="need a CUDA device"):
        kb.load_kernels()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(kb, "_find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kb.load_kernels()
    assert kb._lib is None
