"""Import hygiene and the kernel wrapper contract of the PyTorch port.

- `pmg_dolfinx_tpu_torch` and every submodule import without pulling in
  `jax` or the JAX package (checked in a fresh interpreter), the
  general-hex, device-grid and model-family modules by name too; the
  port's drivers (`examples/*_torch.py`, the modes, nonlinear and
  convdiff ones among them) and `chip_smoke.py` import neither.
- On CPU tensors the kernel wrappers (blocked Kronecker, lattice with
  the z-grouped variant, the serving apply and solve of
  `ops.kron_packed`, the fused p-transfers of `ops.transfer` and the
  whole-lattice apply of `ops.kron_fused`, the device-grid kernel 2 of
  `ops.kron_blocked`) run the plain torch versions;
  on any other non-CUDA device they raise instead of falling back.
- The kernel loaders raise a clear error when there is no CUDA device or
  no ``nvcc``; they never hand back a stand-in.
"""

import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh, PerturbedBoxMesh  # noqa: E402
from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb  # noqa: E402
from pmg_dolfinx_tpu_torch.ops import kron_fused as kf  # noqa: E402
from pmg_dolfinx_tpu_torch.ops import kron_packed as kp  # noqa: E402
from pmg_dolfinx_tpu_torch.ops import lattice_blocked as lb  # noqa: E402
from pmg_dolfinx_tpu_torch.ops import transfer as tt  # noqa: E402
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


_NEW_MODULES = ("fem.mesh", "fem.assembly", "ops.cuda_build", "ops.laplacian",
                "ops.interpolate", "ops.lattice", "ops.lattice_blocked",
                "ops.kron_packed", "ops.transfer", "ops.kron_fused",
                "solvers.pmg", "solvers.cg", "solvers.fdm",
                "solvers.transient", "utils.convert", "ops.blas", "ops.kron",
                "parallel.partition", "parallel.dist", "parallel.grid2d",
                "solvers.line", "solvers.schwarz", "solvers.hmg",
                "fem.unstructured", "ops.unstructured", "ops.csr",
                "solvers.amg", "solvers.schwarz_dss", "models.semilinear",
                "solvers.bicgstab", "solvers.shardwrap", "solvers.newton",
                "solvers.convdiff", "solvers.lobpcg", "solvers.eig",
                "parallel.dist", "parallel.partition", "solvers.shardwrap",
                "utils.convert", "parallel.fdm_dist",
                "parallel.transient_dist", "parallel.dss_dist", "parallel",
                "parallel.multihost", "utils.logging", "utils.checkpoint",
                "utils.io", "utils.measure", "utils.timers", "utils")


def test_general_hex_modules_import_no_jax():
    probe = ("import importlib, sys\n"
             f"for m in {_NEW_MODULES!r}:\n"
             "    importlib.import_module('pmg_dolfinx_tpu_torch.' + m)\n"
             "print(sorted(m for m in sys.modules if m == 'jax' or "
             "m.startswith(('jax.', 'pmg_dolfinx_tpu.'))))\n")
    root = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, check=True, timeout=300,
                         cwd=root).stdout.strip()
    assert out == "[]", out


def test_drivers_and_smoke_import_no_jax():
    """No import statement of a port driver or of `chip_smoke.py` names
    `jax` or the JAX package."""
    import ast

    root = pathlib.Path(__file__).resolve().parent.parent
    files = sorted(root.glob("examples/*_torch.py")) + [root / "chip_smoke.py"]
    names = {f.name for f in files}
    assert {"modes_torch.py", "nonlinear_torch.py", "convdiff_torch.py",
            "scaling_torch.py", "vector_update_torch.py"} <= names
    assert len(files) >= 10
    for f in files:
        names = []
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.append(node.module)
        bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib",
                                                       "pmg_dolfinx_tpu")]
        assert not bad, (f.name, bad)


_SEPARABLE = ("sxzm", "s23m", "mx2", "myb", "mzrow")


def _mats(P=2, nc=(2, 3, 4)):
    mesh = BoxMesh(nc)
    Ks, ms = zip(*(axis_stiffness_mass(n, P, h)
                   for n, h in zip(mesh.nc, mesh.h_cells)))
    fm = kb.checked_face_masks(mesh, P, mesh.boundary_dof_marker(P))
    return mesh.lattice_shape(P), kb.symmetrized_mats(
        [2.0 * K for K in Ks], ms, face_masks=fm, band=P, device="cpu")


def test_cpu_tensors_run_the_plain_version():
    shape, mats = _mats()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=g)
    b = torch.randn(shape, generator=g)
    before = dict(kb.LAUNCHES)
    bc = torch.tensor(BoxMesh((2, 3, 4)).boundary_dof_marker(2)).reshape(shape)
    assert torch.equal(kb.blocked_kron_apply(x, bc, mats, sigma=0.5),
                       kb.plain_apply_m(x, mats, 0.5))
    assert torch.equal(kb.blocked_kron_residual(b, x, bc, mats),
                       kb.plain_residual_m(b, x, mats))
    full = {k: v for k, v in mats.items() if k not in _SEPARABLE}
    assert torch.equal(kb.blocked_kron_apply(x, bc, full, sigma=0.5),
                       kb.plain_apply(x, bc, full, 0.5))
    assert torch.equal(kb.blocked_kron_residual(b, x, bc, full),
                       kb.plain_residual(b, x, bc, full))
    assert torch.equal(
        kb.blocked_kron_cheb4(b, x, bc, full, torch.ones(shape), 4.0, 2),
        kb.blocked_kron_cheb4(b, x, bc, full, torch.ones(shape),
                              torch.tensor(4.0), 2))
    assert kb.LAUNCHES == before  # no kernel ran


def test_non_cuda_device_raises_instead_of_falling_back():
    shape, mats = _mats()
    x = torch.empty(shape, device="meta")
    bc = torch.empty(shape, dtype=torch.bool, device="meta")
    full = {k: v for k, v in mats.items() if k not in _SEPARABLE}
    for m in (mats, full):
        with pytest.raises(ValueError, match="CUDA tensors"):
            kb.blocked_kron_apply(x, bc, m)
        with pytest.raises(ValueError, match="CUDA tensors"):
            kb.blocked_kron_residual(x, x, bc, m)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kb.blocked_kron_cheb4(x, x, bc, full, x, 4.0, 2)


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


def _lattice_operands(P=2, nc=(2, 3, 2)):
    mesh = PerturbedBoxMesh(nc)
    op = lb.PallasLatticeBlocked(mesh, P, device="cpu")
    opg = lb.PallasLatticeBlocked(mesh, P, variant="geom", device="cpu")
    x = torch.randn(op.ndofs, generator=torch.Generator().manual_seed(0))
    return mesh, op, opg, x


def test_lattice_cpu_tensors_run_the_plain_version():
    mesh, op, opg, x = _lattice_operands()
    before = dict(lb.LAUNCHES)
    assert torch.equal(op(x), lb.plain_lattice_apply(x, op.mats, op.Gt,
                                                     op.bc_marker))
    assert torch.equal(opg(x), lb.plain_lattice_apply_geom(
        x, opg.mats, opg.co, opg.bc_marker, mesh.nc, 2))
    assert lb.LAUNCHES == before  # no kernel ran


def test_lattice_non_cuda_device_raises_instead_of_falling_back():
    mesh, op, opg, x = _lattice_operands()
    xm = torch.empty(x.shape, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        lb.blocked_lattice_apply(xm, op.mats, op.Gt, op.bc_marker, mesh.nc, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        lb.blocked_lattice_apply_geom(xm, opg.mats, opg.co, opg.geom,
                                      opg.bc_marker, mesh.nc, 2, xi=opg._xi,
                                      wx=opg._wx)


def test_lattice_loader_raises_without_cuda_or_nvcc(monkeypatch):
    monkeypatch.setattr(lb, "_lib", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="need a CUDA device"):
        lb.load_kernels()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(lb, "_find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        lb.load_kernels()
    assert lb._lib is None


def _packed_operands():
    mesh = BoxMesh((2, 3, 2))
    op = kp.PackedKronBatch(mesh, 2, B=2, sigma=0.5, device="cpu")
    fdm = kp.PackedFDMBatch(mesh, 2, B=2, device="cpu")
    x = torch.randn((2,) + mesh.lattice_shape(2),
                    generator=torch.Generator().manual_seed(0))
    return op, fdm, x


def test_packed_cpu_tensors_run_the_plain_version():
    op, fdm, x = _packed_operands()
    before = dict(kp.LAUNCHES)
    assert torch.equal(op.apply_packed(x),
                       kp.plain_packed_apply(x, op.mats, 0.5))
    assert torch.equal(fdm.solve_packed(x), kp.plain_packed_fdm(x, fdm.mats))
    assert kp.LAUNCHES == before  # no kernel ran


def test_packed_non_cuda_device_raises_instead_of_falling_back():
    op, fdm, x = _packed_operands()
    xm = torch.empty(x.shape, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        kp.packed_apply(xm, op.mats)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kp.packed_fdm(xm, fdm.mats)


def test_packed_loader_raises_without_cuda_or_nvcc(monkeypatch):
    monkeypatch.setattr(kp, "_lib", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="need a CUDA device"):
        kp.load_kernels()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(kp, "_find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kp.load_kernels()
    assert kp._lib is None


def _transfer_operands():
    from pmg_dolfinx_tpu_torch.ops.lattice import axis_interpolation_matrix

    I = torch.tensor(axis_interpolation_matrix(2, 1, 2), dtype=torch.float32)
    x = torch.randn((5, 5, 5), generator=torch.Generator().manual_seed(0))
    return tt.transfer_mats((I, I, I), "restrict"), x


def _kron_fused_operands():
    op = kf.PallasKronLaplacian(BoxMesh((2, 3, 2)), 2, device="cpu")
    x = torch.randn(op.shape, generator=torch.Generator().manual_seed(0))
    return op, x


def test_transfer_and_kron_fused_cpu_tensors_run_the_plain_version():
    mats, x = _transfer_operands()
    op, x3 = _kron_fused_operands()
    before = (dict(tt.LAUNCHES), dict(kf.LAUNCHES))
    assert torch.equal(tt.blocked_transfer(x, *mats),
                       tt.plain_transfer(x, *mats))
    assert torch.equal(op(x3).reshape(op.shape),
                       kf.plain_kron_fused(x3, op.bc3, op.Ks, op.planes))
    assert (dict(tt.LAUNCHES), dict(kf.LAUNCHES)) == before  # no kernel ran


def test_transfer_and_kron_fused_non_cuda_device_raises():
    mats, x = _transfer_operands()
    op, x3 = _kron_fused_operands()
    xm = torch.empty(x.shape, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tt.blocked_transfer(xm, *mats)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tt.transfer_yz(xm, mats[1], mats[2])
    with pytest.raises(ValueError, match="CUDA tensors"):
        kf.kron_fused_apply(torch.empty(x3.shape, device="meta"), op.bc3,
                            op.Ks, op.planes)


def test_zgrp_cpu_runs_plain_and_meta_raises():
    mesh = PerturbedBoxMesh((2, 3, 4))
    op = lb.PallasLatticeBlocked(mesh, 2, variant="zgrp", zb=2, device="cpu")
    x = torch.randn(op.ndofs, generator=torch.Generator().manual_seed(0))
    before = dict(lb.LAUNCHES)
    assert torch.equal(op(x), lb.plain_lattice_apply_zgrp(
        x, op.mats, op.Gz, op.bc_marker, mesh.nc, 2, 2))
    assert lb.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        lb.blocked_lattice_apply_zgrp(torch.empty(x.shape, device="meta"),
                                      op.mats, op.zmats, op.Gz, op.bc_marker,
                                      mesh.nc, 2, 2)


@pytest.mark.parametrize("mod", ["transfer", "kron_fused"])
def test_new_loaders_raise_without_cuda_or_nvcc(monkeypatch, mod):
    m = {"transfer": tt, "kron_fused": kf}[mod]
    monkeypatch.setattr(m, "_lib", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="need a CUDA device"):
        m.load_kernels()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(m, "_find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        m.load_kernels()
    assert m._lib is None


def test_grid_kernel_wrappers_cpu_plain_and_meta_raises():
    shape, mats = _mats()
    g = torch.Generator().manual_seed(1)
    x, t1, r = (torch.randn(shape, generator=g) for _ in range(3))
    cy = torch.randn((shape[0], 2, shape[2]), generator=g)
    cz = torch.randn((shape[0], shape[1], 2), generator=g)
    bc = torch.tensor(BoxMesh((2, 3, 4)).boundary_dof_marker(2)).reshape(shape)
    before = dict(kb.LAUNCHES)
    assert torch.equal(kb.kron_t23_grid_m(x, t1, mats, 0.5, cy, cz),
                       kb.plain_t23_grid_m(x, t1, mats, 0.5, cy, cz))
    assert torch.equal(kb.kron_t23_grid(x, bc, t1, mats, 0.5, cy, None, r3=r),
                       r - kb.plain_t23_grid(x, bc, t1, mats, 0.5, cy, None))
    assert kb.LAUNCHES == before  # no kernel ran
    xm = torch.empty(shape, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        kb.kron_t23_grid_m(xm, xm, mats, 0.0, None, None)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kb.kron_t23_grid(xm, torch.empty(shape, dtype=torch.bool,
                                         device="meta"), xm, mats)
