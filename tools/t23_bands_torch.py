#!/usr/bin/env python3
"""Device time of the full-bc kernel 2 (#5 apply, #6 residual) as the
y-march and as the staged tile at each band, in turns, on one NVIDIA GPU:
the measurement behind `ops.kron_blocked.t23_plan`.

    python3 tools/t23_bands_torch.py [--bands 1 3 6 10 11 12 13 14 15 16]

Builds a copy of `csrc/kron_blocked.cu` whose y-march takes every band
(`kT23MarchMaxBand` raised to `kMaxBand`; under `build/kernels/`, like
the package's own build) and calls its `kron_t23_launch` through ctypes
with the wrapper's operands, the march on and off. Each band runs on a
box of 118^3 to 129^3 dofs at degree P = band (phase 3's 43^3 at band
1), kappa=2, with the box faces plus ~1% of the interior dofs marked:
the march and the tile in turns (tile, march, march, tile), each the
median of a CUDA graph of 20 launches replayed 5 times, beside the plan's
choice and whether both forms give the same bits. Prints the card first.
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
# Cells per axis at each band: lattices of 118^3 to 129^3 dofs.
CELLS = {1: 42, 3: 42, 6: 21, 10: 12, 11: 11, 12: 10, 13: 9, 14: 9, 15: 8,
         16: 8}


def all_band_library(kb, cuda_build):
    """The kernels of `kron_blocked.cu` with the y-march at every band."""
    src = kb._SRC.read_text()
    old = f"constexpr int kT23MarchMaxBand = {kb.T23_MARCH_MAX_BAND};"
    if old not in src:
        raise RuntimeError(f"{kb._SRC} does not declare {old!r}")
    copy = cuda_build.BUILD_DIR / "kron_blocked_all_bands.cu"
    copy.parent.mkdir(parents=True, exist_ok=True)
    copy.write_text(src.replace(
        old, "constexpr int kT23MarchMaxBand = kMaxBand;"))
    lib, _ = cuda_build.build_and_load(copy, "kron_blocked_all_bands",
                                       cuda_build.find_nvcc)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.kron_t23_launch.argtypes = [vp] * 12 + [ci] * 4 + [cf, ci, vp]
    lib.kron_t23_launch.restype = ci
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bands", type=int, nargs="+",
                    default=[1, 3, 6, 10, 11, 12, 13, 14, 15, 16])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("t23_bands_torch: needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import graph_ms
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.ops import cuda_build
    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.ops.kron import axis_stiffness_mass

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    lib = all_band_library(kb, cuda_build)
    for P in args.bands:
        mesh = BoxMesh((CELLS[P],) * 3)
        shape = mesh.lattice_shape(P)
        Ks, ms = zip(*(axis_stiffness_mass(n, P, h)
                       for n, h in zip(mesh.nc, mesh.h_cells)))
        m = kb.symmetrized_mats([2.0 * K for K in Ks], ms, band=P,
                                device="cuda")
        rng = np.random.default_rng(P)
        bc = torch.tensor(mesh.boundary_dof_marker(P).reshape(shape)
                          | (rng.random(shape) < 0.01), device="cuda")
        x, r = (torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                             device="cuda") for _ in range(2))
        t1 = kb.plain_t1(x, bc, m)
        out = torch.empty_like(x)
        for form, r3 in (("apply", None), ("residual", r)):
            def call(march, r3=r3):
                rc = lib.kron_t23_launch(
                    *kb._t23_args(x, bc, t1, m), None, None, kb._opt(r3),
                    kb._ptr(out), *shape, P, 0.0, march,
                    cuda_build.stream_of(x))
                if rc != 0:
                    raise RuntimeError(f"kron_t23_launch: CUDA error {rc}")
                return out

            tile = call(0).clone()
            same = bool(torch.equal(call(1), tile))
            t1_, m1, m2, t2 = (graph_ms(lambda: call(0)),
                               graph_ms(lambda: call(1)),
                               graph_ms(lambda: call(1)),
                               graph_ms(lambda: call(0)))
            ms_t, ms_m = (t1_ + t2) / 2, (m1 + m2) / 2
            print(f"    {shape[0]}^3 band {P} {form}: march {ms_m:.4f} ms, "
                  f"tile {ms_t:.4f} ms ({ms_t / ms_m:.2f}x; turns "
                  f"{t1_:.4f}, {m1:.4f}, {m2:.4f}, {t2:.4f}); plan "
                  f"{kb.t23_plan(P)}; same bits {same}", flush=True)


if __name__ == "__main__":
    main()
