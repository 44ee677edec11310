#!/usr/bin/env python3
"""Host microseconds per launch of the port's `kron_t1` (#4),
`transfer_yz` (#11), `packed_apply` (#18/#20) and `packed_fdm` (#19/#21)
wrappers, this checkout against another, in one process and in turns, on
one NVIDIA GPU.

    python3 tools/host_cost_torch.py OTHER_CHECKOUT [--rounds 10]

Imports this checkout's `pmg_dolfinx_tpu_torch` and the other's (under
an alias), each building its kernels from its own sources, and times
1000 enqueued launches of each wrapper at the fused V-cycle's largest
shapes (`kron_t1` on 253^3 at band 6, `transfer_yz` on 253^3 -> 127^3)
and the serving kernels at B=1 (`PackedKronSingle.apply_packed`,
`PackedFDMSingle.solve_packed` on 61^3, p=6), in turns this, other,
other, this, ``--rounds`` times. Each package gets
its own copies of the operands, since both cache on the tensors. Prints
the card, then the median and least per launch of each wrapper.
"""

import argparse
import importlib
import importlib.util
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def load(root, name):
    """The `pmg_dolfinx_tpu_torch` package under ``root``, as ``name``."""
    pkg = Path(root).resolve() / "pmg_dolfinx_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def per_launch_us(fn, calls=1000):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def launches(name, rng):
    """{wrapper: the call to time} for the package imported as ``name``."""
    ops = lambda m: importlib.import_module(f"{name}.ops.{m}")
    kb, tt = ops("kron_blocked"), ops("transfer")
    mesh = importlib.import_module(f"{name}.fem.mesh").BoxMesh((42,) * 3)
    kron = ops("kron")
    Ks, ms = zip(*(kron.axis_stiffness_mass(n, 6, h)
                   for n, h in zip(mesh.nc, mesh.h_cells)))
    mats = kb.symmetrized_mats([2.0 * K for K in Ks], ms, band=6,
                               device="cuda")
    shape = mesh.lattice_shape(6)
    x = torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                     device="cuda")
    bc = torch.tensor(rng.random(shape) < 0.01, device="cuda")
    y = torch.empty_like(x)
    I = torch.tensor(ops("lattice").axis_interpolation_matrix(42, 3, 6),
                     dtype=torch.float32, device="cuda")
    _, My, MzT = tt.transfer_mats((I, I, I), "restrict")
    t = torch.tensor(rng.standard_normal((127, 253, 253), dtype=np.float32),
                     device="cuda")
    kp = ops("kron_packed")
    serving = importlib.import_module(f"{name}.fem.mesh").BoxMesh((10,) * 3)
    op = kp.PackedKronSingle(serving, 6, device="cuda")
    fdm = kp.PackedFDMSingle(serving, 6, device="cuda")
    u = torch.tensor(rng.standard_normal(serving.lattice_shape(6),
                                         dtype=np.float32), device="cuda")
    calls = {"kron_t1": lambda: kb.kron_t1(x, bc, mats, out=y),
             "transfer_yz": lambda: tt.transfer_yz(t, My, MzT),
             "packed_apply": lambda: op.apply_packed(u),
             "packed_fdm": lambda: fdm.solve_packed(u)}
    for fn in calls.values():
        fn()
    return calls


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("host_cost_torch: needs an NVIDIA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    rng = np.random.default_rng(0)
    load(ROOT, "pkg_this")
    load(args.other, "pkg_other")
    sides = {"this": launches("pkg_this", rng),
             "other": launches("pkg_other", rng)}
    times = {(w, s): [] for w in sides["this"] for s in sides}
    for _ in range(args.rounds):
        for side in ("this", "other", "other", "this"):
            for wrapper, fn in sides[side].items():
                times[wrapper, side].append(per_launch_us(fn))
    for (wrapper, side), ts in sorted(times.items()):
        print(f"{wrapper} {side}: median {statistics.median(ts):.2f} us, "
              f"least {min(ts):.2f} us per launch over {len(ts)} x 1000")


if __name__ == "__main__":
    main()
