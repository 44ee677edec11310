#!/usr/bin/env python3
"""Device time of the port's lattice kernels K-A (`lattice_apply`, also on
the z-grouped `Gz`) and K-B (`lattice_apply_geom`), this checkout against
another, in one process and in turns, on one NVIDIA GPU.

    python3 tools/lattice_bench_torch.py [OTHER_CHECKOUT] [--sweep]
    python3 tools/lattice_bench_torch.py --vcycle

Imports this checkout's `pmg_dolfinx_tpu_torch` and, when given, the
other's (under an alias), each building its kernels from its own sources.
On `PerturbedBoxMesh((42, 42, 42))` at the curved V-cycle's three levels
(p=6, 3, 1: 253^3, 127^3, 43^3 dofs) it makes seeded inputs on the card
(the geometry from the mesh's 37 coefficients per cell, `geom_to_G` on
the card, kappa 2), holds each package's kernels to this checkout's plain
versions (relative max-norm), and times each as device time
(`chip_smoke.graph_ms`: a CUDA graph of 20 launches replayed between CUDA
events) in turns this, other, other, this; then each kernel's split by
kernel name under `torch.profiler` (`chip_smoke.profile_busy` of 20
launches) and the host microseconds per launch (`chip_smoke.host_us`).
``--sweep`` also times this checkout's K-A and K-B on other boxes
``(Sx, By, Bz)`` than `lattice_plan` picks (`BOX` and `MARCH` patched;
a box over a kernel's thread cap is refused at launch and skipped).
``--vcycle`` instead times this checkout's curved V-cycle, phase 7 of
`chip_smoke.py` (16.2M dofs, p=(1,3,6), `lattice_blocked` + `cg`), as
device busy time under the profiler (`chip_smoke.profile_complete`),
first thing in a fresh process, where the profiler keeps every kernel;
to compare two checkouts, run it from each in turn. Prints the card
first.
"""

import argparse
import importlib
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (  # noqa: E402
    graph_ms,
    host_us,
    lattice_kernel_ms,
    profile_busy,
    profile_complete,
)
from host_cost_torch import load  # noqa: E402

LEVELS = ((6, True), (3, False), (1, False))   # (P, with K-B and Gz)
SWEEP = {6: ((6, 1, 3), (14, 1, 3), (3, 1, 3), (6, 1, 5), (6, 2, 3),
             (14, 1, 7)),
         3: ((6, 2, 7), (7, 2, 7), (6, 2, 6), (7, 3, 5), (14, 2, 7)),
         1: ((6, 3, 14), (6, 4, 14), (6, 3, 21), (3, 4, 14), (6, 7, 7))}
SPLIT = 20


def split_ms(fn):
    """{kernel name: device ms per call} of ``SPLIT`` calls of ``fn``
    under the profiler."""
    _, _, _, by_name = profile_busy(lambda: [fn() for _ in range(SPLIT)])
    return {k: v / SPLIT for k, v in by_name.items()}


def on_box(lb, P, box):
    """Make ``lb``'s `lattice_plan` pick ``box`` at degree ``P``."""
    lb.BOX = {**lb.BOX, P: tuple(box[1:])}
    lb.MARCH = box[0]
    lb._RECORDS.clear()


def operands(lb, mesh, P, zgrp):
    """Seeded operands at degree P on the card (this checkout's setup)."""
    nc = mesh.nc
    kc = np.full(mesh.ncells, 2.0)
    co = torch.tensor(lb.lattice_geom_coefficients(mesh, P, kc),
                      dtype=torch.float32, device="cuda")
    G = lb.geom_to_G(co, nc, P)
    ops = dict(co=co, Gt=torch.movedim(G, -1, 0).contiguous(),
               bc=torch.tensor(mesh.boundary_dof_marker(P), device="cuda"),
               mats=lb.lattice_blocked_mats(nc, P, device="cuda"))
    _, ops["xi"], ops["wx"] = lb.lattice_geom_data(nc, P, device="cpu")
    if zgrp:
        ops["zb"] = lb.select_zgroup(nc[2], P)
        ops["Gz"] = torch.tensor(lb.geometry_to_zgrouped(
            G.cpu().numpy(), ops["zb"], P), device="cuda")
    del G
    rng = np.random.default_rng(1000 + P)
    ops["x"] = torch.tensor(rng.standard_normal(mesh.num_dofs(P),
                                                dtype=np.float32),
                            device="cuda")
    return ops


def vcycle(pkg):
    """Busy ms of one curved V-cycle of the package ``pkg`` from a
    complete profiler window, K-A's share by kernel and the wall ms."""
    mod = lambda m: importlib.import_module(f"{pkg}.{m}")
    lb = mod("ops.lattice_blocked")
    t0 = time.perf_counter()
    prob = mod("models.poisson").PoissonProblem(
        mesh=mod("fem.mesh").PerturbedBoxMesh((42, 42, 42)),
        operator="lattice_blocked", degrees=(1, 3, 6), kappa=2.0,
        dtype=torch.float32, coarse="cg", device="cuda")
    print(f"setup {time.perf_counter() - t0:.1f} s")
    hier, b1 = prob.hierarchy, torch.ones_like(prob.b)
    cycle = lambda: hier.apply(b1, torch.zeros_like(b1))
    cycle()
    for _ in range(2):
        wall, busy, nk, by_name, n, tries, complete = profile_complete(cycle,
                                                                       lb)
        ka = lattice_kernel_ms(by_name)
        print(f"V-cycle ({'complete' if complete else 'INCOMPLETE'} window,"
              f" {tries} tried): wall {wall:.3f} ms, busy {busy:.3f} ms "
              f"({nk} kernels), K-A {ka['march'] + ka['fold']:.3f} ms "
              f"(march/cells {ka['march']:.3f}, faces/fold "
              f"{ka['fold']:.3f}); by kernel (launches, ms): "
              + "; ".join(f"{k[:48]}: {n[k]}, {ms:.3f}" for k, ms in
                          sorted(by_name.items()) if "lattice_" in k))


def calls(pkg, o, nc, P, zgrp):
    """{kernel: the call to time} for the package ``pkg``'s wrappers."""
    lb = importlib.import_module(f"{pkg}.ops.lattice_blocked")
    out = {"lattice_apply": lambda: lb.lattice_apply(
        o["x"], o["bc"], o["Gt"], o["mats"]["D1"], nc, P)}
    if zgrp:
        out["lattice_apply_geom"] = lambda: lb.lattice_apply_geom(
            o["x"], o["bc"], o["co"], o["mats"]["D1"], nc, P, o["xi"],
            o["wx"])
        out["lattice_apply_zgrp"] = lambda: lb.lattice_apply_zgrp(
            o["x"], o["bc"], o["Gz"], o["mats"]["D1"], nc, P, o["zb"])
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?", help="root of the other checkout")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--vcycle", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lattice_bench_torch: needs an NVIDIA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    if args.vcycle:
        load(ROOT, "pkg_this")
        vcycle("pkg_this")
        return
    sides = {"this": load(ROOT, "pkg_this")}
    if args.other:
        sides["other"] = load(args.other, "pkg_other")
    lb = importlib.import_module("pkg_this.ops.lattice_blocked")
    for side in sides:
        m = importlib.import_module(f"pkg_{side}.ops.lattice_blocked")
        t0 = time.perf_counter()
        m.load_kernels()
        print(f"{side}: build {time.perf_counter() - t0:.1f} s")
        for line in m.BUILD_LOG.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("    " + line.strip())
    mesh = importlib.import_module("pkg_this.fem.mesh").PerturbedBoxMesh(
        (42, 42, 42))
    nc = mesh.nc
    for P, full in LEVELS:
        o = operands(lb, mesh, P, full)
        plain = {"lattice_apply": lb.plain_lattice_apply(
            o["x"], o["mats"], o["Gt"], o["bc"])}
        if full:
            plain["lattice_apply_geom"] = lb.plain_lattice_apply_geom(
                o["x"], o["mats"], o["co"], o["bc"], nc, P)
            plain["lattice_apply_zgrp"] = plain["lattice_apply"]
        fns = {s: calls(f"pkg_{s}", o, nc, P, full) for s in sides}
        print(f"\nnc=42 p={P} ({o['x'].numel()} dofs); this plan "
              f"{lb.lattice_plan(nc, P)}")
        for name in fns["this"]:
            res = {s: [] for s in sides}
            for side in ("this", "other", "other", "this"):
                if side not in sides:
                    continue
                fn = fns[side][name]
                y = fn()
                torch.cuda.synchronize()
                ref = plain[name]
                err = float((y - ref).abs().max() / ref.abs().max())
                res[side].append((graph_ms(fn), err))
            for side, runs in res.items():
                sp = split_ms(fns[side][name])
                print(f"  {name} {side}: device ms "
                      f"{[round(r[0], 4) for r in runs]}, rel err "
                      f"{max(r[1] for r in runs):.2e}, host us "
                      f"{host_us(fns[side][name], calls=200):.1f}; split "
                      + ", ".join(f"{k[:40]} {v:.4f}" for k, v in sp.items()))
        if args.sweep:
            saved = lb.BOX, lb.MARCH
            for box in SWEEP[P]:
                on_box(lb, P, box)
                plan = lb.lattice_plan(nc, P)
                for name, fn in calls("pkg_this", o, nc, P, full).items():
                    if name == "lattice_apply_zgrp":
                        continue
                    try:
                        y = fn()
                    except RuntimeError as e:
                        print(f"  sweep {name} box {plan}: {e}")
                        continue
                    err = float((y - plain[name]).abs().max()
                                / plain[name].abs().max())
                    print(f"  sweep {name} box {plan}: {graph_ms(fn):.4f} "
                          f"ms, {lb.blocks_per_sm(name, P, plan)} "
                          f"blocks/SM, rel err {err:.2e}")
            lb.BOX, lb.MARCH = saved
            lb._RECORDS.clear()
        del o, plain, fns
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
