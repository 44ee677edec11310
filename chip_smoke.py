#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, builds the port's CUDA kernels from
its sources and drives the flagship solve through them. Every phase
raises on failure; nothing is caught.

1. Environment: the card (``nvidia-smi`` name and power limit), torch,
   CUDA and nvcc versions. Fails when ``torch.cuda.is_available()`` is
   False.
2. Build the kernels (``csrc/kron_blocked.cu``, nvcc, sm_90a).
3. Kernel parity: each kernel against its plain torch version at
   2,048,383 dofs (nc=21, p=6, 127^3) and 16,194,277 dofs (nc=42, p=6,
   253^3), seeded inputs, sigma in {0, 0.5}; relative max-norm error
   <= 1e-5 (float32, different summation order). Both timed with CUDA
   events.
4. Main path: ``PoissonProblem(nc=(42,42,42), degrees=(1,3,6), kappa=2,
   float32, coarse="fdm", operator="kron_blocked")`` — 10 stationary
   V-cycles (the residual falls on each of the first 4) and FCG(V) to
   rtol 1e-6 within 50 iterations; every kernel's launch count must rise
   during this phase. Also times the V-cycle of the plain torch
   ``operator="kron"`` hierarchy at the same size.
5. In-card reference: the same problem at nc=21 with ``operator="kron"``
   (plain torch) and ``"kron_blocked"``, the second run with the first
   one's calibrated smoother bounds: residual trajectories agree to
   1e-3 relative on every cycle above 5e-3 relative residual, FCG counts
   differ by at most 1, the two FCG solutions agree to 1e-3 relative.

Prints a ``{"kernels": [...]}`` JSON line and, only when every phase
passed, the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = ROOT / "pmg_dolfinx_tpu_torch"
SOURCE = "pmg_dolfinx_tpu_torch/csrc/kron_blocked.cu"
TPU_KERNELS = {
    "t1_m": "pmg_dolfinx_tpu/ops/pallas_kron_blocked.py:125",
    "t23_m": "pmg_dolfinx_tpu/ops/pallas_kron_blocked.py:149",
    "t23_res_m": "pmg_dolfinx_tpu/ops/pallas_kron_blocked.py:185",
}
KERNEL_RTOL = 1e-5
REF_TRAJ_FROM = 5e-3
SEED = 1234


def phase(name):
    print(f"\n=== {name}", flush=True)
    return time.perf_counter()


def done(t0):
    print(f"    phase seconds: {time.perf_counter() - t0:.2f}", flush=True)


def cuda_ms(fn, reps=20, warmup=3):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_max_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def kernel_parity(nc, P, kappa=2.0):
    """Phase 3 at one size: returns {kernel: (max_abs_err, ms, plain_ms)}
    measured at sigma=0 (the errors over both sigmas)."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.ops.kron import axis_stiffness_mass

    mesh = BoxMesh((nc, nc, nc))
    shape = mesh.lattice_shape(P)
    Ks, ms = [], []
    for nc_a, h_a in zip(mesh.nc, mesh.h_cells):
        K, m = axis_stiffness_mass(nc_a, P, h_a)
        Ks.append(torch.tensor(kappa * K, dtype=torch.float32))
        ms.append(torch.tensor(m, dtype=torch.float32))
    mats = kb.symmetrized_mats(
        Ks, ms, kb.checked_face_masks(mesh, P, mesh.boundary_dof_marker(P)),
        band=P, device="cuda")
    rng = np.random.default_rng(SEED + nc)
    x = torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                     device="cuda")
    r = torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                     device="cuda")
    out = {}
    for sigma in (0.0, 0.5):
        t1_ref = kb.plain_t1_m(x, mats)
        cases = {
            "t1_m": (lambda: kb.kron_t1_m(x, mats), t1_ref),
            "t23_m": (lambda: kb.kron_t23_m(x, t1_ref, mats, sigma),
                      kb.plain_t23_m(x, t1_ref, mats, sigma)),
            "t23_res_m": (lambda: kb.kron_t23_m(x, t1_ref, mats, sigma, r3=r),
                          r - kb.plain_t23_m(x, t1_ref, mats, sigma)),
        }
        for name, (launch, ref) in cases.items():
            got = launch()
            torch.cuda.synchronize()
            err = rel_max_err(got, ref)
            abs_err = float((got - ref).abs().max())
            print(f"    {shape} sigma={sigma} {name}: rel max err {err:.3e}")
            if not err <= KERNEL_RTOL:
                raise AssertionError(
                    f"{name} at {shape}, sigma={sigma}: relative max-norm "
                    f"error {err:.3e} > {KERNEL_RTOL}")
            prev = out.get(name, (0.0, None, None))
            out[name] = (max(prev[0], abs_err), prev[1], prev[2])
        # Whole entry points: apply = kernels 1+2, residual = kernels 1+3.
        for name, got, ref in (
                ("apply", kb.blocked_kron_apply(x, mats, sigma=sigma),
                 kb.plain_apply_m(x, mats, sigma)),
                ("residual", kb.blocked_kron_residual(r, x, mats, sigma=sigma),
                 kb.plain_residual_m(r, x, mats, sigma))):
            torch.cuda.synchronize()
            err = rel_max_err(got, ref)
            print(f"    {shape} sigma={sigma} {name}: rel max err {err:.3e}")
            if not err <= KERNEL_RTOL:
                raise AssertionError(f"{name} at {shape}: {err:.3e}")
    plain = {
        "t1_m": lambda: kb.plain_t1_m(x, mats),
        "t23_m": lambda: kb.plain_t23_m(x, t1_ref, mats),
        "t23_res_m": lambda: r - kb.plain_t23_m(x, t1_ref, mats),
    }
    kern = {
        "t1_m": lambda: kb.kron_t1_m(x, mats),
        "t23_m": lambda: kb.kron_t23_m(x, t1_ref, mats),
        "t23_res_m": lambda: kb.kron_t23_m(x, t1_ref, mats, r3=r),
    }
    for name in kern:
        # plain, kernel, kernel, plain: compare within one call only.
        p1 = cuda_ms(plain[name])
        k1 = cuda_ms(kern[name])
        k2 = cuda_ms(kern[name])
        p2 = cuda_ms(plain[name])
        ms_k, ms_p = (k1 + k2) / 2, (p1 + p2) / 2
        print(f"    {shape} {name}: kernel {ms_k:.4f} ms "
              f"({k1:.4f}, {k2:.4f}) vs plain {ms_p:.4f} ms "
              f"({p1:.4f}, {p2:.4f})")
        out[name] = (out[name][0], ms_k, ms_p)
    apply_k = cuda_ms(lambda: kb.blocked_kron_apply(x, mats))
    apply_p = cuda_ms(lambda: kb.plain_apply_m(x, mats))
    ndofs = x.numel()
    print(f"    {shape} apply: kernels {apply_k:.4f} ms "
          f"({ndofs / apply_k / 1e6:.3f} GDOF/s) vs plain {apply_p:.4f} ms "
          f"({ndofs / apply_p / 1e6:.3f} GDOF/s)")
    return out


def vcycle_ms(hier, cycles=10, reps=3):
    """ms per V-cycle on the fine rhs: CUDA events around ``cycles``
    back-to-back V-cycles, ``reps`` times; returns (median, all)."""
    import torch

    b = torch.ones(hier.levels[-1].ndofs, dtype=hier.dtype,
                   device=hier.device)
    u = torch.zeros_like(b)
    times = [cuda_ms(lambda: hier.apply(b, u), reps=cycles, warmup=2)
             for _ in range(reps)]
    return sorted(times)[len(times) // 2], times


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    if not PKG.is_dir():
        raise SystemExit(f"chip_smoke: {PKG} not found; run from the root "
                         "of a checkout")
    sys.path.insert(0, str(ROOT))

    t0 = phase("1. environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb

    nvcc = kb._find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    print(subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[-1])
    done(t0)

    t0 = phase("2. build kernels")
    kb.load_kernels()
    print(f"    build seconds: {time.perf_counter() - t0:.2f}")
    for line in kb.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            print("    " + line.strip())
    done(t0)

    t0 = phase("3. kernel parity vs plain torch")
    kernel_parity(21, 6)
    main_shape = kernel_parity(42, 6)
    done(t0)

    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import PoissonProblem
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    t0 = phase("4. main path: 16.2M dofs, p=(1,3,6), kron_blocked + fdm")
    cfg = dict(degrees=(1, 3, 6), kappa=2.0, dtype=torch.float32,
               coarse="fdm", device="cuda")
    for k in kb.LAUNCHES:
        kb.LAUNCHES[k] = 0
    ts = time.perf_counter()
    prob = PoissonProblem(nc=(42, 42, 42), operator="kron_blocked", **cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - ts
    hier = prob.hierarchy
    print(f"    setup seconds: {setup_s:.2f}  (eig max per level: "
          f"{[float(e[-1]) for e in hier.eigs]})")
    r0 = float(torch.linalg.vector_norm(prob.b))
    ts = time.perf_counter()
    u, rn = prob.solve(num_cycles=10)
    solve_s = time.perf_counter() - ts
    rel = [r / r0 for r in rn]
    for i, v in enumerate(rel):
        print(f"    cycle {i + 1:2d}: rel = {v:.4e}")
    print(f"    10 cycles: {solve_s:.3f} s (host clock)")
    hist = [1.0] + rel
    if not all(hist[i + 1] < hist[i] for i in range(4)):
        raise AssertionError(f"residual did not fall on cycles 1-4: {rel}")
    ts = time.perf_counter()
    u, niter = hier.solve_pcg(prob.b, rtol=1e-6, maxiter=50)
    torch.cuda.synchronize()
    pcg_s = time.perf_counter() - ts
    launches = dict(kb.LAUNCHES)
    print(f"    FCG(V) iterations to rtol 1e-6: {niter} ({pcg_s:.3f} s host "
          "clock)")
    if not niter < 50:
        raise AssertionError("FCG did not converge within 50 iterations")
    if tuple(u.shape) != (prob.mesh.num_dofs(6),) or not bool(
            torch.isfinite(u).all()):
        raise AssertionError("solution is not a finite vector of ndofs")
    print(f"    kernel launches on the main path: {launches}")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel was not launched: {launches}")
    vc_blk, vc_blk_all = vcycle_ms(hier)
    print(f"    V-cycle {vc_blk:.3f} ms (kron_blocked kernels; 10 "
          f"back-to-back, 3 reps {[round(t, 3) for t in vc_blk_all]})")
    ts = time.perf_counter()
    err = prob.error_l2(u)
    print(f"    L2 error vs manufactured solution: {err:.4e} "
          f"({time.perf_counter() - ts:.1f} s host)")
    if not err < 1e-4:
        raise AssertionError(f"L2 error {err} too large")
    del prob, u
    ts = time.perf_counter()
    plain_hier = PMGHierarchy(BoxMesh((42, 42, 42)), operator="kron", **cfg)
    torch.cuda.synchronize()
    print(f"    plain kron PMGHierarchy setup seconds (no rhs): "
          f"{time.perf_counter() - ts:.2f}")
    vc_plain, vc_plain_all = vcycle_ms(plain_hier)
    print(f"    V-cycle {vc_plain:.3f} ms (plain torch kron; 10 "
          f"back-to-back, 3 reps {[round(t, 3) for t in vc_plain_all]})")
    del plain_hier
    vc_blk2, _ = vcycle_ms(hier)
    print(f"    V-cycle again {vc_blk2:.3f} ms (kron_blocked)")
    del hier
    done(t0)

    t0 = phase("5. in-card reference: nc=21, kron (plain) vs kron_blocked")
    res = {}
    lmax = None
    for op in ("kron", "kron_blocked"):
        prob = PoissonProblem(nc=(21, 21, 21), operator=op, **cfg)
        levels = prob.hierarchy.data["levels"]
        print(f"    {op}: own calibration lmax "
              f"{[float(lv['lmax']) for lv in levels]}")
        if lmax is None:
            lmax = [lv["lmax"] for lv in levels]
        else:
            # Run both cycles with the same smoother bounds, so the
            # comparison sees the operators and not two f32 calibrations.
            prob.hierarchy.load_state(
                {"levels": [{"lmax": v} for v in lmax]})
        r0 = float(torch.linalg.vector_norm(prob.b))
        _, rn = prob.solve(num_cycles=10)
        u, niter = prob.hierarchy.solve_pcg(prob.b, rtol=1e-6, maxiter=50)
        res[op] = (np.array(rn) / r0, niter, u, prob.error_l2(u),
                   vcycle_ms(prob.hierarchy)[0])
        print(f"    {op}: rel {[f'{v:.3e}' for v in res[op][0]]}, FCG "
              f"{niter}, L2 {res[op][3]:.4e}, V-cycle {res[op][4]:.3f} ms")
    (rk, nk, uk, _, _), (rb, nb, ub, _, _) = res["kron"], res["kron_blocked"]
    # The f32 residual stalls near 2.4e-4 relative at this size; within
    # ~20x of that floor the two operators' roundings alone move the
    # residual by ~1e-3, so the trajectories are compared above 5e-3.
    keep = rk > REF_TRAJ_FROM
    traj = float(np.max(np.abs(rb[keep] - rk[keep]) / rk[keep]))
    print(f"    trajectory max rel diff (cycles above {REF_TRAJ_FROM:g}): "
          f"{traj:.3e}")
    if not traj <= 1e-3:
        raise AssertionError(f"trajectories differ: {traj}")
    if abs(nk - nb) > 1:
        raise AssertionError(f"FCG counts differ: {nk} vs {nb}")
    # The L2 error of an f32 solve at p=6 is the operator's f32 rounding
    # (the discretization error is ~1e-11), so compare the solutions.
    du = float(torch.linalg.vector_norm(ub - uk) / torch.linalg.vector_norm(uk))
    print(f"    FCG solutions: relative difference {du:.3e}")
    if not du <= 1e-3:
        raise AssertionError(f"FCG solutions differ: {du}")
    done(t0)

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": TPU_KERNELS[name], "launches": launches[name],
         "max_abs_err": main_shape[name][0], "ms": main_shape[name][1],
         "plain_ms": main_shape[name][2]}
        for name in ("t1_m", "t23_m", "t23_res_m")
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
