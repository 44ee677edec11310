#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, builds the port's CUDA kernels from
its sources and drives the flagship solve and the curved-hex solve
through them. Every phase raises on failure; nothing is caught.

1. Environment: the card (``nvidia-smi`` name and power limit), torch,
   CUDA and nvcc versions. Fails when ``torch.cuda.is_available()`` is
   False.
2. Build the kernels (``csrc/kron_blocked.cu`` and
   ``csrc/lattice_blocked.cu``, one nvcc each, started together, sm_90a).
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
6. Lattice kernel parity: K-A (``lattice_apply``, launched under each
   variant name 'yexp', 'v1' and 'ym') at p=6 on nc=21 (2,048,383 dofs)
   and nc=42 (16,194,277 dofs), and at p=1 and p=3 on nc=42; K-B
   (``lattice_apply_geom``) at p=6 on nc=21 and nc=42. Seeded x, the
   geometry of the perturbed mesh, kappa=2; relative max-norm error
   <= 1e-5 against the plain torch versions; timed in turns plain,
   kernel, kernel, plain.
7. Curved main path: ``PoissonProblem(mesh=PerturbedBoxMesh((42,42,42)),
   degrees=(1,3,6), kappa=2, float32, coarse="cg",
   operator="lattice_blocked")`` — 10 stationary V-cycles (the residual
   falls on each of the first 4), FCG(V) to rtol 1e-6 within 50
   iterations, K-A's launch count rises, collocated L2 error < 1e-4;
   V-cycle timed against the plain torch ``operator="lattice"``
   hierarchy on the same mesh.
8. The operator micro-benchmark entry point
   (``examples/mat_free_torch.py --operator lattice_blocked --variant
   geom --mesh perturbed``) at 16.2M dofs, p=6: K-B's launch count rises.
9. Curved in-card reference: nc=21 with ``operator="lattice"`` (plain
   torch) and ``"lattice_blocked"`` under the rules of phase 5.

Prints a ``{"kernels": [...]}`` JSON line and, only when every phase
passed, the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import contextlib
import importlib.util
import io
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = ROOT / "pmg_dolfinx_tpu_torch"
SOURCES = {
    "t1_m": "pmg_dolfinx_tpu_torch/csrc/kron_blocked.cu",
    "t23_m": "pmg_dolfinx_tpu_torch/csrc/kron_blocked.cu",
    "t23_res_m": "pmg_dolfinx_tpu_torch/csrc/kron_blocked.cu",
    "lattice_apply": "pmg_dolfinx_tpu_torch/csrc/lattice_blocked.cu",
    "lattice_apply_geom": "pmg_dolfinx_tpu_torch/csrc/lattice_blocked.cu",
}
TPU_KERNELS = {
    "t1_m": "pmg_dolfinx_tpu/ops/pallas_kron_blocked.py:125",
    "t23_m": "pmg_dolfinx_tpu/ops/pallas_kron_blocked.py:149",
    "t23_res_m": "pmg_dolfinx_tpu/ops/pallas_kron_blocked.py:185",
    "lattice_apply": ("pmg_dolfinx_tpu/ops/pallas_lattice_blocked.py:117 "
                      "(_kernel_lattice_yx 'yexp'; also :69 _kernel_lattice "
                      "'v1' and :220 _kernel_lattice_ym 'ym')"),
    "lattice_apply_geom": "pmg_dolfinx_tpu/ops/pallas_lattice_blocked.py:411",
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


def peak_rss_gb():
    """Peak resident host memory of this process so far, GB."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024**2


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


def turns(plain, kern):
    """Times ``plain`` and ``kern`` in turns plain, kernel, kernel, plain;
    returns (kernel ms, plain ms, the four times)."""
    p1 = cuda_ms(plain, reps=5, warmup=1)
    k1 = cuda_ms(kern)
    k2 = cuda_ms(kern)
    p2 = cuda_ms(plain, reps=5, warmup=1)
    return (k1 + k2) / 2, (p1 + p2) / 2, (p1, k1, k2, p2)


def lattice_parity(mesh, P, geom):
    """Phase 6 at one size: K-A under each variant name (and K-B when
    ``geom``) against the plain versions; returns {kernel: (max_abs_err,
    ms, plain_ms)}."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import geometry_factors_np, scale_G
    from pmg_dolfinx_tpu_torch.ops import lattice_blocked as lb
    from pmg_dolfinx_tpu_torch.ops.lattice import geometry_to_qlattice

    nc = mesh.nc
    kc = np.full(mesh.ncells, 2.0)
    ts = time.perf_counter()
    G_cells, _ = geometry_factors_np(mesh, P)
    print(f"    nc={nc[0]} p={P}: host f64 geometry factors "
          f"{time.perf_counter() - ts:.1f} s; peak host RSS so far "
          f"{peak_rss_gb():.1f} GB")
    Gt = torch.tensor(lb.geometry_to_gfirst(geometry_to_qlattice(
        scale_G(G_cells, kc, None), nc, P)), dtype=torch.float32,
        device="cuda")
    mats = lb.lattice_blocked_mats(nc, P, device="cuda")
    bc = torch.tensor(mesh.boundary_dof_marker(P), device="cuda")
    rng = np.random.default_rng(SEED + 100 * P + nc[0])
    x = torch.tensor(rng.standard_normal(mesh.num_dofs(P), dtype=np.float32),
                     device="cuda")
    tag = f"nc={nc[0]} p={P} ({x.numel()} dofs)"
    out = {}
    ref = lb.plain_lattice_apply(x, mats, Gt, bc)
    abs_err = 0.0
    for variant in ("yexp", "v1", "ym"):
        got = lb.blocked_lattice_apply(x, mats, Gt, bc, nc, P,
                                       variant=variant)
        torch.cuda.synchronize()
        err = rel_max_err(got, ref)
        abs_err = max(abs_err, float((got - ref).abs().max()))
        print(f"    {tag} lattice_apply variant={variant}: rel max err "
              f"{err:.3e}")
        if not err <= KERNEL_RTOL:
            raise AssertionError(f"lattice_apply ({variant}) at {tag}: "
                                 f"{err:.3e} > {KERNEL_RTOL}")
    ms_k, ms_p, four = turns(lambda: lb.plain_lattice_apply(x, mats, Gt, bc),
                             lambda: lb.blocked_lattice_apply(
                                 x, mats, Gt, bc, nc, P))
    print(f"    {tag} lattice_apply: kernel {ms_k:.4f} ms vs plain "
          f"{ms_p:.4f} ms (turns {[round(t, 4) for t in four]}); "
          f"{x.numel() / ms_k / 1e6:.3f} GDOF/s")
    out["lattice_apply"] = (abs_err, ms_k, ms_p)
    del Gt, ref
    if geom:
        co = torch.tensor(lb.lattice_geom_coefficients(mesh, P, kc),
                          dtype=torch.float32, device="cuda")
        _, xi, wx = lb.lattice_geom_data(nc, P, device="cuda")
        ref = lb.plain_lattice_apply_geom(x, mats, co, bc, nc, P)
        got = lb.blocked_lattice_apply_geom(x, mats, co, bc, nc, P, xi=xi,
                                            wx=wx)
        torch.cuda.synchronize()
        err = rel_max_err(got, ref)
        print(f"    {tag} lattice_apply_geom: rel max err {err:.3e}")
        if not err <= KERNEL_RTOL:
            raise AssertionError(f"lattice_apply_geom at {tag}: {err:.3e}")
        abs_err = float((got - ref).abs().max())
        del ref, got
        ms_k, ms_p, four = turns(
            lambda: lb.plain_lattice_apply_geom(x, mats, co, bc, nc, P),
            lambda: lb.blocked_lattice_apply_geom(x, mats, co, bc, nc, P,
                                                  xi=xi, wx=wx))
        print(f"    {tag} lattice_apply_geom: kernel {ms_k:.4f} ms vs "
              f"plain {ms_p:.4f} ms (turns {[round(t, 4) for t in four]}); "
              f"{x.numel() / ms_k / 1e6:.3f} GDOF/s")
        out["lattice_apply_geom"] = (abs_err, ms_k, ms_p)
    return out


def f64_diagonal(mesh, P, kappa=2.0):
    """The operator diagonal in f64 on the host (sequential sums)."""
    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import geometry_factors_np
    from pmg_dolfinx_tpu_torch.fem.gll import derivative_matrix
    from pmg_dolfinx_tpu_torch.ops.laplacian import laplacian_diagonal

    G, _ = geometry_factors_np(mesh, P)
    return laplacian_diagonal(
        torch.tensor(mesh.dofmap(P), dtype=torch.int64), torch.tensor(G),
        torch.full((mesh.ncells,), kappa, dtype=torch.float64),
        torch.tensor(derivative_matrix(P)),
        torch.tensor(mesh.boundary_dof_marker(P)), mesh.num_dofs(P))


def run_mat_free(args):
    """Runs ``examples/mat_free_torch.py`` in this process (so its kernel
    launches count here) and returns its last JSON line."""
    spec = importlib.util.spec_from_file_location(
        "mat_free_torch", ROOT / "examples" / "mat_free_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argv, buf = sys.argv, io.StringIO()
    sys.argv = ["mat_free_torch.py", *args]
    try:
        with contextlib.redirect_stdout(buf):
            mod.main()
    finally:
        sys.argv = argv
    text = buf.getvalue()
    print("    " + text.strip().replace("\n", "\n    "))
    return json.loads(text.strip().splitlines()[-1])


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

    from pmg_dolfinx_tpu_torch.ops import lattice_blocked as lb

    t0 = phase("2. build kernels")
    with ThreadPoolExecutor(max_workers=2) as pool:
        for fut in [pool.submit(m.load_kernels) for m in (kb, lb)]:
            fut.result()
    print(f"    build seconds (both sources, in parallel): "
          f"{time.perf_counter() - t0:.2f}")
    for mod in (kb, lb):
        for line in mod.BUILD_LOG.splitlines():
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

    from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh

    t0 = phase("6. lattice kernel parity vs plain torch")
    curved = PerturbedBoxMesh((42, 42, 42))
    lattice_parity(PerturbedBoxMesh((21, 21, 21)), 6, geom=True)
    lattice_parity(curved, 1, geom=False)
    lattice_parity(curved, 3, geom=False)
    main_shape.update(lattice_parity(curved, 6, geom=True))
    done(t0)

    t0 = phase("7. curved main path: 16.2M dofs, p=(1,3,6), lattice_blocked "
               "+ cg")
    ccfg = dict(degrees=(1, 3, 6), kappa=2.0, dtype=torch.float32,
                coarse="cg", device="cuda")
    for k in lb.LAUNCHES:
        lb.LAUNCHES[k] = 0
    ts = time.perf_counter()
    prob = PoissonProblem(mesh=curved, operator="lattice_blocked", **ccfg)
    torch.cuda.synchronize()
    print(f"    setup seconds: {time.perf_counter() - ts:.2f}  (eig max per "
          f"level: {[float(e[-1]) for e in prob.hierarchy.eigs]})")
    hier = prob.hierarchy
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
    launches["lattice_apply"] = lb.LAUNCHES["lattice_apply"]
    print(f"    FCG(V) iterations to rtol 1e-6: {niter} ({pcg_s:.3f} s host "
          f"clock); kernel launches on the main path: {dict(lb.LAUNCHES)}")
    if not niter < 50:
        raise AssertionError("FCG did not converge within 50 iterations")
    if tuple(u.shape) != (curved.num_dofs(6),) or not bool(
            torch.isfinite(u).all()):
        raise AssertionError("solution is not a finite vector of ndofs")
    if not launches["lattice_apply"] > 0:
        raise AssertionError(f"K-A was not launched: {dict(lb.LAUNCHES)}")
    ts = time.perf_counter()
    err = prob.error_l2(u)
    print(f"    collocated L2 error vs manufactured solution: {err:.4e} "
          f"({time.perf_counter() - ts:.1f} s host)")
    if not err < 1e-4:
        raise AssertionError(f"L2 error {err} too large")
    vc_lb, vc_lb_all = vcycle_ms(hier)
    print(f"    V-cycle {vc_lb:.3f} ms (lattice_blocked kernels; 10 "
          f"back-to-back, 3 reps {[round(t, 3) for t in vc_lb_all]}); "
          f"peak host RSS so far {peak_rss_gb():.1f} GB, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 1024**3:.1f} GB")
    del prob, u, hier
    ts = time.perf_counter()
    plain_hier = PMGHierarchy(curved, operator="lattice", **ccfg)
    torch.cuda.synchronize()
    print(f"    plain lattice PMGHierarchy setup seconds (no rhs): "
          f"{time.perf_counter() - ts:.2f}")
    vc_plain, vc_plain_all = vcycle_ms(plain_hier)
    print(f"    V-cycle {vc_plain:.3f} ms (plain torch lattice; 10 "
          f"back-to-back, 3 reps {[round(t, 3) for t in vc_plain_all]})")
    del plain_hier
    done(t0)

    t0 = phase("8. operator micro-benchmark entry point, K-B: 16.2M dofs, "
               "p=6")
    del curved
    for k in lb.LAUNCHES:
        lb.LAUNCHES[k] = 0
    mf = run_mat_free(["--ndofs", "16194277", "--degree", "6", "--mesh",
                       "perturbed", "--operator", "lattice_blocked",
                       "--variant", "geom", "--reps", "50"])
    launches["lattice_apply_geom"] = lb.LAUNCHES["lattice_apply_geom"]
    print(f"    kernel launches on this path: {dict(lb.LAUNCHES)}")
    if not launches["lattice_apply_geom"] > 0:
        raise AssertionError(f"K-B was not launched: {dict(lb.LAUNCHES)}")
    if not (mf["device"] == torch.cuda.get_device_name(0)
            and mf["ms_per_apply"] > 0):
        raise AssertionError(f"mat_free did not time the card: {mf}")
    done(t0)

    t0 = phase("9. curved in-card reference: nc=21, lattice (plain) vs "
               "lattice_blocked")
    res = {}
    lmax = None
    mesh21 = PerturbedBoxMesh((21, 21, 21))
    for op in ("lattice", "lattice_blocked"):
        prob = PoissonProblem(mesh=mesh21, operator=op, **ccfg)
        levels = prob.hierarchy.data["levels"]
        print(f"    {op}: own calibration lmax "
              f"{[float(lv['lmax']) for lv in levels]}")
        if lmax is None:
            lmax = [lv["lmax"] for lv in levels]
        else:
            prob.hierarchy.load_state(
                {"levels": [{"lmax": v} for v in lmax]})
            # The f32 diagonal comes from index_add_ (atomics on the card):
            # its error against a sequential f64 sum.
            d_card = (1.0 / levels[-1]["diag_inv"]).double().cpu()
            print(f"    f32 card diagonal vs f64 host diagonal: rel max err "
                  f"{rel_max_err(d_card, f64_diagonal(mesh21, 6)):.3e}")
        r0 = float(torch.linalg.vector_norm(prob.b))
        _, rn = prob.solve(num_cycles=10)
        u, niter = prob.hierarchy.solve_pcg(prob.b, rtol=1e-6, maxiter=50)
        res[op] = (np.array(rn) / r0, niter, u, prob.error_l2(u),
                   vcycle_ms(prob.hierarchy)[0])
        print(f"    {op}: rel {[f'{v:.3e}' for v in res[op][0]]}, FCG "
              f"{niter}, L2 {res[op][3]:.4e}, V-cycle {res[op][4]:.3f} ms")
    (rk, nk, uk, _, _), (rb, nb, ub, _, _) = (res["lattice"],
                                              res["lattice_blocked"])
    keep = rk > REF_TRAJ_FROM
    traj = float(np.max(np.abs(rb[keep] - rk[keep]) / rk[keep]))
    print(f"    trajectory max rel diff (cycles above {REF_TRAJ_FROM:g}): "
          f"{traj:.3e}")
    if not traj <= 1e-3:
        raise AssertionError(f"trajectories differ: {traj}")
    if abs(nk - nb) > 1:
        raise AssertionError(f"FCG counts differ: {nk} vs {nb}")
    du = float(torch.linalg.vector_norm(ub - uk) / torch.linalg.vector_norm(uk))
    print(f"    FCG solutions: relative difference {du:.3e}")
    if not du <= 1e-3:
        raise AssertionError(f"FCG solutions differ: {du}")
    done(t0)

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": TPU_KERNELS[name], "launches": launches[name],
         "max_abs_err": main_shape[name][0], "ms": main_shape[name][1],
         "plain_ms": main_shape[name][2]}
        for name in SOURCES
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
