#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--parent PARENT_CHECKOUT]

Runs from the root of a checkout, builds the port's CUDA kernels from
its sources and drives the flagship solve (unfused, with the fused
Chebyshev smoother and with the fused p-transfers, the refined, W-cycle
and FMG modes, the Schwarz smoother, the device grid), the whole-lattice
Kronecker operator, the curved-hex solve and operator (streamed,
z-grouped and in-kernel geometry; with the Schwarz smoother and the
h-multigrid coarse solve), the serving (transient) steppers, the
AMG-driver twin and the coefficient and boundary-condition family
(graded spacing, Neumann and Robin faces, per-axis, tensor and variable
kappa, sigma fields) through them. Every phase raises on failure;
nothing is caught. The phases run in the order 1-3f, 4-4e, 14, 15, 18d,
19a-19c, 5-8b, 16, 17, 20a-20c, 9-11, 21, 12, 13, 18a-18c: 15, 18d, 19b,
20a and 20c reuse phase 4's mesh (and its host geometry factors), 16
and 17 phase 7's.

1. Environment: the card (``nvidia-smi`` name and power limit), torch,
   CUDA and nvcc versions. Fails when ``torch.cuda.is_available()`` is
   False.
2. Build the kernels (``csrc/kron_blocked.cu``, ``csrc/lattice_blocked.cu``,
   ``csrc/kron_packed.cu``, ``csrc/transfer.cu`` and ``csrc/kron_fused.cu``,
   one nvcc each, started together, sm_90a); the seconds, and each
   kernel's registers and spills (``kron_blocked.cu``: the marching
   kernels at the main path's bands 3 and 6, and the most over all).
3. Kernel parity: each kernel against its plain torch version at
   2,048,383 dofs (nc=21, p=6, 127^3) and 16,194,277 dofs (nc=42, p=6,
   253^3), seeded inputs, sigma in {0, 0.5}; relative max-norm error
   <= 1e-5 (float32, different summation order). Both timed with CUDA
   events around host-issued calls, in turns; kernels #1-#3 also as
   device time (a CUDA graph of 20 launches replayed between CUDA
   events), kernel 1 beside its library call (one ``torch.matmul`` of
   ``Ktx`` with the pre-masked input, TF32 off), and the host
   microseconds per launch of the ``kron_t1_m`` / ``kron_t23_m``
   wrappers (the least of 5 rounds of 1000 calls enqueued). Then #1-#3
   the same way at the V-cycles' coarser shapes (127^3 and 64^3 at band
   3, 43^3 and 22^3 at band 1) and at the highest bands (121^3 at band
   10, 129^3 at 16).
3b. Full-bc kernel parity: kernels #4-#7 (``kron_t1``, ``kron_t23``
   apply/residual, ``kron_t23_cheb`` init and loop steps) on a
   non-separable Dirichlet marker (the box faces plus ~1% of the interior
   dofs), sigma in {0, 0.5}, at 127^3 and 253^3; relative max-norm error
   <= 1e-5 against the plain torch versions, CUDA-event times in turns;
   #4 also as device time (CUDA graph) at each size, beside its library
   call (one ``torch.matmul`` of ``Ktx`` with the pre-masked, pre-scaled
   input, TF32 off) and the host us per launch of ``kron_t1``.
   At 253^3 the ops entry points ``blocked_kron_apply``,
   ``blocked_kron_residual`` and ``blocked_kron_cheb4`` run between a reset
   and a read of the launch counts: each of the four kernels must launch.
   Then #5 / #6 (the y-march with the marker byte up to band 12, the tile
   above: ``t23_plan``) within 1e-5 of ``plain_t23`` and as device time
   beside the bound and the separable twin's (#2 / #3) at 253^3 and
   127^3 band 6, 127^3 band 3, and phase 3's 43^3 band 1, 121^3 band 10
   and 129^3 band 16; with ``--parent``, the parent's in turns and
   whether both give the same bits (#7 too, at the first three).
3c. Transfer kernel parity: ``transfer_x`` (#10) and ``transfer_yz`` (#11)
   alone and as ``blocked_transfer`` against the plain torch versions for
   the main path's two pairs, 253^3 <-> 127^3 (p 6 <-> 3) and 127^3 <->
   43^3 (p 3 <-> 1), restrict and prolong, seeded x; relative max-norm
   <= 1e-5. Kernel, plain (in turns) and library times (one
   ``torch.einsum("ax,by,cz,xyz->abc")`` call, never used by the port)
   beside the bound; each kernel alone as device time (CUDA graph) at all
   four shapes beside its bound and library call (``torch.matmul`` /
   ``torch.einsum("by,ayz,zc->abc")``), both launch plans (`transfer_yz`'s
   with its shared memory and blocks per SM), and both wrappers' host us
   per launch at 253^3 -> 127^3. With ``--parent``, each kernel's device
   time at each shape in turns with the parent's, and whether both give
   the same bits.
3d. The whole-lattice Kronecker apply: ``PallasKronLaplacian(BoxMesh((21,
   21, 21)), 6)`` (2,048,383 dofs, the headline metric's size) between a
   reset and a read of the ``kron_fused`` count (one apply and the timed
   applies); relative max-norm <= 1e-5 against its plain version and
   <= 1e-4 against ``PallasKronBlocked`` on the same input (two f32 forms
   of ``Kt``); ms, GDOF/s, plain ms, bound. Then at 127^3 and 253^3
   (16,194,277 dofs) the same two gates and the kernel's device time
   beside its bound and ``PallasKronBlocked``'s device time for the same
   apply (#1 + #2); with ``--parent``, the parent's device time in turns
   and whether both give the same bits.
3e. The device-grid kernels #8/#9 on one shard at 127^3 and 253x127x127
   (band 6), 64^3 (band 3) and 22^3 (band 1) with seeded corrections
   against their plain versions (#8 on a non-separable marker), #9 and #8
   (apply and residual) as device time (CUDA graph), #8 beside its bound
   and #9's time, with ``--parent`` beside the parent's #8 and whether
   both give the same bits; `blocked_kron_apply_grid` on a non-separable
   marker must launch #8.
3f. This slice's operands: kernels #1-#3 (separable masks), #4 and #7
   (init and loop step, the box marker as the fused smoother passes it)
   at 253^3 and #12 at 127^3 on a box with x Neumann, y Robin (alpha 2),
   z Dirichlet and graded (ratio 8), per-axis kappa (1, 2, 4), sigma in
   {0, 0.5}: relative max-norm <= 1e-5 against the plain versions.
4. Main path: ``PoissonProblem(nc=(42,42,42), degrees=(1,3,6), kappa=2,
   float32, coarse="fdm", operator="kron_blocked")`` — 10 stationary
   V-cycles (the residual falls on each of the first 4) and FCG(V) to
   rtol 1e-6 within 50 iterations; every kernel's launch count must rise
   during this phase. The back-to-back V-cycle's idle share (1 - the
   `torch.profiler` busy ms of one cycle / the CUDA-event ms per cycle).
   Also times the V-cycle of the plain torch ``operator="kron"``
   hierarchy at the same size.
4b. The fused main path: ``PMGHierarchy(fuse_smoother=True)`` on phase
   4's mesh and rhs (16,194,277 dofs): 10 stationary cycles (the residual
   falls on each of the first 4), FCG(V) to rtol 1e-6 within one
   iteration of phase 4's count, the FCG solution within 1e-3 relative of
   phase 4's; kernels #4 and #7 must launch. V-cycle ms fused against
   unfused in turns; for each, the CUDA-event ms and the host ms to
   enqueue 10 cycles over 5 reps (who sets the pace), and a
   `torch.profiler` breakdown of one V-cycle with its idle share of the
   back-to-back cycle and the ms of kernels #4, #7, #10, #11 in it; the
   trajectory and FCG count beside the parent commit's as printed.
4c. ``solve_refined`` on the fused hierarchy: the f64 relative residual
   falls below 1e-8 within 20 cycles (trajectory printed).
4d. At nc=21 (2,048,383 dofs), fused: the W-cycle (``gamma=2``) ends
   below the V-cycle after 6 cycles (f64 residuals of `solve_refined`),
   and ``solve(fmg=True)``'s first residual is below the zero start's.
4e. The fused p-transfers: ``PMGHierarchy(fuse_transfers=True)``, alone
   and with ``fuse_smoother=True``, on phase 4's mesh and rhs: one
   V-cycle launches each transfer kernel exactly 4 times (2 restrict, 2
   prolong); 10 stationary cycles within 1e-4 of phase 4's (alone) / 4b's
   (with the fused smoother) trajectory above 5e-3; FCG(V) within one
   iteration of phase 4's count; #11 must launch in both and #4 with the
   fused smoother. V-cycle ms against 4b's in turns, and a
   `torch.profiler` split of one cycle (transfer kernels against the
   rest; busy ms, idle share, #4/#7/#10/#11 ms); the trajectories and
   FCG counts beside the parent commit's as printed.
5. In-card reference: the same problem at nc=21 with ``operator="kron"``
   (plain torch) and ``"kron_blocked"``, the second run with the first
   one's calibrated smoother bounds: residual trajectories agree to
   1e-3 relative on every cycle above 5e-3 relative residual, FCG counts
   differ by at most 1, the two FCG solutions agree to 1e-3 relative.
6. Lattice kernel parity: K-A (``lattice_apply``, launched under each
   variant name 'yexp', 'v1' and 'ym') at p=6 on nc=21 (2,048,383 dofs)
   and nc=42 (16,194,277 dofs), and at p=1 and p=3 on nc=42; K-B
   (``lattice_apply_geom``) at p=6 on nc=21 and nc=42; at nc=42, p=6 K-A
   on the z-grouped ``Gz`` (``lattice_apply_zgrp``, zb=14 of
   ``select_zgroup``) against its plain version and against K-A on ``Gt``;
   ``PallasLatticeBlocked(variant="zgrp")`` with zb in {2, 3} on a small
   mesh against its plain version and K-A. Seeded x, the geometry of the
   perturbed mesh, kappa=2; relative max-norm error <= 1e-5 against the
   plain torch versions; two applies of K-A give the same bits; timed in
   turns plain, kernel, kernel, plain. Each kernel at each size also as
   device time (`graph_ms`) beside its bound, host us per launch, and
   (one-launch design) its box, blocks per SM and face scratch.
7. Curved main path: ``PoissonProblem(mesh=PerturbedBoxMesh((42,42,42)),
   degrees=(1,3,6), kappa=2, float32, coarse="cg",
   operator="lattice_blocked")`` — 10 stationary V-cycles (the residual
   falls on each of the first 4), FCG(V) to rtol 1e-6 within 50
   iterations, K-A's launch count rises, collocated L2 error < 1e-4;
   V-cycle timed against the plain torch ``operator="lattice"``
   hierarchy on the same mesh; one V-cycle under `torch.profiler`,
   labelled complete only when its lattice kernels number the wrappers'
   count and its kernel count repeats (`profile_complete`): wall ms,
   device busy ms, K-A's share of it by degree and the idle share of the
   back-to-back cycle; the trajectory and FCG count beside the parent
   commit's as printed (`PARENT_RUNS`), within 1e-3 relative above 5e-3
   and one iteration.
8. The operator micro-benchmark entry point
   (``examples/mat_free_torch.py --operator lattice_blocked --variant
   geom --mesh perturbed``) at 16.2M dofs, p=6: K-B's launch count rises;
   ms per apply and GDOF/s.
8b. The same entry point with ``--variant zgrp`` (zb from
   ``select_zgroup``, 14): ``lattice_apply_zgrp``'s launch count rises.
   Both runs get phase 7's mesh, so its host geometry factors are not
   computed again.
9. Curved in-card reference: nc=21 with ``operator="lattice"`` (plain
   torch) and ``"lattice_blocked"`` under the rules of phase 5.
10. Serving kernel parity: ``packed_apply`` and ``packed_fdm``
   (``csrc/kron_packed.cu``) through each of the four classes of
   ``ops/kron_packed.py`` at 61^3 (nc=10, p=6, 226,981 dofs), kappa=2:
   the apply at B in {1, 8, 64} with sigma in {0, 1e3} and one mixed
   Dirichlet/Neumann case, the FDM solve at B in {1, 8, 64}; relative
   max-norm <= 1e-5 against the plain torch versions; ``apply(solve(b))``
   equals ``b`` to 1e-4; CUDA-event times in turns plain, kernel,
   kernel, plain; each kernel's device time (`graph_ms`) at each B beside
   its bound, its kernels per call (profiler) and host us per call at
   B=1, and both launch plans. With ``--parent DIR`` (a parent checkout,
   e.g. ``git archive`` unpacked under ``build/``) the parent's package
   is timed in the same process, in turns (parent, change, change,
   parent), with its kernels and host us per call, and whether both give
   the same bits.
11. Serving path, the README's configuration (61^3, p=6): heat CN
   (``heat_packed_evolve``, dt=1e-3, 2000 steps) at B=1 and B=8, wave
   leapfrog (``wave_packed_evolve``, 0.72 x ``wave_stable_dt``, 2000
   steps) at B=1 and B=8 and Newmark at B=1: L2 error against the
   analytic mode, column-steps/s, kernels and device busy ms per step
   under ``torch.profiler`` with the idle share, the launches of both
   kernels (each must rise); in-card reference: the same evolve with the
   plain versions agrees to 1e-4 relative (heat over 200 steps: after
   2000 the CN state is below float32 range). With ``--parent``, each
   configuration's profiled steps also run on the parent's package, in
   turns.
12. The JAX bench's ``heat_cn_2M`` recipe: ``heat_fdm_evolve`` on
   ``BoxMesh((42,42,42))``, p=3 (2,048,383 dofs), CN, dt=1e-4, f32,
   kappa=2 (plain torch): steps/s as the slope between 200 and 1000
   steps.
13. A small curved stepper: ``heat_pcg_evolve`` on
   ``PerturbedBoxMesh((19,19,19))``, p=3 (195,112 dofs),
   ``operator="lattice"``, ``coarse="cg"``, CN, 5 steps: FCG counts per
   step, finite state.
15. The Schwarz flagship, the JAX bench's ``vcycle_16M_p136_schwarz``:
   ``PMGHierarchy(smoother="schwarz")`` on phase 4's mesh and rhs
   (16,194,277 dofs, p=(1,3,6), kappa=2, float32, ``kron_blocked`` +
   ``fdm``): setup seconds, 10 stationary cycles with the contraction per
   cycle, FCG(V) to rtol 1e-6 within phase 4's point-Jacobi count, L2 <
   1e-4, #1/#2/#3 launch; the V-cycle's CUDA-event ms and pace, its
   profiled busy ms and kernels (window complete when the profiler's
   ``kron_t*`` kernels number the wrappers' launches), and the Schwarz
   applies' share of the busy time (each level's apply profiled alone,
   times 2 x (smoother_iters + 1) per cycle). At nc=21 against the
   plain-torch ``kron`` Schwarz hierarchy at its smoother bounds: one
   V-cycle on a seeded random rhs and iterate within 1e-5 (relative
   max-norm), and the trajectories within twice the f32 residual floor
   (absolute difference of the relative residuals; the relative
   difference is printed).
16. Curved Schwarz: ``PoissonProblem(mesh=PerturbedBoxMesh((42,42,42)),
   ..., coarse="cg", operator="lattice_blocked", smoother="schwarz")`` on
   phase 7's mesh: FCG(V) within phase 7's point-Jacobi count, K-A
   launches, collocated L2 < 1e-4, V-cycle ms; then the nc=21 recipe of
   the JAX bench's ``curved_2M_p136`` Schwarz half (V-cycle ms, FCG(V),
   L2).
17. Curved hmg coarse, the JAX driver's ``--mesh perturbed --coarse fdm``
   path: ``coarse="hmg"`` on phase 7's mesh (h-levels (42,42,42) ->
   (21,...) -> (7,...) at p=1, a 512-dof dense bottom): the levels, setup
   seconds, FCG(V) within one of phase 7's ``cg``-coarse count, L2 <
   1e-4, wall and busy ms per V-cycle and the idle share beside phase
   7's.
18. The remaining entry points. a: ``examples/amg_torch.py --ndofs
   2000000 --pc jacobi|cheb|hmg``, box and ``--mesh perturbed``, in this
   process: hmg-CG below Jacobi-CG's iterations on each mesh. b:
   ``coarse="direct"`` at nc=14, p=(1,3,6), ``kron_blocked``, against
   ``coarse="fdm"`` at the same smoother bounds: trajectories within 1e-4
   above 5e-3. c: ``BoxMesh((16,16,32), extent=(1,1,0.25))`` (64:1
   coupling), p=(1,3), float64 ``kron``, ``coarse="hmg"`` on
   ``semicoarsen_sizes`` with ``smoother="line"`` (z) on the p- and
   h-levels: FCG(V) to 1e-10 below the point-Jacobi hierarchy's. d (run
   after 15): ``GridPMG((2,2,2), smoother="schwarz",
   operator="kron_blocked")`` on phase 4's mesh: one grid V-cycle within
   1e-5 of phase 15's single-device one, #9 launches.

19. The box family at 16,194,277 dofs, p=(1,3,6), float32,
   ``kron_blocked`` + ``fdm`` (JAX's ``examples/pmg.py`` flags). a:
   ``--grade z:8 --neumann x --robin y`` (the mesh of 3f, kappa 2,
   `f_rhs_mixed` / `u_exact_mixed` / `robin_data`): FCG(V) to 1e-6
   within 50, L2 < 1e-4 (on a host thread, joined after phase 5), ms per
   V-cycle (CUDA events, 10 back-to-back, median of 3), #1-#3 launch. b: ``--kappa-field aniso-diag``
   (diag(1, 1, 100)) on phase 4's mesh: FCG(V) count and ms per V-cycle;
   the ``--fdm`` one-shot direct solve within 1e-3 of the FCG solution,
   and its L2 < 1e-4 at nc=21. c: at nc=21, a's problem with
   ``fuse_smoother=True, fuse_transfers=True`` (#4/#7/#10/#11) at the
   unfused hierarchy's smoother bounds: one V-cycle on a seeded input
   within 1e-5 of the unfused one's, FCG(V) within one.
20. The general family, ``lattice_blocked``. a: ``--kappa-field aniso``
   (`kappa_aniso`, 100:1 rotated 30 degrees, folded into G: the first
   off-diagonal G on a box) on phase 4's mesh, ``coarse="cg"``: FCG(V) to
   1e-6 within 100, ms per V-cycle beside phase 7's curved cycle, K-A
   launches; L2 < 1e-4 at nc=21. b: at nc=21, `kappa_linear` with
   ``coarse="hmg"`` and `sigma_linear` with ``coarse="cg"``: FCG(V)
   within one of the plain ``lattice`` hierarchy's, L2 < 1e-4 (the DG-0
   `kappa_linear`: within 1% of the plain solve's, its own h^2
   coefficient error), one V-cycle on a seeded input within 1e-5 of the
   plain hierarchy's at its smoother bounds. c: K-B
   (``PallasLatticeBlocked(kappa=kappa_linear, variant="geom")``, the
   per-cell kappa at ``co[36]``) at 253^3 on phase 4's mesh, within 1e-5
   of its plain version.
21. Serving at 61^3, p=6, kappa (1, 1, 100), z graded (ratio 8), x
   Neumann: #18-#21 through the four packed classes within 1e-5 of their
   plain versions; heat CN (dt 1e-4) at B=1 and B=8 (steps/s; 20 steps
   within 1e-4 of the f64 `heat_fdm_evolve`), leapfrog at B=1 and 8 (100
   steps within 1e-4 of `wave_leapfrog_evolve`).

Prints a ``{"kernels": [...]}`` JSON line (each kernel's launches on its
path, error, host-issued time, plain time, library time where one
PyTorch call computes the same function, and its bound: bytes over 3.35
TB/s or f32 operations over 67 TFLOP/s, the larger; #1-#6, #8-#12, the
lattice kernels #13-#17 and the serving kernels #18-#21 add their device
times as ``device_ms*`` keys, #5, #6, #8, the transfers, #12 and the
lattice kernels per shape beside ``bound_ms_by_shape`` (#5, #6, #8 with
their separable twin's device time, #12 with the blocked apply's), the
lattice kernels with their box and face
scratch, the serving kernels per batch beside ``bound_ms_by_batch``;
``launches`` sums each kernel's launches over every path that runs it
(#1-#3 phases 4, 15 and 19a/19b, #4/#7/#10/#11 phases 4b-4e and 19c, #9
phases 14 and 18d, K-A phases 7, 16, 17, 20a and 20b, K-B phases 8 and
20c, #18-#21 phases 11 and 21),
with their kernels and host us per call and, with ``--parent``, the
parent's device times and whether the bits are the same) and, only when every
phase passed, the last line
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
    "t1": "pmg_dolfinx_tpu_torch/csrc/kron_blocked.cu",
    "t23": "pmg_dolfinx_tpu_torch/csrc/kron_blocked.cu",
    "t23_res": "pmg_dolfinx_tpu_torch/csrc/kron_blocked.cu",
    "t23_cheb": "pmg_dolfinx_tpu_torch/csrc/kron_blocked.cu",
    "lattice_apply": "pmg_dolfinx_tpu_torch/csrc/lattice_blocked.cu",
    "lattice_apply_zgrp": "pmg_dolfinx_tpu_torch/csrc/lattice_blocked.cu",
    "lattice_apply_geom": "pmg_dolfinx_tpu_torch/csrc/lattice_blocked.cu",
    "packed_apply": "pmg_dolfinx_tpu_torch/csrc/kron_packed.cu",
    "packed_fdm": "pmg_dolfinx_tpu_torch/csrc/kron_packed.cu",
    "transfer_x": "pmg_dolfinx_tpu_torch/csrc/transfer.cu",
    "transfer_yz": "pmg_dolfinx_tpu_torch/csrc/transfer.cu",
    "kron_fused": "pmg_dolfinx_tpu_torch/csrc/kron_fused.cu",
    "t23_grid": "pmg_dolfinx_tpu_torch/csrc/kron_blocked.cu",
    "t23_grid_m": "pmg_dolfinx_tpu_torch/csrc/kron_blocked.cu",
}
TPU_KERNELS = {
    "t1_m": "pmg_dolfinx_tpu/ops/pallas_kron_blocked.py:125",
    "t23_m": "pmg_dolfinx_tpu/ops/pallas_kron_blocked.py:149",
    "t23_res_m": "pmg_dolfinx_tpu/ops/pallas_kron_blocked.py:185",
    "t1": "pmg_dolfinx_tpu/ops/pallas_kron_blocked.py:70",
    "t23": "pmg_dolfinx_tpu/ops/pallas_kron_blocked.py:90",
    "t23_res": "pmg_dolfinx_tpu/ops/pallas_kron_blocked.py:264",
    "t23_cheb": "pmg_dolfinx_tpu/ops/pallas_kron_blocked.py:219",
    "lattice_apply": ("pmg_dolfinx_tpu/ops/pallas_lattice_blocked.py:117 "
                      "(_kernel_lattice_yx 'yexp'; also :69 _kernel_lattice "
                      "'v1' and :220 _kernel_lattice_ym 'ym')"),
    "lattice_apply_zgrp": "pmg_dolfinx_tpu/ops/pallas_lattice_blocked.py:332",
    "lattice_apply_geom": "pmg_dolfinx_tpu/ops/pallas_lattice_blocked.py:411",
    "packed_apply": ("pmg_dolfinx_tpu/ops/pallas_kron_packed.py:64 "
                     "(_packed_kernel; also :471 _packed_single_kernel)"),
    "packed_fdm": ("pmg_dolfinx_tpu/ops/pallas_kron_packed.py:273 "
                   "(_packed_fdm_kernel; also :797 "
                   "_packed_fdm_single_kernel)"),
    "transfer_x": "pmg_dolfinx_tpu/ops/pallas_transfer.py:48",
    "transfer_yz": "pmg_dolfinx_tpu/ops/pallas_transfer.py:56",
    "kron_fused": "pmg_dolfinx_tpu/ops/pallas_kron.py:43",
    "t23_grid": "pmg_dolfinx_tpu/ops/pallas_kron_blocked.py:295",
    "t23_grid_m": "pmg_dolfinx_tpu/ops/pallas_kron_blocked.py:365",
}
KERNEL_RTOL = 1e-5
REF_TRAJ_FROM = 5e-3
# Fused against unfused Chebyshev at the same lmax: the CPU tests' gate
# of the fused hierarchy against the JAX one.
FUSED_TRAJ_RTOL = 1e-4
# The device grid against one device, both f32, on cycles above
# REF_TRAJ_FROM, relative: within twice the spread of two correct f32
# operators on the same problem, measured in the same run (the plain kron
# hierarchy against kron_blocked; the grid sums the interface planes in
# another order), at least the JAX package's own 5e-4
# (tests/test_grid2d.py) and at most GRID_TRAJ_CAP.
GRID_TRAJ_RTOL = 5e-4
GRID_TRAJ_CAP = 5e-3
# One grid V-cycle against one single-device V-cycle on a seeded random
# rhs and iterate, at the same smoother bounds: relative max-norm.
GRID_VCYCLE_RTOL = 1e-5
GRID_NEEDS = ((True, True), (True, False), (False, True))
# The kron_blocked Schwarz hierarchy against its plain-torch kron twin at
# nc=21, at the twin's smoother bounds: one V-cycle on a seeded random rhs
# and iterate, relative max-norm. (Their f32 residual trajectories differ
# by the f32 residual's rounding noise, about the stationary floor times
# |b| in absolute terms each, 2.5e-4 here: ~8e-4 relative on cycle 1
# already. So the trajectories are held to twice that floor, absolute.)
SCHWARZ_VCYCLE_RTOL = 1e-5
SEED = 1234
# The card's published peaks (H100 SXM data sheet, at 700 W): HBM bytes/s
# and float32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def phase(name):
    print(f"\n=== {name}", flush=True)
    return time.perf_counter()


def done(t0):
    print(f"    phase seconds: {time.perf_counter() - t0:.2f}", flush=True)


def traj_diff(rel, rel_ref):
    """Max relative difference of two residual trajectories over the
    cycles where ``rel_ref`` is above `REF_TRAJ_FROM`."""
    import numpy as np

    rel, rel_ref = np.asarray(rel), np.asarray(rel_ref)
    keep = rel_ref > REF_TRAJ_FROM
    return float(np.max(np.abs(rel[keep] - rel_ref[keep]) / rel_ref[keep]))


def grid_traj_gate(rel, rel_ref, spread, tag):
    """Raise unless ``rel`` keeps within the grid gate of ``rel_ref`` on
    every cycle where ``rel_ref`` is above `REF_TRAJ_FROM`: relative, twice
    ``spread`` (the `traj_diff` of two correct f32 operators on the same
    problem, this run) clipped to [GRID_TRAJ_RTOL, GRID_TRAJ_CAP]."""
    gate = min(max(GRID_TRAJ_RTOL, 2.0 * spread), GRID_TRAJ_CAP)
    diff = traj_diff(rel, rel_ref)
    print(f"    {tag}: trajectory max rel diff (cycles above "
          f"{REF_TRAJ_FROM:g}) {diff:.3e}; gate {gate:.3e} (2 x the "
          f"plain-kron spread {spread:.3e}, clipped to [{GRID_TRAJ_RTOL:g}, "
          f"{GRID_TRAJ_CAP:g}])")
    if not diff <= gate:
        raise AssertionError(f"{tag}: trajectories differ by {diff:.3e} > "
                             f"{gate:.3e} relative")


def grid_vcycle_parity(grid, hier, seed, tag):
    """One `GridPMG` V-cycle against one single-device V-cycle on a seeded
    random rhs and iterate, the grid run at the single device's smoother
    bounds (the two calibrations differ by f32 rounding): the smoother,
    the transfers and the coarse gather/slice of the grid, on the card."""
    import numpy as np
    import torch

    n = hier.levels[-1].ndofs
    rng = np.random.default_rng(seed)
    b, u = (torch.tensor(rng.standard_normal(n, dtype=np.float32),
                         device="cuda") for _ in range(2))
    own = [lv["lmax"] for lv in grid.data["levels"]]
    for lv_g, lv_s in zip(grid.data["levels"], hier.data["levels"]):
        lv_g["lmax"] = lv_s["lmax"]
    try:
        v_g = grid.from_dist(grid.apply(grid.to_dist(b), grid.to_dist(u)))
    finally:
        for lv_g, lm in zip(grid.data["levels"], own):
            lv_g["lmax"] = lm
    v_s = hier.apply(b, u)
    err = rel_max_err(v_g, v_s)
    print(f"    {tag}: one V-cycle, seeded random rhs and iterate, vs the "
          f"single device: rel max err {err:.3e} (gate {GRID_VCYCLE_RTOL:g})")
    if not err <= GRID_VCYCLE_RTOL:
        raise AssertionError(f"{tag}: grid and single-device V-cycles differ "
                             f"by {err:.3e}")


def vcycle_pair_parity(hier, ref, seed):
    """Relative max-norm difference of one V-cycle of two single-device
    hierarchies on the same seeded random rhs and iterate (at whatever
    smoother bounds they hold)."""
    import numpy as np
    import torch

    n = ref.levels[-1].ndofs
    rng = np.random.default_rng(seed)
    b, u = (torch.tensor(rng.standard_normal(n, dtype=np.float32),
                         device="cuda") for _ in range(2))
    return rel_max_err(hier.apply(b, u), ref.apply(b, u))


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


def graph_ms(fn, launches=20, reps=5):
    """Device ms per call of ``fn``: a `torch.cuda.CUDAGraph` capturing
    ``launches`` calls, replayed between CUDA events (median of ``reps``
    replays), so the host's launch rate does not enter. A kernel wrapper
    counts its launches once, at the capture."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return sorted(times)[reps // 2]


def device_ms(kern, par=None, bound=None):
    """Device ms of ``kern`` (`graph_ms`) and the text to print after it.
    With the parent's twin call ``par``, both run in turns (parent,
    change, change, parent) and the third value is (parent ms, whether
    both give the same bits), else None; ``bound`` (ms) adds the
    parent's share of it to the text."""
    import torch

    if par is None:
        return graph_ms(kern), "", None
    p1, d1, d2, p2 = graph_ms(par), graph_ms(kern), graph_ms(kern), \
        graph_ms(par)
    pdev = (p1 + p2) / 2
    same = bool(torch.equal(kern().clone(), par()))
    share = "" if bound is None else f", {bound / pdev:.0%}"
    return (d1 + d2) / 2, (
        f"; parent {pdev:.4f} ms{share} (turns {p1:.4f}, {d1:.4f}, "
        f"{d2:.4f}, {p2:.4f}), same bits {same}"), (pdev, same)


def host_us(fn, calls=1000, reps=5):
    """Host microseconds per call of ``fn`` (enqueue only: the card is
    idle before the first call, and its finish is not timed): the least
    of ``reps`` rounds of ``calls`` calls, since a busy host only adds."""
    import torch

    fn()
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return best


def ptxas_lines(log, keep, prefix="kron_t", width=32):
    """The ``-Xptxas -v`` registers and spills of each kernel of ``log``
    whose mangled name contains one of ``keep``, one line each, the name
    from ``prefix`` on (``width`` characters of it)."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name, spill = line.split("'")[1], ""
        elif name and any(k in name for k in keep):
            if "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                out.append(f"{name[name.find(prefix):][:width]}: "
                           f"{line.split(': ', 1)[-1].strip()}; {spill}")
    return out


def peak_rss_gb():
    """Peak resident host memory of this process so far, GB."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024**2


def rel_max_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def kernel_parity(nc, P, kappa=2.0, host_cost=False):
    """Phase 3 at one size: returns ({kernel: (max_abs_err, ms, plain_ms)}
    measured at sigma=0 (the errors over both sigmas; ms host-issued, in
    turns with plain), {kernel: device ms from `graph_ms`}, the library
    ms of kernel 1 (one ``torch.matmul`` of ``Ktx`` with the pre-masked
    input, TF32 off, never used by the port) and {kernel: host us per
    launch}, measured with ``host_cost`` only, else empty)."""
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
        Ks, ms, face_masks=kb.checked_face_masks(
            mesh, P, mesh.boundary_dof_marker(P)),
        band=P, device="cuda")
    rng = np.random.default_rng(SEED + nc)
    x = torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                     device="cuda")
    r = torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                     device="cuda")
    bc = torch.tensor(mesh.boundary_dof_marker(P).reshape(shape),
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
                ("apply", kb.blocked_kron_apply(x, bc, mats, sigma=sigma),
                 kb.plain_apply_m(x, mats, sigma)),
                ("residual", kb.blocked_kron_residual(r, x, bc, mats,
                                                      sigma=sigma),
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
    # Device time: a CUDA graph of 20 launches into preallocated outputs.
    y = torch.empty_like(x)
    dev = {
        "t1_m": graph_ms(lambda: kb.kron_t1_m(x, mats, out=y)),
        "t23_m": graph_ms(lambda: kb.kron_t23_m(x, t1_ref, mats, out=y)),
        "t23_res_m": graph_ms(lambda: kb.kron_t23_m(x, t1_ref, mats, r3=r,
                                                    out=y)),
    }
    w = (x * (mats["myb"][None, :, :] * mats["sxzm"][:, None, :])).view(
        shape[0], -1)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lib_t1 = cuda_ms(lambda: torch.matmul(mats["Ktx"], w))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    host = {}
    if host_cost:
        host = {
            "t1_m": host_us(lambda: kb.kron_t1_m(x, mats, out=y)),
            "t23_m": host_us(lambda: kb.kron_t23_m(x, t1_ref, mats, out=y)),
        }
    print(f"    {shape} device ms (CUDA graph of 20 launches): "
          + ", ".join(f"{k} {v:.4f}" for k, v in dev.items())
          + f"; t1_m library (torch.matmul, TF32 off) {lib_t1:.4f}"
          + "".join(f"; host us per launch (least of 5 x 1000 enqueued) "
                    f"{k} {v:.2f}" for k, v in host.items()))
    apply_k = cuda_ms(lambda: kb.blocked_kron_apply(x, bc, mats))
    apply_g = graph_ms(lambda: kb.blocked_kron_apply(x, bc, mats))
    apply_p = cuda_ms(lambda: kb.plain_apply_m(x, mats))
    ndofs = x.numel()
    print(f"    {shape} apply: kernels {apply_k:.4f} ms "
          f"({ndofs / apply_k / 1e6:.3f} GDOF/s; device {apply_g:.4f} ms, "
          f"{ndofs / apply_g / 1e6:.3f} GDOF/s) vs plain {apply_p:.4f} ms "
          f"({ndofs / apply_p / 1e6:.3f} GDOF/s)")
    return out, dev, lib_t1, host


def kernel_bound(name, N, P, nc=None, B=None, dims=None, terms=None):
    """The least time (ms) the card could take for one launch of kernel
    ``name`` at the shape its ``ms`` was measured on, and what bounds it:
    the larger of its bytes (each input read once, each output written
    once) over the HBM rate and its float32 operations (band-limited sums
    as the kernels run them) over the f32 peak. ``N`` is the lattice's
    dofs, ``P`` the degree (band half-width), ``nc`` the cells per axis
    (lattice kernels), ``B`` the batch and ``dims`` the lattice extents
    (serving kernels; the transfers' ``(NX, NY, NZ, A)`` / ``(A, NY, NZ,
    B, C)``, the whole-lattice apply's ``(NX, NY, NZ)``). ``terms`` counts
    the nonzero-range products these inputs need (`transfer_terms`,
    `kron_fused_terms`)."""
    D = 2 * P + 1
    n = P + 1
    if name in ("t1_m", "t1", "t23_m", "t23", "t23_res_m", "t23_res",
                "t23_cheb"):
        lattices = {"t1_m": (1, 1), "t1": (1, 1), "t23_m": (2, 1),
                    "t23": (2, 1), "t23_res_m": (3, 1), "t23_res": (3, 1),
                    "t23_cheb": (5, 3)}[name]     # f32 (reads, writes)
        marker = 0 if name.endswith("_m") else 1  # the 1-byte bc lattice
        nbytes = 4 * N * sum(lattices) + marker * N
        flops = {"t1_m": 2 * D + 2, "t1": 2 * D + 1, "t23_m": 4 * D + 10,
                 "t23": 4 * D + 8, "t23_res_m": 4 * D + 11,
                 "t23_res": 4 * D + 9, "t23_cheb": 4 * D + 14}[name] * N
    elif name in ("lattice_apply", "lattice_apply_zgrp", "lattice_apply_geom"):
        cells = nc[0] * nc[1] * nc[2]
        Q = cells * n**3
        geom = 4 * 37 * cells if name == "lattice_apply_geom" else 24 * Q
        nbytes = 9 * N + geom
        flops = (12 * n + 15 + (120 if name == "lattice_apply_geom" else 0)) * Q
    elif name == "packed_apply":
        nbytes = 8 * B * N + N
        flops = (6 * D + 4) * B * N
    elif name == "packed_fdm":
        nbytes = 8 * B * N + 5 * N
        flops = (4 * sum(dims) + 1) * B * N
    elif name == "transfer_x":           # x3 and Mx read, t written
        NX, NY, NZ, A = dims
        nbytes = 4 * (NX + A) * NY * NZ + 4 * A * NX
        flops = 2 * terms
    elif name == "transfer_yz":          # t, My, MzT read, out written
        A, NY, NZ, B_, C = dims
        nbytes = 4 * A * (NY * NZ + B_ * C) + 4 * (B_ * NY + NZ * C)
        flops = 2 * terms
    elif name in ("t23_grid", "t23_grid_m", "t23_grid_res",
                  "t23_grid_res_m"):     # t23(_res)(_m) + the cy/cz planes
        NX, NY, NZ = dims
        marker = 0 if name.endswith("_m") else 1
        res = 1 if "_res" in name else 0
        edge = 2 * NX * NZ + 2 * NX * NY
        nbytes = 4 * N * (3 + res) + marker * N + 4 * edge
        flops = (4 * D + (8 if marker else 10) + res) * N + 2 * edge
    elif name == "kron_fused":           # x, marker, planes read, y written
        NX, NY, NZ = dims
        nbytes = 9 * N + 4 * (NY * NZ + NX * NZ + NX * NY)
        flops = 2 * terms + 5 * N
    else:
        raise KeyError(name)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def full_bc_parity(nc, P, kappa=2.0, path=False):
    """Phase 3b at one size: the full-bc kernels #4-#7 on a non-separable
    marker (the box faces plus ~1% of the interior dofs) against their
    plain versions, sigma in {0, 0.5}; returns ({kernel: (max_abs_err, ms,
    plain_ms)}, launches, t1) with ``t1`` kernel #4's {"device_ms": from
    `graph_ms`, "library_ms": one ``torch.matmul`` of ``Ktx`` with the
    pre-masked, pre-scaled input (TF32 off, never used by the port),
    "host_us": per launch, `host_us`}. With ``path``, the ops entry
    points (`blocked_kron_apply`, `blocked_kron_residual`,
    `blocked_kron_cheb4`) run as a user calls them, between a reset and a
    read of the launch counts; ``launches`` is that read (else None)."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.ops.kron import axis_stiffness_mass, kron_diagonal

    mesh = BoxMesh((nc, nc, nc))
    shape = mesh.lattice_shape(P)
    Ks, ms = [], []
    for nc_a, h_a in zip(mesh.nc, mesh.h_cells):
        K, m = axis_stiffness_mass(nc_a, P, h_a)
        Ks.append(torch.tensor(kappa * K, dtype=torch.float32, device="cuda"))
        ms.append(torch.tensor(m, dtype=torch.float32, device="cuda"))
    mats = kb.symmetrized_mats(Ks, ms, band=P, device="cuda")
    rng = np.random.default_rng(SEED + 7 * nc)
    bc_np = (mesh.boundary_dof_marker(P).reshape(shape)
             | (rng.random(shape) < 0.01))
    if kb.checked_face_masks(mesh, P, bc_np) is not None:
        raise AssertionError("the phase-3b marker must not be separable")
    bc = torch.tensor(bc_np, device="cuda")
    x, r, b = (torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                            device="cuda") for _ in range(3))
    dinv = 1.0 / kron_diagonal(Ks, ms, bc.reshape(-1)).reshape(shape)
    lmax = torch.tensor(2.2, dtype=torch.float32, device="cuda")
    out = {k: [0.0, None, None] for k in ("t1", "t23", "t23_res", "t23_cheb")}

    def check(name, tag, got, ref):
        torch.cuda.synchronize()
        err = rel_max_err(got, ref)
        out[name][0] = max(out[name][0], float((got - ref).abs().max()))
        print(f"    {shape} P={P} {tag}: rel max err {err:.3e}")
        if not err <= KERNEL_RTOL:
            raise AssertionError(f"{tag} at {shape}: relative max-norm error "
                                 f"{err:.3e} > {KERNEL_RTOL}")

    for sigma in (0.0, 0.5):
        t1_x = kb.plain_t1(x, bc, mats)
        init = kb.plain_cheb_step(x, bc, x, b, dinv,
                                  kb.cheb_coefs(lmax, 0, torch.float32, "cuda"),
                                  mats, sigma, t1=t1_x)
        t1_z = kb.plain_t1(init[2], bc, mats)
        loop = kb.plain_cheb_step(init[2], bc, init[0], init[1], dinv,
                                  kb.cheb_coefs(lmax, 1, torch.float32, "cuda"),
                                  mats, sigma, t1=t1_z)
        tag = f"sigma={sigma}"
        check("t1", f"{tag} t1", kb.kron_t1(x, bc, mats), t1_x)
        check("t23", f"{tag} t23", kb.kron_t23(x, bc, t1_x, mats, sigma),
              kb.plain_t23(x, bc, t1_x, mats, sigma))
        check("t23_res", f"{tag} t23_res",
              kb.kron_t23(x, bc, t1_x, mats, sigma, r3=r),
              r - kb.plain_t23(x, bc, t1_x, mats, sigma))
        got = kb.kron_t23_cheb(x, bc, t1_x, mats, x, b, dinv, lmax, 0, sigma)
        for part, g, w in zip("xrz", got, init):
            check("t23_cheb", f"{tag} t23_cheb init {part}'", g, w)
        got = kb.kron_t23_cheb(init[2], bc, t1_z, mats, init[0], init[1],
                               dinv, lmax, 1, sigma)
        for part, g, w in zip("xrz", got, loop):
            check("t23_cheb", f"{tag} t23_cheb loop {part}'", g, w)
    plain = {
        "t1": lambda: kb.plain_t1(x, bc, mats),
        "t23": lambda: kb.plain_t23(x, bc, t1_x, mats),
        "t23_res": lambda: r - kb.plain_t23(x, bc, t1_x, mats),
        "t23_cheb": lambda: kb.plain_cheb_step(
            init[2], bc, init[0], init[1], dinv,
            kb.cheb_coefs(lmax, 1, torch.float32, "cuda"), mats, t1=t1_z),
    }
    kern = {
        "t1": lambda: kb.kron_t1(x, bc, mats),
        "t23": lambda: kb.kron_t23(x, bc, t1_x, mats),
        "t23_res": lambda: kb.kron_t23(x, bc, t1_x, mats, r3=r),
        "t23_cheb": lambda: kb.kron_t23_cheb(init[2], bc, t1_z, mats,
                                             init[0], init[1], dinv, lmax, 1),
    }
    for name in kern:
        ms_k, ms_p, four = turns(plain[name], kern[name])
        print(f"    {shape} P={P} {name}: kernel {ms_k:.4f} ms vs plain "
              f"{ms_p:.4f} ms (turns {[round(t, 4) for t in four]})")
        out[name][1:] = [ms_k, ms_p]
    # Kernel #4 as device time, beside its library call and host cost.
    y = torch.empty_like(x)
    t1 = {"device_ms": graph_ms(lambda: kb.kron_t1(x, bc, mats, out=y))}
    w = torch.where(bc, 0.0, x * mats["sxz"][:, None, :]).view(shape[0], -1)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t1["library_ms"] = cuda_ms(lambda: torch.matmul(mats["Ktx"], w))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    t1["host_us"] = host_us(lambda: kb.kron_t1(x, bc, mats, out=y))
    print(f"    {shape} P={P} t1 (#4): device {t1['device_ms']:.4f} ms (CUDA "
          f"graph of 20 launches); library (torch.matmul, TF32 off) "
          f"{t1['library_ms']:.4f} ms; host us per launch (least of 5 x "
          f"1000 enqueued) {t1['host_us']:.2f}")
    launches = None
    if path:
        for k in kb.LAUNCHES:
            kb.LAUNCHES[k] = 0
        y = kb.blocked_kron_apply(x, bc, mats)
        rr = kb.blocked_kron_residual(r, x, bc, mats)
        xc = kb.blocked_kron_cheb4(b, x, bc, mats, dinv, lmax, 2)
        torch.cuda.synchronize()
        launches = dict(kb.LAUNCHES)
        print(f"    entry points on the non-separable marker: launches "
              f"{launches}")
        if not all(launches[k] > 0 for k in out):
            raise AssertionError(f"a full-bc kernel was not launched: "
                                 f"{launches}")
        check("t23", "blocked_kron_apply", y, kb.plain_apply(x, bc, mats))
        check("t23_res", "blocked_kron_residual", rr,
              kb.plain_residual(r, x, bc, mats))
        check("t23_cheb", "blocked_kron_cheb4 (2 iterations)", xc,
              kb.plain_cheb4(b, x, bc, mats, dinv, lmax, 2))
    return {k: tuple(v) for k, v in out.items()}, launches, t1


def full_bc_march(nc, P, extra, parent=None, kappa=2.0):
    """Phase 3b, kernels #5 / #6 (`kron_t23`, the y-march with the marker
    byte) at ``BoxMesh((nc,) * 3)``, degree P, on a non-separable marker
    (the box faces plus ~1% of the interior dofs): within 1e-5 of
    `plain_t23` (apply and residual, sigma in {0, 0.5}), then each
    kernel's device time (`graph_ms`) beside its bound and its separable
    twin's (#2 / #3 on the box's face masks, same x and t1'). With the
    parent's package ``parent``, the parent's device time in turns
    (parent, change, change, parent) and whether both give the same bits,
    for #7 (`kron_t23_cheb`, loop step) too. Into ``extra`` (kernel name
    -> the kernels line's keys, by shape)."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.ops.kron import axis_stiffness_mass

    mesh = BoxMesh((nc, nc, nc))
    shape = mesh.lattice_shape(P)
    Ks, ms = zip(*(axis_stiffness_mass(n, P, h)
                   for n, h in zip(mesh.nc, mesh.h_cells)))
    Ks = [kappa * K for K in Ks]
    mats = kb.symmetrized_mats(Ks, ms, band=P, device="cuda")
    sep = kb.symmetrized_mats(Ks, ms, face_masks=kb.checked_face_masks(
        mesh, P, mesh.boundary_dof_marker(P)), band=P, device="cuda")
    rng = np.random.default_rng(SEED + 11 * nc + P)
    bc = torch.tensor(mesh.boundary_dof_marker(P).reshape(shape)
                      | (rng.random(shape) < 0.01), device="cuda")
    x, r, b = (torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                            device="cuda") for _ in range(3))
    t1 = kb.plain_t1(x, bc, mats)
    t1m = kb.plain_t1_m(x, sep)
    key = f"{shape[0]}^3 band {P}"
    for sigma in (0.0, 0.5):
        for rr in (None, r):
            ref = kb.plain_t23(x, bc, t1, mats, sigma)
            if rr is not None:
                ref = rr - ref
            got = kb.kron_t23(x, bc, t1, mats, sigma, r3=rr)
            torch.cuda.synchronize()
            err = rel_max_err(got, ref)
            tag = (f"{key} {'t23_res' if rr is not None else 't23'} "
                   f"sigma={sigma}")
            print(f"    {tag}: rel max err {err:.3e}")
            if not err <= KERNEL_RTOL:
                raise AssertionError(f"{tag}: relative max-norm error "
                                     f"{err:.3e} > {KERNEL_RTOL}")
    pkb = (importlib.import_module(f"{parent.__name__}.ops.kron_blocked")
           if parent else None)
    y = torch.empty_like(x)
    N = x.numel()
    dinv = torch.rand(shape, device="cuda") + 0.5
    lmax = torch.tensor(2.2, dtype=torch.float32, device="cuda")
    cases = {
        "t23": (lambda k: k.kron_t23(x, bc, t1, mats, out=y),
                lambda: kb.kron_t23_m(x, t1m, sep, out=y), "t23_m"),
        "t23_res": (lambda k: k.kron_t23(x, bc, t1, mats, r3=r, out=y),
                    lambda: kb.kron_t23_m(x, t1m, sep, r3=r, out=y),
                    "t23_res_m"),
    }
    if parent and (nc, P) in ((42, 6), (21, 6), (42, 3)):
        # #7 keeps the parent's code: its bits and time beside the parent's.
        cases["t23_cheb"] = (lambda k: k.kron_t23_cheb(
            x, bc, t1, mats, b, r, dinv, lmax, 1)[1], None, None)
    for name, (kern, twin, twin_name) in cases.items():
        e = extra.setdefault(name, {
            "device_ms_by_shape": {}, "bound_ms_by_shape": {},
            "twin_device_ms_by_shape": {},
            "parent_device_ms_by_shape": {} if parent else None,
            "same_bits_as_parent_by_shape": {} if parent else None})
        bound, by = kernel_bound(name, N, P)
        dev, vs, par = device_ms(lambda: kern(kb), parent and (
            lambda: kern(pkb)), bound)
        if par:
            (e["parent_device_ms_by_shape"][key],
             e["same_bits_as_parent_by_shape"][key]) = par
        e["device_ms_by_shape"][key] = dev
        e["bound_ms_by_shape"][key] = bound
        tw = ""
        if twin is not None:
            tdev = e["twin_device_ms_by_shape"][key] = graph_ms(twin)
            tw = f"; separable twin {twin_name} {tdev:.4f} ms"
        form = f" ({kb.t23_plan(P)})" if name != "t23_cheb" else ""
        print(f"    {key} {name}{form}: device {dev:.4f} ms (CUDA graph of 20 "
              f"launches), {bound / dev:.0%} of its bound {bound:.4f} ms "
              f"({by}){tw}{vs}")


def turns(plain, kern):
    """Times ``plain`` and ``kern`` in turns plain, kernel, kernel, plain;
    returns (kernel ms, plain ms, the four times)."""
    p1 = cuda_ms(plain, reps=5, warmup=1)
    k1 = cuda_ms(kern)
    k2 = cuda_ms(kern)
    p2 = cuda_ms(plain, reps=5, warmup=1)
    return (k1 + k2) / 2, (p1 + p2) / 2, (p1, k1, k2, p2)


def range_terms(M, axis):
    """The products a banded sum over ``M``'s rows (``axis=0``) or columns
    (``axis=1``) needs: the total length of their nonzero ranges."""
    from pmg_dolfinx_tpu_torch.ops.transfer import nonzero_ranges

    lo, hi = nonzero_ranges(M, axis).long()
    return int((hi - lo).sum())


def transfer_parity(parent=None):
    """Phase 3c: kernels #10/#11 against their plain versions on the main
    path's two transfer pairs, both directions. Returns ({kernel:
    (max_abs_err, ms, plain_ms)}, {kernel: (bound_ms, by)}, {kernel:
    library_ms}) measured on the fine restriction 253^3 -> 127^3, and
    {kernel: extra keys of the kernels line}: each kernel alone as device
    time (`graph_ms`) at all four V-cycle shapes beside its bound and
    library time there, and its host us per launch. With the parent's
    package ``parent``, each kernel's device time at each shape is taken
    in turns with the parent's (parent, change, change, parent), and
    whether both give the same bits."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.ops import transfer as tt
    from pmg_dolfinx_tpu_torch.ops.lattice import axis_interpolation_matrix

    ptt = (importlib.import_module(f"{parent.__name__}.ops.transfer")
           if parent else None)
    out, bounds, library = {}, {}, {}
    abs_err = {"transfer_x": 0.0, "transfer_yz": 0.0}
    extra = {name: {"device_ms_by_shape": {}, "bound_ms_by_shape": {},
                    "library_ms_by_shape": {},
                    "parent_device_ms_by_shape": {} if parent else None,
                    "same_bits_as_parent_by_shape": {} if parent else None}
             for name in abs_err}
    for nc, pc, pf in ((42, 3, 6), (42, 1, 3)):
        I = torch.tensor(axis_interpolation_matrix(nc, pc, pf),
                         dtype=torch.float32, device="cuda")
        for direction in ("restrict", "prolong"):
            Mx, My, MzT = tt.transfer_mats((I, I, I), direction)
            n = nc * (pf if direction == "restrict" else pc) + 1
            A = Mx.shape[0]
            tag = f"{direction} {n}^3 -> {A}^3 (p {pc} <-> {pf})"
            rng = np.random.default_rng(SEED + n)
            x3 = torch.tensor(rng.standard_normal((n, n, n), dtype=np.float32),
                              device="cuda")
            t_ref = tt.plain_transfer_x(x3, Mx)
            y_ref = tt.plain_transfer_yz(t_ref, My, MzT)
            Mz = MzT.T.contiguous()        # the library call's operand
            lib_pair = lambda: torch.einsum("ax,by,cz,xyz->abc", Mx, My, Mz,
                                            x3)
            for name, got, ref in (
                    ("transfer_x", tt.transfer_x(x3, Mx), t_ref),
                    ("transfer_yz", tt.transfer_yz(t_ref, My, MzT), y_ref),
                    ("blocked_transfer", tt.blocked_transfer(x3, Mx, My, MzT),
                     y_ref),
                    ("library einsum", lib_pair(), y_ref)):
                torch.cuda.synchronize()
                err = rel_max_err(got, ref)
                print(f"    {tag} {name}: rel max err {err:.3e}")
                if not err <= KERNEL_RTOL:
                    raise AssertionError(f"{name} {tag}: relative max-norm "
                                         f"error {err:.3e} > {KERNEL_RTOL}")
                if name in abs_err:
                    abs_err[name] = max(abs_err[name],
                                        float((got - ref).abs().max()))
            bx = kernel_bound("transfer_x", 0, 0, dims=(n, n, n, A),
                              terms=range_terms(Mx, 0) * n * n)
            byz = kernel_bound("transfer_yz", 0, 0, dims=(A, n, n, A, A),
                               terms=A * (range_terms(My, 0) * n
                                          + A * range_terms(MzT, 1)))
            ms_k, ms_p, four = turns(
                lambda: tt.plain_transfer(x3, Mx, My, MzT),
                lambda: tt.blocked_transfer(x3, Mx, My, MzT))
            ms_l = cuda_ms(lib_pair, reps=5, warmup=1)
            print(f"    {tag}: kernels {ms_k:.4f} ms, plain {ms_p:.4f} ms "
                  f"(turns {[round(t, 4) for t in four]}), library "
                  f"{ms_l:.4f} ms, bound {bx[0] + byz[0]:.4f} ms "
                  f"(transfer_x {bx[0]:.4f} {bx[1]}, transfer_yz "
                  f"{byz[0]:.4f} {byz[1]})")
            # Each kernel alone as device time; its library yardstick is
            # one call each.
            key = f"{direction} {n}^3 -> {A}^3"
            alone = {
                "transfer_x": (lambda: tt.transfer_x(x3, Mx),
                               lambda: torch.matmul(Mx, x3.view(n, -1)), bx),
                "transfer_yz": (lambda: tt.transfer_yz(t_ref, My, MzT),
                                lambda: torch.einsum("by,ayz,zc->abc", My,
                                                     t_ref, MzT), byz)}
            if parent:   # the parent's wrappers cache on their own copies
                pM = [M.clone() for M in (Mx, My, MzT)]
                palone = {
                    "transfer_x": lambda: ptt.transfer_x(x3, pM[0]),
                    "transfer_yz": lambda: ptt.transfer_yz(t_ref, pM[1],
                                                           pM[2])}
            for name, (kern, lib, bound) in alone.items():
                e = extra[name]
                dev, vs, par = device_ms(kern, parent and palone[name],
                                         bound[0])
                if par:
                    (e["parent_device_ms_by_shape"][key],
                     e["same_bits_as_parent_by_shape"][key]) = par
                e["device_ms_by_shape"][key] = dev
                e["bound_ms_by_shape"][key] = bound[0]
                lib_ms = e["library_ms_by_shape"][key] = cuda_ms(
                    lib, reps=5, warmup=1)
                print(f"    {key} {name}: device {dev:.4f} ms (CUDA graph of "
                      f"20 launches), {bound[0] / dev:.0%} of its bound "
                      f"{bound[0]:.4f} ms ({bound[1]}); library "
                      f"{lib_ms:.4f} ms{vs}")
            if hasattr(tt, "x_plan"):
                print(f"    {key} transfer_x plan (ring width, rows per "
                      f"block, columns per thread): {tt._x_launch(x3, Mx)[:3]}")
            if hasattr(tt, "yz_plan"):
                W, RB = tt.yz_plan(A, n, A, A, max(
                    tt.nonzero_width(My, 0), tt.nonzero_width(MzT, 1)),
                    tt._sms(x3.device))
                print(f"    {key} transfer_yz plan: ring width {W}, {RB} "
                      f"rows per block of 256 threads, "
                      f"{tt.yz_smem(W, RB, n, A)} B shared memory, "
                      f"{tt.yz_blocks_per_sm(W, RB, n, A)} blocks per SM")
            if (pf, direction) != (6, "restrict"):
                continue
            for name, (kern, _, _) in alone.items():
                extra[name]["device_ms"] = extra[name][
                    "device_ms_by_shape"][key]
                extra[name]["host_us_per_launch"] = host_us(kern)
                print(f"    {key} {name}: host us per launch (least of 5 "
                      f"x 1000 enqueued) "
                      f"{extra[name]['host_us_per_launch']:.2f}")
            # Each kernel alone on the fine restriction, the V-cycle's
            # largest transfer, in turns with its plain version.
            for name, plain in (
                    ("transfer_x", lambda: tt.plain_transfer_x(x3, Mx)),
                    ("transfer_yz", lambda: tt.plain_transfer_yz(t_ref, My,
                                                                 MzT))):
                kern, _, bound = alone[name]
                ms_k, ms_p, four = turns(plain, kern)
                library[name] = extra[name]["library_ms_by_shape"][key]
                out[name] = (abs_err[name], ms_k, ms_p)
                bounds[name] = bound
                print(f"    {tag} {name}: kernel {ms_k:.4f} ms vs plain "
                      f"{ms_p:.4f} ms (turns {[round(t, 4) for t in four]}), "
                      f"library {library[name]:.4f} ms, bound "
                      f"{bound[0]:.4f} ms ({bound[1]})")
    for name in abs_err:
        out[name] = (abs_err[name],) + out[name][1:]
    return out, bounds, library, extra


def kron_fused_path(parent=None):
    """Phase 3d: ``PallasKronLaplacian`` at 2,048,383 dofs, p=6. Returns
    ({"kron_fused": (max_abs_err, ms, plain_ms)}, launches on the path,
    (bound_ms, by), the kernels line's extra keys): then `kron_fused_device`
    at 127^3 and 253^3."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.ops import kron_fused as kf

    mesh, P = BoxMesh((21, 21, 21)), 6
    x = torch.tensor(np.random.default_rng(SEED + 12).standard_normal(
        mesh.num_dofs(P), dtype=np.float32), device="cuda")
    for k in kf.LAUNCHES:
        kf.LAUNCHES[k] = 0
    op = kf.PallasKronLaplacian(mesh, P, kappa=2.0, device="cuda")
    y = op(x)
    ms_path = cuda_ms(lambda: op(x), reps=50)
    torch.cuda.synchronize()
    launches = kf.LAUNCHES["kron_fused"]
    N = op.ndofs
    print(f"    {op.shape} ({N} dofs): {ms_path:.4f} ms per apply = "
          f"{N / ms_path / 1e6:.3f} GDOF/s (50 back-to-back); launches "
          f"{launches}")
    if not (launches > 0 and tuple(y.shape) == (N,)
            and bool(torch.isfinite(y).all())):
        raise AssertionError(f"PallasKronLaplacian: launches {launches}, "
                             f"shape {tuple(y.shape)}")
    x3 = x.reshape(op.shape)
    ref = kf.plain_kron_fused(x3, op.bc3, op.Ks, op.planes).reshape(-1)
    err = rel_max_err(y, ref)
    opb = kb.PallasKronBlocked(mesh, P, kappa=2.0, device="cuda")
    yb = opb(x)
    torch.cuda.synchronize()
    d = rel_max_err(y, yb)
    print(f"    kron_fused vs plain: rel max err {err:.3e}; vs "
          f"PallasKronBlocked: {d:.3e}")
    if not err <= KERNEL_RTOL:
        raise AssertionError(f"kron_fused: {err:.3e} > {KERNEL_RTOL}")
    if not d <= 1e-4:
        raise AssertionError(f"PallasKronLaplacian and PallasKronBlocked "
                             f"differ: {d:.3e}")
    ms_k, ms_p, four = turns(
        lambda: kf.plain_kron_fused(x3, op.bc3, op.Ks, op.planes),
        lambda: kf.kron_fused(x3, op.bc3, op.Ks, op.planes, op.ranges))
    ms_b = cuda_ms(lambda: opb(x3))
    terms = sum(range_terms(K, 0) * N // n for K, n in zip(op.Ks, op.shape))
    bound = kernel_bound("kron_fused", N, P, dims=op.shape, terms=terms)
    print(f"    kron_fused: kernel {ms_k:.4f} ms vs plain {ms_p:.4f} ms "
          f"(turns {[round(t, 4) for t in four]}); PallasKronBlocked "
          f"{ms_b:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]})")
    err_abs = float((y - ref).abs().max())
    del op, opb, y, yb, ref
    extra = {"device_ms_by_shape": {}, "bound_ms_by_shape": {},
             "blocked_device_ms_by_shape": {},
             "parent_device_ms_by_shape": {} if parent else None,
             "same_bits_as_parent_by_shape": {} if parent else None}
    for nc in (21, 42):
        err_abs = max(err_abs, kron_fused_device(nc, extra, parent))
    extra["device_ms"] = extra["device_ms_by_shape"]["127^3"]
    return {"kron_fused": (err_abs, ms_k, ms_p)}, launches, bound, extra


def kron_fused_device(nc, extra, parent=None):
    """Phase 3d at ``BoxMesh((nc,) * 3)``, p=6: kernel #12 within 1e-5 of
    its plain version and 1e-4 of ``PallasKronBlocked`` (#1 + #2, the same
    operator in two launches) on a seeded x, then its device time
    (`graph_ms`) beside its bound, the blocked apply's device time and,
    with the parent's package, the parent's device time in turns (parent,
    change, change, parent) and whether both give the same bits; into
    ``extra``. Returns the largest absolute error against the plain
    version."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.ops import kron_fused as kf

    mesh, P = BoxMesh((nc,) * 3), 6
    op = kf.PallasKronLaplacian(mesh, P, kappa=2.0, device="cuda")
    N, key = op.ndofs, f"{op.shape[0]}^3"
    x = torch.tensor(np.random.default_rng(SEED + nc).standard_normal(
        N, dtype=np.float32), device="cuda")
    x3 = x.reshape(op.shape)

    def kern():
        return kf.kron_fused(x3, op.bc3, op.Ks, op.planes, op.ranges)

    got = kern()
    ref = kf.plain_kron_fused(x3, op.bc3, op.Ks, op.planes)
    opb = kb.PallasKronBlocked(mesh, P, kappa=2.0, device="cuda")
    torch.cuda.synchronize()
    err = rel_max_err(got, ref)
    d = rel_max_err(got.reshape(-1), opb(x))
    print(f"    {key} ({N} dofs) kron_fused vs plain: rel max err "
          f"{err:.3e}; vs PallasKronBlocked {d:.3e}; plan (band, chunk) "
          f"{kf.fused_plan(op.shape, op.band, kf._sms(x.device))}")
    if not (err <= KERNEL_RTOL and d <= 1e-4):
        raise AssertionError(f"kron_fused at {key}: {err:.3e} against its "
                             f"plain version, {d:.3e} against the blocked "
                             "apply")
    err_abs = float((got - ref).abs().max())
    del ref, got
    terms = sum(range_terms(K, 0) * N // n for K, n in zip(op.Ks, op.shape))
    bound, by = kernel_bound("kron_fused", N, P, dims=op.shape, terms=terms)
    if parent:
        pkf = importlib.import_module(f"{parent.__name__}.ops.kron_fused")
        pop = pkf.PallasKronLaplacian(mesh, P, kappa=2.0, device="cuda")

        def par():
            return pkf.kron_fused(x3, pop.bc3, pop.Ks, pop.planes,
                                  pop.ranges)

        dev, vs, (pdev, same) = device_ms(kern, par, bound)
        extra["parent_device_ms_by_shape"][key] = pdev
        extra["same_bits_as_parent_by_shape"][key] = same
        del pop
    else:
        dev, vs, _ = device_ms(kern)
    blocked = graph_ms(lambda: opb(x))
    extra["device_ms_by_shape"][key] = dev
    extra["bound_ms_by_shape"][key] = bound
    extra["blocked_device_ms_by_shape"][key] = blocked
    print(f"    {key} kron_fused: device {dev:.4f} ms (CUDA graph of 20 "
          f"launches), {bound / dev:.0%} of its bound {bound:.4f} ms ({by}), "
          f"{N / dev / 1e6:.3f} GDOF/s; PallasKronBlocked (#1 + #2) device "
          f"{blocked:.4f} ms{vs}")
    return err_abs


def lattice_kernel_ms(by_name):
    """{kernel: ms} of the lattice kernels in a `profile_busy` split: the
    march (``lattice_march``, or the cells pass ``lattice_cells`` of
    earlier commits) and the fold (``lattice_faces``, or ``lattice_fold``
    over the whole lattice)."""
    out = {"march": 0.0, "fold": 0.0}
    for name, ms in by_name.items():
        if "lattice_march" in name or "lattice_cells" in name:
            out["march"] += ms
        elif "lattice_faces" in name or "lattice_fold" in name:
            out["fold"] += ms
    return out


def lattice_device(lb, name, fn, N, P, nc):
    """Device time of one lattice kernel's apply (`graph_ms`), its bound,
    host us per launch and (on the one-launch design) its box, blocks per
    SM and face scratch; printed and returned as a dict.
    (`tools/lattice_bench_torch.py` splits the time by kernel.)"""
    dev = graph_ms(fn)
    bound, by = kernel_bound(name, N, P, nc=nc)
    rec = {"device_ms": dev, "bound_ms": bound, "bound_by": by,
           "host_us": host_us(fn, calls=200)}
    if hasattr(lb, "lattice_plan"):
        zb = lb.select_zgroup(nc[2], P) if name == "lattice_apply_zgrp" \
            else None
        plan = lb.lattice_plan(nc, P, zb)
        nbytes, faces = lb.face_scratch_bytes(nc, P, plan)
        rec.update(box=list(plan), face_scratch_bytes=nbytes,
                   face_kernel_threads=faces, blocks_per_sm=lb.blocks_per_sm(
                       name, P, plan))
    print(f"    {name} nc={nc[0]} p={P}: device {dev:.4f} ms (bound "
          f"{bound:.4f} ms, {by}: {bound / dev:.0%}); host "
          f"{rec['host_us']:.1f} us per launch"
          + ("" if "box" not in rec else
             f"; box {tuple(rec['box'])}, {rec['blocks_per_sm']} blocks/SM,"
             f" face scratch {rec['face_scratch_bytes'] / 1e6:.2f} MB, "
             f"face kernel {rec['face_kernel_threads']} threads"))
    return rec


def lattice_parity(mesh, P, geom, zgrp=False):
    """Phase 6 at one size: K-A under each variant name (K-B when
    ``geom``, K-A on the z-grouped geometry when ``zgrp``) against the
    plain versions; returns ({kernel: (max_abs_err, ms, plain_ms)},
    {kernel: `lattice_device` record})."""
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
    Gq = geometry_to_qlattice(scale_G(G_cells, kc, None), nc, P)
    Gt = torch.tensor(lb.geometry_to_gfirst(Gq), dtype=torch.float32,
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
    y1 = lb.blocked_lattice_apply(x, mats, Gt, bc, nc, P)
    same = bool(torch.equal(y1, lb.blocked_lattice_apply(x, mats, Gt, bc, nc,
                                                         P)))
    print(f"    {tag} lattice_apply: two applies bitwise equal: {same}")
    if not same:
        raise AssertionError(f"lattice_apply at {tag}: two applies differ")
    del y1
    dev = {"lattice_apply": lattice_device(
        lb, "lattice_apply", lambda: lb.blocked_lattice_apply(
            x, mats, Gt, bc, nc, P), x.numel(), P, nc)}
    if zgrp:
        # K-A on Gz read in place: the same sums on the same values as on
        # Gt; its box holds within a z-group, so where that box differs
        # from Gt's the fold adds in another order (last bits only).
        y_gt = lb.blocked_lattice_apply(x, mats, Gt, bc, nc, P)
        del Gt, ref
        zb = lb.select_zgroup(nc[2], P)
        Gz = torch.tensor(lb.geometry_to_zgrouped(Gq, zb, P),
                          dtype=torch.float32, device="cuda")
        zmats = lb.zgroup_matrices(zb, P, device="cuda")
        ref = lb.plain_lattice_apply_zgrp(x, mats, Gz, bc, nc, P, zb)
        got = lb.blocked_lattice_apply_zgrp(x, mats, zmats, Gz, bc, nc, P, zb)
        torch.cuda.synchronize()
        err, d = rel_max_err(got, ref), rel_max_err(got, y_gt)
        print(f"    {tag} lattice_apply_zgrp (zb={zb}): rel max err "
              f"{err:.3e}; vs K-A on Gt {d:.3e} (bitwise equal: "
              f"{bool(torch.equal(got, y_gt))})")
        if not (err <= KERNEL_RTOL and d <= KERNEL_RTOL):
            raise AssertionError(f"lattice_apply_zgrp at {tag}: {err:.3e}, "
                                 f"vs K-A {d:.3e}")
        abs_err = float((got - ref).abs().max())
        del ref, got, y_gt
        ms_k, ms_p, four = turns(
            lambda: lb.plain_lattice_apply_zgrp(x, mats, Gz, bc, nc, P, zb),
            lambda: lb.blocked_lattice_apply_zgrp(x, mats, zmats, Gz, bc, nc,
                                                  P, zb))
        print(f"    {tag} lattice_apply_zgrp: kernel {ms_k:.4f} ms vs plain "
              f"{ms_p:.4f} ms (turns {[round(t, 4) for t in four]}); "
              f"{x.numel() / ms_k / 1e6:.3f} GDOF/s")
        out["lattice_apply_zgrp"] = (abs_err, ms_k, ms_p)
        dev["lattice_apply_zgrp"] = lattice_device(
            lb, "lattice_apply_zgrp", lambda: lb.blocked_lattice_apply_zgrp(
                x, mats, zmats, Gz, bc, nc, P, zb), x.numel(), P, nc)
        del Gz
    else:
        del Gt, ref
    del Gq
    if geom:
        co = torch.tensor(lb.lattice_geom_coefficients(mesh, P, kc),
                          dtype=torch.float32, device="cuda")
        geom, xi, wx = lb.lattice_geom_data(nc, P, device="cuda")
        ref = lb.plain_lattice_apply_geom(x, mats, co, bc, nc, P)
        got = lb.blocked_lattice_apply_geom(x, mats, co, geom, bc, nc, P,
                                            xi=xi, wx=wx)
        torch.cuda.synchronize()
        err = rel_max_err(got, ref)
        print(f"    {tag} lattice_apply_geom: rel max err {err:.3e}")
        if not err <= KERNEL_RTOL:
            raise AssertionError(f"lattice_apply_geom at {tag}: {err:.3e}")
        abs_err = float((got - ref).abs().max())
        del ref, got
        ms_k, ms_p, four = turns(
            lambda: lb.plain_lattice_apply_geom(x, mats, co, bc, nc, P),
            lambda: lb.blocked_lattice_apply_geom(x, mats, co, geom, bc, nc,
                                                  P, xi=xi, wx=wx))
        print(f"    {tag} lattice_apply_geom: kernel {ms_k:.4f} ms vs "
              f"plain {ms_p:.4f} ms (turns {[round(t, 4) for t in four]}); "
              f"{x.numel() / ms_k / 1e6:.3f} GDOF/s")
        out["lattice_apply_geom"] = (abs_err, ms_k, ms_p)
        dev["lattice_apply_geom"] = lattice_device(
            lb, "lattice_apply_geom", lambda: lb.blocked_lattice_apply_geom(
                x, mats, co, geom, bc, nc, P, xi=xi, wx=wx), x.numel(), P,
            nc)
    return out, dev


def zgrp_small():
    """Phase 6: ``PallasLatticeBlocked(variant="zgrp")`` with zb in {2, 3}
    on a small curved mesh (ncz = 6) against its plain version and K-A."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_tpu_torch.ops import lattice_blocked as lb

    mesh, P = PerturbedBoxMesh((5, 4, 6)), 6
    k_a = lb.PallasLatticeBlocked(mesh, P, kappa=2.0, device="cuda")
    x = torch.tensor(np.random.default_rng(SEED + 16).standard_normal(
        k_a.ndofs, dtype=np.float32), device="cuda")
    y_a = k_a(x)
    for zb in (2, 3):
        op = lb.PallasLatticeBlocked(mesh, P, kappa=2.0, variant="zgrp",
                                     zb=zb, device="cuda")
        got = op(x)
        ref = lb.plain_lattice_apply_zgrp(x, op.mats, op.Gz, op.bc_marker,
                                          mesh.nc, P, zb)
        torch.cuda.synchronize()
        err, d = rel_max_err(got, ref), rel_max_err(got, y_a)
        print(f"    {mesh.nc} p={P} zgrp zb={zb}: rel max err {err:.3e}; vs "
              f"K-A {d:.3e}")
        if not (err <= KERNEL_RTOL and d <= KERNEL_RTOL):
            raise AssertionError(f"zgrp zb={zb}: {err:.3e}, vs K-A {d:.3e}")


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


def run_mat_free(args, mesh=None):
    """Runs ``examples/mat_free_torch.py`` in this process (so its kernel
    launches count here) and returns its last JSON line. With ``mesh``,
    the ``PerturbedBoxMesh`` the example builds for the same cells is that
    instance, so its cached host geometry factors are not computed
    again."""
    from pmg_dolfinx_tpu_torch.fem import mesh as fem_mesh

    spec = importlib.util.spec_from_file_location(
        "mat_free_torch", ROOT / "examples" / "mat_free_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def reuse(nc):
        if tuple(nc) != tuple(mesh.nc):
            raise AssertionError(f"mat_free built {nc}, not {mesh.nc}")
        return mesh

    argv, saved, buf = sys.argv, fem_mesh.PerturbedBoxMesh, io.StringIO()
    sys.argv = ["mat_free_torch.py", *args]
    if mesh is not None:
        fem_mesh.PerturbedBoxMesh = reuse
    try:
        with contextlib.redirect_stdout(buf):
            mod.main()
    finally:
        sys.argv, fem_mesh.PerturbedBoxMesh = argv, saved
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


def vcycle_pace(hier, cycles=10, reps=5):
    """Who sets the pace of back-to-back V-cycles: per rep of ``cycles``
    cycles, (CUDA-event ms per cycle, host ms per cycle to enqueue them).
    Host ms well under the event ms: the card sets the pace; host ms near
    it: the host does, and the cycle's wall time follows the host's speed."""
    import torch

    b = torch.ones(hier.levels[-1].ndofs, dtype=hier.dtype,
                   device=hier.device)
    u = torch.zeros_like(b)
    for _ in range(2):
        hier.apply(b, u)
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        for _ in range(cycles):
            hier.apply(b, u)
        host = (time.perf_counter() - t0) * 1e3 / cycles
        end.record()
        end.synchronize()
        out.append((start.elapsed_time(end) / cycles, host))
    return out


@contextlib.contextmanager
def plain_packed():
    """Run the serving classes on their plain torch versions on the card
    (the in-card reference): the module's two entry points are swapped
    for the plain functions while the block runs."""
    from pmg_dolfinx_tpu_torch.ops import kron_packed as kp

    saved = kp.packed_apply, kp.packed_fdm
    kp.packed_apply, kp.packed_fdm = kp.plain_packed_apply, kp.plain_packed_fdm
    try:
        yield
    finally:
        kp.packed_apply, kp.packed_fdm = saved


def profile_busy(fn, counts=None):
    """One call of ``fn`` under `torch.profiler`: (wall ms, device busy ms
    = the sum of kernel durations (one stream, no overlap), kernel count,
    {kernel name: ms}); ``counts``, when given, gets {kernel name:
    launches}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        if counts is not None:
            counts[e.name] = counts.get(e.name, 0) + 1
    return wall, sum(by_name.values()), len(kernels), by_name


def profile_complete(fn, lb, tries=8):
    """`profile_busy` of one call of ``fn`` (a curved V-cycle) from a
    complete window. Late in a long process the profiler can leave out
    some of a window's kernels (here phase 7 misses two of the cycle's
    seven p=6 applies in every window; a fresh process on the same mesh
    keeps them all, `tools/lattice_bench_torch.py --vcycle`), so a window
    is read as complete only when its lattice kernels number what the
    wrappers counted for the call (`lb.LAUNCHES`:
    each apply is one march, or cells, kernel and one fold, or faces,
    kernel; every level of the curved cycle has faces between boxes) and
    its kernel count equals an earlier window's. Returns (wall, busy, kernels,
    {name: ms}, {name: launches}, windows tried, complete)."""
    seen, last = [], None
    for tries_made in range(1, tries + 1):
        before = sum(lb.LAUNCHES.values())
        calls = {}
        wall, busy, nk, by_name = profile_busy(fn, calls)
        applies = sum(lb.LAUNCHES.values()) - before
        march = sum(n for k, n in calls.items()
                    if "lattice_march" in k or "lattice_cells" in k)
        fold = sum(n for k, n in calls.items()
                   if "lattice_faces" in k or "lattice_fold" in k)
        complete = march == applies and fold == applies and nk in seen
        print(f"    profile window {tries_made}: {nk} kernels, lattice "
              f"{march} + {fold} for {applies} applies"
              + (" (complete)" if complete else ""))
        seen.append(nk)
        last = (wall, busy, nk, by_name, calls, tries_made, complete)
        if complete:
            break
    return last


def fused_kernel_ms(by_name):
    """{kernel: ms} of kernels #4, #7, #10 and #11 in a `profile_busy`
    split, by the name the profiler gives each launch (template arguments
    demangled, ``kron_t1_m<6, true>``, or mangled, ``kron_t1_mILi6ELb1E``;
    the tiled #4 of earlier commits is ``kron_t1``)."""
    import re

    def kid(n):
        if "transfer_yz" in n:
            return "#11 transfer_yz"
        if "transfer_x" in n:
            return "#10 transfer_x"
        if "kron_t23<2" in n or "kron_t23ILi2E" in n:
            return "#7 t23_cheb"
        if ("kron_t1_m" in n and ("true>" in n or "Lb1E" in n)) or re.search(
                r"kron_t1(?!_m)", n):
            return "#4 t1"
        return None

    out = {k: 0.0 for k in ("#4 t1", "#7 t23_cheb", "#10 transfer_x",
                            "#11 transfer_yz")}
    for name, ms in by_name.items():
        k = kid(name)
        if k is not None:
            out[k] += ms
    return out


# The parent commit's printed trajectories (relative residuals of the 10
# stationary cycles, as printed) and FCG(V) counts in phases 4b, 4e and
# 7, from the parent's package under this script on an NVIDIA H100 80GB
# HBM3 at 700 W: kernels that keep every sum's order repeat them digit
# for digit; phase 7's lattice kernels fold in another order, so its
# trajectory is held to 1e-3 of the parent's (`parent_gate`).
_FUSED_SMOOTHER_REL = ["8.7404e-02", "2.3993e-02", "9.4998e-03", "3.9849e-03",
                       "1.8904e-03", "1.2124e-03", "1.0516e-03", "9.5400e-04",
                       "9.0908e-04", "8.8960e-04"]
PARENT_RUNS = {
    "4b fuse_smoother": (_FUSED_SMOOTHER_REL, 5),
    "4e fuse_transfers": (["8.7404e-02", "2.3993e-02", "9.4996e-03",
                           "3.9843e-03", "1.8888e-03", "1.2122e-03",
                           "1.0527e-03", "9.5441e-04", "9.1710e-04",
                           "8.9045e-04"], 5),
    "4e fuse_transfers + fuse_smoother": (_FUSED_SMOOTHER_REL, 5),
    "7 curved": (["1.0156e-01", "2.8758e-02", "1.1751e-02", "5.1864e-03",
                  "2.4541e-03", "1.3631e-03", "1.0296e-03", "8.3217e-04",
                  "7.2670e-04", "6.9319e-04"], 7),
}


def against_parent(tag, rel, niter):
    """Print whether ``rel`` and ``niter`` repeat the parent's as printed
    (`PARENT_RUNS`); the phase's own gates decide pass or fail."""
    ref = PARENT_RUNS.get(tag)
    if ref is None:
        print(f"    {tag}: no parent values to compare with")
        return
    same = [f"{v:.4e}" for v in rel] == ref[0] and niter == ref[1]
    diff = max(abs(v - float(r)) / float(r) for v, r in zip(rel, ref[0]))
    print(f"    {tag}: trajectory and FCG(V) "
          f"{'equal' if same else 'differ from'} the parent's as printed "
          f"(max rel diff from its 4 printed digits {diff:.1e}; parent "
          f"FCG(V) {ref[1]})")


def parent_gate(tag, rel, niter, rtol=1e-3):
    """Raise unless ``rel`` keeps within ``rtol`` of the parent's printed
    trajectory (`PARENT_RUNS`) on every cycle above `REF_TRAJ_FROM` and
    ``niter`` within one iteration of the parent's FCG(V) count: a
    changed summation order moves the last bits only."""
    ref = PARENT_RUNS.get(tag)
    if ref is None:
        return
    diff = traj_diff(rel, [float(v) for v in ref[0]])
    print(f"    {tag}: trajectory max rel diff from the parent's "
          f"{diff:.3e} (gate {rtol:g}); FCG(V) {niter} vs {ref[1]}")
    if not (diff <= rtol and abs(niter - ref[1]) <= 1):
        raise AssertionError(f"{tag}: trajectory {diff:.3e} or FCG(V) "
                             f"{niter} vs {ref[1]} off the parent's")


PACKED_NC = (10, 10, 10)     # 61^3 at p=6: 226,981 dofs, the serving size
PACKED_P = 6
PACKED_BATCHES = (1, 8, 64)  # B=64 (58 MB) is more than the card's L2
MIXED = ((True, False), (False, False), (True, True))


def load_parent(root):
    """The ``pmg_dolfinx_tpu_torch`` package of the checkout at ``root``,
    imported as ``pmg_parent`` (its kernels build from its own sources
    into its own ``build/``), or None without ``root``."""
    if root is None:
        return None
    sys.path.insert(0, str(ROOT / "tools"))
    from host_cost_torch import load

    return load(root, "pmg_parent")


def packed_ops(pkg, mesh, P, B, U):
    """{kernel: (call, the call's operand dict)} of the serving classes of
    package ``pkg`` (a module) at batch ``B`` on ``U`` (sigma = 0):
    the single classes at B = 1, the batch classes above."""
    kp = importlib.import_module(f"{pkg.__name__}.ops.kron_packed")
    if B == 1:
        op = kp.PackedKronSingle(mesh, P, kappa=2.0, device="cuda")
        fdm = kp.PackedFDMSingle(mesh, P, kappa=2.0, device="cuda")
        return {"packed_apply": (lambda: op.apply_packed(U[0])[None], op),
                "packed_fdm": (lambda: fdm.solve_packed(U[0])[None], fdm)}
    op = kp.PackedKronBatch(mesh, P, kappa=2.0, B=B, device="cuda")
    fdm = kp.PackedFDMBatch(mesh, P, kappa=2.0, B=B, device="cuda")
    return {"packed_apply": (lambda: op.apply_packed(U), op),
            "packed_fdm": (lambda: fdm.solve_packed(U), fdm)}


def kernels_per_call(fn, counts=None, windows=5):
    """The kernels one call of ``fn`` launches: the most any of
    ``windows`` one-call `profile_busy` windows shows (the profiler can
    leave a window's first kernels out, never add one), or None when every
    window came back empty (late in a long process, §7 of PERF.md);
    ``counts`` gets that window's {kernel name: launches}."""
    best, best_counts = 0, {}
    for _ in range(windows):
        c = {}
        n = profile_busy(fn, c)[2]
        if n > best:
            best, best_counts = n, c
    if counts is not None:
        counts.update(best_counts)
    return best or None


def packed_parity(parent=None):
    """Phase 10: both serving kernels through the four classes at 61^3;
    returns ({kernel: (max_abs_err, ms, plain_ms)} at B=8, {kernel: the
    kernels line's extra keys}): device time (`graph_ms`) at each batch
    of `PACKED_BATCHES` beside the bound, kernels per call (profiler),
    host us per call at B=1, and, with the parent's package ``parent``,
    the parent's device time in turns (parent, change, change, parent),
    its kernels and host us per call, and whether both give the same
    bits."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.ops import kron_packed as kp

    import pmg_dolfinx_tpu_torch as this

    P = PACKED_P
    mesh = BoxMesh(PACKED_NC)
    shape, n = mesh.lattice_shape(P), mesh.num_dofs(P)
    out = {"packed_apply": [0.0, None, None], "packed_fdm": [0.0, None, None]}
    extra = {k: {"device_ms_by_batch": {}, "bound_ms_by_batch": {},
                 "bound_share_by_batch": {}, "plain_ms_by_batch": {},
                 "parent_device_ms_by_batch": {} if parent else None,
                 "same_bits_as_parent_by_batch": {} if parent else None}
             for k in out}

    def check(name, tag, got, ref, tol=KERNEL_RTOL):
        torch.cuda.synchronize()
        err = rel_max_err(got, ref)
        out[name][0] = max(out[name][0], float((got - ref).abs().max()))
        print(f"    {tag}: rel max err {err:.3e}")
        if not err <= tol:
            raise AssertionError(f"{tag}: relative max-norm error {err:.3e} "
                                 f"> {tol}")

    for B in PACKED_BATCHES:
        rng = np.random.default_rng(SEED + B)
        U = torch.tensor(rng.standard_normal((B,) + shape, dtype=np.float32),
                         device="cuda")
        ops = {}
        for sigma in (0.0, 1e3):
            if B == 1:
                op = kp.PackedKronSingle(mesh, P, kappa=2.0, sigma=sigma,
                                         device="cuda")
                got = op.apply_packed(U[0])[None]
            else:
                op = kp.PackedKronBatch(mesh, P, kappa=2.0, B=B, sigma=sigma,
                                        device="cuda")
                got = op.apply_packed(U)
            ops[sigma] = op
            check("packed_apply", f"{type(op).__name__} B={B} sigma={sigma:g}",
                  got, kp.plain_packed_apply(U, op.mats, sigma))
        calls = packed_ops(this, mesh, P, B, U)
        solve, fdm = calls["packed_fdm"]
        check("packed_fdm", f"{type(fdm).__name__} B={B}", solve(),
              kp.plain_packed_fdm(U, fdm.mats))
        x = ops[0.0].pack(solve()) if B > 1 else solve()
        back = (ops[0.0].apply_packed(x) if B > 1
                else ops[0.0].apply_packed(x[0])[None])
        torch.cuda.synchronize()
        inv = rel_max_err(back, U)
        print(f"    B={B}: apply(solve(b)) vs b: rel max err {inv:.3e}")
        if not inv <= 1e-4:
            raise AssertionError(f"the FDM is not the apply's inverse: {inv}")
        pcalls = packed_ops(parent, mesh, P, B, U) if parent else None
        for name, (kern, obj) in calls.items():
            plain = ((lambda: kp.plain_packed_apply(U, obj.mats))
                     if name == "packed_apply" else
                     (lambda: kp.plain_packed_fdm(U, obj.mats)))
            ms_k, ms_p, four = turns(plain, kern)
            bound, by = kernel_bound(name, n, P, B=B, dims=shape)
            e = extra[name]
            dev, vs, par = device_ms(kern, pcalls and pcalls[name][0])
            if par:
                (e["parent_device_ms_by_batch"][str(B)],
                 e["same_bits_as_parent_by_batch"][str(B)]) = par
            e["device_ms_by_batch"][str(B)] = dev
            e["bound_ms_by_batch"][str(B)] = bound
            e["bound_share_by_batch"][str(B)] = bound / dev
            e["plain_ms_by_batch"][str(B)] = ms_p
            print(f"    B={B} {name}: device {dev:.4f} ms, bound {bound:.4f} "
                  f"ms ({by}), {bound / dev:.0%} of it{vs}; host-issued "
                  f"{ms_k:.4f} ms vs plain {ms_p:.4f} ms (turns "
                  f"{[round(t, 4) for t in four]}); "
                  f"{B * n / dev / 1e6:.3f} GDOF/s, {dev / B:.5f} ms per RHS")
            if B == 8:
                out[name][1:] = [ms_k, ms_p]
                e["device_ms"] = dev
            if B == 1:
                counts = {}
                nk = kernels_per_call(kern, counts)
                e["kernels_per_call"] = nk
                e["host_us_per_call"] = host_us(kern)
                kpc = ("kernels per call not measured (empty profiler "
                       "windows)" if nk is None else
                       f"{nk} kernels per call ("
                       + ", ".join(k[:32] for k in counts) + ")")
                line = (f"    B=1 {name}: {kpc}, host "
                        f"{e['host_us_per_call']:.2f} us per call")
                if pcalls:
                    par = pcalls[name][0]
                    e["parent_kernels_per_call"] = kernels_per_call(par)
                    e["parent_host_us_per_call"] = host_us(par)
                    line += (f"; parent {e['parent_kernels_per_call']} "
                             f"kernels, {e['parent_host_us_per_call']:.2f} us")
                print(line)
    for B in (1, 8, 64):
        print("    " + ", ".join(
            f"{k} launch plan at B={B}: {v}" for k, v in (
                ("packed_apply", kp.apply_plan(
                    B, shape, PACKED_P, kp._sms(torch.device("cuda", 0)),
                    kp._resident(torch.device("cuda", 0), PACKED_P,
                                 shape[2], shape[0]))),
                ("packed_fdm", kp.fdm_launch_plan(B, shape)))))
    mixed = BoxMesh(PACKED_NC, dirichlet_faces=MIXED)
    U = torch.tensor(np.random.default_rng(SEED).standard_normal(
        (8,) + shape, dtype=np.float32), device="cuda")
    op = kp.PackedKronBatch(mixed, P, kappa=2.0, B=8, sigma=1e3,
                            device="cuda")
    fdm = kp.PackedFDMBatch(mixed, P, kappa=2.0, B=8, sigma=1e3,
                            device="cuda")
    check("packed_apply", "mixed faces PackedKronBatch B=8 sigma=1e3",
          op.apply_packed(U), kp.plain_packed_apply(U, op.mats, 1e3))
    check("packed_fdm", "mixed faces PackedFDMBatch B=8 sigma=1e3",
          fdm.solve_packed(U), kp.plain_packed_fdm(U, fdm.mats))
    return {k: tuple(v) for k, v in out.items()}, extra


SERVING_STEPS = 2000
SERVING_CONFIGS = (("heat", 1), ("heat", 8), ("leapfrog", 1), ("leapfrog", 8),
                   ("newmark", 1))


def serving_path(parent=None):
    """Phase 11: the README's serving configuration; returns the launches
    of both kernels over the timed and profiled runs. With the parent's
    package ``parent``, each configuration's 100 profiled steps also run
    on it, in turns (change, parent, parent, change)."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import l2_error
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.ops import kron_packed as kp
    from pmg_dolfinx_tpu_torch.solvers import transient
    from pmg_dolfinx_tpu_torch.solvers.transient import wave_stable_dt

    P, kappa = PACKED_P, 2.0
    mesh = BoxMesh(PACKED_NC)
    n = mesh.num_dofs(P)
    c = mesh.dof_coords(P)
    u0 = (np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
          * np.sin(np.pi * c[:, 2]))
    dt_wave = 0.72 * wave_stable_dt(mesh, P, kappa=kappa)
    lam, omega = 3.0 * np.pi**2 * kappa, np.pi * np.sqrt(3.0 * kappa)
    print(f"    mesh {PACKED_NC} p={P} ({n} dofs); wave dt {dt_wave:.4e} "
          "(0.72 x wave_stable_dt)")
    ptr = (importlib.import_module(f"{parent.__name__}.solvers.transient")
           if parent else None)
    total = {"packed_apply": 0, "packed_fdm": 0}
    for kind, B in SERVING_CONFIGS:
        heat = kind == "heat"
        dt = 1e-3 if heat else dt_wave
        U0 = torch.tensor(np.broadcast_to(u0, (B, n)), dtype=torch.float32,
                          device="cuda")

        def make(mod=transient):
            if heat:
                return mod.heat_packed_evolve(mesh, P, kappa=kappa, dt=dt,
                                              B=B, scheme="cn", device="cuda")
            return mod.wave_packed_evolve(mesh, P, kappa=kappa, dt=dt, B=B,
                                          scheme=kind, device="cuda")

        def run(ev, k):
            return ev(U0, k) if heat else ev(U0, torch.zeros_like(U0), k)[0]

        tag = f"{'heat CN' if heat else 'wave ' + kind} B={B}"
        for k in kp.LAUNCHES:
            kp.LAUNCHES[k] = 0
        ts = time.perf_counter()
        ev = make()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - ts
        run(ev, 20)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        UT = run(ev, SERVING_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - ts
        pw, busy, nk, by_name = profile_busy(lambda: run(ev, 100))
        launches = dict(kp.LAUNCHES)
        if tuple(UT.shape) != (B, n) or not bool(torch.isfinite(UT).all()):
            raise AssertionError(f"{tag}: the state is not finite (B, ndofs)")
        T = dt * SERVING_STEPS
        amp = np.exp(-lam * T) if heat else np.cos(omega * T)
        err = l2_error(mesh, P, UT[0].double().cpu().numpy(),
                       lambda x: amp * np.sin(np.pi * x[0])
                       * np.sin(np.pi * x[1]) * np.sin(np.pi * x[2]))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        print(f"    {tag}: {SERVING_STEPS} steps in {wall:.3f} s = "
              f"{SERVING_STEPS * B / wall:.1f} column-steps/s "
              f"({SERVING_STEPS / wall:.1f} steps/s); setup {setup_s:.2f} s; "
              f"L2 error at T={T:.4g}: {err:.4e}; launches {launches}")
        print(f"      profiled 100 steps: wall {pw / 100:.4f} ms/step, device "
              f"busy {busy / 100:.4f} ms/step ({nk / 100:.0f} kernels/step; "
              f"idle {max(0.0, 1 - busy / pw):.1%}); top: "
              + ", ".join(f"{k[:40]} {v / 100:.4f}" for k, v in top))
        if ptr is not None:
            pev = make(ptr)
            run(pev, 20)
            rows = []
            for who, e in (("change", ev), ("parent", pev), ("parent", pev),
                           ("change", ev)):
                pw2, busy2, nk2, _ = profile_busy(lambda: run(e, 100))
                rows.append(f"{who} {nk2 / 100:.0f} kernels/step, busy "
                            f"{busy2 / 100:.4f} ms/step, wall "
                            f"{pw2 / 100:.4f} ms/step")
            print("      in turns: " + "; ".join(rows))
        if not err < 1e-2:
            raise AssertionError(f"{tag}: L2 error {err}")
        need = ("packed_fdm",) if heat else (
            ("packed_apply",) if kind == "leapfrog" else
            ("packed_apply", "packed_fdm"))
        if not all(launches[k] > 0 for k in need):
            raise AssertionError(f"{tag}: a kernel was not launched: "
                                 f"{launches}")
        for k in total:
            total[k] += launches[k]
        # In-card reference: the same evolve on the plain versions. The CN
        # state falls below float32 range after 2000 steps, so heat is
        # compared after 200.
        nref = 200 if heat else SERVING_STEPS
        Uk = UT if nref == SERVING_STEPS else run(ev, nref)
        before = dict(kp.LAUNCHES)
        with plain_packed():
            Up = run(make(), nref)
        if kp.LAUNCHES != before:
            raise AssertionError(f"{tag}: the plain reference launched a "
                                 "kernel")
        d = rel_max_err(Uk, Up)
        print(f"      in-card reference ({nref} steps, plain versions): rel "
              f"max diff {d:.3e}")
        if not d <= 1e-4:
            raise AssertionError(f"{tag}: kernel and plain evolves differ {d}")
    return total


def heat_cn_2m():
    """Phase 12: the JAX bench's heat_cn_2M recipe on the port."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import l2_error
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.solvers.transient import heat_fdm_evolve

    mesh, P, dt = BoxMesh((42, 42, 42)), 3, 1e-4
    c = mesh.dof_coords(P)
    u0 = torch.tensor(np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
                      * np.sin(np.pi * c[:, 2]), dtype=torch.float32,
                      device="cuda")
    evolve = heat_fdm_evolve(mesh, P, kappa=2.0, dt=dt, scheme="cn",
                             dtype=torch.float32, device="cuda")

    def timed(k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u = evolve(u0, k)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, u

    lo, hi = 200, 1000
    timed(lo)
    timed(hi)
    samples = []
    for _ in range(3):
        t_lo, _ = timed(lo)
        t_hi, u = timed(hi)
        samples.append((t_hi - t_lo) / (hi - lo))
    per = sorted(samples)[1]
    T = hi * dt
    amp = np.exp(-3.0 * np.pi**2 * 2.0 * T)
    err = l2_error(mesh, P, u.double().cpu().numpy().reshape(-1),
                   lambda x: amp * np.sin(np.pi * x[0]) * np.sin(np.pi * x[1])
                   * np.sin(np.pi * x[2]))
    print(f"    {mesh.num_dofs(P)} dofs: {1.0 / per:.1f} steps/s "
          f"({per * 1e3:.4f} ms/step; slope samples "
          f"{[round(s * 1e3, 4) for s in samples]} ms); L2 error at "
          f"T={T:g}: {err:.4e}")
    if not (bool(torch.isfinite(u).all()) and err < 1e-3):
        raise AssertionError(f"heat_cn_2M: L2 error {err}")


def curved_stepper():
    """Phase 13: heat_pcg_evolve on a small curved mesh."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy
    from pmg_dolfinx_tpu_torch.solvers.transient import heat_pcg_evolve

    mesh, P, dt, kappa = PerturbedBoxMesh((19, 19, 19)), 3, 1e-3, 2.0
    ts = time.perf_counter()
    hier = PMGHierarchy(mesh, degrees=(1, P), kappa=kappa / 2,
                        sigma=1.0 / dt, dtype=torch.float32, coarse="cg",
                        operator="lattice", device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - ts
    c = mesh.dof_coords(P)
    u0 = (np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
          * np.sin(np.pi * c[:, 2]))
    ts = time.perf_counter()
    u, iters = heat_pcg_evolve(hier, mesh, P, dt, scheme="cn",
                               rtol=1e-6)(u0, 5)
    torch.cuda.synchronize()
    print(f"    {mesh.num_dofs(P)} dofs p={P}: setup {setup_s:.2f} s, 5 CN "
          f"steps {time.perf_counter() - ts:.2f} s (host clock); FCG "
          f"iterations per step {iters}")
    if not bool(torch.isfinite(u).all()) or max(iters) > 50:
        raise AssertionError(f"curved stepper: iterations {iters}")


def fused_path(prob, hier, rel_ref, u_ref, niter_ref, cfg, launches):
    """Phase 4b: the slice's path, ``PMGHierarchy(fuse_smoother=True)`` on
    phase 4's mesh and rhs; compared with phase 4's unfused hierarchy, its
    stationary residual trajectory ``rel_ref`` and FCG solution. Adds the
    launches of kernels #4 and #7 to ``launches``."""
    import torch

    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    for k in kb.LAUNCHES:
        kb.LAUNCHES[k] = 0
    ts = time.perf_counter()
    fused = PMGHierarchy(prob.mesh, operator="kron_blocked",
                         fuse_smoother=True, **cfg)
    torch.cuda.synchronize()
    print(f"    setup seconds: {time.perf_counter() - ts:.2f}  (lmax per "
          f"level {[float(lv['lmax']) for lv in fused.data['levels']]}; "
          "unfused "
          f"{[float(lv['lmax']) for lv in hier.data['levels']]})")
    r0 = float(torch.linalg.vector_norm(prob.b))
    ts = time.perf_counter()
    _, rn = fused.solve(prob.b, num_cycles=10)
    rel = [r / r0 for r in rn]
    print(f"    10 cycles ({time.perf_counter() - ts:.3f} s host clock): rel "
          f"{[f'{v:.4e}' for v in rel]}")
    hist = [1.0] + rel
    if not all(hist[i + 1] < hist[i] for i in range(4)):
        raise AssertionError(f"residual did not fall on cycles 1-4: {rel}")
    # Both hierarchies calibrate to the same lmax, so the two smoothers
    # differ only by f32 rounding above the stall floor.
    traj = traj_diff(rel, rel_ref)
    print(f"    fused vs unfused trajectory max rel diff (cycles above "
          f"{REF_TRAJ_FROM:g}): {traj:.3e}")
    if not traj <= FUSED_TRAJ_RTOL:
        raise AssertionError(f"fused and unfused trajectories differ: {traj}")
    ts = time.perf_counter()
    u, niter = fused.solve_pcg(prob.b, rtol=1e-6, maxiter=50)
    torch.cuda.synchronize()
    pcg_s = time.perf_counter() - ts
    main = dict(kb.LAUNCHES)
    print(f"    FCG(V) iterations to rtol 1e-6: {niter} ({pcg_s:.3f} s host "
          f"clock; unfused {niter_ref}); kernel launches on this path: {main}")
    if not (main["t1"] > 0 and main["t23_cheb"] > 0):
        raise AssertionError(f"the fused kernels were not launched: {main}")
    against_parent("4b fuse_smoother", rel, niter)
    launches.update(t1=main["t1"], t23_cheb=main["t23_cheb"])
    if abs(niter - niter_ref) > 1:
        raise AssertionError(f"FCG counts differ: {niter} vs {niter_ref}")
    if tuple(u.shape) != tuple(u_ref.shape) or not bool(
            torch.isfinite(u).all()):
        raise AssertionError("fused solution is not a finite vector of ndofs")
    du = float(torch.linalg.vector_norm(u - u_ref)
               / torch.linalg.vector_norm(u_ref))
    print(f"    fused vs unfused FCG solution: relative difference {du:.3e}")
    if not du <= 1e-3:
        raise AssertionError(f"fused and unfused solutions differ: {du}")
    # unfused, fused, fused, unfused: compare within this call only.
    t_u1, _ = vcycle_ms(hier)
    t_f1, all_f1 = vcycle_ms(fused)
    t_f2, all_f2 = vcycle_ms(fused)
    t_u2, _ = vcycle_ms(hier)
    print(f"    V-cycle: fused {(t_f1 + t_f2) / 2:.3f} ms ({t_f1:.3f}, "
          f"{t_f2:.3f}; reps {[round(t, 3) for t in all_f1 + all_f2]}) vs "
          f"unfused {(t_u1 + t_u2) / 2:.3f} ms ({t_u1:.3f}, {t_u2:.3f}); 10 "
          "back-to-back, median of 3, in turns unfused/fused/fused/unfused")
    b1 = torch.ones(fused.levels[-1].ndofs, dtype=torch.float32,
                    device="cuda")
    u0 = torch.zeros_like(b1)
    for tag, h, t_b2b in (("fused", fused, (t_f1 + t_f2) / 2),
                          ("unfused", hier, (t_u1 + t_u2) / 2)):
        pace = vcycle_pace(h)
        print(f"    {tag} V-cycle pace, 5 reps of 10 (CUDA-event ms, host ms "
              f"to enqueue): {[(round(e, 3), round(c, 3)) for e, c in pace]}")
        h.apply(b1, u0)
        wall, busy, nk, by_name = profile_busy(lambda: h.apply(b1, u0))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])
        print(f"    profile, one {tag} V-cycle: wall {wall:.3f} ms, device "
              f"busy {busy:.3f} ms, {nk} kernels, idle "
              f"{max(0.0, 1 - busy / wall):.1%}; of the back-to-back "
              f"{t_b2b:.3f} ms: idle {max(0.0, 1 - busy / t_b2b):.1%}")
        for kname, ms in top[:10]:
            print(f"      {ms:8.4f} ms {ms / busy:6.1%}  {kname[:90]}")
        print(f"    {tag} V-cycle, busy {busy:.4f} ms per cycle: "
              + ", ".join(f"{k} {v:.4f} ms"
                          for k, v in fused_kernel_ms(by_name).items()))
    return fused, u, rel


def fused_transfer_path(prob, hier, fused, rel_ref, rel_fused, niter_ref,
                        cfg, launches):
    """Phase 4e: ``PMGHierarchy(fuse_transfers=True)`` alone and with
    ``fuse_smoother=True`` on phase 4's mesh and rhs, against phase 4's
    (``hier``, ``rel_ref``) and 4b's (``fused``, ``rel_fused``) hierarchies.
    Adds the transfer kernels' launches on this path to ``launches``."""
    import torch

    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.ops import transfer as tt
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    r0 = float(torch.linalg.vector_norm(prob.b))
    b1 = torch.ones_like(prob.b)
    u0 = torch.zeros_like(b1)
    path = {k: 0 for k in tt.LAUNCHES}
    for tag, smoother, ref_h, ref_rel in (
            ("fuse_transfers", False, hier, rel_ref),
            ("fuse_transfers + fuse_smoother", True, fused, rel_fused)):
        for mod in (tt, kb):
            for k in mod.LAUNCHES:
                mod.LAUNCHES[k] = 0
        ts = time.perf_counter()
        h = PMGHierarchy(prob.mesh, operator="kron_blocked",
                         fuse_transfers=True, fuse_smoother=smoother, **cfg)
        torch.cuda.synchronize()
        print(f"    {tag}: setup seconds {time.perf_counter() - ts:.2f}")
        _, rn = h.solve(prob.b, num_cycles=10)
        rel = [r / r0 for r in rn]
        traj = traj_diff(rel, ref_rel)
        u, niter = h.solve_pcg(prob.b, rtol=1e-6, maxiter=50)
        torch.cuda.synchronize()
        for k in path:
            path[k] += tt.LAUNCHES[k]
        print(f"    {tag}: rel {[f'{v:.4e}' for v in rel]}; trajectory max "
              f"rel diff against the einsum transfers (cycles above "
              f"{REF_TRAJ_FROM:g}) {traj:.3e}; FCG(V) {niter} (phase 4: "
              f"{niter_ref}); launches {dict(tt.LAUNCHES)}")
        if not traj <= FUSED_TRAJ_RTOL:
            raise AssertionError(f"{tag}: trajectories differ: {traj}")
        if not (tt.LAUNCHES["transfer_yz"] > 0
                and (kb.LAUNCHES["t1"] > 0) == smoother):
            raise AssertionError(f"{tag}: kernels #4/#11 launched "
                                 f"{kb.LAUNCHES['t1']} / "
                                 f"{tt.LAUNCHES['transfer_yz']} times")
        against_parent(f"4e {tag}", rel, niter)
        if abs(niter - niter_ref) > 1:
            raise AssertionError(f"{tag}: FCG counts differ: {niter} vs "
                                 f"{niter_ref}")
        if not bool(torch.isfinite(u).all()):
            raise AssertionError(f"{tag}: the FCG solution is not finite")
        # One V-cycle: 2 restrictions and 2 prolongations, each kernel
        # #10 then #11.
        for k in tt.LAUNCHES:
            tt.LAUNCHES[k] = 0
        h.apply(b1, u0)
        torch.cuda.synchronize()
        if tt.LAUNCHES != {"transfer_x": 4, "transfer_yz": 4}:
            raise AssertionError(f"{tag}: one V-cycle launched "
                                 f"{tt.LAUNCHES}, not 4 transfers")
        # reference, fused transfers, fused transfers, reference
        t_r1, _ = vcycle_ms(ref_h)
        t_f1, all_f1 = vcycle_ms(h)
        t_f2, all_f2 = vcycle_ms(h)
        t_r2, _ = vcycle_ms(ref_h)
        print(f"    {tag}: V-cycle {(t_f1 + t_f2) / 2:.3f} ms ({t_f1:.3f}, "
              f"{t_f2:.3f}; reps {[round(t, 3) for t in all_f1 + all_f2]}) "
              f"vs einsum transfers {(t_r1 + t_r2) / 2:.3f} ms ({t_r1:.3f}, "
              f"{t_r2:.3f}); 10 back-to-back, median of 3, in turns")
        wall, busy, nk, by_name = profile_busy(lambda: h.apply(b1, u0))
        tms = sum(v for k, v in by_name.items() if "transfer" in k)
        print(f"    profile, one {tag} V-cycle: wall {wall:.3f} ms, device "
              f"busy {busy:.3f} ms, {nk} kernels; transfer kernels "
              f"{tms:.4f} ms ({tms / busy:.1%}), the rest "
              f"{busy - tms:.4f} ms")
        for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            print(f"      {ms:8.4f} ms {ms / busy:6.1%}  {kname[:90]}")
        print(f"    {tag} V-cycle, busy {busy:.4f} ms per cycle, idle "
              f"{max(0.0, 1 - busy / wall):.1%} of the profiled cycle and "
              f"{max(0.0, 1 - busy / ((t_f1 + t_f2) / 2)):.1%} of the "
              "back-to-back one: " + ", ".join(
                  f"{k} {v:.4f} ms"
                  for k, v in fused_kernel_ms(by_name).items()))
        del h, u
    launches.update(path)


def refined_path(fused, b):
    """Phase 4c: ``solve_refined`` on the fused hierarchy, to < 1e-8
    relative f64 residual within 20 cycles."""
    import torch

    ts = time.perf_counter()
    u64, rn = fused.solve_refined(b, num_cycles=20)
    torch.cuda.synchronize()
    secs = time.perf_counter() - ts
    r0 = float(torch.linalg.vector_norm(b.double()))
    rel = [r / r0 for r in rn]
    print(f"    20 refinement cycles: {secs:.2f} s host clock (the f64 "
          "Kronecker apply built on first use included)")
    print(f"    f64 relative residual before each cycle: "
          f"{[f'{v:.3e}' for v in rel]}")
    if u64.dtype != torch.float64 or not bool(torch.isfinite(u64).all()):
        raise AssertionError("solve_refined did not return a finite f64 vector")
    if not min(rel) < 1e-8:
        raise AssertionError(f"solve_refined stalled at {min(rel):.3e}")


def cycle_modes(cfg):
    """Phase 4d: at nc=21 the fused W-cycle against the fused V-cycle (f64
    residuals of 7 `solve_refined` cycles: the f32 stationary residual
    stalls near 2.4e-4 at this size) and the FMG start against the zero
    start."""
    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import f_rhs
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    mesh = BoxMesh((21, 21, 21))
    b = torch.tensor(assemble_rhs(mesh, 6, f_rhs(2.0)), dtype=torch.float32,
                     device="cuda")
    r0 = float(torch.linalg.vector_norm(b))
    hv = PMGHierarchy(mesh, operator="kron_blocked", fuse_smoother=True, **cfg)
    hw = PMGHierarchy(mesh, operator="kron_blocked", fuse_smoother=True,
                      coarse_cfg={"gamma": 2}, **cfg)
    _, sv = hv.solve(b, num_cycles=6)
    _, sw = hw.solve(b, num_cycles=6)
    print(f"    stationary f32 rel, V: {[f'{v / r0:.3e}' for v in sv]}")
    print(f"    stationary f32 rel, W: {[f'{v / r0:.3e}' for v in sw]}")
    _, rv = hv.solve_refined(b, num_cycles=7)
    _, rw = hw.solve_refined(b, num_cycles=7)
    print(f"    refined f64 rel, V: {[f'{v / r0:.3e}' for v in rv]}")
    print(f"    refined f64 rel, W: {[f'{v / r0:.3e}' for v in rw]}")
    if not rw[-1] < rv[-1]:
        raise AssertionError(f"the W-cycle did not end below the V-cycle: "
                             f"{rw[-1]} vs {rv[-1]}")
    print(f"    cycle ms: V {vcycle_ms(hv)[0]:.3f}, W {vcycle_ms(hw)[0]:.3f}")
    _, rz = hv.solve(b, num_cycles=3)
    _, rf = hv.solve(b, num_cycles=3, fmg=True)
    print(f"    solve from zero rel {[f'{v / r0:.3e}' for v in rz]}; from the "
          f"FMG guess {[f'{v / r0:.3e}' for v in rf]}")
    if not rf[0] < rz[0]:
        raise AssertionError(f"FMG start not below the zero start: {rf[0]} "
                             f"vs {rz[0]}")


def grid_mats(nc, P, shards, masks, kappa=2.0):
    """The grid-stacked kron_blocked arrays of `GridPMG` on
    ``BoxMesh(nc)`` at degree P (float32, on the card), with the box's
    separable masks when ``masks``."""
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.ops.kron import axis_stiffness_mass, local_axis_K
    from pmg_dolfinx_tpu_torch.parallel.grid2d import GridPartition
    from pmg_dolfinx_tpu_torch.parallel.partition import duplicate_planes

    mesh = BoxMesh(nc)
    part = GridPartition(mesh, shards)
    npls = part.local_shape(P)
    Ks, ms = [], []
    for a in range(3):
        K, _ = local_axis_K(mesh, a, part.cells_per_shard[a], P, kappa,
                            part.shards[a])
        _, mg = axis_stiffness_mass(mesh.nc[a], P, mesh.h_cells[a])
        Ks.append(K)
        ms.append(duplicate_planes(mg, npls[a], part.shards[a]))
    fm = None
    if masks:
        fm = tuple(duplicate_planes(m, npls[a], part.shards[a]) for a, m in
                   enumerate(kb.axis_interior_masks(mesh, P)))
    mats, _ = kb.grid_symmetrized_mats(Ks, ms, part.shards, torch.float32,
                                       fm, band=P, device="cuda")
    return mesh, part, mats


def grid_kernel_parity(nc, P=6, extra=None, parent=None):
    """Phase 3e at one per-shard shape: kernels #8 / #9 on one shard of a
    box (``nc`` cells, degree P) against their plain versions, with seeded
    synthetic corrections, need_y / need_z in GRID_NEEDS, sigma in {0, 0.5},
    apply and fused residual; #8 on a non-separable marker (the box faces
    plus ~1% of the interior dofs). Returns ({kernel: (max_abs_err, ms,
    plain_ms)}, {kernel: (bound_ms, by)}, #9's device ms from `graph_ms`),
    timed on the apply with both corrections. With ``extra``, #8's device
    time, apply and residual with both corrections, beside its bound and
    #9's (its separable twin) goes into ``extra["t23_grid"]``; with the
    parent's package ``parent``, also the parent's #8 in turns (parent,
    change, change, parent) and whether both give the same bits."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb

    mesh, _, m = grid_mats(nc, P, (1, 1, 1), masks=True)
    shape = mesh.lattice_shape(P)
    rng = np.random.default_rng(SEED + 8 * nc[0])
    f32 = lambda s: torch.tensor(rng.standard_normal(s, dtype=np.float32),
                                 device="cuda")
    x, r = f32(shape), f32(shape)
    bc = torch.tensor(mesh.boundary_dof_marker(P).reshape(shape)
                      | (rng.random(shape) < 0.01), device="cuda")
    cy0, cz0 = f32((shape[0], 2, shape[2])), f32((shape[0], shape[1], 2))
    t1 = kb.plain_t1_m(x, m)
    err = {"t23_grid": 0.0, "t23_grid_m": 0.0}
    for need in GRID_NEEDS:
        cy = cy0 if need[0] else None
        cz = cz0 if need[1] else None
        for sigma in (0.0, 0.5):
            for rr in (None, r):
                ref8 = kb.plain_t23_grid(x, bc, t1, m, sigma, cy, cz)
                ref9 = kb.plain_t23_grid_m(x, t1, m, sigma, cy, cz)
                if rr is not None:
                    ref8, ref9 = rr - ref8, rr - ref9
                for name, got, ref in (
                        ("t23_grid", kb.kron_t23_grid(x, bc, t1, m, sigma, cy,
                                                      cz, r3=rr), ref8),
                        ("t23_grid_m", kb.kron_t23_grid_m(x, t1, m, sigma, cy,
                                                          cz, r3=rr), ref9)):
                    torch.cuda.synchronize()
                    e = rel_max_err(got, ref)
                    tag = (f"{shape} {name} need_y={need[0]} "
                           f"need_z={need[1]} sigma={sigma} "
                           f"{'residual' if rr is not None else 'apply'}")
                    if not e <= KERNEL_RTOL:
                        raise AssertionError(f"{tag}: relative max-norm "
                                             f"error {e:.3e} > {KERNEL_RTOL}")
                    err[name] = max(err[name], float((got - ref).abs().max()))
                    print(f"    {tag}: rel max err {e:.3e}")
    out, bounds = {}, {}
    N = x.numel()
    for name, plain, kern in (
            ("t23_grid",
             lambda: kb.plain_t23_grid(x, bc, t1, m, 0.0, cy0, cz0),
             lambda: kb.kron_t23_grid(x, bc, t1, m, 0.0, cy0, cz0)),
            ("t23_grid_m",
             lambda: kb.plain_t23_grid_m(x, t1, m, 0.0, cy0, cz0),
             lambda: kb.kron_t23_grid_m(x, t1, m, 0.0, cy0, cz0))):
        ms_k, ms_p, four = turns(plain, kern)
        bounds[name] = kernel_bound(name, N, P, dims=shape)
        out[name] = (err[name], ms_k, ms_p)
        print(f"    {shape} {name} (both corrections): kernel {ms_k:.4f} ms "
              f"vs plain {ms_p:.4f} ms (turns {[round(t, 4) for t in four]}); "
              f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]}); "
              f"t23_m without corrections "
              f"{cuda_ms(lambda: kb.kron_t23_m(x, t1, m)):.4f} ms")
    y = torch.empty_like(x)
    dev9 = graph_ms(lambda: kb.kron_t23_grid_m(x, t1, m, 0.0, cy0, cz0,
                                               out=y))
    dev9r = graph_ms(lambda: kb.kron_t23_grid_m(x, t1, m, 0.0, cy0, cz0,
                                                r3=r, out=y))
    print(f"    {shape} t23_grid_m (both corrections) device ms (CUDA graph "
          f"of 20 launches): apply {dev9:.4f}, residual {dev9r:.4f}")
    if extra is not None:
        grid_march_device(x, bc, t1, m, cy0, cz0, r, (dev9, dev9r), P,
                          extra, parent)
    return out, bounds, dev9


def grid_march_device(x, bc, t1, m, cy, cz, r, twin, P, extra, parent):
    """Phase 3e: #8 (apply, residual) with both corrections as device time
    beside its bound and #9's device time ``twin`` (apply, residual); with
    the parent's package, the parent's #8 in turns and whether both give
    the same bits. Into ``extra["t23_grid"]``, keyed by shape and form."""
    import torch

    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb

    pkb = (importlib.import_module(f"{parent.__name__}.ops.kron_blocked")
           if parent else None)
    e = extra.setdefault("t23_grid", {
        "device_ms_by_shape": {}, "bound_ms_by_shape": {},
        "twin_device_ms_by_shape": {},
        "parent_device_ms_by_shape": {} if parent else None,
        "same_bits_as_parent_by_shape": {} if parent else None})
    shape = tuple(x.shape)
    y = torch.empty_like(x)
    for form, rr, tdev in (("apply", None, twin[0]),
                           ("residual", r, twin[1])):
        def kern(k):
            return k.kron_t23_grid(x, bc, t1, m, 0.0, cy, cz, r3=rr, out=y)

        key = f"{'x'.join(map(str, shape))} band {P} {form}"
        bound, by = kernel_bound("t23_grid" if rr is None else
                                 "t23_grid_res", x.numel(), P, dims=shape)
        dev, vs, par = device_ms(lambda: kern(kb), parent and (
            lambda: kern(pkb)), bound)
        if par:
            (e["parent_device_ms_by_shape"][key],
             e["same_bits_as_parent_by_shape"][key]) = par
        e["device_ms_by_shape"][key] = dev
        e["bound_ms_by_shape"][key] = bound
        e["twin_device_ms_by_shape"][key] = tdev
        print(f"    {key} t23_grid (both corrections): device {dev:.4f} ms "
              f"(CUDA graph of 20 launches), {bound / dev:.0%} of its bound "
              f"{bound:.4f} ms ({by}); separable twin t23_grid_m "
              f"{tdev:.4f} ms{vs}")


def grid_entry_point():
    """Phase 3e, the entry point: `blocked_kron_apply_grid` on the stacked
    (2, 2, 2) layout of nc=21, p=6 with a non-separable marker (the box
    faces plus ~1% of the interior dofs, as phase 3b) and every exchange of
    `grid_kron_blocked_cycle_ops`, apply and fused residual, between a
    reset and a read of the launch counts (kernel #8 must launch), held to
    the same call on CPU copies (the plain versions). Returns the
    launches of #8."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.parallel import grid2d as g2

    shards, P = (2, 2, 2), 6
    mesh, part, mats = grid_mats((22, 22, 22), P, shards, masks=False)
    shape = mesh.lattice_shape(P)
    rng = np.random.default_rng(SEED + 33)
    bc_np = (mesh.boundary_dof_marker(P).reshape(shape)
             | (rng.random(shape) < 0.01))
    grid = g2.StackedGrid(shards)
    stack = lambda a: g2.stack_shards(torch.tensor(
        part.to_dist(P, a.reshape(-1))), shards).to("cuda")
    bc = stack(bc_np.astype(np.float64)) > 0.5
    x = stack(rng.standard_normal(shape)).float()
    r = stack(rng.standard_normal(shape)).float()
    kw = dict(
        exchange_x=lambda t: g2._exchange_axis(t, grid, 0, inplace=True),
        ex_y=g2._plane_exchange_pair(grid, 1),
        ex_z=g2._plane_exchange_pair(grid, 2))
    for k in kb.LAUNCHES:
        kb.LAUNCHES[k] = 0
    y = kb.blocked_kron_apply_grid(x, bc, mats, **kw)
    rr = kb.blocked_kron_apply_grid(x, bc, mats, r3=r, **kw)
    torch.cuda.synchronize()
    launches = dict(kb.LAUNCHES)
    print(f"    blocked_kron_apply_grid on the stacked (2, 2, 2) layout of "
          f"{shape} ({x.shape[3:]} per shard), non-separable marker: "
          f"launches {launches}")
    if not (launches["t23_grid"] > 0 and launches["t23_grid_res"] > 0):
        raise AssertionError(f"kernel #8 was not launched: {launches}")
    cpu = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
           for k, v in mats.items()}
    y_ref = kb.blocked_kron_apply_grid(x.cpu(), bc.cpu(), cpu, **kw)
    r_ref = kb.blocked_kron_apply_grid(x.cpu(), bc.cpu(), cpu, r3=r.cpu(),
                                       **kw)
    for tag, got, ref in (("apply", y, y_ref), ("residual", rr, r_ref)):
        e = rel_max_err(got.cpu(), ref)
        print(f"    entry point {tag} vs the plain versions on the CPU: rel "
              f"max err {e:.3e}")
        if not e <= KERNEL_RTOL:
            raise AssertionError(f"grid entry point {tag}: {e:.3e}")
    return launches["t23_grid"] + launches["t23_grid_res"]


def grid_vcycle_ms(grid, cycles=10, reps=3):
    """`vcycle_ms` for a `GridPMG`: one-vectors in the stacked layout."""
    import torch

    b = torch.ones(grid.shards + grid.levels[-1].shape, dtype=grid.dtype,
                   device=grid.device)
    u = torch.zeros_like(b)
    times = [cuda_ms(lambda: grid.apply(b, u), reps=cycles, warmup=2)
             for _ in range(reps)]
    return sorted(times)[len(times) // 2], times


def grid_path(prob, hier, rel_ref, u_ref, niter_ref, spread, cfg, launches):
    """Phase 14: the device-grid main path, ``GridPMG(BoxMesh((42, 42,
    42)), (2, 2, 2), degrees=(1, 3, 6), kappa=2, float32, coarse="fdm",
    operator="kron_blocked")`` on phase 4's mesh and rhs, every shard on
    this card, against phase 4's single-device hierarchy (``spread``: phase
    4's plain-kron spread); then (1, 2, 4) at about 2.0M dofs against the
    single-device hierarchy on its mesh. Adds #9's launches on the path to
    ``launches``."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import f_rhs
    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.parallel.grid2d import GridPMG
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    path_kernels = ("t1_m", "t23_grid_m", "t23_grid_res_m")
    for k in kb.LAUNCHES:
        kb.LAUNCHES[k] = 0
    ts = time.perf_counter()
    grid = GridPMG(prob.mesh, (2, 2, 2), operator="kron_blocked", **cfg)
    torch.cuda.synchronize()
    print(f"    setup seconds: {time.perf_counter() - ts:.2f}  (per-shard "
          f"lattice {grid.levels[-1].shape}; eig max per level "
          f"{[float(e[-1]) for e in grid.eigs]}; single device "
          f"{[float(e[-1]) for e in hier.eigs]})")
    r0 = float(torch.linalg.vector_norm(prob.b))
    ts = time.perf_counter()
    u, rn = grid.solve(prob.b, num_cycles=10)
    rel = [v / r0 for v in rn]
    print(f"    10 cycles ({time.perf_counter() - ts:.3f} s host clock): rel "
          f"{[f'{v:.4e}' for v in rel]}")
    hist = [1.0] + rel
    if not all(hist[i + 1] < hist[i] for i in range(4)):
        raise AssertionError(f"residual did not fall on cycles 1-4: {rel}")
    grid_traj_gate(rel, rel_ref, spread, "grid vs single device")
    ts = time.perf_counter()
    u, niter = grid.solve_pcg(prob.b, rtol=1e-6, maxiter=50)
    torch.cuda.synchronize()
    pcg_s = time.perf_counter() - ts
    main = dict(kb.LAUNCHES)
    print(f"    FCG(V) iterations to rtol 1e-6: {niter} ({pcg_s:.3f} s host "
          f"clock; single device {niter_ref}); kernel launches on this path: "
          f"{main}")
    if not all(main[k] > 0 for k in path_kernels):
        raise AssertionError(f"a grid-path kernel was not launched: {main}")
    launches["t23_grid_m"] = main["t23_grid_m"] + main["t23_grid_res_m"]
    if abs(niter - niter_ref) > 1:
        raise AssertionError(f"FCG counts differ: {niter} vs {niter_ref}")
    if tuple(u.shape) != tuple(u_ref.shape) or not bool(
            torch.isfinite(u).all()):
        raise AssertionError("grid solution is not a finite vector of ndofs")
    du = float(torch.linalg.vector_norm(u - u_ref)
               / torch.linalg.vector_norm(u_ref))
    print(f"    grid vs single-device FCG solution: relative difference "
          f"{du:.3e}")
    if not du <= 1e-3:
        raise AssertionError(f"grid and single-device solutions differ: {du}")
    # The decomposed operator against the single-device one on a seeded
    # random vector (no cancellation, so f32 rounding stays ~1e-7).
    x = torch.tensor(np.random.default_rng(SEED + 14).standard_normal(
        u_ref.numel(), dtype=np.float32), device="cuda")
    lv_s, lv_g = hier.levels[-1], grid.levels[-1]
    y_s = hier.ops["apply"](hier.data["levels"][-1], x.reshape(lv_s.shape),
                            lv_s).reshape(-1)
    y_g = grid.from_dist(grid.ops["apply"](grid.data["levels"][-1],
                                           grid.to_dist(x), lv_g))
    err = rel_max_err(y_g, y_s)
    print(f"    grid apply vs single-device apply, seeded random vector: rel "
          f"max err {err:.3e}")
    if not err <= KERNEL_RTOL:
        raise AssertionError(f"grid and single-device operators differ: {err}")
    del x, y_s, y_g
    grid_vcycle_parity(grid, hier, SEED + 15, "grid (2, 2, 2)")
    bd = grid.to_dist(prob.b)
    ud = torch.zeros_like(bd)
    for k in kb.LAUNCHES:
        kb.LAUNCHES[k] = 0
    grid.apply(bd, ud)
    torch.cuda.synchronize()
    print(f"    launches per grid V-cycle: "
          f"{ {k: v for k, v in kb.LAUNCHES.items() if v} }")
    # single device, grid, grid, single device
    t_s1, _ = vcycle_ms(hier)
    t_g1, all_g1 = grid_vcycle_ms(grid)
    t_g2, all_g2 = grid_vcycle_ms(grid)
    t_s2, _ = vcycle_ms(hier)
    print(f"    V-cycle: grid (2, 2, 2) {(t_g1 + t_g2) / 2:.3f} ms ({t_g1:.3f}, "
          f"{t_g2:.3f}; reps {[round(t, 3) for t in all_g1 + all_g2]}) vs "
          f"single device {(t_s1 + t_s2) / 2:.3f} ms ({t_s1:.3f}, "
          f"{t_s2:.3f}); 10 back-to-back, median of 3, in turns")
    wall, busy, nk, by_name = profile_busy(lambda: grid.apply(bd, ud))
    print(f"    profile, one grid V-cycle: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms, {nk} kernels, idle {max(0.0, 1 - busy / wall):.1%}")
    for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"      {ms:8.4f} ms {ms / busy:6.1%}  {kname[:90]}")
    del grid, u, bd, ud

    # (1, 2, 4): 21 cells cannot split 2 or 4 ways, so the nearest mesh
    # with ~2.0M dofs at p=6 that can.
    mesh = BoxMesh((21, 22, 20))
    b = torch.tensor(assemble_rhs(mesh, 6, f_rhs(2.0)), dtype=torch.float32,
                     device="cuda")
    r0 = float(torch.linalg.vector_norm(b))
    single = PMGHierarchy(mesh, operator="kron_blocked", **cfg)
    grid = GridPMG(mesh, (1, 2, 4), operator="kron_blocked", **cfg)
    _, rn_s = single.solve(b, num_cycles=10)
    _, rn_g = grid.solve(b, num_cycles=10)
    _, rn_p = PMGHierarchy(mesh, operator="kron", **cfg).solve(
        b, num_cycles=10)
    spread_124 = traj_diff([v / r0 for v in rn_p], [v / r0 for v in rn_s])
    u_s, n_s = single.solve_pcg(b, rtol=1e-6, maxiter=50)
    u_g, n_g = grid.solve_pcg(b, rtol=1e-6, maxiter=50)
    rel_s, rel_g = [v / r0 for v in rn_s], [v / r0 for v in rn_g]
    du = float(torch.linalg.vector_norm(u_g - u_s)
               / torch.linalg.vector_norm(u_s))
    print(f"    (1, 2, 4) on {mesh.nc} ({mesh.num_dofs(6)} dofs, per-shard "
          f"{grid.levels[-1].shape}): rel {[f'{v:.3e}' for v in rel_g]} "
          f"(single {[f'{v:.3e}' for v in rel_s]}); FCG {n_g} (single "
          f"{n_s}); solutions {du:.3e}; V-cycle grid "
          f"{grid_vcycle_ms(grid)[0]:.3f} ms vs single "
          f"{vcycle_ms(single)[0]:.3f} ms")
    grid_traj_gate(rel_g, rel_s, spread_124, "(1, 2, 4) vs single device")
    grid_vcycle_parity(grid, single, SEED + 16, "grid (1, 2, 4)")
    if abs(n_g - n_s) > 1 or not du <= 1e-3:
        raise AssertionError(f"(1, 2, 4): FCG {n_g} vs {n_s}, solutions {du}")



def kron_profile(fn, tag, tries=4):
    """`profile_busy` of one V-cycle ``fn`` on a Kronecker hierarchy from a
    complete window: one whose ``kron_t*`` kernels number the wrappers'
    launches in the call and whose kernel count repeats an earlier
    window's (late in a long process the profiler leaves kernels out, see
    `profile_complete`); up to ``tries`` windows. Prints the window read.
    Returns (wall ms, busy ms, kernels, {name: ms}, complete)."""
    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb

    seen_nk = []
    for tried in range(1, tries + 1):
        before = sum(kb.LAUNCHES.values())
        calls = {}
        wall, busy, nk, by_name = profile_busy(fn, calls)
        launched = sum(kb.LAUNCHES.values()) - before
        seen = sum(n for k, n in calls.items() if "kron_t" in k)
        complete = seen == launched and nk in seen_nk
        seen_nk.append(nk)
        if complete:
            break
    print(f"    {tag}: profiled V-cycle ({'complete' if complete else 'INCOMPLETE'}"
          f" window, {tried} tried: {seen} kron kernels for {launched} "
          f"launches): wall {wall:.3f} ms, device busy {busy:.3f} ms ({nk} "
          f"kernels)")
    return wall, busy, nk, by_name, complete


def schwarz_flagship(prob, niter_ref, cfg, launches):
    """Phase 15: the Schwarz flagship, the JAX bench's
    ``vcycle_16M_p136_schwarz`` (``PoissonProblem(nc=(42, 42, 42),
    degrees=(1, 3, 6), kappa=2, float32, coarse="fdm",
    operator="kron_blocked", smoother="schwarz")``), its hierarchy on phase
    4's mesh and rhs. Gates: FCG(V) to 1e-6 within phase 4's (point-Jacobi)
    count, L2 < 1e-4, #1/#2/#3 launch; at nc=21, at the plain-torch
    ``kron`` Schwarz twin's smoother bounds, one V-cycle within
    `SCHWARZ_VCYCLE_RTOL` of the twin's and the trajectories within twice
    the f32 floor. Adds #1-#3's launches to ``launches``; returns the
    hierarchy (phase 18d)."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import f_rhs
    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy
    from pmg_dolfinx_tpu_torch.solvers.schwarz import schwarz_precond_apply

    for k in kb.LAUNCHES:
        kb.LAUNCHES[k] = 0
    ts = time.perf_counter()
    hier = PMGHierarchy(prob.mesh, operator="kron_blocked",
                        smoother="schwarz", **cfg)
    torch.cuda.synchronize()
    sw_mb = sum(t.numel() * t.element_size() for lv in hier.data["levels"]
                for t in lv["schwarz"].values()) / 1e6
    print(f"    setup seconds: {time.perf_counter() - ts:.2f} (no rhs; lmax "
          f"per level {[float(lv['lmax']) for lv in hier.data['levels']]}; "
          f"Schwarz arrays {sw_mb:.0f} MB)")
    r0 = float(torch.linalg.vector_norm(prob.b))
    ts = time.perf_counter()
    _, rn = hier.solve(prob.b, num_cycles=10)
    rel = [v / r0 for v in rn]
    rate = [b / a for a, b in zip([1.0] + rel, rel)]
    print(f"    10 cycles ({time.perf_counter() - ts:.3f} s host clock): rel "
          f"{[f'{v:.4e}' for v in rel]}; contraction per cycle "
          f"{[f'{v:.3f}' for v in rate]}, over 10 cycles "
          f"{rel[-1] ** 0.1:.3f}")
    ts = time.perf_counter()
    u, niter = hier.solve_pcg(prob.b, rtol=1e-6, maxiter=50)
    torch.cuda.synchronize()
    path = dict(kb.LAUNCHES)
    print(f"    FCG(V) iterations to rtol 1e-6: {niter} "
          f"({time.perf_counter() - ts:.3f} s host clock; point Jacobi, "
          f"phase 4: {niter_ref}); kernel launches on this path: {path}")
    if not all(path[k] > 0 for k in ("t1_m", "t23_m", "t23_res_m")):
        raise AssertionError(f"a kernel was not launched: {path}")
    for k in ("t1_m", "t23_m", "t23_res_m"):
        launches[k] += path[k]
    if not niter <= niter_ref:
        raise AssertionError(f"Schwarz FCG(V) {niter} > point Jacobi's "
                             f"{niter_ref}")
    if tuple(u.shape) != (hier.levels[-1].ndofs,) or not bool(
            torch.isfinite(u).all()):
        raise AssertionError("solution is not a finite vector of ndofs")
    vc, vc_all = vcycle_ms(hier)
    print(f"    V-cycle {vc:.3f} ms (10 back-to-back, 3 reps "
          f"{[round(t, 3) for t in vc_all]}); pace, 5 reps of 10 (CUDA-event "
          f"ms, host ms to enqueue): "
          f"{[(round(a, 3), round(b, 3)) for a, b in vcycle_pace(hier)]}")
    b1 = torch.ones_like(prob.b)
    hier.apply(b1, torch.zeros_like(b1))
    _, busy, _, by_name, complete = kron_profile(
        lambda: hier.apply(b1, torch.zeros_like(b1)), "Schwarz flagship")
    # The Schwarz applies of one cycle, each level's apply timed alone
    # (CUDA events, back-to-back: card-paced at these sizes):
    # (smoother_iters + 1) per smooth, a pre- and a post-smooth on every
    # level above the coarse one.
    sw_ms, parts = 0.0, []
    for lv, level in zip(hier.data["levels"][1:], hier.levels[1:]):
        r = torch.randn(level.shape, device="cuda", generator=torch.Generator(
            "cuda").manual_seed(SEED))
        apply = lambda: schwarz_precond_apply(lv["schwarz"], r, level.shape,
                                              level.P)
        one = cuda_ms(apply, reps=10)
        n = 2 * (level.smoother_iters + 1)
        sw_ms += n * one
        parts.append(f"p={level.P}: {n} x {one:.3f} ms")
    _, one_busy, nk1, names = profile_busy(apply)
    print(f"    Schwarz applies per V-cycle (CUDA events): {'; '.join(parts)}"
          f": {sw_ms:.3f} ms, {sw_ms / vc:.1%} of the back-to-back V-cycle "
          f"{vc:.3f} ms" + (f"; idle {max(0.0, 1 - busy / vc):.1%}"
                            if complete else ""))
    print(f"    one p={level.P} Schwarz apply by kernel ({nk1} kernels, busy "
          f"{one_busy:.3f} ms of its CUDA-event {one:.3f} ms): " + "; ".join(
              f"{ms:.3f} ms {name[:60]}" for name, ms in sorted(
                  names.items(), key=lambda kv: -kv[1])[:6]))
    print("    busy V-cycle by kernel (top 8): " + "; ".join(
        f"{ms:.3f} ms {name[:50]}" for name, ms in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:8]))
    ts = time.perf_counter()
    err = prob.error_l2(u)
    print(f"    L2 error vs manufactured solution: {err:.4e} "
          f"({time.perf_counter() - ts:.1f} s host)")
    if not err < 1e-4:
        raise AssertionError(f"L2 error {err} too large")

    # nc=21: the kernels' Schwarz trajectory against the plain-torch
    # Kronecker twin's, at the twin's smoother bounds (phase 5's rules).
    mesh = BoxMesh((21, 21, 21))
    b = torch.tensor(assemble_rhs(mesh, cfg["degrees"][-1], f_rhs(2.0)),
                     dtype=torch.float32, device="cuda")
    r0 = float(torch.linalg.vector_norm(b))
    res, hs = {}, {}
    lmax = None
    for op in ("kron", "kron_blocked"):
        h = hs[op] = PMGHierarchy(mesh, operator=op, smoother="schwarz",
                                  **cfg)
        if lmax is None:
            lmax = [lv["lmax"] for lv in h.data["levels"]]
        else:
            h.load_state({"levels": [{"lmax": v} for v in lmax]})
        _, rn = h.solve(b, num_cycles=10)
        res[op] = (np.array(rn) / r0, h.solve_pcg(b, rtol=1e-6)[1],
                   vcycle_ms(h)[0])
        print(f"    nc=21 {op} Schwarz: rel "
              f"{[f'{v:.3e}' for v in res[op][0]]}, FCG {res[op][1]}, "
              f"V-cycle {res[op][2]:.3f} ms")
    rk, rb = res["kron"][0], res["kron_blocked"][0]
    # each trajectory carries its own f32 noise of about its floor
    floor = float(max(rk.min(), rb.min()))
    gap = float(np.abs(rb - rk).max())
    print(f"    nc=21 kron_blocked vs kron Schwarz: trajectory max rel diff "
          f"(cycles above {REF_TRAJ_FROM:g}) {traj_diff(rb, rk):.3e}; max "
          f"abs diff of the relative residuals {gap:.3e} (gate: twice the "
          f"f32 floor, 2 x {floor:.3e})")
    if not gap <= 2.0 * floor:
        raise AssertionError(f"Schwarz trajectories differ by {gap:.3e} > "
                             f"twice the f32 floor {floor:.3e}")
    err = vcycle_pair_parity(hs["kron_blocked"], hs["kron"], SEED + 15)
    print(f"    nc=21 kron_blocked vs kron Schwarz: one V-cycle, seeded "
          f"random rhs and iterate, rel max err {err:.3e} (gate "
          f"{SCHWARZ_VCYCLE_RTOL:g})")
    if not err <= SCHWARZ_VCYCLE_RTOL:
        raise AssertionError(f"Schwarz V-cycles differ by {err:.3e}")
    return hier


def grid_schwarz(prob, hier, cfg, launches):
    """Phase 18d: ``GridPMG(BoxMesh((42, 42, 42)), (2, 2, 2),
    smoother="schwarz", operator="kron_blocked")`` on phase 4's mesh and
    rhs, every shard on this card: one grid V-cycle within
    `GRID_VCYCLE_RTOL` of phase 15's single-device Schwarz V-cycle, #9
    launches. Adds #9's launches to ``launches``."""
    import torch

    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.parallel.grid2d import GridPMG

    for k in kb.LAUNCHES:
        kb.LAUNCHES[k] = 0
    ts = time.perf_counter()
    grid = GridPMG(prob.mesh, (2, 2, 2), operator="kron_blocked",
                   smoother="schwarz", **cfg)
    torch.cuda.synchronize()
    print(f"    setup seconds: {time.perf_counter() - ts:.2f} (per-shard "
          f"lattice {grid.levels[-1].shape}; eig max per level "
          f"{[float(e[-1]) for e in grid.eigs]}; single device "
          f"{[float(e[-1]) for e in hier.eigs]})")
    grid_vcycle_parity(grid, hier, SEED + 18, "grid (2, 2, 2) Schwarz")
    r0 = float(torch.linalg.vector_norm(prob.b))
    _, rn = grid.solve(prob.b, num_cycles=4)
    path = dict(kb.LAUNCHES)
    print(f"    4 cycles: rel {[f'{v / r0:.4e}' for v in rn]}; kernel "
          f"launches on this path: {path}")
    if not path["t23_grid_m"] > 0:
        raise AssertionError(f"#9 was not launched: {path}")
    launches["t23_grid_m"] += path["t23_grid_m"] + path["t23_grid_res_m"]
    print(f"    V-cycle: grid (2, 2, 2) Schwarz {grid_vcycle_ms(grid)[0]:.3f} "
          f"ms vs single device {vcycle_ms(hier)[0]:.3f} ms (10 "
          f"back-to-back, median of 3)")


def curved_schwarz(curved, niter_ref, ccfg, launches):
    """Phase 16: ``PoissonProblem(mesh=PerturbedBoxMesh((42, 42, 42)),
    degrees=(1, 3, 6), kappa=2, float32, coarse="cg",
    operator="lattice_blocked", smoother="schwarz")`` on phase 7's mesh
    (16,194,277 dofs): FCG(V) within phase 7's point-Jacobi count, K-A
    launches, collocated L2 < 1e-4; then the nc=21 recipe of the JAX
    bench's ``curved_2M_p136`` Schwarz half. Adds K-A's launches to
    ``launches``."""
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import PoissonProblem
    from pmg_dolfinx_tpu_torch.ops import lattice_blocked as lb

    for k in lb.LAUNCHES:
        lb.LAUNCHES[k] = 0
    ts = time.perf_counter()
    prob = PoissonProblem(mesh=curved, operator="lattice_blocked",
                          smoother="schwarz", **ccfg)
    torch.cuda.synchronize()
    hier = prob.hierarchy
    print(f"    setup seconds: {time.perf_counter() - ts:.2f} (lmax per level "
          f"{[float(lv['lmax']) for lv in hier.data['levels']]})")
    r0 = float(torch.linalg.vector_norm(prob.b))
    _, rn = prob.solve(num_cycles=10)
    print(f"    10 cycles: rel {[f'{v / r0:.4e}' for v in rn]}")
    u, niter = hier.solve_pcg(prob.b, rtol=1e-6, maxiter=50)
    torch.cuda.synchronize()
    print(f"    FCG(V) iterations to rtol 1e-6: {niter} (point Jacobi, phase "
          f"7: {niter_ref}); kernel launches on this path: "
          f"{dict(lb.LAUNCHES)}")
    if not lb.LAUNCHES["lattice_apply"] > 0:
        raise AssertionError(f"K-A was not launched: {dict(lb.LAUNCHES)}")
    launches["lattice_apply"] += lb.LAUNCHES["lattice_apply"]
    if not niter <= niter_ref:
        raise AssertionError(f"Schwarz FCG(V) {niter} > point Jacobi's "
                             f"{niter_ref}")
    err = prob.error_l2(u)
    vc, vc_all = vcycle_ms(hier)
    print(f"    collocated L2 error {err:.4e}; V-cycle {vc:.3f} ms (10 "
          f"back-to-back, 3 reps {[round(t, 3) for t in vc_all]})")
    if not err < 1e-4:
        raise AssertionError(f"L2 error {err} too large")
    del prob, hier, u
    ts = time.perf_counter()
    prob = PoissonProblem(mesh=PerturbedBoxMesh((21, 21, 21)),
                          operator="lattice_blocked", smoother="schwarz",
                          **ccfg)
    _, niter = prob.hierarchy.solve_pcg(prob.b, rtol=1e-6)
    u, niter = prob.hierarchy.solve_pcg(prob.b, rtol=1e-6)
    print(f"    curved_2M_p136 Schwarz recipe (nc=21, 2,048,383 dofs): "
          f"V-cycle {vcycle_ms(prob.hierarchy)[0]:.3f} ms, FCG(V) {niter}, "
          f"collocated L2 {prob.error_l2(u):.4e} "
          f"({time.perf_counter() - ts:.1f} s with setup)")


def curved_hmg(curved, niter_ref, vc_ref, busy_ref, ccfg, launches):
    """Phase 17: the JAX driver's ``--mesh perturbed --coarse fdm`` path
    (``coarse="hmg"``: the rediscretised curved h-hierarchy, (42, 42, 42)
    -> (21, ...) -> (7, ...) at p=1 with a 512-dof dense bottom) on phase
    7's mesh, ``lattice_blocked``: FCG(V) within one of phase 7's ``cg``
    coarse count, collocated L2 < 1e-4; wall and busy ms per V-cycle beside
    phase 7's. Adds K-A's launches to ``launches``."""
    import torch

    from pmg_dolfinx_tpu_torch.models.poisson import PoissonProblem
    from pmg_dolfinx_tpu_torch.ops import lattice_blocked as lb

    for k in lb.LAUNCHES:
        lb.LAUNCHES[k] = 0
    ts = time.perf_counter()
    prob = PoissonProblem(mesh=curved, operator="lattice_blocked",
                          **dict(ccfg, coarse="hmg"))
    torch.cuda.synchronize()
    hier = prob.hierarchy
    cc = hier.coarse_cfg
    print(f"    setup seconds: {time.perf_counter() - ts:.2f}; h-levels "
          f"{[lv.shape for lv in cc['hmg_levels']]} at p=1, bottom "
          f"'{cc['hmg_bottom']}' ({cc['hmg_levels'][0].ndofs} dofs), "
          f"{cc['cycles']} h-cycles per coarse solve; h-level lmax "
          f"{[float(lv['lmax']) for lv in hier.data['hmg']['levels']]}")
    r0 = float(torch.linalg.vector_norm(prob.b))
    _, rn = prob.solve(num_cycles=10)
    print(f"    10 cycles: rel {[f'{v / r0:.4e}' for v in rn]}")
    u, niter = hier.solve_pcg(prob.b, rtol=1e-6, maxiter=50)
    torch.cuda.synchronize()
    print(f"    FCG(V) iterations to rtol 1e-6: {niter} (cg coarse, phase 7: "
          f"{niter_ref}); kernel launches on this path: {dict(lb.LAUNCHES)}")
    launches["lattice_apply"] += lb.LAUNCHES["lattice_apply"]
    if abs(niter - niter_ref) > 1:
        raise AssertionError(f"FCG(V) {niter} vs phase 7's {niter_ref}")
    err = prob.error_l2(u)
    print(f"    collocated L2 error {err:.4e}")
    if not err < 1e-4:
        raise AssertionError(f"L2 error {err} too large")
    vc, vc_all = vcycle_ms(hier)
    b1 = torch.ones_like(prob.b)
    hier.apply(b1, torch.zeros_like(b1))
    wall, busy, nk, by_name, _, tries, complete = profile_complete(
        lambda: hier.apply(b1, torch.zeros_like(b1)), lb)
    ka = lattice_kernel_ms(by_name)
    print(f"    V-cycle {vc:.3f} ms back-to-back (3 reps "
          f"{[round(t, 3) for t in vc_all]}), device busy {busy:.3f} ms "
          f"({nk} kernels, {'complete' if complete else 'INCOMPLETE'} window, "
          f"{tries} tried; K-A {ka['march'] + ka['fold']:.3f} ms), idle "
          f"{max(0.0, 1 - busy / vc):.1%}; phase 7 (cg coarse): "
          f"{vc_ref:.3f} ms, busy {busy_ref:.3f} ms, idle "
          f"{max(0.0, 1 - busy_ref / vc_ref):.1%}")
    print("    busy V-cycle by kernel (top 8): " + "; ".join(
        f"{ms:.3f} ms {name[:50]}" for name, ms in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:8]))


def amg_twin():
    """Phase 18a: ``examples/amg_torch.py --ndofs 2000000 --pc
    jacobi|cheb|hmg``, box and ``--mesh perturbed``, in this process, one
    mesh object per cell count (the fit gives 124 x 124 x 127 cells,
    2,000,000 p=1 dofs; the hmg runs round them to multiples of 4, 124 x
    124 x 128, h-levels down to 31 x 31 x 32 cells with a ``cg`` bottom,
    as the JAX driver does): h-multigrid-preconditioned CG must take
    fewer iterations than Jacobi-CG on each mesh."""
    from pmg_dolfinx_tpu_torch.utils import timers

    spec = importlib.util.spec_from_file_location(
        "amg_torch", ROOT / "examples" / "amg_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh, PerturbedBoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import fit_box_cells

    nc = fit_box_cells(2000000, 1)
    nc4 = tuple((c + 3) // 4 * 4 for c in nc)   # the driver's hmg rounding
    for mesh in ("box", "perturbed"):
        iters = {}
        kind = PerturbedBoxMesh if mesh == "perturbed" else BoxMesh
        # one mesh per cell count, so its host geometry is computed once
        meshes = {nc: kind(nc), nc4: kind(nc4)}
        for pc in ("jacobi", "cheb", "hmg"):
            timers._records.clear()
            buf = io.StringIO()
            ts = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                iters[pc] = mod.main(["--ndofs", "2000000", "--pc", pc,
                                      "--mesh", mesh],
                                     mesh=meshes[nc4 if pc == "hmg" else nc])
            keep = [line for line in buf.getvalue().splitlines()
                    if line.startswith(("mesh", "h-MG", "Chebyshev", "CG",
                                        "final"))]
            print(f"    {mesh} {pc}: " + "; ".join(keep) + f"; solve "
                  f"{timers._records['ZZZ Solve'][1]:.3f} s, run "
                  f"{time.perf_counter() - ts:.1f} s")
        if not iters["hmg"] < iters["jacobi"]:
            raise AssertionError(f"{mesh}: hmg-CG {iters['hmg']} iterations "
                                 f"not below Jacobi-CG's {iters['jacobi']}")


def direct_coarse(cfg):
    """Phase 18b: ``coarse="direct"`` (the host f64 Cholesky of the p=1
    matrix, 3,375 dofs) against ``coarse="fdm"`` at nc=14, p=(1, 3, 6),
    ``kron_blocked``, at the fdm run's smoother bounds: both coarse solves
    are exact, so the trajectories agree within `FUSED_TRAJ_RTOL` above
    `REF_TRAJ_FROM`."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import f_rhs
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    mesh = BoxMesh((14, 14, 14))
    b = torch.tensor(assemble_rhs(mesh, cfg["degrees"][-1], f_rhs(2.0)),
                     dtype=torch.float32, device="cuda")
    r0 = float(torch.linalg.vector_norm(b))
    res, lmax = {}, None
    for coarse in ("fdm", "direct"):
        ts = time.perf_counter()
        h = PMGHierarchy(mesh, operator="kron_blocked",
                         **dict(cfg, coarse=coarse))
        setup = time.perf_counter() - ts
        if lmax is None:
            lmax = [lv["lmax"] for lv in h.data["levels"]]
        else:
            h.load_state({"levels": [{"lmax": v} for v in lmax]})
        _, rn = h.solve(b, num_cycles=10)
        res[coarse] = np.array(rn) / r0
        print(f"    {coarse}: setup {setup:.2f} s, rel "
              f"{[f'{v:.3e}' for v in res[coarse]]}, FCG "
              f"{h.solve_pcg(b, rtol=1e-6)[1]}, V-cycle "
              f"{vcycle_ms(h)[0]:.3f} ms")
    traj = traj_diff(res["direct"], res["fdm"])
    print(f"    direct vs fdm coarse: trajectory max rel diff (cycles above "
          f"{REF_TRAJ_FROM:g}) {traj:.3e} (gate {FUSED_TRAJ_RTOL:g})")
    if not traj <= FUSED_TRAJ_RTOL:
        raise AssertionError(f"direct and fdm trajectories differ: {traj}")


def line_semicoarsened():
    """Phase 18c: the anisotropy case, stretched cells ``BoxMesh((16, 16,
    32), extent=(1, 1, 0.25))`` (64:1 coupling), p=(1, 3), float64, plain
    torch ``kron``, ``coarse="hmg"`` on ``semicoarsen_sizes`` of
    ``semicoarsen_axes`` with the line smoother ('line', resolving to z) on
    the p- and h-levels, against the point-Jacobi hierarchy on the same
    h-levels: FCG(V) to 1e-10 must take fewer iterations."""
    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import f_gauss
    from pmg_dolfinx_tpu_torch.solvers.hmg import (
        semicoarsen_axes,
        semicoarsen_sizes,
    )
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    mesh = BoxMesh((16, 16, 32), extent=(1.0, 1.0, 0.25))
    axes = semicoarsen_axes(mesh, 2.0)
    sizes = semicoarsen_sizes(mesh.nc, axes)
    b = torch.tensor(assemble_rhs(mesh, 3, f_gauss), dtype=torch.float64,
                     device="cuda")
    iters = {}
    for sm in ("line", "cheb"):
        ts = time.perf_counter()
        h = PMGHierarchy(mesh, degrees=(1, 3), kappa=2.0,
                         dtype=torch.float64, operator="kron", coarse="hmg",
                         coarse_cfg=dict(sizes=sizes, smoother=sm),
                         smoother=sm, device="cuda")
        setup = time.perf_counter() - ts
        _, iters[sm] = h.solve_pcg(b, rtol=1e-10, maxiter=200)
        print(f"    {sm}: line axis {h.levels[-1].line_axis if sm == 'line' else '-'}, "
              f"h-levels {sizes} (axes {axes}), setup {setup:.2f} s, FCG(V) "
              f"to 1e-10: {iters[sm]}, V-cycle {vcycle_ms(h)[0]:.3f} ms")
    if not iters["line"] < iters["cheb"]:
        raise AssertionError(f"line FCG(V) {iters['line']} not below point "
                             f"Jacobi's {iters['cheb']}")


# --- the coefficient and boundary-condition family (phases 3f, 19-21) ---------

# The JAX driver's ``--grade z:8 --neumann x --robin y``: x Neumann, y
# Robin (alpha 2) on both faces, z Dirichlet, z graded (ratio 8).
MIX_FACES = ((False, False), (False, False), (True, True))
MIX_ROBIN = ((0.0, 0.0), (2.0, 2.0), (0.0, 0.0))
GRADE_RATIO = 8.0
# ``--kappa-field aniso-diag``: the grid-aligned tensor diag(1, 1, 100).
ANISO_DIAG = (1.0, 1.0, 100.0)


def mixed_mesh(nc):
    """`BoxMesh((nc,) * 3)` with `MIX_FACES`, `MIX_ROBIN` and z graded."""
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh, geometric_spacing

    return BoxMesh((nc, nc, nc), dirichlet_faces=MIX_FACES, robin=MIX_ROBIN,
                   spacing=(None, None, geometric_spacing(nc, GRADE_RATIO)))


def mixed_problem(mesh, **cfg):
    """The JAX driver's mixed-BC problem on ``mesh`` (kappa 2): the
    manufactured `u_exact_mixed`, its source and Robin data."""
    from pmg_dolfinx_tpu_torch.models import poisson as pm

    u = pm.u_exact_mixed(MIX_FACES)
    g = pm.robin_data(2.0, u, pm.grad_u_exact_mixed(MIX_FACES), MIX_ROBIN)
    return pm.PoissonProblem(mesh=mesh, f=pm.f_rhs_mixed(2.0, MIX_FACES),
                             u_exact=u, robin_g=g, **cfg)


def reset(*modules):
    for mod in modules:
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0


def add_launches(launches, counts, need):
    """Raise unless each kernel of ``need`` launched (``counts`` read just
    after the path); add the counts to the kernels line's ``launches``."""
    if not all(counts[k] > 0 for k in need):
        raise AssertionError(f"a kernel of {need} was not launched: {counts}")
    for k in need:
        launches[k] += counts[k]


def check_rel(tag, got, ref, tol=KERNEL_RTOL):
    import torch

    torch.cuda.synchronize()
    err = rel_max_err(got, ref)
    print(f"    {tag}: rel max err {err:.3e} (gate {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{tag}: {err:.3e} > {tol:g}")
    return err


def coeff_operand_parity():
    """Phase 3f: kernels #1-#3, #4/#7 and #12 on this slice's operands,
    the first non-Toeplitz, Robin-ended factors they see: 253^3 (nc=42,
    p=6), x Neumann, y Robin (alpha 2), z Dirichlet and graded (ratio 8),
    per-axis kappa (1, 2, 4); #1-#3 with the separable masks, #4 and #7
    (init and loop step) with the box marker as the fused smoother gives
    it, sigma in {0, 0.5}; #12 at 127^3 on the same kind of mesh. Each
    within `KERNEL_RTOL` of its plain version."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.ops import kron_fused as kf
    from pmg_dolfinx_tpu_torch.ops.kron import KronLaplacian, kron_diagonal

    P, kappa = 6, (1.0, 2.0, 4.0)
    mesh = mixed_mesh(42)
    op = KronLaplacian(mesh, P, kappa=kappa, dtype=torch.float32,
                       device="cuda")
    shape = mesh.lattice_shape(P)
    masks = kb.checked_face_masks(mesh, P, mesh.boundary_dof_marker(P))
    if masks is None:
        raise AssertionError("the mixed box marker must be separable")
    mats = kb.symmetrized_mats(op.Ks, op.ms, face_masks=masks, band=P,
                               device="cuda")
    rng = np.random.default_rng(SEED + 14)
    x, r, b = (torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                            device="cuda") for _ in range(3))
    bc = op.bc_marker.reshape(shape)
    dinv = 1.0 / kron_diagonal(op.Ks, op.ms, op.bc_marker).reshape(shape)
    lmax = torch.tensor(2.2, dtype=torch.float32, device="cuda")
    for sigma in (0.0, 0.5):
        tag = f"{shape} sigma={sigma}"
        t1 = kb.plain_t1_m(x, mats)
        check_rel(f"{tag} #1 t1_m", kb.kron_t1_m(x, mats), t1)
        check_rel(f"{tag} #2 t23_m", kb.kron_t23_m(x, t1, mats, sigma),
                  kb.plain_t23_m(x, t1, mats, sigma))
        check_rel(f"{tag} #3 t23_res_m",
                  kb.kron_t23_m(x, t1, mats, sigma, r3=r),
                  r - kb.plain_t23_m(x, t1, mats, sigma))
        t1f = kb.plain_t1(x, bc, mats)
        check_rel(f"{tag} #4 t1", kb.kron_t1(x, bc, mats), t1f)
        init = kb.plain_cheb_step(x, bc, x, b, dinv, kb.cheb_coefs(
            lmax, 0, torch.float32, "cuda"), mats, sigma, t1=t1f)
        got = kb.kron_t23_cheb(x, bc, t1f, mats, x, b, dinv, lmax, 0, sigma)
        for part, g, w in zip("xrz", got, init):
            check_rel(f"{tag} #7 t23_cheb init {part}'", g, w)
        t1z = kb.plain_t1(init[2], bc, mats)
        loop = kb.plain_cheb_step(init[2], bc, init[0], init[1], dinv,
                                  kb.cheb_coefs(lmax, 1, torch.float32,
                                                "cuda"), mats, sigma, t1=t1z)
        got = kb.kron_t23_cheb(init[2], bc, t1z, mats, init[0], init[1],
                               dinv, lmax, 1, sigma)
        for part, g, w in zip("xrz", got, loop):
            check_rel(f"{tag} #7 t23_cheb loop {part}'", g, w)
    del op, mats, x, r, b, bc, dinv, init, loop, got
    m21 = mixed_mesh(21)
    opf = kf.PallasKronLaplacian(m21, P, kappa=kappa, device="cuda")
    x = torch.tensor(rng.standard_normal(m21.num_dofs(P), dtype=np.float32),
                     device="cuda")
    check_rel(f"{opf.shape} #12 kron_fused", opf(x),
              kf.plain_kron_fused(x.reshape(opf.shape), opf.bc3, opf.Ks,
                                  opf.planes).reshape(-1))


def box_family(mesh, launches):
    """Phase 19a/19b at 16,194,277 dofs (p=(1,3,6), float32, kron_blocked +
    fdm). 19a: the JAX driver's ``--grade z:8 --neumann x --robin y``
    (kappa 2): FCG(V) to 1e-6 within 50, L2 < 1e-4, ms per V-cycle, #1-#3
    launches. 19b on ``mesh`` (phase 4's uniform box, whose host geometry
    is cached): ``--kappa-field aniso-diag``: FCG(V) count, ms per
    V-cycle; the ``--fdm`` one-shot direct solve against the FCG solution,
    and its L2 < 1e-4 at nc=21. Returns ({tag: (FCG, ms per V-cycle)},
    19a's L2 job for `check_l2`)."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs, l2_error
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import (
        PoissonProblem,
        f_rhs_tensor,
        u_exact,
    )
    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.solvers.fdm import FastDiagonalizationSolver

    cfg = dict(degrees=(1, 3, 6), dtype=torch.float32, coarse="fdm",
               operator="kron_blocked", device="cuda")
    need = ("t1_m", "t23_m", "t23_res_m")
    out = {}
    t0 = phase("19a. box family: --grade z:8 --neumann x --robin y, 16.2M "
               "dofs, p=(1,3,6), kron_blocked + fdm")
    reset(kb)
    ts = time.perf_counter()
    prob = mixed_problem(mixed_mesh(42), kappa=2.0, **cfg)
    torch.cuda.synchronize()
    print(f"    setup seconds: {time.perf_counter() - ts:.2f} (eig max per "
          f"level {[round(float(e[-1]), 4) for e in prob.hierarchy.eigs]})")
    u, niter = prob.hierarchy.solve_pcg(prob.b, rtol=1e-6, maxiter=50)
    torch.cuda.synchronize()
    path = dict(kb.LAUNCHES)
    print(f"    FCG(V) iterations to rtol 1e-6: {niter}; launches {path}")
    if not niter < 50 or not bool(torch.isfinite(u).all()):
        raise AssertionError(f"19a: FCG {niter}, finite "
                             f"{bool(torch.isfinite(u).all())}")
    add_launches(launches, path, need)
    # The host L2 (numpy, ~100 s at this size) runs on a worker thread
    # while the card goes on; `check_l2` joins it.
    pool = ThreadPoolExecutor(max_workers=1)
    l2_job = (pool.submit(prob.error_l2, u.double().cpu().numpy()),
              time.perf_counter())
    pool.shutdown(wait=False)
    vc, vc_all = vcycle_ms(prob.hierarchy)
    print(f"    V-cycle {vc:.3f} ms (10 back-to-back, 3 reps "
          f"{[round(t, 3) for t in vc_all]}); the L2 error runs on a host "
          "thread")
    out["19a"] = (niter, vc)
    del prob, u
    done(t0)

    t0 = phase("19b. box family: --kappa-field aniso-diag (diag(1,1,100)), "
               "16.2M dofs, kron_blocked + fdm; the --fdm one-shot solve")
    K = np.diag(ANISO_DIAG)
    f = f_rhs_tensor(K)
    reset(kb)
    ts = time.perf_counter()
    prob = PoissonProblem(mesh=mesh, kappa=K, f=f, **cfg)
    torch.cuda.synchronize()
    print(f"    setup seconds: {time.perf_counter() - ts:.2f} (kappa_axes "
          f"{prob.hierarchy.kappa_axes})")
    u, niter = prob.hierarchy.solve_pcg(prob.b, rtol=1e-6, maxiter=200)
    torch.cuda.synchronize()
    path = dict(kb.LAUNCHES)
    print(f"    FCG(V) iterations to rtol 1e-6: {niter}; launches {path}")
    if not niter < 200 or not bool(torch.isfinite(u).all()):
        raise AssertionError(f"19b: FCG {niter}")
    add_launches(launches, path, need)
    vc, vc_all = vcycle_ms(prob.hierarchy)
    print(f"    V-cycle {vc:.3f} ms (10 back-to-back, 3 reps "
          f"{[round(t, 3) for t in vc_all]})")
    out["19b"] = (niter, vc)
    fdm = FastDiagonalizationSolver(mesh, 6, kappa=K, dtype=torch.float32,
                                    device="cuda")
    fdm.solve(prob.b)
    t_fdm = cuda_ms(lambda: fdm.solve(prob.b), reps=5, warmup=1)
    d = float(torch.linalg.vector_norm(fdm.solve(prob.b) - u)
              / torch.linalg.vector_norm(u))
    print(f"    --fdm one-shot solve: {t_fdm:.3f} ms; against the FCG "
          f"solution: rel diff {d:.3e} (gate 1e-3)")
    if not d <= 1e-3:
        raise AssertionError(f"19b: FDM and FCG solutions differ by {d}")
    del prob, u, fdm
    m21 = BoxMesh((21, 21, 21))
    fdm = FastDiagonalizationSolver(m21, 6, kappa=K, dtype=torch.float32,
                                    device="cuda")
    b21 = torch.tensor(assemble_rhs(m21, 6, f), dtype=torch.float32,
                       device="cuda")
    err = l2_error(m21, 6, fdm.solve(b21).double().cpu().numpy(), u_exact)
    print(f"    --fdm one-shot at nc=21: L2 error {err:.4e}")
    if not err < 1e-4:
        raise AssertionError(f"19b: FDM L2 error {err}")
    done(t0)
    return out, l2_job


def check_l2(job):
    """Join phase 19a's L2 thread: L2 < 1e-4."""
    future, started = job
    err = future.result()
    print(f"    19a (joined): L2 error vs u_exact_mixed {err:.4e} (the host "
          f"thread started {time.perf_counter() - started:.1f} s ago)")
    if not err < 1e-4:
        raise AssertionError(f"19a: L2 error {err}")


def box_family_fused(launches):
    """Phase 19c: at nc=21, 19a's problem on the fused hierarchy
    (``fuse_smoother=True, fuse_transfers=True``: #4/#7/#10/#11) at the
    unfused one's smoother bounds: one V-cycle on a seeded random rhs and
    iterate within `SCHWARZ_VCYCLE_RTOL`; FCG(V) within one of the
    unfused count."""
    import torch

    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.ops import transfer as tt
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    cfg = dict(degrees=(1, 3, 6), kappa=2.0, dtype=torch.float32,
               coarse="fdm", operator="kron_blocked", device="cuda")
    prob = mixed_problem(mixed_mesh(21), **cfg)
    ref = prob.hierarchy
    reset(kb, tt)
    fused = PMGHierarchy(prob.mesh, fuse_smoother=True, fuse_transfers=True,
                         **cfg)
    fused.load_state({"levels": [{"lmax": lv["lmax"]}
                                 for lv in ref.data["levels"]]})
    err = vcycle_pair_parity(fused, ref, SEED + 19)
    _, n_f = fused.solve_pcg(prob.b, rtol=1e-6, maxiter=50)
    torch.cuda.synchronize()
    path = {**kb.LAUNCHES, **tt.LAUNCHES}
    _, n_u = ref.solve_pcg(prob.b, rtol=1e-6, maxiter=50)
    print(f"    fused vs unfused, one V-cycle (seeded rhs and iterate, the "
          f"same lmax): rel max err {err:.3e} (gate "
          f"{SCHWARZ_VCYCLE_RTOL:g}); FCG(V) {n_f} vs {n_u}; launches {path}")
    if not err <= SCHWARZ_VCYCLE_RTOL:
        raise AssertionError(f"19c: fused and unfused V-cycles differ {err}")
    if abs(n_f - n_u) > 1:
        raise AssertionError(f"19c: FCG counts {n_f} vs {n_u}")
    add_launches(launches, path, ("t1", "t23_cheb", "transfer_x",
                                  "transfer_yz"))


def general_family(mesh, launches, vc_curved):
    """Phase 20 (lattice_blocked, K-A / K-B). 20a on ``mesh`` (phase 4's
    uniform box at 16.2M): ``--kappa-field aniso`` (`kappa_aniso`, 100:1
    rotated 30 degrees, folded into G), ``coarse="cg"``, FCG(V) to 1e-6
    within 100, ms per V-cycle beside phase 7's curved cycle
    (``vc_curved``), K-A launches; its L2 < 1e-4 at nc=21. 20b at nc=21:
    `kappa_linear` with ``coarse="hmg"`` and `sigma_linear` with
    ``coarse="cg"``: FCG(V) within one of the plain ``lattice``
    hierarchy's, L2 < 1e-4 (`kappa_linear`: within 1% of the plain
    solve's, the DG-0 coefficient's own h^2 error), one V-cycle within
    `SCHWARZ_VCYCLE_RTOL` of the plain hierarchy's at its smoother
    bounds. 20c: K-B (``variant="geom"``) with `kappa_linear` on
    ``mesh`` through its operator class, within `KERNEL_RTOL` of its plain
    version. Returns {tag: (FCG, ms per V-cycle)}."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.models import poisson as pm
    from pmg_dolfinx_tpu_torch.ops import lattice_blocked as lb
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    cfg = dict(degrees=(1, 3, 6), dtype=torch.float32,
               operator="lattice_blocked", device="cuda")
    out = {}
    t0 = phase("20a. general family: --kappa-field aniso (100:1 rotated 30 "
               "degrees), 16.2M dofs, lattice_blocked + cg")
    K = pm.kappa_aniso()
    f = pm.f_rhs_tensor(K)
    reset(lb)
    ts = time.perf_counter()
    prob = pm.PoissonProblem(mesh=mesh, kappa=K, f=f, coarse="cg", **cfg)
    torch.cuda.synchronize()
    print(f"    setup seconds: {time.perf_counter() - ts:.2f}; peak host RSS "
          f"{peak_rss_gb():.1f} GB")
    u, niter = prob.hierarchy.solve_pcg(prob.b, rtol=1e-6, maxiter=100)
    torch.cuda.synchronize()
    path = dict(lb.LAUNCHES)
    print(f"    FCG(V) iterations to rtol 1e-6: {niter}; launches {path}")
    if not niter < 100 or not bool(torch.isfinite(u).all()):
        raise AssertionError(f"20a: FCG {niter}")
    add_launches(launches, path, ("lattice_apply",))
    vc, vc_all = vcycle_ms(prob.hierarchy)
    print(f"    V-cycle {vc:.3f} ms (10 back-to-back, 3 reps "
          f"{[round(t, 3) for t in vc_all]}); phase 7's curved cycle "
          f"{vc_curved:.3f} ms")
    out["20a"] = (niter, vc)
    del prob, u
    reset(lb)
    p21 = pm.PoissonProblem(mesh=BoxMesh((21, 21, 21)), kappa=K, f=f,
                            coarse="cg", **cfg)
    u, n21 = p21.hierarchy.solve_pcg(p21.b, rtol=1e-6, maxiter=100)
    add_launches(launches, dict(lb.LAUNCHES), ("lattice_apply",))
    err = p21.error_l2(u)
    print(f"    at nc=21: FCG(V) {n21}, L2 error {err:.4e}")
    if not err < 1e-4:
        raise AssertionError(f"20a: L2 error at nc=21 {err}")
    del p21, u
    done(t0)

    t0 = phase("20b. general family at nc=21: kappa_linear + hmg, "
               "sigma_linear + cg; lattice_blocked vs plain lattice")
    m21 = BoxMesh((21, 21, 21))
    for tag, kw in (
            ("kappa_linear + hmg", dict(kappa=pm.kappa_linear,
                                        f=pm.f_rhs_variable(), coarse="hmg")),
            ("sigma_linear + cg", dict(kappa=2.0, sigma=pm.sigma_linear,
                                       f=pm.f_rhs_sigma_field(2.0),
                                       coarse="cg"))):
        reset(lb)
        prob = pm.PoissonProblem(mesh=m21, **kw, **cfg)
        u, niter = prob.hierarchy.solve_pcg(prob.b, rtol=1e-6, maxiter=50)
        torch.cuda.synchronize()
        path = dict(lb.LAUNCHES)
        err = prob.error_l2(u)
        plain = PMGHierarchy(m21, **{k: v for k, v in kw.items()
                                     if k != "f"},
                             **dict(cfg, operator="lattice"))
        u_p, n_p = plain.solve_pcg(prob.b, rtol=1e-6, maxiter=50)
        err_p = prob.error_l2(u_p)
        prob.hierarchy.load_state({"levels": [
            {"lmax": lv["lmax"]} for lv in plain.data["levels"]]})
        d = vcycle_pair_parity(prob.hierarchy, plain, SEED + 20)
        # The DG-0 kappa (1 + x sampled at the centroids) converges as h^2
        # whatever the degree: at nc=21 its L2 is the coefficient's, so it
        # is held to the plain hierarchy's instead of 1e-4.
        l2_gate = 1.01 * err_p if callable(kw["kappa"]) else 1e-4
        print(f"    {tag}: FCG(V) {niter} (plain {n_p}), L2 {err:.4e} "
              f"(plain {err_p:.4e}; gate {l2_gate:.4e}), V-cycle "
              f"{vcycle_ms(prob.hierarchy)[0]:.3f} ms; one V-cycle vs the "
              f"plain lattice hierarchy (its lmax): rel max err {d:.3e}; "
              f"launches {path}")
        if not (niter < 50 and abs(niter - n_p) <= 1 and err < l2_gate
                and d <= SCHWARZ_VCYCLE_RTOL):
            raise AssertionError(f"20b {tag}: FCG {niter} / {n_p}, L2 "
                                 f"{err} / {err_p}, V-cycle diff {d}")
        add_launches(launches, path, ("lattice_apply",))
        out[f"20b {tag}"] = (niter, None)
        del prob, plain, u, u_p
    done(t0)

    t0 = phase("20c. K-B (variant='geom') with kappa_linear at 253^3 (16.2M "
               "dofs), p=6")
    reset(lb)
    op = lb.PallasLatticeBlocked(mesh, 6, kappa=pm.kappa_linear,
                                 variant="geom", device="cuda")
    x = torch.tensor(np.random.default_rng(SEED + 17).standard_normal(
        op.ndofs, dtype=np.float32), device="cuda")
    y = op(x)
    ms = cuda_ms(lambda: op(x))
    torch.cuda.synchronize()
    path = dict(lb.LAUNCHES)
    add_launches(launches, path, ("lattice_apply_geom",))
    print(f"    PallasLatticeBlocked(kappa=kappa_linear, variant='geom'): "
          f"{ms:.4f} ms per apply ({op.ndofs / ms / 1e6:.3f} GDOF/s); "
          f"launches {path}; co[36] spans "
          f"[{float(op.co[36].min()):.4f}, {float(op.co[36].max()):.4f}]")
    check_rel("20c K-B vs plain", y, lb.plain_lattice_apply_geom(
        x, op.mats, op.co, op.bc_marker, mesh.nc, 6))
    done(t0)
    return out


def serving_family(launches):
    """Phase 21: serving at 61^3, p=6, kappa (1, 1, 100), z graded (ratio
    8), x Neumann: #18-#21 through the four packed classes within
    `KERNEL_RTOL` of their plain versions; heat CN (dt 1e-4) at B=1 and
    B=8 through `heat_packed_evolve`, each column after 20 steps within
    1e-4 of `heat_fdm_evolve`'s in float64 (plain torch FDM steps; the
    stiff z modes keep CN's f32 rounding undamped, so longer runs compare
    noise), steps/s; leapfrog at B=1 and 8 (#18/#20) within 1e-4 of
    `wave_leapfrog_evolve` over 100 steps."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh, geometric_spacing
    from pmg_dolfinx_tpu_torch.ops import kron_packed as kp
    from pmg_dolfinx_tpu_torch.solvers import transient

    P, kappa, dt = PACKED_P, ANISO_DIAG, 1e-4
    mesh = BoxMesh(PACKED_NC, dirichlet_faces=((False, False), (True, True),
                                               (True, True)),
                   spacing=(None, None, geometric_spacing(PACKED_NC[2],
                                                          GRADE_RATIO)))
    n = mesh.num_dofs(P)
    rng = np.random.default_rng(SEED + 21)
    for kind, B in (("PackedKronBatch", 8), ("PackedFDMBatch", 8),
                    ("PackedKronSingle", 1), ("PackedFDMSingle", 1)):
        kw = dict(kappa=kappa, sigma=1.0 / dt)
        if "Batch" in kind:
            kw["B"] = B
        op = getattr(kp, kind)(mesh, P, device="cuda", **kw)
        U = torch.tensor(rng.standard_normal((B, n) if B > 1 else n,
                                             dtype=np.float32), device="cuda")
        call = op if "Kron" in kind else op.solve
        got = call(U)
        with plain_packed():
            ref = call(U)
        check_rel(f"{kind} (B={B}) kernel vs plain", got, ref)
    c = mesh.dof_coords(P)
    u0 = np.cos(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1]) * np.sin(
        np.pi * c[:, 2])
    steps, nref = 1000, 20
    for B in (1, 8):
        U0 = torch.tensor(np.stack([u0 * (1.0 + 0.1 * j) for j in range(B)]),
                          dtype=torch.float32, device="cuda")
        reset(kp)
        ev = transient.heat_packed_evolve(mesh, P, kappa=kappa, dt=dt, B=B,
                                          scheme="cn", device="cuda")
        ev(U0, 20)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        UT = ev(U0, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - ts
        path = dict(kp.LAUNCHES)
        ref = transient.heat_fdm_evolve(mesh, P, kappa=kappa, dt=dt,
                                        scheme="cn", dtype=torch.float64,
                                        device="cuda")
        Uk = ev(U0, nref).double()
        d = max(rel_max_err(Uk[j].reshape(-1),
                            ref(U0[j].double(), nref).reshape(-1))
                for j in range(B))
        print(f"    heat CN B={B}: {steps} steps in {wall:.3f} s = "
              f"{steps / wall:.1f} steps/s ({steps * B / wall:.1f} "
              f"column-steps/s); launches {path}; {nref} steps against "
              f"heat_fdm_evolve (f64): rel max diff {d:.3e} (gate 1e-4)")
        if not bool(torch.isfinite(UT).all()) or not d <= 1e-4:
            raise AssertionError(f"21 B={B}: finite "
                                 f"{bool(torch.isfinite(UT).all())}, "
                                 f"diff {d}")
        add_launches(launches, path, ("packed_fdm",))
    # The apply kernels (#18/#20) on this path: leapfrog at 0.72 x
    # wave_stable_dt, held to `wave_leapfrog_evolve` (plain torch).
    dtw = 0.72 * transient.wave_stable_dt(mesh, P, kappa=kappa)
    for B in (1, 8):
        U0 = torch.tensor(np.stack([u0 * (1.0 - 0.05 * j) for j in range(B)]),
                          dtype=torch.float32, device="cuda")
        reset(kp)
        ev = transient.wave_packed_evolve(mesh, P, kappa=kappa, dt=dtw, B=B,
                                          scheme="leapfrog", device="cuda")
        ts = time.perf_counter()
        UT, _ = ev(U0, torch.zeros_like(U0), 100)
        torch.cuda.synchronize()
        wall = time.perf_counter() - ts
        path = dict(kp.LAUNCHES)
        ref = transient.wave_leapfrog_evolve(mesh, P, kappa=kappa, dt=dtw,
                                             dtype=torch.float32,
                                             device="cuda")
        d = max(rel_max_err(UT[j].reshape(-1), ref(
            U0[j], torch.zeros_like(U0[j]), 100)[0].reshape(-1))
            for j in range(B))
        print(f"    leapfrog B={B} (dt {dtw:.4e}): 100 steps, "
              f"{100 / wall:.1f} steps/s; launches {path}; against "
              f"wave_leapfrog_evolve: rel max diff {d:.3e} (gate 1e-4)")
        if not d <= 1e-4:
            raise AssertionError(f"21 leapfrog B={B}: diff {d}")
        add_launches(launches, path, ("packed_apply",))


def main():
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="root of a parent checkout: phases 3b-3e and 10-11 "
                    "also time its full-bc, transfer, whole-lattice, shard "
                    "and serving kernels and its steppers, in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    if not PKG.is_dir():
        raise SystemExit(f"chip_smoke: {PKG} not found; run from the root "
                         "of a checkout")
    sys.path.insert(0, str(ROOT))

    parent = load_parent(args.parent)
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

    from pmg_dolfinx_tpu_torch.ops import kron_fused as kf
    from pmg_dolfinx_tpu_torch.ops import kron_packed as kp
    from pmg_dolfinx_tpu_torch.ops import lattice_blocked as lb
    from pmg_dolfinx_tpu_torch.ops import transfer as tt

    t0 = phase("2. build kernels")
    modules = (kb, lb, kp, tt, kf)
    # The parent's kron_blocked.cu (phases 3b and 3e time it) alongside.
    builds = modules + ((importlib.import_module(
        f"{parent.__name__}.ops.kron_blocked"),) if parent else ())
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        for fut in [pool.submit(m.load_kernels) for m in builds]:
            fut.result()
    print(f"    build seconds ({len(builds)} sources, in parallel): "
          f"{time.perf_counter() - t0:.2f}")
    for mod in modules:
        if mod is kb:
            # One instantiation per band: the main path's bands 3 and 6 of
            # the marching kernels (kron_t23_m: <BAND, RESIDUAL, GRID,
            # FULL>), then the largest count over all.
            for line in ptxas_lines(kb.BUILD_LOG, (
                    "kron_t1_mILi3E", "kron_t1_mILi6E", "kron_t23_mILi3E",
                    "kron_t23_mILi6E", "kron_t23ILi"), width=40):
                print("    " + line)
            regs = [int(line.split("Used ")[1].split()[0])
                    for line in kb.BUILD_LOG.splitlines() if "Used " in line]
            spills = [line.strip() for line in kb.BUILD_LOG.splitlines()
                      if "spill" in line
                      and " 0 bytes spill stores" not in line]
            print(f"    kron_blocked.cu: {len(regs)} kernels, at most "
                  f"{max(regs, default=0)} registers; {len(spills)} with "
                  f"spills {spills[:2]}")
            continue
        if mod is tt:
            for line in ptxas_lines(tt.BUILD_LOG, ("transfer",), "transfer"):
                print("    " + line)
            continue
        if mod is lb:
            for kernel in ("lattice_march", "lattice_faces"):
                for line in ptxas_lines(lb.BUILD_LOG, (kernel,), kernel):
                    print("    " + line)
            continue
        for line in mod.BUILD_LOG.splitlines():
            if "registers" in line or "spill" in line:
                print("    " + line.strip())
    done(t0)

    t0 = phase("3. kernel parity vs plain torch")
    _, dev_127, _, host = kernel_parity(21, 6, host_cost=True)
    main_shape, dev_253, lib_t1, _ = kernel_parity(42, 6)
    library = {"t1_m": lib_t1}
    # The shapes the V-cycles launch at their coarser levels (the single
    # device's 127^3 at band 3; the (2, 2, 2) grid's shards at 64^3, band
    # 3, and 22^3, band 1; 43^3 at band 1), and the highest bands.
    dev_more = {}
    for nc, P in ((42, 3), (21, 3), (42, 1), (21, 1), (12, 10), (8, 16)):
        dev_more[f"{nc * P + 1}^3 band {P}"] = kernel_parity(nc, P)[1]
    done(t0)

    extra = {}   # each kernel's further keys of the kernels line
    t0 = phase("3b. full-bc kernels #4-#7 vs plain torch, non-separable "
               "marker")
    _, _, t1_127 = full_bc_parity(21, 6)
    # 127^3 at band 3 is the shape of the main path's p=3 level.
    band3, _, t1_band3 = full_bc_parity(42, 3)
    full_bc, launches, t1_253 = full_bc_parity(42, 6, path=True)
    library["t1"] = t1_253["library_ms"]
    main_shape.update({k: (max(v[0], band3[k][0]),) + v[1:]
                       for k, v in full_bc.items()})
    # #5 / #6 as device time at 3b's shapes and at phase 3's bands 1, 10
    # and 16, beside #2 / #3 (and, with --parent, the parent's).
    march = {}
    for nc, P in ((42, 6), (21, 6), (42, 3), (42, 1), (12, 10), (8, 16)):
        full_bc_march(nc, P, march, parent)
    for name in ("t23", "t23_res"):
        march[name]["device_ms"] = march[name]["device_ms_by_shape"][
            "253^3 band 6"]
    extra.update(march)
    done(t0)

    t0 = phase("3c. transfer kernels #10/#11 vs plain torch: 253^3 <-> "
               "127^3 and 127^3 <-> 43^3")
    res_t, bounds, lib_t, extra_t = transfer_parity(parent)
    main_shape.update(res_t)
    library.update(lib_t)
    done(t0)

    t0 = phase("3d. PallasKronLaplacian (kernel #12): 2,048,383 dofs, p=6")
    res_k, launches["kron_fused"], bounds["kron_fused"], extra_k = \
        kron_fused_path(parent)
    main_shape.update(res_k)
    done(t0)

    t0 = phase("3e. device-grid kernels #8/#9 vs plain torch: per-shard "
               "127^3 and 253x127x127, and the grid entry point")
    _, _, dev9_253 = grid_kernel_parity((42, 21, 21), 6, extra, parent)
    res_g, bounds_g, dev9_127 = grid_kernel_parity((21, 21, 21), 6, extra,
                                                   parent)
    extra["t23_grid"]["device_ms"] = extra["t23_grid"][
        "device_ms_by_shape"]["127x127x127 band 6 apply"]
    # The grid V-cycle's p=3 and p=1 shards.
    dev9_more = {f"{21 * P + 1}^3 band {P}":
                 grid_kernel_parity((21, 21, 21), P, extra, parent)[2]
                 for P in (3, 1)}
    main_shape.update(res_g)
    bounds.update(bounds_g)
    launches["t23_grid"] = grid_entry_point()
    done(t0)

    t0 = phase("3f. kernels #1-#3, #4/#7 and #12 on graded, Robin-ended "
               "factors with per-axis kappa (253^3 and 127^3)")
    coeff_operand_parity()
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
    launches.update({k: v for k, v in kb.LAUNCHES.items()
                     if k.endswith("_m")})
    print(f"    FCG(V) iterations to rtol 1e-6: {niter} ({pcg_s:.3f} s host "
          "clock)")
    if not niter < 50:
        raise AssertionError("FCG did not converge within 50 iterations")
    if tuple(u.shape) != (prob.mesh.num_dofs(6),) or not bool(
            torch.isfinite(u).all()):
        raise AssertionError("solution is not a finite vector of ndofs")
    print(f"    kernel launches on the main path: {dict(kb.LAUNCHES)}")
    if not all(kb.LAUNCHES[k] > 0 for k in ("t1_m", "t23_m", "t23_res_m")):
        raise AssertionError(f"a kernel was not launched: {kb.LAUNCHES}")
    vc_blk, vc_blk_all = vcycle_ms(hier)
    print(f"    V-cycle {vc_blk:.3f} ms (kron_blocked kernels; 10 "
          f"back-to-back, 3 reps {[round(t, 3) for t in vc_blk_all]})")
    b1 = torch.ones_like(prob.b)
    hier.apply(b1, torch.zeros_like(b1))
    _, busy, nk, _ = profile_busy(lambda: hier.apply(b1, torch.zeros_like(b1)))
    print(f"    device busy per V-cycle {busy:.3f} ms ({nk} kernels, "
          f"torch.profiler) of the back-to-back {vc_blk:.3f} ms: idle "
          f"{max(0.0, 1 - busy / vc_blk):.1%}")
    ts = time.perf_counter()
    err = prob.error_l2(u)
    print(f"    L2 error vs manufactured solution: {err:.4e} "
          f"({time.perf_counter() - ts:.1f} s host)")
    if not err < 1e-4:
        raise AssertionError(f"L2 error {err} too large")
    ts = time.perf_counter()
    plain_hier = PMGHierarchy(BoxMesh((42, 42, 42)), operator="kron", **cfg)
    torch.cuda.synchronize()
    print(f"    plain kron PMGHierarchy setup seconds (no rhs): "
          f"{time.perf_counter() - ts:.2f}")
    vc_plain, vc_plain_all = vcycle_ms(plain_hier)
    print(f"    V-cycle {vc_plain:.3f} ms (plain torch kron; 10 "
          f"back-to-back, 3 reps {[round(t, 3) for t in vc_plain_all]})")
    # The f32 spread of two correct operators at this size (phase 14
    # compares the device grid against the same single-device trajectory).
    _, rn_plain = plain_hier.solve(prob.b, num_cycles=10)
    rel_plain = [v / r0 for v in rn_plain]
    spread = traj_diff(rel_plain, rel)
    print(f"    plain kron trajectory: rel {[f'{v:.4e}' for v in rel_plain]}; "
          f"max rel diff from kron_blocked's (cycles above "
          f"{REF_TRAJ_FROM:g}) {spread:.3e}")
    del plain_hier
    vc_blk2, _ = vcycle_ms(hier)
    print(f"    V-cycle again {vc_blk2:.3f} ms (kron_blocked)")
    done(t0)

    t0 = phase("4b. fused main path: 16.2M dofs, kron_blocked + fdm, "
               "fuse_smoother=True")
    fused, u_fused, rel_fused = fused_path(prob, hier, rel, u, niter, cfg,
                                           launches)
    done(t0)

    t0 = phase("4c. solve_refined on the fused hierarchy: f64 outer "
               "residual, 16.2M dofs")
    refined_path(fused, prob.b)
    done(t0)

    t0 = phase("4d. W-cycle and FMG at nc=21 (2,048,383 dofs), fused")
    cycle_modes(cfg)
    done(t0)

    t0 = phase("4e. fused p-transfers: 16.2M dofs, kron_blocked + fdm, "
               "fuse_transfers=True (alone and with fuse_smoother)")
    fused_transfer_path(prob, hier, fused, rel, rel_fused, niter, cfg,
                        launches)
    del fused, u_fused
    done(t0)

    t0 = phase("14. device-grid main path (run here, on phase 4's mesh, rhs "
               "and hierarchy): GridPMG (2,2,2), 16.2M dofs, kron_blocked + "
               "fdm, every shard on this card")
    grid_path(prob, hier, rel, u, niter, spread, cfg, launches)
    done(t0)

    t0 = phase("15. Schwarz flagship (run here, on phase 4's mesh and rhs): "
               "16.2M dofs, p=(1,3,6), kron_blocked + fdm, smoother=schwarz")
    del hier
    hier_sw = schwarz_flagship(prob, niter, cfg, launches)
    done(t0)

    t0 = phase("18d. device-grid Schwarz (run here, on phase 4's mesh and "
               "rhs): GridPMG (2,2,2), 16.2M dofs, kron_blocked + fdm, "
               "smoother=schwarz")
    grid_schwarz(prob, hier_sw, cfg, launches)
    box42 = prob.mesh   # its host geometry serves phases 19b and 20
    del prob, u, hier_sw
    done(t0)

    family, l2_19a = box_family(box42, launches)
    t0 = phase("19c. box family at nc=21: --grade z:8 --neumann x --robin y, "
               "fuse_smoother + fuse_transfers vs unfused")
    box_family_fused(launches)
    done(t0)

    t0 = phase("5. in-card reference: nc=21, kron (plain) vs kron_blocked, "
               "unfused and fused")
    res = {}
    lmax = None
    for tag in ("kron", "kron_blocked", "kron_blocked fused"):
        op, fuse = tag.split()[0], tag.endswith("fused")
        if not fuse:
            prob = PoissonProblem(nc=(21, 21, 21), operator=op, **cfg)
            h = prob.hierarchy
        else:
            # The fused smoother on every level (p=6 at band 6 and p=3 at
            # band 3), on the unfused run's mesh and rhs.
            h = PMGHierarchy(prob.mesh, operator=op, fuse_smoother=True,
                             **cfg)
        levels = h.data["levels"]
        print(f"    {tag}: own calibration lmax "
              f"{[float(lv['lmax']) for lv in levels]}")
        if lmax is None:
            lmax = [lv["lmax"] for lv in levels]
        else:
            # Run every cycle with the same smoother bounds, so the
            # comparison sees the operators and not two f32 calibrations.
            h.load_state({"levels": [{"lmax": v} for v in lmax]})
        r0 = float(torch.linalg.vector_norm(prob.b))
        _, rn = h.solve(prob.b, num_cycles=10)
        u, niter = h.solve_pcg(prob.b, rtol=1e-6, maxiter=50)
        res[tag] = (np.array(rn) / r0, niter, u, prob.error_l2(u),
                    vcycle_ms(h)[0])
        print(f"    {tag}: rel {[f'{v:.3e}' for v in res[tag][0]]}, FCG "
              f"{niter}, L2 {res[tag][3]:.4e}, V-cycle {res[tag][4]:.3f} ms")
    rk, nk, uk, _, _ = res["kron"]
    # The f32 residual stalls near 2.4e-4 relative at this size; within
    # ~20x of that floor the two operators' roundings alone move the
    # residual by ~1e-3, so the trajectories are compared above 5e-3.
    for tag in ("kron_blocked", "kron_blocked fused"):
        rb, nb, ub, _, _ = res[tag]
        traj = traj_diff(rb, rk)
        print(f"    {tag} vs kron: trajectory max rel diff (cycles above "
              f"{REF_TRAJ_FROM:g}): {traj:.3e}")
        if not traj <= 1e-3:
            raise AssertionError(f"{tag}: trajectories differ: {traj}")
        if abs(nk - nb) > 1:
            raise AssertionError(f"{tag}: FCG counts differ: {nk} vs {nb}")
        # The L2 error of an f32 solve at p=6 is the operator's f32
        # rounding (the discretization error is ~1e-11), so compare the
        # solutions.
        du = float(torch.linalg.vector_norm(ub - uk)
                   / torch.linalg.vector_norm(uk))
        print(f"    {tag} vs kron: FCG solutions relative difference "
              f"{du:.3e}")
        if not du <= 1e-3:
            raise AssertionError(f"{tag}: FCG solutions differ: {du}")
    traj = traj_diff(res["kron_blocked fused"][0], res["kron_blocked"][0])
    print(f"    fused vs unfused kron_blocked: trajectory max rel diff "
          f"{traj:.3e}")
    if not traj <= FUSED_TRAJ_RTOL:
        raise AssertionError(f"fused and unfused trajectories differ: {traj}")
    del prob, h
    done(t0)
    check_l2(l2_19a)

    from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh

    t0 = phase("6. lattice kernel parity vs plain torch")
    curved = PerturbedBoxMesh((42, 42, 42))
    _, lat21 = lattice_parity(PerturbedBoxMesh((21, 21, 21)), 6, geom=True)
    _, lat_p1 = lattice_parity(curved, 1, geom=False)
    _, lat_p3 = lattice_parity(curved, 3, geom=False)
    res_l, lat_p6 = lattice_parity(curved, 6, geom=True, zgrp=True)
    main_shape.update(res_l)
    zgrp_small()
    # K-A at the curved V-cycle's three levels, K-B and K-A on Gz at p=6
    # (nc=42), and K-A and K-B at nc=21: device time beside the bound.
    for name, rec in lat_p6.items():
        extra[name] = {
            "device_ms": rec["device_ms"], "device_share_of_bound":
            rec["bound_ms"] / rec["device_ms"],
            "host_us_per_launch": rec["host_us"],
            **{k: rec[k] for k in ("box", "face_scratch_bytes",
                                   "face_kernel_threads", "blocks_per_sm")
               if k in rec},
            "device_ms_by_shape": {}, "bound_ms_by_shape": {}}
    for tag, recs in (("127^3 p=3", lat_p3), ("43^3 p=1", lat_p1),
                      ("127^3 p=6 (nc=21)", lat21)):
        for name, rec in recs.items():
            extra[name]["device_ms_by_shape"][tag] = rec["device_ms"]
            extra[name]["bound_ms_by_shape"][tag] = rec["bound_ms"]
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
    b1 = torch.ones_like(prob.b)
    hier.apply(b1, torch.zeros_like(b1))
    wall, busy, nk, by_name, calls, tries, complete = profile_complete(
        lambda: hier.apply(b1, torch.zeros_like(b1)), lb)
    ka = lattice_kernel_ms(by_name)
    print(f"    profiled V-cycle ({'complete' if complete else 'INCOMPLETE'}"
          f" window, {tries} tried): wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms ({nk} kernels), of which K-A "
          f"{ka['march'] + ka['fold']:.3f} "
          f"ms ({(ka['march'] + ka['fold']) / busy:.1%}: march/cells "
          f"{ka['march']:.3f}, faces/fold {ka['fold']:.3f}); idle "
          f"{max(0.0, 1 - busy / vc_lb):.1%} of the back-to-back "
          f"{vc_lb:.3f} ms")
    # K-A by template (degree) in the profiled cycle: calls and ms.
    print("    K-A kernels in the profiled V-cycle (name: launches, ms): "
          + "; ".join(f"{n[:48]}: {calls[n]}, {ms:.3f}" for n, ms in sorted(
              by_name.items()) if "lattice_" in n))
    against_parent("7 curved", rel, niter)
    parent_gate("7 curved", rel, niter)
    curved_ref = (niter, vc_lb, busy)
    del b1
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

    for step, variant, name in (("8", "geom", "lattice_apply_geom"),
                                ("8b", "zgrp", "lattice_apply_zgrp")):
        t0 = phase(f"{step}. operator micro-benchmark entry point, "
                   f"--variant {variant}: 16.2M dofs, p=6")
        for k in lb.LAUNCHES:
            lb.LAUNCHES[k] = 0
        mf = run_mat_free(["--ndofs", "16194277", "--degree", "6", "--mesh",
                           "perturbed", "--operator", "lattice_blocked",
                           "--variant", variant, "--reps", "50"],
                          mesh=curved)
        launches[name] = lb.LAUNCHES[name]
        print(f"    kernel launches on this path: {dict(lb.LAUNCHES)}")
        if not launches[name] > 0:
            raise AssertionError(f"{name} was not launched: "
                                 f"{dict(lb.LAUNCHES)}")
        if not (mf["device"] == torch.cuda.get_device_name(0)
                and mf["ms_per_apply"] > 0):
            raise AssertionError(f"mat_free did not time the card: {mf}")
        print(f"    {name}: {mf['ms_per_apply']:.4f} ms per apply, "
              f"{mf['gdofs']:.3f} GDOF/s (examples/mat_free_torch.py, "
              f"{mf['clock']})")
        done(t0)

    t0 = phase("16. curved Schwarz (run here, on phase 7's mesh): 16.2M "
               "dofs, p=(1,3,6), lattice_blocked + cg, smoother=schwarz; "
               "then the nc=21 curved_2M_p136 Schwarz recipe")
    curved_schwarz(curved, curved_ref[0], ccfg, launches)
    done(t0)

    t0 = phase("17. curved hmg coarse (run here, on phase 7's mesh): 16.2M "
               "dofs, p=(1,3,6), lattice_blocked + hmg")
    curved_hmg(curved, *curved_ref, ccfg, launches)
    done(t0)
    del curved

    family.update(general_family(box42, launches, curved_ref[1]))
    del box42

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
    traj = traj_diff(rb, rk)
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

    t0 = phase("10. serving kernel parity vs plain torch: 61^3, p=6")
    res_p, extra_p = packed_parity(parent)
    main_shape.update(res_p)
    extra.update(extra_p)
    done(t0)

    t0 = phase("11. serving path: heat CN and wave at 61^3, p=6, B=1 and 8")
    launches.update(serving_path(parent))
    print(f"    kernel launches on the serving path: "
          f"packed_apply {launches['packed_apply']}, packed_fdm "
          f"{launches['packed_fdm']}")
    done(t0)

    t0 = phase("21. serving at 61^3, p=6: kappa (1,1,100), z graded, x "
               "Neumann; heat CN and leapfrog at B=1 and 8")
    serving_family(launches)
    done(t0)

    t0 = phase("12. heat_cn_2M recipe: heat_fdm_evolve, 2.05M dofs, p=3")
    heat_cn_2m()
    done(t0)

    t0 = phase("13. curved stepper: heat_pcg_evolve, 195k dofs, p=3")
    curved_stepper()
    print(f"    peak host RSS {peak_rss_gb():.1f} GB")
    done(t0)

    t0 = phase("18a. AMG twin: examples/amg_torch.py --ndofs 2000000 --pc "
               "jacobi|cheb|hmg, box and perturbed")
    amg_twin()
    done(t0)

    t0 = phase("18b. direct coarse: nc=14, p=(1,3,6), kron_blocked, "
               "coarse=direct vs fdm")
    direct_coarse(cfg)
    done(t0)

    t0 = phase("18c. line smoother + semicoarsened hmg: BoxMesh((16,16,32), "
               "extent (1,1,0.25)), p=(1,3), f64 kron")
    line_semicoarsened()
    print(f"    peak host RSS {peak_rss_gb():.1f} GB")
    done(t0)

    # Kernels #1-#3 and #9: besides `ms` (host-issued, as every row), the
    # device time from a CUDA graph at the main path's fine shape, at 127^3
    # and at the V-cycles' coarser shapes.
    extra.update({name: {"device_ms": dev_253[name],
                         "device_ms_127": dev_127[name],
                         "device_ms_by_shape": {k: v[name]
                                                for k, v in dev_more.items()}}
                  for name in dev_253})
    extra["t23_grid_m"] = {"device_ms": dev9_127,
                           "device_ms_253x127x127": dev9_253,
                           "device_ms_by_shape": dev9_more}
    for name in ("t1_m", "t23_m"):
        extra[name]["host_us_per_launch"] = host[name]
    # Kernel #4 (3b) and the transfers #10/#11 (3c, all four V-cycle
    # shapes), as device time.
    extra["t1"] = {
        "device_ms": t1_253["device_ms"], "device_ms_127": t1_127["device_ms"],
        "device_ms_by_shape": {"127^3 band 3": t1_band3["device_ms"]},
        "bound_ms_by_shape": {"127^3 band 3": kernel_bound("t1", 127**3,
                                                           3)[0]},
        "host_us_per_launch": t1_253["host_us"]}
    extra.update(extra_t)
    extra["kron_fused"] = extra_k
    kernels = []
    for name in SOURCES:
        if name in bounds:       # measured with its own inputs (3c, 3d)
            bound, by = bounds[name]
        elif name.startswith("lattice"):
            bound, by = kernel_bound(name, 253**3, 6, nc=(42, 42, 42))
        elif name.startswith("packed"):
            bound, by = kernel_bound(name, 61**3, PACKED_P, B=8,
                                     dims=(61, 61, 61))
        else:
            bound, by = kernel_bound(name, 253**3, 6)
        ms = main_shape[name][1]
        kernels.append(
            {"name": name, "route": "cuda", "source": SOURCES[name],
             "replaces": TPU_KERNELS[name], "launches": launches[name],
             "max_abs_err": main_shape[name][0], "ms": ms,
             "plain_ms": main_shape[name][2], "bound_ms": bound,
             "bound_by": by, "library_ms": library.get(name),
             **extra.get(name, {})})
        dev = extra.get(name, {}).get("device_ms")
        print(f"    {name}: {ms:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"{bound / ms:.0%} of the bound's rate"
              + ("" if dev is None else
                 f"; device {dev:.4f} ms, {bound / dev:.0%}"))
    print("    coefficient family (FCG(V), ms per V-cycle): " + "; ".join(
        f"{k} {n}, " + ("-" if ms is None else f"{ms:.3f}")
        for k, (n, ms) in family.items()))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
