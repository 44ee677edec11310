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
AMG-driver twin, the coefficient and boundary-condition family
(graded spacing, Neumann and Robin faces, per-axis, tensor and variable
kappa, sigma fields) and the unstructured-mesh family (the DSS and csr
operators, the DSS Schwarz smoother, the AMG coarse solve) and the
transient and extra model families (steady and implicit Newton,
convection-diffusion with BiCGStab, the semilinear serving and IMEX
steppers, modal LOBPCG), the 1D slab layer (`DistPMG`, its sweep
driver, Newton, BiCGStab and the halo micro-benchmark on the slabs) and
the gather-free coarse family and sharded time loops (`fdm_dist`, the
distributed hmg on the slab and the grid, `transient_dist`) and the
Kronecker family on the sharded layouts (Robin faces, graded spacing,
per-axis and diagonal-tensor kappa on the slab and the grid) and the
distributed unstructured path (`DSSDist`, shards stacked) and
precision="high" (bf16x3) on the Kronecker and general families through
them.
Every phase raises on failure; nothing is caught. The phases run in the
order 1, 2 (nvcc started), 18a, 18c, 25f (kernel-free, on the card while
nvcc builds), 2 (joined), 3-3f, 4-4e, 32a-32d, 14, 26a, 26b, 27a-27c, 15, 18d,
24a, 25a, 25b, 26c, 19a, 29a, 19b, 19c, 29b-29d, 5-8b, 16, 17, 28a-28e,
20a-20c, 9-11, 21, 12, 27d, 13, 18b, 22, 23a-23c, 30a, 30b, 23d, 24b,
25c-25e: 26a, 27a-27c, 15, 18d,
24a, 25a, 25b, 19b and 20c reuse phase 4's mesh (and its host geometry
factors; 25a and 26a its hierarchy, 26c and 27a 26a's), 29a 19a's mesh,
rhs and hierarchy, 16 phase 7's, 28a 17's. The 16.2M L2 errors
of phases 4, 15, 19a, 26a, 27c and 29a run on the card (`card_l2`: the host
rule's quadrature, interpolation on the card; checked after phase 5),
phase 6's 16.2M geometry factors on a host thread started in phase 4,
and phase 4's and 19a's 16.2M box geometry factors and the L-shaped
meshes of phases 22-23 on host threads started with phase 2. The script prints its seconds.

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
9. Curved in-card reference: nc=10 with ``operator="lattice"`` (plain
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
   path, on ``PerturbedBoxMesh((14, 14, 14))`` (614,125 dofs; 28a's
   mesh): first the single-device reference of 17 and 28a there
   (``lattice_blocked`` + ``cg``: 10 cycles, FCG(V), ms and busy ms per
   V-cycle, one seeded V-cycle), then ``coarse="hmg"`` (the
   rediscretised h-levels at p=1 and a dense bottom): the levels, setup
   seconds, FCG(V) within one of the ``cg``-coarse count, L2 < 1e-4, wall
   and busy ms per V-cycle and the idle share beside the ``cg`` one's.
18. The remaining entry points. a: ``examples/amg_torch.py --ndofs
   500000 --pc jacobi|cheb|hmg`` (cut from 2M for time), box and ``--mesh
   perturbed``, in this
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
   within 50, L2 < 1e-4 (`card_l2`, checked after phase 5), ms per
   V-cycle (CUDA events, 10 back-to-back, median of 3), #1-#3 launch. b: ``--kappa-field aniso-diag``
   (diag(1, 1, 100)) on phase 4's mesh: FCG(V) count and ms per V-cycle;
   the ``--fdm`` one-shot direct solve within 1e-3 of the FCG solution,
   and its L2 < 1e-4 at nc=21. c: at nc=21, a's problem with
   ``fuse_smoother=True, fuse_transfers=True`` (#4/#7/#10/#11) at the
   unfused hierarchy's smoother bounds: one V-cycle on a seeded input
   within 1e-5 of the unfused one's, FCG(V) within one.
20. The general family, ``lattice_blocked``. a: ``--kappa-field aniso``
   (`kappa_aniso`, 100:1 rotated 30 degrees, folded into G: the first
   off-diagonal G on a box) at nc=14, ``coarse="cg"``:
   FCG(V) to 1e-6 within 100, ms per V-cycle beside phase 7's curved
   cycle, K-A launches, L2 < 1e-4. b: at nc=14 (nc=21 until PR 17),
   `kappa_linear` with
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
22. The DSS operator (`ops/unstructured.py`, no CUDA kernel: JAX's is
   XLA too) at JAX's ``unstructured_dss_2M`` recipe,
   ``l_shaped_hex_mesh(15)``, p=6, float32, 2,244,151 dofs, and at
   ``l_shaped_hex_mesh(29)``, 16,016,875 dofs: the host setup seconds
   (mesh, merge and tables, geometry, device tables), the apply within
   1e-5 of the port's ``dofmap`` apply, its ms (CUDA events, 20
   back-to-back, median of 3), GDOF/s and kernels per apply, the profiled
   busy split into gather, cells and scatter, and the bound (G, x, y, the
   marker and the int64 tables over 3.35 TB/s).
23. The unstructured solve through `examples/unstructured_torch.py`'s code
   path, ``--degrees 1 3 6``, float32, FCG(V) to rtol 1e-6. a: ``--demo-n
   15 --coarse direct``: FCG within 50, L2 < 1e-4, ms per V-cycle, one
   V-cycle on a seeded input within 1e-5 of the ``dofmap`` hierarchy's
   (at the dss hierarchy's smoother bounds); b: ``--coarse amg``: FCG
   within 2 of a's, the AMG levels and setup seconds; c: ``--smoother
   schwarz``: FCG at or below a's; d: ``--demo-n 29 --coarse amg``: FCG
   within 50, L2 < 1e-4 (host thread), ms per V-cycle, idle share.
24. a: the flagship (phase 4's mesh and rhs) with ``coarse="amg"``: FCG
   within 2 of phase 4's, ms per V-cycle beside phase 4's, #1-#3 launch
   (the p-levels and the AMG's matrix-free level 0). b: ``operator="csr"``
   (cuSPARSE) on ``l_shaped_hex_mesh(4)``, p=(1,3): FCG within 1 of the
   ``dss`` hierarchy's, one V-cycle within 1e-5 of it.

25. The transient and extra model families (no new kernel: JAX writes
   BiCGStab, LOBPCG, the advection and the reactions as XLA ops). a (run
   after 24a): `newton_solve` on phase 4's hierarchy, cubic(5) with its
   manufactured source and Bratu(5); the f32 floor ``|F32(u64)| / |F0|``
   at the f64 solution (Newton on a plain f64 ``kron`` hierarchy) sets
   rtol = 10 x floor; Newton within 8 steps, cubic collocated L2 < 1e-4,
   ms per Newton step, FCG per step, #1-#3 launch; both f32 solutions
   within 1e-3 of the f64 ones. b (after 25a): `convdiff_solve` on plain
   ``kron`` hierarchies, f32 (rtol 1e-8) and f64, at 16.2M (velocity
   (3,-1.5,0.8), kappa 2) and nc=21: f32 against f64 within twice the f32
   floor predicted in f64, ``A^-1 (A32 u64 - b)`` (at 16.2M also the L2
   error), at nc=21 also within 1e-4; and `sd_stabilized_kappa` at cell
   Pe 21 (the JAX README's 6^3 case, f64, 'p' and 'cell'): BiCGStab
   counts, ms per iteration. c (after 24b):
   `semilinear_packed_evolve` at 61^3, p=6, 200 steps, CNAB and BE at B=1
   (#21) and 8 (#19), Bratu at B=8: each column within 1e-4 of the f64
   `semilinear_fdm_evolve`; steps/s (3 reps), busy ms per step and idle
   share (complete profiler window), launches. d: `semilinear_fdm_evolve`
   and `convdiff_fdm_evolve` (CNAB, f32) at 2,048,383 dofs, p=3, 200
   steps: within 1e-4 of f64, steps/s. e: `semilinear_newton_evolve` at
   nc=21, p=(1,3,6), ``kron_blocked``, 5 steps, rtol by 25a's rule: within
   1e-4 of the f64 ``kron`` run, Newton per step, #1-#3 launch. f:
   `examples/modes_torch.py` (f64) ``--ndofs 100000 --kmodes 6 --neumann
   x --sigma 5`` and ``--mesh perturbed --ndofs 400 --kmodes 1`` (its
   ``lattice`` + ``cg`` hierarchy: FCG per solve below its cap, coarse CG
   per V-cycle); and `lowest_eigenpairs` on the ~4k-dof ``PerturbedBoxMesh`` (k=1, tol
   1e-14, a ``lattice`` + ``direct`` hierarchy): each pair's ``|K u - lam
   M u| / |lam M u|`` against the host scipy stiffness (1e-7, 1e-6),
   M-orthonormality <= 1e-10, LOBPCG iterations and seconds.

26. The 1D slab layer (`parallel.dist`; no new kernel: JAX's slab runs
   its exchanges, einsums and scatters as XLA ops and #1-#3 per shard).
   a (run after 14): ``DistPMG(BoxMesh((42, 42, 42)), n_devices=6,
   degrees=(1, 3, 6), kappa=2, float32, coarse="fdm",
   operator="kron_blocked")`` on phase 4's mesh and rhs, the six slabs
   stacked on the card: the trajectory within phase 14's grid gate of
   phase 4's, FCG(V) within one of phase 4's, the solution within 1e-3,
   the apply and one V-cycle on a seeded input within 1e-5 of phase 4's
   hierarchy's, the per-slab launch design's V-cycle within 1e-5 of the
   stacked one's, L2 < 1e-4 (`card_l2`); ms per V-cycle of both launch
   designs in turns beside phase 4's, #1-#3 launches per V-cycle, the
   idle share from a complete profiler window. b:
   `examples/scaling_torch.py`'s slab sweep (S = 1, 2, 4, 8) at ~2.5M
   dofs, p=(1,3,6), ``kron_blocked`` + ``fdm``, f32, 3 cycles, and
   ``dofmap`` + ``cg`` in f64 at ~300k dofs: every trajectory invariant.
   c (after 25b): `newton_solve` on 26a's hierarchy within 1e-3 of 25a's
   f64 solution; `convdiff_solve` on 7 slabs at nc=21 within 25b's f32
   gates of its f64 solution; `examples/vector_update_torch.py` (8
   slabs, p=6, ``kron_blocked``, 100 rounds) with a deterministic dot.

27. The gather-free coarse family and the sharded time loops
   (`parallel.fdm_dist`, `build_hmg_dist` / `build_hmg_grid`,
   `parallel.transient_dist`; no new kernel: JAX writes them as XLA
   einsums and collectives, and their p-levels run #1-#3 and #9). a (after
   26b, on phase 4's mesh and rhs, at 26a's smoother bounds): ``DistPMG(6
   slabs, coarse="fdm", coarse_cfg=dict(dist=True))``: FCG(V) equal to
   26a's, one V-cycle on a seeded input within 1e-5 of 26a's, ms per
   V-cycle in turns with 26a's, all_to_all calls per V-cycle; `DistFDM`
   at p=6 (253^3) on 6 slabs and (2, 2, 2) within 1e-5 of the
   single-device `FastDiagonalizationSolver`, ms per solve in turns, and
   one all_to_all alone (ms, GB/s). b: on 7 slabs (42 -> 21 -> 7 h-cells),
   ``coarse="hmg"`` with ``dist=True, bottom="fdm"`` (nothing gathers)
   against the gathered ``hmg``: one V-cycle within 1e-5, FCG(V) within 2
   of 26a's, the h-levels, ms per V-cycle in turns, the idle share. c:
   ``GridPMG((2, 2, 2), coarse="hmg", coarse_cfg=dict(dist=True,
   bottom="fdm"))`` (42 -> 14): FCG(V) within 2 of phase 14's, L2 < 1e-4
   (`card_l2`), ms per V-cycle, #1/#9 launch. d (after 12, at its
   2,048,383 dofs, p=3): `heat_dist_evolve` CN on 6 slabs and (2, 2, 2),
   steps/s by the 100/500 slope in turns with `heat_fdm_evolve`;
   leapfrog, Newmark, semilinear and convdiff CNAB on 6 slabs at nc=18
   (166,375 dofs), 200 steps:
   f32 within 1e-4 relative L2 of the f64 sharded run, f64 sharded within
   1e-9 of the f64 single-device evolver; `examples/heat_torch.py
   --shards 6 --ndofs 250000` (L2 < 1e-3).
28. The general family on the sharded layouts (no new kernel: K-A once
   per shard), run after 17. a: ``GridPMG(PerturbedBoxMesh((14, 14, 14)),
   (2, 2, 2), degrees=(1, 3, 6), kappa=2, float32, coarse="cg",
   operator="lattice_blocked")`` on 17's mesh, rhs and single-device
   reference: 10 cycles within 1e-3 of the single device's above 5e-3,
   FCG(V) within 1 of its count and the solution within 1e-3, one
   V-cycle on its seeded input at its smoother bounds within 1e-5, K-A
   launched 8x as often as in its V-cycle, collocated L2 < 1e-4, each
   shard's K-A at p=1, 3, 6 within 1e-5 of its plain version (device ms
   a shard beside its bound); ms per V-cycle beside the single device's,
   host ms to enqueue, a profiled window. b:
   the same layout on curved nc=14 with `kappa_linear` + `sigma_linear`
   and `kappa_aniso`, each against one device: FCG(V) within
   1, one V-cycle within 1e-5, L2 (< 1e-4; within 1% of the single
   device's for `kappa_linear`). d: `solve_refined` on b's first grid to
   1e-9 within 2 cycles of one device's count. c: ``coarse="hmg",
   coarse_cfg=dict(dist=True)`` on a curved nc=16 mesh with a Robin face
   and z graded 8:1 against the gathered hmg: FCG(V) within 2, one
   V-cycle within 1e-5. e: ``DistPMG(6 slabs, operator="lattice")`` f32
   on a curved nc=12 mesh with both fields and a Robin face against one
   device (FCG(V) within 1, one V-cycle within 1e-5), then
   `examples/scaling_torch.py --grid --operator lattice_blocked`
   (trajectories layout-invariant).
29. The Kronecker family on the sharded layouts (no new kernel: #1/#9 per
   shard on blocks that differ, #1-#3 on a stacked ``Ktx`` whose blocks
   differ). a (run right after 19a, on its mesh, rhs and hierarchy):
   ``GridPMG(mixed_mesh(42), (2, 2, 2), degrees=(1, 3, 6), kappa=2,
   float32, coarse="fdm", operator="kron_blocked")`` at 19a's smoother
   bounds: 10 cycles within 5e-4 of 19a's above 5e-3, FCG(V) within 1 of
   its count and the solution within 1e-3, one seeded V-cycle within
   1e-5, card L2 < 1e-4, #1 and #9 on every shard's own blocks within
   1e-5 of their plain versions; ms per V-cycle beside 19a's and phase
   14's, launches per cycle, a profiled window's busy ms and idle share.
   b-d (after 19c, seeded right-hand sides): b: (2, 2, 2) on
   ``mixed_mesh(12)`` with ``coarse="fdm", coarse_cfg=dict(dist=True)``
   against the gathered fdm (FCG within 1, one V-cycle within 1e-5). c:
   ``DistPMG(7 slabs)`` on ``BoxMesh((28, 14, 14))`` with x graded 8:1
   and a Robin x-high face, ``coarse="fdm"`` and the gather-free hmg
   (``dist=True, bottom="fdm"``), each against one device (FCG within 1,
   2; one V-cycle within 1e-5), #1-#3 on the stacked ``Ktx`` against the
   per-slab plain versions. d: (2, 2, 2) + fdm on ``BoxMesh((12,) * 3)``
   with ``diag(1, 1, 100)`` and with ``(1, 2, 4)`` against one device
   (FCG within 1, one V-cycle within 1e-5); `solve_refined` on b's
   gathered grid to an f64 relative residual below 1e-9 within 2 cycles
   of one device's count.
30. The distributed unstructured path (`parallel.dss_dist`; no new
   kernel: JAX writes it as XLA ops). a (after 23c, on its mesh and 23a's
   rhs): ``DSSDist(l_shaped_hex_mesh(15), 8, (1, 3, 6), 2.0, float32,
   coarse="direct")``, the 8 shards stacked on the card: `DSSPartition`'s
   host seconds at p = 1, 3, 6; the fine apply within 1e-5 of the
   single-device ``dss`` apply, every level's lmax within 1e-3 of 23a's,
   FCG(V) within 1 of 23a's, one V-cycle at 23a's bounds within 1e-5 of
   23a's, L2 < 1e-4 (host thread); ms per apply and kernels per apply
   beside phase 22's, ms per V-cycle beside 23a's, busy ms, kernels and
   idle share of a complete profiled V-cycle (23a's too), exchanges per
   V-cycle; ``smoother="schwarz"`` against 23c (FCG within 1, one V-cycle
   within 1e-5). b: ``l_shaped_hex_mesh(5)`` (375 cells over 8 shards),
   seeded rhs, ``coarse="cg"`` and ``coarse="direct"`` with sigma 0.8 and
   a DG-0 kappa, each against the single-device ``dss`` hierarchy (FCG
   within 1, one V-cycle within 1e-5).
31. Across processes on the card (`parallel.multihost`; no new kernel),
   after 30: the parent starts rank processes (``--rank31``), each a gloo
   rank pinned to ``cuda:0`` that loads the kernels phase 2 built and
   stages every collective buffer through pinned host memory (NCCL
   refuses two ranks on one GPU). a: 26a's slab flagship on 2 ranks x 3
   slabs (16.2M dofs, the gathered fdm coarse crossing ranks), against
   26a's run; b: 30a's ``DSSDist`` on 2 ranks x 4 shards (the mesh and
   its caches handed over as a pickle), against 30a's; c: ``GridPMG(
   BoxMesh((22,) * 3), (2, 2, 2), (1, 3, 6), kron_blocked, coarse="fdm",
   coarse_cfg=dict(dist=True))`` on 4 ranks x 2 shards (2,352,637 dofs:
   plane exchanges on every axis, pencil all_to_all across ranks),
   against the same problem stacked here. Each rhs goes to the ranks as a
   ``.npy``; 31c's four ranks start with 31a/31b's and wait for their
   turn. Gates: FCG(V) to 1e-6 within 1 of the twin's, 10 cycles
   within 1e-4 of the twin's above 5e-3, one V-cycle on a seeded input
   at the twin's smoother bounds within 1e-5, and on every rank #1-#3
   (a) or #1 and #9 (c) on its own operands within 1e-5 of their plain
   versions. Prints each sub-phase's ms per V-cycle beside its twin's
   (two processes on one card: the cost of the decomposition and the
   staging, not a multi-GPU speed), the collective calls and staged
   bytes per V-cycle, setup and wall seconds; the ranks' main-path
   launches join the kernels line.
32. precision="high" (bf16x3: the HIGH instantiations of
   `csrc/kron_blocked.cu` and `csrc/lattice_blocked.cu`, a second library
   each, nvcc started in phase 2 beside the others), run after 4e on
   phase 4's mesh and hierarchy. a: every HIGH kernel against its plain
   'high' version, 1e-5 relative max norm, and its gap to the 'highest'
   kernel (which must lie in (1e-7, 1e-3): the split acts): #1-#3 and #7
   at 253^3 band 6, #4-#6 on a non-separable marker at 127^3 (their entry
   points' launches count), #8/#9 through `blocked_kron_apply_grid` on
   the (2,2,2) stack of 127^3 shards (x, y and z exchanges), K-A with the
   'v1' splits at 253^3 p=6 and 127^3 p=3 ('yexp' at 253^3), K-A on Gz
   and K-B at 253^3 (synthetic SPD G; K-B on PerturbedBoxMesh((42,)*3)'s
   coefficients); device ms of each beside the 'highest' kernel's in
   turns, the plain 'high' ms, bounds with 3x the operations of the
   sums each kernel splits (`kernel_bound`), the ptxas registers and spills, a first K-A HIGH launch in a graph
   capture. b: `examples/pmg_torch.py --precision high --pcg` at the
   flagship (16.2M, fdm): FCG(V) to 1e-6 within 1 of phase 4's; the
   driver's FCG solution solves the 'high' operator, its L2 a finding
   (< 1e-3), `solve_refined` at 'high' L2 < 1e-4; ms per V-cycle (10
   back-to-back, median of 3) in turns with phase 4's, the relative
   residual after 16 stationary V-cycles at both precisions (a finding),
   the stationary warning; the fused smoother at
   'high' (#4 + #7, FCG within 1). c: curved_2M_p136 (nc=21,
   lattice_blocked + cg) through the driver at 'high' against the same
   hierarchy at 'highest' on its mesh and rhs, FCG within 1, ms per
   V-cycle in turns; `mat_free_torch.py --precision
   high` with 'zgrp' and 'geom'. d: `GridPMG(BoxMesh((22,)*3), (2,2,2),
   (1,3,6), kron_blocked, fdm, precision="high")`, one V-cycle within
   1e-5 of a `PMGHierarchy` at 'high'. The HIGH kernels join the kernels
   line (``_high`` names, with their 'highest' twin's device ms).

Before the kernels line, a line lists the ten longest phases with their
seconds.

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
(#1-#3 phases 4, 15, 24a, 25a, 25e, 19a/19b, 26a-26c, 27a-27b, 29c
and 31a, #1 also 27c, 29a, 29b, 29d and 31c, #4/#7/#10/#11 phases 4b-4e
and 19c, #9 phases 14, 18d, 27c, 29a, 29b, 29d and 31c,
K-A phases 7, 16, 17, 20a, 20b and 28a-28e,
K-B phases 8 and 20c, #18-#21 phases 11 and 21, #19/#21 phase 25c),
with their kernels and host us per call and, with ``--parent``, the
parent's device times and whether the bits are the same) and, only when every
phase passed, the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import contextlib
import importlib.util
import io
import json
import os
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
# V-cycle timing windows: VC_CYCLES back-to-back cycles a window, three
# windows after one warm-up, the median read.
VC_CYCLES = 5
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


# The seconds of every finished phase, by its tag (the phase name up to
# its first '.'), for the line of the ten longest; phases in flight by
# their start time.
PHASE_SECONDS = {}
_OPEN_PHASES = {}


def phase(name):
    print(f"\n=== {name}", flush=True)
    t0 = time.perf_counter()
    _OPEN_PHASES[t0] = name.split(".")[0]
    return t0


def done(t0):
    secs = time.perf_counter() - t0
    tag = _OPEN_PHASES.pop(t0, None)
    if tag is not None:
        PHASE_SECONDS[tag] = PHASE_SECONDS.get(tag, 0.0) + secs
    print(f"    phase seconds: {secs:.2f}", flush=True)


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
                         device=DEV) for _ in range(2))
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


def kernel_bound(name, N, P, nc=None, B=None, dims=None, terms=None,
                 high=None):
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
    `kron_fused_terms`). ``high``: a precision='high' kernel's variant
    ("kron", "v1", "yexp", "zgrp" or "geom"), which does three products
    where the 'highest' one does one in each contraction it splits and
    nowhere else: the band sums of the kron kernels (x of #1 / #4, y and
    z of the others), four of K-A's six derivative sums for 'v1' (uy, uz
    and their transposes) and two (uz and its transpose) for the others;
    the scales, G, the geometry rebuild and the epilogues stay f32."""
    D = 2 * P + 1
    n = P + 1
    split = None   # the operations of the sums a HIGH variant splits
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
        split = (2 * D if name.startswith("t1") else 4 * D) * N
    elif name in ("lattice_apply", "lattice_apply_zgrp", "lattice_apply_geom"):
        cells = nc[0] * nc[1] * nc[2]
        Q = cells * n**3
        geom = 4 * 37 * cells if name == "lattice_apply_geom" else 24 * Q
        nbytes = 9 * N + geom
        flops = (12 * n + 15 + (120 if name == "lattice_apply_geom" else 0)) * Q
        split = (4 if high == "v1" else 2) * 2 * n * Q
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
        split = 4 * D * N
    elif name == "kron_fused":           # x, marker, planes read, y written
        NX, NY, NZ = dims
        nbytes = 9 * N + 4 * (NY * NZ + NX * NZ + NX * NY)
        flops = 2 * terms + 5 * N
    else:
        raise KeyError(name)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if high:
        if split is None:
            raise KeyError(f"{name} has no precision='high' variant")
        flops += 2 * split   # the split sums' two more products
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


def windows_ms(fn, cycles=VC_CYCLES, reps=3):
    """ms per call of ``fn``: CUDA events around ``cycles`` back-to-back
    calls, ``reps`` windows after one warm-up of two calls; returns
    (median, all)."""
    times = [cuda_ms(fn, reps=cycles, warmup=0 if i else 2)
             for i in range(reps)]
    return sorted(times)[len(times) // 2], times


def vcycle_ms(hier, cycles=VC_CYCLES, reps=3):
    """ms per V-cycle on the fine rhs (`windows_ms`); returns (median,
    all)."""
    import torch

    b = torch.ones(hier.levels[-1].ndofs, dtype=hier.dtype,
                   device=hier.device)
    u = torch.zeros_like(b)
    return windows_ms(lambda: hier.apply(b, u), cycles, reps)


def vcycle_pace(hier, cycles=VC_CYCLES, reps=3):
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


def profile_complete(fn, lb, tries=3):
    """`profile_busy` of one call of ``fn`` (a curved V-cycle) from a
    complete window. Late in a long process the profiler can leave out
    some of a window's kernels (here phase 7 misses two of the cycle's
    seven p=6 applies in every window; a fresh process on the same mesh
    keeps them all, `tools/lattice_bench_torch.py --vcycle`), so a window
    is read as complete only when its lattice kernels number what the
    wrappers counted for the call (`lb.LAUNCHES`:
    each apply is one march, or cells, kernel and one fold, or faces,
    kernel; every level of the curved cycle has faces between boxes) and
    its kernel count equals an earlier window's. At most ``tries``
    windows: late in the process phases 7, 17 and 28a have come back
    INCOMPLETE in all of 8, so more windows buy no complete one, and each
    costs seconds of host time (three: one window more than a complete
    read needs). Returns (wall, busy, kernels, {name: ms}, {name: launches}, windows
    tried, complete)."""
    seen, last = [], None
    for tries_made in range(1, tries + 1):
        before = sum(lb.LAUNCHES.values())
        calls = {}
        ts = time.perf_counter()
        wall, busy, nk, by_name = profile_busy(fn, calls)
        secs = time.perf_counter() - ts
        applies = sum(lb.LAUNCHES.values()) - before
        march = sum(n for k, n in calls.items()
                    if "lattice_march" in k or "lattice_cells" in k)
        fold = sum(n for k, n in calls.items()
                   if "lattice_faces" in k or "lattice_fold" in k)
        complete = march == applies and fold == applies and nk in seen
        print(f"    profile window {tries_made}: {nk} kernels, lattice "
              f"{march} + {fold} for {applies} applies, {secs:.2f} s"
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


def timed_build(mod):
    """``mod.load_kernels()`` (nvcc on its source): the clock at its end."""
    mod.load_kernels()
    return time.perf_counter()


def kernel_free_phases():
    """Phases 18a, 18c and 25f, which launch none of the port's CUDA
    kernels (plain torch operators), run on the otherwise idle card while
    nvcc builds the kernels: their times share the host with the build
    and the host threads. Returns 25f's {tag: (iterations, seconds)}."""
    t0 = phase(f"18a. AMG twin: examples/amg_torch.py --ndofs "
               f"{AMG_TWIN_NDOFS} --pc jacobi|cheb|hmg, box and perturbed")
    amg_twin()
    done(t0)
    t0 = phase("18c. line smoother + semicoarsened hmg: BoxMesh((16,16,32), "
               "extent (1,1,0.25)), p=(1,3), f64 kron")
    line_semicoarsened()
    done(t0)
    t0 = phase("25f. modes: examples/modes_torch.py, FDM box (100k); "
               "lowest_eigenpairs, FCG(V) perturbed (4k); float64")
    out = modes_phase()
    done(t0)
    return out


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
    """Phase 12: the JAX bench's heat_cn_2M recipe on the port (its L2
    error on the card, `card_l2_error`)."""
    import numpy as np
    import torch

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
    samples = []
    for _ in range(3):
        t_lo, _ = timed(lo)
        t_hi, u = timed(hi)
        samples.append((t_hi - t_lo) / (hi - lo))
    per = sorted(samples)[1]
    T = hi * dt
    amp = np.exp(-3.0 * np.pi**2 * 2.0 * T)
    err = card_l2_error(mesh, P, u, lambda x: amp * np.sin(np.pi * x[0])
                        * np.sin(np.pi * x[1]) * np.sin(np.pi * x[2]))
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
          f"unfused {(t_u1 + t_u2) / 2:.3f} ms ({t_u1:.3f}, {t_u2:.3f}); {VC_CYCLES} "
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
              f"{t_r2:.3f}); {VC_CYCLES} back-to-back, median of 3, in turns")
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
                                       fm, band=P, device=DEV)
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


def grid_vcycle_ms(grid, cycles=VC_CYCLES, reps=3):
    """`vcycle_ms` for a `GridPMG`: one-vectors in the stacked layout."""
    import torch

    b = torch.ones(grid.shards + grid.levels[-1].shape, dtype=grid.dtype,
                   device=grid.device)
    u = torch.zeros_like(b)
    return windows_ms(lambda: grid.apply(b, u), cycles, reps)


def grid_path(prob, hier, rel_ref, u_ref, niter_ref, spread, cfg, launches):
    """Phase 14: the device-grid main path, ``GridPMG(BoxMesh((42, 42,
    42)), (2, 2, 2), degrees=(1, 3, 6), kappa=2, float32, coarse="fdm",
    operator="kron_blocked")`` on phase 4's mesh and rhs, every shard on
    this card, against phase 4's single-device hierarchy (``spread``: phase
    4's plain-kron spread); then (1, 2, 4) at about 2.0M dofs against the
    single-device hierarchy on its mesh. Adds #9's launches on the path to
    ``launches``; returns the (2, 2, 2) grid's FCG(V) count and ms per
    V-cycle."""
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
    grid_ms = (t_g1 + t_g2) / 2
    print(f"    V-cycle: grid (2, 2, 2) {grid_ms:.3f} ms ({t_g1:.3f}, "
          f"{t_g2:.3f}; reps {[round(t, 3) for t in all_g1 + all_g2]}) vs "
          f"single device {(t_s1 + t_s2) / 2:.3f} ms ({t_s1:.3f}, "
          f"{t_s2:.3f}); {VC_CYCLES} back-to-back, median of 3, in turns")
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
    return niter, grid_ms



# Phase 26a: the flagship mesh's 42 x-cells in 6 slabs of 7 (258 stacked
# x-planes at p=6 against 253).
SLAB_SHARDS = 6
# 20b's mesh (331,451 dofs at p=6): its lattice_blocked and plain lattice
# hierarchies, two per case, set the phase's time (64.0 s at nc=21 on a
# slow host); 28b drives the same coefficients on the grid.
GENERAL_NC = (10, 10, 10)
# 20a's box: the tensor fold and FCG(V) at 614,125 dofs (28b drives the
# same aniso tensor on the curved grid at this size).
GENERAL_ANISO_NC = (14, 14, 14)
SLAB_SWEEP = ["--ndofs", "1000000", "--degrees", "1", "3", "6",
              "--operator", "kron_blocked", "--coarse", "fdm", "--dtype",
              "f32", "--max-devices", "8", "--cycles", "3"]
SLAB_SWEEP_F64 = ["--ndofs", "250000", "--operator", "dofmap", "--coarse",
                  "cg", "--dtype", "f64", "--max-devices", "8"]
VECTOR_UPDATE = ["--operator", "kron_blocked", "--ndofs", "2000000",
                 "--degree", "6", "--devices", "8", "--rounds", "100"]
CONV_SLAB_SHARDS = 7     # 26c: nc=21 in 7 slabs of 3 cells


def run_example(name, args):
    """``examples/<name>.py`` with ``args`` in this process (its kernel
    launches count here, its kernels are this process's); prints its
    output indented and returns its last line, a JSON object."""
    if str(ROOT / "examples") not in sys.path:
        sys.path.insert(0, str(ROOT / "examples"))
    mod = load_example(name)
    argv, buf = sys.argv, io.StringIO()
    sys.argv = [f"{name}.py", *args]
    try:
        with contextlib.redirect_stdout(buf):
            mod.main()
    finally:
        sys.argv = argv
    text = buf.getvalue()
    print("    " + text.strip().replace("\n", "\n    ")[:4000])
    return json.loads(text.strip().splitlines()[-1])


def slab_vcycle_ms(dist, cycles=VC_CYCLES, reps=3):
    """`vcycle_ms` for a `DistPMG`: one-vectors in the slab layout."""
    import torch

    b = dist.to_dist(torch.ones(dist.mesh.num_dofs(dist.degrees[-1]),
                                device=dist.device))
    u = torch.zeros_like(b)
    return windows_ms(lambda: dist.apply(b, u), cycles, reps)


def per_slab_launch_ops(slab):
    """The other launch design of the slab's ``kron_blocked`` apply, for
    timing only: kernels 1 and 2 (or 3) once per slab on its contiguous
    block and its own arrays (`slab_blocks`), the x exchange between them
    (what `GridPMG` does per shard). Returns ``slab``'s cycle ops with
    ``apply`` and ``residual`` replaced."""
    import torch

    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.parallel.dist import (
        _exchange_partials,
        slab_blocks,
    )

    S, sigma = slab.n_shards, slab.sigma
    blocks = {id(lv["kb_mats"]): slab_blocks(lv["kb_mats"], S)
              for lv in slab.data["levels"] if "kb_mats" in lv}

    def run(lv, x, r=None):
        mine = blocks[id(lv["kb_mats"])]
        if "sxzm" not in lv["kb_mats"]:
            raise AssertionError("per-slab launches: separable marker only")
        x = x.contiguous()
        t1 = torch.empty_like(x)
        for s, m in enumerate(mine):
            kb.kron_t1_m(x[s], m, out=t1[s])
        t1 = _exchange_partials(t1, S, inplace=True)
        out = torch.empty_like(x)
        for s, m in enumerate(mine):
            kb.kron_t23_m(x[s], t1[s], m, sigma,
                          r3=None if r is None else r[s], out=out[s])
        return out

    return dict(slab._ops,
                apply=lambda lv, x, level: run(lv, x),
                residual=lambda lv, b, u, level: run(lv, u, r=b.contiguous()))


def slab_kernel_parity(slab):
    """Kernels #1-#3 on the slab's own operand, the stacked fine lattice
    ``(S*npl, NY, NZ)`` with its block-diagonal ``Ktx`` and stacked scale
    factors, against the per-slab plain versions on each slab's own
    arrays (`slab_blocks`): kernel by kernel, and the apply and residual
    entry points with the x exchange, on seeded inputs at sigma 0 and
    0.5, gated at ``KERNEL_RTOL``. These launches are comparisons; they
    are not counted as the main path's."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.parallel.dist import (
        _exchange_partials,
        slab_blocks,
    )

    S = slab.grid.block[0]     # this process's slabs
    lv = slab.data["levels"][-1]
    mats = lv["kb_mats"]
    blocks = slab_blocks(mats, S)
    shape = (S,) + tuple(slab.levels[-1].shape)
    rng = np.random.default_rng(SEED + 28)
    x, r = (torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                         device=DEV) for _ in range(2))
    flat = lambda t: t.reshape((-1,) + shape[2:])
    bc = flat(lv["bc_marker"])

    def ex(t1):
        lat = t1.view(shape)
        return _exchange_partials(lat, S, inplace=True).view(t1.shape)

    t1_raw = torch.stack([kb.plain_t1_m(x[s], blocks[s]) for s in range(S)])
    t1 = _exchange_partials(t1_raw.clone(), S)
    worst = 0.0
    for sigma in (0.0, 0.5):
        y_ref = torch.stack([kb.plain_t23_m(x[s], t1[s], blocks[s], sigma)
                             for s in range(S)])
        cases = (
            ("t1_m", lambda: kb.kron_t1_m(flat(x), mats), t1_raw),
            ("t23_m", lambda: kb.kron_t23_m(flat(x), flat(t1), mats, sigma),
             y_ref),
            ("t23_res_m", lambda: kb.kron_t23_m(flat(x), flat(t1), mats,
                                                sigma, r3=flat(r)),
             r - y_ref),
            ("apply", lambda: kb.blocked_kron_apply(
                flat(x), bc, mats, exchange=ex, sigma=sigma), y_ref),
            ("residual", lambda: kb.blocked_kron_residual(
                flat(r), flat(x), bc, mats, exchange=ex, sigma=sigma),
             r - y_ref),
        )
        for name, launch, ref in cases:
            got = launch()
            torch.cuda.synchronize()
            err = rel_max_err(got.reshape(shape), ref)
            worst = max(worst, err)
            print(f"    stacked {tuple(flat(x).shape)} sigma={sigma} {name} "
                  f"vs the per-slab plain versions: rel max err {err:.3e}")
            if not err <= KERNEL_RTOL:
                raise AssertionError(
                    f"stacked slab {name}, sigma={sigma}: relative max-norm "
                    f"error {err:.3e} > {KERNEL_RTOL}")
    return worst


def slab_flagship(prob, hier, rel_ref, u_ref, niter_ref, spread, cfg,
                  launches):
    """Phase 26a: the slab main path, ``DistPMG(BoxMesh((42, 42, 42)),
    n_devices=6, degrees=(1, 3, 6), kappa=2, float32, coarse="fdm",
    operator="kron_blocked")`` on phase 4's mesh and rhs, the six slabs
    stacked on this card, against phase 4's single-device hierarchy
    (``spread``: phase 4's plain-kron spread, the grid gate of phase 14).
    Gates: the stationary trajectory, FCG(V) within 1 of phase 4's, the
    solution within 1e-3, the apply within 1e-5 and one V-cycle on a
    seeded input within 1e-5 of the single device's, kernels #1-#3 and
    the apply and residual on the stacked fine operand within 1e-5 of the
    per-slab plain versions (`slab_kernel_parity`), the per-slab launch
    design's V-cycle (`per_slab_launch_ops`) within 1e-5 of the stacked
    one's, #1-#3 launch; the L2 error (< 1e-4, `card_l2`). Prints
    ms per V-cycle of both launch designs in turns beside the single
    device's, launches per V-cycle and the idle share (complete profiler
    window). Adds #1-#3's
    launches to ``launches``; returns (the hierarchy, the L2 job, {tag:
    (FCG count, ms per V-cycle)})."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.parallel.dist import DistPMG

    reset(kb)
    ts = time.perf_counter()
    slab = DistPMG(prob.mesh, n_devices=SLAB_SHARDS,
                   operator="kron_blocked", **cfg)
    torch.cuda.synchronize()
    print(f"    setup seconds: {time.perf_counter() - ts:.2f}  (slab "
          f"lattice {slab.levels[-1].shape} x {SLAB_SHARDS}; eig max per level "
          f"{[float(e[-1]) for e in slab.eigs]}; single device "
          f"{[float(e[-1]) for e in hier.eigs]})")
    r0 = float(torch.linalg.vector_norm(prob.b))
    ts = time.perf_counter()
    u, rn = slab.solve(prob.b, num_cycles=10)
    rel = [v / r0 for v in rn]
    print(f"    10 cycles ({time.perf_counter() - ts:.3f} s host clock): rel "
          f"{[f'{v:.4e}' for v in rel]}")
    hist = [1.0] + rel
    if not all(hist[i + 1] < hist[i] for i in range(4)):
        raise AssertionError(f"residual did not fall on cycles 1-4: {rel}")
    grid_traj_gate(rel, rel_ref, spread, "slab vs single device")
    ts = time.perf_counter()
    u, niter = slab.solve_pcg(prob.b, rtol=1e-6, maxiter=50)
    torch.cuda.synchronize()
    pcg_s = time.perf_counter() - ts
    path = dict(kb.LAUNCHES)
    print(f"    FCG(V) iterations to rtol 1e-6: {niter} ({pcg_s:.3f} s host "
          f"clock; single device {niter_ref}); kernel launches on this path: "
          f"{ {k: v for k, v in path.items() if v} }")
    add_launches(launches, path, ("t1_m", "t23_m", "t23_res_m"))
    if abs(niter - niter_ref) > 1:
        raise AssertionError(f"FCG counts differ: {niter} vs {niter_ref}")
    if tuple(u.shape) != tuple(u_ref.shape) or not bool(
            torch.isfinite(u).all()):
        raise AssertionError("slab solution is not a finite vector of ndofs")
    du = rel_l2(u, u_ref)
    print(f"    slab vs single-device FCG solution: relative difference "
          f"{du:.3e}")
    if not du <= 1e-3:
        raise AssertionError(f"slab and single-device solutions differ: {du}")
    l2 = card_l2(prob, u)
    x = torch.tensor(np.random.default_rng(SEED + 26).standard_normal(
        u_ref.numel(), dtype=np.float32), device="cuda")
    y_s = hier.operator()(x)
    y_d = slab.from_dist(slab.operator()(slab.to_dist(x)))
    err = rel_max_err(y_d, y_s)
    print(f"    slab apply vs single-device apply, seeded random vector: rel "
          f"max err {err:.3e}")
    if not err <= KERNEL_RTOL:
        raise AssertionError(f"slab and single-device operators differ: {err}")
    del x, y_s, y_d
    grid_vcycle_parity(slab, hier, SEED + 27, f"slab ({SLAB_SHARDS} slabs)")
    slab_kernel_parity(slab)
    bd = slab.to_dist(prob.b)
    ud = torch.zeros_like(bd)
    stacked = slab._ops
    per_shard = per_slab_launch_ops(slab)

    def with_ops(ops, fn):
        slab._ops = ops
        try:
            return fn()
        finally:
            slab._ops = stacked

    per_cycle = {}
    for tag, ops in (("stacked", stacked), ("per_shard", per_shard)):
        reset(kb)
        with_ops(ops, lambda: slab.apply(bd, ud))
        torch.cuda.synchronize()
        per_cycle[tag] = {k: v for k, v in kb.LAUNCHES.items() if v}
        print(f"    launches per slab V-cycle, {tag}: {per_cycle[tag]}")
    v_st = slab.apply(bd, ud)
    v_ps = with_ops(per_shard, lambda: slab.apply(bd, ud))
    err = rel_max_err(v_ps, v_st)
    print(f"    one V-cycle, per-shard launches vs stacked: rel max err "
          f"{err:.3e} (gate {KERNEL_RTOL:g})")
    if not err <= KERNEL_RTOL:
        raise AssertionError(f"the two launch designs differ: {err}")
    # stacked, per-shard, per-shard, stacked; the single device around them
    t_h1, _ = vcycle_ms(hier)
    t_s1, all_s1 = slab_vcycle_ms(slab)
    t_p1, all_p1 = with_ops(per_shard, lambda: slab_vcycle_ms(slab))
    t_p2, all_p2 = with_ops(per_shard, lambda: slab_vcycle_ms(slab))
    t_s2, all_s2 = slab_vcycle_ms(slab)
    t_h2, _ = vcycle_ms(hier)
    vc_st, vc_ps = (t_s1 + t_s2) / 2, (t_p1 + t_p2) / 2
    print(f"    V-cycle: slab stacked launches {vc_st:.3f} ms ({t_s1:.3f}, "
          f"{t_s2:.3f}; reps {[round(t, 3) for t in all_s1 + all_s2]}), "
          f"per-shard launches {vc_ps:.3f} ms ({t_p1:.3f}, {t_p2:.3f}; reps "
          f"{[round(t, 3) for t in all_p1 + all_p2]}), single device "
          f"{(t_h1 + t_h2) / 2:.3f} ms ({t_h1:.3f}, {t_h2:.3f}); {VC_CYCLES} "
          f"back-to-back, median of 3, in turns")
    faster = "stacked" if vc_st <= vc_ps else "per_shard"
    print(f"    faster design this run: {faster}; DistPMG runs: stacked")
    wall, busy, nk, by_name, complete = kron_profile(
        lambda: slab.apply(bd, ud), "slab stacked")
    print(f"      idle {max(0.0, 1 - busy / vc_st):.1%} of the back-to-back "
          f"{vc_st:.3f} ms")
    for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"      {ms:8.4f} ms {ms / busy:6.1%}  {kname[:90]}")
    return slab, l2, {"26a slab": (niter, vc_st),
                      "26a slab per-shard": (niter, vc_ps)}


def slab_sweeps(launches):
    """Phase 26b: ``examples/scaling_torch.py``'s 1D slab sweep (strong
    mode, S = 1, 2, 4, 8) at about 2M dofs, p=(1,3,6), ``kron_blocked`` +
    ``fdm``, f32, 3 cycles (the f32 floor stays 40x below the last one),
    and the driver's default ``dofmap`` + ``cg`` in f64 at about 250k
    dofs: every count's trajectory invariant (rtol 1e-3 / 1e-9). Adds
    #1-#3's launches of the f32 sweep to ``launches``. Returns {tag:
    (cycles, ms per V-cycle at 8 slabs)}."""
    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb

    out = {}
    for tag, args in (("f32 kron_blocked", SLAB_SWEEP),
                      ("f64 dofmap", SLAB_SWEEP_F64)):
        reset(kb)
        res = run_example("scaling_torch", args)
        rows = res["rows"]
        inv = [r["invariant"] for r in rows[1:]]
        print(f"    {tag}: slabs {[r['devices'] for r in rows]}, s/cycle "
              f"{[round(r['s_per_cycle'], 5) for r in rows]}, invariant "
              f"{inv}")
        if not (len(rows) == 4 and all(v is True for v in inv)):
            raise AssertionError(f"26b {tag}: trajectories not invariant: "
                                 f"{inv}")
        if tag.startswith("f32"):
            add_launches(launches, dict(kb.LAUNCHES),
                         ("t1_m", "t23_m", "t23_res_m"))
        out[f"26b {tag}"] = (len(rows[-1]["rnorms"]),
                             1e3 * rows[-1]["s_per_cycle"])
    return out


def slab_models(slab, newton_ref, conv_ref, launches):
    """Phase 26c: `newton_solve` (cubic(5)) on phase 26a's slab hierarchy
    against phase 25a's f64 single-device solution (25a's rtol and gate);
    `convdiff_solve` on a plain ``kron`` slab hierarchy (nc=21, 7 slabs,
    f32, rtol 1e-8) against phase 25b's nc=21 f64 solution within 25b's
    gates (IMEX_RTOL and CONV_FLOOR_FACTOR x the f32 floor predicted
    there); ``examples/vector_update_torch.py`` (8 slabs, ~2M dofs, p=6,
    ``kron_blocked``, 100 rounds) with a deterministic, finite dot. Adds
    #1-#3's launches to ``launches``. Returns {tag: (count, ms)}."""
    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.models import semilinear
    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.parallel.dist import DistPMG
    from pmg_dolfinx_tpu_torch.solvers.convdiff import convdiff_solve

    out = {}
    u64, rtol, b = newton_ref
    reset(kb)
    u, info, per = newton_f32(slab, b, semilinear.cubic(SEMI_C), rtol,
                              "slab cubic f32")
    add_launches(launches, dict(kb.LAUNCHES), ("t1_m", "t23_m", "t23_res_m"))
    du = rel_max_err(u.double(), u64)
    print(f"      against 25a's f64 single-device solution: rel max diff "
          f"{du:.3e} (gate {NEWTON_F64_RTOL:g})")
    if not du <= NEWTON_F64_RTOL:
        raise AssertionError(f"26c Newton: {du} from the f64 solution")
    out["26c slab Newton"] = (info["niter"], per)

    u64, u_pred = conv_ref
    cvel = (3.0, -1.5, 0.8)
    mesh = BoxMesh(SMALL_NC)
    ts = time.perf_counter()
    h = DistPMG(mesh, n_devices=CONV_SLAB_SHARDS, degrees=(1, 3, 6),
                kappa=2.0, dtype=torch.float32, coarse="fdm",
                operator="kron", device="cuda")
    b = assemble_rhs(mesh, 6, conv_source(2.0, cvel))
    torch.cuda.synchronize()
    setup = time.perf_counter() - ts
    ts = time.perf_counter()
    u, info = convdiff_solve(h, b, cvel, rtol=1e-8, maxiter=200)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - ts) * 1e3
    pred = rel_max_err(u_pred, u64)
    d = rel_max_err(u.double(), u64)
    print(f"    convdiff, {CONV_SLAB_SHARDS} slabs at nc=21: "
          f"{info['niter']} BiCGStab iterations, rel resid "
          f"{info['rel_resid']:.2e}, {wall:.1f} ms (setup and rhs "
          f"{setup:.2f} s); against 25b's f64 single-device solution rel "
          f"max diff {d:.3e}, 25b's predicted f32 floor {pred:.3e}: ratio "
          f"{d / pred:.3f} (gates {IMEX_RTOL:g} and {CONV_FLOOR_FACTOR:g} x "
          f"the floor)")
    if not (info["rel_resid"] <= 1e-8 and d <= IMEX_RTOL
            and d <= CONV_FLOOR_FACTOR * pred):
        raise AssertionError(f"26c convdiff: {info}, {d}, floor {pred}")
    out["26c slab BiCGStab"] = (info["niter"], wall / max(info["niter"], 1))
    del h

    reset(kb)
    res = run_example("vector_update_torch", VECTOR_UPDATE)
    if not (res["deterministic"] is True and res["rounds"] == 100):
        raise AssertionError(f"26c vector_update: {res}")
    add_launches(launches, dict(kb.LAUNCHES), ("t1_m", "t23_m"))
    out["26c vector_update"] = (res["rounds"], 1e3 * res["s_per_round"])
    return out



# Phases 27a-27d: the gather-free coarse family and the sharded time loops.
GF_SLABS = 7          # 27b: 42 x-cells in 7 slabs, h-levels 42 -> 21 -> 7
GF_VCYCLE_RTOL = 1e-5
DIST_FDM_RTOL = 1e-5
STEP_NC = (42, 42, 42)  # 27d at p=3: 2,048,383 dofs, phase 12's size
STEP_F32_RTOL = 1e-4
STEP_F64_RTOL = 1e-9
STEP_N = 200
# 27d's steps/s slope: the wall-clock difference of runs of these step
# counts, over the steps between them.
STEP_SLOPE = (100, 500)
# 27d's leapfrog, Newmark, semilinear and convdiff gates (6 slabs of 3
# x-cells; 166,375 dofs at p=3); heat CN and its slope stay at STEP_NC,
# phase 12's size.
STEP_GATE_NC = (18, 18, 18)
DEV = "cuda"


@contextlib.contextmanager
def a2a_counts():
    """Within the block, count `StackedGrid.all_to_all` calls (the pencil
    transposes of `fdm_dist`): yields a one-element list."""
    from pmg_dolfinx_tpu_torch.parallel import grid2d

    n, orig = [0], grid2d.StackedGrid.all_to_all

    def counted(self, *a, **k):
        n[0] += 1
        return orig(self, *a, **k)

    grid2d.StackedGrid.all_to_all = counted
    try:
        yield n
    finally:
        grid2d.StackedGrid.all_to_all = orig


def seeded(n, seed, dtype=None):
    import numpy as np
    import torch

    return torch.tensor(np.random.default_rng(seed).standard_normal(
        n, dtype=np.float32), dtype=dtype, device=DEV)


def dist_vcycle_parity(a, b, seed, tag, rtol=GF_VCYCLE_RTOL):
    """One V-cycle of two `DistPMG` / `GridPMG` hierarchies of the same
    mesh on a seeded global rhs and iterate, ``b`` at ``a``'s smoother
    bounds: relative max-norm within ``rtol``."""
    n = a.mesh.num_dofs(a.degrees[-1])
    rhs, it = seeded(n, seed), seeded(n, seed + 1)
    b.load_state({"levels": [{"lmax": lv["lmax"]}
                             for lv in a.data["levels"]]})
    va = a.from_dist(a.apply(a.to_dist(rhs), a.to_dist(it)))
    vb = b.from_dist(b.apply(b.to_dist(rhs), b.to_dist(it)))
    err = rel_max_err(vb, va)
    print(f"    {tag}: one V-cycle, seeded rhs and iterate: rel max err "
          f"{err:.3e} (gate {rtol:g})")
    if not err <= rtol:
        raise AssertionError(f"{tag}: V-cycles differ by {err:.3e}")
    return err


def dist_fdm_solves(mesh):
    """27a, second half: `DistFDM` as a whole-problem direct solve at p=6
    on 6 slabs and on (2, 2, 2) against the single-device
    `FastDiagonalizationSolver` on one seeded rhs (relative max-norm within
    `DIST_FDM_RTOL`); ms per solve in turns (single, slab, grid, grid,
    slab, single), all_to_all calls per solve and the one-card
    all_to_all's ms at the first transpose's shape. Returns {tag: (None,
    ms per solve)}."""
    import torch

    from pmg_dolfinx_tpu_torch.parallel.fdm_dist import DistFDM
    from pmg_dolfinx_tpu_torch.solvers.fdm import FastDiagonalizationSolver

    P, kw = 6, dict(kappa=2.0, dtype=torch.float32)
    b = seeded(mesh.num_dofs(P), SEED + 271)
    single = FastDiagonalizationSolver(mesh, P, device=DEV, **kw)
    u_s = single.solve(b).reshape(-1)
    solvers, stacked = {}, {}
    for shards in (SLAB_SHARDS, (2, 2, 2)):
        tag = f"{shards} slabs" if isinstance(shards, int) else str(shards)
        ts = time.perf_counter()
        d = DistFDM(mesh, P, shards, device=DEV, **kw)
        bd = d.to_dist(b)
        with a2a_counts() as n:
            u_d = d.from_dist(d._solve_local(d.data, bd))
        err = rel_max_err(u_d, u_s)
        print(f"    DistFDM {tag} at {mesh.num_dofs(P)} dofs (p=6, local "
              f"{d.part.local_shape(P)}): setup {time.perf_counter() - ts:.2f}"
              f" s; vs FastDiagonalizationSolver rel max err {err:.3e} (gate "
              f"{DIST_FDM_RTOL:g}); {n[0]} all_to_all per solve")
        if not err <= DIST_FDM_RTOL:
            raise AssertionError(f"DistFDM {tag}: {err:.3e}")
        solvers[tag], stacked[tag] = d, bd
    tags = list(solvers)
    ms = {t: [] for t in ["single"] + tags}
    for t in ["single"] + tags + tags[::-1] + ["single"]:
        if t == "single":
            ms[t].append(cuda_ms(lambda: single.solve(b), reps=10))
        else:
            d, bd = solvers[t], stacked[t]
            ms[t].append(cuda_ms(lambda: d._solve_local(d.data, bd), reps=10))
    print("    ms per solve, in turns: " + "; ".join(
        f"{t} {sum(v) / len(v):.3f} ({', '.join(f'{x:.3f}' for x in v)})"
        for t, v in ms.items()))
    # The one-card all_to_all alone: the slab's x transpose, its buddy the
    # y axis (the longest other local axis) padded to a multiple of 6.
    d, bd = solvers[tags[0]], stacked[tags[0]]
    x = torch.nn.functional.pad(bd, (0, 0, 0, (-bd.shape[4]) % SLAB_SHARDS))
    a2a = cuda_ms(lambda: d.grid.all_to_all(x, 0, 1, 0), reps=10)
    gbs = 2 * x.numel() * x.element_size() / a2a / 1e6
    print(f"    one all_to_all (the slab's x transpose, {tuple(x.shape)}): "
          f"{a2a:.3f} ms, {gbs:.0f} GB/s read + written (bound "
          f"{2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3:.3f} "
          f"ms)")
    return {f"27a DistFDM {t}": (1, sum(v) / len(v))
            for t, v in ms.items()}


def gather_free_slab(prob, slab, niter_ref, cfg, launches):
    """Phases 27a and 27b on phase 4's mesh and rhs (16,194,277 dofs,
    p=(1,3,6), f32, ``kron_blocked``). 27a: ``DistPMG(n_devices=6,
    coarse="fdm", coarse_cfg=dict(dist=True))`` at 26a's smoother bounds:
    FCG(V) equal to 26a's (``niter_ref``), one V-cycle on a seeded input
    within 1e-5 of 26a's gathered-fdm hierarchy (``slab``), ms per V-cycle
    in turns with 26a's, all_to_all calls per V-cycle; then
    `dist_fdm_solves`. 27b: on 7 slabs, ``coarse="hmg"`` with
    ``coarse_cfg=dict(dist=True, bottom="fdm")`` (gathers nothing) and the
    gathered ``hmg``: one V-cycle within 1e-5 of each other, FCG(V)
    within 2 of ``niter_ref``, the h-levels, ms per V-cycle in turns and
    the gather-free one's idle share. Adds #1-#3's launches to
    ``launches``; returns {tag: (FCG count, ms per V-cycle or per
    solve)}."""
    import torch

    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.parallel.dist import DistPMG

    out = {}
    t0 = phase("27a. slab p-coarse fdm with coarse_cfg dist=True (pencil "
               "all_to_all, no gather), 6 slabs, 16.2M dofs; DistFDM at p=6")
    ts = time.perf_counter()
    dfdm = DistPMG(prob.mesh, n_devices=SLAB_SHARDS, operator="kron_blocked",
                   coarse_cfg=dict(dist=True), **cfg)
    dfdm.load_state({"levels": [{"lmax": lv["lmax"]}
                                for lv in slab.data["levels"]]})
    torch.cuda.synchronize()
    print(f"    setup seconds: {time.perf_counter() - ts:.2f} (26a's smoother "
          "bounds loaded)")
    reset(kb)
    u, niter = dfdm.solve_pcg(prob.b, rtol=1e-6, maxiter=50)
    torch.cuda.synchronize()
    add_launches(launches, dict(kb.LAUNCHES), ("t1_m", "t23_m", "t23_res_m"))
    print(f"    FCG(V) iterations to rtol 1e-6: {niter} (26a, gathered fdm: "
          f"{niter_ref}); launches {dict((k, v) for k, v in kb.LAUNCHES.items() if v)}")
    if niter != niter_ref or not bool(torch.isfinite(u).all()):
        raise AssertionError(f"27a: FCG {niter} vs 26a's {niter_ref}")
    dist_vcycle_parity(slab, dfdm, SEED + 272, "27a fdm dist vs 26a fdm")
    bd = dfdm.to_dist(prob.b)
    ud = torch.zeros_like(bd)
    with a2a_counts() as n:
        dfdm.apply(bd, ud)
    t_g1, _ = slab_vcycle_ms(slab)
    t_d1, all_d1 = slab_vcycle_ms(dfdm)
    t_d2, all_d2 = slab_vcycle_ms(dfdm)
    t_g2, _ = slab_vcycle_ms(slab)
    vc = (t_d1 + t_d2) / 2
    print(f"    V-cycle: fdm dist {vc:.3f} ms ({t_d1:.3f}, {t_d2:.3f}; reps "
          f"{[round(t, 3) for t in all_d1 + all_d2]}) vs 26a's gathered fdm "
          f"{(t_g1 + t_g2) / 2:.3f} ms ({t_g1:.3f}, {t_g2:.3f}); {VC_CYCLES} "
          f"back-to-back, median of 3, in turns; {n[0]} all_to_all per "
          "V-cycle")
    out["27a slab fdm dist"] = (niter, vc)
    del dfdm, u, bd, ud
    out.update(dist_fdm_solves(prob.mesh))
    done(t0)

    t0 = phase(f"27b. slab gather-free h-coarse: {GF_SLABS} slabs, 16.2M "
               "dofs, coarse=hmg with dist=True, bottom=fdm, against the "
               "gathered hmg")
    kw = dict(cfg, coarse="hmg")
    ts = time.perf_counter()
    gf = DistPMG(prob.mesh, n_devices=GF_SLABS, operator="kron_blocked",
                 coarse_cfg=dict(dist=True, bottom="fdm"), **kw)
    torch.cuda.synchronize()
    setup_gf = time.perf_counter() - ts
    ts = time.perf_counter()
    ga = DistPMG(prob.mesh, n_devices=GF_SLABS, operator="kron_blocked", **kw)
    torch.cuda.synchronize()
    setup_ga = time.perf_counter() - ts
    hl = [tuple(lv.shape) for lv in gf.coarse_cfg["hmg_levels"]]
    print(f"    setup seconds: gather-free {setup_gf:.2f}, gathered "
          f"{setup_ga:.2f}; h-levels (per-slab lattice, coarse to fine) {hl},"
          f" bottom {gf.coarse_cfg['hmg_bottom']}; gathered h-levels "
          f"{[tuple(lv.shape) for lv in ga.coarse_cfg['hmg_levels']]}, "
          f"bottom {ga.coarse_cfg['hmg_bottom']}")
    dist_vcycle_parity(ga, gf, SEED + 274, "27b gather-free vs gathered hmg")
    reset(kb)
    u, niter = gf.solve_pcg(prob.b, rtol=1e-6, maxiter=50)
    torch.cuda.synchronize()
    add_launches(launches, dict(kb.LAUNCHES), ("t1_m", "t23_m", "t23_res_m"))
    _, niter_ga = ga.solve_pcg(prob.b, rtol=1e-6, maxiter=50)
    print(f"    FCG(V) iterations to rtol 1e-6: gather-free {niter}, gathered "
          f"{niter_ga} (26a's fdm: {niter_ref})")
    if abs(niter - niter_ref) > 2 or not bool(torch.isfinite(u).all()):
        raise AssertionError(f"27b: FCG {niter} vs 26a's {niter_ref}")
    bd = gf.to_dist(prob.b)
    ud = torch.zeros_like(bd)
    with a2a_counts() as n:
        gf.apply(bd, ud)
    t_a1, _ = slab_vcycle_ms(ga)
    t_f1, all_f1 = slab_vcycle_ms(gf)
    t_f2, all_f2 = slab_vcycle_ms(gf)
    t_a2, _ = slab_vcycle_ms(ga)
    vc = (t_f1 + t_f2) / 2
    wall, busy, nk, _ = profile_busy(lambda: gf.apply(bd, ud))
    print(f"    V-cycle: gather-free {vc:.3f} ms ({t_f1:.3f}, {t_f2:.3f}; reps "
          f"{[round(t, 3) for t in all_f1 + all_f2]}) vs gathered "
          f"{(t_a1 + t_a2) / 2:.3f} ms ({t_a1:.3f}, {t_a2:.3f}); in turns; "
          f"{n[0]} all_to_all per V-cycle; profiled: busy {busy:.3f} ms, "
          f"{nk} kernels, idle {max(0.0, 1 - busy / vc):.1%} of the "
          "back-to-back cycle")
    out["27b slab hmg gather-free"] = (niter, vc)
    out["27b slab hmg gathered"] = (niter_ga, (t_a1 + t_a2) / 2)
    done(t0)
    return out


def gather_free_grid(prob, niter_ref, cfg, launches):
    """Phase 27c: ``GridPMG((2, 2, 2), coarse="hmg",
    coarse_cfg=dict(dist=True, bottom="fdm"), operator="kron_blocked")``
    on phase 4's mesh and rhs: FCG(V) within 2 of phase 14's grid count
    (``niter_ref``), the L2 error (< 1e-4, `card_l2`), the h-levels, ms
    per V-cycle; #1/#9 launch. Returns ((FCG, ms), the L2 job)."""
    import torch

    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.parallel.grid2d import GridPMG

    ts = time.perf_counter()
    grid = GridPMG(prob.mesh, (2, 2, 2), operator="kron_blocked",
                   coarse_cfg=dict(dist=True, bottom="fdm"),
                   **dict(cfg, coarse="hmg"))
    torch.cuda.synchronize()
    print(f"    setup seconds: {time.perf_counter() - ts:.2f}; h-levels "
          f"(per-shard lattice, coarse to fine) "
          f"{[tuple(lv.shape) for lv in grid.coarse_cfg['hmg_levels']]}, "
          f"bottom {grid.coarse_cfg['hmg_bottom']}")
    reset(kb)
    u, niter = grid.solve_pcg(prob.b, rtol=1e-6, maxiter=50)
    torch.cuda.synchronize()
    counts = dict(kb.LAUNCHES)
    add_launches(launches, counts, ("t1_m", "t23_grid_m"))
    launches["t23_grid_m"] += counts["t23_grid_res_m"]
    print(f"    FCG(V) iterations to rtol 1e-6: {niter} (phase 14's grid with "
          f"the gathered fdm: {niter_ref}); launches "
          f"{dict((k, v) for k, v in counts.items() if v)}")
    if abs(niter - niter_ref) > 2 or not bool(torch.isfinite(u).all()):
        raise AssertionError(f"27c: FCG {niter} vs phase 14's {niter_ref}")
    l2 = card_l2(prob, u)
    bd = grid.to_dist(prob.b)
    ud = torch.zeros_like(bd)
    with a2a_counts() as n:
        grid.apply(bd, ud)
    vc, reps = grid_vcycle_ms(grid)
    wall, busy, nk, _ = profile_busy(lambda: grid.apply(bd, ud))
    print(f"    V-cycle {vc:.3f} ms (reps {[round(t, 3) for t in reps]}); "
          f"{n[0]} all_to_all per V-cycle; profiled: busy {busy:.3f} ms, "
          f"{nk} kernels, idle {max(0.0, 1 - busy / vc):.1%}")
    return (niter, vc), l2


def sharded_steppers(mesh=None, steps=STEP_N):
    """Phase 27d at phase 12's ``heat_cn_2M`` size (``STEP_NC``, p=3,
    2,048,383 dofs): `heat_dist_evolve` CN (dt 1e-4, kappa 2) on 6 slabs
    and on (2, 2, 2), f32 steps/s by the `STEP_SLOPE` slope in turns with the
    single-device `heat_fdm_evolve`; then `wave_leapfrog_dist_evolve`,
    `wave_newmark_dist_evolve`, `semilinear_dist_evolve` (cubic, CNAB) and
    `convdiff_dist_evolve` (CNAB) on 6 slabs of ``BoxMesh(STEP_GATE_NC)``.
    Gates, each over ``steps``
    steps: the f32 run within `STEP_F32_RTOL` relative L2 of the f64 run
    of the same sharded evolver, the f64 sharded run within
    `STEP_F64_RTOL` of its f64 single-device evolver. Then
    ``examples/heat_torch.py --shards 6 --ndofs 250000`` end to end.
    Returns {tag:
    (steps, ms per step)}."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.models.semilinear import cubic
    from pmg_dolfinx_tpu_torch.parallel import transient_dist as td
    from pmg_dolfinx_tpu_torch.solvers import transient as ts1

    mesh = mesh or BoxMesh(STEP_NC)
    P, kappa = 3, 2.0
    c = mesh.dof_coords(P)
    mode = (np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
            * np.sin(np.pi * c[:, 2]))
    f32, f64 = torch.float32, torch.float64
    out = {}

    def timed(ev, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = ev(*args)
        torch.cuda.synchronize()
        return time.perf_counter() - t, r

    def flat(r):
        return (r[0] if isinstance(r, tuple) else r).reshape(-1)

    def gates(tag, make_dist, make_single, args):
        """``make_*(dtype)`` build an evolver (or return a built one)."""
        t32, r32 = timed(make_dist(f32), *args)
        r64 = make_dist(f64)(*args)
        s64 = make_single(f64)(*args)
        e32 = rel_l2(flat(r32).double(), flat(r64))
        e64 = rel_l2(flat(r64), flat(s64))
        print(f"    {tag}: {steps} steps f32 {steps / t32:.1f} steps/s (with "
              f"the loop's first call); f32 vs f64 sharded rel L2 {e32:.3e} "
              f"(gate {STEP_F32_RTOL:g}); f64 sharded vs f64 single device "
              f"{e64:.3e} (gate {STEP_F64_RTOL:g})")
        if not (e32 <= STEP_F32_RTOL and e64 <= STEP_F64_RTOL
                and bool(torch.isfinite(flat(r32)).all())):
            raise AssertionError(f"27d {tag}: {e32:.3e}, {e64:.3e}")
        out[f"27d {tag}"] = (steps, 1e3 * t32 / steps)

    dt = 1e-4
    # Each heat evolver built once per dtype (the host lumped mass and FDM
    # factors are set-up work), for the gates and the timing alike.
    heat = {"single": {d: ts1.heat_fdm_evolve(
        mesh, P, kappa=kappa, dt=dt, scheme="cn", dtype=d, device=DEV)
        for d in (f32, f64)}}
    for shards in (SLAB_SHARDS, (2, 2, 2)):
        tag = f"{shards} slabs" if isinstance(shards, int) else str(shards)
        heat[tag] = {d: td.heat_dist_evolve(
            mesh, P, shards, kappa=kappa, dt=dt, scheme="cn", dtype=d,
            device=DEV) for d in (f32, f64)}
    for tag in list(heat)[1:]:
        gates(f"heat CN {tag}", heat[tag].get, heat["single"].get,
              (mode, steps))
    evs = {t: ev[f32] for t, ev in heat.items()}
    u0 = torch.tensor(mode, dtype=f32, device=DEV)
    lo, hi = STEP_SLOPE
    slope = {t: [] for t in evs}
    for t in list(evs) + list(evs)[::-1]:
        timed(evs[t], u0, lo)
        t_lo, _ = timed(evs[t], u0, lo)
        t_hi, _ = timed(evs[t], u0, hi)
        slope[t].append((t_hi - t_lo) / (hi - lo))
    print("    heat CN f32 steps/s by the " f"{lo}/{hi} slope, in turns: "
          + "; ".join(f"{t} {len(v) / sum(v):.1f} "
                      f"({', '.join(f'{1 / x:.1f}' for x in v)})"
                      for t, v in slope.items()))
    for t, v in slope.items():
        out[f"27d heat CN {t} slope"] = (hi - lo, 1e3 * sum(v) / len(v))

    S = SLAB_SHARDS
    mesh = BoxMesh(STEP_GATE_NC)
    c = mesh.dof_coords(P)
    mode = (np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
            * np.sin(np.pi * c[:, 2]))
    dtw = 0.72 * ts1.wave_stable_dt(mesh, P, kappa=kappa)
    gates("leapfrog", lambda dtype: td.wave_leapfrog_dist_evolve(
        mesh, P, S, kappa=kappa, dt=dtw, dtype=dtype, device=DEV),
        lambda dtype: ts1.wave_leapfrog_evolve(
            mesh, P, kappa=kappa, dt=dtw, dtype=dtype, device=DEV),
        (mode, 0.0 * mode, steps))
    # Newmark at dt 1e-2: at 1e-3 its f32 acceleration c0 (u1 - u*), c0 =
    # 1/(beta dt^2), cancels, and over 200 steps the f32 run leaves the f64
    # one by more than the gate, on one device or sharded alike (the
    # scheme's f32 rounding, not the decomposition).
    gates("Newmark", lambda dtype: td.wave_newmark_dist_evolve(
        mesh, P, S, kappa=kappa, dt=1e-2, dtype=dtype, device=DEV),
        lambda dtype: ts1.wave_newmark_evolve(
            mesh, P, kappa=kappa, dt=1e-2, dtype=dtype, device=DEV),
        (mode, 0.0 * mode, steps))
    nl = cubic(SEMI_C)
    gates("semilinear CNAB", lambda dtype: td.semilinear_dist_evolve(
        mesh, P, S, nl, kappa=kappa, dt=dt, dtype=dtype, device=DEV),
        lambda dtype: ts1.semilinear_fdm_evolve(
            mesh, P, nl, kappa=kappa, dt=dt, dtype=dtype, device=DEV),
        (mode, steps))
    cvel = (3.0, -1.5, 0.8)
    dtc = 0.25 * ts1.convdiff_advective_dt(mesh, P, cvel)
    gates("convdiff CNAB", lambda dtype: td.convdiff_dist_evolve(
        mesh, P, S, cvel, kappa=kappa, dt=dtc, dtype=dtype, device=DEV),
        lambda dtype: ts1.convdiff_fdm_evolve(
            mesh, P, cvel, kappa=kappa, dt=dtc, dtype=dtype, device=DEV),
        (mode, steps))
    return out


def heat_driver_sharded(ndofs="250000"):
    """27d's driver: ``examples/heat_torch.py --shards 6`` (f32, p=3, CN,
    dt 1e-4, 200 steps): the L2 error against the analytic mode < 1e-3."""
    res = run_example("heat_torch", ["--ndofs", ndofs, "--degree", "3",
                                     "--shards", str(SLAB_SHARDS), "--dt",
                                     "1e-4", "--steps", str(STEP_N),
                                     "--device", DEV])
    print(f"    examples/heat_torch.py --shards {SLAB_SHARDS}: {res}")
    if not res["l2_error"] < 1e-3:
        raise AssertionError(f"27d heat driver: {res}")
    return {"27d heat_torch.py --shards 6": (STEP_N,
                                             1e3 / res["steps_per_s"])}


def kron_profile(fn, tag, tries=3):
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
    hierarchy (phase 18d) and the L2 job."""
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
    print(f"    V-cycle {vc:.3f} ms ({VC_CYCLES} back-to-back, 3 reps "
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
    l2_job = card_l2(prob, u)

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
    return hier, l2_job


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
          f"ms vs single device {vcycle_ms(hier)[0]:.3f} ms ({VC_CYCLES} "
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
    print(f"    collocated L2 error {err:.4e}; V-cycle {vc:.3f} ms ({VC_CYCLES} "
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
    (``coarse="hmg"``: the rediscretised curved h-hierarchy at p=1 with a
    dense bottom) on ``curved``, ``lattice_blocked``: FCG(V) within one of
    the ``cg`` coarse count on the same mesh (``niter_ref``), collocated
    L2 < 1e-4; wall and busy ms per V-cycle beside the ``cg`` one's. Adds
    K-A's launches to ``launches``."""
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
    print(f"    FCG(V) iterations to rtol 1e-6: {niter} (cg coarse: "
          f"{niter_ref}); kernel launches on this path: {dict(lb.LAUNCHES)}")
    launches["lattice_apply"] += lb.LAUNCHES["lattice_apply"]
    if abs(niter - niter_ref) > 1:
        raise AssertionError(f"FCG(V) {niter} vs the cg coarse's {niter_ref}")
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
          f"{max(0.0, 1 - busy / vc):.1%}; cg coarse: "
          f"{vc_ref:.3f} ms, busy {busy_ref:.3f} ms, idle "
          f"{max(0.0, 1 - busy_ref / vc_ref):.1%}")
    print("    busy V-cycle by kernel (top 8): " + "; ".join(
        f"{ms:.3f} ms {name[:50]}" for name, ms in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:8]))


# --- phase 28: the general family on the sharded layouts -------------------

GG_SHARDS = (2, 2, 2)
GG_NC = (10, 10, 10)          # 28b, 28d: 226,981 dofs at p=6
# 28b's tensor case with the fields' case: at nc=22 (2,352,637 dofs) it
# took ~40 s of a 1139.0 s script on a slow host (NVIDIA H100 80GB HBM3,
# 700 W); its grid V-cycle is host-paced, so its FCG count sets the time.
GG_TENSOR_NC = GG_NC
GG_HMG_NC = (16, 16, 16)      # 28c: nc=14 has no h-level whose cells split
#                               into (2, 2, 2) shards (14 -> 7)
GG_SLAB_NC = (12, 12, 12)     # 28e: 6 slabs of 2 x-cells
GG_SLABS = 6
# 28a against the single device on cycles above REF_TRAJ_FROM (`parent_gate`'s rule)
# and its FCG solution, relative.
GG_TRAJ_RTOL = 1e-3
GG_SOL_RTOL = 1e-3
GG_REFINED_RTOL = 1e-9
# Robin (alpha 2) on the low y face, Dirichlet elsewhere.
GG_FACES = ((True, True), (False, True), (True, True))
GG_ROBIN = ((0.0, 0.0), (2.0, 0.0), (0.0, 0.0))
# 28e's driver run: `examples/scaling_torch.py --grid` at its defaults.
GG_SCALING = ["--grid", "--operator", "lattice_blocked"]


def curved_grid_ref(prob, hier, rel, niter, u, vc, busy):
    """The single-device state 28a compares with, taken before its
    hierarchy is freed: the
    rhs, trajectory, FCG(V) count and solution, ms and busy ms per V-cycle,
    the smoother bounds, one V-cycle on a seeded rhs and iterate, and K-A's
    launches in that V-cycle (comparison launches, not the path's)."""
    import torch

    from pmg_dolfinx_tpu_torch.ops import lattice_blocked as lb

    n = hier.levels[-1].ndofs
    b1, u1 = seeded(n, SEED + 28), seeded(n, SEED + 29)
    before = lb.LAUNCHES["lattice_apply"]
    v1 = hier.apply(b1, u1)
    torch.cuda.synchronize()
    return dict(b=prob.b, rel=list(rel), niter=niter, u=u, vc=vc, busy=busy,
                lmax=[lv["lmax"].clone() for lv in hier.data["levels"]],
                b1=b1, u1=u1, v1=v1,
                ka_cycle=lb.LAUNCHES["lattice_apply"] - before)


# 17 and 28a: 614,125 dofs at p=6 (each (2, 2, 2) shard 7^3 cells).
CURVED_SMALL_NC = (14, 14, 14)
# Phase 9's in-card reference: the plain lattice V-cycle is ~5x the
# kernel's (181 ms against 37 at nc=21), so its size sets the phase's time.
CURVED_REF_NC = (10, 10, 10)


def curved_small_ref(ccfg):
    """The single-device reference of phases 17 and 28a:
    ``PoissonProblem(mesh=PerturbedBoxMesh(CURVED_SMALL_NC),
    operator="lattice_blocked", coarse="cg")``: 10 cycles, FCG(V) to rtol
    1e-6, ms per V-cycle, busy ms of a profiled V-cycle and
    `curved_grid_ref`'s state. Returns (mesh, state)."""
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import PoissonProblem
    from pmg_dolfinx_tpu_torch.ops import lattice_blocked as lb

    ts = time.perf_counter()
    prob = PoissonProblem(mesh=PerturbedBoxMesh(CURVED_SMALL_NC),
                          operator="lattice_blocked", **ccfg)
    hier = prob.hierarchy
    r0 = float(torch.linalg.vector_norm(prob.b))
    _, rn = prob.solve(num_cycles=10)
    rel = [r / r0 for r in rn]
    u, niter = hier.solve_pcg(prob.b, rtol=1e-6, maxiter=50)
    vc, _ = vcycle_ms(hier)
    b1 = torch.ones_like(prob.b)
    hier.apply(b1, torch.zeros_like(b1))
    _, busy, nk, _, _, tries, complete = profile_complete(
        lambda: hier.apply(b1, torch.zeros_like(b1)), lb)
    print(f"    single-device reference (lattice_blocked + cg, "
          f"{prob.mesh.num_dofs(6):,} dofs): FCG(V) {niter}, V-cycle "
          f"{vc:.3f} ms, busy {busy:.3f} ms ({nk} kernels, "
          f"{'complete' if complete else 'INCOMPLETE'} window, {tries} "
          f"tried); {time.perf_counter() - ts:.2f} s with its setup")
    return prob.mesh, curved_grid_ref(prob, hier, rel, niter, u, vc, busy)


def grid_ka_parity(grid, seed, tag):
    """K-A on each shard of every level of a `GridPMG` (the stacked
    vector's, marker's and ``Gt``'s contiguous blocks, ``apply_bc=False``)
    against its plain version on the same inputs; returns the worst rel
    max-norm error."""
    import numpy as np

    from pmg_dolfinx_tpu_torch.ops import lattice_blocked as lb

    worst = 0.0
    for i, (lv, level) in enumerate(zip(grid.data["levels"], grid.levels)):
        P = level.P
        ncl = tuple((n - 1) // P for n in level.shape)
        x = seeded(int(np.prod(grid.shards)) * level.ndofs, seed + i
                   ).reshape(grid.shards + tuple(level.shape))
        errs = []
        for idx in np.ndindex(*grid.shards):
            args = (x[idx], lv["lb_mats"], lv["Gt"][idx], lv["bc_marker"][idx])
            y = lb.blocked_lattice_apply(*args, ncl, P, apply_bc=False)
            errs.append(rel_max_err(y, lb.plain_lattice_apply(
                *args, apply_bc=False)))
        worst = max(worst, max(errs))
        args = (x[(0, 0, 0)], lv["lb_mats"], lv["Gt"][(0, 0, 0)],
                lv["bc_marker"][(0, 0, 0)])
        dev = graph_ms(lambda: lb.blocked_lattice_apply(
            *args, ncl, P, apply_bc=False))
        bound, by = kernel_bound("lattice_apply", level.ndofs, P, nc=ncl)
        print(f"    {tag}: K-A per shard at p={P} ({level.shape[0]}x"
              f"{level.shape[1]}x{level.shape[2]}, {len(errs)} shards, "
              f"apply_bc=False) vs plain: rel max err {max(errs):.3e}; "
              f"device {dev:.4f} ms a shard (CUDA graph of 20), "
              f"{len(errs) * dev:.4f} ms an apply; bound {bound:.4f} ms a "
              f"shard ({by}), {bound / dev:.0%}")
    if not worst <= KERNEL_RTOL:
        raise AssertionError(f"{tag}: K-A per shard differs from its plain "
                             f"version by {worst:.3e}")
    return worst


def grid_at_lmax(grid, lmax, fn):
    """``fn()`` with ``grid`` at the smoother bounds ``lmax`` (one per
    p-level), its own restored after."""
    own = [lv["lmax"] for lv in grid.data["levels"]]
    for lv, lm in zip(grid.data["levels"], lmax):
        lv["lmax"] = lm
    try:
        return fn()
    finally:
        for lv, lm in zip(grid.data["levels"], own):
            lv["lmax"] = lm


def grid_general_path(curved, ref, launches):
    """Phase 28a: ``GridPMG(curved, (2, 2, 2), degrees=(1, 3, 6),
    kappa=2, float32, coarse="cg", operator="lattice_blocked")`` on the
    mesh and rhs of ``ref`` (`curved_small_ref`: 614,125 dofs, each shard
    7^3 cells, 43^3 at p=6), K-A once per shard: 10 cycles within
    `GG_TRAJ_RTOL` of the single device's trajectory above
    `REF_TRAJ_FROM`, FCG(V) within one of its count and its solution
    within `GG_SOL_RTOL`, one V-cycle at its smoother bounds within
    `GRID_VCYCLE_RTOL` of its one on the same seeded inputs, K-A launched
    8 times as often as in its V-cycle, collocated L2 < 1e-4, each
    shard's K-A within `KERNEL_RTOL` of its plain version. Prints ms per
    V-cycle beside the single device's and a profiled window. Returns
    {tag: (FCG, ms per V-cycle)}."""
    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import l2_error_collocated
    from pmg_dolfinx_tpu_torch.models.poisson import u_exact
    from pmg_dolfinx_tpu_torch.ops import lattice_blocked as lb
    from pmg_dolfinx_tpu_torch.parallel.grid2d import GridPMG

    reset(lb)
    ts = time.perf_counter()
    grid = GridPMG(curved, GG_SHARDS, degrees=(1, 3, 6), kappa=2.0,
                   dtype=torch.float32, coarse="cg",
                   operator="lattice_blocked", device=DEV)
    torch.cuda.synchronize()
    setup = time.perf_counter() - ts
    print(f"    setup seconds (host geometry, diagonal, calibration): "
          f"{setup:.2f}; shard lattices "
          f"{[tuple(lv.shape) for lv in grid.levels]}; lmax "
          f"{[round(float(lv['lmax']), 4) for lv in grid.data['levels']]} "
          f"(single device: {[round(float(v), 4) for v in ref['lmax']]})")
    r0 = float(torch.linalg.vector_norm(ref["b"]))
    ts = time.perf_counter()
    _, rn = grid.solve(ref["b"], num_cycles=10)
    solve_s = time.perf_counter() - ts
    rel = [r / r0 for r in rn]
    diff = traj_diff(rel, ref["rel"])
    print(f"    10 cycles ({solve_s:.3f} s host clock): rel "
          f"{[f'{v:.4e}' for v in rel]}; vs the single device: max rel diff "
          f"{diff:.3e} above {REF_TRAJ_FROM:g} (gate {GG_TRAJ_RTOL:g})")
    ts = time.perf_counter()
    u, niter = grid.solve_pcg(ref["b"], rtol=1e-6, maxiter=50)
    torch.cuda.synchronize()
    pcg_s = time.perf_counter() - ts
    path = dict(lb.LAUNCHES)
    add_launches(launches, path, ("lattice_apply",))
    du = float(torch.linalg.vector_norm(u - ref["u"])
               / torch.linalg.vector_norm(ref["u"]))
    print(f"    FCG(V) to rtol 1e-6: {niter} (single device: {ref['niter']}; "
          f"{pcg_s:.3f} s host clock), solution vs the single device's rel "
          f"{du:.3e}; K-A launches on the path {path['lattice_apply']}")
    if not (diff <= GG_TRAJ_RTOL and abs(niter - ref["niter"]) <= 1
            and du <= GG_SOL_RTOL):
        raise AssertionError(f"28a: trajectory {diff:.3e}, FCG {niter} vs "
                             f"{ref['niter']}, solution {du:.3e}")
    if tuple(u.shape) != (curved.num_dofs(6),) or not bool(
            torch.isfinite(u).all()):
        raise AssertionError("28a: solution is not a finite vector of ndofs")
    before = lb.LAUNCHES["lattice_apply"]
    v = grid_at_lmax(grid, ref["lmax"], lambda: grid.from_dist(grid.apply(
        grid.to_dist(ref["b1"]), grid.to_dist(ref["u1"]))))
    torch.cuda.synchronize()
    ka_cycle = lb.LAUNCHES["lattice_apply"] - before
    err_v = rel_max_err(v, ref["v1"])
    print(f"    one V-cycle at the single device's smoother bounds, seeded rhs and "
          f"iterate: rel max err {err_v:.3e} (gate {GRID_VCYCLE_RTOL:g}); "
          f"K-A launches per V-cycle {ka_cycle} (single device: "
          f"{ref['ka_cycle']}, x{ka_cycle / max(1, ref['ka_cycle']):.1f})")
    if not (err_v <= GRID_VCYCLE_RTOL
            and ka_cycle == 8 * ref["ka_cycle"]):
        raise AssertionError(f"28a: V-cycle {err_v:.3e}, K-A {ka_cycle} vs "
                             f"8 x {ref['ka_cycle']}")
    ts = time.perf_counter()
    err = l2_error_collocated(curved, 6, u.double().cpu().numpy(), u_exact)
    print(f"    collocated L2 error {err:.4e} "
          f"({time.perf_counter() - ts:.1f} s host)")
    if not err < 1e-4:
        raise AssertionError(f"28a: L2 error {err}")
    # One rep each (it was 3): the script's time limit on a slow host.
    vc, vc_all = grid_vcycle_ms(grid, reps=1)
    pace = [(round(e, 3), round(h, 3))
            for e, h in grid_vcycle_pace(grid, reps=1)]
    b1 = torch.ones(grid.shards + grid.levels[-1].shape, dtype=grid.dtype,
                    device=grid.device)
    grid.apply(b1, torch.zeros_like(b1))
    wall, busy, nk, by_name, _, tries, complete = profile_complete(
        lambda: grid.apply(b1, torch.zeros_like(b1)), lb)
    ka = lattice_kernel_ms(by_name)
    print(f"    V-cycle {vc:.3f} ms ({VC_CYCLES} back-to-back, 1 rep) against "
          f"the single device's "
          f"{ref['vc']:.3f} ms; (event ms, host ms to enqueue) per cycle "
          f"{pace}; profiled ({'complete' if complete else 'INCOMPLETE'} "
          f"window, {tries} tried): wall {wall:.3f} ms, busy {busy:.3f} ms "
          f"({nk} kernels), K-A {ka['march'] + ka['fold']:.3f} ms "
          f"({(ka['march'] + ka['fold']) / max(busy, 1e-9):.1%}), idle "
          f"{max(0.0, 1 - busy / vc):.1%} (single device: busy {ref['busy']:.3f} "
          f"ms, idle {max(0.0, 1 - ref['busy'] / ref['vc']):.1%})")
    grid_ka_parity(grid, SEED + 280, "28a")
    return {"28a grid lattice_blocked": (niter, vc)}


def grid_vcycle_pace(grid, cycles=VC_CYCLES, reps=3):
    """`vcycle_pace` for a `GridPMG`."""
    import torch

    b = torch.ones(grid.shards + grid.levels[-1].shape, dtype=grid.dtype,
                   device=grid.device)
    u = torch.zeros_like(b)
    grid.apply(b, u)
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        for _ in range(cycles):
            grid.apply(b, u)
        host = (time.perf_counter() - t0) * 1e3 / cycles
        end.record()
        end.synchronize()
        out.append((start.elapsed_time(end) / cycles, host))
    return out


def f_klin_sfield():
    """Source of `kappa_linear` with the `sigma_linear` reaction field."""
    from pmg_dolfinx_tpu_torch.models import poisson as pm

    fv = pm.f_rhs_variable()
    return lambda x: fv(x) + pm.sigma_linear(x) * pm.u_exact(x)


def grid_general_coeffs(launches):
    """Phases 28b and 28d. 28b: `GridPMG` (2, 2, 2) ``lattice_blocked`` +
    ``cg`` on curved meshes, `kappa_linear` + `sigma_linear` at `GG_NC`
    and `kappa_aniso` at `GG_TENSOR_NC`, each against the single-device
    ``lattice_blocked`` hierarchy on the same problem: FCG(V) within one,
    one V-cycle at its smoother bounds within `GRID_VCYCLE_RTOL`, L2 < 1e-4
    (`kappa_linear`: within 1% of the single device's, the DG-0
    coefficient's own h^2 error). 28d: `solve_refined` of the first grid
    to `GG_REFINED_RTOL` within 2 cycles of the single device's count.
    Returns {tag: (FCG, ms per V-cycle)}."""
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_tpu_torch.models import poisson as pm
    from pmg_dolfinx_tpu_torch.ops import lattice_blocked as lb
    from pmg_dolfinx_tpu_torch.parallel.grid2d import GridPMG

    t0 = phase(f"28b. GridPMG {GG_SHARDS} lattice_blocked + cg, curved: "
               f"kappa_linear + sigma_linear at nc={GG_NC[0]}, kappa_aniso "
               f"at nc={GG_TENSOR_NC[0]}, each vs the single device")
    cfg = dict(degrees=(1, 3, 6), dtype=torch.float32, coarse="cg",
               operator="lattice_blocked", device=DEV)
    K = pm.kappa_aniso()
    out, keep = {}, None
    for tag, nc, kw, f in (
            ("kappa_linear + sigma_linear", GG_NC,
             dict(kappa=pm.kappa_linear, sigma=pm.sigma_linear),
             f_klin_sfield()),
            ("kappa_aniso", GG_TENSOR_NC, dict(kappa=K), pm.f_rhs_tensor(K))):
        mesh = PerturbedBoxMesh(nc)
        ts = time.perf_counter()
        prob = pm.PoissonProblem(mesh=mesh, f=f, **kw, **cfg)
        u_s, n_s = prob.hierarchy.solve_pcg(prob.b, rtol=1e-6, maxiter=100)
        err_s = prob.error_l2(u_s)
        t_single = time.perf_counter() - ts
        reset(lb)
        ts = time.perf_counter()
        grid = GridPMG(mesh, GG_SHARDS, **kw, **cfg)
        torch.cuda.synchronize()
        setup = time.perf_counter() - ts
        u_g, n_g = grid.solve_pcg(prob.b, rtol=1e-6, maxiter=100)
        torch.cuda.synchronize()
        path = dict(lb.LAUNCHES)
        add_launches(launches, path, ("lattice_apply",))
        err_g = prob.error_l2(u_g)
        gate = 1.01 * err_s if callable(kw["kappa"]) else 1e-4
        vc = grid_vcycle_ms(grid)[0]
        print(f"    {tag} at nc={nc[0]} ({mesh.num_dofs(6):,} dofs): grid "
              f"setup {setup:.2f} s, FCG(V) {n_g} (single device {n_s}, "
              f"{t_single:.1f} s with its setup), L2 {err_g:.4e} (single "
              f"{err_s:.4e}; gate {gate:.4e}), V-cycle {vc:.3f} ms "
              f"(single {vcycle_ms(prob.hierarchy)[0]:.3f}); K-A launches "
              f"{path['lattice_apply']}")
        grid_vcycle_parity(grid, prob.hierarchy, SEED + 281, f"28b {tag}")
        if not (abs(n_g - n_s) <= 1 and n_g < 100 and err_g < gate):
            raise AssertionError(f"28b {tag}: FCG {n_g} / {n_s}, L2 "
                                 f"{err_g} / {gate}")
        out[f"28b {tag}"] = (n_g, vc)
        if keep is None:
            keep = (prob, grid)
        else:
            del prob, grid
    done(t0)
    prob, grid = keep
    t0 = phase("28d. GridPMG.solve_refined on 28b's kappa_linear + "
               "sigma_linear grid: f64 residual to "
               f"{GG_REFINED_RTOL:g}")
    reset(lb)
    r0 = float(torch.linalg.vector_norm(prob.b.double()))
    ts = time.perf_counter()
    u64, rn_g = grid.solve_refined(prob.b, num_cycles=40,
                                   rtol=GG_REFINED_RTOL)
    t_grid = time.perf_counter() - ts
    path = dict(lb.LAUNCHES)
    add_launches(launches, path, ("lattice_apply",))
    _, rn_s = prob.hierarchy.solve_refined(prob.b, num_cycles=40,
                                           rtol=GG_REFINED_RTOL)
    print(f"    grid: {len(rn_g)} cycles to {rn_g[-1] / r0:.3e} "
          f"({t_grid:.2f} s host clock); single device: {len(rn_s)} to "
          f"{rn_s[-1] / r0:.3e}; u64 {u64.dtype}; K-A launches "
          f"{path['lattice_apply']}")
    if not (rn_g[-1] < GG_REFINED_RTOL * r0
            and abs(len(rn_g) - len(rn_s)) <= 2):
        raise AssertionError(f"28d: {len(rn_g)} cycles to "
                             f"{rn_g[-1] / r0:.3e}, single {len(rn_s)}")
    out["28d solve_refined"] = (len(rn_g), None)
    done(t0)
    return out


def grid_general_hmg(launches):
    """Phase 28c: ``coarse="hmg", coarse_cfg=dict(dist=True)``
    (`build_hmg_grid_general`, every h-level in the stacked layout) on a
    curved `GG_HMG_NC` mesh with a Robin face and z graded (ratio
    `GRADE_RATIO`), (2, 2, 2) ``lattice_blocked``, against the gathered
    ``hmg`` on the same grid: FCG(V) within 2, one V-cycle at the gathered
    grid's smoother bounds within `GF_VCYCLE_RTOL`. Prints the h-levels and
    ms per V-cycle of both. Returns {tag: (FCG, ms per V-cycle)}."""
    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu_torch.fem.mesh import (PerturbedBoxMesh,
                                                geometric_spacing)
    from pmg_dolfinx_tpu_torch.models.poisson import f_rhs
    from pmg_dolfinx_tpu_torch.ops import lattice_blocked as lb
    from pmg_dolfinx_tpu_torch.parallel.grid2d import GridPMG

    mesh = PerturbedBoxMesh(GG_HMG_NC, dirichlet_faces=GG_FACES,
                            robin=GG_ROBIN, spacing=(
                                None, None,
                                geometric_spacing(GG_HMG_NC[2], GRADE_RATIO)))
    b = torch.tensor(assemble_rhs(mesh, 6, f_rhs(2.0)), dtype=torch.float32,
                     device=DEV)
    cfg = dict(degrees=(1, 3, 6), kappa=2.0, dtype=torch.float32,
               operator="lattice_blocked", coarse="hmg", device=DEV)
    reset(lb)
    ts = time.perf_counter()
    g_d = GridPMG(mesh, GG_SHARDS, coarse_cfg=dict(dist=True), **cfg)
    torch.cuda.synchronize()
    setup = time.perf_counter() - ts
    _, n_d = g_d.solve_pcg(b, rtol=1e-6, maxiter=50)
    torch.cuda.synchronize()
    path = dict(lb.LAUNCHES)
    add_launches(launches, path, ("lattice_apply",))
    g_g = GridPMG(mesh, GG_SHARDS, **cfg)
    _, n_g = g_g.solve_pcg(b, rtol=1e-6, maxiter=50)
    vc_d, vc_g = grid_vcycle_ms(g_d)[0], grid_vcycle_ms(g_g)[0]
    print(f"    {mesh.num_dofs(6):,} dofs; h-levels (p=1, stacked) "
          f"{[tuple(lv.shape) for lv in g_d.coarse_cfg['hmg_levels']]} per "
          f"shard, bottom '{g_d.coarse_cfg['hmg_bottom']}'; setup "
          f"{setup:.2f} s; FCG(V) {n_d} (gathered {n_g}); V-cycle {vc_d:.3f} "
          f"ms (gathered {vc_g:.3f}); K-A launches {path['lattice_apply']}")
    if not (abs(n_d - n_g) <= 2 and n_d < 50):
        raise AssertionError(f"28c: FCG {n_d} vs gathered {n_g}")
    dist_vcycle_parity(g_g, g_d, SEED + 282, "28c dist vs gathered hmg")
    return {"28c hmg dist": (n_d, vc_d)}


def slab_general(launches):
    """Phase 28e: `DistPMG` with `GG_SLABS` slabs, ``lattice`` (plain torch)
    in float32 on a curved `GG_SLAB_NC` mesh with `kappa_linear`,
    `sigma_linear` and a Robin face, against the single-device ``lattice``
    hierarchy: FCG(V) within 1, one V-cycle at its smoother bounds within
    `GRID_VCYCLE_RTOL`; then `examples/scaling_torch.py` `GG_SCALING` (the
    grid sweep, K-A per shard) at its default size in this process, every
    layout's trajectory invariant. Returns {tag: (FCG, ms per V-cycle)}."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_tpu_torch.models import poisson as pm
    from pmg_dolfinx_tpu_torch.ops import lattice_blocked as lb
    from pmg_dolfinx_tpu_torch.parallel.dist import DistPMG
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    mesh = PerturbedBoxMesh(GG_SLAB_NC, dirichlet_faces=GG_FACES,
                            robin=GG_ROBIN)
    kw = dict(degrees=(1, 3, 6), kappa=pm.kappa_linear,
              sigma=pm.sigma_linear, dtype=torch.float32, coarse="cg",
              operator="lattice", device=DEV)
    ts = time.perf_counter()
    single = PMGHierarchy(mesh, **kw)
    slab = DistPMG(mesh, n_devices=GG_SLABS, **kw)
    setup = time.perf_counter() - ts
    n = mesh.num_dofs(6)
    bc = torch.tensor(mesh.boundary_dof_marker(6), device=DEV)
    b = torch.where(bc, 0.0, seeded(n, SEED + 283))
    _, n_s = single.solve_pcg(b, rtol=1e-6, maxiter=50)
    _, n_d = slab.solve_pcg(b, rtol=1e-6, maxiter=50)
    slab.load_state({"levels": [{"lmax": lv["lmax"]}
                                for lv in single.data["levels"]]})
    b1, u1 = seeded(n, SEED + 284), seeded(n, SEED + 285)
    err = rel_max_err(slab.from_dist(slab.apply(slab.to_dist(b1),
                                                slab.to_dist(u1))),
                      single.apply(b1, u1))
    vc = slab_vcycle_ms(slab)[0]
    print(f"    {n:,} dofs, {GG_SLABS} slabs: setup {setup:.2f} s (both); "
          f"FCG(V) {n_d} (single device {n_s}); one V-cycle at the single "
          f"device's smoother bounds: rel max err {err:.3e} (gate "
          f"{GRID_VCYCLE_RTOL:g}); V-cycle {vc:.3f} ms")
    if not (abs(n_d - n_s) <= 1 and err <= GRID_VCYCLE_RTOL):
        raise AssertionError(f"28e: FCG {n_d} / {n_s}, V-cycle {err:.3e}")
    reset(lb)
    ts = time.perf_counter()
    res = run_example("scaling_torch", GG_SCALING)
    torch.cuda.synchronize()
    path = dict(lb.LAUNCHES)
    add_launches(launches, path, ("lattice_apply",))
    rows = res["rows"]
    print(f"    scaling_torch.py {' '.join(GG_SCALING)}: "
          f"{time.perf_counter() - ts:.1f} s, {res['ndofs']:,} dofs, "
          f"layouts {[r['layout'] for r in rows]}, s/cycle "
          f"{[round(r['s_per_cycle'], 4) for r in rows]}; K-A launches "
          f"{path['lattice_apply']}")
    if not (all(r["invariant"] for r in rows[1:])
            and all(np.isfinite(r["rel_resid"]) for r in rows)):
        raise AssertionError(f"28e: the grid sweep's trajectories are not "
                             f"layout-invariant: {rows}")
    return {"28e slab lattice": (n_d, vc)}


def grid_general_family(curved, ref, launches):
    """Phase 28 (28a-28e): the general family on the sharded layouts, K-A
    once per shard on the grid. Returns {tag: (FCG, ms per V-cycle)}."""
    out = {}
    t_all = time.perf_counter()
    t0 = phase(f"28a. GridPMG(PerturbedBoxMesh({CURVED_SMALL_NC}), (2, 2, "
               "2), degrees=(1, 3, 6), kappa=2, float32, coarse='cg', "
               "operator='lattice_blocked'): 17's problem on the grid, "
               "614,125 dofs, K-A once per shard")
    out.update(grid_general_path(curved, ref, launches))
    done(t0)
    out.update(grid_general_coeffs(launches))
    t0 = phase(f"28c. coarse='hmg' with dist=True (build_hmg_grid_general) "
               f"on a curved nc={GG_HMG_NC[0]} mesh, a Robin face, z graded "
               f"{GRADE_RATIO:g}:1, {GG_SHARDS} lattice_blocked, vs the "
               "gathered hmg")
    out.update(grid_general_hmg(launches))
    done(t0)
    t0 = phase(f"28e. DistPMG(n_devices={GG_SLABS}, operator='lattice') f32 "
               f"on a curved nc={GG_SLAB_NC[0]} mesh, kappa_linear, "
               "sigma_linear, a Robin face, vs one device; then "
               "examples/scaling_torch.py " + " ".join(GG_SCALING))
    out.update(slab_general(launches))
    done(t0)
    print(f"    phase 28 seconds: {time.perf_counter() - t_all:.1f}")
    return out


# Cut from 2,000,000 (112 s, mostly host setup; PR 16) and from 500,000
# (34.9 s; PR 17, for the slab phases 26a-26c).
AMG_TWIN_NDOFS = 250000


def amg_twin():
    """Phase 18a: ``examples/amg_torch.py --ndofs AMG_TWIN_NDOFS --pc
    jacobi|cheb|hmg``, box and ``--mesh perturbed``, in this process, one
    mesh object per cell count (the hmg runs round the fitted cells to
    multiples of 4, with a ``cg`` bottom, as the JAX driver does):
    h-multigrid-preconditioned CG must take fewer iterations than
    Jacobi-CG on each mesh. Cut from the driver's 2M to keep the script in
    its time limit: the six runs were mostly host setup."""
    from pmg_dolfinx_tpu_torch.utils import timers

    spec = importlib.util.spec_from_file_location(
        "amg_torch", ROOT / "examples" / "amg_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh, PerturbedBoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import fit_box_cells

    nc = fit_box_cells(AMG_TWIN_NDOFS, 1)
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
                iters[pc] = mod.main(["--ndofs", str(AMG_TWIN_NDOFS), "--pc",
                                      pc, "--mesh", mesh],
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


def box_family(mesh, launches, grid14_ms=None, mixed=None):
    """Phase 19a/19b at 16,194,277 dofs (p=(1,3,6), float32, kron_blocked +
    fdm). 19a: the JAX driver's ``--grade z:8 --neumann x --robin y``
    (kappa 2): FCG(V) to 1e-6 within 50, L2 < 1e-4, ms per V-cycle, #1-#3
    launches. 19b on ``mesh`` (phase 4's uniform box, whose host geometry
    is cached): ``--kappa-field aniso-diag``: FCG(V) count, ms per
    V-cycle; the ``--fdm`` one-shot direct solve against the FCG solution,
    and its L2 < 1e-4 at nc=21. Phase 29a runs between them, on 19a's
    mesh, rhs and hierarchy (`kron_sharded_flagship`; ``grid14_ms``: phase
    14's grid V-cycle ms, printed beside its own). ``mixed``: 19a's
    ``mixed_mesh(42)`` (its host geometry built already), else a new one.
    Returns ({tag: (FCG, ms per V-cycle)}, 19a's L2 job for
    `check_l2`)."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs
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
    prob = mixed_problem(mixed if mixed is not None else mixed_mesh(42),
                         kappa=2.0, **cfg)
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
    l2_job = card_l2(prob, u)
    vc, vc_all = vcycle_ms(prob.hierarchy)
    print(f"    V-cycle {vc:.3f} ms ({VC_CYCLES} back-to-back, 3 reps "
          f"{[round(t, 3) for t in vc_all]})")
    out["19a"] = (niter, vc)
    done(t0)

    t0 = phase("29a. Kronecker family on the device grid (run here, on 19a's "
               "mesh, rhs and hierarchy): GridPMG (2,2,2), 16.2M dofs, "
               "kron_blocked + fdm, x Neumann, y Robin, z graded 8:1")
    out["29a grid"] = kron_sharded_flagship(prob, u, niter, vc, cfg,
                                            launches, grid14_ms)
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
    print(f"    V-cycle {vc:.3f} ms ({VC_CYCLES} back-to-back, 3 reps "
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
    err = card_l2_error(m21, 6, fdm.solve(b21), u_exact)
    print(f"    --fdm one-shot at nc=21: L2 error {err:.4e}")
    if not err < 1e-4:
        raise AssertionError(f"19b: FDM L2 error {err}")
    done(t0)
    return out, l2_job


def card_l2_error(mesh, P, u, u_exact, chunk=6):
    """`fem.assembly.l2_error` (the Gauss-Legendre rule on an axis-aligned
    box, float64) with its sum-factorised interpolation to the quadrature
    points on ``u``'s device and ``u_exact`` on the host ``chunk`` x-cells
    at a time: seconds at 16.2M dofs, where the host rule takes ~100 s of
    numpy."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.gll import (gauss_legendre, gauss_lobatto,
                                               lagrange_tabulate)

    nq = P + 3
    xq, wq = gauss_legendre(nq)
    phi = lagrange_tabulate(gauss_lobatto(P + 1)[0], xq, 0)[0]   # (nq, n)
    f64 = dict(dtype=torch.float64, device=u.device)
    lat = u.to(torch.float64).reshape(mesh.lattice_shape(P))
    B, pts, wts = [], [], []
    for a in range(3):
        nc, h = mesh.nc[a], np.broadcast_to(mesh.h_cells[a], (mesh.nc[a],))
        Ba = np.zeros((nc * nq, nc * P + 1))
        for c in range(nc):
            Ba[c * nq:(c + 1) * nq, c * P:c * P + P + 1] = phi
        B.append(torch.tensor(Ba, **f64))
        pts.append((mesh.axis_nodes(a)[:-1, None] + xq[None] * h[:, None])
                   .reshape(-1))
        wts.append(torch.tensor((wq[None] * h[:, None]).reshape(-1), **f64))
    t = torch.einsum("cz,xyz->xyc", B[2],
                     torch.einsum("by,xyz->xbz", B[1], lat))
    err2 = torch.zeros((), **f64)
    for c0 in range(0, mesh.nc[0], chunk):
        rows = slice(c0 * nq, min(c0 + chunk, mesh.nc[0]) * nq)
        uq = torch.einsum("ax,xyz->ayz", B[0][rows], t)
        X, Y, Z = np.meshgrid(pts[0][rows], pts[1], pts[2], indexing="ij")
        ue = torch.tensor(u_exact(np.stack(
            [X.reshape(-1), Y.reshape(-1), Z.reshape(-1)])), **f64)
        w = (wts[0][rows][:, None, None] * wts[1][None, :, None]
             * wts[2][None, None, :])
        err2 += ((uq - ue.reshape(uq.shape)) ** 2 * w).sum()
    return float(torch.sqrt(err2))


def card_l2(prob, u):
    """``prob.error_l2(u)`` on its axis-aligned box by `card_l2_error`,
    computed now: a finished job for `check_l2`."""
    from concurrent.futures import Future

    started = time.perf_counter()
    job = Future()
    job.set_result(card_l2_error(prob.mesh, prob.degrees[-1], u,
                                 prob._u_exact))
    return job, started


def start_l2(fn, *args):
    """Run a host L2 error (numpy, ~90-120 s at 16.2M dofs), or other host
    numpy, on a worker thread while the card goes on: ``(future, start
    time)``; `check_l2` joins an L2 job."""
    pool = ThreadPoolExecutor(max_workers=1)
    job = (pool.submit(fn, *args), time.perf_counter())
    pool.shutdown(wait=False)
    return job


def check_l2(job, tag="19a", what="u_exact_mixed"):
    """Read a phase's L2 job (a host thread's or `card_l2`'s): L2 <
    1e-4."""
    future, started = job
    err = future.result()
    print(f"    {tag} (joined): L2 error vs {what} {err:.4e} (the job "
          f"started {time.perf_counter() - started:.1f} s ago)")
    if not err < 1e-4:
        raise AssertionError(f"{tag}: L2 error {err}")
    return err


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


# --- phase 29: the Kronecker family on the sharded layouts ------------------

KS_SHARDS = (2, 2, 2)
KS_SMALL_NC = 12              # 29b, 29d: 73^3 = 389,017 dofs at p=6
# 29c: 169x85x85 = 1,221,025 dofs at p=6 (it was (42, 21, 21), 4,080,907
# dofs, until a run took 1306.6 s to phase 25e on a slow host).
KS_SLAB_NC = (28, 14, 14)
KS_SLABS = 7
# 29c: x graded 8:1 with a Robin x-high face (alpha 1.7), Dirichlet
# elsewhere: every slab's x block differs, the last one by its Robin end.
KS_SLAB_FACES = ((True, False), (True, True), (True, True))
KS_SLAB_ROBIN = ((0.0, 1.7), (0.0, 0.0), (0.0, 0.0))
KS_PER_AXIS = (1.0, 2.0, 4.0)
KS_REFINED_RTOL = 1e-9
# 29d's cap on refinement cycles: the f32 V-cycle contracts this mixed-BC
# problem's f64 residual by ~0.77-0.83 a cycle (75 cycles to 1e-9 at
# nc=4, 94 at nc=8, CPU runs of the same code), slower as nc grows.
KS_REFINED_MAX = 250


def ks_shard_parity(grid, seed, tag, differ=True):
    """Kernels #1 and #9 (apply and fused residual, both corrections, sigma
    0 and 0.5) on every shard of ``grid``'s fine level, each with its own
    ``kb_blocks`` entry, against the plain versions on the same blocks:
    relative max-norm within `KERNEL_RTOL`. First checks that the blocks
    differ where the mesh says they must: the y shards' ``Kty`` (one
    Robin end each) and the z shards' ``KtzT`` (graded z). These launches
    are comparisons, not the main path's. ``differ=False`` skips the
    first check (a rank's block need not hold both shards). Returns the
    worst error."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb

    lv = grid.data["levels"][-1]
    blocks = lv["kb_blocks"]
    for key, a, b in (("Kty", (0, 0, 0), (0, 1, 0)),
                      ("KtzT", (0, 0, 0), (0, 0, 1))):
        if differ and torch.equal(blocks[a][key], blocks[b][key]):
            raise AssertionError(f"{tag}: shards {a} and {b} share {key}")
    shape = tuple(grid.levels[-1].shape)
    rng = np.random.default_rng(seed)
    f32 = lambda s: torch.tensor(rng.standard_normal(s, dtype=np.float32),
                                 device=DEV)
    x, r = f32(shape), f32(shape)
    cy, cz = f32((shape[0], 2, shape[2])), f32((shape[0], shape[1], 2))
    worst = 0.0
    for idx, m in blocks.items():
        t1 = kb.plain_t1_m(x, m)
        worst = max(worst, rel_max_err(kb.kron_t1_m(x, m), t1))
        for sigma in (0.0, 0.5):
            ref = kb.plain_t23_grid_m(x, t1, m, sigma, cy, cz)
            worst = max(worst, rel_max_err(
                kb.kron_t23_grid_m(x, t1, m, sigma, cy, cz), ref),
                rel_max_err(kb.kron_t23_grid_m(x, t1, m, sigma, cy, cz,
                                               r3=r), r - ref))
    torch.cuda.synchronize()
    print(f"    {tag}: #1 and #9 (apply, residual; sigma 0, 0.5) on each of "
          f"the {len(blocks)} shards' own blocks"
          + (" (Kty differs across y, KtzT across z)" if differ else "")
          + f" vs the plain versions: worst rel max err {worst:.3e} "
          f"(gate {KERNEL_RTOL:g})")
    if not worst <= KERNEL_RTOL:
        raise AssertionError(f"{tag}: per-shard kernels differ by {worst}")
    return worst


def kron_sharded_flagship(prob, u_ref, niter_ref, vc_ref, cfg, launches,
                          grid14_ms=None):
    """Phase 29a, run right after 19a on its mesh, rhs and hierarchy: the
    slice's path, ``GridPMG(mixed_mesh(42), (2, 2, 2), degrees=(1, 3, 6),
    kappa=2, float32, coarse="fdm", operator="kron_blocked")`` (x Neumann,
    y Robin, z graded 8:1; 16,194,277 dofs), every shard on this card, at
    19a's smoother bounds: 10 stationary cycles within `GRID_TRAJ_RTOL` of
    19a's on cycles above `REF_TRAJ_FROM`, FCG(V) within 1 of 19a's count
    (``niter_ref``) and its solution within 1e-3 of 19a's (``u_ref``), one
    seeded V-cycle within `GRID_VCYCLE_RTOL`, the card L2 < 1e-4, #1 and #9
    per shard (`ks_shard_parity`); ms per V-cycle beside 19a's (``vc_ref``)
    and phase 14's (``grid14_ms``), the profiled busy ms, kernels and idle
    share. Adds #1's and #9's launches on the path to ``launches``; returns
    (FCG, ms per V-cycle)."""
    import torch

    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.parallel.grid2d import GridPMG

    hier = prob.hierarchy
    r0 = float(torch.linalg.vector_norm(prob.b))
    _, rn = hier.solve(prob.b, num_cycles=10)
    rel_ref = [v / r0 for v in rn]
    ts = time.perf_counter()
    grid = GridPMG(prob.mesh, KS_SHARDS, kappa=2.0, **cfg)
    torch.cuda.synchronize()
    print(f"    setup seconds: {time.perf_counter() - ts:.2f} (per-shard "
          f"lattice {grid.levels[-1].shape}; eig max per level "
          f"{[round(float(e[-1]), 4) for e in grid.eigs]}, 19a's "
          f"{[round(float(e[-1]), 4) for e in hier.eigs]})")
    grid.load_state({"levels": [{"lmax": lv["lmax"]}
                                for lv in hier.data["levels"]]})
    reset(kb)
    _, rn_g = grid.solve(prob.b, num_cycles=10)
    u, niter = grid.solve_pcg(prob.b, rtol=1e-6, maxiter=50)
    torch.cuda.synchronize()
    path = dict(kb.LAUNCHES)
    rel = [v / r0 for v in rn_g]
    diff = traj_diff(rel, rel_ref)
    print(f"    10 cycles at 19a's lmax: rel {[f'{v:.4e}' for v in rel]}; "
          f"19a {[f'{v:.4e}' for v in rel_ref]}; max rel diff (cycles above "
          f"{REF_TRAJ_FROM:g}) {diff:.3e} (gate {GRID_TRAJ_RTOL:g})")
    if not diff <= GRID_TRAJ_RTOL:
        raise AssertionError(f"29a: trajectories differ by {diff:.3e}")
    du = float(torch.linalg.vector_norm(u - u_ref)
               / torch.linalg.vector_norm(u_ref))
    print(f"    FCG(V) iterations to rtol 1e-6: {niter} (19a {niter_ref}); "
          f"solution vs 19a's: rel diff {du:.3e} (gate 1e-3); launches "
          f"{ {k: v for k, v in path.items() if v} }")
    if abs(niter - niter_ref) > 1 or not du <= 1e-3 or not bool(
            torch.isfinite(u).all()):
        raise AssertionError(f"29a: FCG {niter} vs {niter_ref}, solutions "
                             f"{du:.3e}")
    add_launches(launches, path, ("t1_m", "t23_grid_m"))
    launches["t23_grid_m"] += path["t23_grid_res_m"]
    check_l2(card_l2(prob, u), "29a")
    grid_vcycle_parity(grid, hier, SEED + 29, "29a grid (2, 2, 2)")
    ks_shard_parity(grid, SEED + 30, "29a")
    bd = grid.to_dist(prob.b)
    ud = torch.zeros_like(bd)
    reset(kb)
    grid.apply(bd, ud)
    torch.cuda.synchronize()
    per_cycle = {k: v for k, v in kb.LAUNCHES.items() if v}
    vc, reps = grid_vcycle_ms(grid)
    wall, busy, nk, _, complete = kron_profile(lambda: grid.apply(bd, ud),
                                               "29a")
    print(f"    launches per V-cycle {per_cycle}; V-cycle {vc:.3f} ms ({VC_CYCLES} "
          f"back-to-back, 3 reps {[round(t, 3) for t in reps]}) vs 19a's "
          f"single device {vc_ref:.3f} ms and phase 14's uniform grid "
          + (f"{grid14_ms:.3f} ms" if grid14_ms is not None else "(not run)")
          + f"; busy {busy:.3f} ms, {nk} kernels, idle "
          f"{max(0.0, 1 - busy / vc):.1%} ({'complete' if complete else 'INCOMPLETE'}"
          " window)")
    return niter, vc


def ks_rhs(mesh, seed):
    """A seeded normal rhs on the card with ``mesh``'s Dirichlet rows
    zeroed (no host assembly: a new mesh's rhs would build its host
    geometry first)."""
    import torch

    bc = torch.tensor(mesh.boundary_dof_marker(6), device=DEV)
    return torch.where(bc, 0.0, seeded(mesh.num_dofs(6), seed))


def ks_fcg(hier, b, launches, need, maxiter=50):
    """FCG(V) to rtol 1e-6 on ``hier`` between a reset and a read of the
    launch counts: every kernel of ``need`` must launch (counted into
    ``launches``; #9's residual form folded into ``t23_grid_m``)."""
    import torch

    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb

    reset(kb)
    u, niter = hier.solve_pcg(b, rtol=1e-6, maxiter=maxiter)
    torch.cuda.synchronize()
    path = dict(kb.LAUNCHES)
    add_launches(launches, path, need)
    if "t23_grid_m" in need:
        launches["t23_grid_m"] += path["t23_grid_res_m"]
    if not bool(torch.isfinite(u).all()):
        raise AssertionError("FCG solution is not finite")
    return u, niter, {k: v for k, v in path.items() if v}


def ks_fcg_gate(tag, n, n_ref, slack=1):
    print(f"    {tag}: FCG(V) {n} vs {n_ref} (gate within {slack})")
    if abs(n - n_ref) > slack:
        raise AssertionError(f"{tag}: FCG {n} vs {n_ref}")


def kron_sharded_small(launches):
    """Phases 29b-29d at 2-3M dofs, p=(1,3,6), float32, kron_blocked, on
    seeded right-hand sides. 29b: `GridPMG` (2,2,2) on ``mixed_mesh(12)``
    with the distributed fdm coarse (``coarse_cfg=dict(dist=True)``)
    against the gathered fdm at its smoother bounds. 29c: `DistPMG` on 7
    slabs of ``BoxMesh(KS_SLAB_NC)`` with x graded 8:1 and a Robin x-high
    face, (i) ``coarse="fdm"`` and (ii) the gather-free hmg (``dist=True,
    bottom="fdm"``), each against the single-device hierarchy on the same
    mesh; #1-#3 on the stacked ``Ktx`` whose blocks differ against the
    per-slab plain versions. 29d: (2,2,2) + fdm on ``BoxMesh((12,) * 3)``
    with the diagonal tensor ``diag(ANISO_DIAG)`` and the per-axis
    ``KS_PER_AXIS`` against one device; `GridPMG.solve_refined` (29b's
    gathered grid) to an f64 relative residual of `KS_REFINED_RTOL`
    within 2 cycles of the single device's count. Gates: FCG within 1 (2
    for 29c (ii)), one seeded V-cycle within `GRID_VCYCLE_RTOL`. Returns
    {tag: (FCG or cycles, None)}."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh, geometric_spacing
    from pmg_dolfinx_tpu_torch.parallel.dist import DistPMG, slab_blocks
    from pmg_dolfinx_tpu_torch.parallel.grid2d import GridPMG
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    cfg = dict(degrees=(1, 3, 6), kappa=2.0, dtype=torch.float32,
               operator="kron_blocked", device=DEV)
    grid_need, slab_need = ("t1_m", "t23_grid_m"), ("t1_m", "t23_m",
                                                     "t23_res_m")
    out = {}

    t0 = phase(f"29b. GridPMG (2,2,2) kron_blocked on mixed_mesh("
               f"{KS_SMALL_NC}): coarse fdm with dist=True vs the gathered "
               "fdm")
    mesh = mixed_mesh(KS_SMALL_NC)
    b = ks_rhs(mesh, SEED + 31)
    gath = GridPMG(mesh, KS_SHARDS, coarse="fdm", **cfg)
    dist = GridPMG(mesh, KS_SHARDS, coarse="fdm",
                   coarse_cfg=dict(dist=True), **cfg)
    dist_vcycle_parity(gath, dist, SEED + 32, "29b dist fdm vs gathered",
                       rtol=GRID_VCYCLE_RTOL)
    _, n_g, _ = ks_fcg(gath, b, launches, grid_need)
    _, n_d, path = ks_fcg(dist, b, launches, grid_need)
    bd = dist.to_dist(b)
    with a2a_counts() as n_a2a:
        dist.apply(bd, torch.zeros_like(bd))
    print(f"    {mesh.num_dofs(6):,} dofs; launches {path}; {n_a2a[0]} "
          "all_to_all per V-cycle")
    ks_fcg_gate("29b dist fdm vs gathered", n_d, n_g)
    out["29b"] = (n_d, None)
    del dist
    done(t0)

    t0 = phase(f"29c. DistPMG {KS_SLABS} slabs kron_blocked on BoxMesh("
               f"{KS_SLAB_NC}), x graded 8:1, Robin x-high: (i) fdm, (ii) "
               "hmg dist=True bottom=fdm")
    slab_mesh = BoxMesh(KS_SLAB_NC, dirichlet_faces=KS_SLAB_FACES,
                        robin=KS_SLAB_ROBIN,
                        spacing=(geometric_spacing(KS_SLAB_NC[0],
                                                   GRADE_RATIO), None, None))
    b_slab = ks_rhs(slab_mesh, SEED + 33)
    for tag, kw, slack in (
            ("29c (i) fdm", dict(coarse="fdm"), 1),
            ("29c (ii) hmg dist bottom=fdm",
             dict(coarse="hmg", coarse_cfg=dict(dist=True, bottom="fdm")),
             2)):
        single = PMGHierarchy(slab_mesh, coarse=kw["coarse"], **cfg)
        slab = DistPMG(slab_mesh, n_devices=KS_SLABS, **kw, **cfg)
        grid_vcycle_parity(slab, single, SEED + 34, tag)
        _, n_s = single.solve_pcg(b_slab, rtol=1e-6, maxiter=100)
        _, n_d, path = ks_fcg(slab, b_slab, launches, slab_need,
                              maxiter=100)
        print(f"    {tag}: {slab_mesh.num_dofs(6):,} dofs; launches {path}")
        ks_fcg_gate(tag, n_d, n_s, slack)
        out[tag] = (n_d, None)
        if kw["coarse"] == "fdm":
            ktx = [m["Ktx"] for m in slab_blocks(
                slab.data["levels"][-1]["kb_mats"], KS_SLABS)]
            if any(torch.equal(ktx[0], k) for k in ktx[1:]):
                raise AssertionError("29c: slab 0 shares its Ktx block")
            slab_kernel_parity(slab)
        del single, slab
    done(t0)

    t0 = phase(f"29d. GridPMG (2,2,2) kron_blocked + fdm on BoxMesh(("
               f"{KS_SMALL_NC},)*3): diagonal-tensor and per-axis kappa; "
               f"solve_refined on 29b's mixed_mesh({KS_SMALL_NC})")
    box = BoxMesh((KS_SMALL_NC,) * 3)
    b_box = ks_rhs(box, SEED + 35)
    for tag, kappa in (("29d diag tensor", np.diag(ANISO_DIAG)),
                       ("29d per-axis", KS_PER_AXIS)):
        kw = dict(cfg, kappa=kappa, coarse="fdm")
        single = PMGHierarchy(box, **kw)
        grid = GridPMG(box, KS_SHARDS, **kw)
        grid_vcycle_parity(grid, single, SEED + 36, tag)
        _, n_s = single.solve_pcg(b_box, rtol=1e-6, maxiter=200)
        _, n_d, _ = ks_fcg(grid, b_box, launches, grid_need, maxiter=200)
        ks_fcg_gate(tag, n_d, n_s)
        out[tag] = (n_d, None)
        del single, grid
    r0 = float(torch.linalg.vector_norm(b))
    single = PMGHierarchy(mesh, coarse="fdm", **cfg)
    _, rn_s = single.solve_refined(b, num_cycles=KS_REFINED_MAX,
                                   rtol=KS_REFINED_RTOL)
    _, rn_g = gath.solve_refined(b, num_cycles=KS_REFINED_MAX,
                                 rtol=KS_REFINED_RTOL)
    print(f"    29d solve_refined: grid {len(rn_g)} cycles to f64 rel "
          f"{rn_g[-1] / r0:.3e}, single device {len(rn_s)} to "
          f"{rn_s[-1] / r0:.3e} (gate {KS_REFINED_RTOL:g}, counts within 2)")
    if not rn_g[-1] / r0 < KS_REFINED_RTOL or abs(len(rn_g) - len(rn_s)) > 2:
        raise AssertionError(f"29d refined: {len(rn_g)} cycles to "
                             f"{rn_g[-1] / r0:.3e} vs {len(rn_s)}")
    out["29d refined"] = (len(rn_g), None)
    done(t0)
    return out


def general_family(mesh, launches, vc_curved):
    """Phase 20 (lattice_blocked, K-A / K-B). 20a at `GENERAL_ANISO_NC`
    (614,125 dofs): ``--kappa-field aniso`` (`kappa_aniso`, 100:1 rotated 30
    degrees, folded into G), ``coarse="cg"``, FCG(V) to 1e-6 within 100,
    ms per V-cycle beside phase 7's curved cycle (``vc_curved``), K-A
    launches, L2 < 1e-4. 20b at `GENERAL_NC` (nc=21 until PR 17):
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
    t0 = phase(f"20a. general family: --kappa-field aniso (100:1 rotated 30 "
               f"degrees), nc={GENERAL_ANISO_NC[0]} (614,125 dofs), "
               "lattice_blocked + cg")
    K = pm.kappa_aniso()
    f = pm.f_rhs_tensor(K)
    reset(lb)
    ts = time.perf_counter()
    p21 = pm.PoissonProblem(mesh=BoxMesh(GENERAL_ANISO_NC), kappa=K, f=f,
                            coarse="cg", **cfg)
    torch.cuda.synchronize()
    print(f"    setup seconds: {time.perf_counter() - ts:.2f}")
    u, n21 = p21.hierarchy.solve_pcg(p21.b, rtol=1e-6, maxiter=100)
    torch.cuda.synchronize()
    path = dict(lb.LAUNCHES)
    if not n21 < 100 or not bool(torch.isfinite(u).all()):
        raise AssertionError(f"20a: FCG {n21}")
    add_launches(launches, path, ("lattice_apply",))
    vc, vc_all = vcycle_ms(p21.hierarchy)
    err = p21.error_l2(u)
    print(f"    FCG(V) iterations to rtol 1e-6: {n21}; launches {path}; "
          f"V-cycle {vc:.3f} ms ({VC_CYCLES} back-to-back, 3 reps "
          f"{[round(t, 3) for t in vc_all]}; phase 7's 16.2M curved cycle "
          f"{vc_curved:.3f} ms); L2 error {err:.4e}")
    if not err < 1e-4:
        raise AssertionError(f"20a: L2 error at nc=14 {err}")
    out["20a"] = (n21, vc)
    del p21, u
    done(t0)

    t0 = phase(f"20b. general family at nc={GENERAL_NC[0]}: kappa_linear + "
               "hmg, sigma_linear + cg; lattice_blocked vs plain lattice")
    mesh_b = BoxMesh(GENERAL_NC)
    for tag, kw in (
            ("kappa_linear + hmg", dict(kappa=pm.kappa_linear,
                                        f=pm.f_rhs_variable(), coarse="hmg")),
            ("sigma_linear + cg", dict(kappa=2.0, sigma=pm.sigma_linear,
                                       f=pm.f_rhs_sigma_field(2.0),
                                       coarse="cg"))):
        reset(lb)
        prob = pm.PoissonProblem(mesh=mesh_b, **kw, **cfg)
        u, niter = prob.hierarchy.solve_pcg(prob.b, rtol=1e-6, maxiter=50)
        torch.cuda.synchronize()
        path = dict(lb.LAUNCHES)
        err = prob.error_l2(u)
        plain = PMGHierarchy(mesh_b, **{k: v for k, v in kw.items()
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


LSHAPE_N = (15, 29)      # 2,244,151 and 16,016,875 dofs at p=6
LSHAPE_DEGREES = (1, 3, 6)


def lshape_spaces(n):
    """Host job (a worker thread started with the kernel build): JAX's
    ``l_shaped_hex_mesh(n)``, its geometric merge, DSS layout and boundary
    marker at p = 1, 3, 6 and the float64 geometry factors (kept on the
    mesh). Returns (mesh, {stage: host seconds})."""
    from pmg_dolfinx_tpu_torch.fem.assembly import geometry_factors_np
    from pmg_dolfinx_tpu_torch.fem.unstructured import l_shaped_hex_mesh

    secs = {}
    ts = time.perf_counter()
    mesh = l_shaped_hex_mesh(n)
    secs["mesh"] = time.perf_counter() - ts
    ts = time.perf_counter()
    for P in LSHAPE_DEGREES:
        mesh.dss_layout(P)
        mesh.boundary_dof_marker(P)
    secs["space and tables"] = time.perf_counter() - ts
    ts = time.perf_counter()
    for P in LSHAPE_DEGREES:
        geometry_factors_np(mesh, P)
    secs["geometry"] = time.perf_counter() - ts
    return mesh, secs


def dss_bound(lv, ndofs, itemsize=4):
    """Least ms of one DSS apply: the bytes it must move (G, x, y, the bc
    marker, the per-cell coefficient and the int64 gather and scatter
    tables, each once) over `HBM_BYTES_PER_S`; the einsums' f32
    operations (~(12 n + 30) per cell node) are far below 67 TFLOP/s."""
    tables = sum(v.numel() * v.element_size() for k, v in lv.items()
                 if k == "gather" or k.startswith("src_"))
    nbytes = (lv["G"].numel() * itemsize + 2 * ndofs * itemsize + ndofs
              + lv["coeff"].numel() * itemsize + tables)
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def dss_apply_phase(mesh, secs, tag):
    """Phase 22 at one mesh: the DSS apply (`ops.unstructured`, p=6,
    float32, kappa 2) against the port's ``dofmap`` apply on the card
    (within `KERNEL_RTOL`, relative max-norm); its ms (CUDA events, 20
    back-to-back, median of 3), GDOF/s, kernels per apply, the profiled
    busy split into gather, cells and scatter, and the bound."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import geometry_factors_np
    from pmg_dolfinx_tpu_torch.fem.gll import derivative_matrix
    from pmg_dolfinx_tpu_torch.ops import unstructured as us
    from pmg_dolfinx_tpu_torch.ops.laplacian import laplacian_apply

    P = 6
    nd = mesh.num_dofs(P)
    ts = time.perf_counter()
    layout = mesh.dss_layout(P)
    meta = us.dss_meta(layout)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda")
    lv = dict(us.dss_device_tables(layout, torch.float32, device="cuda"),
              G=f32(geometry_factors_np(mesh, P)[0]),
              coeff=torch.full((mesh.ncells,), 2.0, device="cuda"),
              D=f32(derivative_matrix(P)),
              bc_marker=torch.tensor(mesh.boundary_dof_marker(P),
                                     device="cuda"))
    torch.cuda.synchronize()
    secs = dict(secs, **{"device tables": time.perf_counter() - ts})
    print(f"    {tag}: {mesh}, p=6: {nd} dofs; host setup seconds "
          + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    x = torch.tensor(np.random.default_rng(SEED).standard_normal(
        nd, dtype=np.float32), device="cuda")
    apply = lambda: us.dss_laplacian_apply(x, lv, meta)
    dofmap = torch.tensor(mesh.dofmap(P), dtype=torch.int64, device="cuda")
    ref = laplacian_apply(x, dofmap, lv["G"], lv["coeff"], lv["D"],
                          lv["bc_marker"])
    err = check_rel(f"{tag} DSS apply vs the dofmap apply", apply(), ref)
    times = [cuda_ms(apply, reps=20, warmup=3) for _ in range(3)]
    ms = sorted(times)[1]
    dm_ms = cuda_ms(lambda: laplacian_apply(x, dofmap, lv["G"], lv["coeff"],
                                            lv["D"], lv["bc_marker"]))
    del dofmap, ref
    nk = kernels_per_call(apply)
    xb = torch.where(lv["bc_marker"], torch.zeros_like(x), x)
    u = us.dss_gather(xb, lv, meta)
    yc = us.apply_cells(u, lv["G"], lv["coeff"], lv["D"])
    split = {}
    for name, fn in (("gather", lambda: us.dss_gather(xb, lv, meta)),
                     ("cells", lambda: us.apply_cells(u, lv["G"], lv["coeff"],
                                                      lv["D"])),
                     ("scatter", lambda: us.dss_scatter(yc, lv, meta)),
                     ("apply", apply)):
        fn()
        # the profiler can leave a window's kernels out, never add one
        split[name] = max(profile_busy(fn)[1] for _ in range(3))
    bound, nbytes = dss_bound(lv, nd)
    parts = split["gather"] + split["cells"] + split["scatter"]
    print(f"    {tag} DSS apply: {ms:.4f} ms (20 back-to-back, 3 reps "
          f"{[round(t, 4) for t in times]}), {nd / ms / 1e6:.3f} GDOF/s; "
          f"{nk} kernels per apply; dofmap apply (index_add_) {dm_ms:.4f} "
          "ms")
    print(f"    {tag} DSS apply busy {split['apply']:.4f} ms (profiler): "
          + ", ".join(f"{k} {split[k]:.4f} ms ({split[k] / parts:.0%})"
                      for k in ("gather", "cells", "scatter"))
          + f"; bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB over 3.35 "
          f"TB/s): {bound / ms:.1%} of the bound's rate, "
          f"{ms / bound:.1f}x over it")
    del lv, x, xb, u, yc
    return dict(ms=ms, gdofs=nd / ms / 1e6, kernels=nk, bound_ms=bound,
                err=err, split=split, dofmap_ms=dm_ms)


DSS_SHARDS = 8
DSS_LMAX_RTOL = 1e-3        # 30a: calibrated lmax against 23a's, relative


def u_lshape(x):
    """The L-shape demo's manufactured solution (`examples/
    unstructured_torch.py`): zero on the whole boundary."""
    import numpy as np

    return np.sin(np.pi * x[0]) * np.sin(np.pi * x[1]) * np.sin(np.pi * x[2])


def dss_reference(hier, b, niter, vc, tag, profile=False):
    """What phase 30 holds `DSSDist` to, taken from a single-device ``dss``
    hierarchy before it is freed: its rhs, FCG count, per-level ``lmax``,
    ms per V-cycle, one V-cycle on a seeded rhs and iterate, the fine
    apply of a seeded vector and (``profile``) the busy ms, kernels and
    idle share of one V-cycle from a complete profiler window."""
    import types

    import torch

    n = hier.levels[-1].ndofs
    bs, us, xs = (seeded(n, SEED + k) for k in (41, 42, 43))
    ref = dict(b=b, niter=niter, vc=vc, seeds=(bs, us, xs),
               lmax=[lv["lmax"].clone() for lv in hier.data["levels"]],
               vcycle=hier.apply(bs, us), fine=hier.operator()(xs))
    if profile:
        b1 = torch.ones_like(b)
        hier.apply(b1, torch.zeros_like(b1))
        _, busy, nk, _, _, tries, complete = profile_complete(
            lambda: hier.apply(b1, torch.zeros_like(b1)),
            types.SimpleNamespace(LAUNCHES={}))
        ref["busy"] = (busy, nk, complete)
        window = "complete" if complete else "INCOMPLETE"
        print(f"    {tag} profiled V-cycle ({window} window, {tries} "
              f"tried): busy {busy:.3f} ms "
              f"({nk} kernels); idle {max(0.0, 1 - busy / vc):.1%} of the "
              f"back-to-back {vc:.3f} ms")
    return ref


@contextlib.contextmanager
def dss_exchanges():
    """Within the block, count `parallel.dss_dist.dss_exchange` calls (the
    cycle ops look the function up at each call): yields a one-item
    list."""
    from pmg_dolfinx_tpu_torch.parallel import dss_dist as dd

    n, fn = [0], dd.dss_exchange

    def counted(*a, **k):
        n[0] += 1
        return fn(*a, **k)

    dd.dss_exchange = counted
    try:
        yield n
    finally:
        dd.dss_exchange = fn


def dss_vcycle_at(dist, ref):
    """One `DSSDist` V-cycle on ``ref``'s seeded rhs and iterate at
    ``ref``'s smoother bounds, against ``ref``'s single-device V-cycle:
    relative max-norm (the dist's own bounds restored after)."""
    bs, us, _ = ref["seeds"]
    own = [lv["lmax"] for lv in dist.data["levels"]]
    dist.load_state({"levels": [{"lmax": v} for v in ref["lmax"]]})
    try:
        v = dist.from_dist(dist.apply(dist.to_dist(bs), dist.to_dist(us)))
    finally:
        for lv, lm in zip(dist.data["levels"], own):
            lv["lmax"] = lm
    return rel_max_err(v, ref["vcycle"])


def dss_dist_full(mesh, ref, ref_c, dss15):
    """Phase 30a: `DSSDist(mesh, 8, (1, 3, 6), 2.0, float32,
    coarse="direct")` on 23a's mesh and rhs, every shard on this card, then
    the same with ``smoother="schwarz"`` against 23c. Prints
    `DSSPartition`'s host seconds at p = 1, 3, 6 and the setup seconds.
    Gates: the fine apply of a seeded vector within `KERNEL_RTOL` of the
    single-device ``dss`` apply; every level's calibrated lmax within
    `DSS_LMAX_RTOL` of 23a's; FCG(V) to rtol 1e-6 within 1 of 23a's count;
    one V-cycle at 23a's bounds within `SCHWARZ_VCYCLE_RTOL` of 23a's
    (`vcycle_pair_parity`'s rule); L2 < 1e-4 (host thread, returned);
    Schwarz: FCG within 1 of 23c's, one V-cycle within the same gate.
    Prints ms per fine apply (20 back-to-back, median of 3) and kernels
    per apply beside phase 22's, ms per V-cycle beside 23a's, busy ms,
    kernels and idle share of a complete profiled V-cycle, exchanges per
    V-cycle. Returns ({tag: (FCG, ms per V-cycle)}, the L2 job)."""
    import types

    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import l2_error_collocated
    from pmg_dolfinx_tpu_torch.parallel.dss_dist import DSSDist, DSSPartition

    out = {}
    part = DSSPartition(mesh, DSS_SHARDS)
    secs = {}
    for P in LSHAPE_DEGREES:
        ts = time.perf_counter()
        t = part.tables(P)
        secs[P] = time.perf_counter() - ts
        print(f"    DSSPartition p={P}: {secs[P]:.2f} s host; {part.ncl} "
              f"cells a shard ({mesh.ncells} cells, "
              f"{part.ncl * DSS_SHARDS - mesh.ncells} dummy), {t['ndl']} "
              f"dofs a shard, {t['ndl'] * DSS_SHARDS:,} stacked for "
              f"{mesh.num_dofs(P):,}; {t['nshd']:,} shared dofs")
    cfg = dict(degrees=LSHAPE_DEGREES, kappa=2.0, dtype=torch.float32,
               coarse="direct", device=DEV)
    ts = time.perf_counter()
    dist = DSSDist(mesh, DSS_SHARDS, **cfg)
    torch.cuda.synchronize()
    print(f"    DSSDist setup {time.perf_counter() - ts:.2f} s (its own "
          "partition, device tables, geometry, diagonal, calibration, dense "
          f"Cholesky of {mesh.num_dofs(1):,} p=1 dofs)")
    lmax = [float(lv["lmax"]) for lv in dist.data["levels"]]
    lref = [float(v) for v in ref["lmax"]]
    dl = max(abs(a - r) / r for a, r in zip(lmax, lref))
    print(f"    calibrated lmax {lmax} vs 23a's {lref}: max rel diff {dl:.3e} "
          f"(gate {DSS_LMAX_RTOL:g})")
    if not dl <= DSS_LMAX_RTOL:
        raise AssertionError(f"30a: lmax {lmax} against 23a's {lref}")
    xs = ref["seeds"][2]
    fine = dist.operator()
    xd = dist.to_dist(xs)
    check_rel("30a stacked DSS apply vs the single-device dss apply",
              dist.from_dist(fine(xd)), ref["fine"])
    ts = time.perf_counter()
    u, niter = dist.solve_pcg(ref["b"], rtol=1e-6, maxiter=50)
    torch.cuda.synchronize()
    pcg = time.perf_counter() - ts
    print(f"    FCG(V) to rtol 1e-6: {niter} (23a: {ref['niter']}; "
          f"{pcg:.3f} s host clock)")
    if abs(niter - ref["niter"]) > 1 or not bool(torch.isfinite(u).all()):
        raise AssertionError(f"30a: FCG {niter} against 23a's {ref['niter']}")
    rank_twin(dist, ref["b"], "31b")     # phase 31b's reference
    l2_job = start_l2(l2_error_collocated, mesh, 6,
                      u.double().cpu().numpy(), u_lshape)
    err = dss_vcycle_at(dist, ref)
    print(f"    one V-cycle at 23a's lmax, seeded rhs and iterate, vs 23a: "
          f"rel max err {err:.3e} (gate {SCHWARZ_VCYCLE_RTOL:g})")
    if not err <= SCHWARZ_VCYCLE_RTOL:
        raise AssertionError(f"30a: V-cycle differs from 23a's by {err:.3e}")
    times = [cuda_ms(lambda: fine(xd), reps=20, warmup=3) for _ in range(3)]
    ms = sorted(times)[1]
    nk = kernels_per_call(lambda: fine(xd))
    with dss_exchanges() as n_apply:
        fine(xd)
    lvf = dist.data["levels"][-1]
    bound, nbytes = dss_bound(lvf, xd.numel())
    xbytes = sum(v.numel() * v.element_size() for k, v in lvf.items()
                 if k.startswith("x_"))
    bound += xbytes / HBM_BYTES_PER_S * 1e3
    print(f"    stacked DSS apply: {ms:.4f} ms (20 back-to-back, 3 reps "
          f"{[round(t, 4) for t in times]}), {mesh.num_dofs(6) / ms / 1e6:.3f}"
          f" GDOF/s; {nk} kernels per apply, {n_apply[0]} exchange; bound "
          f"{bound:.4f} ms ({(nbytes + xbytes) / 1e6:.1f} MB with the "
          f"exchange tables over 3.35 TB/s); phase 22's single-device "
          f"apply at n=15: {dss15['ms']:.4f} ms, {dss15['kernels']} "
          f"kernels, bound {dss15['bound_ms']:.4f} ms")
    vc, vc_all = slab_vcycle_ms(dist)
    bd = dist.to_dist(torch.ones(mesh.num_dofs(6), device=DEV))
    with dss_exchanges() as n_vc:
        dist.apply(bd, torch.zeros_like(bd))
    wall, busy, nkv, _, _, tries, complete = profile_complete(
        lambda: dist.apply(bd, torch.zeros_like(bd)),
        types.SimpleNamespace(LAUNCHES={}))
    b23 = ref["busy"]
    print(f"    V-cycle {vc:.3f} ms ({VC_CYCLES} back-to-back, 3 reps "
          f"{[round(t, 3) for t in vc_all]}) against 23a's {ref['vc']:.3f}; "
          f"{n_vc[0]} exchanges per V-cycle; profiled "
          f"({'complete' if complete else 'INCOMPLETE'} window, {tries} "
          f"tried) busy {busy:.3f} ms ({nkv} kernels), idle "
          f"{max(0.0, 1 - busy / vc):.1%}; 23a busy {b23[0]:.3f} ms "
          f"({b23[1]} kernels), idle {max(0.0, 1 - b23[0] / ref['vc']):.1%}")
    out["30a"] = (niter, vc)
    del dist, u, fine, xd, bd

    ts = time.perf_counter()
    dist = DSSDist(mesh, DSS_SHARDS, smoother="schwarz", **cfg)
    torch.cuda.synchronize()
    setup = time.perf_counter() - ts
    _, niter = dist.solve_pcg(ref_c["b"], rtol=1e-6, maxiter=50)
    err = dss_vcycle_at(dist, ref_c)
    vc, _ = slab_vcycle_ms(dist)
    print(f"    schwarz: setup {setup:.2f} s; FCG(V) {niter} (23c: "
          f"{ref_c['niter']}); one V-cycle at 23c's lmax vs 23c: rel max err "
          f"{err:.3e} (gate {SCHWARZ_VCYCLE_RTOL:g}); V-cycle {vc:.3f} ms "
          f"against 23c's {ref_c['vc']:.3f}")
    if abs(niter - ref_c["niter"]) > 1 or not err <= SCHWARZ_VCYCLE_RTOL:
        raise AssertionError(f"30a schwarz: FCG {niter} against "
                             f"{ref_c['niter']}, V-cycle {err:.3e}")
    out["30a schwarz"] = (niter, vc)
    del dist
    return out, l2_job


def dss_dist_small():
    """Phase 30b: ``l_shaped_hex_mesh(5)`` (375 cells over 8 shards: dummy
    cells), p=(1,3,6), float32, a seeded rhs; `DSSDist` with ``coarse="cg"``
    and with ``coarse="direct"``, sigma 0.8 and a DG-0 kappa, each against
    the single-device ``dss`` hierarchy: FCG(V) to rtol 1e-6 within 1, one
    V-cycle at the single device's bounds within `SCHWARZ_VCYCLE_RTOL`.
    Returns {tag: (FCG, None)}."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.unstructured import l_shaped_hex_mesh
    from pmg_dolfinx_tpu_torch.parallel.dss_dist import DSSDist
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    mesh = l_shaped_hex_mesh(5)
    nd = mesh.num_dofs(6)
    bc = torch.tensor(mesh.boundary_dof_marker(6), device=DEV)
    b = torch.where(bc, 0.0, seeded(nd, SEED + 44))
    out = {}
    for tag, kw in (("30b cg", dict(coarse="cg", kappa=2.0)),
                    ("30b direct sigma DG-0",
                     dict(coarse="direct", sigma=0.8,
                          kappa=np.linspace(1.0, 2.5, mesh.ncells)))):
        cfg = dict(degrees=LSHAPE_DEGREES, dtype=torch.float32, device=DEV,
                   **kw)
        single = PMGHierarchy(mesh, operator="dss", **cfg)
        dist = DSSDist(mesh, DSS_SHARDS, **cfg)
        _, n_s = single.solve_pcg(b, rtol=1e-6, maxiter=50)
        _, n_d = dist.solve_pcg(b, rtol=1e-6, maxiter=50)
        bs, us = seeded(nd, SEED + 45), seeded(nd, SEED + 46)
        ref = dict(seeds=(bs, us, None), vcycle=single.apply(bs, us),
                   lmax=[lv["lmax"] for lv in single.data["levels"]])
        err = dss_vcycle_at(dist, ref)
        print(f"    {tag}: {nd:,} dofs; FCG(V) {n_d} (single device {n_s}); "
              f"one V-cycle vs the single device: rel max err {err:.3e} "
              f"(gate {SCHWARZ_VCYCLE_RTOL:g})")
        if abs(n_d - n_s) > 1 or not err <= SCHWARZ_VCYCLE_RTOL:
            raise AssertionError(f"{tag}: FCG {n_d} vs {n_s}, V-cycle "
                                 f"{err:.3e}")
        out[tag] = (n_d, None)
    return out


def load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def unstructured_run(mod, argv, mesh):
    """``examples/unstructured_torch.py`` on ``argv`` (its output kept to
    a few lines) on ``mesh``; returns (out, hier, b, setup s, solve s)."""
    from pmg_dolfinx_tpu_torch.utils import timers

    timers._records.clear()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out, _, hier, b, _ = mod.run(argv, mesh=mesh)
    setup = timers._records["setup (dofmap merge + hierarchy + rhs)"][1]
    solve = timers._records["fcg solve"][1]
    return out, hier, b, setup, solve


def amg_levels(hier):
    """The AMG hierarchy's level sizes: p-coarse dofs, aggregates, inner
    levels, dense bottom."""
    amg = hier.data["amg"]
    return ([hier.levels[0].ndofs] + [lv["A"].shape[0] for lv in amg["inner"]]
            + [amg["chol"].shape[0]])


def unstructured_solves(mesh15, mesh29, dss15):
    """Phase 23 through `examples/unstructured_torch.py`'s code path,
    ``--demo-n N --degrees 1 3 6``, float32, FCG(V) to rtol 1e-6. a (n=15,
    ``--coarse direct``, cheb): FCG within 50, L2 < 1e-4, ms per V-cycle,
    one V-cycle on a seeded input within 1e-5 of the ``dofmap``
    hierarchy's at the same smoother bounds; b (``--coarse amg``): FCG
    within 2 of a's, the AMG levels and setup seconds; c (``--smoother
    schwarz``): FCG at or below a's, ms per V-cycle; d (n=29, ``--coarse
    amg``, 79,200 p=1 dofs): FCG within 50, L2 < 1e-4 (host thread), ms
    per V-cycle, idle share. Between c and d, phase 30 (`dss_dist_full`
    on a's and c's references, ``dss15`` phase 22's n=15 apply; then
    `dss_dist_small`). Returns {tag: (FCG, ms per V-cycle)} and the L2
    jobs of d and 30a."""
    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import l2_error_collocated
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    mod = load_example("unstructured_torch")
    common = ["--degrees", "1", "3", "6", "--rtol", "1e-6", "--device",
              "cuda"]
    out = {}
    t0 = phase("23a. unstructured solve: examples/unstructured_torch.py "
               "--demo-n 15 --degrees 1 3 6 (2,244,151 dofs), dss + "
               "direct, cheb")
    res, hier, b, setup, solve = unstructured_run(
        mod, ["--demo-n", "15", "--coarse", "direct"] + common, mesh15)
    vc, vc_all = vcycle_ms(hier)
    print(f"    setup seconds {setup:.2f} (rhs + hierarchy; {hier.levels[0].ndofs}"
          f" p=1 dofs); FCG(V) {res['niter']} ({solve:.3f} s); L2 "
          f"{res['l2_error']:.4e}; V-cycle {vc:.3f} ms ({VC_CYCLES} back-to-back, "
          f"3 reps {[round(t, 3) for t in vc_all]})")
    if not (res["niter"] < 50 and res["l2_error"] < 1e-4):
        raise AssertionError(f"23a: {res}")
    ref = PMGHierarchy(mesh15, degrees=LSHAPE_DEGREES, kappa=2.0,
                       dtype=torch.float32, coarse="direct",
                       operator="dofmap", device="cuda")
    ref.load_state({"levels": [{"lmax": lv["lmax"]}
                               for lv in hier.data["levels"]]})
    err = vcycle_pair_parity(hier, ref, SEED)
    vc_dm = vcycle_ms(ref)[0]
    print(f"    one V-cycle vs the dofmap hierarchy (its lmax the dss "
          f"one's): rel max err {err:.3e} (gate {SCHWARZ_VCYCLE_RTOL:g}); "
          f"dofmap V-cycle {vc_dm:.3f} ms")
    if not err <= SCHWARZ_VCYCLE_RTOL:
        raise AssertionError(f"23a: V-cycle differs from dofmap's: {err}")
    out["23a"] = (res["niter"], vc)
    del ref
    # Phase 30a's reference, kept past this hierarchy.
    ref30 = dss_reference(hier, b, res["niter"], vc, "23a", profile=True)
    del hier
    done(t0)

    t0 = phase("23b. the same with --coarse amg")
    res_b, hier, b, setup, solve = unstructured_run(
        mod, ["--demo-n", "15", "--coarse", "amg"] + common, mesh15)
    vc, vc_all = vcycle_ms(hier)
    print(f"    setup seconds {setup:.2f}; AMG levels {amg_levels(hier)} "
          f"(p=1 dofs, aggregates, ..., dense bottom), "
          f"{hier.coarse_cfg['cycles']} AMG cycles per coarse solve; FCG(V) "
          f"{res_b['niter']} (23a: {res['niter']}); L2 "
          f"{res_b['l2_error']:.4e}; V-cycle {vc:.3f} ms")
    if not (abs(res_b["niter"] - res["niter"]) <= 2
            and res_b["l2_error"] < 1e-4):
        raise AssertionError(f"23b: {res_b} against 23a's {res}")
    out["23b"] = (res_b["niter"], vc)
    del hier, b
    done(t0)

    t0 = phase("23c. the same with --smoother schwarz (schwarz_dss)")
    res_c, hier, b, setup, solve = unstructured_run(
        mod, ["--demo-n", "15", "--coarse", "direct", "--smoother",
              "schwarz"] + common, mesh15)
    vc, vc_all = vcycle_ms(hier)
    print(f"    setup seconds {setup:.2f}; FCG(V) {res_c['niter']} (23a: "
          f"{res['niter']}); L2 {res_c['l2_error']:.4e}; V-cycle {vc:.3f} "
          f"ms ({VC_CYCLES} back-to-back, 3 reps {[round(t, 3) for t in vc_all]})")
    if not (res_c["niter"] <= res["niter"] and res_c["l2_error"] < 1e-4):
        raise AssertionError(f"23c: {res_c} against 23a's {res}")
    out["23c"] = (res_c["niter"], vc)
    ref30c = dss_reference(hier, b, res_c["niter"], vc, "23c")
    del hier, b
    done(t0)

    t0 = phase("30a. DSSDist on l_shaped_hex_mesh(15) (2,244,151 dofs), 8 "
               "shards stacked on this card, p=(1,3,6), direct, cheb and "
               "schwarz, against 23a and 23c")
    dist_out, l2_30a = dss_dist_full(mesh15, ref30, ref30c, dss15)
    out.update(dist_out)
    del ref30, ref30c
    done(t0)

    t0 = phase("30b. DSSDist on l_shaped_hex_mesh(5) (375 cells over 8 "
               "shards), f32, seeded rhs: cg; direct with sigma 0.8 and a "
               "DG-0 kappa; against the single-device dss hierarchy")
    out.update(dss_dist_small())
    done(t0)

    t0 = phase("23d. examples/unstructured_torch.py --demo-n 29 --degrees 1 "
               "3 6 --coarse amg (16,016,875 dofs, 79,200 p=1 dofs)")
    args = mod.parse(["--demo-n", "29", "--coarse", "amg"] + common)
    ts = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        _, u_exact, b, hier = mod.build(args, mesh29)
    b = torch.as_tensor(b, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - ts
    ts = time.perf_counter()
    u, niter = hier.solve_pcg(b, rtol=1e-6, maxiter=50)
    torch.cuda.synchronize()
    solve = time.perf_counter() - ts
    if not niter < 50 or not bool(torch.isfinite(u).all()):
        raise AssertionError(f"23d: FCG {niter}")
    l2_job = start_l2(l2_error_collocated, mesh29, 6,
                      u.double().cpu().numpy(), u_exact)
    vc, vc_all = vcycle_ms(hier)
    b1 = torch.ones_like(b)
    hier.apply(b1, torch.zeros_like(b1))
    _, busy, nk, by_name = profile_busy(
        lambda: hier.apply(b1, torch.zeros_like(b1)))
    print(f"    setup seconds {setup:.2f} (rhs + hierarchy); AMG levels "
          f"{amg_levels(hier)}; FCG(V) {niter} ({solve:.3f} s host clock); "
          f"V-cycle {vc:.3f} ms ({VC_CYCLES} back-to-back, 3 reps "
          f"{[round(t, 3) for t in vc_all]}); profiled busy {busy:.3f} ms "
          f"({nk} kernels): idle {max(0.0, 1 - busy / vc):.1%}; peak host "
          f"RSS {peak_rss_gb():.1f} GB; the L2 error runs on a host thread")
    print("    busy V-cycle by kernel (top 6): " + "; ".join(
        f"{ms:.3f} ms {name[:50]}" for name, ms in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:6]))
    out["23d"] = (niter, vc)
    del hier, b, u, b1
    done(t0)
    return out, l2_job, l2_30a


def flagship_amg(prob, niter_ref, vc_ref, cfg, launches):
    """Phase 24a: the flagship (phase 4's mesh and rhs, 16,194,277 dofs,
    p=(1,3,6), ``kron_blocked``) with ``coarse="amg"``: FCG(V) within 2 of
    phase 4's ``fdm`` count, ms per V-cycle beside phase 4's; #1-#3 carry
    the p-levels and the AMG's matrix-free level 0 (43^3, band 1) and
    must launch. Returns (FCG, ms per V-cycle)."""
    import torch

    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    reset(kb)
    ts = time.perf_counter()
    hier = PMGHierarchy(prob.mesh, operator="kron_blocked",
                        **dict(cfg, coarse="amg"))
    torch.cuda.synchronize()
    setup = time.perf_counter() - ts
    u, niter = hier.solve_pcg(prob.b, rtol=1e-6, maxiter=50)
    torch.cuda.synchronize()
    path = dict(kb.LAUNCHES)
    print(f"    setup seconds {setup:.2f} (no rhs); AMG levels "
          f"{amg_levels(hier)}; FCG(V) iterations to rtol 1e-6: {niter} "
          f"(phase 4, fdm: {niter_ref}); launches {path}")
    if not (abs(niter - niter_ref) <= 2 and bool(torch.isfinite(u).all())):
        raise AssertionError(f"24a: FCG {niter} against {niter_ref}")
    add_launches(launches, path, ("t1_m", "t23_m", "t23_res_m"))
    vc, vc_all = vcycle_ms(hier)
    print(f"    V-cycle {vc:.3f} ms ({VC_CYCLES} back-to-back, 3 reps "
          f"{[round(t, 3) for t in vc_all]}); phase 4's (fdm coarse) "
          f"{vc_ref:.3f} ms")
    del hier, u
    return niter, vc


def csr_small():
    """Phase 24b: ``operator="csr"`` (cuSPARSE matvecs) on
    ``l_shaped_hex_mesh(4)``, p=(1,3), float32, direct coarse, against
    the ``dss`` hierarchy: FCG(V) to 1e-6 within one, one V-cycle on a
    seeded input within 1e-5 at the dss hierarchy's smoother bounds."""
    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu_torch.fem.unstructured import l_shaped_hex_mesh
    from pmg_dolfinx_tpu_torch.models.poisson import f_rhs
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    mesh = l_shaped_hex_mesh(4)
    b = torch.tensor(assemble_rhs(mesh, 3, f_rhs(2.0)), dtype=torch.float32,
                     device="cuda")
    hs, its = {}, {}
    for op in ("dss", "csr"):
        hs[op] = PMGHierarchy(mesh, degrees=(1, 3), kappa=2.0,
                              dtype=torch.float32, coarse="direct",
                              operator=op, device="cuda")
        _, its[op] = hs[op].solve_pcg(b, rtol=1e-6)
    hs["csr"].load_state({"levels": [{"lmax": lv["lmax"]}
                                     for lv in hs["dss"].data["levels"]]})
    err = vcycle_pair_parity(hs["csr"], hs["dss"], SEED)
    print(f"    {mesh}, {mesh.num_dofs(3)} dofs: FCG(V) csr {its['csr']}, "
          f"dss {its['dss']}; one V-cycle csr vs dss: rel max err "
          f"{err:.3e} (gate {SCHWARZ_VCYCLE_RTOL:g}); V-cycle csr "
          f"{vcycle_ms(hs['csr'])[0]:.3f} ms, dss "
          f"{vcycle_ms(hs['dss'])[0]:.3f} ms")
    if not (abs(its["csr"] - its["dss"]) <= 1
            and err <= SCHWARZ_VCYCLE_RTOL):
        raise AssertionError(f"24b: FCG {its}, V-cycle {err}")


# --- phases 25a-25f: the transient and extra model families (no new kernel)

NEWTON_MAXSTEPS = 8   # 25a gate: Newton steps
SMALL_NC = (21, 21, 21)   # 25b's in-card reference and 25e: 2,048,383 dofs
IMEX_NC = (42, 42, 42)    # 25d at p=3: 2,048,383 dofs
IMEX_RTOL = 1e-4      # 25b-25e gates: f32 against the f64 run, rel max-norm
# 25a: the f32 Newton solutions against the f64 ones, rel max-norm. The f32
# solves stop at 10x the f32 floor; cubic and Bratu measured 1.68e-4 and
# 1.92e-4 (NVIDIA H100 80GB HBM3, 700 W); an operator fault shows as O(1).
NEWTON_F64_RTOL = 1e-3
# 25b: f32 against f64 within this factor of the f32 operator's own floor,
# predicted in f64 as A^-1 (A32 u64 - b). Measured / predicted on the CPU
# at p=6: 0.96-1.02 at nc=6-12, 1.57 at nc=4 (15,625 dofs, where the
# solve's other f32 rounding is as large as the operator's).
CONV_FLOOR_FACTOR = 2.0
SEMI_C = 5.0          # cubic(5), the driver's default
BRATU_LAM = 5.0


def rel_l2(got, ref):
    import torch

    return float(torch.linalg.vector_norm(got - ref)
                 / torch.linalg.vector_norm(ref))


def f_norm(hier, u, b, nl):
    """``|A u + m3 N(u) - b|`` with ``hier``'s fine operator (its dtype and
    backend): the Newton residual of `solvers.newton`, on flat vectors."""
    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import lumped_mass_np

    lv, fine = hier.data["levels"][-1], hier.levels[-1]
    m3 = hier._to_work(lumped_mass_np(hier.mesh, fine.P, bc_zero=True))
    uw, bw = hier._to_work(u), hier._to_work(b)
    F = hier._ops["apply"](lv, uw, fine) + m3 * nl.N(uw) - bw
    return float(torch.sqrt(hier._ops["dot"](F, F, lv)))


def newton_f32(hier, b, nl, rtol, tag, atol=0.0):
    """`newton_solve` on ``hier`` with its wall time: (u, info, ms per
    Newton step). Raises unless it converges within NEWTON_MAXSTEPS."""
    import torch

    from pmg_dolfinx_tpu_torch.solvers.newton import newton_solve

    from pmg_dolfinx_tpu_torch.fem.assembly import lumped_mass_np

    # newton_solve forms the lumped mass on the host on every call, as
    # the JAX package does; timed alone here, and left out of ms per step.
    ts = time.perf_counter()
    lumped_mass_np(hier.mesh, hier.levels[-1].P, bc_zero=True)
    host = (time.perf_counter() - ts) * 1e3
    torch.cuda.synchronize()
    ts = time.perf_counter()
    u, info = newton_solve(hier, b, nl, rtol=rtol, atol=atol)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - ts) * 1e3
    per = (wall - host) / max(info["niter"], 1)
    print(f"    {tag}: {info['niter']} Newton steps, converged "
          f"{info['converged']}, |F|/|F0| "
          f"{[f'{f / info['fnorms'][0]:.3e}' for f in info['fnorms']]}, FCG "
          f"per step {info['lin_iters']}; {wall:.1f} ms, of which the host "
          f"lumped mass {host:.1f} ms: {per:.2f} ms per Newton step")
    if not (info["converged"] and info["niter"] <= NEWTON_MAXSTEPS
            and bool(torch.isfinite(u).all())):
        raise AssertionError(f"{tag}: Newton did not converge within "
                             f"{NEWTON_MAXSTEPS}: {info}")
    return u, info, per


def newton_flagship(prob, cfg, launches, keep=None):
    """Phase 25a: `newton_solve` on phase 4's flagship hierarchy (16.2M
    dofs, p=(1,3,6), ``kron_blocked`` + ``fdm``, f32), cubic(5) with its
    manufactured source and Bratu(5) with f = 0. First the f32 operator's
    floor: ``|F|`` at the f64 solution (Newton on a plain ``kron`` f64
    hierarchy, rtol 1e-10), evaluated with the f32 operator, over ``|F0|``;
    the f32 runs take rtol = 10 x that floor. Gates: Newton within
    NEWTON_MAXSTEPS, the cubic's collocated L2 error < 1e-4, #1-#3 launch.
    Returns {tag: (Newton steps, ms per Newton step)}; ``keep`` (a dict)
    gets the cubic's (f64 solution, f32 rtol, rhs) for phase 26c."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import (assemble_rhs,
                                                    l2_error_collocated)
    from pmg_dolfinx_tpu_torch.models import semilinear
    from pmg_dolfinx_tpu_torch.models.poisson import u_exact
    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.solvers.newton import newton_solve
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    hier, mesh, P = prob.hierarchy, prob.mesh, 6
    ts = time.perf_counter()
    cubic = semilinear.cubic(SEMI_C)
    cases = {"cubic": (cubic, assemble_rhs(mesh, P, semilinear.f_rhs_semilinear(
        2.0, cubic))), "bratu": (semilinear.bratu(BRATU_LAM),
                                 np.zeros(mesh.num_dofs(P)))}
    print(f"    rhs assembly {time.perf_counter() - ts:.2f} s (host)")
    ts = time.perf_counter()
    h64 = PMGHierarchy(mesh, operator="kron", **dict(cfg,
                                                     dtype=torch.float64))
    torch.cuda.synchronize()
    print(f"    f64 plain kron hierarchy setup {time.perf_counter() - ts:.2f} "
          "s")
    out, rtols, refs = {}, {}, {}
    for tag, (nl, b) in cases.items():
        ts = time.perf_counter()
        u64, i64 = newton_solve(h64, b, nl, rtol=1e-10)
        f0 = i64["fnorms"][0]
        floor = f_norm(hier, u64, b, nl) / f0
        rtols[tag] = 10.0 * floor
        refs[tag] = u64
        print(f"    {tag}: f64 Newton {i64['niter']} steps (FCG "
              f"{i64['lin_iters']}, {time.perf_counter() - ts:.2f} s), "
              f"|F64|/|F0| {i64['fnorms'][-1] / f0:.3e}; f32 operator at the "
              f"f64 solution: |F32|/|F0| = {floor:.3e} (the floor); rtol "
              f"{rtols[tag]:.3e}")
    del h64
    if keep is not None:
        keep["cubic"] = (refs["cubic"], rtols["cubic"], cases["cubic"][1])
    reset(kb)
    for tag, (nl, b) in cases.items():
        u, info, per = newton_f32(hier, b, nl, rtols[tag], f"{tag} f32")
        du = rel_max_err(u.double(), refs[tag])
        print(f"      against the f64 solution: rel max diff {du:.3e} (gate "
              f"{NEWTON_F64_RTOL:g})")
        if not du <= NEWTON_F64_RTOL:
            raise AssertionError(f"25a {tag}: {du} from the f64 solution")
        if tag == "cubic":
            err = l2_error_collocated(mesh, P, u.double().cpu().numpy(),
                                      u_exact)
            print(f"      collocated L2 error vs the manufactured solution "
                  f"{err:.4e} (gate 1e-4)")
            if not err < 1e-4:
                raise AssertionError(f"25a: L2 error {err}")
        out[f"25a {tag}"] = (info["niter"], per)
    path = dict(kb.LAUNCHES)
    print(f"    launches in the f32 Newton runs: {path}")
    add_launches(launches, path, ("t1_m", "t23_m", "t23_res_m"))
    return out


def convdiff_phase(mesh42, launches, keep=None):
    """Phase 25b: `convdiff_solve` (BiCGStab, V-cycle of the symmetric
    part) on a plain ``kron`` hierarchy (f32, p=(1,3,6), fdm coarse) on
    phase 4's mesh, the driver's velocity (3,-1.5,0.8) and kappa 2, rtol
    1e-6, beside the f64 solve (rtol 1e-10); at nc=21 the f32 solve (rtol
    1e-8, below its floor) against the f64 one within IMEX_RTOL; at both
    sizes `conv_floor_gate`; the streamline-diagonal case at cell Pe 21
    (the JAX README's: 6^3 cells, p=(1,3), f64, 'p' and 'cell' scales).
    Returns {tag: (BiCGStab iterations, ms per iteration)}; ``keep`` (a
    dict) gets nc=21's (f64 solution, predicted f32 solution) for 26c."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import (assemble_rhs,
                                                    l2_error_collocated)
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import u_exact
    from pmg_dolfinx_tpu_torch.solvers.convdiff import (convdiff_solve,
                                                        sd_stabilized_kappa)
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    cvel, out = (3.0, -1.5, 0.8), {}

    def solve(mesh, degrees, kappa, cv, dtype, rtol, tag, kappa_src=2.0,
              b=None):
        # The source is the physical problem's (kappa_src); the hierarchy
        # may carry a stabilized kappa, as in the driver. ``b``: the rhs
        # an earlier solve on the mesh assembled (host numpy, float64).
        ts = time.perf_counter()
        hier = PMGHierarchy(mesh, degrees=degrees, kappa=kappa, dtype=dtype,
                            coarse="fdm", operator="kron", device="cuda")
        if b is None:
            b = assemble_rhs(mesh, degrees[-1], conv_source(kappa_src, cv))
        torch.cuda.synchronize()
        setup = time.perf_counter() - ts
        ts = time.perf_counter()
        u, info = convdiff_solve(hier, b, cv, rtol=rtol, maxiter=200)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - ts) * 1e3
        per = wall / max(info["niter"], 1)
        pe = float(np.linalg.norm(cv)) / mesh.nc[0] / (2.0 * kappa_src)
        print(f"    {tag}: {mesh.num_dofs(degrees[-1])} dofs, cell Pe "
              f"{pe:.3f}; {info['niter']} BiCGStab iterations, rel resid "
              f"{info['rel_resid']:.2e}; {wall:.1f} ms = {per:.3f} ms per "
              f"iteration (setup and rhs {setup:.2f} s)")
        if not (info["rel_resid"] <= rtol and info["niter"] < 200
                and bool(torch.isfinite(u).all())):
            raise AssertionError(f"25b {tag}: {info}")
        out[f"25b {tag}"] = (info["niter"], per)
        return u, hier, b

    def pair(mesh, rtol32, tag):
        u32, h32, b = solve(mesh, (1, 3, 6), 2.0, cvel, torch.float32,
                            rtol32, f"{tag} f32")
        u64, h64, _ = solve(mesh, (1, 3, 6), 2.0, cvel, torch.float64,
                            1e-10, f"{tag} f64", b=b)
        d = rel_max_err(u32.double(), u64)
        u_pred = conv_floor_gate(h32, h64, b, cvel, u32, u64, tag)
        return u32, u64, u_pred, d

    u32, u64, u_pred, _ = pair(mesh42, 1e-8, "16.2M")
    errs = [l2_error_collocated(mesh42, 6, v.double().cpu().numpy(), u_exact)
            for v in (u32, u64, u_pred)]
    print(f"      collocated L2 error vs the manufactured solution: f32 "
          f"{errs[0]:.4e}, f64 {errs[1]:.4e}, the predicted f32 floor "
          f"{errs[2]:.4e} (gate {CONV_FLOOR_FACTOR:g} x the floor)")
    if not errs[0] <= CONV_FLOOR_FACTOR * errs[2]:
        raise AssertionError(f"25b 16.2M: L2 errors {errs}")
    del u32, u64, u_pred
    u32, u64, u_pred, d = pair(BoxMesh(SMALL_NC), 1e-8, "nc=21")
    if keep is not None:
        keep["nc21"] = (u64, u_pred)
    print(f"      nc=21: f32 against f64, rel max diff {d:.3e} (gate "
          f"{IMEX_RTOL:g}), rel 2-norm diff {rel_l2(u32.double(), u64):.3e}")
    if not d <= IMEX_RTOL:
        raise AssertionError(f"25b: f32 and f64 solutions differ: {d}")
    # Streamline-diagonal stabilization at cell Pe 21: the JAX README's
    # case (6^3 cells, p=3, f64, kappa 0.004, c = (1, 0.4, 0.2)).
    mesh6, kappa_sd, cv_sd = BoxMesh((6, 6, 6)), 0.004, (1.0, 0.4, 0.2)
    for h_eff in ("p", "cell"):
        keff, taus = sd_stabilized_kappa(mesh6, 3, cv_sd, kappa_sd,
                                         h_eff=h_eff)
        print(f"    SD '{h_eff}': kappa {kappa_sd:g} -> "
              f"{tuple(round(float(k), 6) for k in keff)}")
        solve(mesh6, (1, 3), keff, cv_sd, torch.float64, 1e-9,
              f"SD '{h_eff}' Pe 21 f64", kappa_src=kappa_sd)
    return out


def convdiff_apply(hier, cvel, x):
    """The convection-diffusion operator of `solvers.convdiff` (the fine
    ``kron`` apply plus the advection terms, Dirichlet rows ``x``) in
    ``hier``'s dtype, on flat vectors."""
    import torch

    from pmg_dolfinx_tpu_torch.ops.kron import (axis_advection,
                                                kron_advection_terms)

    lv, fine = hier.data["levels"][-1], hier.levels[-1]
    Cs = tuple(torch.tensor(axis_advection(hier.mesh.nc[a], fine.P),
                            dtype=hier.dtype, device="cuda")
               for a in range(3))
    xw = hier._to_work(x)
    w = torch.where(lv["bc_marker"], torch.zeros_like(xw), xw)
    adv = kron_advection_terms(
        w, Cs, (lv["mx"], lv["my"], lv["mz"]),
        torch.tensor(cvel, dtype=hier.dtype, device="cuda"))
    y = hier._ops["apply"](lv, xw, fine) + adv
    return torch.where(lv["bc_marker"], xw, y).reshape(-1)


def conv_floor_gate(h32, h64, b, cvel, u32, u64, tag):
    """The f32 floor of the convection-diffusion solve, predicted in f64:
    the f32 solution satisfies ``A32 u32 = b``, so to first order ``u32 -
    u64 = -A^-1 (A32 u64 - b)``, one f64 solve of the f32 operator's
    residual at ``u64``. Gate: ``|u32 - u64|_max`` within
    CONV_FLOOR_FACTOR of the prediction's (a fault beyond f32 rounding,
    in the operator, the V-cycle or BiCGStab, shows above it). Returns
    the predicted f32 solution ``u64 - e``."""
    import torch

    from pmg_dolfinx_tpu_torch.solvers.convdiff import convdiff_solve

    bt = torch.as_tensor(b, dtype=torch.float64, device="cuda")
    r = convdiff_apply(h32, cvel, u64.float()).double() - bt
    e, _ = convdiff_solve(h64, r, cvel, rtol=1e-10, maxiter=200)
    pred = float(e.abs().max() / u64.abs().max())
    d = rel_max_err(u32.double(), u64)
    rb = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(bt))
    print(f"      {tag}: f32 operator at the f64 solution |A32 u64 - b| / |b| "
          f"{rb:.3e}; "
          f"predicted f32 floor (rel max) {pred:.3e}, measured f32 vs f64 "
          f"{d:.3e}: ratio {d / pred:.3f} (gate {CONV_FLOOR_FACTOR:g})")
    if not d <= CONV_FLOOR_FACTOR * pred:
        raise AssertionError(f"25b {tag}: f32 vs f64 {d}, above "
                             f"{CONV_FLOOR_FACTOR} x the f32 floor {pred}")
    return u64 - e


def conv_source(kappa, cvel):
    """The convdiff driver's manufactured source for ``u_e = sin sin sin``:
    ``-kappa lap u_e + c . grad u_e``."""
    import numpy as np

    pi = np.pi

    def f(x):
        sx, sy, sz = (np.sin(pi * x[a]) for a in range(3))
        cx, cy, cz = (np.cos(pi * x[a]) for a in range(3))
        g = (pi * cx * sy * sz, pi * sx * cy * sz, pi * sx * sy * cz)
        return (3.0 * pi**2 * kappa * sx * sy * sz
                + sum(c_ * g_ for c_, g_ in zip(cvel, g)))

    return f


def serving_window(fn, kp, tries=4):
    """`profile_busy` of ``fn`` (serving steps) from a complete window: the
    packed FDM's kernels in the window number 3 per counted call and the
    kernel count repeats an earlier window's. Returns (wall, busy, kernels,
    complete)."""
    seen, last = [], None
    for _ in range(tries):
        before = kp.LAUNCHES["packed_fdm"]
        calls = {}
        wall, busy, nk, _ = profile_busy(fn, calls)
        n = kp.LAUNCHES["packed_fdm"] - before
        fdm = sum(c for k, c in calls.items() if "fdm_" in k)
        complete = fdm == 3 * n and nk in seen
        seen.append(nk)
        last = (wall, busy, nk, complete)
        if complete:
            break
    return last


SEMI_STEPS = 200
SEMI_CONFIGS = (("cubic", "cnab", 1), ("cubic", "cnab", 8),
                ("cubic", "be", 1), ("cubic", "be", 8),
                ("bratu", "cnab", 8))


# 25f: the driver's box run (modes_torch.py argv), its general family at
# the driver's defaults (``lattice`` + ``cg``, default tol) on a small mesh,
# and the general family at ~4k dofs; gates on |K u - lam M u| / |lam M u|.
MODES_BOX = ["--ndofs", "100000", "--kmodes", "6", "--neumann", "x",
             "--sigma", "5"]
MODES_BOX_RES = 1e-7
# The driver's hierarchy and tol, k=1: its default k=4 took 85.13 s here
# (21 iterations; NVIDIA H100 80GB HBM3, 700 W), k=1 15 on the CPU. ~400
# dofs: every V-cycle ends on the coarse CG's host reads, as many as the
# coarse problem's free dofs allow, so the seconds follow the size (at
# 1,000 dofs 23.2 s: 62 solves, 5.4 coarse CG iterations a V-cycle).
MODES_DRIVER_GENERAL = ["--mesh", "perturbed", "--ndofs", "400",
                        "--kmodes", "1"]
# ~4k dofs: host-paced FCG(V) solves (at 29,920 dofs 25f took 64-83 s of
# the time limit; at ~10k 50 solves of ~16 iterations).
MODES_GENERAL_NDOFS = 4000
# k=1 on a ``direct`` coarse: at 30k with the driver's ``cg`` coarse every
# V-cycle is host-paced by the coarse CG's per-iteration reads (k=4, tol
# 1e-13: 638.2 s for 16 iterations on the card), which the script's time
# limit cannot hold. One vector meets LOBPCG's stopping test sooner: at
# tol 1e-13 its residual was 1.5e-6 (k=4: 9.3e-7), so tol 1e-14.
MODES_GENERAL_K = 1
MODES_GENERAL_TOL = 1e-14
MODES_GENERAL_RES = 1e-6


def semilinear_serving(launches):
    """Phase 25c: `semilinear_packed_evolve` at 61^3, p=6 (226,981 dofs),
    kappa 2, dt 1e-3, 200 steps: cubic(5) with its manufactured source
    (columns ``a_j u_e``, a_j in [0.25, 1.5]), CNAB and BE at B=1 (#21)
    and B=8 (#19), and Bratu(5) at B=8 from zero. Gate: each column within
    IMEX_RTOL of `semilinear_fdm_evolve` in f64 on the same column.
    Steps/s over 3 reps, busy ms per step and the idle share from a
    complete profiler window, the launches of #19 / #21. Returns {tag:
    (steps/s, ms per step)}."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.models import semilinear
    from pmg_dolfinx_tpu_torch.ops import kron_packed as kp
    from pmg_dolfinx_tpu_torch.solvers.transient import (
        semilinear_fdm_evolve, semilinear_packed_evolve)

    P, kappa, dt = PACKED_P, 2.0, 1e-3
    mesh = BoxMesh(PACKED_NC)
    n = mesh.num_dofs(P)
    c = mesh.dof_coords(P)
    ue = np.where(mesh.boundary_dof_marker(P), 0.0,
                  np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
                  * np.sin(np.pi * c[:, 2]))
    nls = {"cubic": semilinear.cubic(SEMI_C),
           "bratu": semilinear.bratu(BRATU_LAM)}
    f_cubic = assemble_rhs(mesh, P, semilinear.f_rhs_semilinear(
        kappa, nls["cubic"]))
    out = {}
    for model, scheme, B in SEMI_CONFIGS:
        nl = nls[model]
        f = f_cubic if model == "cubic" else None
        amps = np.linspace(0.25, 1.5, B) if model == "cubic" else np.zeros(B)
        U0 = torch.tensor(amps[:, None] * ue[None, :], dtype=torch.float32,
                          device="cuda")
        tag = f"{model} {scheme} B={B}"
        reset(kp)
        ev = semilinear_packed_evolve(mesh, P, nl, kappa=kappa, dt=dt, B=B,
                                      scheme=scheme, f=f, device="cuda")
        UT = ev(U0, SEMI_STEPS)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            UT = ev(U0, SEMI_STEPS)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - ts)
        wall, busy, nk, complete = serving_window(lambda: ev(U0, 100), kp)
        path = dict(kp.LAUNCHES)
        rates = sorted(SEMI_STEPS / w for w in walls)
        if tuple(UT.shape) != (B, n) or not bool(torch.isfinite(UT).all()):
            raise AssertionError(f"25c {tag}: the state is not finite "
                                 "(B, ndofs)")
        if not path["packed_fdm"] > 0:
            raise AssertionError(f"25c {tag}: packed_fdm was not launched")
        launches["packed_fdm"] += path["packed_fdm"]
        ref_ev = semilinear_fdm_evolve(mesh, P, nl, kappa=kappa, dt=dt,
                                       scheme=scheme, f=f,
                                       dtype=torch.float64, device="cuda")
        refs = [ref_ev(U0[j].double(), SEMI_STEPS).reshape(-1)
                for j in range(B)]
        d = max(rel_max_err(UT[j].double(), refs[j]) for j in range(B))
        d2 = max(rel_l2(UT[j].double(), refs[j]) for j in range(B))
        reps = [round(r, 1) for r in rates]
        print(f"    {tag}: {rates[1]:.1f} steps/s (3 reps {reps}; "
              f"{rates[1] * B:.1f} column-steps/s); profiled 100 steps "
              f"({'complete' if complete else 'INCOMPLETE'} window): wall "
              f"{wall / 100:.4f} ms/step, busy {busy / 100:.4f} ms/step "
              f"({nk / 100:.0f} kernels/step), idle "
              f"{max(0.0, 1 - busy / wall):.1%}; launches {path}; worst "
              f"column vs f64 semilinear_fdm_evolve: rel max {d:.3e} "
              f"(gate {IMEX_RTOL:g}), rel 2-norm {d2:.3e}")
        if not d <= IMEX_RTOL:
            raise AssertionError(f"25c {tag}: {d} from the f64 run")
        out[f"25c {tag}"] = (rates[1], 1e3 / rates[1])
    return out


def imex_2m():
    """Phase 25d: `semilinear_fdm_evolve` (cubic(5), source, dt 1e-4) and
    `convdiff_fdm_evolve` (velocity (3,-1.5,0.8), source, dt a quarter of
    `convdiff_advective_dt`), CNAB, f32, on ``BoxMesh((42,42,42))`` at p=3
    (2,048,383 dofs, the ``heat_cn_2M`` size), 200 steps from zero: within
    IMEX_RTOL of the f64 run; steps/s over 3 reps. Returns {tag: (steps/s,
    ms per step)}."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.models import semilinear
    from pmg_dolfinx_tpu_torch.solvers.transient import (
        convdiff_advective_dt, convdiff_fdm_evolve, semilinear_fdm_evolve)

    mesh, P, steps, out = BoxMesh(IMEX_NC), 3, 200, {}
    cvel = (3.0, -1.5, 0.8)
    nl = semilinear.cubic(SEMI_C)
    dt_cd = 0.25 * convdiff_advective_dt(mesh, P, cvel)
    jobs = {
        "semilinear cnab": (
            lambda dtype, f: semilinear_fdm_evolve(
                mesh, P, nl, kappa=2.0, dt=1e-4, scheme="cnab", f=f,
                dtype=dtype, device="cuda"),
            assemble_rhs(mesh, P, semilinear.f_rhs_semilinear(2.0, nl)),
            1e-4),
        "convdiff cnab": (
            lambda dtype, f: convdiff_fdm_evolve(
                mesh, P, cvel, kappa=2.0, dt=dt_cd, scheme="cnab", f=f,
                dtype=dtype, device="cuda"),
            assemble_rhs(mesh, P, conv_source(2.0, cvel)), dt_cd),
    }
    u0 = torch.zeros(mesh.num_dofs(P), device="cuda")
    for tag, (make, f, dt) in jobs.items():
        ev = make(torch.float32, f)
        uT = ev(u0, steps)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            uT = ev(u0, steps)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - ts)
        rates = sorted(steps / w for w in walls)
        ref = make(torch.float64, f)(u0.double(), steps)
        d = rel_max_err(uT.double(), ref)
        print(f"    {tag}: dt {dt:.3e}, {mesh.num_dofs(P)} dofs: "
              f"{rates[1]:.1f} steps/s ({1e3 / rates[1]:.4f} ms/step; 3 reps "
              f"{[round(r, 1) for r in rates]}); f32 vs f64 after {steps} "
              f"steps: rel max diff {d:.3e} (gate {IMEX_RTOL:g}), rel 2-norm "
              f"diff {rel_l2(uT.double(), ref):.3e}")
        if not (bool(torch.isfinite(uT).all()) and d <= IMEX_RTOL):
            raise AssertionError(f"25d {tag}: {d}")
        out[f"25d {tag}"] = (rates[1], 1e3 / rates[1])
    return out


def newton_be(launches):
    """Phase 25e: `semilinear_newton_evolve` on a ``kron_blocked`` + fdm
    hierarchy at nc=21, p=(1,3,6) (2,048,383 dofs), f32, sigma = 1/dt, dt
    5e-3, 5 steps of cubic(5) with its manufactured source from zero,
    against the f64 plain ``kron`` run (rtol 1e-10). The f32 rtol follows
    25a: 10 x the floor ``|F32(u64_1)|`` over the smallest initial
    residual of a step. Gate: within IMEX_RTOL; #1-#3 launch. Returns
    {tag: (Newton steps in all, ms per step)}."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import (assemble_rhs,
                                                    lumped_mass_np)
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.models import semilinear
    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy
    from pmg_dolfinx_tpu_torch.solvers.transient import (
        semilinear_newton_evolve)

    mesh, P, dt, steps = BoxMesh(SMALL_NC), 6, 5e-3, 5
    nl = semilinear.cubic(SEMI_C)
    f = assemble_rhs(mesh, P, semilinear.f_rhs_semilinear(2.0, nl))
    cfg = dict(degrees=(1, 3, 6), kappa=2.0, coarse="fdm", sigma=1.0 / dt,
               device="cuda")
    h64 = PMGHierarchy(mesh, operator="kron", dtype=torch.float64, **cfg)
    h32 = PMGHierarchy(mesh, operator="kron_blocked", dtype=torch.float32,
                       **cfg)
    ev64 = semilinear_newton_evolve(h64, mesh, P, nl, dt, rtol=1e-10, f=f)
    u0 = np.zeros(mesh.num_dofs(P))
    traj = [torch.zeros(mesh.num_dofs(P), dtype=torch.float64,
                        device="cuda")]
    it64 = []
    for _ in range(steps):
        u, its = ev64(traj[-1], 1)
        traj.append(u)
        it64 += its
    # Step n+1's initial Newton residual: F(u^n) with b = m3 u^n / dt + f.
    sdt = 1.0 / dt
    m3 = torch.tensor(lumped_mass_np(mesh, P, bc_zero=True),
                      dtype=torch.float64, device="cuda")
    fv = torch.tensor(f, dtype=torch.float64, device="cuda")
    f_init = [f_norm(h64, traj[n], sdt * m3 * traj[n] + fv, nl)
              for n in range(steps)]
    floor = f_norm(h32, traj[1], sdt * m3 * traj[0] + fv, nl)
    rtol = 10.0 * floor / min(f_init)
    print(f"    f64 plain kron: Newton per step {it64}; initial residuals "
          f"{[f'{v:.3e}' for v in f_init]}; f32 operator at the f64 step-1 "
          f"state: |F32| = {floor:.3e} (the floor); f32 rtol {rtol:.3e}")
    reset(kb)
    ev32 = semilinear_newton_evolve(h32, mesh, P, nl, dt, rtol=rtol, f=f)
    torch.cuda.synchronize()
    ts = time.perf_counter()
    u32, it32 = ev32(u0, steps)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - ts) * 1e3
    path = dict(kb.LAUNCHES)
    d = rel_max_err(u32, traj[-1])
    print(f"    f32 kron_blocked: Newton per step {it32}; {wall:.1f} ms "
          f"({wall / steps:.1f} ms per time step); against the f64 run: rel "
          f"max diff {d:.3e} (gate {IMEX_RTOL:g}), rel 2-norm diff "
          f"{rel_l2(u32, traj[-1]):.3e}; launches {path}")
    if not (bool(torch.isfinite(u32).all()) and d <= IMEX_RTOL):
        raise AssertionError(f"25e: {d} from the f64 run")
    add_launches(launches, path, ("t1_m", "t23_m", "t23_res_m"))
    return {"25e newton-be": (sum(it32), wall / steps)}


def modes_phase():
    """Phase 25f, float64. The box: `examples/modes_torch.py` with the JAX
    README's flags (`MODES_BOX`: ``--ndofs 100000 --kmodes 6 --neumann x
    --sigma 5``, FDM inverse). The general family through the driver at
    its defaults but k=1 (`MODES_DRIVER_GENERAL`: ``--mesh perturbed``,
    the ``lattice`` + ``cg`` hierarchy, default tol) on a ~400-dof mesh, with
    `fcg_counts` reading the FCG(V) count of every inverse solve and the
    coarse CG iterations of every V-cycle (each ends on a host read) (gate:
    no solve at the FCG cap; the probe of that hierarchy at ~10k dofs was
    cut to make room for phase 27). Then
    `lowest_eigenpairs` on ``PerturbedBoxMesh`` at ~MODES_GENERAL_NDOFS
    dofs, p=3, k=MODES_GENERAL_K, tol MODES_GENERAL_TOL, with a
    ``lattice`` + ``direct`` hierarchy passed as ``hierarchy=``. Gates,
    against the host scipy stiffness: each pair's ``|K u - lam M u| /
    |lam M u|`` (free dofs) within MODES_BOX_RES / MODES_GENERAL_RES, the
    M-orthonormality error <= 1e-10. Returns {tag: (LOBPCG iterations,
    seconds)}."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import fit_box_cells
    from pmg_dolfinx_tpu_torch.solvers.eig import lowest_eigenpairs
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    out = {}
    res, mesh, lams, U = modes_driver(MODES_BOX)
    check_modes("box FDM", mesh, 5.0, lams, U, res["iters"], res["seconds"],
                MODES_BOX_RES, out)
    with fcg_counts() as (fcg, coarse):
        res, mesh, lams, U = modes_driver(MODES_DRIVER_GENERAL)
    cycles = sum(fcg) + len(fcg)   # one V-cycle before the first iteration
    print(f"    the driver (lattice + cg, k=1): {len(fcg)} FCG(V) solves, "
          f"FCG per solve min / median / max {min(fcg)} / "
          f"{int(np.median(fcg))} / {max(fcg)} (cap 100, "
          f"{sum(n >= 100 for n in fcg)} at it); coarse CG per V-cycle "
          f"{sum(coarse) / max(len(coarse), 1):.1f} (max {max(coarse)}, cap "
          f"60) over {len(coarse)} V-cycles ({cycles} counted from FCG); "
          f"{res['seconds'] / max(sum(fcg), 1) * 1e3:.3f} ms per FCG "
          f"iteration")
    if max(fcg) >= 100 or max(fcg + [0]) == 0:
        raise AssertionError(f"25f: FCG counts {fcg} at the driver's "
                             "default hierarchy")
    check_modes("perturbed driver", mesh, 0.0, lams, U, res["iters"],
                res["seconds"], MODES_GENERAL_RES, out)
    mesh = PerturbedBoxMesh(fit_box_cells(MODES_GENERAL_NDOFS, 3))
    ts = time.perf_counter()
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=2.0, dtype=torch.float64,
                        coarse="direct", operator="lattice", device="cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - ts
    ts = time.perf_counter()
    with fcg_counts() as (fcg, _):
        lams, U, iters = lowest_eigenpairs(
            mesh, 3, kappa=2.0, k=MODES_GENERAL_K, tol=MODES_GENERAL_TOL,
            hierarchy=hier, device="cuda")
        torch.cuda.synchronize()
    secs = time.perf_counter() - ts
    print(f"    general family: hierarchy (lattice + direct) setup "
          f"{setup:.2f} s; eigenvalues {[round(float(v), 6) for v in lams]}; "
          f"{len(fcg)} FCG(V) solves, FCG per solve min / median / max "
          f"{min(fcg)} / {int(np.median(fcg))} / {max(fcg)}; "
          f"{secs / max(sum(fcg), 1) * 1e3:.3f} ms per FCG iteration")
    check_modes("perturbed FCG(V)", mesh, 0.0, lams, U, iters, secs,
                MODES_GENERAL_RES, out)
    return out


@contextlib.contextmanager
def fcg_counts():
    """Within the block, list each `PMGHierarchy.solve_pcg` call's FCG
    count and each coarse `cg_solve` call's iterations (the setup's
    recording calibrations left out): yields the two lists."""
    from pmg_dolfinx_tpu_torch.solvers import pmg

    fcg, coarse = [], []
    solve_pcg, cg_solve = pmg.PMGHierarchy.solve_pcg, pmg.cg_solve

    def counted_pcg(self, *a, **k):
        u, n = solve_pcg(self, *a, **k)
        fcg.append(int(n))
        return u, n

    def counted_cg(*a, **k):
        x, info = cg_solve(*a, **k)
        if not k.get("record"):
            coarse.append(int(info["niter"]))
        return x, info

    pmg.PMGHierarchy.solve_pcg, pmg.cg_solve = counted_pcg, counted_cg
    try:
        yield fcg, coarse
    finally:
        pmg.PMGHierarchy.solve_pcg, pmg.cg_solve = solve_pcg, cg_solve


def modes_driver(argv):
    """``examples/modes_torch.py`` on ``argv`` in this process (a few lines
    of its output printed): (result, mesh, lams, U)."""
    if str(ROOT / "examples") not in sys.path:
        sys.path.insert(0, str(ROOT / "examples"))  # its _common_torch
    mod = load_example("modes_torch")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = mod.run(argv)
    lines = buf.getvalue().strip().splitlines()
    print("    " + "\n    ".join(lines[1:5]))
    return out


def check_modes(tag, mesh, sigma, lams, U, iters, secs, gate, out):
    """The 25f gates against the host scipy stiffness (kappa 2, p=3)."""
    import numpy as np
    import scipy.sparse as sp

    from pmg_dolfinx_tpu_torch.fem.assembly import (assemble_stiffness,
                                                    lumped_mass_np)

    P = 3
    m = lumped_mass_np(mesh, P)
    K = assemble_stiffness(mesh, P, kappa=2.0, bc=False).tocsr() \
        + sp.diags(sigma * m)
    free = ~mesh.boundary_dof_marker(P)
    Un = U.cpu().numpy()
    resid = [np.linalg.norm((K @ Un[:, j] - lams[j] * m * Un[:, j])[free])
             / np.linalg.norm((lams[j] * m * Un[:, j])[free])
             for j in range(Un.shape[1])]
    orth = float(np.abs(Un.T @ (m[:, None] * Un) - np.eye(Un.shape[1])).max())
    print(f"    {tag}: {mesh.num_dofs(P)} dofs, {iters} LOBPCG iterations in "
          f"{secs:.2f} s; max |K u - lam M u| / |lam M u| {max(resid):.3e} "
          f"(gate {gate:g}), M-orthonormality {orth:.3e} (gate 1e-10)")
    if not (max(resid) <= gate and orth <= 1e-10):
        raise AssertionError(f"25f {tag}: residual {max(resid)}, "
                             f"orthonormality {orth}")
    out[f"25f {tag}"] = (iters, secs)


# -- phase 31: the sharded paths across processes ---------------------------

RANK_TRAJ_RTOL = 1e-4     # 31a-31c: 10 cycles against the twin's, relative
RANK_TIMEOUT_S = 420      # each rank process's time limit
RANK_SLAB_NC = (42, 42, 42)   # 31a: phase 4's mesh, 16,194,277 dofs at p=6
RANK_GRID_NC = (22, 22, 22)   # 31c: 2,352,637 dofs at p=6
RANK_DEGREES = (1, 3, 6)
RANK_SEED = SEED + 31
RANK_VC_CYCLES = 5        # back-to-back V-cycles a timing window, 3 windows
RANK_TWINS = {}           # {tag: the single-process twin's numbers}
_RANK_DIR = []            # the temporary directory of phase 31's files


def rank_dir():
    """Phase 31's temporary directory (under TMPDIR), made once."""
    import tempfile

    if not _RANK_DIR:
        _RANK_DIR.append(Path(tempfile.mkdtemp(prefix="chip_smoke_31_")))
    return _RANK_DIR[0]


def seeded_pair(n, seed):
    """A seeded random rhs and iterate, float32 host arrays of ``n``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n, dtype=np.float32),
            rng.standard_normal(n, dtype=np.float32))


def rank_twin(h, b, tag):
    """The single-process twin of a phase-31 sub-phase, ``h`` with every
    shard on this card: 10 stationary cycles' relative residuals on the
    global rhs ``b``, FCG(V) to 1e-6, every level's lmax, one V-cycle on
    `seeded_pair` (host array) and ms per V-cycle. ``b`` is saved as
    ``{tag}_rhs.npy`` for the ranks."""
    import numpy as np
    import torch

    b = torch.as_tensor(b, device=DEV)
    np.save(rank_dir() / f"{tag}_rhs.npy", b.cpu().numpy())
    if tag == "31a":
        ship_geometry(h.mesh, rank_dir() / "31a_geom")
    r0 = float(torch.linalg.vector_norm(b))
    _, rn = h.solve(b, num_cycles=10)
    _, niter = h.solve_pcg(b, rtol=1e-6, maxiter=50)
    bs, us = seeded_pair(b.numel(), RANK_SEED)
    vc = h.from_dist(h.apply(h.to_dist(bs), h.to_dist(us))).cpu().numpy()
    ms, _ = slab_vcycle_ms(h, cycles=RANK_VC_CYCLES)
    RANK_TWINS[tag] = dict(rel=[v / r0 for v in rn], niter=niter, vc=vc,
                           lmax=[float(lv["lmax"])
                                 for lv in h.data["levels"]], ms=ms)
    print(f"    31{tag[-1]} twin: FCG(V) {niter}, V-cycle {ms:.3f} ms, lmax "
          f"{RANK_TWINS[tag]['lmax']}")


def ship_mesh(mesh, path):
    """Pickle an unstructured mesh with its built spaces (the merge, DSS
    layout, marker and multiplicity of every degree of phase 31b), so a
    rank process skips the half minute of host work (`load_mesh`)."""
    import pickle

    spaces = {P: (mesh._space(P), mesh.boundary_dof_marker(P),
                  mesh.dof_multiplicity(P)) for P in RANK_DEGREES}
    with open(path, "wb") as f:
        pickle.dump((mesh, spaces), f, protocol=5)


def ship_geometry(mesh, path):
    """Save a box mesh's cached host geometry factors (G and detJ of every
    degree of phase 31a, ~1.6 GB at 16.2M dofs) as ``.npy`` files under
    ``path``, which `load_geometry` maps into a rank's mesh: 31a's ranks
    skip the ~40 s of numpy the parent did in phase 2."""
    import numpy as np

    from pmg_dolfinx_tpu_torch.fem.assembly import geometry_factors_np

    path.mkdir(exist_ok=True)
    for P in RANK_DEGREES:
        G, detJ = geometry_factors_np(mesh, P)
        np.save(path / f"G{P}.npy", G)
        np.save(path / f"detJ{P}.npy", detJ)


def load_geometry(mesh, path):
    """`ship_geometry`'s factors, memory-mapped read-only, as ``mesh``'s
    cache (`fem.assembly.geometry_factors_np` reads it)."""
    import numpy as np

    cache = mesh.__dict__.setdefault("_geometry_factors_np", {})
    for P in RANK_DEGREES:
        cache[P] = tuple(np.load(Path(path) / f"{k}{P}.npy", mmap_mode="r")
                         for k in ("G", "detJ"))
    return mesh


def load_mesh(path):
    """`ship_mesh`'s mesh with its spaces served from the pickle: the
    cached methods shadowed on the instance."""
    import pickle

    with open(path, "rb") as f:
        mesh, spaces = pickle.load(f)
    mesh._space = lambda P: spaces[P][0]
    mesh.boundary_dof_marker = lambda P: spaces[P][1]
    mesh.dof_multiplicity = lambda P: spaces[P][2]
    return mesh


def rank_build(sub):
    """A rank's solver of sub-phase ``sub`` (``devices=None``: the shards
    span every rank)."""
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh

    cfg = dict(degrees=RANK_DEGREES, kappa=2.0, dtype=torch.float32,
               device=DEV)
    if sub["kind"] == "slab":
        from pmg_dolfinx_tpu_torch.parallel.dist import DistPMG

        mesh = load_geometry(BoxMesh(tuple(sub["nc"])), sub["geom"])
        return DistPMG(mesh, n_devices=sub["shards"], coarse="fdm",
                       operator="kron_blocked", **cfg)
    if sub["kind"] == "dss":
        from pmg_dolfinx_tpu_torch.parallel.dss_dist import DSSDist

        return DSSDist(load_mesh(sub["mesh"]), sub["shards"],
                       coarse="direct", **cfg)
    from pmg_dolfinx_tpu_torch.parallel.grid2d import GridPMG

    return GridPMG(BoxMesh(tuple(sub["nc"])), tuple(sub["shards"]),
                   coarse="fdm", coarse_cfg=dict(dist=True),
                   operator="kron_blocked", **cfg)


def rank_subphase(sub, rank):
    """One sub-phase on this rank: the solver, the main path (10 cycles,
    FCG(V) to 1e-6) with the kernel counts set to 0 just before and read
    just after, one V-cycle on `seeded_pair` at the twin's lmax (rank 0
    saves the global result), collective calls and staged bytes of one
    V-cycle, ms per V-cycle (CUDA events), and the kernels on this rank's
    own operands against their plain versions (raises past
    `KERNEL_RTOL`)."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb

    ts = time.perf_counter()
    h = rank_build(sub)
    torch.cuda.synchronize()
    setup = time.perf_counter() - ts
    grid = h.grid
    b = np.load(sub["rhs"])
    r0 = float(np.linalg.norm(b.astype(np.float64)))
    ts = time.perf_counter()
    reset(kb)
    _, rn = h.solve(b, num_cycles=10)
    _, niter = h.solve_pcg(b, rtol=1e-6, maxiter=50)
    torch.cuda.synchronize()
    path = {k: v for k, v in kb.LAUNCHES.items() if v}
    path_s = time.perf_counter() - ts
    bs, us = seeded_pair(b.size, RANK_SEED)
    own = [lv["lmax"] for lv in h.data["levels"]]
    for lv, lm in zip(h.data["levels"], sub["lmax"]):
        lv["lmax"] = torch.tensor(lm, dtype=own[0].dtype, device=DEV)
    try:
        vc = h.from_dist(h.apply(h.to_dist(bs), h.to_dist(us)))
    finally:
        for lv, lm in zip(h.data["levels"], own):
            lv["lmax"] = lm
    if rank == 0:
        np.save(sub["vc_out"], vc.cpu().numpy())
    bd = h.to_dist(np.ones(b.size, dtype=np.float32))
    ud = torch.zeros_like(bd)
    torch.cuda.synchronize()
    grid.stats.update(calls=0, staged_bytes=0)
    h.apply(bd, ud)
    torch.cuda.synchronize()
    per_cycle = dict(grid.stats)
    times = [cuda_ms(lambda: h.apply(bd, ud), reps=RANK_VC_CYCLES, warmup=1)
             for _ in range(3)]
    ms = sorted(times)[1]
    if sub["kind"] == "slab":
        err = slab_kernel_parity(h)
    elif sub["kind"] == "grid":
        err = ks_shard_parity(h, RANK_SEED + rank, f"rank {rank}",
                              differ=False)
    else:
        err = None
    return dict(rel=[v / r0 for v in rn], niter=niter, launches=path,
                setup_s=setup, path_s=path_s, ms=ms, ms_reps=times,
                per_cycle=per_cycle, kernel_err=err, block=list(grid.block),
                staged=bool(grid.staged))


def rank_worker(cfg_path, rank):
    """A phase-31 rank process (``chip_smoke.py --rank31 CFG RANK``): its
    CUDA context on ``cuda:0`` and the kernels loaded from phase 2's
    build (no nvcc) first, then, once the parent has written CFG's ``go``
    file, a gloo rank (its collective buffers staged through pinned host
    memory) that runs the sub-phases of ``CFG`` in order; the results go
    to the file CFG names for this rank."""
    import torch

    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.parallel import multihost

    with open(cfg_path) as f:
        cfg = json.load(f)
    torch.set_num_threads(cfg["threads"])
    torch.zeros(1, device=DEV)      # the CUDA context, before the go
    ts = time.perf_counter()
    kb.load_kernels()
    out = {"load_s": time.perf_counter() - ts}
    go, deadline = Path(cfg["go"]), time.monotonic() + RANK_TIMEOUT_S
    while not go.exists():
        if time.monotonic() > deadline:
            raise RuntimeError(f"rank {rank}: no go file {go}")
        time.sleep(0.05)
    multihost.initialize(cfg["init"], cfg["world"], rank, backend="gloo",
                         device="cuda:0", timeout_s=RANK_TIMEOUT_S)
    for sub in cfg["subs"]:
        out[sub["tag"]] = rank_subphase(sub, rank)
    with open(cfg["out"].format(rank=rank), "w") as f:
        json.dump(out, f)
    multihost.shutdown()


def start_ranks(tag, world, subs):
    """Start ``world`` rank processes on this card for ``subs``; they make
    their CUDA context and load the kernels, then wait for `go_ranks`.
    Returns the handle `wait_ranks` takes."""
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    d = rank_dir()
    cfg = dict(init=f"tcp://localhost:{port}", world=world,
               threads=max(1, 8 // world), subs=subs,
               out=str(d / f"{tag}_rank{{rank}}.json"),
               go=str(d / f"{tag}_go"))
    cfg_path = d / f"{tag}_cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    logs = [open(d / f"{tag}_rank{r}.log", "w+") for r in range(world)]
    # the ranks share the host's cores: each its share of BLAS threads
    env = dict(os.environ, OMP_NUM_THREADS=str(cfg["threads"]),
               OPENBLAS_NUM_THREADS=str(cfg["threads"]),
               MKL_NUM_THREADS=str(cfg["threads"]))
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--rank31",
         str(cfg_path), str(r)], stdout=logs[r], stderr=subprocess.STDOUT,
        cwd=str(ROOT), env=env) for r in range(world)]
    return dict(tag=tag, cfg=cfg, procs=procs, logs=logs, t0=None)


def go_ranks(h):
    """Let `start_ranks`' processes begin their sub-phases."""
    h["t0"] = time.perf_counter()
    Path(h["cfg"]["go"]).touch()


def stop_ranks(h):
    """Kill any of ``h``'s processes still running and close the logs."""
    for p in h["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()
    for f in h["logs"]:
        f.close()


def wait_ranks(h):
    """Wait for ``h``'s processes (each within `RANK_TIMEOUT_S`); a failure
    raises with the failed rank's last output (the caller stops every
    group with `stop_ranks`). Returns the ranks' results, rank order, and
    the wall seconds since `go_ranks`."""
    tag, cfg = h["tag"], h["cfg"]
    for r, p in enumerate(h["procs"]):
        rc = p.wait(timeout=RANK_TIMEOUT_S)
        if rc != 0:
            h["logs"][r].seek(0)
            raise AssertionError(f"{tag}: rank {r} exited {rc}:\n"
                                 + h["logs"][r].read()[-6000:])
    wall = time.perf_counter() - h["t0"]
    res = []
    for r in range(cfg["world"]):
        with open(cfg["out"].format(rank=r)) as f:
            res.append(json.load(f))
    return res, wall


def kerr(m):
    """A rank's worst kernel parity error as text."""
    e = m["kernel_err"]
    return "none on this path" if e is None else f"{e:.3e}"


def rank_gates(tag, res, twin, launches, need):
    """Phase 31's gates of sub-phase ``tag`` on every rank against its
    twin; prints its numbers and adds every rank's main-path launches of
    ``need`` to ``launches`` (#9's fused-residual launches counted as
    #9's, as the other grid phases count them). Returns (FCG count, ms
    per V-cycle)."""
    import numpy as np
    import torch

    vc = torch.as_tensor(np.load(rank_dir() / f"{tag}_vc.npy"))
    err = rel_max_err(vc, torch.as_tensor(twin["vc"]))
    mine = [r[tag] for r in res]
    print(f"    {tag}: {len(res)} ranks, blocks {mine[0]['block']}, "
          f"collective buffers staged through pinned host memory: "
          f"{mine[0]['staged']}; setup s {[round(m['setup_s'], 2) for m in mine]}"
          f", main path s {[round(m['path_s'], 2) for m in mine]}")
    for r, m in enumerate(mine):
        diff = traj_diff(m["rel"], twin["rel"])
        print(f"      rank {r}: FCG(V) {m['niter']} (twin {twin['niter']}); "
              f"trajectory max rel diff above {REF_TRAJ_FROM:g} {diff:.3e} "
              f"(gate {RANK_TRAJ_RTOL:g}); launches {m['launches']}; "
              f"kernels on its own operands vs plain: "
              f"{kerr(m)}")
        if abs(m["niter"] - twin["niter"]) > 1:
            raise AssertionError(f"{tag} rank {r}: FCG {m['niter']} against "
                                 f"the twin's {twin['niter']}")
        if not diff <= RANK_TRAJ_RTOL:
            raise AssertionError(f"{tag} rank {r}: trajectory differs by "
                                 f"{diff:.3e}")
        add_launches(launches, m["launches"], need)
        if "t23_grid_m" in need:
            launches["t23_grid_m"] += m["launches"].get("t23_grid_res_m", 0)
    print(f"    {tag}: one V-cycle at the twin's lmax, seeded rhs and "
          f"iterate, vs the twin: rel max err {err:.3e} (gate "
          f"{GRID_VCYCLE_RTOL:g})")
    if not err <= GRID_VCYCLE_RTOL:
        raise AssertionError(f"{tag}: V-cycle differs by {err:.3e}")
    ms = max(m["ms"] for m in mine)
    pc = mine[0]["per_cycle"]
    print(f"    {tag}: V-cycle {ms:.3f} ms across {len(res)} processes "
          f"(rank reps {[[round(t, 3) for t in m['ms_reps']] for m in mine]})"
          f" vs the single-process twin {twin['ms']:.3f} ms ({len(res)} "
          f"processes on one card: the cost of the decomposition and the "
          f"host staging, not a multi-GPU speed); per V-cycle and rank "
          f"{pc['calls']} collective calls, {pc['staged_bytes']:,} bytes "
          f"staged")
    return mine[0]["niter"], ms


def rank_phases(mesh15, launches):
    """Phase 31: 31a and 31b on 2 rank processes, 31c on 4 (`run_ranks`),
    each against its twin (`rank_twin`: 26a's and 30a's from their phases,
    31c's built here). Returns {tag: (FCG count, ms per V-cycle)}."""
    import shutil

    import torch

    from pmg_dolfinx_tpu_torch.fem.assembly import assemble_rhs
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.models.poisson import f_rhs
    from pmg_dolfinx_tpu_torch.parallel.grid2d import GridPMG

    d = rank_dir()
    ts = time.perf_counter()
    mesh_c = BoxMesh(RANK_GRID_NC)
    twin = GridPMG(mesh_c, (2, 2, 2), degrees=RANK_DEGREES, kappa=2.0,
                   dtype=torch.float32, coarse="fdm",
                   coarse_cfg=dict(dist=True), operator="kron_blocked",
                   device=DEV)
    rank_twin(twin, assemble_rhs(mesh_c, 6, f_rhs(2.0)), "31c")
    del twin
    ship_mesh(mesh15, d / "31b_mesh.pkl")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"    twins and hand-over files: {time.perf_counter() - ts:.2f} s")
    sub = lambda tag, **kw: dict(tag=tag, rhs=str(d / f"{tag}_rhs.npy"),
                                 vc_out=str(d / f"{tag}_vc.npy"),
                                 lmax=RANK_TWINS[tag]["lmax"], **kw)
    out = {}
    t0 = phase("31a/31b. 2 rank processes (gloo, cuda:0): 26a's slab "
               "flagship (6 slabs, 3 a rank, 16.2M dofs) and 30a's DSSDist "
               "(8 shards, 4 a rank, 2,244,151 dofs)")
    ab = start_ranks("31ab", 2, [
        sub("31a", kind="slab", nc=list(RANK_SLAB_NC), shards=SLAB_SHARDS,
            geom=str(d / "31a_geom")),
        sub("31b", kind="dss", mesh=str(d / "31b_mesh.pkl"),
            shards=DSS_SHARDS)])
    # 31c's ranks start now too, and wait, their start under 31a/31b's
    c = start_ranks("31c", 4, [
        sub("31c", kind="grid", nc=list(RANK_GRID_NC), shards=[2, 2, 2])])
    try:
        go_ranks(ab)
        res, wall = wait_ranks(ab)
        print(f"    rank processes: {wall:.1f} s wall (kernel load "
              f"{[round(r['load_s'], 2) for r in res]} s)")
        out["31a slab 2 ranks"] = rank_gates(
            "31a", res, RANK_TWINS["31a"], launches,
            ("t1_m", "t23_m", "t23_res_m"))
        out["31b dss 2 ranks"] = rank_gates("31b", res, RANK_TWINS["31b"],
                                            launches, ())
        done(t0)
        t0 = phase("31c. 4 rank processes (gloo, cuda:0): GridPMG (2,2,2) "
                   "on BoxMesh((22,22,22)), 2,352,637 dofs, kron_blocked, "
                   "fdm dist (pencil all_to_all across ranks)")
        go_ranks(c)
        res, wall = wait_ranks(c)
    finally:
        stop_ranks(ab)
        stop_ranks(c)
    print(f"    rank processes: {wall:.1f} s wall after the go (started "
          "with 31a/31b's)")
    out["31c grid 4 ranks"] = rank_gates("31c", res, RANK_TWINS["31c"],
                                         launches, ("t1_m", "t23_grid_m"))
    done(t0)
    shutil.rmtree(d, ignore_errors=True)
    _RANK_DIR.clear()
    return out


# --- phase 32: precision="high" (bf16x3) ------------------------------------

# The HIGH kernels (launch-count name -> the JAX package's `high` branch it
# ports) and the kernel each one instantiates with HIGH = true.
_JKB = "pmg_dolfinx_tpu/ops/pallas_kron_blocked.py"
_JLB = "pmg_dolfinx_tpu/ops/pallas_lattice_blocked.py"
HIGH_KERNELS = {
    "t1_m_high": f"{_JKB}:137 (_kernel_t1_m, if high; _dot3 at :57)",
    "t23_m_high": f"{_JKB}:162 (_kernel_t23_m, if high)",
    "t23_res_m_high": f"{_JKB}:195 (_kernel_t23_res_m, if high)",
    "t1_high": f"{_JKB}:78 (_kernel_t1, if high)",
    "t23_high": f"{_JKB}:100 (_kernel_t23, if high)",
    "t23_res_high": f"{_JKB}:272 (_kernel_t23_res, if high)",
    "t23_cheb_high": f"{_JKB}:237 (_kernel_t23_cheb, if high)",
    "t23_grid_high": f"{_JKB}:326 (_kernel_t23_grid, if high)",
    "t23_grid_m_high": f"{_JKB}:387 (_kernel_t23_grid_m, if high)",
    "lattice_apply_high": (f"{_JLB}:55 (_mk_dot) in :69 _kernel_lattice "
                           "'v1', the default at 'high' (:997); also :117 "
                           "'yexp' and :191 _mk_split_dot 'ym'"),
    "lattice_apply_zgrp_high": f"{_JLB}:358 (_kernel_lattice_zg, _mk_dot)",
    "lattice_apply_geom_high": (f"{_JLB}:432 (_kernel_lattice_geom, "
                                "dot = _mk_dot(high))"),
}


def high_build():
    """Both HIGH libraries (kron_blocked.cu and lattice_blocked.cu built
    with -DPMG_HIGH=1, in parallel): the clock at the end of each."""
    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.ops import lattice_blocked as lb

    def build(mod):
        mod.load_kernels(high=True)
        return time.perf_counter()

    with ThreadPoolExecutor(max_workers=2) as pool:
        return [f.result() for f in [pool.submit(build, kb),
                                     pool.submit(build, lb)]]


def high_ptxas():
    """The HIGH libraries' registers and spills, as `-Xptxas -v` printed
    them: the main path's instantiations and every one that spills."""
    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.ops import lattice_blocked as lb

    spills = {}
    for tag, log, keep, prefix in (
            ("kron_blocked_high", kb.BUILD_LOG_HIGH,
             ("kron_t1_mILi3E", "kron_t1_mILi6E", "kron_t23_mILi3E",
              "kron_t23_mILi6E", "kron_t23ILi"), "kron_t"),
            ("lattice_blocked_high", lb.BUILD_LOG_HIGH, ("lattice_march",),
             "lattice_march")):
        for line in ptxas_lines(log, keep, prefix, width=40):
            print("    " + line)
        lines = [ln.strip() for ln in log.splitlines() if "spill" in ln]
        bad = [ln for ln in lines if " 0 bytes spill stores" not in ln]
        spills[tag] = (len(bad), len(lines))
        print(f"    {tag}: {len(bad)} of {len(lines)} kernels spill"
              + (f", e.g. {bad[:2]}" if bad else ""))
    return spills


def high_check(name, got, ref, gap_to, split=True):
    """A HIGH kernel's output against its plain 'high' version (relative
    max norm <= KERNEL_RTOL, else raise) and its gap to the 'highest'
    kernel's output ``gap_to`` (with ``split``, an output that went
    through a split: the gap must lie in (1e-7, 1e-3)); returns (max abs
    err, gap)."""
    import torch

    torch.cuda.synchronize()
    err = rel_max_err(got, ref)
    gap = rel_max_err(got, gap_to)
    print(f"    {name}: rel max err vs plain 'high' {err:.3e}; gap to "
          f"'highest' {gap:.3e}")
    if not err <= KERNEL_RTOL:
        raise AssertionError(f"{name}: relative max-norm error {err:.3e} "
                             f"> {KERNEL_RTOL}")
    if split and not 1e-7 < gap < 1e-3:
        raise AssertionError(f"{name}: gap to 'highest' {gap:.3e} outside "
                             "(1e-7, 1e-3): the split does not act")
    return float((got - ref).abs().max()), gap


def high_time(row, kern_high, kern_highest, plain_high, bound):
    """Device ms (`graph_ms`) of the HIGH kernel and of the 'highest' one
    in turns (high, highest, highest, high), and the plain 'high' ms
    (CUDA events), into ``row``."""
    h1, g1, g2, h2 = (graph_ms(kern_high), graph_ms(kern_highest),
                      graph_ms(kern_highest), graph_ms(kern_high))
    row.update(ms=(h1 + h2) / 2, highest_ms=(g1 + g2) / 2,
               plain_ms=cuda_ms(plain_high, reps=5, warmup=1),
               bound_ms=bound[0], bound_by=bound[1])
    print(f"    {row['shape']} {row['name']}: {row['ms']:.4f} ms device "
          f"(turns {h1:.4f}, {h2:.4f}) vs 'highest' {row['highest_ms']:.4f} "
          f"({g1:.4f}, {g2:.4f}); plain 'high' {row['plain_ms']:.4f} ms; "
          f"bound {bound[0]:.4f} ms ({bound[1]}), "
          f"{bound[0] / row['ms']:.0%}")


def high_kron_kernels(rows, launches):
    """32a, kernels #1-#9: each HIGH kernel against its plain 'high'
    version at the main path's shapes (#1-#3 and #7 at 253^3 band 6, #4-#6
    on a non-separable marker at 127^3, #8/#9 on the (2, 2, 2) stacked
    layout of 127^3 shards); fills ``rows`` (kernel name -> its numbers
    for the kernels line). The entry points' launches of #4-#6 and #8 on
    the non-separable marker at 'high' (`blocked_kron_apply`,
    `blocked_kron_residual`, `blocked_kron_apply_grid`) count in
    ``launches``, each path's output checked against plain; the
    comparisons' own launches do not."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.ops.kron import axis_stiffness_mass
    from pmg_dolfinx_tpu_torch.parallel import grid2d as tg

    def box(nc, masks):
        mesh = BoxMesh((nc,) * 3)
        Ks, ms = zip(*(axis_stiffness_mass(n, 6, h)
                       for n, h in zip(mesh.nc, mesh.h_cells)))
        fm = (kb.checked_face_masks(mesh, 6, mesh.boundary_dof_marker(6))
              if masks else None)
        m = kb.symmetrized_mats([2.0 * K for K in Ks], ms, torch.float32, fm,
                                band=6, device=DEV)
        return mesh, m

    rng = np.random.default_rng(SEED + 32)
    f32 = lambda s: torch.tensor(rng.standard_normal(s, dtype=np.float32),
                                 device=DEV)

    def row(name, shape):
        rows[name] = dict(name=name, shape=shape)
        return rows[name]

    # #1-#3 at 253^3.
    mesh, m = box(42, True)
    shape = mesh.lattice_shape(6)
    x, r = f32(shape), f32(shape)
    t1 = kb.plain_t1_m(x, m, True)
    N = x.numel()
    for name, kh, kg, plain in (
            ("t1_m", lambda: kb.kron_t1_m(x, m, high=True),
             lambda: kb.kron_t1_m(x, m), lambda: kb.plain_t1_m(x, m, True)),
            ("t23_m", lambda: kb.kron_t23_m(x, t1, m, high=True),
             lambda: kb.kron_t23_m(x, t1, m),
             lambda: kb.plain_t23_m(x, t1, m, high=True)),
            ("t23_res_m", lambda: kb.kron_t23_m(x, t1, m, r3=r, high=True),
             lambda: kb.kron_t23_m(x, t1, m, r3=r),
             lambda: r - kb.plain_t23_m(x, t1, m, high=True))):
        rw = row(name + "_high", shape)
        rw["max_abs_err"], rw["gap"] = high_check(name + "_high", kh(),
                                                  plain(), kg())
        high_time(rw, kh, kg, plain, kernel_bound(name, N, 6, high="kron"))
    for sigma in (0.5,):
        high_check("t23_m_high sigma=0.5",
                   kb.kron_t23_m(x, t1, m, sigma, high=True),
                   kb.plain_t23_m(x, t1, m, sigma, high=True),
                   kb.kron_t23_m(x, t1, m, sigma))
    # #7 at 253^3: the full-bc arrays, the box's marker.
    _, mf = box(42, False)
    bc = torch.tensor(mesh.boundary_dof_marker(6).reshape(shape),
                      device=DEV)
    dinv = f32(shape).abs() + 0.5
    lm = torch.tensor(3.1, device=DEV)
    t1f = kb.plain_t1(x, bc, mf, True)
    coefs = kb.cheb_coefs(lm, 2, torch.float32, DEV)
    cheb = lambda high: kb.kron_t23_cheb(x, bc, t1f, mf, r, r, dinv, lm, 2,
                                         high=high)
    plain_c = lambda: kb.plain_cheb_step(x, bc, r, r, dinv, coefs, mf,
                                         t1=t1f, high=True)
    rw = row("t23_cheb_high", shape)
    errs = [high_check(f"t23_cheb_high ({o})", a, b, c, o != "x")
            for o, a, b, c in zip("xrz", cheb(True), plain_c(), cheb(False))]
    rw["max_abs_err"] = max(e[0] for e in errs)
    rw["gap"] = max(e[1] for e in errs[1:])
    high_time(rw, lambda: cheb(True)[1], lambda: cheb(False)[1],
              lambda: plain_c()[1], kernel_bound("t23_cheb", N, 6,
                                                 high="kron"))
    del x, r, t1, t1f, dinv, bc, m, mf
    # #4-#6 at 127^3 on a non-separable marker (the faces and ~1% of the
    # interior).
    mesh, mf = box(21, False)
    shape = mesh.lattice_shape(6)
    x, r = f32(shape), f32(shape)
    bc = torch.tensor(mesh.boundary_dof_marker(6).reshape(shape)
                      | (rng.random(shape) < 0.01), device=DEV)
    t1 = kb.plain_t1(x, bc, mf, True)
    N = x.numel()
    reset(kb)
    path = (kb.blocked_kron_apply(x, bc, mf, precision="high"),
            kb.blocked_kron_residual(r, x, bc, mf, precision="high"))
    torch.cuda.synchronize()
    counts = dict(kb.LAUNCHES)
    for tag, got, ref in (("apply", path[0], kb.plain_apply(x, bc, mf,
                                                             high=True)),
                          ("residual", path[1], kb.plain_residual(
                              r, x, bc, mf, high=True))):
        e = rel_max_err(got, ref)
        print(f"    blocked_kron_{tag} at 'high', non-separable marker, "
              f"127^3: rel max err vs plain 'high' {e:.3e}")
        if not e <= KERNEL_RTOL:
            raise AssertionError(f"blocked_kron_{tag} at 'high': {e:.3e}")
    add_launches(launches, counts, ("t1_high", "t23_high", "t23_res_high"))
    for name, kh, kg, plain in (
            ("t1", lambda: kb.kron_t1(x, bc, mf, high=True),
             lambda: kb.kron_t1(x, bc, mf),
             lambda: kb.plain_t1(x, bc, mf, True)),
            ("t23", lambda: kb.kron_t23(x, bc, t1, mf, high=True),
             lambda: kb.kron_t23(x, bc, t1, mf),
             lambda: kb.plain_t23(x, bc, t1, mf, high=True)),
            ("t23_res", lambda: kb.kron_t23(x, bc, t1, mf, r3=r, high=True),
             lambda: kb.kron_t23(x, bc, t1, mf, r3=r),
             lambda: r - kb.plain_t23(x, bc, t1, mf, high=True))):
        rw = row(name + "_high", shape)
        rw["max_abs_err"], rw["gap"] = high_check(name + "_high", kh(),
                                                  plain(), kg())
        high_time(rw, kh, kg, plain, kernel_bound(name, N, 6, high="kron"))
    # #8 / #9 on the (2, 2, 2) stacked layout of phase 14's grid (127^3
    # shards of the 16.2M lattice), the x, y and z exchanges of `GridPMG`,
    # sigma 0.5, apply and fused residual, against the same steps with the
    # plain 'high' versions (`grid_plain_high`).
    shards = (2, 2, 2)
    grid = tg.StackedGrid(shards)
    ex = dict(exchange_x=lambda t: tg._exchange_axis(t, grid, 0,
                                                     inplace=True),
              ex_y=tg._plane_exchange_pair(grid, 1),
              ex_z=tg._plane_exchange_pair(grid, 2))
    for name, masks in (("t23_grid_m", True), ("t23_grid", False)):
        gmesh, part, gm = grid_mats((42,) * 3, 6, shards, masks)
        blocks = kb.shard_blocks(gm)
        stack = lambda a: tg.stack_shards(torch.as_tensor(
            part.to_dist(6, a), device=DEV), shards)
        xs = stack(rng.standard_normal(gmesh.num_dofs(6)).astype(np.float32))
        rs = stack(rng.standard_normal(gmesh.num_dofs(6)).astype(np.float32))
        marker = gmesh.boundary_dof_marker(6).astype(np.float32)
        if not masks:
            marker = np.maximum(marker, rng.random(marker.shape) < 0.01)
        bcs = stack(marker) > 0.5
        for rr in (None, rs):
            run = lambda high: kb.blocked_kron_apply_grid(
                xs, bcs, gm, precision="high" if high else "highest",
                sigma=0.5, r3=rr, blocks=blocks, **ex)
            ref = grid_plain_high(xs, bcs, gm, blocks, ex, 0.5, rr)
            tag = f"{name}_high ({'residual' if rr is not None else 'apply'})"
            reset(kb)
            got = run(True)
            if not masks:   # #8's path: the grid entry point at 'high'
                launches[name + "_high"] += (kb.LAUNCHES["t23_grid_high"]
                                             + kb.LAUNCHES[
                                                 "t23_grid_res_high"])
            e = high_check(tag, got, ref, run(False))
            if rr is None:
                rw = row(name + "_high", tuple(xs.shape))
                rw["max_abs_err"], rw["gap"] = e
        del xs, rs, bcs
        # Kernel 2 alone on shard 0 with seeded corrections: the device
        # ms beside 'highest' and the plain 'high' version's.
        idx = (0, 0, 0)
        m0 = blocks[idx]
        x0 = f32(tuple(m0[k].shape[1] for k in ("Ktx", "Kty", "KtzT")))
        b0 = torch.zeros(x0.shape, dtype=torch.bool, device=DEV)
        b0[0], b0[:, 0], b0[:, :, 0] = True, True, True
        t10 = kb.plain_t1_m(x0, m0, True) if masks else kb.plain_t1(
            x0, b0, m0, True)
        cy0, cz0 = f32((x0.shape[0], 2, x0.shape[2])), f32(
            (x0.shape[0], x0.shape[1], 2))
        if masks:
            kh = lambda: kb.kron_t23_grid_m(x0, t10, m0, 0.5, cy0, cz0,
                                            high=True)
            kg = lambda: kb.kron_t23_grid_m(x0, t10, m0, 0.5, cy0, cz0)
            plain = lambda: kb.plain_t23_grid_m(x0, t10, m0, 0.5, cy0, cz0,
                                                high=True)
        else:
            kh = lambda: kb.kron_t23_grid(x0, b0, t10, m0, 0.5, cy0, cz0,
                                          high=True)
            kg = lambda: kb.kron_t23_grid(x0, b0, t10, m0, 0.5, cy0, cz0)
            plain = lambda: kb.plain_t23_grid(x0, b0, t10, m0, 0.5, cy0, cz0,
                                              high=True)
        high_check(f"{name}_high (shard 0)", kh(), plain(), kg())
        rw["shard_shape"] = tuple(x0.shape)
        high_time(rw, kh, kg, plain, kernel_bound(
            name, x0.numel(), 6, dims=tuple(x0.shape), high="kron"))


def grid_plain_high(xs, bcs, gm, blocks, ex, sigma, r):
    """`blocked_kron_apply_grid` at 'high' on the stacked layout, its
    steps with the plain 'high' versions on the same device: the edge
    partials exchanged into ``cy`` / ``cz``, kernel 1 per shard, the x
    exchange, kernel 2 per shard (the residual ``r - A x`` when ``r``)."""
    import torch

    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb

    sep = "sxzm" in gm
    t2b, t3b = kb.edge_partials(xs, bcs, gm, True, True)
    cy = torch.stack(ex["ex_y"](t2b[..., 0, :], t2b[..., 1, :]), dim=-2)
    cz = torch.stack(ex["ex_z"](t3b[..., 0], t3b[..., 1]), dim=-1)
    t1 = torch.empty_like(xs)
    for idx, m in blocks.items():
        t1[idx] = (kb.plain_t1_m(xs[idx], m, True) if sep
                   else kb.plain_t1(xs[idx], bcs[idx], m, True))
    t1 = ex["exchange_x"](t1)
    out = torch.empty_like(xs)
    for idx, m in blocks.items():
        y = (kb.plain_t23_m(xs[idx], t1[idx], m, sigma, cy[idx], cz[idx],
                            True) if sep else
             kb.plain_t23(xs[idx], bcs[idx], t1[idx], m, sigma, cy[idx],
                          cz[idx], True))
        out[idx] = y if r is None else r[idx] - y
    return out


def high_lattice_kernels(rows, nc=42):
    """32a, K-A / K-B: K-A with the 'v1' splits at 253^3 p=6 and 127^3
    p=3 (and with the 'yexp' splits at 253^3), K-A on the z-grouped
    geometry and K-B at 253^3, each against `plain_lattice_apply_high`. G
    and Gz are seeded synthetic SPD geometry (the kernels' function does
    not depend on where G came from); K-B reads the coefficients of
    PerturbedBoxMesh((42,)*3)."""
    import numpy as np
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_tpu_torch.ops import lattice_blocked as lb

    rng = np.random.default_rng(SEED + 320)

    def spd_G(Q):
        g = torch.empty((6,) + Q, device=DEV)
        g[[0, 3, 5]] = 1.0 + torch.rand((3,) + Q, device=DEV)
        g[[1, 2, 4]] = 0.3 * (2 * torch.rand((3,) + Q, device=DEV) - 1)
        return g

    for P, variants in ((6, ("v1", "yexp")), (3, ("v1",))):
        mesh = PerturbedBoxMesh((nc,) * 3)
        cells = (nc,) * 3
        Q = tuple(c * (P + 1) for c in cells)
        mats = lb.lattice_blocked_mats(cells, P, device=DEV)
        bc = torch.tensor(mesh.boundary_dof_marker(P), device=DEV)
        x = torch.tensor(rng.standard_normal(mesh.num_dofs(P),
                                             dtype=np.float32), device=DEV)
        N = x.numel()
        Gt = spd_G(Q)
        for variant in variants:
            v1 = variant == "v1"
            kh = lambda: lb.lattice_apply(x, bc, Gt, mats["D1"], cells, P,
                                          high=True, v1=v1)
            kg = lambda: lb.lattice_apply(x, bc, Gt, mats["D1"], cells, P)
            plain = lambda: lb.plain_lattice_apply_high(
                x, mats["D1"], torch.movedim(Gt, 0, -1), bc, cells, P, v1)
            tag = f"lattice_apply_high ({variant}, {N} dofs, p={P})"
            e = high_check(tag, kh(), plain(), kg())
            if v1:
                rw = rows.setdefault("lattice_apply_high", dict(
                    name="lattice_apply_high", shape=(N, P),
                    max_abs_err=0.0, gap=0.0, by_shape={}))
                rw["max_abs_err"] = max(rw["max_abs_err"], e[0])
                rw["gap"] = max(rw["gap"], e[1])
                sub = dict(name="lattice_apply_high", shape=f"{N} p={P}")
                high_time(sub, kh, kg, plain, kernel_bound(
                    "lattice_apply", N, P, nc=cells, high="v1"))
                rw["by_shape"][f"{N} p={P}"] = {
                    k: sub[k] for k in ("ms", "highest_ms", "plain_ms",
                                        "bound_ms", "bound_by")}
                if P == 6:
                    rw.update({k: sub[k] for k in (
                        "ms", "highest_ms", "plain_ms", "bound_ms",
                        "bound_by")})
        del Gt
        if P != 6:
            continue
        zb = lb.select_zgroup(nc, P)
        zbn = zb * (P + 1)
        Gz = spd_G(Q).permute(1, 0, 2, 3).reshape(
            Q[0], 6, Q[1], Q[2] // zbn, zbn).permute(0, 1, 3, 2, 4).reshape(
            Q[0], 6 * (Q[2] // zbn), Q[1], zbn).contiguous()
        kh = lambda: lb.lattice_apply_zgrp(x, bc, Gz, mats["D1"], cells, P,
                                           zb, high=True)
        kg = lambda: lb.lattice_apply_zgrp(x, bc, Gz, mats["D1"], cells, P,
                                           zb)
        plain = lambda: lb.plain_lattice_apply_zgrp(x, mats, Gz, bc, cells,
                                                    P, zb, high=True)
        rw = rows["lattice_apply_zgrp_high"] = dict(
            name="lattice_apply_zgrp_high", shape=f"{N} p={P} zb={zb}")
        rw["max_abs_err"], rw["gap"] = high_check(
            f"lattice_apply_zgrp_high (zb={zb})", kh(), plain(), kg())
        high_time(rw, kh, kg, plain, kernel_bound(
            "lattice_apply_zgrp", N, P, nc=cells, high="zgrp"))
        del Gz
        co = torch.tensor(lb.lattice_geom_coefficients(
            mesh, P, np.full(mesh.ncells, 2.0)), dtype=torch.float32,
            device=DEV)
        _, xi, wx = lb.lattice_geom_data(cells, P, device=DEV)
        kh = lambda: lb.lattice_apply_geom(x, bc, co, mats["D1"], cells, P,
                                           xi, wx, high=True)
        kg = lambda: lb.lattice_apply_geom(x, bc, co, mats["D1"], cells, P,
                                           xi, wx)
        plain = lambda: lb.plain_lattice_apply_geom(x, mats, co, bc, cells,
                                                    P, high=True)
        rw = rows["lattice_apply_geom_high"] = dict(
            name="lattice_apply_geom_high", shape=f"{N} p={P}")
        rw["max_abs_err"], rw["gap"] = high_check(
            "lattice_apply_geom_high", kh(), plain(), kg())
        high_time(rw, kh, kg, plain, kernel_bound(
            "lattice_apply_geom", N, P, nc=cells, high="geom"))


def high_graph_capture():
    """A first HIGH launch of each kron_blocked form and of K-A inside a
    CUDA graph capture equals the same launch outside it."""
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_tpu_torch.ops import lattice_blocked as lb

    mesh = PerturbedBoxMesh((4, 5, 6))
    op = lb.PallasLatticeBlocked(mesh, 3, precision="high", device=DEV)
    x = torch.randn(op.ndofs, device=DEV,
                    generator=torch.Generator(DEV).manual_seed(SEED))
    lb._RECORDS.clear()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = op(x)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(y, op(x)):
        raise AssertionError("K-A HIGH: a first launch in graph capture "
                             "differs from one outside it")
    print("    K-A HIGH (v1): first launch inside a CUDA graph capture "
          "equals the launch outside it")


def run_pmg_driver(args, box=None, curved=None):
    """``examples/pmg_torch.py`` through its ``main`` in this process (its
    launches count here); with ``box`` / ``curved`` the mesh instance the
    driver builds for the same cells (its cached host geometry; on the box
    the driver's L2 error is computed on the card, `card_l2_error`).
    Returns (its last JSON line, the `PoissonProblem` it built)."""
    from pmg_dolfinx_tpu_torch.fem import mesh as fem_mesh
    from pmg_dolfinx_tpu_torch.models import poisson

    built = []

    class Recorded(poisson.PoissonProblem):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            built.append(self)

        def error_l2(self, u):
            if box is None:
                return super().error_l2(u)
            return card_l2_error(self.mesh, self.degrees[-1], u,
                                 self._u_exact)

    def same(mesh):
        def make(nc, dirichlet_faces=True, spacing=None):
            if (tuple(nc) != tuple(mesh.nc) or dirichlet_faces is not True
                    or spacing is not None):
                raise AssertionError(f"the driver built {nc}, not {mesh.nc}")
            return mesh
        return make

    saved = (poisson.PoissonProblem, poisson.BoxMesh,
             fem_mesh.PerturbedBoxMesh)
    poisson.PoissonProblem = Recorded
    if box is not None:
        poisson.BoxMesh = same(box)
    if curved is not None:
        fem_mesh.PerturbedBoxMesh = same(curved)
    try:
        out = run_example("pmg_torch", args)
    finally:
        (poisson.PoissonProblem, poisson.BoxMesh,
         fem_mesh.PerturbedBoxMesh) = saved
    return out, built[-1]


def vcycle_turns(a, b):
    """ms per V-cycle of hierarchies ``a`` and ``b`` (`vcycle_ms`: 10
    back-to-back, median of 3) in turns a, b, b, a; returns (a ms, b ms,
    the four)."""
    a1, b1, b2, a2 = (vcycle_ms(h, cycles=10)[0] for h in (a, b, b, a))
    return (a1 + a2) / 2, (b1 + b2) / 2, (a1, b1, b2, a2)


def high_flagship(box, prob, hier, niter_ref, cfg, launches):
    """32b: the flagship through `examples/pmg_torch.py --precision high
    --pcg` on phase 4's mesh (kernels #1-#3 HIGH), held to phase 4's
    'highest' hierarchy: FCG(V) to rtol 1e-6 within 1, ms per V-cycle in
    turns, the relative residual after 16 stationary V-cycles at both
    precisions (a finding, not a gate) and the stationary warning. The
    driver's FCG solution solves the 'high' operator (its outer matvec is
    the bf16x3 apply, as in JAX; on the CPU, JAX's own split FCG solution
    lies as far from the exact one: `tests/test_torch_precision_high.py::
    test_hierarchy_high_matches_split_jax`): its L2 error is a finding,
    held below 1e-3; the refined solve at 'high' (f64 outer residual, the
    mode JAX names for 'high') is held below 1e-4. Then the fused smoother
    at 'high' (#4 + #7). Returns its numbers."""
    import warnings

    import torch

    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    reset(kb)
    out, prob_h = run_pmg_driver(
        ["--ndofs", str(box.num_dofs(6)), "--degrees", "1", "3", "6",
         "--coarse", "fdm", "--operator", "kron_blocked", "--precision",
         "high", "--pcg", "--cycles", "50", "--device", DEV], box=box)
    counts = dict(kb.LAUNCHES)
    if any(counts[k] for k in ("t1_m", "t23_m", "t23_res_m")):
        raise AssertionError(f"a 'highest' kernel ran at 'high': {counts}")
    add_launches(launches, counts, ("t1_m_high", "t23_m_high",
                                    "t23_res_m_high"))
    hier_h = prob_h.hierarchy
    if not out["l2_error"] < 1e-3:
        raise AssertionError(f"32b: FCG L2 error {out['l2_error']}")
    u_r, _ = hier_h.solve_refined(prob_h.b, num_cycles=12)
    l2_ref = card_l2_error(box, 6, u_r, prob_h._u_exact)
    if not l2_ref < 1e-4:
        raise AssertionError(f"32b: refined L2 error {l2_ref}")
    _, n_h = hier_h.solve_pcg(prob_h.b, rtol=1e-6, maxiter=50)
    ms_h, ms_g, four = vcycle_turns(hier_h, hier)
    r0 = float(torch.linalg.vector_norm(prob.b))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, rn_h = hier_h.solve(prob_h.b, num_cycles=16)
    warned = any("stalls" in str(w.message) for w in caught)
    _, rn_g = hier.solve(prob.b, num_cycles=16)
    stat = (rn_h[-1] / r0, rn_g[-1] / r0)
    print(f"    FCG(V) to rtol 1e-6: 'high' {n_h}, 'highest' {niter_ref} "
          f"(phase 4); L2 error: the driver's FCG to 1e-8 "
          f"{out['l2_error']:.4e} (the 'high' operator's solution), "
          f"solve_refined at 'high' {l2_ref:.4e}; V-cycle 'high' "
          f"{ms_h:.3f} ms vs 'highest' {ms_g:.3f} ms (turns "
          f"{[round(t, 3) for t in four]}); 16 stationary V-cycles: rel "
          f"residual 'high' {stat[0]:.4e}, 'highest' {stat[1]:.4e} "
          f"({'the stall shows' if stat[0] > 10 * stat[1] else 'no stall'}"
          f"); stationary warning raised: {warned}; launches {counts}")
    if abs(n_h - niter_ref) > 1:
        raise AssertionError(f"32b: FCG {n_h} at 'high' vs {niter_ref}")
    if not warned:
        raise AssertionError("32b: no stationary warning at 'high'")
    del hier_h, prob_h, u_r
    reset(kb)
    fused = PMGHierarchy(box, operator="kron_blocked", fuse_smoother=True,
                         precision="high", **cfg)
    _, n_f = fused.solve_pcg(prob.b, rtol=1e-6, maxiter=50)
    counts = dict(kb.LAUNCHES)
    print(f"    fused smoother at 'high': FCG(V) to rtol 1e-6 {n_f}; "
          f"launches {counts}")
    if abs(n_f - niter_ref) > 1:
        raise AssertionError(f"32b fused: FCG {n_f} vs {niter_ref}")
    add_launches(launches, counts, ("t1_high", "t23_cheb_high"))
    return dict(fcg_high=n_h, fcg_highest=niter_ref, l2=out["l2_error"],
                l2_refined=l2_ref, vc_high=ms_h, vc_highest=ms_g,
                stationary=stat,
                warned=warned, fcg_fused_high=n_f)


def high_curved(launches, nc=21):
    """32c: curved_2M_p136 (PerturbedBoxMesh((21,)*3), p=(1,3,6),
    lattice_blocked + cg) through `examples/pmg_torch.py --pcg` at 'high'
    (K-A with the 'v1' splits) against the same hierarchy at 'highest'
    (built on the driver's mesh, solving its rhs): FCG(V) to rtol 1e-6
    within 1, ms per V-cycle in turns; then `mat_free_torch.py
    --precision high` with the 'zgrp' (K-A on Gz, zb 7) and 'geom' (K-B)
    variants on the same mesh (``nc`` cells per axis). Returns its
    numbers."""
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_tpu_torch.ops import lattice_blocked as lb
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    mesh = PerturbedBoxMesh((nc,) * 3)
    ndofs = str(mesh.num_dofs(6))
    reset(lb)
    _, p = run_pmg_driver(
        ["--ndofs", ndofs, "--degrees", "1", "3", "6", "--mesh", "perturbed",
         "--operator", "lattice_blocked", "--coarse", "cg", "--precision",
         "high", "--pcg", "--cycles", "50", "--device", DEV], curved=mesh)
    counts = dict(lb.LAUNCHES)
    if counts["lattice_apply"]:
        raise AssertionError(f"'highest' K-A ran at 'high': {counts}")
    add_launches(launches, counts, ("lattice_apply_high",))
    ref = PMGHierarchy(mesh, degrees=(1, 3, 6), kappa=2.0,
                       dtype=torch.float32, coarse="cg",
                       operator="lattice_blocked", device=DEV)
    _, n_h = p.hierarchy.solve_pcg(p.b, rtol=1e-6, maxiter=50)
    _, n_g = ref.solve_pcg(p.b, rtol=1e-6, maxiter=50)
    ms_h, ms_g, four = vcycle_turns(p.hierarchy, ref)
    print(f"    FCG(V) to rtol 1e-6: 'high' {n_h}, 'highest' {n_g}; V-cycle "
          f"'high' {ms_h:.3f} ms vs 'highest' {ms_g:.3f} ms (turns "
          f"{[round(t, 3) for t in four]})")
    if abs(n_h - n_g) > 1:
        raise AssertionError(f"32c: FCG {n_h} at 'high' vs {n_g}")
    del p, ref
    mf = {}
    zb = str(next(z for z in (7, 5, 3, 2, 1) if nc % z == 0))
    for variant, extra, name in (("zgrp", ["--zb", zb], "lattice_apply_zgrp"),
                                 ("geom", [], "lattice_apply_geom")):
        reset(lb)
        mf[variant] = run_mat_free(
            ["--ndofs", ndofs, "--degree", "6", "--mesh", "perturbed",
             "--operator", "lattice_blocked", "--variant", variant, *extra,
             "--precision", "high", "--reps", "20", "--device", DEV],
            mesh)
        add_launches(launches, dict(lb.LAUNCHES), (name + "_high",))
    return dict(fcg_high=n_h, fcg_highest=n_g, vc_high=ms_h,
                vc_highest=ms_g,
                mat_free_ms={k: v["ms_per_apply"] for k, v in mf.items()})


def high_grid(launches, nc=22):
    """32d: `GridPMG(BoxMesh((22,)*3), (2,2,2), (1,3,6), float32,
    kron_blocked, fdm, precision='high')` (31c's problem, 2,352,637 dofs,
    on one process): one V-cycle on a seeded rhs and iterate against a
    `PMGHierarchy` at 'high' at its smoother bounds (#1 / #9 HIGH)."""
    import torch

    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh
    from pmg_dolfinx_tpu_torch.ops import kron_blocked as kb
    from pmg_dolfinx_tpu_torch.parallel.grid2d import GridPMG
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    mesh = BoxMesh((nc,) * 3)
    cfg = dict(degrees=(1, 3, 6), kappa=2.0, dtype=torch.float32,
               coarse="fdm", operator="kron_blocked", precision="high",
               device=DEV)
    hier = PMGHierarchy(mesh, **cfg)
    grid = GridPMG(mesh, (2, 2, 2), **cfg)
    reset(kb)
    grid_vcycle_parity(grid, hier, SEED + 32, "32d grid (2, 2, 2) at 'high'")
    counts = dict(kb.LAUNCHES)
    counts["t23_grid_m_high"] += counts["t23_grid_res_m_high"]
    print(f"    launches: {counts}")
    add_launches(launches, counts, ("t1_m_high", "t23_grid_m_high"))


def main():
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="root of a parent checkout: phases 3b-3e and 10-11 "
                    "also time its full-bc, transfer, whole-lattice, shard "
                    "and serving kernels and its steppers, in turns")
    ap.add_argument("--rank31", nargs=2, metavar=("CFG", "RANK"),
                    help="run as one rank process of phase 31 (started by "
                    "the script itself)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    if not PKG.is_dir():
        raise SystemExit(f"chip_smoke: {PKG} not found; run from the root "
                         "of a checkout")
    sys.path.insert(0, str(ROOT))
    if args.rank31:
        rank_worker(args.rank31[0], int(args.rank31[1]))
        return

    parent = load_parent(args.parent)
    t_script = time.perf_counter()
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

    t0 = t_build = phase("2. build kernels")
    # The L-shaped meshes of phases 22-23 (their merge, layouts and
    # geometry: ~15 s and ~2 min of host numpy) build on worker threads
    # from here on, while nvcc and the card work.
    lshape_pool = ThreadPoolExecutor(max_workers=len(LSHAPE_N))
    lshape_jobs = {n: lshape_pool.submit(lshape_spaces, n) for n in LSHAPE_N}
    lshape_pool.shutdown(wait=False)
    # The 16.2M host f64 geometry factors of phase 4's box and 19a's mixed
    # box (30-48 s of numpy each, cached on the mesh; their rhs assembly
    # reads them) build on worker threads while nvcc runs.
    from pmg_dolfinx_tpu_torch.fem.assembly import geometry_factors_np
    from pmg_dolfinx_tpu_torch.fem.mesh import BoxMesh

    box42, mixed42 = BoxMesh((42, 42, 42)), mixed_mesh(42)
    geom_box = start_l2(geometry_factors_np, box42, 6)
    geom_mixed = start_l2(geometry_factors_np, mixed42, 6)
    modules = (kb, lb, kp, tt, kf)
    # The parent's kron_blocked.cu (phases 3b and 3e time it) alongside.
    builds = modules + ((importlib.import_module(
        f"{parent.__name__}.ops.kron_blocked"),) if parent else ())
    build_pool = ThreadPoolExecutor(max_workers=len(builds))
    built = [build_pool.submit(timed_build, m) for m in builds]
    build_pool.shutdown(wait=False)
    # The precision='high' libraries (kron_blocked.cu and lattice_blocked.cu
    # with -DPMG_HIGH=1) build beside them, joined in phase 32a: started
    # later (before 25f) they were still building at 32a and slowed the
    # join and phase 4 (PERF.md §4).
    high_pool = ThreadPoolExecutor(max_workers=1)
    high_job = (time.perf_counter(), high_pool.submit(high_build))
    high_pool.shutdown(wait=False)
    print(f"    nvcc started ({len(builds)} sources and the two HIGH "
          "libraries, in parallel); the kernel-free phases 18a, 18c and 25f "
          "run on the card meanwhile")
    done(t0)
    early = kernel_free_phases()
    t0 = phase("2 (joined). kernel build")
    ts = time.perf_counter()
    ends = [fut.result() for fut in built]
    print(f"    build seconds ({len(builds)} sources, in parallel): "
          f"{max(ends) - t_build:.2f}; joined after "
          f"{time.perf_counter() - ts:.2f} s of waiting")
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

    from pmg_dolfinx_tpu_torch.models.poisson import PoissonProblem
    from pmg_dolfinx_tpu_torch.solvers.pmg import PMGHierarchy

    t0 = phase("4. main path: 16.2M dofs, p=(1,3,6), kron_blocked + fdm")
    cfg = dict(degrees=(1, 3, 6), kappa=2.0, dtype=torch.float32,
               coarse="fdm", device="cuda")
    # Phase 6's 16.2M host f64 geometry factors (~40 s of numpy, cached on
    # the mesh) build on a worker thread from here; phase 6 joins them.
    from pmg_dolfinx_tpu_torch.fem.mesh import PerturbedBoxMesh

    curved = PerturbedBoxMesh((42, 42, 42))
    geom6 = start_l2(geometry_factors_np, curved, 6)
    for k in kb.LAUNCHES:
        kb.LAUNCHES[k] = 0
    ts = time.perf_counter()
    geom_box[0].result()
    print(f"    nc=42 p=6 host f64 geometry factors (host thread, started in "
          f"phase 2) joined after {time.perf_counter() - ts:.2f} s of waiting")
    ts = time.perf_counter()
    prob = PoissonProblem(mesh=box42, operator="kron_blocked", **cfg)
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
    print(f"    V-cycle {vc_blk:.3f} ms (kron_blocked kernels; {VC_CYCLES} "
          f"back-to-back, 3 reps {[round(t, 3) for t in vc_blk_all]})")
    b1 = torch.ones_like(prob.b)
    hier.apply(b1, torch.zeros_like(b1))
    _, busy, nk, _ = profile_busy(lambda: hier.apply(b1, torch.zeros_like(b1)))
    print(f"    device busy per V-cycle {busy:.3f} ms ({nk} kernels, "
          f"torch.profiler) of the back-to-back {vc_blk:.3f} ms: idle "
          f"{max(0.0, 1 - busy / vc_blk):.1%}")
    l2_4 = card_l2(prob, u)
    ts = time.perf_counter()
    plain_hier = PMGHierarchy(BoxMesh((42, 42, 42)), operator="kron", **cfg)
    torch.cuda.synchronize()
    print(f"    plain kron PMGHierarchy setup seconds (no rhs): "
          f"{time.perf_counter() - ts:.2f}")
    vc_plain, vc_plain_all = vcycle_ms(plain_hier)
    print(f"    V-cycle {vc_plain:.3f} ms (plain torch kron; {VC_CYCLES} "
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

    t0 = phase("32a. precision='high': the HIGH kernels #1-#9, K-A and K-B "
               "vs their plain 'high' versions (253^3, 127^3, the (2,2,2) "
               "stack of 127^3 shards)")
    launches.update({k: 0 for k in HIGH_KERNELS})
    ts = time.perf_counter()
    t_high, job = high_job
    high_ends = job.result()
    print(f"    HIGH libraries (nvcc started in phase 2): built in "
          f"{max(high_ends) - t_high:.2f} s; joined after "
          f"{time.perf_counter() - ts:.2f} s of waiting")
    high_spills = high_ptxas()
    high_rows = {}
    high_kron_kernels(high_rows, launches)
    high_lattice_kernels(high_rows)
    high_graph_capture()
    done(t0)

    t0 = phase("32b. precision='high' flagship (run here, on phase 4's mesh "
               "and hierarchy): examples/pmg_torch.py --precision high "
               "--pcg, 16.2M dofs, p=(1,3,6), kron_blocked + fdm; the fused "
               "smoother at 'high'")
    high_flagship(box42, prob, hier, niter, cfg, launches)
    done(t0)

    t0 = phase("32c. precision='high' curved_2M_p136: examples/pmg_torch.py "
               "--mesh perturbed, nc=21, lattice_blocked + cg, 'high' vs "
               "'highest'; mat_free_torch.py --precision high, zgrp and geom")
    high_curved(launches)
    done(t0)

    t0 = phase("32d. precision='high' GridPMG (2,2,2) on BoxMesh((22,)*3) "
               "(2,352,637 dofs), kron_blocked + fdm, one V-cycle vs "
               "PMGHierarchy at 'high'")
    high_grid(launches)
    done(t0)

    t0 = phase("14. device-grid main path (run here, on phase 4's mesh, rhs "
               "and hierarchy): GridPMG (2,2,2), 16.2M dofs, kron_blocked + "
               "fdm, every shard on this card")
    grid_niter, grid_ms = grid_path(prob, hier, rel, u, niter, spread, cfg,
                                    launches)
    done(t0)

    t0 = phase("26a. slab main path (run here, on phase 4's mesh, rhs and "
               "hierarchy): DistPMG, 6 slabs, 16.2M dofs, kron_blocked + fdm, "
               "every slab on this card")
    slab, l2_26a, family = slab_flagship(prob, hier, rel, u, niter, spread,
                                         cfg, launches)
    rank_twin(slab, prob.b, "31a")     # phase 31a's reference
    done(t0)

    t0 = phase("26b. examples/scaling_torch.py 1D slab sweep: ~2M dofs "
               "kron_blocked f32 and ~250k dofs dofmap + cg f64, 1-8 slabs")
    family.update(slab_sweeps(launches))
    done(t0)

    family.update(gather_free_slab(prob, slab, family["26a slab"][0], cfg,
                                   launches))
    t0 = phase("27c. grid gather-free h-coarse (run here, on phase 4's mesh "
               "and rhs): GridPMG (2,2,2), 16.2M dofs, kron_blocked, "
               "coarse=hmg with dist=True, bottom=fdm")
    family["27c grid hmg gather-free"], l2_27c = gather_free_grid(
        prob, grid_niter, cfg, launches)
    done(t0)

    t0 = phase("15. Schwarz flagship (run here, on phase 4's mesh and rhs): "
               "16.2M dofs, p=(1,3,6), kron_blocked + fdm, smoother=schwarz")
    del hier
    hier_sw, l2_15 = schwarz_flagship(prob, niter, cfg, launches)
    done(t0)

    t0 = phase("18d. device-grid Schwarz (run here, on phase 4's mesh and "
               "rhs): GridPMG (2,2,2), 16.2M dofs, kron_blocked + fdm, "
               "smoother=schwarz")
    grid_schwarz(prob, hier_sw, cfg, launches)
    del hier_sw
    done(t0)

    t0 = phase("24a. flagship with the AMG coarse (run here, on phase 4's "
               "mesh and rhs): 16.2M dofs, p=(1,3,6), kron_blocked + amg")
    family["24a"] = flagship_amg(prob, niter, vc_blk, cfg, launches)
    done(t0)

    t0 = phase("25a. steady Newton on phase 4's flagship hierarchy: 16.2M "
               "dofs, p=(1,3,6), kron_blocked + fdm, cubic(5) and bratu(5)")
    keep = {}
    family.update(newton_flagship(prob, cfg, launches, keep))
    box42 = prob.mesh   # its host geometry serves phases 19b, 20 and 25b
    del prob, u
    done(t0)

    t0 = phase("25b. convection-diffusion (BiCGStab, V-cycle of the "
               "symmetric part): 16.2M dofs f32 kron; nc=21 f32 vs f64; SD "
               "at cell Pe 20")
    family.update(convdiff_phase(box42, launches, keep))
    done(t0)

    t0 = phase("26c. slab model families: newton_solve on 26a's hierarchy "
               "(16.2M), convdiff_solve on 7 slabs at nc=21, "
               "examples/vector_update_torch.py")
    family.update(slab_models(slab, keep["cubic"], keep["nc21"], launches))
    del slab, keep
    done(t0)

    geom_mixed[0].result()
    fam, l2_19a = box_family(box42, launches, grid_ms, mixed42)
    family.update(fam)
    t0 = phase("19c. box family at nc=21: --grade z:8 --neumann x --robin y, "
               "fuse_smoother + fuse_transfers vs unfused")
    box_family_fused(launches)
    done(t0)
    family.update(kron_sharded_small(launches))

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
        res[tag] = (np.array(rn) / r0, niter, u,
                    card_l2_error(prob.mesh, 6, u, prob._u_exact),
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
    check_l2(l2_4, "4", "the manufactured solution")
    check_l2(l2_15, "15", "the manufactured solution")
    check_l2(l2_26a, "26a", "the manufactured solution")
    check_l2(l2_27c, "27c", "the manufactured solution")
    check_l2(l2_19a)

    t0 = phase("6. lattice kernel parity vs plain torch")
    ts = time.perf_counter()
    geom6[0].result()
    print(f"    nc=42 p=6 host f64 geometry factors (host thread, started in "
          f"phase 4) joined after {time.perf_counter() - ts:.2f} s of waiting")
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
    print(f"    V-cycle {vc_lb:.3f} ms (lattice_blocked kernels; {VC_CYCLES} "
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
    print(f"    V-cycle {vc_plain:.3f} ms (plain torch lattice; {VC_CYCLES} "
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

    del curved
    t0 = phase(f"17. curved hmg coarse on PerturbedBoxMesh({CURVED_SMALL_NC})"
               " (614,125 dofs), p=(1,3,6), lattice_blocked + hmg, against "
               "lattice_blocked + cg there")
    small, ref28 = curved_small_ref(ccfg)
    curved_hmg(small, ref28["niter"], ref28["vc"], ref28["busy"], ccfg,
               launches)
    done(t0)

    family.update(grid_general_family(small, ref28, launches))
    del small, ref28

    family.update(general_family(box42, launches, curved_ref[1]))
    del box42

    t0 = phase(f"9. curved in-card reference: nc={CURVED_REF_NC[0]}, "
               "lattice (plain) vs lattice_blocked")
    res = {}
    lmax = None
    mesh21 = PerturbedBoxMesh(CURVED_REF_NC)
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

    t0 = phase("27d. sharded time loops at 2,048,383 dofs, p=3: heat CN on "
               "6 slabs and (2,2,2) against heat_fdm_evolve; leapfrog, "
               "Newmark, semilinear and convdiff CNAB on 6 slabs; f32 vs "
               "f64; examples/heat_torch.py --shards 6")
    family.update(sharded_steppers())
    family.update(heat_driver_sharded())
    done(t0)

    t0 = phase("13. curved stepper: heat_pcg_evolve, 195k dofs, p=3")
    curved_stepper()
    print(f"    peak host RSS {peak_rss_gb():.1f} GB")
    done(t0)

    t0 = phase("18b. direct coarse: nc=14, p=(1,3,6), kron_blocked, "
               "coarse=direct vs fdm")
    direct_coarse(cfg)
    done(t0)

    print(f"    peak host RSS {peak_rss_gb():.1f} GB")
    t_new = time.perf_counter()
    t0 = phase("22. DSS operator (ops/unstructured.py): l_shaped_hex_mesh(15) "
               "(2,244,151 dofs) and (29) (16,016,875 dofs), p=6, float32, "
               "against the dofmap apply")
    meshes, dss = {}, {}
    for n in LSHAPE_N:
        ts = time.perf_counter()
        meshes[n], secs = lshape_jobs[n].result()
        print(f"    n={n}: host thread joined after {time.perf_counter() - ts:.2f}"
              " s of waiting")
        dss[n] = dss_apply_phase(meshes[n], secs, f"n={n}")
    done(t0)

    solves, l2_23d, l2_30a = unstructured_solves(meshes[15], meshes[29],
                                                 dss[15])
    family.update(solves)
    t_31 = time.perf_counter()
    family.update(rank_phases(meshes[15], launches))
    print(f"    phase 31 added {time.perf_counter() - t_31:.1f} s")

    t0 = phase("24b. operator='csr' (cuSPARSE) on l_shaped_hex_mesh(4), "
               "p=(1,3), against dss")
    csr_small()
    done(t0)
    check_l2(l2_23d, "23d", "the manufactured solution")
    check_l2(l2_30a, "30a", "the manufactured solution")
    del meshes
    print("    DSS apply (not a TPU kernel; no Pallas kernel on this path): "
          + "; ".join(f"n={n} {r['ms']:.4f} ms, {r['gdofs']:.3f} GDOF/s, "
                      f"{r['kernels']} kernels, bound {r['bound_ms']:.4f} ms"
                      for n, r in dss.items()))
    print(f"    phases 22-24b and 30 added {time.perf_counter() - t_new:.1f} "
          "s (24a and the host threads not counted)")

    t_new = time.perf_counter()
    t0 = phase("25c. semilinear serving: semilinear_packed_evolve at 61^3, "
               "p=6, cnab/be, B=1 (#21) and 8 (#19), cubic and bratu")
    family.update(semilinear_serving(launches))
    done(t0)

    t0 = phase("25d. IMEX stepping at 2.05M dofs, p=3: semilinear_fdm_evolve "
               "and convdiff_fdm_evolve, CNAB, f32 vs f64")
    family.update(imex_2m())
    done(t0)

    t0 = phase("25e. implicit Newton-BE: semilinear_newton_evolve, nc=21, "
               "p=(1,3,6), kron_blocked + fdm, f32 vs f64 kron")
    family.update(newton_be(launches))
    done(t0)

    family.update(early)
    print(f"    phases 25c-25e added {time.perf_counter() - t_new:.1f} s "
          "(25a and 25b not counted; 25f ran during the build)")

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
    # The precision='high' kernels (phase 32a's numbers; ms is device time
    # there, beside the 'highest' kernel's in the same turns).
    for name in HIGH_KERNELS:
        row = high_rows[name]
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on its path")
        lib = ("kron_blocked_high" if name.startswith("t")
               else "lattice_blocked_high")
        kernels.append(
            {"name": name, "route": "cuda",
             "source": SOURCES[name[:-len("_high")]],
             "replaces": HIGH_KERNELS[name], "launches": launches[name],
             "max_abs_err": row["max_abs_err"], "ms": row["ms"],
             "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["bound_by"], "library_ms": None,
             "highest_ms": row["highest_ms"], "gap_to_highest": row["gap"],
             "shape": str(row["shape"]),
             "spilling_kernels_of_library": high_spills[lib],
             **({"by_shape": row["by_shape"]} if "by_shape" in row else {})})
        print(f"    {name}: {row['ms']:.4f} ms device ('highest' "
              f"{row['highest_ms']:.4f}), bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), {row['bound_ms'] / row['ms']:.0%}; "
              f"launches {launches[name]}")
    print("    coefficient, unstructured and model families (FCG(V), ms "
          "per V-cycle; 25a/25e Newton steps, ms per step; 25b BiCGStab "
          "iterations, ms per iteration; 25c/25d steps/s, ms per step; 25f "
          "LOBPCG iterations, s; 27a DistFDM 1, ms per solve; 27d steps, "
          "ms per step): " + "; ".join(
        f"{k} {n:.6g}, " + ("-" if ms is None else f"{ms:.4g}")
        for k, (n, ms) in family.items()))
    print(f"    script seconds: {time.perf_counter() - t_script:.1f}")
    print("    ten longest phases (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(
            PHASE_SECONDS.items(), key=lambda kv: -kv[1])[:10]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
