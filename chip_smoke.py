"""Smoke test of porepy_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit) when it fails:

1. print the card (``nvidia-smi`` name and power limit, and torch's name);
2. build the hand-written kernels from ``porepy_tpu_torch/kernels/csrc``;
3. hold each md kernel against its plain PyTorch version at the md 1/128
   shapes (n = 18,157 rows, K = 9, B = 11 seeds), with CUDA-event times
   over 100 calls.
   Tolerance: |kernel - plain| <= 1e-13 (float64) or 1e-5 (float32) times
   the row's sum of |terms|; K2 (``jacobi_sweeps``: one sweep from a given
   y, eight from y = sinv r in one launch) equal to its plain version;
   K1's launcher (``EllOperator``) and custom
   operator give the same bits, and its epilogue ``c -/+ A x`` the bits of
   the product followed by the torch subtraction or addition. The same for
   the structured (K12) and unstructured (K13) flow-step residuals and
   tangents at 32^3 (32,768 cells, 101,376 faces), in f64 and f32 (K13's,
   one launch a call, to the bit of its plain version), with
   the four residual/tangent kernels' device us by graph replay and K12's
   Newton-step launches (the residual that writes the densities, the
   refinement round ``c - J(p) dx``) against their plain versions and ``-r -
   structured_jvp``, to the bit
   (``applications/benchmarking/structured_refine_check.py``). Inside
   phases 4 and 24 (3c): K1 at md 1/128's Jacobian (f32, B = 1, the
   solve's shape; f64, B = 17) and md 1/256's (f64, B = 17), with and
   without the epilogue, against the plain version; device microseconds a
   launch (a CUDA graph of 100 launches, replayed), host microseconds a
   call of the launcher and of the custom operator in turns, the bound and
   its share, the plain version, ``torch.mv`` on the CSR matrix; and, there
   and inside phases 8 and 12, K3 (``amg_vcycle``, one launch a V-cycle) at
   the final hierarchies of md 1/128, md 1/256, 3d 32^3 and biot 1/64
   (``applications/benchmarking/vcycle_check.py``): equal to its plain
   version in f32 and f64, within 1e-5 (f32) and 1e-12 (f64) of max |y| of
   the composition it replaced (K1 launchers, one-sweep K2 launches,
   ``torch.matmul``), one launch an apply, device microseconds an apply by
   graph replay, host microseconds and CUDA-event ms in turns with the
   composition, the plain version and the bound; and, inside phase 4 (3d),
   K4 (``fgmres_arnoldi``: an FGMRES Arnoldi step, the matvec inside, one
   cooperative launch) at md 1/128's Jacobian, Ruiz-equilibrated as the
   solve runs it, restart 70, f32 and f64
   (``applications/benchmarking/arnoldi_check.py``): every column of a
   cycle equal to its plain version and to its split form (the sharded
   solve's four launches) to the bit, breakdowns (``z = Z[j - 1]``) at
   columns 8, 35 and 69; at columns 0, 8, 35 and 69, in turns with the
   composition it replaced (K1's launcher, the CGS2 GEMVs and copies in
   torch, the K4g custom operator from the parent's source), device
   microseconds a step by graph replay (``j`` reset in the graph), host
   microseconds a call, ms by events, the plain version's ms and the bound
   and its share;
4. run the md case at cell size 1/128 through ``run_time_dependent_model``
   for 26 time steps on the card, with every kernel's launch count reset
   just before and read just after; check 3 fused blocks committed, no host
   fallback solve, every md kernel launched, one ``amg_vcycle`` launch a
   preconditioner apply and one ``fgmres_arnoldi`` launch an apply (no
   ``fgmres_givens``: the K4g launcher is retired), Newton counts a block
   as the parent's (8; Krylov within one a solve of its 64), a finite state, pressure
   within the boundary data's range [0, 1], and the last step re-checked
   on the host with the plain path: its residual, and one more Newton
   increment (a direct solve) within the Newton tolerance; K5 (ms a solve
   by events, the card's busy share of one) and K7 (device us an apply by
   graph replay, host us) at the final Newton system;
5. run md at 1/16 on the card and on the host (plain path) and compare
   the final states (1e-8 max abs);
6. run the 3d case at 32^3 (32,768 dofs) for 26 steps with dense frozen
   block inverses (K6), as porepy_tpu ran it on the TPU: 3 fused blocks,
   no host fallback, dense active and not demoted, every K1/K4/K6 kernel
   launched, a finite state with pressure in [1e5, 2e5] (the boundary data
   and the initial value), and one more host Newton increment <= 1e-10;
   prints setup, dense-build and Gauss-Jordan seconds and per-block times;
7. hold the K6 kernels against their plain versions at the 3d shapes: the
   scatter of the 3d block's pattern (223,232 entries) into a 32,768^2
   matrix, the pivot inverse on a batch of 128 x 128 blocks (one needing
   row swaps, one singular; timed also on one block, the dense build's
   launch, beside ``torch.linalg.inv_ex``: device us by graph replay in
   turns, the kernel's below ``inv_ex``'s), the pivot inverse at b = 1, 7,
   64 and 128 in f32 and f64 on blocks with many equal magnitudes (ties), a
   zero leading entry and a singular block (flags as the plain version's,
   inverses within 4 eps b cond(A) max |X|), the blocked inverse at n =
   4,096 by kernel and plain route (max |S X - I| and the distance between
   the two X), the dense build's Gauss-Jordan at 32^3's size (32,768, 256
   pivots) by both routes in turns (seconds), and the apply with the 3d
   run's own 32,768^2 inverse (with GB/s);
8. the same 3d run with the AMG preconditioner instead (its numbers; 3
   blocks, no fallback);
9. 3d at 1/16 with dense inverses on the card and on the host (plain
   path): final states within 1e-8 of max |p|;
10. the structured flow step (K12) at 32^3 as porepy_tpu's ``structured``
   bench case runs it: 7 chained Newton steps from p = 2e5 (median ms),
   then Newton to |r| < 1e-6 or to the residual's rounding floor, on the
   card and on the host (plain path, 1e-6 abs apart), and the unstructured
   step (K13) on the same problem (1e-4 abs from the structured one). A
   structured step linearizes once (``structured_linearize``), an
   unstructured one writes its residual, Jacobian values and Jacobi
   diagonal in one ``tpfa_step`` launch; each solves by ``FlowCycle`` (two
   cooperative launches a solve): the gates are one residual (it writes the
   densities too) and 3 ``structured_refine`` launches a structured step,
   one ``tpfa_step`` and no ``tpfa_residual``, ``tpfa_linearize`` or
   ``tpfa_jvp`` an unstructured one, no ``structured_jvp``, 2 cycle
   launches a solve, one linearization a structured step, and one host read
   a solve (CUDA's sync debug mode counts them); every K13 mode (residual,
   jvp, linearize, step; f64 and f32) against its plain version and the
   parent's kernels to the bit; the unstructured step's operands at a
   random state (against ``reference.tpfa_step`` too) and 7 chained steps
   in turns with the parent's route (its residual and ``tpfa_linearize`` kernels, built from
   ``parent_tpfa_flow/``, and the torch diagonal;
   ``applications/benchmarking/tpfa_step_check.py``): the same bits, the
   same iteration counts, device and host us, ms a step, the kernels of a
   step; a refinement round and 7
   chained steps in turns with the parent's route (``structured_jvp`` and
   two torch operations a round): the same bits, the same iteration
   counts, device and host us a round, ms a step, and the residual's and
   the refinement's launches a step (5 against 11); then ms per Newton step by
   this route and by the route it replaced (a host BiCGStab loop over the
   jvp launches, ``old_structured_newton_step``/``old_tpfa_newton_step``),
   in turns; 10b. at 32^3, in f32 and f64, for the stencil and for TPFA,
   on phase 10's kernels (the buffers and ``FlowCycle`` their Newton steps
   use), each linearization against its plain version (TPFA's to the bit,
   the stencil's within ``TOL``) and every cycle
   launch of one solve (the start, 1 and 7 iterations, the rest) against
   its plain version from the same state, to the bit; device microseconds
   an iteration (graph replay), host microseconds a launch, the bound
   (``flow_cycle_check.py``);
11. hold the batched interaction-region solve (K10) against its plain
   versions on the chunks that the discretization of the biot 1/64 model
   (MPSA/Biot and MPFA) and of a 3d 16^3 Biot problem build (the largest
   bucket (81, 32, 80) at the chunk size ``max_batch_elements`` gives), on
   a batch with a zero leading entry and on one too large for shared
   memory: the bits of ``region_solve_ordered`` and |kernel - linalg.solve
   plain| <= 1e-12 max |plain| per bucket, with the route (a warp or a
   16 x 16 block a region in registers, shared memory, workspace),
   CUDA-event times of kernel and plain version, the kernel's device us
   (graph replay) and the host-device copies, pageable and pinned;
12. run the biot case at 1/64 (12,288 dofs) for 26 steps, its
   discretization by K10 (``PPT_LOCAL_SOLVE_DEVICE=1`` set just before
   ``prepare_simulation`` and removed after), once with the SA-AMG field
   split (rigid-body modes on u, fixed-stress stabilization) and once with
   dense frozen block inverses: 3 blocks, no host fallback, K10 launched in
   the discretization, the block kernels launched, a finite state and one
   more host Newton increment <= 1e-10; prints setup seconds, the
   discretization seconds by K10 and by host LAPACK, ms per Newton
   iteration and the reference's 567 ms;
13. biot 1/16 (10 steps) and the fractured poromechanics "contact" case
   (``device_gmres``) on the card against the host plain path (1e-8 of
   each field's max; the contact case's AMG and Jacobi blocks launch
   ``amg_vcycle`` and ``jacobi_sweeps``; K2 at the contact case's Jacobi
   block with the case's own count, equal to its plain version, timed for
   the kernels line), and every Biot matrix at 1/64 by
   K10 against the host LAPACK route (1e-12 relative);
14. the Jacobi-Krylov route (K18) on the first Newton system of biot 1/64
   (12,288 dofs): every launch of a BiCGStab solve (one cooperative K18a
   launch, ``bicgstab_cycle``, to start and one that runs every iteration)
   and every GMRES(30) restart (one cooperative K18b launch,
   ``gmres_cycle``) held against its plain version to the bit, whole
   solves by kernels and by the plain iterations (1e-9 of max |x|), two
   launches a BiCGStab solve and one a restart and none of K1, the times of
   one BiCGStab solve's launch (device us an iteration, host us a launch)
   and of one restart; then
   biot 1/64 for 26 steps with ``linear_solver="jax_bicgstab"`` and
   ``"jax_gmres"`` (the host Newton loop): 0 host fallbacks, the K18
   kernels launched (two K18a launches a solve, one K18b launch a restart
   and one a solve, no K1 inside a solve), u and p within 1e-8 of each
   field's largest value of phase 12's AMG run at t = 10, 18, 26, one more
   host Newton increment <= 1e-10; ms per Newton iteration, host assembly
   and solve ms, Krylov iterations per solve;
15. the constant-K flash (K17) at 2048^2 points, nc = 2 and 3, against its
   plain version (V, x, y within 1e-12, equal flags and iteration counts;
   each point stops once its iterate repeats one of its last 8), at nc = 3
   against a plain run of all 150 iterations (V, x, y and the flags to the
   bit), the iterations (mean, the mean over warps of each warp's slowest
   lane, the points at 150), the kernel's time beside the bound at the
   iterations these inputs need, and ``ConstantKFlash.compute_flash`` on
   the card;
16. the table lookup (K16) of a 201 x 201 table at 2048^2 points, inside
   and outside the table, through the table's ``InterpLauncher``: the
   value, four tangents and the dual call (value and tangents), each one
   ``interp_dual`` launch, against the plain versions to the bit, with
   CUDA-event times and device us; then ``tab(p, T)`` in an
   ``EquationSystem`` on a 1024^2 grid, evaluated and assembled on the
   card against the CPU (1e-12), with exactly 2 K16 launches (the
   evaluation, the assembly's dual rule);
17. the batched block inverse (K11) on the interaction-region matrices of
   phase 11 (3,969 blocks of 20 from biot 1/64, 1,374 of 81 from the 3d
   16^3 Biot problem), a batch with a zero leading entry, one of 160 (in
   shared memory) and one of 200 (device workspace): the kernel against its
   plain version (1e-12 of the plain result's largest entry; whether equal),
   max |A X - I| per block within 1e-10 ||A|| ||X|| (max-row-sum norms),
   CUDA-event times of kernel, plain version, ``torch.linalg.inv_ex`` and
   the copies, at (1,374, 81) the copies pageable and pinned in turns; then
   a block-diagonal matrix of sizes 1-12, 20, 81 and 160 through
   ``invert_diagonal_blocks`` on the card (one launch per size) against
   ``method="python"``;
18. the dof-sharded Newton solve (K19) on md 1/128: (a) its first Jacobian
   in the solver's ELL layout split into 4 row shards and into 1 on the
   card, halo plans built in one process, through the shards'
   ``HaloOperator`` launchers (``halo_interior``: the send buffer and the
   interior rows; ``halo_boundary``: the boundary rows after the
   exchange), in f64 and f32: each launch equal to its plain version to the
   bit, the shards equal to K1's global product and to the two-launch
   route they replaced (``applications/benchmarking/halo_spmv_check.py``,
   the older source beside it), halo sizes with and without the spatial dof
   permutation; per shard call in f32, in turns, host us a call, device us
   by graph replay, ms by events and launches a matvec of the launcher, the
   two-launch route and ``index_select`` + ``torch.mv`` on the shard's CSR
   (at 1 shard K1's launcher too), each launch alone against its plain
   version and the bounds; (b) ``ShardedNewton`` in a one-rank NCCL group
   (a ``FileStore`` in a temporary directory): ``solve_once`` three times
   beside the unsharded solve of the same system (increments equal to the
   bit), one time step by ``step()`` to the Newton tolerance against the
   unsharded Newton loop (1e-10), 0 host fallbacks, one ``halo_interior``
   launch a matvec and no ``halo_boundary`` launch, K1 and K3 launched in
   the preconditioner; (c) the first K10 chunk of biot 1/64 through
   ``set_batch_mesh`` against the unsharded route (1e-12);
19. hold the upstream-selection kernel (K15: ``upwind_dual``, counted as
   ``upwind_flux`` and ``upwind_select``) through its entry points at the
   tracer 1/64 shapes (about 8,600 faces, 4,400 cells, 16 seeds, faces with
   ``q = 0.0`` and ``-0.0`` among them) and at every call the dual rules
   make in one assembly of md 1/128 and of tracer 1/64 (one launch a call,
   the value and every tangent, the interface rule's product inside; equal
   to the plain version and to a second launch to the bit; device us by
   graph replay, host us a call and the bound at each kind's first call;
   the kernels line takes tracer 1/64's calls), the
   one-launch differentiable-TPFA op (K14: ``tpfa_ad_dual``, the value and
   every tangent of the flux or the trace in one launch) at ``DarcysLawAd``
   1/128's own calls of one assembly (both subdomains, flux and trace, the
   seeds the dual rule hands it: 33,088 faces, 65,536 half-faces) and at
   the 3d 32^3 shapes (32,768 cells, 101,376 faces, 196,608 half-faces,
   full tensors, 16 seeds of every input), and ``segment_sum_sorted`` at
   32^3 against their plain versions on the card: values and tangents
   within 1e-12 of the plain result's largest entry, the same bits from two
   launches, the trace's faces outside its boundary list exactly 0 in
   every row, CUDA-event times, the bound, K14's and ``upwind_flux``'s
   device microseconds by graph replay and K14's host microseconds a call
   (at both shapes; the kernels line takes 1/128's matrix subdomain), and
   the time of ``torch.where`` + ``index_select`` and of ``index_add_`` for
   the two that one PyTorch call matches, also as device microseconds by
   graph replay, kernel and library call in turns;
20. run the tracer case for 26 steps of 60 s, at 1/32 (2,246 dofs) with
   the AMG preconditioner and at 1/64 (8,710 dofs) with dense frozen block
   inverses: 3 fused
   blocks, no host fallback, the K15 kernels launched (at 1/32 also
   ``amg_vcycle``; its Jacobi count frozen at 1 is ``sinv r`` alone, no
   ``jacobi_sweeps`` launch), ``pressure`` and
   ``z_tracer`` within 1e-8 of each field's largest value of the same case
   run on the host (plain path), one more host Newton increment within
   the case's Newton tolerance, ``z_tracer`` in [0, 0.2]; ms per Newton
   iteration beside the reference's 132 ms, the time steps outside the
   blocks with their Krylov counts, and one assembly at the final state
   through the kernels and through their plain versions, in turns; then
   K2 on the Jacobi block of 1/64's AMG field split at its final Jacobian
   (``vcycle_check.check_sweeps``): s = 1, 2, 8, 40, each launch equal to
   its plain version, timed beside s one-sweep launches;
21. run the differentiable-permeability flow model of
   ``tests/models/test_darcys_law_ad.py`` at md width: ``DarcysLawAd`` +
   cubic-law fracture permeability + ``k(p) = k0 (1 + 0.3 p)`` over
   single-phase flow with TPFA, one fracture, cell size 1/128 (16,384 +
   128 cells), 26 steps, the md case's solver parameters, its TPFA
   discretization on the card (``PPT_LOCAL_SOLVE_DEVICE=1``, so the
   transmissibilities' sums run in ``segment_sum_sorted``): 3 fused blocks,
   no host fallback, the K14 flux and trace each launched exactly once a
   subdomain an assembly (2 x 32 each), the Jacobian at the first
   iterate and the final pressure against the same model on the host
   (plain path; 1e-10 and 1e-8 of the largest entry), one more host Newton
   increment <= 1e-10, and the assembly in turns as in phase 20;
22. hold the kernels of the hand-written forward-mode assembly (K8:
   ``dual_ew``, ``dual_gather``, and ``dual_ew_scatter``, each equation's
   root writing its nonzeros and right-hand side rows) against their plain
   versions at the md 1/128 shapes (18,157 unknowns, 16,969 cells, 16 seeds):
   values and tangents within 1e-13 of the largest entry
   (the gathers equal), the same bits from two launches, CUDA-event times,
   the bound (bytes read once and written once over 3.35 TB/s); md 1/128's
   own roots (inside phase 4) against their plain version to the bit and
   against the parent's route (the roots in ``dual_ew``'s row layout, then
   the parent's ``jac_gather``, built from
   ``applications/benchmarking/parent_jac_gather/``), device us by graph
   replay and host us in turns; the two
   gathers through their per-step launchers (``DualGatherVar``: tangent
   rows written once, then the value row alone; ``DualGatherCopy``), through
   the functional wrappers and by ``index_select`` x2 + ``cat`` in turns,
   and the launchers' host us a call; ``dual_ew`` through its launcher
   (``DualEwLauncher``) at phase 22's program: device us by graph replay,
   host us a call, the functional ``ops.dual_ew`` equal to it, and one
   program a family of opcodes (every opcode) within 1e-13 of the plain
   version, the same bits twice; and at every case's own shapes
   (md 1/256 included), inside its phase: every call of a K8 wrapper in one
   assembly and one residual of the case, with the programs and gather
   indices of its compiled equations, is repeated through the plain version
   on the same inputs (1e-13 of the largest entry, NaN in the same places;
   md 1/128's root scatters to the bit), and one assembly and residual by
   the parent's route, to the bit, with the assembly in turns (least and
   median of 20, host us) and the launches of one assembly by route (md
   1/128, md 1/256, tracer 1/64, biot 1/64, ``DarcysLawAd`` 1/128, 3d 32^3);
   at md 1/128 the 59 ``dual_ew`` calls of one assembly are printed as a
   histogram of (instructions, inputs, n, B) with the most slots a tape
   needs, and their device us (graph replay) and host us summed.
   In phase 13 the contact case's residual must launch ``dual_ew`` as often
   as its assembly does;
23. the assembly in turns (functorch, dual, dual, functorch: the K8 pass of
   ``numerics/ad/forward.py`` against ``torch.func`` over the traced
   residual, its plain version) at the final state of md 1/128, 3d 32^3, biot
   1/64, tracer 1/64, ``DarcysLawAd`` 1/128, thm 1/16 and berre3d, inside
   their phases: both
   results within 1e-12 of the largest entry, median ms of each turn, the
   launches of one assembly by kernel, and the nodes without a dual rule per
   equation, which must be 0 (md 1/128: 107 launches an assembly, 59 of them
   ``dual_ew`` and 2 root scatters, 3 of K15, one a rule; tracer 1/64: 6 of
   K15; one root scatter an equation, no ``jac_gather``), and each route's
   difference from the functorch route, the parent's and this one's, which
   must not grow; for tracer and
   ``DarcysLawAd`` phase 20's and 21's turns now time the dual route through
   the K15/K14 kernels against the same route through their plain versions,
   and ``DarcysLawAd``'s functorch assembly is timed with its K14 launchers
   found by the geometry tensors' pointers and bound a call, in turns;
24. run md at cell size 1/256 (the case ``cases.build_case("md256")`` makes; AMG,
   as the system is above the dense limit) for 26 steps: 3 fused blocks, 0
   host fallbacks, every md and K8 kernel launched, pressure in [0, 1], one
   more host Newton increment <= 1e-10, and the final state within 1e-8 of
   the same run through the functorch route; setup seconds, Newton and
   Krylov counts, ms per Newton iteration of both;
25. run the thm case (``cases.build_thm_contact_3d``: 3d thermoporomechanics
   with frictional contact, four fractures, 25,120 dofs at 1/16) for its 10
   steps of 1.0 (``THM_STEPS``), discretized and rediscretized by K10:
   every Newton iteration rediscretizes the fracture MPFA, so the host
   Newton loop runs, each iteration assembled by the K8 pass and solved on
   the card with dense frozen block inverses (K6). Gates: 25,120 dofs, 0
   host fallbacks, every sweep block dense (none demoted; the pivots' fate
   printed: the contact block is built in its sparse LU's row order), the
   K1, K4, K6, K8, K10 and K15 kernels launched, all eight fields finite,
   one more Newton iteration by the plain route (rediscretized by host
   LAPACK, assembled by ``torch.func`` with every kernel's plain version and
   no launch, a dense f64 LU solve on the card) below the Newton tolerance
   1e-10. Prints the field split,
   each step's seconds, Newton and Krylov counts, ms per Newton iteration
   (the run's wall time over its Newton iterations) split into the
   rediscretization, the assembly, the solve (the preconditioner's builds
   apart) and the host bookkeeping, the launches of the run and of one
   assembly, beside the reference's 54,683 ms. Then phase 23 at thm's
   final state (the median of 2 assemblies a turn, not 5: functorch takes
   ~3.5 s an assembly; the K8 pass against the functorch route, every K8 call of
   an assembly against its plain version, no node without a dual rule);
   (d) every K15 call of
   one assembly, one launch each, to the bit of its plain version; (c) the
   discretization by host LAPACK and by K10 in turns (every matrix within
   1e-12 of the host's largest entry), every region bucket's first chunk
   through the kernel to the bits of ``region_solve_ordered``, with device
   us at (81, 64, 112), and one Newton iteration's rediscretization by both
   routes in turns; (b) thm 1/4 (664 dofs, 2 steps) on the card against the
   host plain path, all eight fields within 1e-8 of each field's max;
26. run Berre et al. 3d case 2 (``cases.build_berre3d``: md flow on the
   native 16^3 tet lattice, 31,578 dofs in 106 subdomains) for its 10 steps
   (``BERRE3D_STEPS``): 2 blocks of 4 steps committed, 0 host fallbacks,
   the md kernels and K8 launched, a finite state, one more Newton
   increment (assembled by ``torch.func`` with every kernel's plain version
   and no launch, a dense f64 LU solve on the card) below 1e-10, and phase
   23 at the final state; prints setup seconds (grid, prepare, discretization, the
   equations' compile and first assembly, the preconditioner's builds),
   Newton and Krylov counts per block, ms per Newton iteration in the blocks
   beside the reference's 98,254 ms, the launches of one assembly and its
   ms; then (b) the 8^3 lattice (5,136 dofs, 4 steps, one 2-step block) on
   the card against the host plain path, pressure and mortar fluxes within
   1e-8 of each field's max;
27. run Flemisch et al. (2018) 2d case 4 (``cases.build_flow_benchmark_2d_case_4``:
   the published 63 fractures on 700 m x 600 m, the native simplex mesh at
   5 m, 43,790 dofs in 149 subdomains and 233 interfaces; the example's
   one step, the host Newton loop, the pressure block above the dense limit
   on AMG): the size, 0 host fallbacks, the field split's AMG and
   elimination kept (no block demoted), at least one
   preconditioner build, the md kernels, K8 and K15 launched, a finite
   state with pressure within the boundary data's [1e6, 4e6], and one more
   Newton increment by the plain route (a dense f64 LU on the card, 15.3
   GB) within ``FB2D4_INCREMENT_TOL``; prints the setup split (mesh,
   prepare, discretization, compile and first assembly, the
   preconditioner's builds), the field split, the largest K of a K1
   matrix, Newton and Krylov counts and ms per Newton iteration, the
   launches of one assembly and its median ms of 5, phase 23 at the final
   state and K5/K7 re-timed at the final system; 3c at its final state: K1
   at its Jacobian (f64, B = 17, and f32, B = 1, as at md 1/128) and K3 at
   every hierarchy of its solver (the pressure block's, levels with rows
   up to 2,435 wide), each against its plain version; then (b) case 4 at
   20 m (4,594 dofs) on the card against the host plain path (the same
   ``device_gmres`` route on the CPU), pressure and mortar fluxes within
   ``FB2D4_FIELD_TOL`` of each field's max.

28. run Berre et al. (2021) 3d case 3 (``cases.build_flow_benchmark_3d_case_3``:
   eight fractures on the native cut-tet mesh at refinement 0, 47,900 dofs
   in 16 subdomains, TPFA, the example's one step on the host Newton loop)
   with the gates and prints of phase 27 and the benchmark's inflow, outlet
   and Table 5 checks; then (b) the (6, 14, 6) lattice on the card against
   the host plain path;
29. the Terzaghi and Mandel verification examples on the card by
   ``device_gmres`` against their analytical solutions and the host plain
   path, and the sliding-contact model of ``tests/numerics/test_solvers.py``
   at 1/32 by plain Newton and by the constraint line search (the tractions
   within 1e-10 of each other, plain Newton's within ``CONTACT_HOST_TOL`` of
   the host's);
30. run the fracture damage example (``cases.build_fracture_damage``: one
   sheared fracture, friction and dilation decaying with the damage
   history, the anisotropic history equation, 3 steps) at 1/128 (33,216
   dofs) on the card by ``device_gmres`` with dense block inverses: 0 host
   fallbacks, the route printed (the field split, which blocks are dense,
   whether each step's Newton loop ran fused on the device), the K1, K4, K8
   and K6 (or K3) kernels launched, the history >= 0 and non-decreasing in
   every cell from step to step, the damage factors and the damaged
   friction bound and dilation gap equal (1e-12) to ``1 + (d0 - 1) exp(-c
   h)`` from numpy (times the intact value), no node of the last step's
   system without a dual rule, and no compiled system, solver or dense
   inverse of a step outliving the next step (the history equation is
   replaced every step, so each step compiles its system and builds its
   solver anew); each step's seconds (the history equation's update, the
   compile, the Newton loop) and ms per Newton iteration; then (b) 1/32 on
   the card against the host plain path (``HOST_RUNS``): the history, the
   tractions and the displacements within ``DAMAGE_HOST_TOL`` of each
   field's largest value, and (c) the isotropic history equation at 1/32 on
   the card;
31. conforming fracture propagation under tension (the model of
   ``tests/numerics/test_propagation.py``, ``_TensionPropagation`` in
   :func:`propagation_case`) on a 64 x 64 grid on the card, 4 steps of
   critical SIFs 1e-4 by ``device_gmres`` with dense block inverses: at
   every step the fracture grows, the growing tips' mode-I SIFs are at
   least the critical value and the largest is > 0, the rebuilt system has
   a dual rule at every node, nothing of the topology before a rebuild
   (compiled system, solver, dense inverses) outlives the next step's
   solve, the card's allocated bytes after each rebuild stay within 2 MiB
   of the first's and the compiler's device constants do not grow; the
   seconds of each rebuild and compile; then (b) 16
   x 16 on the card against the host plain path (``HOST_RUNS``): the opened
   host faces and the fracture's cells equal at every step, the tip SIFs
   within ``PROPAGATION_SIF_TOL``.

Phases 25, 26 and 27 alone, on a card: ``python3 -c "import torch, chip_smoke as c;
d = c.build_kernels(); c.bench_summary(c.bench_cases(torch.device('cuda'), 10,
10), '')"`` (``None`` for a phase's steps leaves it out).

The host plain-path runs of phases 26b, 27b, 28b, 30b, 31b and 20
(``HOST_RUNS``) need no card: they run in two worker processes that see no
CUDA device, started after phase 22, the last phase whose times go into the
kernels line, and running beside phases 21 and 24-31 (phase 20 runs last);
each phase waits for its own. All fused runs (phases 4-21) assemble through the K8 pass. The line before
the last is a JSON object with one entry per kernel (ms,
plain ms, the bound and what sets it, the time of one PyTorch call of the
same function where there is one); the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA card, or
without the rest of the repository beside it, the script exits non-zero
before printing either.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from porepy_tpu_torch.applications.benchmarking.cases import local_solves as _local_solves
from porepy_tpu_torch.applications.benchmarking.timing import cuda_ms as _cuda_ms
from porepy_tpu_torch.applications.benchmarking.timing import graph_us as _graph_us
from porepy_tpu_torch.applications.benchmarking.timing import host_us as _host_us

N_ROWS, K_ELL, N_SEEDS, RESTART = 18157, 9, 11, 70
TOL = {torch.float64: 1e-13, torch.float32: 1e-5}
MD_KERNELS = ("ell_spmv", "amg_vcycle", "fgmres_arnoldi")
# Newton / Krylov iterations a fused block of md 1/128 and md 1/256 on the
# route before the one-launch Arnoldi step (every block of the chip runs
# recorded in PERF.md): this route keeps the Newton counts and moves a
# solve's Krylov count by at most one.
PARENT_BLOCKS = {"": (8, 64), "md256": (8, 72)}
K8_KERNELS = ("dual_ew", "dual_gather", "dual_ew_scatter")
# The parents' kernels of the yardsticks (built once, in main).
_PARENT: dict = {}
DENSE_KERNELS = ("dense_block_scatter", "gj_pivot_inverse", "dense_block_apply")
N3D = 32
# The least time of a kernel's work: its bytes (each input read once, each
# output written once) over the H100's 3.35 TB/s, or its operations over the
# card's peak for the type outside the tensor cores, which none of these
# kernels use: 67 TFLOP/s in f32, 34 TFLOP/s in f64 (NVIDIA's H100 SXM data
# sheet).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def _bound(nbytes: float, flops: float, dtype=torch.float64) -> tuple[float, str]:
    """``(bound_ms, bound_by)`` of work in ``dtype`` that moves ``nbytes``
    and does ``flops`` operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _csr_of_ell(val, col):
    """The ELL matrix ``(val, col)`` as a torch sparse CSR tensor (the
    yardstick's operand)."""
    n, n_cols = val.shape[0], val.shape[0]
    real = col < n_cols
    crow = torch.zeros(n + 1, dtype=torch.int64, device=val.device)
    crow[1:] = torch.cumsum(real.sum(1), 0)
    return torch.sparse_csr_tensor(crow, col[real].long(), val[real], size=(n, n_cols))


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _check(name, err, bound):
    ok = bool(torch.all(err <= bound))
    worst = float(err.max())
    print(f"  {name}: max |err| {worst:.3e}, within bound: {ok}")
    _require(ok, f"{name} disagrees with its plain version")
    return worst


def _ell_operator(gen, dtype, dev):
    val = torch.randn(N_ROWS, K_ELL, generator=gen, dtype=torch.float64).to(dtype)
    col = torch.randint(0, N_ROWS, (N_ROWS, K_ELL), generator=gen, dtype=torch.int32)
    # Padded rows, as the ELL layout of the md Jacobian has: padding slots
    # point at column n and carry zero values.
    pad = torch.rand(N_ROWS, K_ELL, generator=gen) < 0.1
    col[pad] = N_ROWS
    val[pad] = 0
    return val.to(dev), col.to(dev)


def check_kernels(dev) -> dict:
    from porepy_tpu_torch.kernels import ops, reference

    gen = torch.Generator().manual_seed(0)
    report = {}

    print("phase 3: kernels against their plain versions")
    k1 = {"err": 0.0}
    for dtype in (torch.float32, torch.float64):
        val, col = _ell_operator(gen, dtype, dev)
        op = ops.EllOperator(val, col)
        for batch in (None, N_SEEDS):
            shape = (N_ROWS,) if batch is None else (batch, N_ROWS)
            x = torch.randn(shape, generator=gen, dtype=torch.float64).to(dtype).to(dev)
            c = torch.randn(shape, generator=gen, dtype=torch.float64).to(dtype).to(dev)
            y = op(x)
            y_ref = reference.ell_spmv(val, col, x)
            rowsum = reference.ell_spmv(val.abs(), col, x.abs())
            tag = f"ell_spmv {str(dtype)[6:]} x{list(shape)}"
            k1["err"] = max(k1["err"], _check(tag, (y - y_ref).abs(), TOL[dtype] * rowsum))
            # The custom operator (the torch.func route) launches the same
            # kernel; the epilogue equals the product and the torch operation.
            _require(torch.equal(ops.ell_spmv(val, col, x), y), f"{tag}: custom operator and launcher differ")
            for sign in (-1, 1):
                fused = op(x, c=c, sign=sign)
                _require(torch.equal(fused, c - y if sign < 0 else c + y),
                         f"{tag}: the epilogue with sign {sign} differs from the two operations")
                want = c - y_ref if sign < 0 else c + y_ref
                k1["err"] = max(k1["err"], _check(f"{tag}, c {'-' if sign < 0 else '+'} A x",
                                                  (fused - want).abs(), TOL[dtype] * (rowsum + c.abs())))
            ms = _cuda_ms(lambda: op(x))
            plain_ms = _cuda_ms(lambda: reference.ell_spmv(val, col, x))
            print(f"    {ms:.4f} ms kernel, {plain_ms:.4f} ms plain")
    report["ell_spmv"] = k1

    # K2 at the md shapes: one sweep from a given y (``ell_jacobi_sweep``'s
    # form) and 8 from y = sinv r in one launch, each the bits of its plain
    # version.
    k2 = {"err": 0.0}
    for dtype in (torch.float32, torch.float64):
        val, col = _ell_operator(gen, dtype, dev)
        sinv, r, y = (
            torch.randn(N_ROWS, generator=gen, dtype=torch.float64).to(dtype).to(dev)
            for _ in range(3)
        )
        sinv *= 0.5 / (val.abs().sum(1) + 1.0)
        for s, y0 in ((1, y), (8, None)):
            out = ops.JacobiSweeps(val, col, sinv)(r, s, y0)
            same = torch.equal(out, reference.jacobi_sweeps(val, col, sinv, r, y0, s))
            print(f"  jacobi_sweeps {str(dtype)[6:]}, s = {s} from {'y' if s == 1 else 'sinv r'}: equal to "
                  f"the plain version: {same}")
            _require(same, f"jacobi_sweeps (s = {s}, {dtype}) differs from its plain version")
    report["jacobi_sweeps"] = k2

    return report


def _model_jacobian_ell(model):
    """The model's Jacobian at its final state in its device solver's ELL
    layout (float64 values, int32 columns), as each solve gathers it."""
    eq_sys = model.equation_system
    data = eq_sys.compiled_system().assemble(eq_sys)[0]
    solver = next(iter(model._device_solvers.values()))
    data_p = torch.cat([data, data.new_zeros(1)])
    return data_p[solver._ell_sel].contiguous(), solver._ell_col, solver


def check_k1_at(label: str, val, col, batch: int, seed: int) -> dict:
    """Phase 3 at one of the main path's own matrices: K1 (``EllOperator``)
    against its plain version, its epilogue ``c - A x`` against the kernel's
    product and the torch subtraction (the same bits), and its times: device
    microseconds per launch (a CUDA graph of 100 launches, replayed), host
    microseconds per call (back-to-back calls, no synchronization) of the
    launcher and of the custom operator in turns, ms per call over
    back-to-back calls (CUDA events) of the kernel, the plain version and one
    PyTorch call on the same matrix in CSR (``torch.mv`` or ``@``), the bound
    and the share of it the device time reaches. The bound counts the work
    the product needs: each nonzero's value and column, ``x`` and the output
    (and ``c``) once; the padded ELL slots that the kernel also reads are
    printed beside it as the layout's bound, not counted."""
    from porepy_tpu_torch.kernels import ops, reference

    gen = torch.Generator().manual_seed(seed)
    n, K = val.shape
    dtype = val.dtype
    shape = (n,) if batch == 1 else (batch, n)
    x = torch.randn(shape, generator=gen, dtype=torch.float64).to(dtype).to(val.device)
    c = torch.randn(shape, generator=gen, dtype=torch.float64).to(dtype).to(val.device)
    op = ops.EllOperator(val, col)
    y, y_ref = op(x), reference.ell_spmv(val, col, x)
    rowsum = reference.ell_spmv(val.abs(), col, x.abs())
    tag = f"ell_spmv at {label}, {str(dtype)[6:]}, B = {batch}"
    err = _check(tag, (y - y_ref).abs(), TOL[dtype] * rowsum)
    fused = op(x, c=c, sign=-1)
    _require(torch.equal(fused, c - y), f"{tag}: the epilogue differs from the two operations")
    err = max(err, _check(f"{tag}, c - A x", (fused - (c - y_ref)).abs(), TOL[dtype] * (rowsum + c.abs())))
    nnz = int((col < n).sum())
    size = torch.finfo(dtype).bits // 8
    out = {"err": err, "K": K, "n": n, "nnz": nnz}
    for epi in (False, True):
        call = (lambda: op(x, c=c, sign=-1)) if epi else (lambda: op(x))
        vectors = batch * n * size * (3 if epi else 2)
        flops = 2 * nnz * batch + (batch * n if epi else 0)
        bound_ms, bound_by = _bound(nnz * (size + 4) + vectors, flops, dtype)
        layout_ms, _ = _bound(n * K * (size + 4) + vectors, flops, dtype)
        dev_us = _graph_us(call)
        host = {"launcher": [], "custom op": []}
        routes = ("launcher", "custom op", "custom op", "launcher") if not epi else ("launcher", "launcher")
        for route in routes:
            fn = call if route == "launcher" else (lambda: ops.ell_spmv(val, col, x))
            host[route].append(_host_us(fn))
        key = "epilogue" if epi else "product"
        out[key] = {"device_us": dev_us, "host_us": host, "bound_ms": bound_ms, "bound_by": bound_by,
                    "layout_ms": layout_ms, "ms": _cuda_ms(call), "share": 1e3 * bound_ms / dev_us}
        print(f"    {tag}{' with c - A x' if epi else ''}: device {dev_us:.2f} us a launch (graph replay), "
              f"host us a call {host}, {out[key]['ms']:.4f} ms a call back to back; bound "
              f"{1e3 * bound_ms:.2f} us ({bound_by}, the nonzeros), device time at {100 * out[key]['share']:.1f}% "
              f"of it; the ELL layout's bound (every padded slot) {1e3 * layout_ms:.2f} us")
    out["plain_ms"] = _cuda_ms(lambda: reference.ell_spmv(val, col, x), 20)
    csr = _csr_of_ell(val, col)
    library = (lambda: torch.mv(csr, x)) if batch == 1 else (lambda: csr @ x.T)
    out["library_ms"] = _cuda_ms(library)
    print(f"    {tag}: n {n}, K {K}, nnz {nnz}; plain {out['plain_ms']:.4f} ms, "
          f"{'torch.mv' if batch == 1 else 'csr @ x.T'} on the CSR matrix {out['library_ms']:.4f} ms")
    return out


def vcycle_times(solver, label: str) -> dict:
    """K3 at every AMG hierarchy of the solver (its final state):
    ``vcycle_check.check`` (the kernel to the bit against its plain
    version in f32 and f64, against the composition it replaced, one launch
    an apply, times in turns with the composition, the bound); the largest
    hierarchy's numbers, each hierarchy's under ``"all"``."""
    from porepy_tpu_torch.applications.benchmarking import vcycle_check

    runs = [vcycle_check.check(hier, f"{label}, block {i}") for i, hier in sorted(solver._hierarchies.items())]
    out = dict(max(runs, key=lambda r: r["levels"][0]))
    out["all"] = runs
    return out


def largest_ell_k(model) -> int:
    """The largest K of any K1 matrix of the model's device solver: its
    Jacobian layout, the eliminations and couplings, every AMG level."""
    solver = next(iter(model._device_solvers.values()))
    ks = [solver._ell_col.shape[1]]
    state = solver._m_state or {}
    for group in ("dinv", "cpl"):
        ks += [col.shape[1] for _val, col in state.get(group, {}).values()]
    for hier in (solver._hierarchies or {}).values():
        ks += [lv[m + "_col"].shape[1] for lv in hier.state["levels"] for m in "APR"]
    for jb in state.get("jac", {}).values():
        ks.append(jb["col"].shape[1])
    return max(ks)


def last_step_check(model, device: str = "cpu") -> tuple[float, float]:
    """The last time step re-checked with the plain path: the md equations
    at the final state ``x_26`` with the previous-step state ``x_25`` of
    the last block. Returns ``|F| / sqrt(n)`` and the norm ``|dx| /
    sqrt(n)`` of one more Newton increment, ``J dx = -F``. The assembly runs
    on ``device`` by the plain route (:func:`_plain_assembly`: ``torch.func``
    over the traced residuals, every kernel's plain version, no launch);
    on the host CPU (``device="cpu"``) scipy solves directly, on a card a
    dense f64 LU (:func:`_dense_increment`). A model that ran no fused
    block (the host Newton loop) is assembled at its final state with the
    committed state as the previous one: the last step's system where the
    residual does not depend on the previous state (an incompressible
    fluid's, as fb2d4's)."""
    import scipy.sparse as sps
    import scipy.sparse.linalg as spla

    from porepy_tpu_torch.numerics.ad import compiler

    eq_sys = model.equation_system
    cs = eq_sys.compiled_system()
    data, vals = [], []
    if getattr(model, "_last_block_states", None) is None:
        with _plain_assembly():
            J, rhs = (t.cpu().numpy() for t in cs.assemble(eq_sys))
        data, vals = [J], [-rhs]
    else:
        subst = model._fused_block_substitution(cs)
        x_prev, x_last = (t.to(device) for t in model._last_block_states[-2:])
        with _plain_assembly():
            for ce, smap in zip(cs.ces, subst):
                env = ce.env_spec.fetch(eq_sys, device=device)
                env = [x_prev[smap[i][0] : smap[i][1]] if i in smap else e for i, e in enumerate(env)]
                seeds = torch.tensor(ce.seeds, dtype=torch.float64, device=device)
                val, compressed = compiler.colored_jvps(ce.fn, x_last, env, seeds)
                data.append(compressed.cpu().numpy()[ce.gather_color, ce.rows])
                vals.append(val.cpu().numpy())
    F = np.concatenate(vals)
    sqrt_n = np.sqrt(F.size)
    if device != "cpu":
        return float(np.linalg.norm(F) / sqrt_n), _dense_increment(cs.indices_np, np.concatenate(data), -F, device)
    rows, cols = cs.indices_np[:, 0], cs.indices_np[:, 1]
    J = sps.csr_matrix((np.concatenate(data), (rows, cols)), shape=cs.shape)
    dx = spla.spsolve(J.tocsc(), -F)
    return float(np.linalg.norm(F) / sqrt_n), float(np.linalg.norm(dx) / sqrt_n)


def _dense_increment(indices, data, b, device) -> float:
    """``|dx| / sqrt(n)`` of ``J dx = b`` for the square COO matrix
    ``(indices, data)`` (duplicates summed), by a dense f64 LU with partial
    pivoting on ``device`` (``torch.linalg.solve``): a direct solve of the
    Newton system that shares nothing with the Krylov path, where scipy's
    sparse LU of thm's Jacobian is slow (``PERF.md`` §6)."""
    n = b.size
    J = torch.zeros(n, n, dtype=torch.float64, device=device)
    idx = torch.as_tensor(np.ascontiguousarray(indices), device=device)
    J.index_put_((idx[:, 0], idx[:, 1]), torch.as_tensor(data, dtype=torch.float64, device=device), accumulate=True)
    dx = torch.linalg.solve(J, torch.as_tensor(b, dtype=torch.float64, device=device))
    del J
    torch.cuda.empty_cache()
    return float(torch.linalg.vector_norm(dx)) / np.sqrt(n)


def timed_model(base, dev):
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    class Timed(base):
        """The md model with a wall clock around each fused block
        (synchronized with the card when it runs on ``dev``, a CUDA device),
        keeping the last block's states for the residual check."""

        def fused_time_block(self, n_steps, nl_params):
            sync()
            tic = time.perf_counter()
            n = super().fused_time_block(n_steps, nl_params)
            sync()
            if n:
                self.block_log.append((time.perf_counter() - tic, dict(self._ftb_last)))
                # The state at the end of each block, by its time.
                self.block_states[self.time_manager.time] = self.equation_system.get_variable_values(
                    time_step_index=0
                )
            return n

        def _build_fused_time_block(self, *args, **kwargs):
            block = super()._build_fused_time_block(*args, **kwargs)

            def keep_states(*a):
                out = block(*a)
                self._last_block_states = out[0]
                return out

            return keep_states

    return Timed


def retime_solver(model, label: str, repeats: int = 10) -> dict:
    """K5 and K7 re-timed at the model's final Newton system (their times
    dated from PRs 1-2): ms a K5 solve (``solve_device``, CUDA events over
    ``repeats`` solves, and the host clock), the card's busy share of one
    solve (``torch.profiler``'s device time over the host clock), and a K7
    apply (the block preconditioner on an f32 vector, as the solve calls it):
    device us by graph replay, host us a call, ms by events."""
    from torch.profiler import ProfilerActivity, profile

    eq_sys = model.equation_system
    data, rhs = eq_sys.compiled_system().assemble(eq_sys)
    solver = next(iter(model._device_solvers.values()))
    solver.solve_device(data, rhs)
    solve_ms = _cuda_ms(lambda: solver.solve_device(data, rhs), repeats=repeats)
    iters = solver.last_stats["krylov_iters"]
    walls = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        solver.solve_device(data, rhs)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - tic))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        tic = time.perf_counter()
        solver.solve_device(data, rhs)
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - tic)
    device_ms = 1e-3 * sum(
        getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)) for e in prof.key_averages()
    )
    r = torch.randn(solver.n, generator=torch.Generator().manual_seed(5), dtype=torch.float64).to(
        torch.float32).to(data.device)

    def apply():
        return solver._m_apply(solver._m_state, r)

    out = {
        "solve_ms": solve_ms, "solve_wall_ms": [float(np.min(walls)), float(np.median(walls))],
        "krylov_iters": iters, "busy_ms": device_ms, "traced_ms": traced_ms,
        "apply_device_us": _graph_us(apply, mode="relaxed"), "apply_host_us": _host_us(apply),
        "apply_ms": _cuda_ms(apply),
    }
    print(f"  K5 at {label}'s final Newton system: {out['solve_ms']:.3f} ms a solve by events ({iters} Krylov "
          f"iterations), host clock least / median {out['solve_wall_ms']}; the card busy {device_ms:.3f} ms of a "
          f"traced solve's {traced_ms:.3f} ms; K7, an apply: device {out['apply_device_us']:.2f} us (graph replay), "
          f"host {out['apply_host_us']:.2f} us a call, {out['apply_ms']:.4f} ms by events")
    return out


def run_md(dev, cell_size: float = 1.0 / 128, case: str = "", functorch: bool = False) -> dict:
    """Phase 4: md at ``cell_size``; phase 24 with ``case="md256"`` (class
    and parameters as ``cases.build_case`` takes them), once more through the
    functorch route with ``functorch=True``."""
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.applications.benchmarking.cases import CASE_BUILDERS, build_md_flow
    from porepy_tpu_torch.kernels import LAUNCHES, reset_launches
    from porepy_tpu_torch.numerics.linalg.krylov import FALLBACK_COUNTER

    if case:
        Model, params = CASE_BUILDERS[case]()
        cell_size = params["meshing_arguments"]["cell_size"]
        route = "functorch route" if functorch else "dual route"
        print(f"phase 24: {case} (md at cell size {cell_size:g}), 26 steps on {dev}, {route}")
    else:
        print(f"phase 4: md at cell size {cell_size:g}, 26 steps on {dev}")
        Model, params = build_md_flow(cell_size, device=str(dev))
    model = timed_model(Model, dev)(params)
    model.block_log = []
    model.block_states = {}
    fallbacks0 = FALLBACK_COUNTER["count"]
    reset_launches()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    model.prepare_simulation()
    model._prepared = True
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - tic
    tic = time.perf_counter()
    with (_functorch_route() if functorch else contextlib.nullcontext()):
        pt.run_time_dependent_model(model, params)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - tic
    launches = dict(LAUNCHES)

    eq_sys = model.equation_system
    x = eq_sys.get_variable_values(time_step_index=0)
    p = eq_sys.get_variable_values(["pressure"], time_step_index=0)
    print(f"  dofs {eq_sys.num_dofs()}, setup {setup_s:.3f} s, 26 steps {run_s:.3f} s")
    for i, (secs, rec) in enumerate(model.block_log):
        print(
            f"  block {i}: {secs:.4f} s, {rec['steps']} steps, "
            f"{rec['newton_iters']} Newton, {rec['krylov_iters']} Krylov, "
            f"{1e3 * secs / max(rec['newton_iters'], 1):.2f} ms per Newton iteration"
        )
    print(f"  kernel launches in the run: {launches}; largest K of a K1 matrix {largest_ell_k(model)}")
    res, inc = last_step_check(model)
    tol = 1e-10  # NewtonSolver's nl_convergence_tol, the md case's default
    print(
        f"  last step on the host, plain path: |F|/sqrt(n) {res:.3e}, "
        f"next Newton increment |dx|/sqrt(n) {inc:.3e}, tolerance {tol:.0e}"
    )
    print(f"  pressure in [{p.min():.6f}, {p.max():.6f}]")

    _require(model._ftb_blocks_committed == 3, f"blocks {model._ftb_blocks_committed}")
    _require(FALLBACK_COUNTER["count"] == fallbacks0, f"host fallbacks {FALLBACK_COUNTER}")
    needed = MD_KERNELS + (() if functorch else K8_KERNELS)
    _require(all(launches[k] > 0 for k in needed), f"kernel not launched: {launches}")
    # One V-cycle launch a preconditioner apply, and an apply an Arnoldi
    # step, one fgmres_arnoldi launch with the matvec inside.
    _require(launches["amg_vcycle"] == launches["fgmres_arnoldi"],
             f"amg_vcycle {launches['amg_vcycle']} launches, {launches['fgmres_arnoldi']} Arnoldi steps")
    _require(launches.get("fgmres_givens", 0) == 0, f"fgmres_givens launched: {launches}")
    steps = launches["fgmres_arnoldi"]
    print(f"  one amg_vcycle and one fgmres_arnoldi launch an apply: {steps} applies; fgmres_givens "
          f"{launches.get('fgmres_givens', 0)} launches; ell_spmv {launches['ell_spmv']} launches, with the "
          f"Arnoldi matvec outside the step (the parent's route, at these Krylov counts) "
          f"{launches['ell_spmv'] + steps}")
    blocks = [(rec["newton_iters"], rec["krylov_iters"]) for _s, rec in model.block_log]
    newton_p, krylov_p = PARENT_BLOCKS[case if case in PARENT_BLOCKS else ""]
    print(f"  Newton / Krylov a block {blocks}; the parent's route {[(newton_p, krylov_p)] * len(blocks)}")
    if not functorch:
        _require(all(nw == newton_p and abs(kr - krylov_p) <= nw for nw, kr in blocks),
                 f"Newton / Krylov a block {blocks}, the parent's {(newton_p, krylov_p)}")
    if case:
        # Above the dense limit: the AMG preconditioner, as the case asks.
        solver = next(iter(model._device_solvers.values()))
        _require(not solver._dense, f"{case}: dense inverses on {eq_sys.num_dofs()} dofs")
    _require(bool(np.all(np.isfinite(x))), "non-finite state")
    _require(p.min() >= 0.0 and p.max() <= 1.0, f"pressure {p.min()}..{p.max()}")
    _require(inc <= tol, f"Newton increment {inc} > {tol}")
    newton = sum(rec["newton_iters"] for _s, rec in model.block_log)
    block_s = sum(s for s, _rec in model.block_log)
    out = {
        "launches": launches,
        "setup_s": setup_s,
        "blocks": [rec for _s, rec in model.block_log],
        "ms_per_newton": 1e3 * block_s / max(newton, 1),
        "newton": newton,
        "krylov": sum(rec["krylov_iters"] for _s, rec in model.block_log),
        "dofs": eq_sys.num_dofs(),
        "state": x,
    }
    if not functorch:
        out["routes"] = _assembly_routes_in_turns(model, case or "md")
        val, col, solver = _model_jacobian_ell(model)
        name = case or f"md {cell_size:g}"
        label = f"{name}'s Jacobian"
        print(f"phase 3c: K1 at {label} (the final state's, in the solver's ELL layout)")
        out["k1"] = {"f64 B17": check_k1_at(label, val, col, 17, 71)}
        if not case:
            out["k1"]["f32 B1"] = check_k1_at(label, val.to(torch.float32), col, 1, 70)
            print(f"phase 4: K5 and K7 re-timed at {name}'s final state")
            out["retime"] = retime_solver(model, name)
        print(f"phase 3c: K3 at {name}'s hierarchy (the final state's)")
        out["k3"] = vcycle_times(solver, name)
        if not case:
            from porepy_tpu_torch.applications.benchmarking import arnoldi_check

            print(f"phase 3d: K4 (fgmres_arnoldi) at {label}, Ruiz-equilibrated as the solve runs it")
            with tempfile.TemporaryDirectory() as work:
                out["k4"] = arnoldi_check.check_step(
                    arnoldi_check.solve_matrix(val, col, solver._m_state), col, label, work
                )
    return out


def run_md256(dev) -> dict:
    """Phase 24: the ``md256`` bench case through the K8 pass and, for its
    final state, once more through the functorch route."""
    out = run_md(dev, case="md256")
    ref = run_md(dev, case="md256", functorch=True)
    diff = float(np.abs(out["state"] - ref["state"]).max())
    scale = float(np.abs(ref["state"]).max())
    print(
        f"  md256 final state, dual route against functorch route: max |diff| {diff:.3e} "
        f"(largest value {scale:.3e}); Newton {out['newton']} / {ref['newton']}, Krylov "
        f"{out['krylov']} / {ref['krylov']}; {out['ms_per_newton']:.2f} / {ref['ms_per_newton']:.2f} ms "
        f"per Newton iteration"
    )
    _require(diff <= 1e-8 * max(scale, 1.0), f"md256: the two routes' states differ by {diff}")
    out["functorch"] = {k: ref[k] for k in ("ms_per_newton", "newton", "krylov", "setup_s")}
    return out


def compare_small(dev) -> None:
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.applications.benchmarking.cases import build_md_flow

    print("phase 5: md 1/16 on the card against the host plain path")
    finals = []
    for device in (str(dev), "cpu"):
        Model, params = build_md_flow(1.0 / 16, device=device)
        model = Model(params)
        pt.run_time_dependent_model(model, params)
        _require(model._ftb_blocks_committed == 3, f"{device}: blocks committed")
        finals.append(model.equation_system.get_variable_values(time_step_index=0))
    err = float(np.abs(finals[0] - finals[1]).max())
    print(f"  max |cuda - cpu| {err:.3e} over {finals[0].size} dofs")
    _require(err <= 1e-8, f"cuda and cpu differ by {err}")


def check_flow_kernels(dev) -> dict:
    """K12 and K13 residual/tangent kernels against their plain versions
    at 32^3, f64 and f32 (K13's to the bit), with CUDA-event times."""
    from porepy_tpu_torch.applications.benchmarking import flow_cycle_check as fcc
    from porepy_tpu_torch.applications.benchmarking import tpfa_step_check as tsc
    from porepy_tpu_torch.kernels import ops, reference

    print(f"phase 3b: flow-step kernels against their plain versions at {N3D}^3")
    shape = (N3D,) * 3
    ks, ku = fcc.structured_kernel(N3D, dev), fcc.tpfa_kernel(N3D, dev)
    print(f"  cells {ku.num_cells}, faces {ku.num_faces}")
    gen = torch.Generator().manual_seed(1)
    report = {k: {"err": 0.0} for k in ("structured_residual", "structured_jvp", "tpfa_residual", "tpfa_jvp")}
    for dtype in (torch.float64, torch.float32):
        s_args = (*ks._as_dtype(dtype)._arrays(), ks._coef().to(dtype))
        u_args = list(ku._arrays()) + [ku._coef()]
        for i in (2, 4, 5, 8):  # t, bc_val, pv, coef
            u_args[i] = u_args[i].to(dtype)
        for names, args, n_shape in (
            (("structured_residual", "structured_jvp"), s_args, shape),
            (("tpfa_residual", "tpfa_jvp"), tuple(u_args), (ku.num_cells,)),
        ):
            p, q = (
                (2e5 + 1e4 * torch.randn(n_shape, generator=gen, dtype=torch.float64)).to(dtype).to(dev)
                for _ in range(2)
            )
            v = torch.randn(n_shape, generator=gen, dtype=torch.float64).to(dtype).to(dev)
            for name, second in zip(names, (q, v)):
                kern, plain = getattr(ops, name), getattr(reference, name)
                got, want = kern(p, second, *args), plain(p, second, *args)
                tag = f"{name} {str(dtype)[6:]}"
                if name.startswith("tpfa"):
                    # K13's one launch rounds as its plain version.
                    same = tsc.same_bits(got, want)
                    print(f"  {tag}: {'the same bits as its plain version' if same else 'DIFFERENT bits'}")
                    _require(same, f"{tag} differs from its plain version")
                    err = 0.0
                else:
                    # The scale of the summed terms: the largest entry of
                    # the result and of the result along |q|.
                    scale = want.abs().max() + plain(p, second.abs(), *args).abs().max()
                    err = _check(tag, (got - want).abs(), TOL[dtype] * scale)
                report[name]["err"] = max(report[name]["err"], err)
                ms = _cuda_ms(lambda: kern(p, second, *args))
                plain_ms = _cuda_ms(lambda: plain(p, second, *args))
                print(f"    {ms:.4f} ms kernel, {plain_ms:.4f} ms plain")
                if dtype == torch.float64:
                    inputs = [p, second] + [a for a in args if torch.is_tensor(a)]
                    n_cells = p.numel()
                    report[name].update(
                        ms=ms, plain_ms=plain_ms, library_ms=None,
                        bytes=sum(a.numel() * a.element_size() for a in inputs) + 8 * n_cells,
                        # ~40 operations per cell (3 face fluxes with their
                        # densities, the divergence, the accumulation).
                        flops=40 * n_cells,
                    )
    # The flow steps' four residual/tangent kernels' device us (graph replay), and the Newton step's
    # residual with its densities and refinement round against their plain
    # versions and the route they replaced, to the bit
    # (applications/benchmarking/structured_refine_check.py).
    from porepy_tpu_torch.applications.benchmarking import structured_refine_check as src

    report["flow_kernels"] = src.flow_kernels(dev, N3D)
    bits = src.check_launches(ks, dev)
    _require(all(bits.values()), f"K12's launches against their plain versions: {bits}")
    return report


def run_3d(dev, dense: bool, cell_size: float = 1.0 / N3D) -> dict:
    """The 3d case for 26 steps on ``dev``; with ``dense`` the dense frozen
    block inverse (K6), timed build by build."""
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.applications.benchmarking.cases import build_3d_flow
    from porepy_tpu_torch.kernels import LAUNCHES, reset_launches
    from porepy_tpu_torch.numerics.linalg import device_solver as ds
    from porepy_tpu_torch.numerics.linalg.krylov import FALLBACK_COUNTER

    phase = "6" if dense else "8"
    print(f"phase {phase}: 3d at cell size {cell_size:g}, 26 steps on {dev}, dense_precond={dense}")
    Model, params = build_3d_flow(cell_size, device=str(dev))
    params["dense_precond"] = dense
    model = timed_model(Model, dev)(params)
    model.block_log = []
    model.block_states = {}
    times = {"build": [], "inverse": [], "gj": []}

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[key].append(time.perf_counter() - tic)
            return out

        return wrapper

    patched = [
        (ds._BlockPrecondBuilder, "_build_dense_block", "build"),
        (ds, "_dense_inv_fn", "inverse"),
        (ds, "_dense_block_inv", "gj"),
    ]
    originals = [(obj, name, getattr(obj, name)) for obj, name, _k in patched]
    for obj, name, key in patched:
        setattr(obj, name, timed(getattr(obj, name), key))
    try:
        fallbacks0 = FALLBACK_COUNTER["count"]
        reset_launches()
        torch.cuda.synchronize()
        tic = time.perf_counter()
        model.prepare_simulation()
        model._prepared = True
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - tic
        tic = time.perf_counter()
        pt.run_time_dependent_model(model, params)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - tic
        launches = dict(LAUNCHES)
    finally:
        for obj, name, fn in originals:
            setattr(obj, name, fn)

    eq_sys = model.equation_system
    x = eq_sys.get_variable_values(time_step_index=0)
    solver = next(iter(model._device_solvers.values()))
    print(f"  dofs {eq_sys.num_dofs()}, setup {setup_s:.3f} s, 26 steps {run_s:.3f} s")
    if dense:
        print(
            f"  dense builds {len(times['build'])}: "
            + ", ".join(
                f"{b:.3f} s (inverse {i:.3f} s, Gauss-Jordan alone {g:.3f} s)"
                for b, i, g in zip(times["build"], times["inverse"], times["gj"])
            )
        )
    for i, (secs, rec) in enumerate(model.block_log):
        print(
            f"  block {i}: {secs:.4f} s, {rec['steps']} steps, "
            f"{rec['newton_iters']} Newton, {rec['krylov_iters']} Krylov, "
            f"{1e3 * secs / max(rec['newton_iters'], 1):.2f} ms per Newton iteration"
        )
    print(f"  kernel launches in the run: {launches}; largest K of a K1 matrix {largest_ell_k(model)}")
    print(f"  pressure in [{x.min():.6f}, {x.max():.6f}]")
    _require(model._ftb_blocks_committed == 3, f"blocks {model._ftb_blocks_committed}")
    _require(FALLBACK_COUNTER["count"] == fallbacks0, f"host fallbacks {FALLBACK_COUNTER}")
    newton = sum(rec["newton_iters"] for _s, rec in model.block_log)
    block_s = sum(s for s, _rec in model.block_log)
    out = {
        "launches": launches,
        "setup_s": setup_s,
        "blocks": [rec for _s, rec in model.block_log],
        "ms_per_newton": 1e3 * block_s / max(newton, 1),
        "blocks": [(s, dict(rec)) for s, rec in model.block_log],
    }
    _require(all(launches[k] > 0 for k in K8_KERNELS), f"K8 kernel not launched: {launches}")
    if not dense:
        _require(all(launches[k] > 0 for k in MD_KERNELS), f"kernel not launched: {launches}")
        out["routes"] = _assembly_routes_in_turns(model, "3d")
        out["k3"] = vcycle_times(solver, "3d 32^3")
        return out
    _require(solver._dense and solver._builder._block_dense == {0: True}, "dense demoted")
    needed = ("ell_spmv", "fgmres_arnoldi") + DENSE_KERNELS
    _require(all(launches[k] > 0 for k in needed), f"kernel not launched: {launches}")
    _require(bool(np.all(np.isfinite(x))), "non-finite state")
    _require(x.min() >= 1e5 and x.max() <= 2e5, f"pressure {x.min()}..{x.max()}")
    res, inc = last_step_check(model)
    tol = 1e-10
    print(
        f"  last step on the host, plain path: |F|/sqrt(n) {res:.3e}, "
        f"next Newton increment |dx|/sqrt(n) {inc:.3e}, tolerance {tol:.0e}"
    )
    _require(inc <= tol, f"Newton increment {inc} > {tol}")
    cs = eq_sys.compiled_system()
    out.update(
        build_s=times["build"], inverse_s=times["inverse"], gj_s=times["gj"],
        pattern=(cs.indices_np[:, 0], cs.indices_np[:, 1], cs.shape[0]),
        D=solver._m_state["dense"][0],
    )
    return out


def check_dense_kernels(dev, d3) -> dict:
    """K6 kernels against their plain versions at the 3d shapes."""
    from porepy_tpu_torch.applications.benchmarking.dual_pivot_check import pivot_blocks
    from porepy_tpu_torch.kernels import ops, reference
    from porepy_tpu_torch.numerics.linalg import device_solver as ds

    print("phase 7: dense-block kernels against their plain versions")
    report = {}
    gen = torch.Generator().manual_seed(2)

    rows, cols, ni = d3["pattern"]
    n_pad = -(-ni // ds._DENSE_GJ_BLOCK) * ds._DENSE_GJ_BLOCK
    vals = torch.randn(rows.size, generator=gen).to(dev)
    rows_t = torch.tensor(rows.astype(np.int32), device=dev)
    cols_t = torch.tensor(cols.astype(np.int32), device=dev)
    D = ops.dense_block_scatter(vals, rows_t, cols_t, ni, n_pad)
    D_ref = reference.dense_block_scatter(vals, rows_t, cols_t, ni, n_pad)
    err = float((D - D_ref).abs().max())
    print(f"  dense_block_scatter ni {ni}, nnz {rows.size}: max |err| {err:.3e} (must be 0: plain stores)")
    _require(err == 0.0, "dense_block_scatter disagrees with its plain version")
    del D, D_ref
    ms = _cuda_ms(lambda: ops.dense_block_scatter(vals, rows_t, cols_t, ni, n_pad), 10)
    plain_ms = _cuda_ms(lambda: reference.dense_block_scatter(vals, rows_t, cols_t, ni, n_pad), 10)
    print(f"    {ms:.4f} ms kernel, {plain_ms:.4f} ms plain (each includes zeroing {n_pad}^2 f32)")
    report["dense_block_scatter"] = {
        "err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
        "bytes": 4.0 * n_pad * n_pad + 12 * rows.size, "flops": 0, "dtype": torch.float32,
    }

    # Pivot inverses: well-conditioned blocks, one with a zero leading entry
    # (needs a row swap) and one singular (must be flagged).
    b, batch = ds._DENSE_GJ_BLOCK, 64
    a = torch.randn(batch, b, b, generator=gen, dtype=torch.float64) / b**0.5 + 4 * torch.eye(b, dtype=torch.float64)
    a[0, [0, 1]] = a[0, [1, 0]]
    a[0, 0, 0] = 0.0
    a[1] = torch.outer(torch.arange(1.0, b + 1, dtype=torch.float64), torch.arange(1.0, b + 1, dtype=torch.float64))
    report["gj_pivot_inverse"] = {"err": 0.0}
    for dtype in (torch.float32, torch.float64):
        ad = a.to(dtype).to(dev)
        flag = torch.zeros(batch, dtype=torch.int32, device=dev)
        inv = ops.gj_pivot_inverse(ad, flag)
        flag_ref = torch.zeros(batch, dtype=torch.int32, device=dev)
        inv_ref = reference.gj_pivot_inverse(ad, flag_ref)
        flags = flag.cpu().tolist()
        _require(flags == [0, 1] + [0] * (batch - 2), f"gj flags {flags[:4]}...")
        _require(flag_ref.cpu().tolist() == flags, "gj flags differ from the plain version's")
        good = [0] + list(range(2, batch))
        # Inverse of a matrix with condition number ~3: |X - X_ref| <= TOL
        # times b times max |X| (b-term sums, both in dtype).
        e = (inv[good] - inv_ref[good]).abs().max()
        bound = TOL[dtype] * b * inv_ref[good].abs().max()
        err = _check(f"gj_pivot_inverse {str(dtype)[6:]} {batch} x {b}^2", e, bound)
        report["gj_pivot_inverse"]["err"] = max(report["gj_pivot_inverse"]["err"], err)
        ms = _cuda_ms(lambda: ops.gj_pivot_inverse(ad, flag))
        plain_ms = _cuda_ms(lambda: reference.gj_pivot_inverse(ad, flag_ref))
        print(f"    {ms:.4f} ms kernel, {plain_ms:.4f} ms plain (torch.linalg.inv_ex)")
        if dtype == torch.float32:
            lib_ms = _cuda_ms(lambda: torch.linalg.inv_ex(ad))
            print(f"    {lib_ms:.4f} ms torch.linalg.inv_ex alone")
            # The line: the shape the dense build launches, one 128 x 128
            # pivot a launch (256 launches at 32^3), not the batch of 64.
            one, flag1 = ad[2:3].contiguous(), torch.zeros(1, dtype=torch.int32, device=dev)
            one_ms = _cuda_ms(lambda: ops.gj_pivot_inverse(one, flag1))
            one_us = _graph_us(lambda: ops.gj_pivot_inverse(one, flag1))
            one_plain = _cuda_ms(lambda: reference.gj_pivot_inverse(one, flag1))
            one_lib = _cuda_ms(lambda: torch.linalg.inv_ex(one))
            print(f"    one block (the dense build's launch): {one_ms:.4f} ms kernel ({one_us:.2f} us device, graph "
                  f"replay), {one_plain:.4f} ms plain, {one_lib:.4f} ms torch.linalg.inv_ex; the batch of {batch}: "
                  f"{ms:.4f} ms")
            report["gj_pivot_inverse"].update(
                ms=one_ms, plain_ms=one_plain, library_ms=one_lib, device_us=one_us, batch_ms=ms,
                bytes=2 * one.numel() * 4 + 4, flops=2.0 * b**3, dtype=torch.float32,
            )
            # Device us of the one block, kernel and torch.linalg.inv_ex in
            # turns (graph replay: no host dispatch in it).
            us = {"kernel": [], "inv_ex": []}
            for route in ("kernel", "inv_ex", "inv_ex", "kernel"):
                us[route].append(_graph_us(
                    (lambda: ops.gj_pivot_inverse(one, flag1)) if route == "kernel"
                    else (lambda: torch.linalg.inv_ex(one))
                ))
            print(f"    one block, device us a launch in turns (graph replay): kernel {us['kernel']}, "
                  f"torch.linalg.inv_ex {us['inv_ex']}")
            _require(max(us["kernel"]) < min(us["inv_ex"]),
                     f"gj_pivot_inverse: {us['kernel']} us against inv_ex's {us['inv_ex']}")
            report["gj_pivot_inverse"].update(device_us=min(us["kernel"]), device_us_turns=us)

    # Every size class (b = 1, 7, 64, 128) on blocks with many equal
    # magnitudes (ties in the pivot search), a zero leading entry and a
    # singular block (a zero column: a zero pivot under any rounding); the
    # flags equal the plain version's and a set flag stays set.
    for dtype in (torch.float32, torch.float64):
        for bs in (1, 7, 64, 128):
            blocks = pivot_blocks(bs, 40 + bs)
            ad = torch.tensor(blocks, dtype=dtype, device=dev)
            flag = torch.tensor([0, 0, 0, 1], dtype=torch.int32, device=dev)
            flag_ref = flag.clone()
            inv = ops.gj_pivot_inverse(ad, flag)
            inv_ref = reference.gj_pivot_inverse(ad, flag_ref)
            _require(flag.tolist() == flag_ref.tolist() and flag.tolist()[2:] == [1, 1],
                     f"gj flags at b {bs}: {flag.tolist()} against {flag_ref.tolist()}")
            eps = float(torch.finfo(dtype).eps)
            for m in (0, 1, 3):
                if flag_ref[m] and m != 3:
                    continue
                bound = 4 * eps * bs * float(np.linalg.cond(blocks[m])) * float(inv_ref[m].abs().max())
                e = float((inv[m].double() - inv_ref[m].double()).abs().max())
                _require(e <= bound, f"gj_pivot_inverse b {bs} block {m}: {e} > {bound}")
        print(f"  gj_pivot_inverse {str(dtype)[6:]}, b = 1, 7, 64, 128 (ties, a zero leading entry, a zero "
              f"column): flags as the plain version's, inverses within 4 eps b cond(A) max |X|")

    # The whole blocked inverse at n = 4096, kernel route against plain
    # route. Bound: f32 and cond(S) ~ 3 give |S X - I| ~ n eps_f32 cond at
    # worst (1.5e-3); the two routes differ only in the pivot inverses.
    n = 4096
    S = (torch.randn(n, n, generator=gen) / n**0.5 + 4 * torch.eye(n)).to(dev)
    eye = torch.eye(n, device=dev, dtype=torch.float64)
    routes = {}
    for route, piv in (("kernel", ops.gj_pivot_inverse), ("plain", reference.gj_pivot_inverse)):
        ds._dense_block_inv(S.clone(), pivot_inverse=piv)  # warm-up
        torch.cuda.synchronize()
        tic = time.perf_counter()
        X = ds._dense_block_inv(S.clone(), pivot_inverse=piv)
        torch.cuda.synchronize()
        routes[route] = (X, time.perf_counter() - tic)
    for route, (X, secs) in routes.items():
        res = float((S.double() @ X.double() - eye).abs().max())
        print(f"  blocked inverse n {n}, {route} route: max |S X - I| {res:.3e}, {secs:.4f} s")
        _require(res <= 1.5e-3, f"{route} blocked inverse residual {res}")
    dist = float((routes["kernel"][0] - routes["plain"][0]).abs().max() / routes["plain"][0].abs().max())
    print(f"  max |X_kernel - X_plain| / max |X| {dist:.3e} (bound 1e-4)")
    _require(dist <= 1e-4, "blocked inverse routes differ")
    del routes, S

    # The dense build's Gauss-Jordan at its own size (the 3d 32^3 block,
    # 256 pivot launches), kernel route and plain route in turns.
    n = -(-ni // ds._DENSE_GJ_BLOCK) * ds._DENSE_GJ_BLOCK
    S = torch.randn(n, n, generator=gen).to(dev) / n**0.5
    S.diagonal().add_(4.0)
    gj_s = {"kernel": [], "plain": []}
    for route in ("kernel", "plain", "plain", "kernel"):
        piv = ops.gj_pivot_inverse if route == "kernel" else reference.gj_pivot_inverse
        M = S.clone()
        torch.cuda.synchronize()
        tic = time.perf_counter()
        ds._dense_block_inv(M, pivot_inverse=piv)
        torch.cuda.synchronize()
        gj_s[route].append(time.perf_counter() - tic)
        del M
    print(f"  blocked Gauss-Jordan at n {n} ({n // ds._DENSE_GJ_BLOCK} pivots), seconds in turns: kernel route "
          f"{gj_s['kernel']}, plain route {gj_s['plain']}")
    report["gj_pivot_inverse"]["gj_s_turns"] = gj_s
    del S
    torch.cuda.empty_cache()

    D = d3["D"]
    report["dense_block_apply"] = {"err": 0.0}
    for dtype in (torch.float32, torch.float64):
        r = torch.randn(ni, generator=gen, dtype=torch.float64).to(dtype).to(dev)
        y = ops.dense_block_apply(D, r)
        y_ref = reference.dense_block_apply(D, r)
        scale = reference.dense_block_apply(D.abs(), r.abs())
        err = _check(f"dense_block_apply {str(dtype)[6:]} n {ni}", (y - y_ref).abs(), TOL[torch.float32] * scale)
        report["dense_block_apply"]["err"] = max(report["dense_block_apply"]["err"], err)
        ms = _cuda_ms(lambda: ops.dense_block_apply(D, r), 20)
        plain_ms = _cuda_ms(lambda: reference.dense_block_apply(D, r), 20)
        gbs = 4.0 * ni * ni / (ms * 1e-3) / 1e9
        print(f"    {ms:.4f} ms kernel ({gbs:.0f} GB/s of D), {plain_ms:.4f} ms plain")
        if dtype == torch.float32:
            lib_ms = _cuda_ms(lambda: torch.mv(D, r), 20) if D.shape[0] == ni else None
            print(f"    {lib_ms} ms torch.mv")
            report["dense_block_apply"].update(
                ms=ms, plain_ms=plain_ms, gb_s=gbs, library_ms=lib_ms,
                bytes=4.0 * ni * ni + 8 * ni, flops=2.0 * ni * ni, dtype=torch.float32,
            )
    return report


def compare_3d_small(dev) -> None:
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.applications.benchmarking.cases import build_3d_flow

    print("phase 9: 3d 1/16 with dense inverses on the card against the host plain path")
    finals = []
    for device in (str(dev), "cpu"):
        Model, params = build_3d_flow(1.0 / 16, device=device)
        params["dense_precond"] = True
        model = Model(params)
        pt.run_time_dependent_model(model, params)
        _require(model._ftb_blocks_committed == 3, f"{device}: blocks committed")
        _require(next(iter(model._device_solvers.values()))._dense, f"{device}: dense demoted")
        finals.append(model.equation_system.get_variable_values(time_step_index=0))
    err = float(np.abs(finals[0] - finals[1]).max())
    scale = float(np.abs(finals[1]).max())
    print(f"  max |cuda - cpu| {err:.3e} over {finals[0].size} dofs, max |p| {scale:.6e}")
    _require(err <= 1e-8 * scale, f"cuda and cpu differ by {err}")


def _newton_to_floor(step, p0, tol=1e-6, max_iter=20):
    """Newton from ``p0`` until |r| < tol or the residual stops falling
    (|r_k| > |r_{k-1}| / 2: its rounding floor). Returns the state and
    the residual history."""
    p, hist = p0, []
    for _ in range(max_iter):
        p, rn = step(p, p0)
        hist.append(float(rn))
        if hist[-1] < tol or (len(hist) > 1 and hist[-1] > 0.5 * hist[-2]):
            break
    return p, hist


def old_structured_newton_step(kernel, p, p_prev, inner_iter: int = 200, refine: int = 3):
    """The structured Newton step as it ran before its solves became
    ``FlowCycle`` launches: a host BiCGStab loop (``krylov.bicgstab``, a flag
    read an iteration) around one f32 ``structured_jvp`` launch a matvec.
    The yardstick of phase 10's turns; the package no longer has it."""
    from porepy_tpu_torch import kernels
    from porepy_tpu_torch.numerics.linalg.krylov import bicgstab

    arrays, coef = kernel._arrays(), kernel._coef()
    r64 = kernels.structured_residual(p, p_prev, *arrays, coef)
    rnorm = torch.linalg.vector_norm(r64)
    diag32 = kernel._jacobi_diagonal(p).to(torch.float32)
    kernel32 = kernel._as_dtype(torch.float32)
    arrays32, coef32 = kernel32._arrays(), kernel32._coef()
    p32 = p.to(torch.float32)

    def solve32(rhs64):
        nrm = torch.linalg.vector_norm(rhs64)
        scale = torch.where(nrm > 0, nrm, torch.ones_like(nrm))
        x, _ = bicgstab(lambda v: kernels.structured_jvp(p32, v, *arrays32, coef32),
                        (rhs64 / scale).to(torch.float32), M=lambda v: v / diag32, tol=1e-6,
                        atol=0.0, maxiter=inner_iter)
        x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
        return x.to(torch.float64) * scale

    dx = solve32(-r64)
    for _ in range(refine):
        dx = dx + solve32(-r64 - kernels.structured_jvp(p, dx, *arrays, coef))
    return p + dx, rnorm


def old_tpfa_newton_step(kernel, p, p_prev, tol: float = 1e-10, maxiter: int = 200):
    """The unstructured Newton step as it ran before (a host BiCGStab loop
    around one ``tpfa_jvp`` launch a matvec); phase 10's yardstick."""
    from porepy_tpu_torch import kernels
    from porepy_tpu_torch.numerics.linalg.krylov import bicgstab

    arrays, coef = kernel._arrays(), kernel._coef()
    r = kernels.tpfa_residual(p, p_prev, *arrays, coef)
    diag = kernel._jacobi_diagonal(p)
    nrm = torch.linalg.vector_norm(r)
    scale = torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    dx, _ = bicgstab(lambda v: kernels.tpfa_jvp(p, v, *arrays, coef), -r / scale, M=lambda x: x / diag,
                     tol=tol, atol=0.0, maxiter=maxiter)
    return p + torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx)) * scale, nrm


def _host_reads(step, p, p_prev) -> int:
    """The synchronizing operations of one ``step(p, p_prev)``: CUDA's sync
    debug mode warns at each (a read of the device from the host); its
    own notice that the mode is a prototype is not one."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(p, p_prev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def _routes_in_turns(new, old, p0, steps: int = 5) -> tuple:
    """ms per Newton step of ``steps`` chained steps from ``p0`` by each
    route, in turns (new, old, old, new): ``({route: [median ms, ...]},
    {route: the launches of its last turn}, {route: [|r|, ...]})``."""
    from porepy_tpu_torch.kernels import LAUNCHES, reset_launches

    ms, launches, hist = {"new": [], "old": []}, {}, {}
    for route in ("new", "old", "old", "new"):
        step = new if route == "new" else old
        p, times, rs = p0, [], []
        torch.cuda.synchronize()
        reset_launches()
        for _ in range(steps):
            tic = time.perf_counter()
            p, rn = step(p, p0)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - tic)
            rs.append(float(rn))
        launches[route], hist[route] = dict(LAUNCHES), rs
        ms[route].append(1e3 * float(np.median(times)))
    return ms, launches, hist


def run_flow_steps(dev) -> dict:
    from porepy_tpu_torch.applications.benchmarking import flow_cycle_check as fcc
    from porepy_tpu_torch.kernels import LAUNCHES, reset_launches

    print(f"phase 10: structured (K12) and unstructured (K13) flow steps at {N3D}^3")
    shape = (N3D,) * 3
    out = {}
    finals = []
    for on_card, device in ((True, dev), (False, torch.device("cpu"))):
        kernel = fcc.structured_kernel(N3D, device)
        p_prev = torch.full(shape, 2.0e5, dtype=torch.float64, device=device)
        if on_card:
            reset_launches()
            kernel.newton_step(p_prev, p_prev)
            torch.cuda.synchronize()
            times = []
            p = p_prev
            for _ in range(7):
                tic = time.perf_counter()
                p = kernel.newton_step(p, p_prev)[0]
                torch.cuda.synchronize()
                times.append(time.perf_counter() - tic)
            out["structured_ms"] = 1e3 * float(np.median(times))
            print(f"  structured, 7 chained Newton steps: median {out['structured_ms']:.3f} ms per step")
        tic = time.perf_counter()
        iters = []
        p, hist = _newton_to_floor(lambda a, b: kernel.newton_step(a, b, iterations=iters), p_prev)
        if on_card:
            torch.cuda.synchronize()
            out["structured_launches"] = dict(LAUNCHES)
            out["structured_steps"] = 8 + len(hist)
        out.setdefault("structured_iterations", []).append(iters)
        print(f"  structured on {device}: {len(hist)} Newton steps in {time.perf_counter() - tic:.3f} s, |r| {['%.3e' % h for h in hist]}")
        print(f"    iterations of its {len(iters)} solves: {iters}")
        finals.append(p.cpu().numpy())
        if on_card:
            card_kernel, card_hist = kernel, hist
        else:
            out["structured_newton"] = (len(card_hist), len(hist))
    err = float(np.abs(finals[0] - finals[1]).max())
    print(f"  structured, max |card - host| {err:.3e}")
    _require(err <= 1e-6, f"structured card and host differ by {err}")

    kernel = fcc.tpfa_kernel(N3D, dev)
    q_prev = torch.full((kernel.num_cells,), 2.0e5, dtype=torch.float64, device=dev)
    reset_launches()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    iters = []
    q, hist = _newton_to_floor(lambda a, b: kernel.newton_step(a, b, iterations=iters), q_prev)
    torch.cuda.synchronize()
    out["tpfa_launches"] = dict(LAUNCHES)
    out["tpfa_iterations"] = iters
    out["tpfa_steps"] = len(hist)
    out["tpfa_newton"] = len(hist)
    print(f"  unstructured on {dev}: {len(hist)} Newton steps in {time.perf_counter() - tic:.3f} s, |r| {['%.3e' % h for h in hist]}")
    print(f"    iterations of its {len(iters)} solves: {iters}")
    card_its, host_its = out["structured_iterations"]
    gap = max((abs(a - b) for a, b in zip(card_its, host_its)), default=0)
    print(f"  structured solves, card against host: {len(card_its)} and {len(host_its)} solves, iterations at most "
          f"{gap} apart")
    # CartGrid numbers cells x fastest.
    q3 = q.cpu().numpy().reshape(shape[::-1]).T
    err = float(np.abs(finals[0] - q3).max())
    print(f"  max |structured - unstructured| {err:.3e}")
    _require(err < 1e-4, f"structured and unstructured differ by {err}")
    for key, names in (("structured_launches", ("structured_residual", "structured_refine", "structured_linearize",
                                                "bicgstab_stencil")),
                       ("tpfa_launches", ("tpfa_step", "bicgstab_tpfa"))):
        print(f"  kernel launches ({key[:-9]} run): {out[key]}")
        _require(all(out[key][k] > 0 for k in names), f"{names} not launched: {out[key]}")
    # A solve, two cycle launches; one residual (with its densities), the
    # three rounds' refinement launches and one linearization a structured
    # step; one tpfa_step launch (the residual, the Jacobian's values and
    # the diagonal) an unstructured step; no jvp in either step.
    s, u = out["structured_steps"], out["tpfa_steps"]
    ls, lu = out["structured_launches"], out["tpfa_launches"]
    want = {"structured_residual": s, "structured_refine": 3 * s, "structured_jvp": 0,
            "structured_linearize": s, "bicgstab_stencil": 2 * 4 * s,
            "tpfa_step": u, "tpfa_residual": 0, "tpfa_linearize": 0, "tpfa_jvp": 0, "bicgstab_tpfa": 2 * u}
    got = {k: (ls if k.startswith(("structured", "bicgstab_stencil")) else lu)[k] for k in want}
    print(f"  launches in {s} structured and {u} unstructured Newton steps: {got} (expected {want})")
    _require(got == want, f"flow-step launches {got}, expected {want}")
    reads = {"structured": _host_reads(card_kernel.newton_step, p_prev.to(dev), p_prev.to(dev)),
             "unstructured": _host_reads(kernel.newton_step, q_prev, q_prev)}
    print(f"  host reads in one Newton step (sync debug mode): {reads} (4 and 1 solves)")
    _require(reads == {"structured": 4, "unstructured": 1}, f"host reads a step {reads}, expected one a solve")
    out["reads"] = reads

    # The refinement round and the step against the parent's route (a
    # structured_jvp and two torch operations a round), in turns: the bits,
    # the counts and the launches of a step.
    from porepy_tpu_torch.applications.benchmarking import structured_refine_check as src

    out["round"] = src.round_in_turns(card_kernel, dev)
    out["parent_steps"] = src.steps_in_turns(card_kernel, dev)
    _require(out["round"]["equal"], "a refinement round differs from the parent's")
    _require(out["parent_steps"]["equal"] and out["parent_steps"]["same_iterations"],
             "the structured steps differ from the parent route's")
    refinement = {r: k["refinement_launches"] for r, k in out["parent_steps"]["step_kernels"].items()}
    print(f"  launches a structured step of the residual and the refinement: {refinement} (5 and 11 expected)")
    _require(refinement == {"new": 5, "parent": 11}, f"a structured step's refinement launches {refinement}")

    # The unstructured step's operands (one tpfa_step launch) and its steps
    # against the parent's route (its residual and linearization kernels
    # and the torch diagonal), in turns: the bits, the counts, the kernels.
    from porepy_tpu_torch.applications.benchmarking import tpfa_step_check as tsc

    modes = tsc.check_modes(kernel, dev, _PARENT["k13"])
    _require(all(modes.values()), f"a K13 mode differs: {[k for k, ok in modes.items() if not ok]}")
    out["tpfa_operands"] = tsc.step_in_turns(kernel, dev)
    out["tpfa_parent_steps"] = tsc.steps_in_turns(kernel, dev)
    _require(all(out["tpfa_operands"]["equal"].values()),
             f"the step's operands differ from their plain version or the parent route's: "
             f"{out['tpfa_operands']['equal']}")
    _require(out["tpfa_parent_steps"]["equal"] and out["tpfa_parent_steps"]["same_iterations"],
             "the unstructured steps differ from the parent route's")
    one = out["tpfa_parent_steps"]["step_kernels"]["new"]
    k13 = {k: v for k, v in one["kernels"].items() if k.startswith("tpfa_")}
    print(f"  one unstructured step: K13 kernels {k13}, counted {one['counted']}; the operands' CUDA kernels "
          f"{out['tpfa_operands']['launches']}, counted {out['tpfa_operands']['counted']}")
    _require(one["counted"] == {"tpfa_step": 1, "bicgstab_tpfa": 2} and k13 == {"tpfa_kernel<double, 3>": 1},
             f"an unstructured step's launches {one['counted']}, {k13}")
    _require(out["tpfa_operands"]["counted"] == {"tpfa_step": 1},
             f"the step's operands are not one launch: {out['tpfa_operands']['counted']}")

    # The route before (host BiCGStab loops over the jvp launches) and this
    # one, in turns, 5 chained steps from p = 2e5 each.
    s_kernel = card_kernel
    p_s = torch.full(shape, 2.0e5, dtype=torch.float64, device=dev)
    out["turns"] = {}
    for tag, new, old, start in (
        ("structured", s_kernel.newton_step, lambda a, b: old_structured_newton_step(s_kernel, a, b), p_s),
        ("unstructured", kernel.newton_step, lambda a, b: old_tpfa_newton_step(kernel, a, b), q_prev),
    ):
        ms, launches, rs = _routes_in_turns(new, old, start)
        out["turns"][tag] = {"ms": ms, "launches": launches}
        print(f"  {tag} ms per Newton step in turns (new, old, old, new; median of 5 chained steps): new "
              f"{ms['new']}, old {ms['old']}; |r| new {['%.2e' % r for r in rs['new']]}, old "
              f"{['%.2e' % r for r in rs['old']]}")
    old_u = out["turns"]["unstructured"]["launches"]["old"]
    print(f"  the old route's launches in 5 unstructured steps: tpfa_jvp {old_u['tpfa_jvp']}, "
          f"structured: structured_jvp {out['turns']['structured']['launches']['old']['structured_jvp']}")
    out["kernels"] = (s_kernel, kernel)
    return out


def check_flow_cycles(dev, smi: str, ks, ku) -> dict:
    """Phase 10b: the cycle launches and linearizations of phase 10's
    kernels ``ks`` (structured) and ``ku`` (unstructured) at 32^3, on the
    buffers their Newton steps use, against their plain versions, with
    times (see ``applications/benchmarking/flow_cycle_check.py``)."""
    from porepy_tpu_torch.applications.benchmarking import flow_cycle_check as fcc

    print(f"phase 10b: the flow steps' BiCGStab (FlowCycle) and linearizations at {N3D}^3 against their plain versions")
    gen = torch.Generator().manual_seed(10)
    results = {}
    for kind, kernel, shape in (("stencil", ks, (N3D,) * 3), ("tpfa", ku, (ku.num_cells,))):
        p = (2e5 + 1e4 * torch.randn(shape, generator=gen, dtype=torch.float64)).to(dev)
        p_prev = torch.full(shape, 2e5, dtype=torch.float64, device=dev)
        for dtype in (torch.float32, torch.float64):
            r = fcc.check(kind, kernel, p, p_prev, dtype)
            print("  " + fcc.describe(r, smi))
            _require(r["equal"], f"{kind} {dtype}: a cycle launch differs from its plain version")
            _require(r["lin_ok"], f"{kind} {dtype}: the linearization differs from its plain version")
            results[(kind, dtype)] = r
    # What the syncs and reductions cost with little work: the same f32
    # solve at 8^3 (4 tiles) and 16^3 (32 tiles).
    floor = fcc.iteration_floor(dev)
    for n, r in floor.items():
        print(f"  {n}^3: " + fcc.describe(r, smi))
        _require(r["equal"] and r["lin_ok"], f"{n}^3: a cycle launch or the linearization differs")
    report = {"flow_floor": floor}
    # The line: each kernel at the main path's dtype (f32 stencil, f64 TPFA).
    for name, lin, key in (("bicgstab_stencil", "structured_linearize", ("stencil", torch.float32)),
                           ("bicgstab_tpfa", "tpfa_linearize", ("tpfa", torch.float64))):
        r = results[key]
        report[name] = {"err": 0.0, "ms": r["ms"], "plain_ms": r["plain_ms"], "library_ms": None,
                        "bound": r["bound"]}
        # No one PyTorch call computes J(p)'s coefficients.
        report[lin] = {"err": r["lin_err"], "ms": r["lin_ms"], "plain_ms": r["lin_plain_ms"], "library_ms": None,
                       "bound": r["lin_bound"]}
    report["flow_cycles"] = {f"{k} {str(d)[6:]}": r for (k, d), r in results.items()}
    return report


# -- K10 and the biot case --------------------------------------------------------


def check_region_kernel(dev) -> dict:
    """K10 against its plain versions on real and synthetic region batches:
    the ordered one to the bit, ``torch.linalg.solve``'s within 1e-12."""
    from porepy_tpu_torch.applications.benchmarking.cases import region_batches
    from porepy_tpu_torch.kernels import ops, reference

    print("phase 11: the region-solve kernel (K10) against its plain versions")
    batches = region_batches(dev)
    main_bucket = max(k for src, k, _ in batches if src == "biot 1/64")
    # For phases 17 and 18: the region matrices of the two real buckets
    # that K11 inverts, and the first and the largest chunks of the biot
    # discretization.
    chunks = [arrays for src, k, arrays in batches if src == "biot 1/64" and k in (batches[0][1], main_bucket)]
    report = {"err": 0.0, "buckets": [], "chunks": chunks, "real_a": [
        (src, arrays[0]) for src, k, arrays in batches
        if (src, k) == ("biot 1/64", main_bucket) or (src == "biot 3d 16^3" and k[0] == 81)
    ]}
    for source, (n, m, q), arrays in batches:
        B = arrays[0].shape[0]
        host = [torch.from_numpy(x) for x in arrays]
        pinned = [x.pin_memory() for x in host]
        a, rhs, w = (x.to(dev) for x in host)
        got = ops.region_solve(a, rhs, w)
        want = reference.region_solve_contract(a, rhs, w)
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        route = ops.region_solve_route(n, m)
        tag = f"region_solve {source}: B {B}, n {n}, m {m}, q {q}, {route} route"
        _check(tag, torch.tensor(err), 1e-12 * scale)
        _require(reference.same_bits(got, reference.region_solve_ordered(a, rhs, w)),
                 f"{tag}: the kernel differs from region_solve_ordered")
        report["err"] = max(report["err"], err)
        reps = 20
        ms = _cuda_ms(lambda: ops.region_solve(a, rhs, w), reps)
        device_us = _graph_us(lambda: ops.region_solve(a, rhs, w), launches=10, replays=3)
        plain_ms = _cuda_ms(lambda: reference.region_solve_contract(a, rhs, w), reps)
        h2d_ms = _cuda_ms(lambda: [x.to(dev) for x in host], reps)
        d2h_ms = _cuda_ms(lambda: got.cpu(), reps)
        back = torch.empty(got.shape, dtype=got.dtype, pin_memory=True)
        h2d_pinned = _cuda_ms(lambda: [x.to(dev, non_blocking=True) for x in pinned], reps)
        d2h_pinned = _cuda_ms(lambda: back.copy_(got, non_blocking=True), reps)
        print(
            f"    the ordered plain version's bits; rel err {err / scale:.3e} against linalg.solve; {ms:.4f} ms "
            f"kernel, device {device_us:.2f} us (graph replay), {plain_ms:.4f} ms plain; copies pageable "
            f"{h2d_ms:.4f} ms to the card, {d2h_ms:.4f} ms back, pinned {h2d_pinned:.4f} and {d2h_pinned:.4f}"
        )
        report["buckets"].append(dict(source=source, B=B, n=n, m=m, q=q, ms=ms, plain_ms=plain_ms,
                                      device_us=device_us, route=route))
        if source == "biot 1/64" and (n, m, q) == main_bucket:
            # The yardstick: torch.linalg.solve and the contraction, unscaled.
            lib_ms = _cuda_ms(lambda: w @ torch.linalg.solve(a, rhs), reps)
            print(f"    {lib_ms:.4f} ms torch.linalg.solve + w @ x")
            report.update(
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, device_us=device_us,
                bytes=8.0 * B * (n * n + n * m + q * n + q * m),
                flops=B * (2.0 / 3.0 * n**3 + 2.0 * n * n * m + 2.0 * q * n * m),
            )
    return report


def run_biot(dev, dense: bool) -> dict:
    """The biot case at 1/64 for 26 steps on ``dev``, discretized by K10."""
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.applications.benchmarking.cases import build_biot
    from porepy_tpu_torch.kernels import LAUNCHES, reset_launches
    from porepy_tpu_torch.numerics.linalg.krylov import FALLBACK_COUNTER

    print(f"phase 12: biot at cell size 1/64, 26 steps on {dev}, dense_precond={dense}, discretized by K10")
    Model, params = build_biot(1.0 / 64, device=str(dev))
    params["dense_precond"] = dense
    model = timed_model(Model, dev)(params)
    model.block_log = []
    model.block_states = {}
    disc_s = []
    discretize = model.discretize

    def timed_discretize():
        tic = time.perf_counter()
        discretize()
        torch.cuda.synchronize()
        disc_s.append(time.perf_counter() - tic)

    model.discretize = timed_discretize
    fallbacks0 = FALLBACK_COUNTER["count"]
    reset_launches()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    with _local_solves("k10"):
        model.prepare_simulation()
    model._prepared = True
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - tic
    disc_launches = LAUNCHES["region_solve"]
    tic = time.perf_counter()
    pt.run_time_dependent_model(model, params)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - tic
    launches = dict(LAUNCHES)
    model.discretize = discretize

    eq_sys = model.equation_system
    x = eq_sys.get_variable_values(time_step_index=0)
    solver = next(iter(model._device_solvers.values()))
    print(
        f"  dofs {eq_sys.num_dofs()}, setup {setup_s:.3f} s (discretization by K10 "
        f"{sum(disc_s):.3f} s, {disc_launches} launches), 26 steps {run_s:.3f} s"
    )
    for i, (secs, rec) in enumerate(model.block_log):
        print(
            f"  block {i}: {secs:.4f} s, {rec['steps']} steps, "
            f"{rec['newton_iters']} Newton, {rec['krylov_iters']} Krylov, "
            f"{1e3 * secs / max(rec['newton_iters'], 1):.2f} ms per Newton iteration"
        )
    print(f"  kernel launches in the run: {launches}; largest K of a K1 matrix {largest_ell_k(model)}")
    _require(model._ftb_blocks_committed == 3, f"blocks {model._ftb_blocks_committed}")
    _require(FALLBACK_COUNTER["count"] == fallbacks0, f"host fallbacks {FALLBACK_COUNTER}")
    _require(disc_launches > 0, "region_solve not launched in the discretization")
    needed = ("ell_spmv", "fgmres_arnoldi") + (DENSE_KERNELS if dense else ("amg_vcycle",))
    _require(all(launches[k] > 0 for k in needed), f"kernel not launched: {launches}")
    _require(solver._dense == dense, f"dense {solver._dense}")
    if dense:
        _require(solver._builder._block_dense == {0: True, 1: True}, f"dense blocks {solver._builder._block_dense}")
    _require(bool(np.all(np.isfinite(x))), "non-finite state")
    res, inc = last_step_check(model)
    tol = 1e-10
    print(
        f"  last step on the host, plain path: |F|/sqrt(n) {res:.3e}, "
        f"next Newton increment |dx|/sqrt(n) {inc:.3e}, tolerance {tol:.0e}"
    )
    _require(inc <= tol, f"Newton increment {inc} > {tol}")
    newton = sum(rec["newton_iters"] for _s, rec in model.block_log)
    krylov = sum(rec["krylov_iters"] for _s, rec in model.block_log)
    block_s = sum(s for s, _rec in model.block_log)
    out = {
        "launches": launches,
        "setup_s": setup_s,
        "disc_k10_s": sum(disc_s),
        "ms_per_newton": 1e3 * block_s / max(newton, 1),
        "newton": newton,
        "krylov": krylov,
        "states": {**model.block_states, 26.0: eq_sys.get_variable_values(time_step_index=0)},
        "dofs": {v: eq_sys.dofs_of([v]) for v in ("u", "pressure")},
    }
    _require(all(launches[k] > 0 for k in K8_KERNELS), f"K8 kernel not launched: {launches}")
    if not dense:
        out["routes"] = _assembly_routes_in_turns(model, "biot")
        out["k3"] = vcycle_times(solver, "biot 1/64")
        # Both routes once more on the prepared model, in turns.
        for route in ("host", "k10", "host", "k10"):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            with _local_solves(route):
                model.discretize()
            torch.cuda.synchronize()
            out.setdefault(f"disc_{route}_turns", []).append(time.perf_counter() - tic)
        print(
            f"  discretization again, in turns: host LAPACK {out['disc_host_turns']} s, "
            f"K10 {out['disc_k10_turns']} s"
        )
    return out


def build_fractured_poromechanics(device: str):
    """The fractured poromechanics case of the poromechanics parity tests:
    a unit square at cell size 1/4 with one horizontal fracture, the north
    side sheared and compressed ("contact" boundary data), one time step."""
    import porepy_tpu_torch as pt

    class Model(pt.Poromechanics):
        def set_fractures(self):
            self._fractures = [pt.LineFracture(np.array([[0.25, 0.75], [0.5, 0.5]]))]

        def bc_values_displacement(self, bg):
            vals = np.zeros((self.nd, bg.num_cells))
            north = self.domain_boundary_sides(bg).north
            vals[0, north] = 0.01
            vals[1, north] = -0.005
            return vals.ravel("F")

        def bc_values_pressure(self, bg):
            return 1e-3 * (1.0 - bg.cell_centers[1])

        def initialize_data_saving(self):
            pass

        def save_data_time_step(self):
            pass

    params = {
        "grid_type": "cartesian",
        "meshing_arguments": {"cell_size": 0.25},
        "material_constants": {
            "solid": pt.SolidConstants(
                residual_aperture=0.01, normal_permeability=1.0, permeability=1.0, porosity=0.1,
            ),
            "fluid": pt.FluidComponent(compressibility=1e-3, viscosity=1.0, density=1.0),
        },
        "time_manager": pt.TimeManager([0, 1.0], 1.0, constant_dt=True),
        "linear_solver": "device_gmres",
        "device": device,
    }
    return Model(params), params


def compare_poro_small(dev) -> dict:
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.applications.benchmarking.cases import biot_matrices, biot_problem, build_biot

    print("phase 13: poromechanics on the card against the host plain path")
    runs = {}
    for device in (str(dev), "cpu"):
        Model, params = build_biot(1.0 / 16, device=device)
        # Ten steps: at t = 26 the pressure has decayed to ~7e-12, below
        # the Newton tolerance, where a relative bound measures rounding.
        params["time_manager"] = pt.TimeManager([0, 10.0], 1.0, constant_dt=True)
        params["dense_precond"] = False
        model = Model(params)
        with _local_solves("host" if device == "cpu" else "k10"):
            model.prepare_simulation()
        model._prepared = True
        pt.run_time_dependent_model(model, params)
        _require(model._ftb_blocks_committed == 1, f"{device}: blocks committed")
        runs[device] = model
    for var in ("u", "pressure"):
        got, want = (
            runs[d].equation_system.get_variable_values([var], time_step_index=0) for d in (str(dev), "cpu")
        )
        err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
        print(f"  biot 1/16 {var}: max |card - host| {err:.3e}, max |{var}| {scale:.3e}")
        _require(err <= 1e-8 * scale, f"biot 1/16 {var}: card and host differ by {err}")

    from porepy_tpu_torch.kernels import LAUNCHES, reset_launches

    finals = {}
    for device in (str(dev), "cpu"):
        model, params = build_fractured_poromechanics(device)
        reset_launches()
        pt.run_time_dependent_model(model, params)
        finals[device] = model
        if device != "cpu":
            solver = next(iter(model._device_solvers.values()))
            launched = {k: LAUNCHES[k] for k in ("amg_vcycle", "jacobi_sweeps")}
            ((i, sweeps),) = solver._builder._jac_sweeps.items()
            s = (sweeps or 8) - 1
            print(f"  fractured, contact: methods {solver._builder.methods}, Jacobi sweeps frozen "
                  f"{solver._builder._jac_sweeps} (0: 8 sweeps), s = {s} a jacobi_sweeps launch; launches {launched}")
            _require(all(launched.values()), f"fractured: kernel not launched: {launched}")
            k2 = check_jacobi_block(solver._m_state["jac"][i], "the contact case", (s,))
            k2["launches"] = launched["jacobi_sweeps"]
    for var in ("pressure", "u", "contact_traction", "u_interface", "interface_darcy_flux"):
        got, want = (finals[d].equation_system.get_variable_values([var], iterate_index=0) for d in (str(dev), "cpu"))
        err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
        print(f"  fractured, contact: {var}: max |card - host| {err:.3e}, max |{var}| {scale:.3e}")
        _require(bool(np.all(np.isfinite(got))), f"fractured {var} not finite")
        _require(err <= 1e-8 * scale, f"fractured {var}: card and host differ by {err}")

    # The residual alone (no seeds) runs the same programs as the assembly:
    # the cell-wise norm of the contact equations included.
    eq_sys = finals[str(dev)].equation_system
    cs = eq_sys.compiled_system()
    with _launches_of_block() as with_seeds:
        cs.assemble(eq_sys)
    with _launches_of_block() as without_seeds:
        cs.residual(eq_sys)
    print(f"  fractured, contact: dual_ew launches of one assembly {with_seeds.get('dual_ew')}, of one residual {without_seeds.get('dual_ew')}")
    _require(
        without_seeds.get("dual_ew", 0) == with_seeds.get("dual_ew", -1),
        f"fractured: the residual launches dual_ew {without_seeds.get('dual_ew')} times, the assembly {with_seeds.get('dual_ew')}",
    )

    mats = {}
    for route in ("k10", "host"):
        with _local_solves(route):
            mats[route] = biot_matrices(*biot_problem([64, 64]))
    for key, want in mats["host"].items():
        diff = abs(mats["k10"][key] - want)
        err = diff.max() if diff.nnz else 0.0
        scale = abs(want).max()
        print(f"  Biot 1/64 {key}: max |K10 - host| / max |host| {err / scale:.3e}")
        _require(err <= 1e-12 * scale, f"Biot matrix {key}: K10 and host differ by {err}")
    return k2


# -- K18, K17, K16 ----------------------------------------------------------------


def _first_newton_system(dev, cell_size: float = 1.0 / 64):
    """The first Newton system of the biot case, host-assembled (scipy)."""
    from porepy_tpu_torch.applications.benchmarking.cases import build_biot

    Model, params = build_biot(cell_size, device=str(dev))
    params.pop("fused_time_steps")
    params.pop("fused_commit_states")
    params["linear_solver"] = "jax_bicgstab"
    model = Model(params)
    model.prepare_simulation()
    model.before_nonlinear_loop()
    model.before_nonlinear_iteration()
    model.assemble_linear_system()
    A, b = model.linear_system
    return A.tocsr(), np.asarray(b)


class _Holding:
    """A ``run`` hook for the fused Krylov loops: every K18 call runs by the
    kernel and by its plain version on copies of the same inputs, every
    tensor argument must come out with the same bits (NaN where the plain
    version has NaN), and the loop goes on with the kernel's results."""

    def __init__(self):
        self.held = 0

    def __call__(self, name, *args):
        from porepy_tpu_torch.applications.benchmarking.krylov_cycle_check import same_bits
        from porepy_tpu_torch.kernels import ops, reference

        self.held += 1
        copies = [[a.clone() if torch.is_tensor(a) else a for a in args] for _ in range(2)]
        getattr(ops, name)(*copies[0])
        getattr(reference, name)(*copies[1])
        for a, k, w in zip(args, *copies):
            if torch.is_tensor(a):
                _require(same_bits(k, w), f"{name}: kernel and plain version differ in bits")
                a.copy_(k)


def check_krylov(dev, A, b) -> dict:
    """K18a and K18b on the biot 1/64 system: every launch of a BiCGStab
    solve (its start and the launch that runs every iteration) and every
    GMRES restart held against its plain version to the bit, whole solves
    against the plain iterations, the launches of a solve, and times."""
    from porepy_tpu_torch import kernels
    from porepy_tpu_torch.applications.benchmarking import krylov_cycle_check
    from porepy_tpu_torch.kernels import ops, reference
    from porepy_tpu_torch.numerics.ad.compiler import _device_const_matrix, _EllMat
    from porepy_tpu_torch.numerics.linalg import krylov

    n, nnz = A.shape[0], A.nnz
    print(f"phase 14: the Krylov kernels (K18a, K18b) on the biot 1/64 system, n {n}, nnz {nnz}")
    mat = _device_const_matrix(A, dev)
    _require(isinstance(mat, _EllMat), "biot 1/64 is not in ELL layout")
    mv = ops.EllOperator(mat.val, mat.col)
    csr = krylov.csr_arrays(A, dev)
    dinv = torch.tensor(krylov._inverse_diagonal(A), device=dev)
    bt = torch.tensor(b, device=dev)
    b_dot = float(b @ b)
    tol, maxiter = 1e-12, max(200, 4 * n)
    report = {}
    for method in ("bicgstab", "gmres"):

        def fused(run=krylov._op):
            if method == "bicgstab":
                return krylov._bicgstab_fused(csr, bt, dinv, tol**2 * b_dot, maxiter, run=run)
            return krylov._gmres_fused(csr, bt, dinv, tol * np.sqrt(b_dot), maxiter, 30, run=run)

        def plain():
            solve = krylov.gmres if method == "gmres" else krylov.bicgstab
            kwargs = {"restart": 30} if method == "gmres" else {}
            return solve(mv, bt, tol=tol, maxiter=maxiter, M=lambda v: dinv * v, **kwargs)[0]

        # Every launch, the start included, by the kernel and by the plain
        # version it composes, from the same state.
        hold = _Holding()
        fused(run=hold)
        print(f"  {method}: {hold.held} launches held, each with its plain version's bits")
        before = dict(kernels.LAUNCHES)
        _x, steps = fused()
        torch.cuda.synchronize()
        launched = {k: kernels.LAUNCHES[k] - before[k] for k in ("bicgstab_cycle", "gmres_cycle", "ell_spmv")}
        if method == "bicgstab":
            want = {"bicgstab_cycle": 2, "gmres_cycle": 0, "ell_spmv": 0}
        else:
            want = {"bicgstab_cycle": 0, "gmres_cycle": steps // 30 + 1, "ell_spmv": 0}
        print(f"  {method}: launches of one solve {launched}")
        _require(launched == want, f"{method}: not one launch to start and {'one a solve' if method == 'bicgstab' else 'one a restart'} without K1: {launched}")
        times = {}
        for route in ("kernel", "plain", "kernel", "plain"):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            out = fused() if route == "kernel" else plain()
            torch.cuda.synchronize()
            times.setdefault(route, []).append(time.perf_counter() - tic)
            if route == "kernel":
                x_k, iters = out
            else:
                x_p = out
        err = float((x_k - x_p).abs().max())
        scale = float(x_p.abs().max())
        res = np.linalg.norm(b - A @ x_k.cpu().numpy()) / np.linalg.norm(b)
        print(
            f"  {method} whole solve: {iters} iterations, |b - A x| / |b| {res:.3e}, "
            f"max |kernel - plain| {err:.3e} of max |x| {scale:.3e}; "
            f"in turns kernel {times['kernel']} s, plain {times['plain']} s"
        )
        _require(err <= 1e-9 * scale, f"{method}: kernel and plain solves differ by {err}")
        report[method] = {"err": err, "iters": iters, "solve_s": times}

    # K18a: one solve's launch (every iteration, its matvecs inside) from
    # the state after the start, by CUDA events; host microseconds a launch.
    t_a = [krylov_cycle_check.time_bicgstab(A, b, dev) for _ in range(2)]
    iters_a = t_a[0]["iterations"]
    state = krylov.bicgstab_state(n, tol**2 * b_dot, dev)
    ops.bicgstab_cycle(*csr, dinv, bt, *state, 0)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    reference.bicgstab_cycle(*csr, dinv, bt, *state, maxiter)
    torch.cuda.synchronize()
    plain_a = 1e3 * (time.perf_counter() - tic)
    # An iteration reads the CSR matrix twice (two matvecs) and moves 14
    # vectors (r, p, q, dinv twice, rhat twice, phat, s, shat, t, x, and r
    # and x written); operations: 2 per nonzero a matvec, ~30 per entry.
    bytes_it = 2.0 * (12.0 * nnz + 4.0 * (n + 1)) + 14.0 * 8.0 * n
    flops_it = 4.0 * nnz + 30.0 * n
    bound_it = _bound(bytes_it, flops_it)
    bound_a = _bound(iters_a * bytes_it, iters_a * flops_it)
    ms_a = [t["ms"] for t in t_a]
    print(f"  K18a, one BiCGStab solve's launch ({iters_a} iterations, {ops.bicgstab_cycle_grid(n)} blocks): "
          f"{ms_a} ms, {[round(t['us_per_iteration'], 3) for t in t_a]} us of device time an iteration, "
          f"{[round(t['host_us'], 2) for t in t_a]} us of host time a launch; plain version {plain_a:.1f} ms; "
          f"bound {1e3 * bound_it[0]:.3f} us an iteration ({bound_it[1]}), the kernel at "
          f"{100 * bound_a[0] / min(ms_a):.2f}% of it")
    # No one PyTorch call computes a BiCGStab solve.
    report["bicgstab_cycle"] = {
        "err": 0.0, "ms": min(ms_a), "plain_ms": plain_a, "library_ms": None, "bound": bound_a,
        "iters": iters_a, "us_per_iteration": [t["us_per_iteration"] for t in t_a],
        "host_us": [t["host_us"] for t in t_a], "bound_it": bound_it,
    }

    # K18b: one restart (its 31 matvecs inside) from the state after the
    # start of the solve, kernel and plain version; host microseconds of a
    # launch; the projection's one-call yardstick torch.mv(V, w) at k = 29.
    R = 30
    grid = ops.gmres_cycle_grid(n)
    ms_b = [krylov_cycle_check.time_restart(A, b, dev) for _ in range(2)]
    state = krylov.gmres_state(n, R, tol * np.sqrt(b_dot), dev)
    ops.gmres_cycle(*csr, dinv, bt, *state, 0)
    saved = [v.clone() for v in state]

    def plain_restart():
        for v, v0 in zip(state, saved):
            v.copy_(v0)
        reference.gmres_cycle(*csr, dinv, bt, *state, 1)

    plain_b = _cuda_ms(plain_restart, 3)
    host_b = _host_us(lambda: ops.gmres_cycle(*csr, dinv, bt, *state, 1), 20)
    # In: the CSR matrix, dinv, b, x, V[0]; out: V[0..30], x, w, H, y.
    # Operations: 31 matvecs, the projections and updates (4 (k + 1) n a
    # step), the normalizations and the correction.
    bound_b = _bound(12.0 * nnz + 4.0 * (n + 1) + 8.0 * (4 * n + 33 * n + R * (R + 1) + R),
                     2.0 * nnz * (R + 1) + 4.0 * n * R * (R + 1) / 2 + 6.0 * n * R + 2.0 * n * R)
    gen = torch.Generator(device=dev).manual_seed(14)
    V = state[1]
    w29 = torch.randn(n, generator=gen, dtype=torch.float64, device=dev)
    mv_ms = _cuda_ms(lambda: torch.mv(V, w29))
    print(f"  K18b, one GMRES(30) restart with its 31 matvecs, one launch of {grid} blocks: {ms_b} ms "
          f"(CUDA events, kernel twice), {plain_b:.4f} ms plain, {host_b:.2f} us of host time a launch; "
          f"bound {bound_b[0]:.6f} ms ({bound_b[1]}), the kernel at {100 * bound_b[0] / min(ms_b):.2f}% "
          f"of it; torch.mv(V, w) (the projection's yardstick) {mv_ms:.4f} ms")
    # No one PyTorch call computes a restart: torch.mv(V, w) is printed, not
    # the line's library time.
    report["gmres_cycle"] = {"err": 0.0, "ms": min(ms_b), "plain_ms": plain_b,
                             "library_ms": None, "bound": bound_b, "host_us": host_b, "grid": grid,
                             "ms_turns": ms_b, "mv_ms": mv_ms}
    return report


def run_biot_krylov(dev, method: str, device_gmres: dict, cell_size: float = 1.0 / 64) -> dict:
    """biot 1/64 for 26 steps with ``linear_solver="jax_<method>"``: the
    per-step host Newton loop, host assembly, K18 solves on the card; its
    states against those of the ``device_gmres`` run (phase 12) at the ends
    of that run's fused blocks (t = 10, 18, 26)."""
    import scipy.sparse.linalg as sps_linalg

    import porepy_tpu_torch as pt
    from porepy_tpu_torch.applications.benchmarking.cases import build_biot
    from porepy_tpu_torch.kernels import LAUNCHES, ops, reset_launches
    from porepy_tpu_torch.numerics.linalg import krylov

    solver = "jax_" + method
    print(f"phase 14: biot at cell size {cell_size:g}, 26 steps on {dev}, linear_solver={solver}")
    Model, params = build_biot(cell_size, device=str(dev))
    params.pop("fused_time_steps")
    params.pop("fused_commit_states")
    params["linear_solver"] = solver
    log = {"assemble": [], "solve": [], "iters": [], "steps": 0, "states": {}, "solve_k1": 0}
    reference_states = device_gmres["states"]

    class Logged(Model):
        def assemble_linear_system(self):
            tic = time.perf_counter()
            super().assemble_linear_system()
            log["assemble"].append(time.perf_counter() - tic)

        def solve_linear_system(self):
            k1 = LAUNCHES["ell_spmv"]
            tic = time.perf_counter()
            x = super().solve_linear_system()
            log["solve"].append(time.perf_counter() - tic)
            log["iters"].append(krylov.LAST_SOLVE["iterations"])
            log["solve_k1"] += LAUNCHES["ell_spmv"] - k1
            return x

        def after_nonlinear_convergence(self):
            log["steps"] += 1
            if log["steps"] == 26:
                # One more Newton increment at the converged state of the
                # last step, by a direct host solve.
                A, b = self.equation_system.assemble()
                dx = sps_linalg.spsolve(A.tocsc(), b)
                log["increment"] = float(np.linalg.norm(dx) / np.sqrt(dx.size))
            super().after_nonlinear_convergence()
            if float(self.time_manager.time) in reference_states:
                log["states"][float(self.time_manager.time)] = self.equation_system.get_variable_values(
                    time_step_index=0
                )

    model = Logged(params)
    fallbacks0 = krylov.FALLBACK_COUNTER["count"]
    tic = time.perf_counter()
    model.prepare_simulation()
    model._prepared = True
    setup_s = time.perf_counter() - tic
    reset_launches()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    pt.run_time_dependent_model(model, params)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - tic
    launches = dict(LAUNCHES)
    eq_sys = model.equation_system
    newton = len(log["solve"])
    iters = np.array(log["iters"])
    print(
        f"  dofs {eq_sys.num_dofs()}, setup {setup_s:.3f} s, 26 steps {run_s:.3f} s, {newton} Newton iterations, "
        f"{1e3 * run_s / max(newton, 1):.2f} ms per Newton iteration; per Newton iteration host assembly "
        f"{1e3 * np.mean(log['assemble']):.2f} ms, solve {1e3 * np.mean(log['solve']):.2f} ms; Krylov "
        f"iterations per solve mean {iters.mean():.1f}, min {iters.min()}, max {iters.max()}"
    )
    print(f"  kernel launches in the run: {launches}")
    names = ops.K18A if method == "bicgstab" else ops.K18B
    _require(krylov.FALLBACK_COUNTER["count"] == fallbacks0, f"host fallbacks {krylov.FALLBACK_COUNTER}")
    _require(all(launches[k] > 0 for k in names), f"kernel not launched: {launches}")
    if method == "bicgstab":
        # One K18a launch to start a solve and one that runs its iterations,
        # the matvecs inside it.
        print(f"  {int(iters.sum())} iterations in {newton} solves: {launches['bicgstab_cycle']} bicgstab_cycle "
              f"launches, {log['solve_k1']} K1 launches inside the solves")
        _require(launches["bicgstab_cycle"] == 2 * newton and log["solve_k1"] == 0,
                 f"bicgstab: not two launches a solve: {launches}, K1 in the solves {log['solve_k1']}")
    else:
        # One K18b launch a restart and one a solve, the matvecs inside it.
        restarts = int(iters.sum()) // 30
        print(f"  {restarts} restarts in {newton} solves: {launches['gmres_cycle']} gmres_cycle launches, "
              f"{log['solve_k1']} K1 launches inside the solves")
        _require(launches["gmres_cycle"] == restarts + newton and log["solve_k1"] == 0,
                 f"gmres: not one launch a restart: {launches}, K1 in the solves {log['solve_k1']}")
    _require(log["steps"] == 26, f"{log['steps']} steps")
    # Each field within 1e-8 of its largest value over the three states: by
    # t = 26 the pressure has decayed to ~7e-12, below what the Newton
    # tolerance (1e-10) resolves, and a bound relative to that state's own
    # maximum would measure rounding (1e-17 absolute apart on the CPU at
    # 1/16 and 1/64), so the pressure's scale is its t = 10 maximum.
    _require(sorted(log["states"]) == sorted(reference_states), f"states at {sorted(log['states'])}")
    for var, dofs in device_gmres["dofs"].items():
        scale = max(float(np.abs(x[dofs]).max()) for x in reference_states.values())
        for t, want in sorted(reference_states.items()):
            got = log["states"][t][dofs]
            err = float(np.abs(got - want[dofs]).max())
            print(f"  t = {t:g}, {var}: max |{solver} - device_gmres| {err:.3e}, max |{var}| "
                  f"{float(np.abs(want[dofs]).max()):.3e} (scale {scale:.3e})")
            _require(err <= 1e-8 * scale, f"{solver} {var} at t = {t} differs from device_gmres by {err}")
    tol = 1e-10
    print(f"  last step on the host: next Newton increment |dx|/sqrt(n) {log['increment']:.3e}, tolerance {tol:.0e}")
    _require(log["increment"] <= tol, f"Newton increment {log['increment']} > {tol}")
    return {
        "launches": sum(launches[k] for k in names), "ms_per_newton": 1e3 * run_s / max(newton, 1),
        "newton": newton, "iters_mean": float(iters.mean()), "assemble_ms": 1e3 * np.mean(log["assemble"]),
        "solve_ms": 1e3 * np.mean(log["solve"]), "run_s": run_s,
    }


N_POINTS = 2048 * 2048


def _fluid(pt, nc):
    from porepy_tpu_torch.compositional._core import PhysicalState
    from porepy_tpu_torch.compositional.base import Fluid, Phase

    comps = [pt.FluidComponent(name=f"c{i}") for i in range(nc)]
    phases = [Phase(PhysicalState.liquid, "liquid"), Phase(PhysicalState.gas, "gas")]
    for ph in phases:
        ph.components = comps
    return Fluid(comps, phases)


def check_flash(dev) -> dict:
    """K17 at 2048^2 points against its plain version (and, at nc = 3,
    against a plain run of all max_iter iterations, to the bit), and
    ConstantKFlash through its public entry point on the card."""
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.kernels import LAUNCHES, ops, reference, reset_launches

    print(f"phase 15: the constant-K flash (K17) at {N_POINTS} points")
    report = {"err": 0.0}
    for K in ([2.5, 0.3], [3.0, 0.8, 0.2]):
        nc = len(K)
        raw = np.random.default_rng(15 + nc).random((nc, N_POINTS)) + 0.02
        z_host = raw / raw.sum(axis=0)
        zs = torch.tensor(z_host, device=dev)
        Kt = torch.tensor(K, dtype=torch.float64, device=dev)
        got = ops.rachford_rice(zs, Kt, 150, 1e-8)
        want = reference.rachford_rice(zs, Kt, 150, 1e-8)
        for tag, g, w in zip(("V", "x", "y"), got[:3], want[:3]):
            err = _check(f"rachford_rice nc {nc} {tag}", (g - w).abs(), torch.tensor(1e-12, device=dev))
            report["err"] = max(report["err"], err)
        _require(torch.equal(got[3], want[3]), f"nc {nc}: converged flags differ")
        _require(torch.equal(got[4], want[4]), f"nc {nc}: iteration counts differ")
        if nc == 3:
            full = reference.rachford_rice_full(zs, Kt, 150, 1e-8)
            for tag, g, w in zip(("V", "x", "y", "converged"), got[:4], full):
                same = reference.same_bits(g, w)
                print(f"  rachford_rice nc {nc} {tag}: the bits of a plain run of all 150 iterations: {same}")
                _require(same, f"nc {nc}: {tag} differs from the full-loop plain run")
        iters = got[4].long()
        stats = reference.flash_iteration_stats(got[4], 150)
        ms = _cuda_ms(lambda: ops.rachford_rice(zs, Kt, 150, 1e-8), 10)
        plain_ms = _cuda_ms(lambda: reference.rachford_rice(zs, Kt, 150, 1e-8), 2)
        copy_ms = _cuda_ms(lambda: torch.tensor(z_host, device=dev), 5)
        back_ms = _cuda_ms(lambda: [a.cpu() for a in got[:4]], 5)
        # The iterations these inputs need (each point's own count).
        bound = _bound(*reference.flash_work(got[4], nc))
        two_phase = int(((got[0] > 0) & (got[0] < 1)).sum())
        print(
            f"    {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, copies {copy_ms:.4f} ms to the card, "
            f"{back_ms:.4f} ms back; {two_phase} two-phase points, {int(iters.sum())} iterations "
            f"(mean {stats['mean']:.3f}, the slowest lane of a warp {stats['warp_slowest']:.3f} on average, "
            f"max {int(iters.max())}, {stats['at_max']} points at 150); bound {bound[0]:.4f} ms ({bound[1]}), "
            f"{100 * bound[0] / ms:.1f}% of it"
        )
        if nc == 3:
            report.update(ms=ms, plain_ms=plain_ms, library_ms=None, bound=bound)
        reset_launches()
        flash = pt.ConstantKFlash(_fluid(pt, nc), K)
        state, success, _ = flash.compute_flash(list(z_host))
        launches = LAUNCHES["rachford_rice"]
        _require(launches > 0, "ConstantKFlash did not launch K17")
        _require(np.array_equal(state.y[1], got[0].cpu().numpy()), "compute_flash V differs from the kernel's")
        _require(np.array_equal(success == 0, got[3].cpu().numpy()), "compute_flash flags differ")
        print(f"  ConstantKFlash.compute_flash on {flash.device}, nc {nc}: {launches} launches, "
              f"{int((success == 0).sum())} of {success.size} converged")
        report["launches"] = launches
    return report


def check_lookup(dev) -> dict:
    """K16 at 2048^2 points against its plain versions (the value, the
    tangents and the dual call, each one launch, to the bit), then inside an
    EquationSystem on a 1024^2 grid on the card against the CPU."""
    from porepy_tpu_torch.applications.benchmarking import cases
    from porepy_tpu_torch.kernels import LAUNCHES, reference, reset_launches

    print(f"phase 16: the table lookup (K16), a 201 x 201 table at {N_POINTS} points")
    tab, x, dx = cases.lookup_inputs(dev)
    launcher = tab["launcher"]
    args = (tab["values"], tab["fgeom"], tab["igeom"], x)
    xs, tans = list(x.unbind(0)), list(dx.unbind(1))
    lo, hi = (torch.tensor(v, device=dev)[:, None] for v in cases.TABLE[:2])
    outside = int(((x < lo) | (x > hi)).any(0).sum())
    plain_tan = lambda: reference.interp_tangent(*args, dx)
    report = {"err": 0.0}
    table_bytes = 8.0 * tab["values"].numel()
    for tag, kern, plain, n_seeds in (
        ("value", lambda: launcher.rows(xs), lambda: reference.interp_lookup(*args), 0),
        ("tangent B=4", lambda: launcher.rows(xs, tans), plain_tan, dx.shape[0]),
        ("dual B=4", lambda: launcher(xs, tans),
         lambda: torch.cat([reference.interp_lookup(*args)[None], plain_tan()]), dx.shape[0]),
    ):
        before = LAUNCHES["interp_lookup"]
        got = kern()
        torch.cuda.synchronize()
        _require(LAUNCHES["interp_lookup"] == before + 1, f"interp_lookup {tag}: not one launch")
        want = plain()
        err = _check(f"interp_lookup {tag} ({outside} points outside the table)",
                     (got - want).abs(), 1e-13 * want.abs().max())
        _require(reference.same_bits(got, want), f"interp_lookup {tag}: not the plain version's bits")
        report["err"] = max(report["err"], err)
        ms, plain_ms = _cuda_ms(kern, 20), _cuda_ms(plain, 5)
        device_us = _graph_us(kern, launches=20, replays=3)
        value_rows = 0 if tag.startswith("tangent") else 1
        # Bytes: the 2 coordinates and 2 B seed entries in, the rows out, the
        # table once (the flat one: the function needs no more; the kernel's
        # corner-block copy of it, 4 times as large, is its own layout). Operations: ~20 per point for the cell and the 4
        # weights, ~36 per seed for the weight tangents and sums.
        bound = _bound(
            8.0 * N_POINTS * (2 + 2 * n_seeds + value_rows + n_seeds) + table_bytes,
            N_POINTS * (20.0 + 36.0 * n_seeds),
        )
        print(f"    the plain version's bits; {ms:.4f} ms kernel, device {device_us:.2f} us (graph replay), "
              f"{plain_ms:.4f} ms plain; bound {bound[0]:.4f} ms ({bound[1]})")
        if tag.startswith("tangent"):
            report.update(ms=ms, plain_ms=plain_ms, library_ms=None, bound=bound, device_us=device_us)

    nx = cases.NX_TABLE
    out = {}
    for device in (str(dev), "cpu"):
        es, op, _fun = cases.table_system(nx, device)
        reset_launches()
        tic = time.perf_counter()
        val = es.evaluate(op)
        data, b, _cs = es.assemble_device()
        data = data.cpu().numpy()
        out[device] = (val, data, b.cpu().numpy(), time.perf_counter() - tic, LAUNCHES["interp_lookup"])
    for i, tag in ((0, "evaluate"), (1, "Jacobian"), (2, "residual")):
        got, want = out[str(dev)][i], out["cpu"][i]
        err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
        print(f"  EquationSystem {nx}^2, {tag}: max |card - cpu| {err:.3e}, max {scale:.3e}")
        _require(err <= 1e-12 * scale, f"{tag}: card and cpu differ by {err}")
    launches = out[str(dev)][4]
    print(f"  evaluate + assembly on the card {out[str(dev)][3]:.3f} s, on the CPU {out['cpu'][3]:.3f} s; K16 launches {launches}")
    _require(launches == 2, f"the EquationSystem run launched K16 {launches} times, expected 2 (evaluate, assembly)")
    report["launches"] = launches
    return report


# -- K11, K19 ---------------------------------------------------------------------


def _inf_norm(m: torch.Tensor) -> torch.Tensor:
    return m.abs().sum(2).amax(1)


def _copies_in_turns(host: torch.Tensor, X: torch.Tensor, reps: int = 10) -> None:
    """The copies around a K11 batch, pageable and pinned, in turns
    (pageable, pinned, pinned, pageable): the batch to the card and the
    inverses back, ms by CUDA events (``invert_diagonal_blocks`` takes the
    pinned route)."""
    pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    pinned.copy_(host)
    back = torch.empty(X.shape, dtype=X.dtype, pin_memory=True)
    routes = {
        "pageable": (lambda: host.to(X.device), lambda: X.cpu()),
        "pinned": (lambda: pinned.to(X.device, non_blocking=True), lambda: back.copy_(X, non_blocking=True)),
    }
    out = {k: {"to": [], "back": []} for k in routes}
    for k in ("pageable", "pinned", "pinned", "pageable"):
        out[k]["to"].append(_cuda_ms(routes[k][0], reps))
        out[k]["back"].append(_cuda_ms(routes[k][1], reps))
    _require(torch.equal(back, X.cpu()), "the pinned copy differs")
    for k, v in out.items():
        print(f"    copies {k}, in turns: to the card {', '.join(f'{t:.4f}' for t in v['to'])} ms, "
              f"back {', '.join(f'{t:.4f}' for t in v['back'])} ms")


def check_block_inverse(dev, real) -> dict:
    """K11 on the real region matrices and two synthetic batches against
    its plain version, then ``invert_diagonal_blocks`` on the card."""
    import scipy.sparse as sps

    from porepy_tpu_torch.kernels import LAUNCHES, ops, reference, reset_launches
    from porepy_tpu_torch.numerics.linalg.matrix_operations import invert_diagonal_blocks

    print("phase 17: the batched block inverse (K11) against its plain version")
    gen = np.random.default_rng(17)
    batches = list(real)
    a = gen.standard_normal((64, 20, 20)) + 10.0 * np.eye(20)
    a[0, 0, 0] = 0.0
    batches.append(("synthetic, zero leading entry", a))
    batches.append(("synthetic, n 160 in shared memory", gen.standard_normal((3, 160, 160)) + 80.0 * np.eye(160)))
    batches.append(("synthetic, device workspace", gen.standard_normal((2, 200, 200)) + 100.0 * np.eye(200)))
    report = {"err": 0.0}
    for source, arr in batches:
        B, n = arr.shape[0], arr.shape[1]
        host = torch.from_numpy(np.ascontiguousarray(arr))
        A = host.to(dev)
        X = ops.block_inverse(A)
        W = reference.block_inverse(A)
        err = float((X - W).abs().max())
        scale = float(W.abs().max())
        _check(f"block_inverse {source}: B {B}, n {n}", torch.tensor(err), 1e-12 * scale)
        print(f"    equal to the plain version (the same pivots and roundings): {torch.equal(X, W)}; "
              f"{float((A == 0).double().mean()):.3f} of the entries 0")
        report["err"] = max(report["err"], err)
        eye = torch.eye(n, dtype=A.dtype, device=dev)
        resid = (A @ X - eye).abs().amax(dim=(1, 2))
        worst = float((resid / (_inf_norm(A) * _inf_norm(X))).max())
        print(f"    max |A X - I| / (||A|| ||X||) {worst:.3e} (bound 1e-10)")
        _require(worst <= 1e-10, f"block_inverse {source}: residual {worst}")
        reps = 20
        ms = _cuda_ms(lambda: ops.block_inverse(A), reps)
        plain_ms = _cuda_ms(lambda: reference.block_inverse(A), reps)
        lib_ms = _cuda_ms(lambda: torch.linalg.inv_ex(A), reps)
        h2d_ms = _cuda_ms(lambda: host.to(dev), reps)
        d2h_ms = _cuda_ms(lambda: X.cpu(), reps)
        nbytes, flops = 2 * 8.0 * B * n * n, 2.0 * B * n**3
        bound = _bound(nbytes, flops)
        print(
            f"    {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, {lib_ms:.4f} ms torch.linalg.inv_ex; "
            f"bound {bound[0]:.4f} ms ({bound[1]}); copies {h2d_ms:.4f} ms to the card, {d2h_ms:.4f} ms back"
        )
        if source == "biot 3d 16^3":
            report.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound=bound)
            _copies_in_turns(host, X)

    # The entry point on one block-diagonal matrix of both real sizes and
    # a few odd ones, seeded and well conditioned (cond < 10), so that
    # Gauss-Jordan and LAPACK's LU inverse agree to rounding.
    sizes = np.array(list(range(1, 13)) + [20] * 6 + [81] * 4 + [160])
    sizes = sizes[gen.permutation(sizes.size)]
    mat = sps.block_diag([sps.csr_matrix(gen.standard_normal((k, k)) + k * np.eye(k)) for k in sizes], format="csr")
    reset_launches()
    got = invert_diagonal_blocks(mat, sizes)
    torch.cuda.synchronize()
    launches = LAUNCHES["block_inverse"]
    want = invert_diagonal_blocks(mat, sizes, method="python")
    err = float(abs(got - want).max())
    scale = float(abs(want).max())
    print(f"  invert_diagonal_blocks, {sizes.size} blocks of {np.unique(sizes).size} sizes (n {mat.shape[0]}): "
          f"max |card - python| {err:.3e}, max {scale:.3e}; K11 launches {launches}")
    _require(err <= 1e-12 * scale, f"invert_diagonal_blocks: card and python differ by {err}")
    _require(launches == np.unique(sizes).size, f"K11 launches {launches}")
    report["launches"] = launches
    return report


def check_halo_kernels(model, n_shards: int = 4) -> tuple[dict, dict]:
    """Phase 18a: md 1/128's first Jacobian in 4 row shards and in 1 on the
    card, through ``HaloOperator`` (``applications/benchmarking/
    halo_spmv_check.py``): each launch, K1 and the two-launch route to the
    bit in f64 and f32, and the routes' times in turns in f32."""
    import tempfile

    from porepy_tpu_torch.applications.benchmarking import halo_spmv_check as check
    from porepy_tpu_torch.numerics.linalg.device_solver import DeviceLinearSolver
    from porepy_tpu_torch.parallel import halo
    from porepy_tpu_torch.parallel.placement import PermutedSystem, nnz_locality, spatial_dof_permutation

    eq = model.equation_system
    cs = eq.compiled_system()
    val64, col, n = check.md_jacobian_ell(model)
    print(f"phase 18a: md 1/128's Jacobian (n {n}, K {col.shape[1]}) in {n_shards} row shards and in 1 on the card")
    perm, _ = spatial_dof_permutation(eq, model.mdg, n_shards)
    psys = PermutedSystem(cs, perm)
    psys.device = cs.device
    pplans = halo.local_plans(DeviceLinearSolver(psys)._ell_col.cpu().numpy(), n, n_shards)
    print(f"  halo entries per shard with the spatial permutation {[p.n_halo for p in pplans]}; nnz locality "
          f"{nnz_locality(cs, n_shards):.4f}, with it {nnz_locality(cs, n_shards, perm):.4f}")
    with tempfile.TemporaryDirectory() as work:
        old = check.old_route(work)
        out = check.report(val64, col, n, old, sizes=(n_shards, 1))
    for (size, tag), r in out.items():
        for what, same in r["equal"].items():
            _require(same, f"{size} shard(s), {tag}: {what} differs from the launcher's bits")
        _require(r["launches"]["halo_interior"] == size, f"halo_interior launches {r['launches']}")
        _require((r["launches"]["halo_boundary"] > 0) == (size > 1), f"halo_boundary launches {r['launches']}")
    main, one = out[(n_shards, "float32")], out[(1, "float32")]
    print(f"  per shard call at {n_shards} shards, f32, median ms of the turns: launcher "
          f"{np.median(main['times']['launcher']['ms']):.4f}, two-launch route "
          f"{np.median(main['times']['two-launch']['ms']):.4f}, index_select + torch.mv "
          f"{np.median(main['times']['library']['ms']):.4f}; at 1 shard host us a matvec: launcher "
          f"{one['times']['launcher']['host_us']}, K1's launcher {one['times']['K1']['host_us']}")
    # halo_interior's line is the one-rank matvec that phase 18b launches
    # (every row interior, nothing to send), held against torch.mv on the
    # CSR matrix; halo_boundary's the four shards' launch B, against
    # torch.mv on the boundary rows' CSR matrix.
    report = {}
    err = max(r["err"] for r in out.values())
    for name, run in (("interior", one), ("boundary", main)):
        t = run["launch_times"]
        report["halo_" + name] = {
            "err": err, "ms": t[name]["ms"], "plain_ms": t[name + " plain"]["ms"],
            "library_ms": t[name + " library"]["ms"], "bound": (run["bounds"][name], "bytes"),
            "launches": run["launches"]["halo_" + name],
        }
    return report, {k: r["times"] for k, r in out.items() if "times" in r}


def _newton_time_step(model, step, max_iter: int = 10) -> tuple[np.ndarray, int]:
    """Newton iterations by ``step()`` until the increment is below the
    model's tolerance; returns the state and the iteration count."""
    tol = model.params.get("nl_convergence_tol", 1e-10)
    for it in range(1, max_iter + 1):
        model.before_nonlinear_iteration()
        dx, _res = step()
        if model.compute_nonlinear_increment_norm(dx) < tol:
            return model.equation_system.get_variable_values(iterate_index=0), it
    raise RuntimeError(f"chip_smoke check failed: no Newton convergence in {max_iter} iterations")


def run_sharded(dev, chunks) -> dict:
    """Phase 18: the K19 kernels at 4 row shards, ``ShardedNewton`` on md
    1/128 in a one-rank NCCL group, and the sharded region batches."""
    import tempfile

    import torch.distributed as dist

    from porepy_tpu_torch.applications.benchmarking.cases import build_md_flow
    from porepy_tpu_torch.kernels import LAUNCHES, reset_launches
    from porepy_tpu_torch.numerics.fv import local_solves
    from porepy_tpu_torch.numerics.linalg.krylov import FALLBACK_COUNTER
    from porepy_tpu_torch.parallel.sharded import ShardedNewton, make_dof_mesh

    print("phase 18: the dof-sharded Newton solve (K19) on md 1/128")
    Model, params = build_md_flow(1.0 / 128, device=str(dev))
    model = Model(params)
    model.prepare_simulation()
    model.before_nonlinear_loop()
    model.before_nonlinear_iteration()
    eq = model.equation_system
    x0 = eq.get_variable_values(iterate_index=0)
    kernels, routes = check_halo_kernels(model)

    def timed(fn):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - tic)

    # NCCL's bootstrap socket stays on the loopback: the group has one rank.
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    launches = dict.fromkeys(LAUNCHES, 0)
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1, device_id=dev)
        try:
            mesh = make_dof_mesh()
            print(f"phase 18b: ShardedNewton in a one-rank NCCL group on {mesh.device}")
            fallbacks0 = FALLBACK_COUNTER["count"]

            def counted(fn):
                """``fn()`` with the launches it makes added to the sharded
                path's counts (the unsharded runs between are not)."""
                reset_launches()
                out = fn()
                torch.cuda.synchronize()
                for k, v in LAUNCHES.items():
                    launches[k] += v
                return out

            sn = ShardedNewton(model, mesh)
            shard = sn.solver.dof_shard
            matvecs = [0]

            def matvec(op, x_own, _matvec=shard.matvec):
                matvecs[0] += 1
                return _matvec(op, x_own)

            # Counts the sharded solve's matvecs, to hold them against the
            # launches (the instance attribute shadows the method).
            shard.matvec = matvec
            (dx_s, res_s), first_ms = counted(lambda: timed(sn.solve_once))
            per_solve = {"matvecs": matvecs[0], **{k: launches[k] for k in ("halo_interior", "halo_boundary")}}

            def unsharded_once():
                data, b = sn.assemble()
                return sn.solver.solve(data, b)

            dx_u, _ = timed(unsharded_once)
            sharded_ms, unsharded_ms = [], []
            for sharded_first in (True, False, True):
                for is_sharded in (sharded_first, not sharded_first):
                    if is_sharded:
                        sharded_ms.append(counted(lambda: timed(sn.solve_once))[1])
                    else:
                        unsharded_ms.append(timed(unsharded_once)[1])
            dx_diff = float(np.abs(dx_s - dx_u).max())
            scale = float(np.abs(dx_u).max())
            print(f"  solve_once {first_ms:.2f} ms first, then {[round(t, 2) for t in sharded_ms]} ms; unsharded "
                  f"assembly + solve {[round(t, 2) for t in unsharded_ms]} ms; |r| {res_s:.3e}, "
                  f"{sn.solver.last_stats['krylov_iters']} Krylov iterations; one solve_once: {per_solve}")
            print(f"  increments: max |sharded - unsharded| {dx_diff:.3e} (max |dx| {scale:.3e}; bit-equal: {dx_diff == 0.0})")
            _require(dx_diff == 0.0, f"one-rank sharded and unsharded increments differ by {dx_diff}")
            _require(
                per_solve["halo_interior"] == per_solve["matvecs"] > 0 and per_solve["halo_boundary"] == 0,
                f"a one-rank matvec is one halo_interior launch: {per_solve}",
            )

            x_s, newton = counted(lambda: _newton_time_step(model, sn.step))
            eq.set_variable_values(x0, iterate_index=0)
            model.update_derived_quantities()

            def unsharded_step():
                data, b = sn.assemble()
                dx = sn.solver.solve(data, b)
                model.after_nonlinear_iteration(dx)
                return dx, None

            x_u, newton_u = _newton_time_step(model, unsharded_step)
            state_diff = float(np.abs(x_s - x_u).max())
            fallbacks = FALLBACK_COUNTER["count"] - fallbacks0
            print(f"  one time step: {newton} Newton iterations sharded, {newton_u} unsharded; max |state "
                  f"difference| {state_diff:.3e}; host fallbacks {fallbacks}")
            print(f"  kernel launches of the sharded runs: {matvecs[0]} matvecs, halo_interior "
                  f"{launches['halo_interior']}, halo_boundary {launches['halo_boundary']}, ell_spmv (K1, the "
                  f"preconditioner) {launches['ell_spmv']}, amg_vcycle (K3, the preconditioner) "
                  f"{launches['amg_vcycle']}")
            _require(state_diff <= 1e-10, f"sharded and unsharded states differ by {state_diff}")
            _require(fallbacks == 0, f"host fallbacks {fallbacks}")
            _require(launches["halo_interior"] == matvecs[0] > 0, "halo_interior not launched once a matvec")
            _require(launches["halo_boundary"] == 0, "halo_boundary launched on one rank")
            _require(launches["ell_spmv"] > 0, "K1 not launched in the preconditioner")
            _require(launches["amg_vcycle"] > 0, "K3 not launched in the preconditioner")

            print("phase 18c: the first and the largest K10 chunks of biot 1/64 through set_batch_mesh")
            for chunk in chunks:
                local_solves.set_batch_mesh(mesh)
                try:
                    got = local_solves._solve_chunk_device(*chunk)
                finally:
                    local_solves.set_batch_mesh(None)
                want = local_solves._solve_chunk_device(*chunk)
                err = float(np.abs(got - want).max())
                print(f"  B {chunk[0].shape[0]}, n {chunk[0].shape[1]}: max |sharded - unsharded| {err:.3e}")
                _require(err <= 1e-12 * float(np.abs(want).max()), f"sharded region batch differs by {err}")
        finally:
            dist.destroy_process_group()
    return {
        "kernels": kernels,
        "routes": routes,
        "launches": launches,
        "per_solve": per_solve,
        "sharded_ms": float(np.median(sharded_ms)),
        "unsharded_ms": float(np.median(unsharded_ms)),
        "dx_diff": dx_diff,
        "newton": newton,
    }


# -- K15, K14: tracer and the differentiable TPFA ---------------------------------


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the largest |want|."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def _same_bits(name: str, fn) -> None:
    a, b = fn(), fn()
    _require(torch.equal(a, b), f"{name}: two launches differ")


def check_upwind_tpfa_kernels(dev, cell_size: float = 1.0 / 64, n3d: int = N3D) -> dict:
    """Phase 19: the K15 kernels at the tracer 1/64 shapes and the K14
    launch at DarcysLawAd 1/128's own calls and at the 3d 32^3 shapes
    against their plain versions."""
    from porepy_tpu_torch.applications.benchmarking import tpfa_ad_calls as k14
    from porepy_tpu_torch.applications.benchmarking.cases import build_tracer
    from porepy_tpu_torch.kernels import ops, reference

    print("phase 19: K15 at the tracer 1/64 shapes, 16 seeds; K14 at DarcysLawAd 1/128's calls and at the 3d "
          "32^3 shapes, 16 seeds")
    B, tol = 16, 1e-12
    rng = np.random.default_rng(19)
    f64 = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    report = {}

    Model, params = build_tracer(cell_size, device=str(dev))
    model = Model(params)
    model.prepare_simulation()
    geom, _pattern = model._upwind_geometry(model.mdg.subdomains())
    g = geom.on(dev)
    geo = (g["lo"], g["hi"], g["is_dir"], g["is_neu"], g["sgn_div"])
    nf, nc = geom.lo.size, geom.num_cells
    q_np = rng.standard_normal(nf)
    q_np[::5] = 0.0
    q_np[2::7] = -0.0
    q, w, bc = f64(q_np), f64(rng.standard_normal(nc)), f64(rng.standard_normal(nf))
    dq, dw, dbc = (f64(rng.standard_normal((B, n))) for n in (nf, nc, nf))
    print(f"  tracer {cell_size:g}: {nf} faces, {nc} cells, {int((q == 0).sum())} faces with q = +-0")

    def flux_pair(mod):
        return (
            mod.upwind_flux(q, w, bc, *geo),
            mod.upwind_flux_tangent(q, w, bc, dq, dw, dbc, *geo),
        )

    got, want = flux_pair(ops), flux_pair(reference)
    err = max(_rel_err(a, b) for a, b in zip(got, want))
    print(f"  upwind_flux: value and {B} tangents, max rel err {err:.3e}")
    _require(err <= tol, "upwind_flux disagrees with its plain version")
    _same_bits("upwind_flux", lambda: torch.cat([t.reshape(-1) for t in flux_pair(ops)]))
    nbytes = 8 * (2 * nf + nc) + 16 * nf + 2 * nf + 8 * nf + 8 * B * (2 * nf + nc) + 8 * (1 + B) * nf
    synthetic = {"upwind_flux": {"device_us": _graph_us(lambda: flux_pair(ops)), "bytes": nbytes}}
    print(f"  upwind_flux: value and {B} tangents (the entry points' two launches), device "
          f"{synthetic['upwind_flux']['device_us']:.2f} us (graph replay), bound {1e6 * nbytes / 3.35e12:.3f} us")

    # up(w) and the two-candidate selection, value and tangent rows at once.
    ws = torch.cat([w[None], dw])
    a2, b2 = dq, dbc

    def select_pair(mod):
        return mod.upwind_select(q, ws, *geo[:4]), mod.upwind_select_pair(q, a2, b2)

    got, want = select_pair(ops), select_pair(reference)
    _require(all(torch.equal(a, b) for a, b in zip(got, want)), "upwind_select disagrees with its plain version")
    _require(torch.equal(ops.upwind_select_pair(q, a2, None), reference.upwind_select_pair(q, a2, None)),
             "upwind_select_pair with a missing candidate")
    interior = (g["lo"] >= 0) & (g["hi"] >= 0) & ~g["is_neu"] & (q == 0)
    _require(bool(interior.any()) and torch.equal(got[0][0][interior], w[g["lo"][interior]]),
             "q = +-0 does not pick lo")
    _same_bits("upwind_select", lambda: select_pair(ops)[0])
    print(f"  upwind_select: up(w) on {1 + B} rows and the pair selection on {B} rows, equal to the plain version")
    lo_c, hi_c = g["lo"].clamp_min(0), g["hi"].clamp_min(0)

    def select_library():
        return torch.where(q >= 0, ws.index_select(1, lo_c), ws.index_select(1, hi_c)), torch.where(q >= 0, a2, b2)

    synthetic["upwind_select"] = {"library_ms": _cuda_ms(select_library)}
    del model

    # K15 at the calls the dual rules make: every call of one assembly of md
    # 1/128 (the main path) and of tracer 1/64, at the first iterate, one
    # upwind_dual launch each (the value and every tangent; the interface
    # rule's product inside), equal to the plain version and to a second
    # launch to the bit; device us by graph replay, host us a call and the
    # bound at the first call of each kind. The kernels line takes tracer
    # 1/64's (its launches are tracer 1/64's): the flux and the interface
    # selection, which no one PyTorch call computes with its product.
    from porepy_tpu_torch.applications.benchmarking import upwind_calls

    for case in ("md", "tracer"):
        seen = set()
        for call in upwind_calls.case_calls(dev, case):
            name = call["launcher"].name
            with _launches_of_block() as counted:
                upwind_calls.launch(call)()
            _require(counted == {name: 1}, f"{call['label']}: launches {counted} for one call")
            upwind_calls.check_launch(call)
            if call["kind"] in seen:
                print(f"  {call['label']}: one launch, equal to the plain version and a second launch to the bit")
                continue
            seen.add(call["kind"])
            fn = upwind_calls.launch(call)
            plain = upwind_calls.launch(
                call, lambda L, p, sd=None: reference.upwind_dual(L.kind, L.geometry, p, sd))
            B_call, n = upwind_calls.batch_of(call), call["primals"][0].shape[0]
            r = {"label": call["label"], "err": 0.0, "ms": _cuda_ms(fn), "plain_ms": _cuda_ms(plain, repeats=20),
                 "device_us": _graph_us(fn), "host_us": _host_us(fn), "bytes": upwind_calls.dual_bytes(call),
                 "flops": (6 + 9 * B_call) * n if call["kind"] == "flux" else (1 + 3 * B_call) * n,
                 "library_ms": None}
            print(f"  {call['label']}: one launch, equal to the plain version and a second launch to the bit; "
                  f"device {r['device_us']:.2f} us (graph replay), host {r['host_us']:.2f} us a call, "
                  f"{r['ms']:.4f} ms by events, plain {r['plain_ms']:.4f} ms, bound "
                  f"{1e6 * r['bytes'] / 3.35e12:.3f} us ({r['bytes'] / 1e6:.3f} MB)")
            if case == "tracer":
                report[name] = r
    report["upwind_flux"]["synthetic"] = synthetic["upwind_flux"]
    report["upwind_select"]["synthetic"] = synthetic["upwind_select"]

    # K14: one launch a call (the value and every tangent, tpfa_ad_dual) at
    # DarcysLawAd 1/128's own calls of one assembly (both subdomains, flux
    # and trace, the seeds the dual rule hands it) and at 3d 32^3 (Dirichlet
    # on the x faces, Neumann elsewhere, full tensors, 16 seeds of every
    # input), against the plain version: 1e-12 of the largest entry, the
    # same bits twice, the trace's unlisted faces 0 in every row. The
    # kernels line takes the path's shape (1/128's matrix subdomain).
    darcy_calls = k14.darcy_ad_calls(dev)
    cubes = [k14.cube_call(dev, trace, n3d=n3d, B=B) for trace in (False, True)]
    k14_err = {"tpfa_ad_flux": 0.0, "tpfa_ad_trace": 0.0}
    for call in darcy_calls + cubes:
        name = "tpfa_ad_trace" if call["trace"] else "tpfa_ad_flux"
        err = k14.check_launch(call)
        print(f"  {call['label']}: one launch, value and tangents within {err:.3e} of the plain version, "
              f"the same bits twice{', unlisted faces 0' if call['trace'] else ''}")
        _require(err <= tol, f"{name} disagrees with its plain version")
        k14_err[name] = max(k14_err[name], err)

    def k14_times(call):
        launch = lambda: ops.tpfa_ad_dual(call["geom"], call["primals"], call["seeds"], call["trace"])  # noqa: E731
        n_work = call["geom"].num_half_faces if not call["trace"] else call["geom"]["boundary_faces"].shape[0]
        return {
            "ms": _cuda_ms(launch),
            "plain_ms": _cuda_ms(lambda: reference.tpfa_ad_dual(call["geom"], call["primals"], call["seeds"],
                                                                call["trace"]), repeats=10),
            "device_us": _graph_us(launch), "host_us": _host_us(launch),
            "bytes": k14.dual_bytes(call), "flops": (1 + k14.batch_of(call)) * 60 * n_work,
        }

    for call in [c for c in darcy_calls if c["geom"] is darcy_calls[0]["geom"]]:
        name = "tpfa_ad_trace" if call["trace"] else "tpfa_ad_flux"
        cube = cubes[int(call["trace"])]
        report[name] = {"err": k14_err[name], "library_ms": None, "label": call["label"], **k14_times(call),
                        "cube": {"label": cube["label"], **k14_times(cube)}}
        for r in (report[name], report[name]["cube"]):
            print(f"  {r['label']}: {r['ms']:.4f} ms by events, device {r['device_us']:.2f} us a launch (graph "
                  f"replay), host {r['host_us']:.2f} us a call, plain {r['plain_ms']:.4f} ms, bound "
                  f"{1e6 * r['bytes'] / 3.35e12:.3f} us ({r['bytes'] / 1e6:.3f} MB)")
    dgeom = cubes[0]["dgeom"]
    ncell, nface, nhf = dgeom.num_cells, dgeom.num_faces, cubes[0]["geom"].num_half_faces
    del darcy_calls, cubes

    mesh = dgeom.meshes[0]
    x_hf = f64(rng.standard_normal((B, nhf)))
    face_ptr, face_hf, cell_ptr = (t.to(dev) for t in (mesh.face_ptr, mesh.face_hf, mesh.cell_ptr))
    fi_dev, ci_dev = mesh.fi.to(dev), mesh.ci.to(dev)

    def sums(mod):
        return (mod.segment_sum_sorted(x_hf, face_ptr, face_hf, nface),
                mod.segment_sum_sorted(x_hf, cell_ptr, None, ncell))

    def sums_library():
        return (torch.zeros(B, nface, dtype=torch.float64, device=dev).index_add_(1, fi_dev, x_hf),
                torch.zeros(B, ncell, dtype=torch.float64, device=dev).index_add_(1, ci_dev, x_hf))

    got, want = sums(ops), sums(reference)
    err = max(_rel_err(a, b) for a, b in zip(got, want))
    print(f"  segment_sum_sorted: {B} rows over faces and over cells, max rel err {err:.3e}")
    _require(err <= tol, "segment_sum_sorted disagrees with its plain version")
    _same_bits("segment_sum_sorted", lambda: torch.cat(sums(ops), dim=1))
    report["segment_sum_sorted"] = {
        "err": err, "ms": _cuda_ms(lambda: sums(ops)), "plain_ms": _cuda_ms(lambda: sums(reference)),
        "bytes": 2 * 8 * B * nhf + 4 * (nface + 1 + nhf + ncell + 1) + 8 * B * (nface + ncell),
        "flops": 2 * B * nhf, "library_ms": _cuda_ms(sums_library),
    }
    # The two kernels that one PyTorch call matches, by device time (CUDA-
    # graph replay: no host dispatch in it), kernel and call in turns.
    for name, kernel_fn, library_fn in (("upwind_select", lambda: select_pair(ops), select_library),
                                        ("segment_sum_sorted", lambda: sums(ops), sums_library)):
        us = {"kernel": [], "library": []}
        for route in ("kernel", "library", "library", "kernel"):
            us[route].append(_graph_us(kernel_fn if route == "kernel" else library_fn))
        (report[name]["synthetic"] if name == "upwind_select" else report[name])["device_us"] = us
        print(f"  {name}, device us a call (graph replay, in turns): kernel {us['kernel']}, library {us['library']}")
    for name in ("upwind_flux", "upwind_select", "tpfa_ad_flux", "tpfa_ad_trace", "segment_sum_sorted"):
        r = report[name]
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library {r['library_ms']}")
    return report


@contextlib.contextmanager
def _plain_k14_k15():
    """The K14 and K15 operators swapped for their plain versions (behind
    the same autograd functions), to time an assembly both ways."""
    from porepy_tpu_torch.kernels import ops, reference

    plain = {
        "upwind_flux": reference.upwind_flux,
        "upwind_flux_tangent": reference.upwind_flux_tangent,
        "upwind_select": reference.upwind_select,
        "upwind_select_pair": reference.upwind_select_pair,
        "segment_sum_sorted": reference.segment_sum_sorted,
        "tpfa_ad_flux": reference.tpfa_ad_flux,
        "tpfa_ad_trace": reference.tpfa_ad_trace,
        "tpfa_ad_flux_tangent": lambda g, p, s: reference.tpfa_ad_tangent(reference.tpfa_ad_flux, g, p, s),
        "tpfa_ad_trace_tangent": lambda g, p, s: reference.tpfa_ad_tangent(reference.tpfa_ad_trace, g, p, s),
        "tpfa_ad_dual": reference.tpfa_ad_dual,
        "upwind_dual": lambda L, p, sd=None: reference.upwind_dual(L.kind, L.geometry, p, sd),
    }
    kernels = {name: getattr(ops, name) for name in plain}
    for name, fn in plain.items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in kernels.items():
            setattr(ops, name, fn)


def functorch_data_and_rhs(cs, x, envs) -> tuple[torch.Tensor, torch.Tensor]:
    """K8's plain version: what ``cs._data_and_rhs(x, envs)`` returns for the
    compiled system ``cs``, through ``torch.func`` (``compiler.colored_jvps``:
    ``vmap`` over ``jvp`` of each traced residual), with one gather, two
    concatenations and a negation per equation."""
    from porepy_tpu_torch.numerics.ad import compiler

    if not cs.ces:
        return cs._empty(), cs._empty()
    static = cs.__dict__.get("_functorch_static")
    if static is None:
        as_tensor = lambda a, dtype: torch.tensor(a, dtype=dtype, device=cs.device)  # noqa: E731
        static = cs._functorch_static = [
            (as_tensor(ce.gather_color, torch.int64), as_tensor(ce.rows, torch.int64),
             as_tensor(ce.seeds, torch.float64))
            for ce in cs.ces
        ]
    data, vals = [], []
    for ce, env, (gc, rj, seeds) in zip(cs.ces, envs, static):
        val, compressed = compiler.colored_jvps(ce.fn, x, env, seeds)
        data.append(compressed[gc, rj])
        vals.append(val)
    return torch.cat(data), -torch.cat(vals)


def functorch_rhs_only(cs, x, envs) -> torch.Tensor:
    """``cs._rhs_only(x, envs)`` through the traced residuals."""
    vals = [ce.fn(x, *env) for ce, env in zip(cs.ces, envs)]
    return -torch.cat(vals) if vals else cs._empty()


@contextlib.contextmanager
def _functorch_route():
    """Every compiled system assembles through :func:`functorch_data_and_rhs`
    and :func:`functorch_rhs_only` instead of the K8 pass, swapped in as
    :func:`_plain_k14_k15` swaps operators."""
    from porepy_tpu_torch.numerics.ad.equation_system import _CompiledSystem as cls

    dual = (cls._data_and_rhs, cls._rhs_only)
    cls._data_and_rhs, cls._rhs_only = functorch_data_and_rhs, functorch_rhs_only
    try:
        yield
    finally:
        cls._data_and_rhs, cls._rhs_only = dual


@contextlib.contextmanager
def _plain_assembly():
    """The plain route of an assembly inside the block: the compiled
    systems through :func:`_functorch_route`, K14 and K15 through their
    plain versions (:func:`_plain_k14_k15`), and the constant matrices'
    products through K1's plain version (``reference.ell_spmv`` where
    ``compiler._EllMatvec`` calls the kernel). Fails if the block launched
    any kernel."""
    from porepy_tpu_torch import kernels
    from porepy_tpu_torch.kernels import reference

    ell_spmv = kernels.ell_spmv
    kernels.ell_spmv = reference.ell_spmv
    try:
        with _functorch_route(), _plain_k14_k15(), _launches_of_block() as counted:
            yield
    finally:
        kernels.ell_spmv = ell_spmv
    _require(not counted, f"the plain assembly launched kernels: {counted}")


@contextlib.contextmanager
def _launches_of_block():
    """The launches made inside the block, by kernel, in the dict it yields;
    the running counts go on as if the block had not reset them."""
    from porepy_tpu_torch.kernels import LAUNCHES, reset_launches

    before = dict(LAUNCHES)
    reset_launches()
    counted: dict = {}
    try:
        yield counted
    finally:
        counted.update({k: v for k, v in LAUNCHES.items() if v})
        for k, v in before.items():
            LAUNCHES[k] = v + LAUNCHES[k]


def _k8_calls_against_plain(cs, eq_sys, label: str, tol: float = 1e-13, capture=None) -> dict:
    """Phase 22 at a case's own shapes: one assembly of the compiled system
    ``cs`` in which every call of a K8 wrapper (the equations' fused programs
    on their fields, the gathers of their unknowns and concatenations, each
    root's scatter into the nonzeros and the right-hand side with the
    system's own indices) is repeated through its plain version on the same
    inputs and held against it (``tol`` of the largest entry; the roots of md
    1/128 to the bit). The largest error by kernel."""
    from porepy_tpu_torch import kernels
    from porepy_tpu_torch.kernels import ops, reference

    errs = dict.fromkeys(K8_KERNELS, 0.0)
    calls = dict.fromkeys(K8_KERNELS, 0)

    def held(kernel_name, kernel, plain):
        def call(*args):
            got, want = kernel(*args), plain(*args)
            for g, w in zip(got, want):
                _require((g is None) == (w is None), f"{label}: {kernel_name} and its plain version differ in what is constant")
                if g is not None and g.numel():
                    _require(g.shape == w.shape, f"{label}: {kernel_name} gives {tuple(g.shape)}, plain {tuple(w.shape)}")
                    nan = torch.isnan(w)
                    _require(torch.equal(torch.isnan(g), nan), f"{label}: {kernel_name} has NaN where its plain version has none, or the reverse")
                    err = _rel_err(g.masked_fill(nan, 0.0), w.masked_fill(nan, 0.0))
                    _require(err == err, f"{label}: {kernel_name} against its plain version is not a number")
                    errs[kernel_name] = max(errs[kernel_name], err)
            calls[kernel_name] += 1
            return got

        return call

    var_call, copy_call = ops.DualGatherVar.__call__, ops.DualGatherCopy.__call__
    ew_call = ops.DualEwLauncher.__call__
    if capture is not None:
        def ew_kernel(self, inputs, batch):
            capture.append((self, list(inputs), batch))
            return ew_call(self, inputs, batch)
    else:
        ew_kernel = ew_call
    patches = [
        (ops.DualEwLauncher, "__call__", "dual_ew", ew_kernel,
         lambda self, inputs, batch: reference.dual_ew(self.program.instrs, self.program.imm, inputs, batch)),
        (ops.DualGatherVar, "__call__", "dual_gather", var_call,
         lambda self, x, colors=None, batch=0: reference.dual_gather_var(
             x, self.idx, colors, batch if colors is not None else 0)),
        (ops.DualGatherCopy, "__call__", "dual_gather", copy_call,
         lambda self, pieces, batch: reference.dual_gather_copy(pieces, batch)),
    ]
    scatter = ops.DualEwLauncher.scatter
    bits = {"dual_ew_scatter": True}

    def scatter_held(self, inputs, batch, target, data, rhs):
        scatter(self, inputs, batch, target, data, rhs)
        prog = self.program
        want_v, want_d = reference.dual_ew_scatter(prog.instrs, prog.imm, inputs, batch, target.gather_color,
                                                   target.gather_row)
        pairs = [(rhs[target.row_off:target.row_off + target.rows], want_v)]
        if batch:
            pairs.append((data[target.nnz_off:target.nnz_off + target.nnz], want_d))
        for got, want in pairs:
            if want.numel():
                bits["dual_ew_scatter"] &= bool(torch.equal(got, want))
                errs["dual_ew_scatter"] = max(errs["dual_ew_scatter"], _rel_err(got, want))
        calls["dual_ew_scatter"] += 1

    originals = [(mod, attr, getattr(mod, attr)) for mod, attr, _name, _kernel, _plain in patches]
    originals.append((ops.DualEwLauncher, "scatter", scatter))
    for mod, attr, name, kernel, plain in patches:
        setattr(mod, attr, held(name, kernel, plain))
    ops.DualEwLauncher.scatter = scatter_held
    try:
        with _launches_of_block():
            cs.assemble(eq_sys)
            n_assembly = len(capture) if capture is not None else 0
            cs.residual(eq_sys)
        if capture is not None:
            del capture[n_assembly:]  # the assembly's calls only
    finally:
        for mod, attr, original in originals:
            setattr(mod, attr, original)
    print(
        f"  phase 22 at the {label} shapes: the K8 calls of one assembly and one residual against their "
        f"plain versions on the same inputs: calls {calls}, largest error over the largest entry {errs}; "
        f"the root scatters {'equal to the bit' if bits['dual_ew_scatter'] else 'not equal to the bit'}"
    )
    _require(all(calls[k] > 0 for k in K8_KERNELS), f"{label}: a K8 wrapper was not called: {calls}")
    _require(calls["dual_ew_scatter"] == 2 * len(cs.ces), f"{label}: {calls['dual_ew_scatter']} root scatters "
             f"for {len(cs.ces)} equations in an assembly and a residual")
    _require(max(errs.values()) <= tol, f"{label}: a K8 kernel disagrees with its plain version: {errs}")
    if label == "md":
        _require(bits["dual_ew_scatter"], "md: a root scatter differs from its plain version")
    return errs


def _timed_assemblies(cs, eq_sys, repeats: int) -> float:
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        cs.assemble(eq_sys)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - tic))
    return float(np.median(times))


def _assembly_routes_in_turns(model, label: str, repeats: int = 5) -> dict:
    """Phase 23: the model's device assembly at its final state through
    ``torch.func`` and through the K8 pass, in turns (functorch, dual, dual,
    functorch): median ms of each turn, the two results held together (1e-12
    of the largest entry), the launches of one assembly by kernel, and the
    nodes without a dual rule per equation (which must be none). Then the
    K8 kernels against their plain versions on this assembly's own calls."""
    eq_sys = model.equation_system
    cs = eq_sys.compiled_system()
    turns = {"functorch": [], "dual": []}
    results = {}
    for route in ("functorch", "dual", "dual", "functorch"):
        with (_functorch_route() if route == "functorch" else contextlib.nullcontext()):
            results[route] = cs.assemble(eq_sys)
            turns[route].append(_timed_assemblies(cs, eq_sys, repeats))
    errs = [_rel_err(got, want) for got, want in zip(results["dual"], results["functorch"])]
    _require(max(errs) <= 1e-12, f"{label}: the dual route's assembly differs from functorch's by {errs}")
    with _launches_of_block() as per_assembly:
        cs.assemble(eq_sys)
    ruleless = _ruleless(model)
    print(
        f"  phase 23, {label} assembly in turns, median ms: functorch {turns['functorch']}, dual "
        f"{turns['dual']}; Jacobian and residual within {max(errs):.1e} of the largest entry"
    )
    print(
        f"  phase 23, {label}: launches of one assembly {per_assembly} (sum {sum(per_assembly.values())}); "
        f"nodes without a dual rule {ruleless}"
    )
    _require(not any(ruleless.values()), f"{label}: nodes without a dual rule: {ruleless}")
    # Each equation's root writes its nonzeros and rows: one scatter launch
    # an equation, no separate gather.
    _require(per_assembly.get("dual_ew_scatter") == len(cs.ces) and "jac_gather" not in per_assembly,
             f"{label}: {per_assembly.get('dual_ew_scatter')} root scatters for {len(cs.ces)} equations")
    if label == "md":
        # md 1/128's assembly: 107 launches, 59 dual_ew and the 2 roots'
        # scatters, 3 K15 (one a rule: the flux and twice the interface,
        # its product inside).
        _require(sum(per_assembly.values()) == 107 and per_assembly.get("dual_ew") == 59,
                 f"md: {sum(per_assembly.values())} launches an assembly, dual_ew {per_assembly.get('dual_ew')}")
    if label in ("md", "tracer"):
        k15 = per_assembly.get("upwind_flux", 0) + per_assembly.get("upwind_select", 0)
        _require(k15 == (3 if label == "md" else 6), f"{label}: {k15} K15 launches an assembly")
    capture = [] if label == "md" else None
    k8_err = _k8_calls_against_plain(cs, eq_sys, label, capture=capture)
    out = {"turns": turns, "launches": per_assembly, "err": max(errs), "k8_err": k8_err}
    out.update(_scatter_against_parent(cs, eq_sys, label, results))
    if label == "DarcysLawAd":
        out["functorch_binding"] = _functorch_binding_in_turns(cs, eq_sys, results["dual"], repeats)
    if capture:
        # The histogram of the calls' (instructions, inputs, n, B), the slots
        # their tapes need, and their device and host us summed (the
        # launchers, in turns with themselves).
        from porepy_tpu_torch.applications.benchmarking.dual_pivot_check import check_case_programs

        out["dual_ew_programs"] = check_case_programs(f"phase 22 at the {label} shapes", capture, None)
    return out


def _scatter_against_parent(cs, eq_sys, label: str, results: dict) -> dict:
    """Phase 22 and 23 at a case's shapes against the parent's route (each
    root in ``dual_ew``'s row layout, then the parent's ``jac_gather``):
    one assembly and residual by both routes to the bit, the assembly in
    turns (least and median of 20, host us) with the launches of one
    assembly by route, and the distance of each route from the functorch
    route (phase 23's difference, before and after: it must not grow). At
    md 1/128, the roots' scatter launches against their plain version to the
    bit and their device us by graph replay in turns with the parent's pair
    (``applications/benchmarking/root_scatter_check.py``)."""
    from porepy_tpu_torch.applications.benchmarking import root_scatter_check as rsc
    from porepy_tpu_torch.kernels import reference

    parent = _PARENT["k8"]
    asm = rsc.assembly_in_turns(cs, eq_sys, parent, f"phase 23, {label}", repeats=20)
    _require(asm["equal"], f"{label}: the root scatter's assembly differs from the parent route's")
    _require(asm["launches"]["new"].get("dual_ew_scatter") == len(cs.ces), f"{label}: {asm['launches']['new']}")
    with rsc.parent_route(parent):
        before = cs.assemble(eq_sys)
    diff = {
        "before": max(_rel_err(a, b) for a, b in zip(before, results["functorch"])),
        "after": max(_rel_err(a, b) for a, b in zip(results["dual"], results["functorch"])),
    }
    print(f"  phase 23, {label}: the K8 pass against the functorch route, largest difference over the largest "
          f"entry: the parent's route {diff['before']:.3e}, the root scatter {diff['after']:.3e}")
    _require(diff["after"] <= diff["before"], f"{label}: the difference from the functorch route grew: {diff}")
    out = {"parent_turns": asm, "functorch_diff": diff}
    if label == "md":
        calls = rsc.capture_roots(cs, eq_sys)
        plain = rsc.check_roots(calls, f"phase 22, {label}")
        _require(plain["equal"], f"{label}: a root scatter differs from its plain version")
        roots = rsc.roots_in_turns(calls, parent, cs, f"phase 22, {label}")
        _require(roots["equal"], f"{label}: the roots by both routes differ")
        # The line's shape: the mass balance's root, one launch.
        launcher, inputs, batch, target = calls[0]
        data = torch.empty(cs._nnz_offsets[-1], dtype=torch.float64, device=inputs[0][0].device)
        rhs = torch.empty(cs.num_rows, dtype=torch.float64, device=data.device)
        prog = launcher.program

        def one():
            launcher.scatter(inputs, batch, target, data, rhs)

        roots["line"] = {
            "err": 0.0 if plain["equal"] else plain["err"], "ms": _cuda_ms(one), "device_us": _graph_us(one),
            "plain_ms": _cuda_ms(lambda: reference.dual_ew_scatter(prog.instrs, prog.imm, inputs, batch,
                                                                   target.gather_color, target.gather_row)),
            "bytes": rsc.root_bytes(calls[:1]), "flops": (target.nnz + target.rows) * 3 * len(prog.instrs),
            "library_ms": None,
        }
        out["roots"] = roots
    return out


def _functorch_binding_in_turns(cs, eq_sys, dual, repeats: int) -> dict:
    """The ``torch.func`` route's assembly with the K14 geometry (and its
    launchers) found again by the tensors' pointers
    (``TpfaAdGeometry.cached``) and with a geometry and launcher bound a call
    (``TpfaAdGeometry.trusted``, as before), in turns (cached, per call, per
    call, cached): median ms, each within 1e-12 of the K8 pass's result."""
    from unittest import mock

    from porepy_tpu_torch.kernels import ops

    per_call = classmethod(lambda cls, tensors: cls.trusted(tensors))
    turns = {"cached": [], "per_call": []}
    errs = []
    for route in ("cached", "per_call", "per_call", "cached"):
        patch = mock.patch.object(ops.TpfaAdGeometry, "cached", per_call) if route == "per_call" else (
            contextlib.nullcontext())
        with _functorch_route(), patch:
            got = cs.assemble(eq_sys)
            errs.append(max(_rel_err(a, b) for a, b in zip(got, dual)))
            turns[route].append(_timed_assemblies(cs, eq_sys, repeats))
    print(f"  phase 23, DarcysLawAd functorch assembly in turns, median ms: the K14 launchers found by the "
          f"tensors' pointers {turns['cached']}, bound a call {turns['per_call']}; within {max(errs):.1e} of the "
          f"dual route")
    _require(max(errs) <= 1e-12, f"DarcysLawAd: the functorch route differs from the dual route by {errs}")
    return turns


def _assembly_in_turns(model, label: str, repeats: int = 5) -> dict:
    """The model's device assembly (Jacobian data and residual) at its final
    state, through the K14/K15 kernels and through their plain versions, in
    turns (plain, kernels, kernels, plain): median ms of each turn, and the
    two results held together (1e-12 of the largest entry)."""
    eq_sys = model.equation_system
    cs = eq_sys.compiled_system()
    turns = {"plain": [], "kernels": []}
    results = {}
    for route in ("plain", "kernels", "kernels", "plain"):
        with (_plain_k14_k15() if route == "plain" else contextlib.nullcontext()):
            results[route] = cs.assemble(eq_sys)
            times = []
            for _ in range(repeats):
                torch.cuda.synchronize()
                tic = time.perf_counter()
                cs.assemble(eq_sys)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - tic))
        turns[route].append(float(np.median(times)))
    for got, want in zip(results["kernels"], results["plain"]):
        _require(_rel_err(got, want) <= 1e-12, f"{label}: assembly by kernels differs from the plain versions")
    print(
        f"  {label} assembly in turns, median ms: plain versions {turns['plain']}, "
        f"kernels {turns['kernels']}; results within 1e-12"
    )
    return turns


def _run_fused_case(dev, Model, params, local_solves: str = "host", blocks: int = 3, compile_first: bool = False):
    """``Model(params)`` prepared (its discretization by ``local_solves``;
    with ``compile_first`` its equations then compiled and assembled once,
    timed apart) and run on ``dev`` with launch counts reset just before;
    ``blocks`` fused blocks committed. The model, the counts and the
    times."""
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.kernels import LAUNCHES, reset_launches
    from porepy_tpu_torch.numerics.linalg.krylov import FALLBACK_COUNTER

    class Logged(timed_model(Model, dev)):
        """Keeps the Newton and Krylov counts and the wall time of every
        time step that ran outside a fused block."""

        def after_nonlinear_convergence(self, *args, **kwargs):
            stats = next(iter(self._device_solvers.values())).last_stats
            if not stats.get("block"):
                # The host-orchestrated Newton loop keeps only its last
                # solve's count.
                krylov = stats.get("krylov_iters_per_newton", [stats["krylov_iters"]])
                self.step_log.append((
                    time.perf_counter() - self.step_tic,
                    self.nonlinear_solver_statistics.num_iteration,
                    "device" if stats.get("fused") else "host",
                    list(krylov),
                ))
            self.step_tic = time.perf_counter()
            return super().after_nonlinear_convergence(*args, **kwargs)

    model = Logged(params)
    model.block_log = []
    model.block_states = {}
    model.step_log = []
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    disc_s = []
    discretize = model.discretize

    def timed_discretize():
        sync()
        tic = time.perf_counter()
        discretize()
        sync()
        disc_s.append(time.perf_counter() - tic)

    model.discretize = timed_discretize
    fallbacks0 = FALLBACK_COUNTER["count"]
    sync()
    reset_launches()
    tic = time.perf_counter()
    with _local_solves(local_solves):
        model.prepare_simulation()
    model._prepared = True
    sync()
    setup_s = time.perf_counter() - tic
    model.discretize = discretize
    compile_s = None
    if compile_first:
        tic = time.perf_counter()
        model.equation_system.compiled_system().assemble(model.equation_system)
        sync()
        compile_s = time.perf_counter() - tic
    setup_launches = dict(LAUNCHES)
    tic = model.step_tic = time.perf_counter()
    pt.run_time_dependent_model(model, params)
    sync()
    run_s = time.perf_counter() - tic
    launches = dict(LAUNCHES)
    steps = len(model.nonlinear_solver_statistics.history)
    print(f"  on {dev}: dofs {model.equation_system.num_dofs()}, setup {setup_s:.3f} s, {steps} steps {run_s:.3f} s")
    for i, (secs, newton, loop, krylov) in enumerate(model.step_log):
        print(
            f"  step {i + 1} outside the blocks: {secs:.3f} s, {newton} Newton iterations in the "
            f"{loop} Newton loop, Krylov iterations {krylov}"
        )
    for i, (secs, rec) in enumerate(model.block_log):
        print(
            f"  block {i}: {secs:.4f} s, {rec['steps']} steps, "
            f"{rec['newton_iters']} Newton, {rec['krylov_iters']} Krylov, "
            f"{1e3 * secs / max(rec['newton_iters'], 1):.2f} ms per Newton iteration"
        )
    _require(getattr(model, "_ftb_blocks_committed", 0) == blocks, f"blocks {getattr(model, '_ftb_blocks_committed', 0)}")
    _require(FALLBACK_COUNTER["count"] == fallbacks0, f"host fallbacks {FALLBACK_COUNTER}")
    newton = sum(rec["newton_iters"] for _s, rec in model.block_log)
    block_s = sum(s for s, _rec in model.block_log)
    return model, {
        "launches": launches, "setup_launches": setup_launches, "setup_s": setup_s,
        "disc_s": sum(disc_s), "compile_s": compile_s,
        "ms_per_newton": 1e3 * block_s / max(newton, 1), "newton": newton,
        "krylov": sum(rec["krylov_iters"] for _s, rec in model.block_log),
    }


def _final_fields(model, names=None) -> dict:
    """``model``'s final state by field: those of ``names``, or every
    variable's."""
    es = model.equation_system
    names = names or sorted({v.name for v in es.variables})
    return {name: es.get_variable_values([name], time_step_index=0) for name in names}


def _fields_close(model, host, names, tol) -> None:
    """Each field of ``names`` of ``model``'s final state within ``tol`` of
    the field's largest value of the host's final state (``host``: a model,
    or its fields by name)."""
    host = host if isinstance(host, dict) else _final_fields(host, names)
    for name in names:
        a = model.equation_system.get_variable_values([name], time_step_index=0)
        b = host[name]
        diff, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
        print(f"  {name}: card against host max |diff| {diff:.3e} (largest value {scale:.3e})")
        _require(diff <= tol * scale, f"{name} differs from the host plain path by {diff}")


def tracer_case(cell_size: float, dense: bool, dev) -> tuple:
    """The tracer case at ``cell_size``, 26 steps of 60 s, on ``dev`` with
    ``dense_precond=dense`` (phase 20, and its host plain path): the model
    and :func:`_run_fused_case`'s numbers."""
    from porepy_tpu_torch.applications.benchmarking.cases import build_tracer

    Model, params = build_tracer(cell_size, device=str(dev))
    params["dense_precond"] = dense
    return _run_fused_case(dev, Model, params)


def berre3d_small_case(dev) -> tuple:
    """berre3d on the 8^3 lattice (5,136 dofs), 4 steps of 1.0 (2 per-step
    solves and one fused 2-step block) on ``dev`` (phase 26b, on the card
    and on the host): the model and :func:`_run_fused_case`'s numbers."""
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.applications.benchmarking.cases import berre3d_lattice_mdg, berre3d_on

    Model, params = berre3d_on(berre3d_lattice_mdg(8), device=str(dev))
    params["time_manager"] = pt.TimeManager([0, 4.0], 1.0, constant_dt=True)
    return _run_fused_case(dev, Model, params, blocks=1)


def fb2d4_case(cell_size: float, dev) -> tuple:
    """Case 4 at ``cell_size`` on ``dev``, the example's one step, with no
    host fallback (phase 27b, on the card and on the host): the model and
    ``None``."""
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.numerics.linalg.krylov import FALLBACK_COUNTER

    fallbacks0, tic = FALLBACK_COUNTER["count"], time.perf_counter()
    model, params = _fb2d4_model(dev, cell_size)
    pt.run_time_dependent_model(model, params)
    _require(FALLBACK_COUNTER["count"] == fallbacks0, f"fb2d4 at {cell_size:g} m on {dev}: host fallbacks")
    print(f"  on {dev}: {model.equation_system.num_dofs()} dofs, {time.perf_counter() - tic:.3f} s, Krylov per "
          f"solve {model.log['krylov']}")
    return model, None


def fb3d3_small_case(dev) -> tuple:
    """Case 3 on the ``FB3D3_LATTICE`` lattice on ``dev``, the example's one
    step by ``device_gmres``, with no host fallback and the benchmark's
    checks (phase 28b, on the card and on the host): the model and
    ``None``."""
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.applications.benchmarking.cases import fb3d3_lattice
    from porepy_tpu_torch.numerics.linalg.krylov import FALLBACK_COUNTER

    fallbacks0, tic = FALLBACK_COUNTER["count"], time.perf_counter()
    model, params = _fb3d3_model(dev, grid=fb3d3_lattice(FB3D3_LATTICE))
    pt.run_time_dependent_model(model, params)
    _require(FALLBACK_COUNTER["count"] == fallbacks0, f"fb3d3 at {FB3D3_LATTICE} on {dev}: host fallbacks")
    print(f"  on {dev}: {model.equation_system.num_dofs()} dofs, {time.perf_counter() - tic:.3f} s, Krylov per "
          f"solve {model.log['krylov']}, field split {next(iter(model._device_solvers.values()))._builder.methods}")
    fb3d3_checks(model, f"fb3d3 at {FB3D3_LATTICE} on {dev}")
    return model, None


#: Phase 30's gate on the card's fields at 1/32 against the host plain
#: path (the same ``device_gmres`` route, the kernels' plain versions),
#: relative to each field's largest value. Newton stops at an increment of
#: 1e-10 on both, so the fields agree to about that: on the CPU the route
#: and a direct solve are 1.5e-11 apart at 1/16 (the damage history), and
#: the H100's history at 1/32 read 2.6e-11, 5.4e-11 and 1.1e-10 from the
#: host's in three runs (the tractions 7.9e-13 to 3.4e-12). 1e-8 is the
#: other phases' field gate, ~90 times that spread.
DAMAGE_HOST_TOL = 1e-8
#: Phase 31b's gate on the tip SIFs of the card's 16 x 16 run against the
#: host's, relative to the largest: the H100's read 8.7e-16 from the
#: host's in three runs; on the CPU the port's and porepy_tpu's device routes
#: give SIFs 7.1e-14 apart (``tests/test_torch_fracture_propagation.py``).
PROPAGATION_SIF_TOL = 1e-8
#: The critical SIFs of phase 31 (``tests/numerics/test_propagation.py``'s
#: growing case), and its steps.
CRITICAL_SIF, PROPAGATION_STEPS = 1e-4, 4


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _topology_refs(model) -> list:
    """Weak references to the objects of the model's current topology that
    must not outlive it: the compiled system, its device solver and the
    solver's dense block inverses (K6)."""
    import weakref

    es = model.equation_system
    refs = [weakref.ref(cs) for cs in es._compiled_systems.values()]
    for solver in getattr(model, "_device_solvers", {}).values():
        refs.append(weakref.ref(solver))
        state = solver._m_state or {}
        refs.extend(weakref.ref(t) for t in state.get("dense", {}).values())
    return refs


def _alive(refs) -> int:
    """How many of ``refs`` still point to an object, after a collection."""
    import gc

    gc.collect()
    return sum(r() is not None for r in refs)


def _ruleless(model) -> dict:
    """The nodes without a dual rule of the model's compiled system, by
    equation (compiling it if it is not yet)."""
    cs = model.equation_system.compiled_system()
    return {name: list(ce.fn.dual.ruleless) for name, ce in zip(cs.names, cs.ces)}


def damage_case(cell_size: float, dev, history: str = "anisotropic") -> tuple:
    """The damage case (``cases.build_fracture_damage``) at ``cell_size`` on
    ``dev`` (phase 30, and the host plain path of 30b), each step logged in
    ``model.steps``: the seconds of the history equation's rebuild
    (``before_nonlinear_loop``), of the system's compile, of the Newton
    loop, whether the fused device Newton loop ran it, the Newton and
    Krylov counts, the history, and how many objects of the step before's
    compiled system, solver and dense inverses are still alive at this
    step's end. The model and ``None``."""
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.applications.benchmarking.cases import build_fracture_damage

    Model, params = build_fracture_damage(cell_size, device=str(dev), history=history)

    class Logged(Model):
        def before_nonlinear_loop(self):
            rec = {"fused": None}
            self.steps.append(rec)
            _sync(dev)
            tic = time.perf_counter()
            super().before_nonlinear_loop()
            _sync(dev)
            rec["update_s"] = time.perf_counter() - tic
            tic = time.perf_counter()
            self.equation_system.compiled_system()
            _sync(dev)
            rec["compile_s"] = time.perf_counter() - tic
            rec["tic"] = time.perf_counter()

        def fused_newton_loop(self, nl_params):
            out = super().fused_newton_loop(nl_params)
            self.steps[-1]["fused"] = bool(out)
            return out

        def after_nonlinear_convergence(self):
            _sync(dev)
            rec = self.steps[-1]
            rec["newton_s"] = time.perf_counter() - rec.pop("tic")
            rec["newton"] = self.nonlinear_solver_statistics.num_iteration
            solver = next(iter(self._device_solvers.values()))
            rec["krylov"] = solver.last_stats.get("krylov_iters_per_newton", solver.last_stats["krylov_iters"])
            super().after_nonlinear_convergence()
            rec["h"] = self.equation_system.get_variable_values(["damage_history"], time_step_index=0)
            rec["alive_before"], rec["watched"] = (_alive(self._refs) if self._refs else 0), len(self._refs)
            self._refs = _topology_refs(self)

    model = Logged(params)
    model.steps, model._refs = [], []
    model.smoke_extra = {"steps": model.steps}
    pt.run_time_dependent_model(model, params)
    return model, None


def propagation_case(n: int, dev, steps: int = PROPAGATION_STEPS) -> tuple:
    """``tests/numerics/test_propagation.py``'s tension model on an ``n`` x
    ``n`` Cartesian grid on ``dev`` (phase 31, and the host plain path of
    31b): the fracture from (0.25, 0.5) to (0.5, 0.5) in the unit square,
    the plate pulled apart by 0.01 at north and south, ``critical_sifs``
    ``CRITICAL_SIF``, ``steps`` steps of 1.0, ``device_gmres`` with dense
    block inverses and up to 20 Newton iterations (the contact cases'
    route). Each propagation is logged in ``model.steps``: the route of
    the step's solve (the field split, its dense blocks, whether the Newton
    loop ran fused on the device), the host faces opened, the fracture's cells, the tip SIFs (mode I) and the tips that
    grew, the seconds of the criterion and of the rebuild, of the rebuilt
    system's compile, its nodes without a dual rule, the entries of the
    compiler's device constants and the card's allocated bytes after the
    rebuild, and how many objects of the topology before the last rebuild
    were still alive at this step's end. The model and ``None``."""
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.fracs import meshing
    from porepy_tpu_torch.numerics.ad import compiler

    class _TensionPropagation(pt.ConformingFracturePropagation, pt.MomentumBalance):
        def __init__(self, params, mdg):
            self._injected_mdg = mdg
            super().__init__(params)

        def set_geometry(self):
            self.mdg = self._injected_mdg
            self.nd = 2
            self._domain = pt.Domain({"xmin": 0, "xmax": 1, "ymin": 0, "ymax": 1})
            pt.set_local_coordinate_projections(self.mdg)
            self.set_well_network()

        def set_well_network(self):
            self.well_network = None

        def bc_type_mechanics(self, sd):
            sides = self.domain_boundary_sides(sd)
            bc = pt.BoundaryConditionVectorial(sd, sides.north | sides.south, "dir")
            bc.internal_to_dirichlet(sd)
            return bc

        def bc_values_displacement(self, bg):
            sides = self.domain_boundary_sides(bg)
            vals = np.zeros((self.nd, bg.num_cells))
            vals[1, sides.north] = 0.01
            vals[1, sides.south] = -0.01
            return vals.ravel("F")

        def initialize_data_saving(self):
            pass

        def save_data_time_step(self):
            pass

        def fused_newton_loop(self, nl_params):
            out = super().fused_newton_loop(nl_params)
            self._fused = bool(out)
            return out

        def evaluate_propagation(self):
            rec = {"alive_before": _alive(self._refs) if self._refs else 0, "watched": len(self._refs),
                   "rebuild_s": 0.0, "fused": self._fused}
            self.steps.append(rec)
            self._refs = _topology_refs(self)
            sd_l = self.mdg.subdomains(dim=1)[0]
            rec["dofs"] = self.equation_system.num_dofs()
            builder = next(iter(self._device_solvers.values()))._builder
            rec["route"] = (list(builder.methods), dict(builder._block_dense))
            del builder  # the rebuild below must free the solver
            _sync(dev)
            tic = time.perf_counter()
            super().evaluate_propagation()
            _sync(dev)
            rec["criterion_s"] = time.perf_counter() - tic - rec["rebuild_s"]
            data_l, data_h = self.mdg.subdomain_data(sd_l), self.mdg.subdomain_data(self.mdg.subdomains(dim=2)[0])
            sifs = data_l["SIFs"][0]
            rec["sifs"] = sifs[sifs != 0].copy()
            rec["grew"] = sifs[data_l["propagate_faces"]].copy()
            rec["opened"] = np.asarray(data_h.get("new_faces", np.zeros(0, int))).copy()
            rec["cells"] = sd_l.num_cells
            rec["propagated"] = self.has_propagated()
            _alive([])
            rec["consts"] = len(compiler._DEVICE_CONSTS)
            if torch.device(dev).type == "cuda":
                rec["memory"] = torch.cuda.memory_allocated()
            tic = time.perf_counter()
            rec["ruleless"] = _ruleless(self)
            _sync(dev)
            rec["compile_s"] = time.perf_counter() - tic

        def _rebuild_after_propagation(self):
            _sync(dev)
            tic = time.perf_counter()
            super()._rebuild_after_propagation()
            _sync(dev)
            self.steps[-1]["rebuild_s"] = time.perf_counter() - tic

    mdg = meshing.cart_grid([np.array([[0.25, 0.5], [0.5, 0.5]])], np.array([n, n]), physdims=[1.0, 1.0])
    params = {
        "critical_sifs": [CRITICAL_SIF, CRITICAL_SIF],
        "times_to_export": [],
        "time_manager": pt.TimeManager([0, float(steps)], 1.0, constant_dt=True),
        "material_constants": {
            "solid": pt.SolidConstants(shear_modulus=1.0, lame_lambda=1.0, residual_aperture=1e-3),
        },
        "linear_solver": "device_gmres",
        "dense_precond": True,
        "max_iterations": 20,
        "device": str(dev),
    }
    model = _TensionPropagation(params, mdg)
    model.steps, model._refs, model._fused = [], [], False
    model.smoke_extra = {"steps": model.steps}
    pt.run_time_dependent_model(model, params)
    return model, None


#: The host plain-path runs that phases 26b, 27b, 28b, 30b, 31b and 20 hold
#: the card against: each the phase's own case with the device left out,
#: the longest first, then in the order the phases need them.
#: :func:`start_host_runs` starts them in worker processes; a phase finds
#: its run by the case and its arguments (:func:`host_fields`).
HOST_RUNS = (
    functools.partial(tracer_case, 1.0 / 64, False),
    functools.partial(berre3d_small_case),
    functools.partial(fb2d4_case, 20.0),
    functools.partial(fb3d3_small_case),
    functools.partial(damage_case, 1.0 / 32),
    functools.partial(propagation_case, 16),
    functools.partial(tracer_case, 1.0 / 32, False),
)
_HOST = {"pool": None, "futures": {}}


def _run_key(run) -> tuple:
    return run.func, run.args, tuple(sorted(run.keywords.items()))


def _host_worker_init() -> None:
    # The workers compute on the host alone: no CUDA device is visible to
    # them, so none opens a context on the card; two threads each, below
    # the card's phases in priority.
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    os.nice(10)
    torch.set_num_threads(2)


def _host_job(run) -> tuple[str, dict]:
    """``run`` on the host CPU: its printed lines and its final fields, with
    what the case records in ``model.smoke_extra``."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        model, _ = run(torch.device("cpu"))
    # A case's own record beside its fields (phases 30b and 31b's steps).
    return out.getvalue(), {**_final_fields(model), **getattr(model, "smoke_extra", {})}


def _host_worker(run) -> tuple[str, dict]:
    text, fields = _host_job(run)
    _require(not torch.cuda.is_initialized(), f"the host run {run} initialized CUDA")
    return text, fields


def start_host_runs() -> None:
    """Start every run of ``HOST_RUNS`` in two spawned worker processes;
    :func:`stop_host_runs` ends them."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(max_workers=2, mp_context=multiprocessing.get_context("spawn"),
                               initializer=_host_worker_init)
    _HOST["pool"] = pool
    for run in HOST_RUNS:
        _HOST["futures"][_run_key(run)] = pool.submit(_host_worker, run)
    print(f"the host plain-path runs started in 2 worker processes of 2 threads each, on a host of "
          f"{os.cpu_count()} cores ({len(os.sched_getaffinity(0))} usable by this process)")


def stop_host_runs() -> None:
    """Cancel the host runs not yet started and wait for those running."""
    pool, _HOST["pool"] = _HOST["pool"], None
    _HOST["futures"].clear()
    if pool is not None:
        pool.shutdown(cancel_futures=True)


def host_fields(run) -> dict:
    """The final fields of ``run`` (a case with its device left out) on the
    host: from the worker that runs it (``HOST_RUNS``), once it is done, or
    run here when no worker has it (no pool started, as when a phase runs
    alone); its printed lines are printed here."""
    future = _HOST["futures"].pop(_run_key(run), None)
    tic = time.perf_counter()
    text, fields = future.result() if future is not None else _host_job(run)
    print(f"  the host plain path ({run.func.__name__}{run.args}{', in a worker process' if future else ''}; "
          f"waited {time.perf_counter() - tic:.1f} s):")
    print(text, end="")
    return fields


def run_tracer(dev, dense: bool, cell_size: float = 1.0 / 64, turns: bool = False):
    """Phase 20: the tracer case at ``cell_size`` for 26 steps on ``dev``;
    with ``turns`` also its assembly in turns (phases 20 and 23); with
    ``dense``, K2 on the Jacobi block of the case's AMG field split."""
    print(f"phase 20: tracer at cell size {cell_size:g}, 26 steps of 60 s, dense_precond={dense}")
    model, out = tracer_case(cell_size, dense, dev)
    launches = out["launches"]
    print(f"  kernel launches in the run: {launches}; largest K of a K1 matrix {largest_ell_k(model)}")
    needed = ("ell_spmv", "fgmres_arnoldi", "upwind_flux", "upwind_select") + K8_KERNELS
    solver = next(iter(model._device_solvers.values()))
    if not dense:
        # The AMG field split: a V-cycle on the pressure block, sweeps on
        # the transport block (``s = sweeps - 1`` a launch; a count frozen
        # at 1 is ``sinv r`` alone and launches nothing).
        needed += ("amg_vcycle",)
        print(f"  methods {solver._builder.methods}, Jacobi sweeps frozen {solver._builder._jac_sweeps} "
              f"(0: 8 sweeps); jacobi_sweeps launches {launches['jacobi_sweeps']}")
    _require(all(launches[k] > 0 for k in needed), f"kernel not launched: {launches}")
    _require(solver._dense == dense, f"dense {solver._dense}")
    x = model.equation_system.get_variable_values(time_step_index=0)
    _require(bool(np.all(np.isfinite(x))), "non-finite state")
    z = model.equation_system.get_variable_values(["z_tracer"], time_step_index=0)
    print(f"  z_tracer in [{z.min():.3e}, {z.max():.6f}]")
    _require(z.min() >= -1e-8 and z.max() <= 0.2 + 1e-8, f"z_tracer {z.min()}..{z.max()}")
    # The host plain path runs the AMG field split at either size.
    host = host_fields(functools.partial(tracer_case, cell_size, False))
    _fields_close(model, host, ("pressure", "z_tracer"), 1e-8)
    res, inc = last_step_check(model)
    tol = float(model.params["nl_convergence_tol"])
    print(
        f"  last step on the host, plain path: |F|/sqrt(n) {res:.3e}, "
        f"next Newton increment |dx|/sqrt(n) {inc:.3e}, tolerance {tol:.0e}"
    )
    _require(inc <= tol, f"Newton increment {inc} > {tol}")
    if turns:
        out["assembly_turns"] = _assembly_in_turns(model, "tracer")
        out["routes"] = _assembly_routes_in_turns(model, "tracer")
    if dense:
        out["k2"] = check_jacobi_block(amg_jacobi_block(model), f"tracer {cell_size:g}'s", (1, 2, 8, 40))
    return out


def check_jacobi_block(jb: dict, label: str, counts) -> dict:
    """K2 on the Jacobi block ``jb`` (its ``val``, ``col``, ``sinv``):
    ``vcycle_check.check_sweeps`` with each ``s`` in ``counts``; the last
    count's numbers beside them."""
    from porepy_tpu_torch.applications.benchmarking import vcycle_check

    out = vcycle_check.check_sweeps(jb["val"], jb["col"], jb["sinv"], f"{label} Jacobi block", counts=counts)
    out.update(out["by_s"][counts[-1]], s=counts[-1])
    return out


def amg_jacobi_block(model) -> dict:
    """The Jacobi block of the model's AMG field split
    (``dense_precond=False``) at its final Jacobian."""
    from porepy_tpu_torch.numerics.linalg.device_solver import DeviceLinearSolver

    dense = next(iter(model._device_solvers.values()))
    solver = DeviceLinearSolver(
        dense.system, blocks=dense._builder.blocks, methods=list(dense._builder.methods), dense=False
    )
    eq_sys = model.equation_system
    solver.refresh_preconditioner(eq_sys.compiled_system().assemble(eq_sys)[0])
    ((i, jb),) = solver._m_state["jac"].items()
    print(f"phase 20: K2 at the Jacobi block of the final state's AMG field split (a build here would "
          f"freeze {solver._builder._jac_sweeps[i]} sweeps)")
    return jb


def run_darcy_ad(dev, cell_size: float = 1.0 / 128) -> dict:
    """Phase 21: the ``DarcysLawAd`` model at 1/128 for 26 steps on ``dev``."""
    from porepy_tpu_torch.applications.benchmarking.cases import build_darcy_ad
    from porepy_tpu_torch.applications.benchmarking.tpfa_ad_calls import assemblies

    print(f"phase 21: DarcysLawAd + cubic law + k(p) at cell size {cell_size:g}, 26 steps, TPFA discretized on the card")
    first = {}
    for device in ("cpu", str(dev)):
        Model, params = build_darcy_ad(cell_size, device)
        m = Model(params)
        m.prepare_simulation()
        first[device] = m.equation_system.assemble()
    (A_h, b_h), (A_c, b_c) = first["cpu"], first[str(dev)]
    jac_diff = float(abs(A_c - A_h).max() / abs(A_h).max())
    rhs_diff = float(np.abs(b_c - b_h).max() / max(np.abs(b_h).max(), 1e-300))
    print(f"  first iterate, card against host: Jacobian {jac_diff:.3e}, residual {rhs_diff:.3e} (relative to the largest entry)")
    _require(jac_diff <= 1e-10 and rhs_diff <= 1e-10, "first Jacobian differs from the host plain path")

    Model, params = build_darcy_ad(cell_size, "cpu")
    host_model, _ = _run_fused_case(torch.device("cpu"), Model, params)
    Model, params = build_darcy_ad(cell_size, str(dev))
    with assemblies() as counted:
        model, out = _run_fused_case(dev, Model, params, local_solves="k10")
    launches = out["launches"]
    print(f"  kernel launches in the run: {launches}; largest K of a K1 matrix {largest_ell_k(model)}")
    _require(out["setup_launches"]["segment_sum_sorted"] > 0, "segment_sum_sorted not launched in the discretization")
    needed = ("ell_spmv", "fgmres_arnoldi", "tpfa_ad_flux", "tpfa_ad_trace", "segment_sum_sorted") + K8_KERNELS
    _require(all(launches[k] > 0 for k in needed), f"kernel not launched: {launches}")
    # K14: one launch a subdomain an assembly for the flux and for the trace.
    n_sub = len([sd for sd in model.mdg.subdomains() if sd.dim > 0])
    once = n_sub * sum(counted.values())
    print(f"  K14: {launches['tpfa_ad_flux']} flux and {launches['tpfa_ad_trace']} trace launches in "
          f"{sum(counted.values())} assemblies ({counted}) of {n_sub} subdomains")
    _require(launches["tpfa_ad_flux"] == once and launches["tpfa_ad_trace"] == once,
             f"K14 launches {launches['tpfa_ad_flux']}, {launches['tpfa_ad_trace']}: expected {once} each")
    out["k14_assemblies"] = sum(counted.values())
    p = model.equation_system.get_variable_values(["pressure"], time_step_index=0)
    _require(bool(np.all(np.isfinite(p))), "non-finite state")
    print(f"  pressure in [{p.min():.6f}, {p.max():.6f}]")
    _require(p.min() >= -1e-8 and p.max() <= 1.0 + 1e-8, f"pressure {p.min()}..{p.max()}")
    _fields_close(model, host_model, ("pressure", "interface_darcy_flux"), 1e-8)
    res, inc = last_step_check(model)
    tol = 1e-10
    print(
        f"  last step on the host, plain path: |F|/sqrt(n) {res:.3e}, "
        f"next Newton increment |dx|/sqrt(n) {inc:.3e}, tolerance {tol:.0e}"
    )
    _require(inc <= tol, f"Newton increment {inc} > {tol}")
    out["assembly_turns"] = _assembly_in_turns(model, "DarcysLawAd")
    out["routes"] = _assembly_routes_in_turns(model, "DarcysLawAd")
    return out


# -- K8: the forward-mode assembly by hand ----------------------------------------


def check_dual_kernels(dev) -> dict:
    """Phase 22: ``dual_ew`` and ``dual_gather`` against their plain
    versions at the md 1/128 shapes, 16 seeds (the roots' scatter at md
    1/128's own roots, inside phase 4: ``_scatter_against_parent``)."""
    from porepy_tpu_torch.applications.benchmarking import dual_pivot_check
    from porepy_tpu_torch.kernels import ops, reference

    print("phase 22: the K8 kernels at the md 1/128 shapes, 16 seeds")
    B, tol = 16, 1e-13
    ndof, nc, nm = N_ROWS, 16969, 1188
    rng = np.random.default_rng(22)
    f64 = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    report = {}

    # Phase 22's program, a mass-balance-like expression: a constant field, a
    # scalar, the larger of two duals, an exponential, a constant power and a
    # quotient (dual_pivot_check.phase22_program).
    program, inputs = dual_pivot_check.phase22_inputs(dev, B, nc)
    launch = ops.DualEwLauncher(program)
    got = launch(inputs, B)
    want = reference.dual_ew(program.instrs, program.imm, inputs, B)
    err = max(_rel_err(a, b) for a, b in zip(got, want))
    print(f"  dual_ew: {len(program.instrs)} instructions on {nc} elements, value and {B} tangents, max rel err {err:.3e}")
    _require(err <= tol, "dual_ew disagrees with its plain version")
    _same_bits("dual_ew", lambda: torch.cat([t.reshape(-1) for t in launch(inputs, B)]))
    value_only = launch(inputs, 0)
    _require(value_only[1] is None and _rel_err(value_only[0], want[0]) <= tol, "dual_ew without seeds")
    functional = ops.dual_ew(program, inputs, B)
    _require(all(torch.equal(a, b) for a, b in zip(functional, got)), "ops.dual_ew and the launcher differ")
    # Every opcode, a program a family, at the md 1/128 shapes.
    for family, (fam_program, _order) in dual_pivot_check.family_programs().items():
        fam_inputs = [
            (f64(rng.uniform(-1.0, 1.0, nc)), None if k == 1 else f64(rng.standard_normal((B, nc))))
            for k in range(fam_program.n_inputs)
        ]
        fam_launch = ops.DualEwLauncher(fam_program)
        fam_got = fam_launch(fam_inputs, B)
        fam_want = reference.dual_ew(fam_program.instrs, fam_program.imm, fam_inputs, B)
        fam_err = max(_rel_err(a, b) for a, b in zip(fam_got, fam_want) if a is not None)
        _require(fam_err <= tol, f"dual_ew, the {family} program: {fam_err}")
        _same_bits(f"dual_ew {family}", lambda: torch.cat([t.reshape(-1) for t in fam_launch(fam_inputs, B)]))
        err = max(err, fam_err)
    print(f"  dual_ew: every opcode (seven programs) on {nc} elements, {B} tangents, within {tol:g}, the same bits twice")
    tape = program.tape(tuple(t is None for _v, t in inputs))
    device_us = _graph_us(lambda: launch(inputs, B))
    launcher_host_us = _host_us(lambda: launch(inputs, B))
    print(f"  dual_ew at phase 22's program: {device_us:.2f} us device a launch (graph replay), "
          f"{launcher_host_us:.2f} us of host time a launcher call; tape of {len(tape.tape)} entries, "
          f"{tape.n_slot} slots, {tape.n_part} partials")
    n_dual = sum(t is not None for _v, t in inputs)
    report["dual_ew"] = {
        "err": err, "ms": _cuda_ms(lambda: launch(inputs, B)),
        "plain_ms": _cuda_ms(lambda: reference.dual_ew(program.instrs, program.imm, inputs, B)),
        "bytes": 8 * nc * ((1 + B) * n_dual + 1) + 8 * (1 + B) * nc,
        "flops": (1 + B) * 3 * len(program.instrs) * nc, "library_ms": None,
        "device_us": device_us, "host_us": launcher_host_us,
    }

    # The unknowns of the cells under one-hot seeds, and a concatenation.
    x = f64(rng.standard_normal(ndof))
    colors = torch.tensor(rng.integers(0, B, ndof).astype(np.int32), device=dev)
    idx = torch.tensor(np.sort(rng.permutation(ndof)[:nc]), device=dev)
    lens = (nc // 2, 1, 0, nc - nc // 2 - 1, nm, 64, 300)
    pieces = [
        (f64(rng.standard_normal(n)), None if i % 3 == 2 else f64(rng.standard_normal((B, n))))
        for i, n in enumerate(lens)
    ]

    # The launchers of one step each, as the dual pass holds them: the
    # unknowns' tangent rows written at the first call, the value row after.
    gather_var, gather_copy = ops.DualGatherVar(idx), ops.DualGatherCopy()

    def launchers():
        return gather_var(x, colors, B) + gather_copy(pieces, B)

    def wrappers():
        # The functional forms: checks, buffers and tables made per call.
        return ops.dual_gather_var(x, idx, colors, B) + ops.dual_gather_copy(pieces, B)

    def plain():
        return reference.dual_gather_var(x, idx, colors, B) + reference.dual_gather_copy(pieces, B)

    want = plain()
    for route in (launchers, launchers, wrappers):
        _require(all(torch.equal(a, b) for a, b in zip(route(), want)), "dual_gather disagrees with its plain version")
    _require(gather_var.seed_writes == 1, "the unknowns' tangent rows were written more than once")
    _require(ops.dual_gather_var(x, idx, None, 0)[1] is None, "dual_gather_var without seeds")
    _same_bits("dual_gather", lambda: torch.cat([t.reshape(-1) for t in launchers()]))
    print(f"  dual_gather: {nc} unknowns of {ndof} under {B} colors, and {len(lens)} duals concatenated: equal to the plain version")
    cat_rows = [torch.cat([v[None], t]) for v, t in pieces if t is not None]

    def gathers_library():
        return x.index_select(0, idx), colors.index_select(0, idx), torch.cat(cat_rows, dim=1)

    # In turns: launchers, functional wrappers, yardstick, and back.
    turns = {"launchers": [], "wrappers": [], "library": []}
    for name in ("launchers", "wrappers", "library", "library", "wrappers", "launchers"):
        fn = {"launchers": launchers, "wrappers": wrappers, "library": gathers_library}[name]
        turns[name].append(_cuda_ms(fn))
    host_us = [_host_us(fn) for fn in (lambda: gather_var(x, colors, B), lambda: gather_copy(pieces, B))]
    n_cat = sum(lens)
    print(f"  dual_gather in turns (ms over back-to-back calls): launchers {turns['launchers']}, functional "
          f"wrappers {turns['wrappers']}, index_select x2 + cat {turns['library']}; host us a call: "
          f"DualGatherVar {host_us[0]:.2f}, DualGatherCopy {host_us[1]:.2f}")
    report["dual_gather"] = {
        "err": 0.0, "ms": min(turns["launchers"]), "plain_ms": _cuda_ms(plain),
        # The value row: idx, x[idx] read and the row written; the copy:
        # every row of every piece read and written once.
        "bytes": (8 + 8 + 8) * nc + 2 * 8 * (1 + B) * n_cat,
        "flops": nc + (1 + B) * n_cat, "library_ms": min(turns["library"]),
        "turns": turns, "host_us": host_us,
    }

    for name in ("dual_ew", "dual_gather"):
        r = report[name]
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library {r['library_ms']}")
    return report


# -- the thm and berre3d bench cases ----------------------------------------------

# Steps of the full-width runs of phases 25 and 26 (the cases' own: 10).
THM_STEPS, BERRE3D_STEPS = 10, 10


THM_FIELDS = (
    "u", "pressure", "temperature", "contact_traction", "u_interface",
    "interface_darcy_flux", "interface_fourier_flux", "interface_enthalpy_flux",
)
# The reference's ms per Newton iteration on its CPU (tools/ref_baselines.json:
# thm_contact_3d_16, berre3d_case2_flow_16).
REF_MS = {"thm": 54683.0, "berre3d": 98254.0}


def _discretization_matrices(model) -> dict:
    """Every matrix of the model's registered discretizations, by (keyword,
    grid number, name), copied."""
    import scipy.sparse as sps

    from porepy_tpu_torch.utils.common_constants import DISCRETIZATION_MATRICES

    grids = {id(sd): i for i, sd in enumerate(model.mdg.subdomains())}
    out = {}

    def walk(prefix, d):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(prefix + (k,), v)
            elif sps.issparse(v):
                out[prefix + (k,)] = v.tocsr(copy=True)

    for discr, sd, data in model._discretizations:
        walk((discr.keyword, grids[id(sd)]), data[DISCRETIZATION_MATRICES].get(discr.keyword, {}))
    return out


def _region_bucket(source: str, key, arrays, dev, timed: bool) -> dict:
    """One K10 bucket's first chunk: the kernel against its plain versions
    (``region_solve_ordered``'s bits, ``linalg.solve``'s within 1e-12),
    with times when ``timed``."""
    from porepy_tpu_torch.kernels import ops, reference

    n, m, q = key
    a, rhs, w = (torch.from_numpy(x).to(dev) for x in arrays)
    got = ops.region_solve(a, rhs, w)
    want = reference.region_solve_contract(a, rhs, w)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    tag = f"region_solve {source}: B {a.shape[0]}, n {n}, m {m}, q {q}, {ops.region_solve_route(n, m)} route"
    _check(tag, torch.tensor(err), 1e-12 * scale)
    _require(reference.same_bits(got, reference.region_solve_ordered(a, rhs, w)),
             f"{tag}: the kernel differs from region_solve_ordered")
    out = {"B": a.shape[0], "n": n, "m": m, "q": q, "err": err}
    if timed:
        out.update(
            ms=_cuda_ms(lambda: ops.region_solve(a, rhs, w), 20),
            device_us=_graph_us(lambda: ops.region_solve(a, rhs, w), launches=10, replays=3),
            plain_ms=_cuda_ms(lambda: reference.region_solve_contract(a, rhs, w), 20),
        )
        print(f"    the ordered plain version's bits; {out['ms']:.4f} ms kernel, device {out['device_us']:.2f} us "
              f"(graph replay), {out['plain_ms']:.4f} ms plain")
    return out


def _thm_model(dev, cell_size: float, steps: int):
    """The thm case at ``cell_size`` for ``steps`` steps on ``dev``, its
    host Newton loop logged: seconds of each rediscretization, assembly and
    solve (synchronized), each step's Newton and Krylov counts, and at the
    last step one more Newton iteration by the plain route: rediscretized at
    the converged state by host LAPACK, assembled by :func:`_plain_assembly`
    on ``dev``, solved directly (a dense f64 LU on a card, scipy on the
    host)."""
    import scipy.sparse as sps
    import scipy.sparse.linalg as sps_linalg

    import porepy_tpu_torch as pt
    from porepy_tpu_torch.applications.benchmarking.cases import build_thm_contact_3d

    Model, params = build_thm_contact_3d(cell_size, device=str(dev))
    params["time_manager"] = pt.TimeManager([0, float(steps)], 1.0, constant_dt=True)
    log = {key: [] for key in ("rediscretize", "assemble", "solve", "update", "check", "loop", "ref_residual",
                               "steps", "krylov", "step_s")}
    log["tic"] = None
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def timed(key, fn):
        sync()
        tic = time.perf_counter()
        out = fn()
        sync()
        log[key].append(time.perf_counter() - tic)
        return out

    class Logged(Model):
        def before_nonlinear_loop(self):
            log["tic"] = time.perf_counter()
            timed("loop", super().before_nonlinear_loop)
            es = self.equation_system
            if "assemble" not in vars(es):
                # The Newton loop's reference residual, once a step.
                assemble = es.assemble

                def residual_timed(*args, **kwargs):
                    if kwargs.get("evaluate_jacobian", True):
                        return assemble(*args, **kwargs)
                    return timed("ref_residual", lambda: assemble(*args, **kwargs))

                es.assemble = residual_timed

        def rediscretize(self):
            timed("rediscretize", super().rediscretize)

        def assemble_linear_system(self):
            timed("assemble", super().assemble_linear_system)

        def solve_linear_system(self):
            x = timed("solve", super().solve_linear_system)
            log["krylov"].append(next(iter(self._device_solvers.values())).last_stats["krylov_iters"])
            return x

        def after_nonlinear_iteration(self, increment):
            timed("update", lambda: super(Logged, self).after_nonlinear_iteration(increment))

        def check_convergence(self, *args):
            return timed("check", lambda: super(Logged, self).check_convergence(*args))

        def after_nonlinear_convergence(self):
            k = self.nonlinear_solver_statistics.num_iteration
            done = sum(n for n, _ in log["steps"])
            log["steps"].append((k, log["krylov"][done:done + k]))
            if len(log["steps"]) == steps:
                # One more Newton iteration by the plain route, sharing no
                # kernel with the run.
                tic = time.perf_counter()
                with _local_solves("host"):
                    Model.rediscretize(self)
                es = self.equation_system
                cs = es.compiled_system()
                with _plain_assembly():
                    data, rhs = (t.cpu().numpy() for t in cs.assemble(es))
                log["residual"] = float(np.linalg.norm(rhs) / np.sqrt(rhs.size))
                if dev.type == "cuda":
                    log["increment"] = _dense_increment(cs.indices_np, data, rhs, dev)
                else:
                    A = sps.csr_matrix((data, (cs.indices_np[:, 0], cs.indices_np[:, 1])), shape=cs.shape)
                    dx = sps_linalg.spsolve(A.tocsc(), rhs)
                    log["increment"] = float(np.linalg.norm(dx) / np.sqrt(dx.size))
                log["check_s"] = time.perf_counter() - tic
            super().after_nonlinear_convergence()
            log["step_s"].append(time.perf_counter() - log["tic"] - log.get("check_s", 0.0))

    model = Logged(params)
    model.log = log
    return model, params


@contextlib.contextmanager
def _timed_builds():
    """The seconds of every preconditioner build or refresh inside the
    block (``DeviceLinearSolver.refresh_preconditioner``, synchronized), in
    the list it yields."""
    from porepy_tpu_torch.numerics.linalg.device_solver import DeviceLinearSolver

    secs = []
    refresh = DeviceLinearSolver.refresh_preconditioner

    def timed(self, data):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        refresh(self, data)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - tic)

    DeviceLinearSolver.refresh_preconditioner = timed
    try:
        yield secs
    finally:
        DeviceLinearSolver.refresh_preconditioner = refresh


def run_thm(dev, steps: int) -> dict:
    """Phase 25a: the thm case at 1/16 (25,120 dofs) for ``steps`` steps of
    1.0 on ``dev``, discretized (and rediscretized every Newton iteration)
    by K10, the host Newton loop, dense frozen block inverses."""
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.kernels import LAUNCHES, reset_launches
    from porepy_tpu_torch.numerics.linalg.krylov import FALLBACK_COUNTER

    cut = "" if steps == 10 else f" (cut from the case's 10: the first {steps})"
    print(f"phase 25: thm (3d thermoporomechanics, frictional contact) at cell size 1/16, {steps} steps of 1.0"
          f"{cut} on {dev}, dense_precond=True, discretized by K10, the host Newton loop")
    model, params = _thm_model(dev, 1.0 / 16, steps)
    log = model.log
    fallbacks0 = FALLBACK_COUNTER["count"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tic = time.perf_counter()
    with _local_solves("k10"):
        model.prepare_simulation()
        model._prepared = True
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - tic
        setup_launches = dict(LAUNCHES)
        reset_launches()
        tic = time.perf_counter()
        with _timed_builds() as builds:
            pt.run_time_dependent_model(model, params)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - tic - log["check_s"]
    launches = {k: v for k, v in LAUNCHES.items() if v}
    eq_sys = model.equation_system
    solver = next(iter(model._device_solvers.values()))
    newton = sum(n for n, _ in log["steps"])
    krylov = sum(log["krylov"])
    builder = solver._builder
    sweep = [i for i, m in enumerate(builder.methods) if m != "eliminate"]
    sizes = builder._sizes
    print(f"  dofs {eq_sys.num_dofs()}, setup {setup_s:.3f} s (K10 launches {setup_launches.get('region_solve', 0)}), "
          f"{steps} steps {run_s:.3f} s, {newton} Newton / {krylov} Krylov iterations; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; largest K of a K1 matrix {largest_ell_k(model)}")
    decl = model.linear_solver_blocks()["blocks"]
    print(f"  field split (unknowns, rows, method): "
          f"{[(v, size, m) for (_eqs, v), size, m in zip(decl, sizes, builder.methods)]}")
    print(f"  dense inverses, the pivots' fate (rows, built or demoted, inverted in the block's sparse LU's row "
          f"order after a singular 128-row pivot block): "
          f"{ {i: (sizes[i], builder._block_dense.get(i), builder._block_reordered.get(i)) for i in sweep} }")
    for i, ((k, kry), secs) in enumerate(zip(log["steps"], log["step_s"])):
        print(f"  step {i + 1}: {secs:.3f} s, {k} Newton, Krylov {kry}")
    per = {key: 1e3 * sum(log[key]) / max(newton, 1) for key in ("rediscretize", "assemble", "solve", "update",
                                                                 "check", "loop", "ref_residual")}
    per["builds"] = 1e3 * sum(builds) / max(newton, 1)
    ms = 1e3 * run_s / max(newton, 1)
    print(f"  ms per Newton iteration {ms:.2f} (the run's wall time over its Newton iterations): rediscretization "
          f"{per['rediscretize']:.2f}, assembly {per['assemble']:.2f}, solve {per['solve']:.2f} (of it the "
          f"preconditioner's {len(builds)} builds {per['builds']:.2f}: {[round(t, 3) for t in builds]} s), the "
          f"iterate's update {per['update']:.2f}, the convergence check {per['check']:.2f}, the steps' set-up "
          f"{per['loop']:.2f} and reference residual {per['ref_residual']:.2f}, the rest "
          f"{ms - sum(v for k, v in per.items() if k != 'builds'):.2f}; the "
          f"reference's CPU {REF_MS['thm']:.0f}")
    print(f"  kernel launches in the run: {launches}")
    _require(eq_sys.num_dofs() == 25120, f"thm dofs {eq_sys.num_dofs()}")
    _require(FALLBACK_COUNTER["count"] == fallbacks0, f"host fallbacks {FALLBACK_COUNTER}")
    _require(len(log["steps"]) == steps, f"{len(log['steps'])} steps")
    _require(solver._dense and all(builder._block_dense.get(i) for i in sweep),
             f"a dense block demoted or not built: {builder._block_dense}")
    needed = ("ell_spmv", "fgmres_arnoldi", "upwind_flux", "upwind_select", "region_solve") + DENSE_KERNELS + K8_KERNELS
    _require(all(launches.get(k, 0) > 0 for k in needed), f"kernel not launched: {launches}")
    for var in THM_FIELDS:
        v = eq_sys.get_variable_values([var], time_step_index=0)
        _require(bool(np.all(np.isfinite(v))), f"thm {var} not finite")
    tol = 1e-10
    print(f"  last step by the plain route (rediscretized by host LAPACK, assembled by torch.func with the "
          f"kernels' plain versions, a dense f64 LU solve on the card, {log['check_s']:.2f} s): "
          f"|F|/sqrt(n) {log['residual']:.3e}, next Newton increment |dx|/sqrt(n) {log['increment']:.3e}, "
          f"tolerance {tol:.0e}")
    _require(log["increment"] <= tol, f"Newton increment {log['increment']} > {tol}")
    cs = eq_sys.compiled_system()
    with _launches_of_block() as per_assembly:
        cs.assemble(eq_sys)
    print(f"  launches of one assembly {per_assembly} (sum {sum(per_assembly.values())})")
    return {
        "model": model, "launches": launches, "per_assembly": per_assembly, "setup_s": setup_s, "run_s": run_s,
        "ms_per_newton": ms, "split": per, "newton": newton, "krylov": krylov, "steps": log["steps"],
        "builds": builds,
    }


def compare_thm_small(dev) -> None:
    """Phase 25b: thm in 3d at 1/4 (664 dofs), two steps, on the card (K10)
    and on the host plain path: all eight fields within 1e-8 of each
    field's largest value."""
    import porepy_tpu_torch as pt

    print("phase 25b: thm at cell size 1/4, 2 steps, on the card against the host plain path")
    runs = {}
    for device in (str(dev), "cpu"):
        model, params = _thm_model(torch.device(device), 1.0 / 4, 2)
        with _local_solves("host" if device == "cpu" else "k10"):
            pt.run_time_dependent_model(model, params)
        runs[device] = model
    for var in THM_FIELDS:
        got, want = (runs[d].equation_system.get_variable_values([var], time_step_index=0) for d in (str(dev), "cpu"))
        err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
        print(f"  {var}: max |card - host| {err:.3e}, max |{var}| {scale:.3e}")
        _require(bool(np.all(np.isfinite(got))), f"thm 1/4 {var} not finite")
        _require(err <= 1e-8 * scale, f"thm 1/4 {var}: card and host differ by {err}")
    print(f"  Newton / Krylov a step, card {runs[str(dev)].log['steps']}, host {runs['cpu'].log['steps']}")


def check_thm_k10(dev, model) -> dict:
    """Phase 25c: thm 1/16's discretization by K10 and by host LAPACK in
    turns (host, K10, K10, host; the first host turn records each bucket's
    first chunk): every matrix within 1e-12 of the host's largest entry;
    each bucket's chunk through the kernel, ``region_solve_ordered``'s bits;
    then one Newton iteration's fracture rediscretization by each route, in
    turns."""
    from porepy_tpu_torch.applications.benchmarking.cases import capture_chunks

    print("phase 25c: thm 1/16's discretization by K10 and by host LAPACK, in turns")
    secs = {"host": [], "k10": []}
    mats = {}
    chunks = {}
    for route in ("host", "k10", "k10", "host"):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        if route == "host" and not chunks:
            chunks = capture_chunks(model.discretize)
        else:
            with _local_solves(route):
                model.discretize()
        torch.cuda.synchronize()
        secs[route].append(time.perf_counter() - tic)
        mats.setdefault(route, _discretization_matrices(model))
    worst = 0.0
    for key, want in mats["host"].items():
        got = mats["k10"][key]
        diff = abs(got - want)
        err = (diff.max() if diff.nnz else 0.0) / max(abs(want).max() if want.nnz else 0.0, 1e-300)
        worst = max(worst, err)
        _require(err <= 1e-12, f"thm matrix {key}: K10 and host differ by {err} of the largest entry")
    print(f"  {len(mats['host'])} matrices, the largest difference K10 - host over the host's largest entry "
          f"{worst:.3e}; seconds in turns: host {secs['host']}, K10 {secs['k10']}")
    print(f"  {len(chunks)} buckets (n, m, q): B of the first chunk "
          f"{ {k: v[0].shape[0] for k, v in sorted(chunks.items())} }")
    out = {"disc_s": secs, "buckets": {}, "worst": worst}
    for key, arrays in sorted(chunks.items()):
        out["buckets"][key] = _region_bucket("thm 1/16", key, arrays, dev, timed=key == (81, 64, 112))
    _require((81, 64, 112) in out["buckets"], f"thm 1/16 has no (81, 64, 112) bucket: {sorted(chunks)}")
    redisc = {"host": [], "k10": []}
    for route in ("k10", "host", "host", "k10"):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        with _local_solves(route):
            model.rediscretize()
        torch.cuda.synchronize()
        redisc[route].append(time.perf_counter() - tic)
    print(f"  one Newton iteration's fracture rediscretization (and the compiled constants' refresh), s in "
          f"turns: K10 {redisc['k10']}, host {redisc['host']}")
    out["redisc_s"] = redisc
    return out


def check_thm_k15(model) -> dict:
    """Phase 25d: every K15 call of one thm 1/16 assembly at its final
    state, one launch each, against its plain version and a second launch
    to the bit; times at each kind's first call."""
    from porepy_tpu_torch.applications.benchmarking import upwind_calls
    from porepy_tpu_torch.kernels import reference

    print("phase 25d: K15 at every call of one thm 1/16 assembly")
    calls = upwind_calls.assembly_calls(model, "thm 1/16")
    out = {}
    for call in calls:
        name = call["launcher"].name
        with _launches_of_block() as counted:
            upwind_calls.launch(call)()
        _require(counted == {name: 1}, f"{call['label']}: launches {counted} for one call")
        upwind_calls.check_launch(call)
        if call["kind"] in out:
            print(f"  {call['label']}: one launch, equal to the plain version and a second launch to the bit")
            continue
        fn = upwind_calls.launch(call)
        plain = upwind_calls.launch(call, lambda L, p, sd=None: reference.upwind_dual(L.kind, L.geometry, p, sd))
        r = {"label": call["label"], "device_us": _graph_us(fn), "host_us": _host_us(fn), "ms": _cuda_ms(fn),
             "plain_ms": _cuda_ms(plain, repeats=20), "bound_us": upwind_calls.bound_us(call)}
        out[call["kind"]] = r
        print(f"  {call['label']}: one launch, equal to the plain version and a second launch to the bit; device "
              f"{r['device_us']:.2f} us (graph replay), host {r['host_us']:.2f} us a call, {r['ms']:.4f} ms by "
              f"events, plain {r['plain_ms']:.4f} ms, bound {r['bound_us']:.3f} us")
    _require(len(calls) > 0 and {"flux", "interface"} <= set(out), f"thm 1/16's K15 calls: {sorted(out)}")
    return {"calls": len(calls), "kinds": out}


def run_berre3d(dev, steps: int) -> dict:
    """Phase 26a: Berre et al. 3d case 2 at refinement level 0 (the 16^3
    tet lattice, 31,578 dofs) for ``steps`` steps of 1.0 on ``dev``: 2
    per-step solves, then fused 4-step blocks."""
    from porepy_tpu_torch.applications.benchmarking.cases import build_berre3d

    cut = "" if steps == 10 else f" (cut from the case's 10: the first {steps})"
    print(f"phase 26: berre3d (Berre et al. 3d case 2, native tet mesh) at refinement 0, {steps} steps of 1.0"
          f"{cut} on {dev}, fused 4-step blocks")
    tic = time.perf_counter()
    Model, params = build_berre3d(device=str(dev))
    grid_s = time.perf_counter() - tic
    import porepy_tpu_torch as pt

    params["time_manager"] = pt.TimeManager([0, float(steps)], 1.0, constant_dt=True)
    blocks = -(-(steps - 2) // 4)
    with _timed_builds() as builds:
        model, out = _run_fused_case(dev, Model, params, blocks=blocks, compile_first=True)
    print(f"  the preconditioner's builds: {[round(t, 3) for t in builds]} s")
    eq_sys = model.equation_system
    launches = {k: v for k, v in out["launches"].items() if v}
    print(f"  setup: grid {grid_s:.3f} s, prepare_simulation {out['setup_s']:.3f} s (discretization "
          f"{out['disc_s']:.3f} s), the equations' compile and first assembly {out['compile_s']:.3f} s; "
          f"{len(model.mdg.subdomains())} subdomains, {len(model.mdg.interfaces())} interfaces")
    print(f"  kernel launches in the run: {launches}; largest K of a K1 matrix {largest_ell_k(model)}")
    print(f"  Newton / Krylov per block {[(rec['newton_iters'], rec['krylov_iters']) for _s, rec in model.block_log]}; "
          f"{out['ms_per_newton']:.2f} ms per Newton iteration in the blocks; the reference's CPU "
          f"{REF_MS['berre3d']:.0f}")
    _require(eq_sys.num_dofs() == 31578, f"berre3d dofs {eq_sys.num_dofs()}")
    needed = ("ell_spmv", "fgmres_arnoldi", "amg_vcycle") + K8_KERNELS
    _require(all(launches.get(k, 0) > 0 for k in needed), f"kernel not launched: {launches}")
    p = eq_sys.get_variable_values(["pressure"], time_step_index=0)
    _require(bool(np.all(np.isfinite(eq_sys.get_variable_values(time_step_index=0)))), "berre3d: non-finite state")
    print(f"  pressure in [{p.min():.6e}, {p.max():.6e}]")
    tic = time.perf_counter()
    res, inc = last_step_check(model, device=str(dev))
    tol = 1e-10
    print(f"  last step by the plain route (torch.func with the kernels' plain versions, a dense f64 LU solve on the "
          f"card, {time.perf_counter() - tic:.2f} s): "
          f"|F|/sqrt(n) {res:.3e}, next Newton increment |dx|/sqrt(n) {inc:.3e}, tolerance {tol:.0e}")
    _require(inc <= tol, f"Newton increment {inc} > {tol}")
    cs = eq_sys.compiled_system()
    with _launches_of_block() as per_assembly:
        cs.assemble(eq_sys)
    print(f"  launches of one assembly {per_assembly} (sum {sum(per_assembly.values())}); "
          f"{len(cs.ces)} equations; an assembly {_timed_assemblies(cs, eq_sys, 5):.2f} ms (median of 5)")
    out.update(grid_s=grid_s, per_assembly=per_assembly, blocks=[rec for _s, rec in model.block_log], builds=builds,
               routes=_assembly_routes_in_turns(model, "berre3d"))
    return out


def compare_berre3d_small(dev) -> None:
    """Phase 26b: berre3d on the 8^3 lattice on the card and on the host
    plain path (:func:`berre3d_small_case`): pressure and mortar fluxes
    within 1e-8 of each field's largest value."""
    print("phase 26b: berre3d on the 8^3 lattice, 4 steps, on the card against the host plain path")
    model, _ = berre3d_small_case(dev)
    host = host_fields(functools.partial(berre3d_small_case))
    _fields_close(model, host, ("pressure", "interface_darcy_flux"), 1e-8)


#: Phase 27's gate on one more Newton increment of fb2d4 at 5 m by the
#: plain route, ``|dx| / sqrt(n)`` in the model's units (Pa, the pressures
#: carry the norm). The system is ill conditioned (a 1-norm condition
#: estimate of ~1.3e26 at 20 m: permeabilities 1e-14 and 1e-8, aperture
#: 1e-2): at 20 m two direct solves of bit-equal systems differ by up to
#: 3.2 Pa (8.1e-7 of the largest pressure, 4e6 Pa), the port's host and
#: device_gmres routes by 0.53 Pa at most and 0.028 Pa in the root mean
#: square. The increment is such a distance, from the card's solution to
#: the dense LU's, in the root mean square: 1 Pa is twice the routes' 20 m
#: spread at its largest and 35 times it in the mean, 2.5e-7 of the largest
#: pressure.
FB2D4_INCREMENT_TOL = 1.0
#: Phase 27b's tolerance, relative to each field's largest value, between
#: the card and the host plain path at 20 m. Both run the same route
#: (``device_gmres``, the kernels on the card and their plain versions on
#: the host), so they differ by rounding that the conditioning amplifies
#: through the Krylov solve's stopping point: at most by as much as two
#: routes that stop at different points, which is what the port's own two
#: CPU routes at 20 m (the host's direct solve and ``device_gmres``) show:
#: 1.3e-7 (pressure) and 2.2e-7 (mortar fluxes). 1e-6 is 4.5 times the
#: larger, and 77 times the 1.3e-8 that the mortar fluxes read on an H100
#: against the host (the pressure 1.4e-9).
FB2D4_FIELD_TOL = 1e-6
#: Case 4 at 5 m: the dofs, subdomains (the matrix, 63 fractures, 85
#: intersection points) and interfaces of the native simplex mesh.
FB2D4_SIZE = (43790, 149, 233)


def _logged_case(Model, params, dev):
    """``Model`` on ``dev`` with its setup and Newton loop timed
    (synchronized): the mesh (``set_geometry``), the discretization, each
    assembly and solve, and each solve's Krylov count, in ``model.log``."""
    log = {key: [] for key in ("mesh", "discretize", "assemble", "solve", "krylov")}
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def timed(key, fn):
        sync()
        tic = time.perf_counter()
        out = fn()
        sync()
        log[key].append(time.perf_counter() - tic)
        return out

    class Logged(Model):
        def set_geometry(self):
            timed("mesh", super().set_geometry)

        def discretize(self):
            timed("discretize", super().discretize)

        def assemble_linear_system(self):
            timed("assemble", super().assemble_linear_system)

        def solve_linear_system(self):
            x = timed("solve", super().solve_linear_system)
            if self._device_solvers:
                log["krylov"].append(next(iter(self._device_solvers.values())).last_stats["krylov_iters"])
            return x

    model = Logged(params)
    model.log = log
    return model, params


def _fb2d4_model(dev, cell_size: float):
    """Case 4 at ``cell_size`` on ``dev`` (``cases.build_flow_benchmark_2d_case_4``),
    logged by :func:`_logged_case`."""
    from porepy_tpu_torch.applications.benchmarking.cases import build_flow_benchmark_2d_case_4

    return _logged_case(*build_flow_benchmark_2d_case_4(cell_size, device=str(dev)), dev)


def _host_loop_run(model, params, tag: str) -> dict:
    """A logged case (:func:`_logged_case`) on the card through the host
    Newton loop: ``prepare_simulation`` (the mesh and the discretization
    inside it), the equations' compile with the first assembly, and the
    run, each timed (synchronized), with the preconditioner's builds, the
    run's launches and its host fallbacks; printed and returned."""
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.kernels import LAUNCHES, reset_launches
    from porepy_tpu_torch.numerics.linalg.krylov import FALLBACK_COUNTER

    log = model.log
    fallbacks0 = FALLBACK_COUNTER["count"]
    with _timed_builds() as builds:
        torch.cuda.synchronize()
        reset_launches()
        tic = time.perf_counter()
        model.prepare_simulation()
        model._prepared = True
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - tic
        eq_sys = model.equation_system
        tic = time.perf_counter()
        eq_sys.compiled_system().assemble(eq_sys)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - tic
        reset_launches()
        tic = time.perf_counter()
        pt.run_time_dependent_model(model, params)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - tic
        launches = {k: v for k, v in LAUNCHES.items() if v}
    mdg = model.mdg
    dofs, n_sd, n_intf = eq_sys.num_dofs(), len(mdg.subdomains()), len(mdg.interfaces())
    newton = len(log["solve"])
    solver = next(iter(model._device_solvers.values()))
    mesh_s, disc_s = sum(log["mesh"]), sum(log["discretize"])
    build_s = sum(builds)
    solve_s = sum(log["solve"])
    print(f"  setup: prepare_simulation {setup_s:.3f} s (the mesh {mesh_s:.3f} s and the discretization "
          f"{disc_s:.3f} s inside it), the equations' compile and first assembly {compile_s:.3f} s; the "
          f"preconditioner's builds {[round(t, 3) for t in builds]} s; {dofs} dofs, {n_sd} subdomains, {n_intf} "
          f"interfaces; field split methods {solver._builder.methods}, block sizes {solver._builder._sizes}")
    ms_per_newton = 1e3 * run_s / max(newton, 1)
    print(f"  the run: {run_s:.3f} s, {newton} Newton iterations, Krylov per solve {log['krylov']}; "
          f"{ms_per_newton:.2f} ms per Newton iteration (assembly {1e3 * sum(log['assemble']):.2f} ms, solve "
          f"{1e3 * solve_s:.2f} ms of which the preconditioner's builds {1e3 * build_s:.2f} ms)")
    ell_k = largest_ell_k(model)
    fallbacks = FALLBACK_COUNTER["count"] - fallbacks0
    print(f"  kernel launches in the run: {launches}; largest K of a K1 matrix {ell_k}; host fallbacks {fallbacks}")
    _require(fallbacks == 0, f"{tag}: host fallbacks {FALLBACK_COUNTER}")
    _require(len(builds) > 0, f"{tag}: the preconditioner was never built")
    needed = ("ell_spmv", "fgmres_arnoldi", "amg_vcycle") + K8_KERNELS
    missing = [k for k in needed if not launches.get(k)]
    _require(not missing, f"{tag}: kernels not launched {missing}: {launches}")
    _require(bool(np.all(np.isfinite(eq_sys.get_variable_values(time_step_index=0)))), f"{tag}: non-finite state")
    out = {
        "dofs": dofs, "subdomains": n_sd, "interfaces": n_intf, "mesh_s": mesh_s, "setup_s": setup_s,
        "disc_s": disc_s, "compile_s": compile_s, "builds": builds, "run_s": run_s, "newton": newton,
        "krylov": list(log["krylov"]), "ms_per_newton": ms_per_newton, "launches": launches, "ell_k": ell_k,
        "split": {"assemble": 1e3 * sum(log["assemble"]) / max(newton, 1), "solve": 1e3 * solve_s / max(newton, 1),
                  "builds": 1e3 * build_s / max(newton, 1)},
        "methods": list(solver._builder.methods), "sizes": list(solver._builder._sizes),
    }
    return out


def _case_shapes(model, tag: str, label: str, out: dict) -> None:
    """After a host-loop case's gates: the launches of one assembly and its
    median ms of 5, the assembly routes in turns (phase 23), K5/K7
    re-timed, K1 against its plain version at the Jacobian (f64 with
    B = 17, f32 with B = 1) and at the widest AMG level, and K3 at every
    hierarchy (3c); into ``out``."""
    eq_sys = model.equation_system
    cs = eq_sys.compiled_system()
    with _launches_of_block() as per_assembly:
        cs.assemble(eq_sys)
    assembly_ms = _timed_assemblies(cs, eq_sys, 5)
    print(f"  launches of one assembly {per_assembly} (sum {sum(per_assembly.values())}); {len(cs.ces)} equations; "
          f"an assembly {assembly_ms:.2f} ms (median of 5)")
    out.update(per_assembly=per_assembly, assembly_ms=assembly_ms)
    out["routes"] = _assembly_routes_in_turns(model, tag)
    out["retime"] = retime_solver(model, tag)
    # K1 and K3 at the case's own shapes, each against its plain version:
    # the Jacobian as the solve gathers it, and every level of the pressure
    # block's hierarchy (rows up to the largest K).
    val, col, solver = _model_jacobian_ell(model)
    print(f"phase 3c: K1 at {label}'s Jacobian (the final state's, in the solver's ELL layout)")
    out["k1"] = {"f64 B17": check_k1_at(f"{label}'s Jacobian", val, col, 17, 71),
                 "f32 B1": check_k1_at(f"{label}'s Jacobian", val.to(torch.float32), col, 1, 70)}
    del val, col
    # The widest K1 rows of the path: the AMG level whose A has the largest
    # K, in the hierarchy's type, one vector, as the V-cycle multiplies by it.
    lv = max((lv for h in solver._hierarchies.values() for lv in h.state["levels"]),
             key=lambda lv: lv["A_col"].shape[1])
    tag = f"{label}'s widest AMG level"
    print(f"phase 3c: K1 at {tag} (n {lv['A_col'].shape[0]}, K {lv['A_col'].shape[1]})")
    out["k1"]["level B1"] = check_k1_at(tag, lv["A_val"], lv["A_col"], 1, 72)
    print(f"phase 3c: K3 at {label}'s hierarchy (the final state's)")
    out["k3"] = vcycle_times(solver, label)


def run_fb2d4(dev, cell_size: float = 5.0) -> dict:
    """Phase 27a: Flemisch et al. 2d case 4 at 5 m (43,790 dofs in 149
    subdomains) on ``dev``: the example's one step, the host Newton loop,
    each iteration assembled by the K8 pass and solved by the block
    preconditioned FGMRES (the pressure block above the dense limit takes
    AMG); then K1 and K3 at its final state's shapes (3c)."""
    print(f"phase 27: fb2d4 (Flemisch et al. 2d flow benchmark case 4, 63 fractures, native simplex mesh) at "
          f"{cell_size:g} m on {dev}, the example's time manager, the host Newton loop")
    model, params = _fb2d4_model(dev, cell_size)
    out = _host_loop_run(model, params, "fb2d4")
    size = (out["dofs"], out["subdomains"], out["interfaces"])
    _require(size == FB2D4_SIZE, f"fb2d4 size {size}, not {FB2D4_SIZE}")
    # The pressure block on AMG, the mortar block eliminated: a block the
    # build demoted (to Jacobi sweeps) would show here.
    _require(out["methods"] == ["amg", "eliminate"], f"fb2d4: field split {out['methods']}")
    launches = out["launches"]
    k15 = launches.get("upwind_flux", 0) + launches.get("upwind_select", 0)
    _require(k15 > 0, f"fb2d4: K15 not launched: {launches}")
    eq_sys = model.equation_system
    p = eq_sys.get_variable_values(["pressure"], time_step_index=0)
    print(f"  pressure in [{p.min():.6e}, {p.max():.6e}]")
    _require(p.min() > 1e6 - 1.0 and p.max() < 4e6 + 1.0, f"fb2d4: pressure outside [1e6, 4e6]: {p.min()}, {p.max()}")
    tic = time.perf_counter()
    res, inc = last_step_check(model, device=str(dev))
    print(f"  the step by the plain route (torch.func with the kernels' plain versions, a dense f64 LU solve on the "
          f"card, {time.perf_counter() - tic:.2f} s): |F|/sqrt(n) {res:.3e}, next Newton increment |dx|/sqrt(n) "
          f"{inc:.3e} Pa, tolerance {FB2D4_INCREMENT_TOL:g} Pa (above the 20 m spread of two solution routes)")
    _require(inc <= FB2D4_INCREMENT_TOL, f"fb2d4: Newton increment {inc} > {FB2D4_INCREMENT_TOL}")
    out["increment"] = inc
    _case_shapes(model, "fb2d4", f"fb2d4 {cell_size:g} m", out)
    return out


def compare_fb2d4_small(dev, cell_size: float = 20.0) -> None:
    """Phase 27b: case 4 at 20 m (4,594 dofs) on the card and on the host
    plain path, both by ``device_gmres`` (:func:`fb2d4_case`): pressure
    and mortar fluxes within ``FB2D4_FIELD_TOL`` of each field's largest
    value."""
    print(f"phase 27b: fb2d4 at {cell_size:g} m on the card against the host plain path")
    model, _ = fb2d4_case(cell_size, dev)
    host = host_fields(functools.partial(fb2d4_case, cell_size))
    _fields_close(model, host, ("pressure", "interface_darcy_flux"), FB2D4_FIELD_TOL)


#: Case 3 at refinement 0: the dofs, subdomains (the matrix, 8 fractures,
#: 7 intersection lines) and interfaces of the native cut-tet mesh.
FB3D3_SIZE = (47900, 16, 22)
#: Its field split: the pressure block (41,302 cells) on AMG above the
#: dense limit, the mortar block (6,598 cells) eliminated, as the route
#: splits the case at refinement 0 on the CPU (the 28b lattice takes the
#: same methods).
FB3D3_SPLIT = (["amg", "eliminate"], [41302, 6598])
#: Phase 28's gate on one more Newton increment by the plain route,
#: ``|dx| / sqrt(n)`` (the pressures, of order 1, carry the norm; the largest
#: is 0.70 at the 28b lattice). The increment is the distance from the
#: card's FGMRES solution to the dense LU's: on the CPU the device route's
#: increment is 4.4e-12 at the 28b lattice and 1.4e-13 at refinement 0,
#: against the direct solve's own 7.8e-14 and 2.7e-13 (the plain kernels,
#: ``device_gmres``, then the plain route with scipy); an H100 reads
#: 8.9e-13. 1e-10 is 23 times the largest, as berre3d's gate.
FB3D3_INCREMENT_TOL = 1e-10
#: Phase 28b's tolerance, relative to each field's largest value, between
#: the card and the host plain path at the lattice. Both run
#: ``device_gmres`` and differ by rounding through the Krylov solve's
#: stopping point, at most by as much as two routes that stop at different
#: points: the port's host direct solve and its ``device_gmres`` differ by
#: 7.5e-12 (pressure) and 2.5e-11 (mortar fluxes) there on the CPU
#: (``tests/test_torch_flow_benchmark_3d_case_3.py``). 1e-9 is 40 times the
#: larger, and 36 times the 2.8e-11 that the mortar fluxes read on an H100
#: against the host (the pressure 6.3e-12).
FB3D3_FIELD_TOL = 1e-9
#: The 28b lattice: 12,302 tets, 8 fractures, 4 intersection lines, 14,936
#: dofs.
FB3D3_LATTICE = (6, 14, 6)


def _fb3d3_model(dev, grid=None):
    """Case 3 on ``dev`` (``cases.build_flow_benchmark_3d_case_3``: refinement
    0, or ``grid``; the two-point flux), with the benchmark's effective
    permeabilities, logged by :func:`_logged_case`."""
    from porepy_tpu_torch.applications.benchmarking.cases import build_flow_benchmark_3d_case_3
    from porepy_tpu_torch.applications.test_utils.benchmarks import EffectivePermeability

    Model, params = build_flow_benchmark_3d_case_3(device=str(dev), grid=grid)

    class Case(EffectivePermeability, Model):
        pass

    return _logged_case(Case, params, dev)


def fb3d3_checks(model, tag: str) -> dict:
    """The checks of ``tests/functional/test_benchmark_3d_case_3.py`` on the
    model's solution: the inflow through the south band -1/3 and the
    pressure on the north Dirichlet bands 0, each within 1e-5, and the
    effective permeabilities of Table 5 (matrix 1, fractures 1e2,
    intersections 1; normal 2e6 on 2d interfaces, 2e4 on 1d) within the
    test's 1.5e-6."""
    from porepy_tpu_torch.utils.common_constants import ITERATE_SOLUTIONS

    es = model.equation_system
    bg, data_bg = model.mdg.boundaries(return_data=True, dim=2)[0]
    sides = model.domain_boundary_sides(bg)
    inflow = float(np.sum(data_bg[ITERATE_SOLUTIONS]["darcy_flux"][0][sides.south]))
    outlet = float(np.sum(data_bg[ITERATE_SOLUTIONS]["pressure"][0][sides.north]))
    tangential = max(float(np.abs(es.evaluate(model.effective_tangential_permeability([sd]))
                                  - (1e2 if sd.dim == 2 else 1.0)).max()) for sd in model.mdg.subdomains())
    normal = max(float(np.abs(es.evaluate(model.effective_normal_permeability([intf]))
                              - (2e6 if intf.dim == 2 else 2e4)).max()) for intf in model.mdg.interfaces())
    p = es.get_variable_values(["pressure"], time_step_index=0)
    print(f"  {tag}: inflow through the south band {inflow:.12f} (want -1/3), pressure on the north bands "
          f"{outlet:.3e} (want 0); Table 5's effective permeabilities, largest difference: tangential "
          f"{tangential:.3e}, normal {normal:.3e}; pressure in [{p.min():.6e}, {p.max():.6e}]")
    _require(abs(inflow + 1.0 / 3.0) <= 1e-5, f"{tag}: inflow {inflow}, not -1/3")
    _require(abs(outlet) <= 1e-5, f"{tag}: outlet pressure {outlet}, not 0")
    _require(tangential < 1.5e-6 and normal < 1.5e-6, f"{tag}: effective permeabilities {tangential}, {normal}")
    _require(p.max() - p.min() > 1e-3, f"{tag}: the pressure is not driven")
    return {"inflow": inflow, "outlet": outlet, "tangential": tangential, "normal": normal}


def run_fb3d3(dev) -> dict:
    """Phase 28a: Berre et al. 3d case 3 at refinement 0 (47,900 dofs in 16
    subdomains) on ``dev``: the example's one step, the host Newton loop,
    each iteration assembled by the K8 pass and solved by the block
    preconditioned FGMRES (the pressure block above the dense limit takes
    AMG, the mortar block eliminated); the benchmark's checks, the
    plain-route increment, then K1 and K3 at its final state's shapes
    (3c)."""
    print(f"phase 28: fb3d3 (Berre et al. 3d flow benchmark case 3, 8 fractures, native cut-tet mesh) at refinement "
          f"0 on {dev}, the example's time manager, the two-point flux, the host Newton loop")
    model, params = _fb3d3_model(dev)
    out = _host_loop_run(model, params, "fb3d3")
    size = (out["dofs"], out["subdomains"], out["interfaces"])
    _require(size == FB3D3_SIZE, f"fb3d3 size {size}, not {FB3D3_SIZE}")
    # No block demoted (to Jacobi sweeps): the split the route picks.
    _require((out["methods"], out["sizes"]) == FB3D3_SPLIT, f"fb3d3: field split {out['methods']}, {out['sizes']}")
    out["checks"] = fb3d3_checks(model, "fb3d3 refinement 0")
    tic = time.perf_counter()
    res, inc = last_step_check(model, device=str(dev))
    out["lu_s"] = time.perf_counter() - tic
    print(f"  the step by the plain route (torch.func with the kernels' plain versions, a dense f64 LU solve of "
          f"{out['dofs']}^2 x 8 B = {out['dofs'] ** 2 * 8 / 1e9:.1f} GB on the card, {out['lu_s']:.2f} s): |F|/sqrt(n) "
          f"{res:.3e}, next Newton increment |dx|/sqrt(n) {inc:.3e}, tolerance {FB3D3_INCREMENT_TOL:g}")
    _require(inc <= FB3D3_INCREMENT_TOL, f"fb3d3: Newton increment {inc} > {FB3D3_INCREMENT_TOL}")
    out["increment"] = inc
    torch.cuda.empty_cache()
    _case_shapes(model, "fb3d3", "fb3d3 refinement 0", out)
    return out


def compare_fb3d3_small(dev) -> None:
    """Phase 28b: case 3 on the lattice on the card and on the host plain
    path, both by ``device_gmres`` (:func:`fb3d3_small_case`): pressure and
    mortar fluxes within ``FB3D3_FIELD_TOL`` of each field's largest
    value."""
    print(f"phase 28b: fb3d3 on the {FB3D3_LATTICE} lattice on the card against the host plain path")
    model, _ = fb3d3_small_case(dev)
    host = host_fields(functools.partial(fb3d3_small_case))
    _fields_close(model, host, ("pressure", "interface_darcy_flux"), FB3D3_FIELD_TOL)


# -- the verification examples and the line search --------------------------------


#: The errors each verification example collects, with the bounds of
#: ``tests/examples/test_biot_examples.py`` (None: printed, not bounded).
VERIFICATION = {
    "terzaghi": {"error_pressure": 0.07, "error_consolidation_degree": 0.03},
    "mandel": {"error_pressure": 0.05, "error_displacement": 2e-3, "error_flux": None},
}


def verification_case(name: str, dev):
    """Terzaghi (20 cells, 6 steps of 0.05 s) or Mandel (the example's
    cells of 2 m on 100 m x 10 m, 5 steps of 10 s) with the material
    constants and time managers of ``tests/examples/test_biot_examples.py``,
    by ``device_gmres`` on ``dev``: the run model."""
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.examples import MandelModel, TerzaghiModel
    from porepy_tpu_torch.examples.mandel_biot import mandel_solid_params
    from porepy_tpu_torch.examples.terzaghi_biot import terzaghi_solid_params

    terzaghi = name == "terzaghi"
    params = {
        "material_constants": {
            "solid": pt.SolidConstants(**(terzaghi_solid_params if terzaghi else mandel_solid_params)),
            "fluid": pt.FluidComponent(viscosity=1e-3, density=1e3, compressibility=0.0),
        },
        "time_manager": (pt.TimeManager([0, 0.05, 0.1, 0.3], 0.05, constant_dt=True) if terzaghi
                         else pt.TimeManager([0, 10, 50], 10, constant_dt=True)),
        "suppress_export": True,
        "linear_solver": "device_gmres",
        "device": str(dev),
    }
    if terzaghi:
        params.update(num_cells=20, vertical_load=6e8)
    model = (TerzaghiModel if terzaghi else MandelModel)(params)
    pt.run_time_dependent_model(model, params)
    return model


def _contact_model(dev, line_search: bool, counts: dict):
    """``tests/numerics/test_solvers.py``'s sliding-contact
    ``MomentumBalance`` with ``ContactIndicators`` at cell size 1/32 on
    ``dev`` by ``device_gmres`` with dense block inverses (the contact
    block's), up to 20 Newton iterations (the line search takes 12 there on
    the CPU, above the default 10); with ``line_search``, through
    ``ConstraintLineSearch + SplineInterpolationLineSearch +
    LineSearchNewtonSolver``, each of its evaluations counted in
    ``counts``, with the launches made inside the searches."""
    import porepy_tpu_torch as pt

    class Model(pt.ContactIndicators, pt.MomentumBalance):
        def set_fractures(self):
            self._fractures = [np.array([[0.25, 0.75], [0.5, 0.5]])]

        def meshing_arguments(self):
            return {"cell_size": 1.0 / 32}

        def bc_values_displacement(self, bg):
            vals = np.zeros((self.nd, bg.num_cells))
            north = self.domain_boundary_sides(bg).north
            vals[0, north] = 0.05
            vals[1, north] = -0.002
            return vals.ravel("F")

        def initialize_data_saving(self):
            pass

        def save_data_time_step(self):
            pass

    class Solver(pt.ConstraintLineSearch, pt.SplineInterpolationLineSearch, pt.LineSearchNewtonSolver):
        def nonlinear_line_search(self, model, dx):
            es = model.equation_system
            evaluate, assemble = es.evaluate, es.assemble

            def counted_evaluate(*args, **kwargs):
                counts["evaluations"] += 1
                return evaluate(*args, **kwargs)

            def counted_assemble(*args, **kwargs):
                counts["residuals"] += 1
                return assemble(*args, **kwargs)

            es.evaluate, es.assemble = counted_evaluate, counted_assemble
            counts["searches"] += 1
            try:
                with _launches_of_block() as launched:
                    return super().nonlinear_line_search(model, dx)
            finally:
                del es.evaluate, es.assemble
                for k, v in launched.items():
                    counts["launches"][k] = counts["launches"].get(k, 0) + v

    params = {"suppress_export": True, "device": str(dev), "linear_solver": "device_gmres", "dense_precond": True,
              "max_iterations": 20}
    if line_search:
        params.update(global_line_search=True, local_line_search=True, adaptive_indicator_scaling=True,
                      nonlinear_solver=Solver, nl_convergence_tol_res=1e-10)
    model = Model(params)
    pt.run_time_dependent_model(model, params)
    return model


#: Phase 29's gate on the contact tractions of the card's plain Newton run
#: against the host plain path's (the same route, the kernels' plain
#: versions), largest absolute difference. Newton converges to rounding
#: here whatever the linear solve: on the CPU ``device_gmres`` (9 Newton
#: iterations) and a direct solve (7) give tractions 6.7e-16 apart, of a
#: largest 1.2e-2. 1e-12 is 1,500 times that, and a hundredth of the
#: 1e-10 that ``tests/numerics/test_solvers.py`` holds two solvers to.
CONTACT_HOST_TOL = 1e-12


def run_verification(dev) -> dict:
    """Phase 29: Terzaghi and Mandel on the card by ``device_gmres``, each
    error within ``tests/examples/test_biot_examples.py``'s bounds and
    falling in time, and within 1e-8 of the host plain path's (the same
    route, the kernels' plain versions); then the contact model of
    ``tests/numerics/test_solvers.py`` at 1/32 on the card by plain Newton
    and by the constraint line search, the tractions within the test's
    1e-10 of each other, and plain Newton's within ``CONTACT_HOST_TOL`` of
    the host plain path's."""
    tic0 = time.perf_counter()
    out = {}
    for name, bounds in VERIFICATION.items():
        print(f"phase 29: {name} on {dev} by device_gmres, against the analytical solution and the host plain path")
        tic = time.perf_counter()
        with _launches_of_block() as launches:
            model = verification_case(name, dev)
        secs = time.perf_counter() - tic
        host = verification_case(name, torch.device("cpu"))
        errors = {f: [float(getattr(r, f)) for r in model.results] for f in bounds}
        times = [r.time for r in model.results]
        print(f"  {model.equation_system.num_dofs()} dofs, {len(times) - 1} steps, {secs:.3f} s on the card; "
              f"kernel launches {launches}")
        for f, bound in bounds.items():
            mine = np.array(errors[f])
            diff = float(np.abs(mine - np.array([getattr(r, f) for r in host.results])).max())
            print(f"  {f} at t = {times}: {[float(f'{e:.6e}') for e in mine]}; bound {bound}; host plain path "
                  f"max |diff| {diff:.3e}")
            _require(diff <= 1e-8, f"{name}: {f} differs from the host plain path by {diff}")
            if bound is not None:
                _require(bool(np.all(mine[1:] < bound)), f"{name}: {f} {mine} above {bound}")
        ep = errors["error_pressure"]
        _require(ep[-1] < ep[1], f"{name}: the pressure error does not fall in time: {ep}")
        _require(launches.get("fgmres_arnoldi", 0) > 0 and any(launches.get(k) for k in K8_KERNELS),
                 f"{name}: the solve's or the assembly's kernels not launched: {launches}")
        out[name] = {"errors": errors, "launches": launches, "s": secs, "dofs": model.equation_system.num_dofs()}
    print(f"phase 29: the sliding-contact model at 1/32 on {dev} by device_gmres (dense block inverses), by plain "
          f"Newton and by the constraint line search")
    counts = {"searches": 0, "evaluations": 0, "residuals": 0, "launches": {}}
    tractions, newton = {}, {}
    for line_search in (False, True):
        tic = time.perf_counter()
        model = _contact_model(dev, line_search, counts)
        tractions[line_search] = model.equation_system.get_variable_values(["contact_traction"], iterate_index=0)
        newton[line_search] = model.nonlinear_solver_statistics.num_iteration
        print(f"  {'line search' if line_search else 'plain Newton'}: {model.equation_system.num_dofs()} dofs, "
              f"{newton[line_search]} Newton iterations, {time.perf_counter() - tic:.3f} s")
    tic = time.perf_counter()
    host = _contact_model(torch.device("cpu"), False, {})
    host_traction = host.equation_system.get_variable_values(["contact_traction"], iterate_index=0)
    host_diff = float(np.abs(tractions[False] - host_traction).max())
    print(f"  the host plain path, plain Newton: {host.nonlinear_solver_statistics.num_iteration} Newton iterations, "
          f"{time.perf_counter() - tic:.3f} s; the card's contact tractions max |diff| {host_diff:.3e}, tolerance "
          f"{CONTACT_HOST_TOL:g}")
    _require(host_diff <= CONTACT_HOST_TOL, f"the card's plain Newton traction differs from the host's by {host_diff}")
    diff = float(np.abs(tractions[True] - tractions[False]).max())
    print(f"  the line search: {counts['searches']} searches, {counts['evaluations']} indicator evaluations and "
          f"{counts['residuals']} residual assemblies on the card, kernel launches inside them {counts['launches']}; "
          f"contact tractions max |diff| {diff:.3e} (largest {float(np.abs(tractions[False]).max()):.3e}), "
          f"tolerance 1e-10")
    _require(diff <= 1e-10, f"the line-search traction differs from plain Newton's by {diff}")
    _require(counts["evaluations"] > 0, "the line search evaluated no indicator")
    out["line_search"] = {"newton": newton, "diff": diff, "host_diff": host_diff, **counts}
    out["seconds"] = time.perf_counter() - tic0
    print(f"phase 29 took {out['seconds']:.1f} s")
    return out


def _damage_gates(model, tag: str) -> dict:
    """Phase 30's checks of a damage run: no host fallback is the caller's;
    here the history, >= 0 and non-decreasing from step to step in every
    cell; the friction bound and the dilation gap equal to
    ``1 + (d0 - 1) exp(-c h)`` computed in numpy from the run's ``h``,
    times the intact bound and gap (1e-12 of the largest); every node of
    the last step's system with a dual rule; a finite state. Returns the
    largest differences."""
    from porepy_tpu_torch.models import constitutive_laws as laws

    es = model.equation_system
    hs = np.stack([rec["h"] for rec in model.steps])
    _require(bool(np.all(hs >= 0)), f"{tag}: a negative damage history {hs.min()}")
    _require(bool(np.all(np.diff(hs, axis=0) >= 0)), f"{tag}: the damage history decreased: {np.diff(hs, axis=0).min()}")
    h = hs[-1]
    fracture = model.mdg.subdomains(dim=model.nd - 1)
    solid = model.solid
    out = {}
    for factor, law, kind, d0, c in (
        ("friction_damage", "friction_bound", laws.FrictionDamage, solid.initial_friction_damage,
         solid.friction_damage_decay),
        ("dilation_damage", "shear_dilation_gap", laws.DilationDamage, solid.initial_dilation_damage,
         solid.dilation_damage_decay),
    ):
        damage = 1.0 + (d0 - 1.0) * np.exp(-c * h)
        got = np.asarray(es.evaluate(getattr(model, factor)(fracture)))
        out[factor] = float(np.abs(got - damage).max())
        # The damaged bound (gap): the factor times the intact one, the
        # next class's in the model's order.
        got = np.asarray(es.evaluate(getattr(model, law)(fracture)))
        want = damage * np.asarray(es.evaluate(getattr(super(kind, model), law)(fracture)))
        scale = float(np.abs(want).max())
        out[law] = float(np.abs(got - want).max())
        print(f"  {factor}: against 1 + (d0 - 1) exp(-c h) from numpy, max |diff| {out[factor]:.3e}; {law}: against "
              f"that factor x the intact value, max |diff| {out[law]:.3e} (largest {scale:.3e})")
        _require(out[factor] <= 1e-12, f"{tag}: {factor} differs by {out[factor]}")
        _require(out[law] <= 1e-12 * scale, f"{tag}: {law} differs by {out[law]} of {scale}")
    ruleless = _ruleless(model)
    print(f"  nodes without a dual rule at the last step: {ruleless}")
    _require(not any(ruleless.values()), f"{tag}: nodes without a dual rule: {ruleless}")
    _require(bool(np.all(np.isfinite(es.get_variable_values(time_step_index=0)))), f"{tag}: non-finite state")
    out["h_max"] = float(h.max())
    return out


def _print_steps(model, tag: str) -> None:
    for i, rec in enumerate(model.steps, 1):
        kry = rec["krylov"]
        print(f"  {tag} step {i}: the history equation's update {rec['update_s']:.3f} s, compile "
              f"{rec['compile_s']:.3f} s, the Newton loop {rec['newton_s']:.3f} s ({rec['newton']} Newton, Krylov "
              f"{kry}; {'fused device loop' if rec['fused'] else 'host loop'}), the step before's objects alive "
              f"{rec['alive_before']} of {rec['watched']}, max h {float(rec['h'].max()):.6e}")


def run_damage(dev) -> dict:
    """Phase 30: the fracture damage example at 1/128 (33,216 dofs) on the
    card by ``device_gmres`` with dense block inverses, 3 steps, every gate
    of :func:`_damage_gates` and no host fallback; the route it took and
    each step's seconds. Then (b) at 1/32 against the host plain path (a
    ``HOST_RUNS`` worker), and (c) the isotropic history equation at 1/32
    on the card."""
    from porepy_tpu_torch.numerics.linalg.krylov import FALLBACK_COUNTER

    tic0 = time.perf_counter()
    print(f"phase 30: the fracture damage example (anisotropic history) at 1/128, 3 steps, on {dev} by device_gmres")
    fallbacks0 = FALLBACK_COUNTER["count"]
    torch.cuda.synchronize()
    tic = time.perf_counter()
    with _timed_builds() as builds, _launches_of_block() as launches:
        model, _ = damage_case(1.0 / 128, dev)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - tic
    es = model.equation_system
    solver = next(iter(model._device_solvers.values()))
    b = solver._builder
    dense = {i: bool(b._block_dense.get(i, False)) for i in range(len(b.methods))}
    dofs = es.num_dofs()
    newton = sum(rec["newton"] for rec in model.steps)
    fused = [rec["fused"] for rec in model.steps]
    print(f"  {dofs} dofs; the route: device_gmres, field split methods {b.methods}, block sizes {b._sizes}, "
          f"dense inverse by block {dense}; the Newton loop of each step {['fused device loop' if f else 'host loop' for f in fused]}")
    _print_steps(model, "1/128")
    setup_s = run_s - sum(rec["update_s"] + rec["compile_s"] + rec["newton_s"] for rec in model.steps)
    loop_s = sum(rec["newton_s"] for rec in model.steps)
    print(f"  the run {run_s:.3f} s (setup and the steps' bookkeeping {setup_s:.3f} s); {newton} Newton iterations, "
          f"{1e3 * run_s / newton:.2f} ms per Newton iteration over the run, {1e3 * loop_s / newton:.2f} ms in the "
          f"Newton loops (the preconditioner's builds {[round(t, 3) for t in builds]} s inside them); launches {launches}")
    fallbacks = FALLBACK_COUNTER["count"] - fallbacks0
    _require(fallbacks == 0, f"damage: host fallbacks {fallbacks}")
    _require(dofs == 128 * 128 * 2 + 64 * 3 + 256, f"damage: {dofs} dofs")
    _require(len(model.steps) == 3, f"damage: {len(model.steps)} steps")
    _require(all(rec["alive_before"] == 0 for rec in model.steps),
             f"damage: a step before's compiled system or solver outlived it: {[r['alive_before'] for r in model.steps]}")
    needed = ("ell_spmv", "fgmres_arnoldi") + K8_KERNELS
    if any(dense.values()):
        needed += DENSE_KERNELS
    if "amg" in [m for i, m in enumerate(b.methods) if not dense[i]]:
        needed += ("amg_vcycle",)
    missing = [k for k in needed if not launches.get(k)]
    _require(not missing, f"damage: kernels not launched {missing}: {launches}")
    gates = _damage_gates(model, "damage 1/128")
    out = {"dofs": dofs, "run_s": run_s, "setup_s": setup_s, "newton": newton, "builds": list(builds),
           "launches": launches, "methods": list(b.methods), "sizes": list(b._sizes), "dense": dense,
           "steps": [{k: v for k, v in rec.items() if k != "h"} for rec in model.steps], "gates": gates,
           "ms_per_newton": 1e3 * run_s / newton, "loop_ms_per_newton": 1e3 * loop_s / newton}
    del model, solver, b
    torch.cuda.empty_cache()

    print(f"phase 30b: the damage example at 1/32 on {dev} against the host plain path")
    tic = time.perf_counter()
    small, _ = damage_case(1.0 / 32, dev)
    print(f"  on {dev}: {small.equation_system.num_dofs()} dofs, {time.perf_counter() - tic:.3f} s")
    _print_steps(small, "1/32")
    _damage_gates(small, "damage 1/32")
    host = host_fields(functools.partial(damage_case, 1.0 / 32))
    for rec, hrec in zip(small.steps, host["steps"]):
        print(f"  the host's step: {hrec['newton']} Newton (card {rec['newton']}), "
              f"{'fused device loop' if hrec['fused'] else 'host loop'}")
    _fields_close(small, host, ["damage_history", "contact_traction", "u"], DAMAGE_HOST_TOL)
    out["small"] = {f: float(np.abs(small.equation_system.get_variable_values([f], time_step_index=0) - host[f]).max()
                             / np.abs(host[f]).max()) for f in ("damage_history", "contact_traction", "u")}

    print(f"phase 30c: the isotropic history equation at 1/32 on {dev}")
    fallbacks0 = FALLBACK_COUNTER["count"]
    tic = time.perf_counter()
    with _launches_of_block() as iso_launches:
        iso, _ = damage_case(1.0 / 32, dev, history="isotropic")
    print(f"  {iso.equation_system.num_dofs()} dofs, {time.perf_counter() - tic:.3f} s; launches {iso_launches}")
    _print_steps(iso, "isotropic 1/32")
    _require(FALLBACK_COUNTER["count"] == fallbacks0, "damage, isotropic: host fallbacks")
    _damage_gates(iso, "damage 1/32, isotropic")
    h_iso, h_aniso = iso.steps[-1]["h"], small.steps[-1]["h"]
    out["iso_vs_aniso"] = float(np.abs(h_iso - h_aniso).max())
    print(f"  the isotropic history against the anisotropic one at 1/32 (the slip never reverses here): max |diff| "
          f"{out['iso_vs_aniso']:.3e} of {float(np.abs(h_aniso).max()):.3e}")
    out["seconds"] = time.perf_counter() - tic0
    print(f"phase 30 took {out['seconds']:.1f} s")
    return out


def _propagation_gates(model, cells0: int, tag: str) -> None:
    """Phase 31's checks at every step: the fracture grew, every tip that
    grew had a mode-I SIF at or above the critical one (so > 0), the
    largest mode-I SIF > 0, the rebuilt system has a dual rule at every
    node, and nothing of the topology before the last rebuild outlived the
    step after it."""
    cells = [cells0] + [rec["cells"] for rec in model.steps]
    _require(len(model.steps) == PROPAGATION_STEPS, f"{tag}: {len(model.steps)} propagation steps")
    for i, rec in enumerate(model.steps, 1):
        _require(rec["propagated"] and cells[i] > cells[i - 1], f"{tag}: no growth at step {i}: cells {cells}")
        _require(rec["grew"].size > 0 and bool(np.all(rec["grew"] >= CRITICAL_SIF)),
                 f"{tag}: step {i}'s growing tips' SIFs {rec['grew']}")
        _require(float(rec["sifs"].max()) > 0, f"{tag}: step {i}'s mode-I SIFs {rec['sifs']}")
        _require(not any(rec["ruleless"].values()), f"{tag}: step {i}: nodes without a dual rule {rec['ruleless']}")
        _require(rec["alive_before"] == 0, f"{tag}: step {i}: {rec['alive_before']} objects of an old topology alive")


def _print_propagation(model, tag: str) -> None:
    for i, rec in enumerate(model.steps, 1):
        mem = f", allocated {rec['memory'] / 2**20:.2f} MiB" if "memory" in rec else ""
        mem = f", after the rebuild {rec['consts']} device constants{mem}"
        print(f"  {tag} step {i}: {rec['dofs']} dofs solved; opened host faces {rec['opened'].tolist()}, fracture "
              f"cells {rec['cells']}, tip SIFs (mode I) {[float(f'{s:.6e}') for s in rec['sifs']]}, the growing tips' "
              f"{[float(f'{s:.6e}') for s in rec['grew']]}; the criterion {rec['criterion_s']:.3f} s, the rebuild "
              f"{rec['rebuild_s']:.3f} s, the rebuilt system's compile {rec['compile_s']:.3f} s{mem}; the old "
              f"topology's objects alive {rec['alive_before']} of {rec['watched']}")


def run_propagation(dev) -> dict:
    """Phase 31: conforming propagation under tension on a 64 x 64 grid
    (8,300 dofs at the start) on the card, 4 steps, the fracture growing at
    every step (:func:`_propagation_gates`), no host fallback, the card's
    allocated bytes after each rebuild within 2 MiB of the first's and the
    compiler's device constants not growing; then
    (b) the 16 x 16 run on the card against the host plain path (a
    ``HOST_RUNS`` worker): the opened faces and the fracture's cells equal
    at every step, the tip SIFs within ``PROPAGATION_SIF_TOL``."""
    from porepy_tpu_torch.numerics.linalg.krylov import FALLBACK_COUNTER

    tic0 = time.perf_counter()
    print(f"phase 31: conforming fracture propagation under tension on a 64 x 64 grid, {PROPAGATION_STEPS} steps, "
          f"critical SIFs {CRITICAL_SIF:g}, on {dev} by device_gmres")
    fallbacks0 = FALLBACK_COUNTER["count"]
    torch.cuda.synchronize()
    tic = time.perf_counter()
    with _timed_builds() as builds, _launches_of_block() as launches:
        model, _ = propagation_case(64, dev)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - tic
    methods, dense = model.steps[0]["route"]
    print(f"  the run {run_s:.3f} s; the route: device_gmres, field split {methods}, dense inverse by block {dense}, "
          f"the Newton loops {'fused on the device' if all(r['fused'] for r in model.steps) else 'on the host'}; "
          f"the preconditioner's builds {[round(t, 3) for t in builds]} s; launches {launches}")
    _print_propagation(model, "64 x 64")
    _require(FALLBACK_COUNTER["count"] == fallbacks0, "propagation: host fallbacks")
    _propagation_gates(model, 16, "propagation 64 x 64")
    mem = [rec["memory"] for rec in model.steps]
    consts = [rec["consts"] for rec in model.steps]
    # A topology's constants left behind are ~5.5 MiB at this size (the
    # compiler's device constants before they were freed with their host
    # arrays); a few dofs more a step add kilobytes.
    _require(max(mem) <= mem[0] + 2 * 2**20 and max(consts) <= consts[0],
             f"propagation: the allocated bytes or device constants grew after the rebuilds: {mem}, {consts}")
    missing = [k for k in ("ell_spmv", "fgmres_arnoldi") + K8_KERNELS + DENSE_KERNELS if not launches.get(k)]
    _require(not missing, f"propagation: kernels not launched {missing}: {launches}")
    out = {"run_s": run_s, "builds": list(builds), "launches": launches, "memory": mem,
           "steps": [{k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in rec.items()} for rec in model.steps]}
    del model
    torch.cuda.empty_cache()

    print(f"phase 31b: the same run on a 16 x 16 grid on {dev} against the host plain path")
    tic = time.perf_counter()
    small, _ = propagation_case(16, dev)
    print(f"  on {dev}: {time.perf_counter() - tic:.3f} s")
    _print_propagation(small, "16 x 16")
    _propagation_gates(small, 4, "propagation 16 x 16")
    host = host_fields(functools.partial(propagation_case, 16))
    worst = 0.0
    for i, (rec, hrec) in enumerate(zip(small.steps, host["steps"]), 1):
        _require(np.array_equal(rec["opened"], hrec["opened"]) and rec["cells"] == hrec["cells"],
                 f"propagation 16 x 16, step {i}: opened {rec['opened']} / {hrec['opened']}, cells {rec['cells']} / "
                 f"{hrec['cells']}")
        _require(rec["sifs"].shape == hrec["sifs"].shape, f"step {i}: tips {rec['sifs']} / {hrec['sifs']}")
        worst = max(worst, float(np.abs(rec["sifs"] - hrec["sifs"]).max() / np.abs(hrec["sifs"]).max()))
    print(f"  the opened faces and fracture cells equal at every step; tip SIFs max relative |diff| {worst:.3e}, "
          f"tolerance {PROPAGATION_SIF_TOL:g}")
    _require(len(small.steps) == len(host["steps"]) and worst <= PROPAGATION_SIF_TOL,
             f"propagation 16 x 16: SIFs {worst} apart")
    out["small_sif_diff"] = worst
    out["seconds"] = time.perf_counter() - tic0
    print(f"phase 31 took {out['seconds']:.1f} s")
    return out


def bench_cases(dev, thm_steps, berre3d_steps) -> dict:
    """Phases 25 (thm, ``thm_steps`` steps at 1/16), 26 (berre3d,
    ``berre3d_steps`` steps), 27 (Flemisch et al. 2d case 4 at 5 m) and 28
    (Berre et al. 3d case 3 at refinement 0); a phase whose steps are
    ``None`` is not run."""
    out = {}
    if thm_steps is not None:
        tic = time.perf_counter()
        thm = run_thm(dev, thm_steps)
        model = thm.pop("model")
        # Two assemblies a turn, not five: thm's functorch assembly takes
        # ~3.5 s, so three more a turn would add ~21 s to the script.
        thm["routes"] = _assembly_routes_in_turns(model, "thm", repeats=2)
        thm["k15"] = check_thm_k15(model)
        thm["k10"] = check_thm_k10(dev, model)
        del model
        torch.cuda.empty_cache()
        compare_thm_small(dev)
        thm["seconds"] = time.perf_counter() - tic
        print(f"phase 25 took {thm['seconds']:.1f} s")
        out["thm"] = thm
    if berre3d_steps is not None:
        tic = time.perf_counter()
        berre = run_berre3d(dev, berre3d_steps)
        compare_berre3d_small(dev)
        berre["seconds"] = time.perf_counter() - tic
        print(f"phase 26 took {berre['seconds']:.1f} s")
        out["berre3d"] = berre
    tic = time.perf_counter()
    fb = run_fb2d4(dev)
    torch.cuda.empty_cache()
    compare_fb2d4_small(dev)
    fb["seconds"] = time.perf_counter() - tic
    print(f"phase 27 took {fb['seconds']:.1f} s")
    out["fb2d4"] = fb
    tic = time.perf_counter()
    fb3 = run_fb3d3(dev)
    torch.cuda.empty_cache()
    compare_fb3d3_small(dev)
    fb3["seconds"] = time.perf_counter() - tic
    print(f"phase 28 took {fb3['seconds']:.1f} s")
    out["fb3d3"] = fb3
    return out


def bench_summary(bench: dict, smi: str) -> None:
    """Phases 25, 26, 27 and 28's numbers, a line or two each."""
    t = bench.get("thm")
    if t:
        s = t["split"]
        b = t["k10"]["buckets"][(81, 64, 112)]
        print(f"thm 1/16 on {smi}: {t['ms_per_newton']:.2f} ms per Newton iteration (rediscretization "
              f"{s['rediscretize']:.2f}, assembly {s['assemble']:.2f}, solve {s['solve']:.2f} with the preconditioner's "
              f"{len(t['builds'])} builds {s['builds']:.2f}, update {s['update']:.2f}, convergence check "
              f"{s['check']:.2f}, steps' set-up {s['loop']:.2f}, reference residual {s['ref_residual']:.2f}), "
              f"{t['newton']} Newton / "
              f"{t['krylov']} Krylov in {len(t['steps'])} steps, setup {t['setup_s']:.3f} s, launches of one "
              f"assembly {sum(t['per_assembly'].values())} ({t['per_assembly'].get('dual_ew', 0)} dual_ew); the "
              f"reference's CPU {REF_MS['thm']:.0f} ms")
        print(f"thm 1/16 discretization on {smi}, s in turns: host {t['k10']['disc_s']['host']}, K10 "
              f"{t['k10']['disc_s']['k10']}; a fracture rediscretization: host {t['k10']['redisc_s']['host']}, K10 "
              f"{t['k10']['redisc_s']['k10']}; K10 at (81, 64, 112), B {b['B']}: {b['device_us']:.2f} us device "
              f"(graph replay), {b['ms']:.4f} ms, plain {b['plain_ms']:.4f} ms")
        for kind, r in t["k15"]["kinds"].items():
            print(f"K15 at thm 1/16's {kind} call ({r['label']}) on {smi}: device {r['device_us']:.2f} us, host "
                  f"{r['host_us']:.2f} us, {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_us']:.3f} us")
    b = bench.get("berre3d")
    if b:
        print(f"berre3d (refinement 0) on {smi}: {b['ms_per_newton']:.2f} ms per Newton iteration in the blocks, "
              f"Newton / Krylov per block {[(r['newton_iters'], r['krylov_iters']) for r in b['blocks']]}, setup: grid "
              f"{b['grid_s']:.3f} s, prepare {b['setup_s']:.3f} s (discretization {b['disc_s']:.3f} s), compile and "
              f"first assembly {b['compile_s']:.3f} s, the preconditioner's builds {[round(x, 3) for x in b['builds']]} s; "
              f"launches of one assembly {sum(b['per_assembly'].values())} "
              f"({b['per_assembly'].get('dual_ew', 0)} dual_ew); the reference's CPU {REF_MS['berre3d']:.0f} ms")
    for key, label in (("fb2d4", "fb2d4 (5 m"), ("fb3d3", "fb3d3 (refinement 0")):
        f = bench.get(key)
        if not f:
            continue
        r = f["retime"]
        print(f"{label}, {f['dofs']} dofs, {f['subdomains']} subdomains, {f['interfaces']} interfaces) on {smi}: "
              f"{f['ms_per_newton']:.2f} ms per Newton iteration ({f['newton']} Newton, Krylov {f['krylov']}; assembly "
              f"{f['split']['assemble']:.2f}, solve {f['split']['solve']:.2f} of which the builds "
              f"{f['split']['builds']:.2f}), setup: mesh {f['mesh_s']:.3f} s, prepare {f['setup_s']:.3f} s "
              f"(discretization {f['disc_s']:.3f} s), compile and first assembly {f['compile_s']:.3f} s, the "
              f"preconditioner's builds {[round(x, 3) for x in f['builds']]} s; field split {f['methods']} "
              f"{f['sizes']}; largest K {f['ell_k']}; launches in the run {sum(f['launches'].values())}, of one "
              f"assembly {sum(f['per_assembly'].values())}, an assembly {f['assembly_ms']:.2f} ms; a solve at the "
              f"final system {r['solve_ms']:.3f} ms ({r['krylov_iters']} Krylov), K7 {r['apply_device_us']:.2f} us "
              f"device an apply; no reference time")
        k1, k3, kl = f["k1"]["f64 B17"], f["k3"], f["k1"]["level B1"]
        print(f"{label}) K1 and K3 on {smi}: the Jacobian n {k1['n']}, K {k1['K']}, f64 B = 17 device "
              f"{k1['product']['device_us']:.2f} us, f32 B = 1 {f['k1']['f32 B1']['product']['device_us']:.2f} us; "
              f"the widest AMG level n {kl['n']}, K {kl['K']}, nnz {kl['nnz']}, device "
              f"{kl['product']['device_us']:.2f} us (bound {1e3 * kl['product']['bound_ms']:.2f} us, "
              f"{100 * kl['product']['share']:.1f}%; the ELL layout's {1e3 * kl['product']['layout_ms']:.2f}), torch.mv "
              f"{kl['library_ms']:.4f} ms; V-cycle levels {k3['levels']}, K of A, P, R {k3['K']}, device "
              f"{min(k3['device_us']['kernel']):.2f} us an apply (composition "
              f"{min(k3['device_us']['composition']):.2f}), {k3['ms']:.4f} ms by events, largest error against "
              f"the composition {max(r['err'] for r in k3['all']):.3e}")


def build_kernels() -> tempfile.TemporaryDirectory:
    """Phase 2: the library and, beside it, the parents' K8 gather (the
    yardstick of the roots' scatter) and K13 kernels (the yardstick of the
    unstructured step), into ``_PARENT``; the parents' build directory,
    which lives as long as the returned object."""
    from porepy_tpu_torch.applications.benchmarking import root_scatter_check, tpfa_step_check
    from porepy_tpu_torch.kernels import build

    parent_dir = tempfile.TemporaryDirectory()
    parent_build = root_scatter_check.start_build(parent_dir.name)
    k13_build = tpfa_step_check.start_build(parent_dir.name)
    build.library()
    _PARENT["k8"] = root_scatter_check.ParentJacGather(parent_dir.name, parent_build)
    _PARENT["k13"] = tpfa_step_check.ParentTpfa(parent_dir.name, k13_build)
    return parent_dir


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from porepy_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"phase 1: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {name}")

    try:
        return _main(dev, smi, name, build)
    finally:
        stop_host_runs()


def _main(dev, smi: str, name: str, build) -> int:
    parent_dir = build_kernels()
    print(f"phase 2: kernels built in {build.build_seconds():.2f} s")

    report = check_kernels(dev)
    report.update(check_flow_kernels(dev))
    md = run_md(dev)
    compare_small(dev)
    d3 = run_3d(dev, dense=True)
    report.update(check_dense_kernels(dev, d3))
    del d3["D"]
    torch.cuda.empty_cache()
    d3_amg = run_3d(dev, dense=False)
    compare_3d_small(dev)
    flow = run_flow_steps(dev)
    report.update(check_flow_cycles(dev, smi, *flow.pop("kernels")))
    report["region_solve"] = check_region_kernel(dev)
    biot = run_biot(dev, dense=False)
    biot_dense = run_biot(dev, dense=True)
    contact_k2 = compare_poro_small(dev)
    report.update(check_krylov(dev, *_first_newton_system(dev)))
    bicg = run_biot_krylov(dev, "bicgstab", biot)
    gmres = run_biot_krylov(dev, "gmres", biot)
    report["rachford_rice"] = check_flash(dev)
    report["interp_lookup"] = check_lookup(dev)
    tic = time.perf_counter()
    report["block_inverse"] = check_block_inverse(dev, report["region_solve"].pop("real_a"))
    sharded = run_sharded(dev, report["region_solve"].pop("chunks"))
    report.update(sharded["kernels"])
    print(f"phases 17-18 took {time.perf_counter() - tic:.1f} s")
    tic = time.perf_counter()
    report.update(check_upwind_tpfa_kernels(dev))
    report.update(check_dual_kernels(dev))
    print(f"phases 19 and 22 took {time.perf_counter() - tic:.1f} s")
    # Every time of the kernels line is taken: the host plain-path runs of
    # phases 26b, 27b and 20 start in their workers beside the phases left.
    start_host_runs()
    tic = time.perf_counter()
    darcy_ad = run_darcy_ad(dev)
    md256 = run_md256(dev)
    print(f"phases 21 and 24 took {time.perf_counter() - tic:.1f} s")
    bench = bench_cases(dev, THM_STEPS, BERRE3D_STEPS)
    verification = run_verification(dev)
    damage = run_damage(dev)
    propagation = run_propagation(dev)
    tic = time.perf_counter()
    # The AMG run at 1/32 (its first two time steps cost a minute and a half
    # at 1/64, on the card and on the host); the dense run, the assembly in
    # turns and the kernels' launch counts at 1/64.
    tracer = run_tracer(dev, dense=False, cell_size=1.0 / 32)
    tracer_dense = run_tracer(dev, dense=True, turns=True)
    print(f"phase 20 took {time.perf_counter() - tic:.1f} s")

    # The roots' scatter in the line: md 1/128's mass-balance root, one
    # launch (phase 4); its error the largest over every case's roots.
    report["dual_ew_scatter"] = md["routes"]["roots"]["line"]
    # K13's step launch in the line: phase 10's operands at 32^3 (f64), its
    # error the largest difference from reference.tpfa_step there.
    fo = flow["tpfa_operands"]
    report["tpfa_step"] = {"err": fo["err"], "ms": fo["ms"], "plain_ms": fo["plain_ms"], "library_ms": None,
                           "bytes": fo["bytes"], "flops": fo["flops"], "device_us": fo["device_us"]}
    # K12's refinement launch in the line: phase 10's round at 32^3 (f64).
    fr = flow["round"]
    report["structured_refine"] = {"err": fr["err"], "ms": fr["ms"], "plain_ms": fr["plain_ms"], "library_ms": None,
                                   "bytes": fr["bytes"], "flops": 60 * 32768,
                                   "device_us": min(fr["turns"]["new"]["device_us"])}
    # The K8 kernels' error: the largest of phase 22's and of every case's
    # own calls (phase 22 at the cases' shapes).
    for r in (md, d3_amg, biot, tracer_dense, darcy_ad, md256, *bench.values()):
        for k, err in r["routes"]["k8_err"].items():
            report[k]["err"] = max(report[k]["err"], err)

    # K1 in the line: the solve's shape, md 1/128's Jacobian in f32 for one
    # vector (phase 3c); its error the largest of every K1 check.
    k1 = md["k1"]["f32 B1"]
    report["ell_spmv"].update(
        ms=k1["product"]["ms"], plain_ms=k1["plain_ms"], library_ms=k1["library_ms"],
        bound=(k1["product"]["bound_ms"], k1["product"]["bound_by"]),
        err=max([report["ell_spmv"]["err"]] + [r["err"] for m in (md, md256, bench["fb2d4"], bench["fb3d3"])
                                                for r in m["k1"].values()]),
    )

    # K3 in the line: one apply at md 1/128's hierarchy (phase 3c); its error
    # the largest against the composition at any hierarchy (each equal to
    # its plain version).
    k3 = md["k3"]
    report["amg_vcycle"] = {
        "ms": k3["ms"], "plain_ms": k3["plain_ms"], "library_ms": None, "bound": (k3["bound_ms"], "bytes"),
        "err": max(r["err"] for m in (md, md256, d3_amg, biot, bench["fb2d4"], bench["fb3d3"])
                   for r in m["k3"]["all"]),
    }
    # K4 in the line: one step at column 8 of md 1/128's Jacobian in f32
    # (phase 3d), the solve's type; every column of a cycle in f32 and f64
    # equal to the plain version. No one PyTorch call runs an Arnoldi step.
    k4 = md["k4"]["float32"]["timed"][8]
    report["fgmres_arnoldi"] = {"ms": k4["ms"], "plain_ms": k4["plain_ms"], "library_ms": None, "err": 0.0,
                                "bound": (1e-3 * k4["bound_us"], k4["bound_by"]),
                                "device_us": min(k4["device_us"]["kernel"])}
    # K2 in the line: the contact case's Jacobi block at its own count
    # (phase 13), the one path whose frozen count launches sweeps. No one
    # PyTorch call runs s sweeps.
    k2 = contact_k2
    report["jacobi_sweeps"].update(ms=k2["ms"], plain_ms=k2["plain_ms"], library_ms=None,
                                   bound=(k2["bound_ms"], k2["bound_by"]))

    csrc = "porepy_tpu_torch/kernels/csrc/"
    kernels = {
        "ell_spmv": ("ell_spmv.cu", "porepy_tpu/numerics/linalg/amg.py:59", md["launches"]["ell_spmv"]),
        "amg_vcycle": ("amg_vcycle.cu", "porepy_tpu/numerics/linalg/amg.py:327", md["launches"]["amg_vcycle"]),
        "jacobi_sweeps": ("amg_vcycle.cu", "porepy_tpu/numerics/linalg/device_solver.py:256", contact_k2["launches"]),
        "fgmres_arnoldi": ("fgmres_arnoldi.cu", "porepy_tpu/numerics/linalg/device_solver.py:179-212",
                           md["launches"]["fgmres_arnoldi"]),
        "dense_block_scatter": ("dense_block.cu", "porepy_tpu/numerics/linalg/device_solver.py:141", d3["launches"]["dense_block_scatter"]),
        "gj_pivot_inverse": ("dense_block.cu", "porepy_tpu/numerics/linalg/device_solver.py:104", d3["launches"]["gj_pivot_inverse"]),
        "dense_block_apply": ("dense_block.cu", "porepy_tpu/numerics/linalg/device_solver.py:702", d3["launches"]["dense_block_apply"]),
        "structured_residual": ("structured_flow.cu", "porepy_tpu/parallel/structured_flow.py:69", flow["structured_launches"]["structured_residual"]),
        # The structured Newton step no longer launches structured_jvp (its
        # refinement is structured_refine): 0 launches on the path, checked
        # in phase 10; its times are phase 3b's.
        "structured_jvp": ("structured_flow.cu", "porepy_tpu/parallel/structured_flow.py:116", flow["structured_launches"]["structured_jvp"]),
        "structured_refine": ("structured_flow.cu", "porepy_tpu/parallel/structured_flow.py:140",
                              flow["structured_launches"]["structured_refine"]),
        # The unstructured Newton step launches neither tpfa_residual nor
        # tpfa_jvp (its operands are one tpfa_step launch, its solve
        # bicgstab_tpfa): 0 launches on the path, checked in phase 10; their
        # times are phase 3b's.
        "tpfa_residual": ("tpfa_flow.cu", "porepy_tpu/parallel/flow_step.py:72", flow["tpfa_launches"]["tpfa_residual"]),
        "tpfa_jvp": ("tpfa_flow.cu", "porepy_tpu/parallel/flow_step.py:104", flow["tpfa_launches"]["tpfa_jvp"]),
        "tpfa_step": ("tpfa_flow.cu", "porepy_tpu/parallel/flow_step.py:104-105", flow["tpfa_launches"]["tpfa_step"]),
        "structured_linearize": ("structured_flow.cu", "porepy_tpu/parallel/structured_flow.py:124",
                                 flow["structured_launches"]["structured_linearize"]),
        "bicgstab_stencil": ("krylov.cu", "porepy_tpu/parallel/structured_flow.py:132",
                             flow["structured_launches"]["bicgstab_stencil"]),
        # The step's linearization is inside tpfa_step: 0 launches on the
        # path; its times are phase 10b's.
        "tpfa_linearize": ("tpfa_flow.cu", "porepy_tpu/parallel/flow_step.py:104", flow["tpfa_launches"]["tpfa_linearize"]),
        "bicgstab_tpfa": ("krylov.cu", "porepy_tpu/parallel/flow_step.py:109", flow["tpfa_launches"]["bicgstab_tpfa"]),
        "region_solve": ("region_solve.cu", "porepy_tpu/numerics/fv/local_solves.py:168", biot["launches"]["region_solve"]),
        "bicgstab_cycle": ("krylov.cu", "porepy_tpu/numerics/linalg/krylov.py:42", bicg["launches"]),
        "gmres_cycle": ("krylov.cu", "porepy_tpu/numerics/linalg/krylov.py:42", gmres["launches"]),
        "rachford_rice": ("flash.cu", "porepy_tpu/compositional/flash.py:80", report["rachford_rice"]["launches"]),
        "interp_lookup": ("interp_lookup.cu", "porepy_tpu/numerics/ad/operator_functions.py:117", report["interp_lookup"]["launches"]),
        "block_inverse": ("block_inverse.cu", "porepy_tpu/numerics/linalg/matrix_operations.py:105", report["block_inverse"]["launches"]),
        # A one-rank group has no boundary rows: halo_boundary's launches
        # are those of the four row shards of phase 18a, halo_interior's
        # those of phase 18b's one rank, timed at 1 shard in phase 18a.
        "halo_interior": ("halo_spmv.cu", "porepy_tpu/numerics/linalg/device_solver.py:947", sharded["launches"]["halo_interior"]),
        "halo_boundary": ("halo_spmv.cu", "porepy_tpu/numerics/linalg/device_solver.py:947", report["halo_boundary"]["launches"]),
        "upwind_flux": ("upwind.cu", "porepy_tpu/numerics/fv/upwind.py:82", tracer_dense["launches"]["upwind_flux"]),
        "upwind_select": ("upwind.cu", "porepy_tpu/models/constitutive_laws.py:605", tracer_dense["launches"]["upwind_select"]),
        "tpfa_ad_flux": ("tpfa_ad.cu", "porepy_tpu/models/darcys_law_ad.py:71", darcy_ad["launches"]["tpfa_ad_flux"]),
        "tpfa_ad_trace": ("tpfa_ad.cu", "porepy_tpu/models/darcys_law_ad.py:108", darcy_ad["launches"]["tpfa_ad_trace"]),
        "segment_sum_sorted": ("tpfa_ad.cu", "porepy_tpu/numerics/fv/fv_mesh.py:129", darcy_ad["launches"]["segment_sum_sorted"]),
        "dual_ew": ("dual_ad.cu", "porepy_tpu/numerics/ad/equation_system.py:132", md256["launches"]["dual_ew"]),
        "dual_gather": ("dual_ad.cu", "porepy_tpu/numerics/ad/equation_system.py:132", md256["launches"]["dual_gather"]),
        "dual_ew_scatter": ("dual_ad.cu", "porepy_tpu/numerics/ad/equation_system.py:134",
                            md256["launches"]["dual_ew_scatter"]),
    }
    entries = []
    for k, (src, replaces, launches) in kernels.items():
        r = report[k]
        bound_ms, bound_by = r["bound"] if "bound" in r else _bound(
            r["bytes"], r["flops"], r.get("dtype", torch.float64)
        )
        entries.append({
            "name": k, "route": "cuda", "source": csrc + src, "replaces": replaces,
            "launches": launches, "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": r["library_ms"],
        })
        if k in ("gj_pivot_inverse", "dual_ew", "fgmres_arnoldi", "tpfa_ad_flux", "tpfa_ad_trace", "upwind_flux",
                 "upwind_select", "dual_ew_scatter", "structured_refine", "region_solve", "interp_lookup",
                 "tpfa_step"):
            entries[-1]["device_us"] = r["device_us"]
    kernels_line = {"kernels": entries}
    print(
        f"md 1/128 on {smi}: setup {md['setup_s']:.3f} s, "
        f"{md['ms_per_newton']:.2f} ms per Newton iteration (fused blocks)"
    )
    print(
        f"3d 32^3 on {smi}: dense: setup {d3['setup_s']:.3f} s, dense build "
        f"{sum(d3['build_s']):.3f} s (Gauss-Jordan {sum(d3['gj_s']):.3f} s), "
        f"{d3['ms_per_newton']:.2f} ms per Newton iteration; AMG: setup "
        f"{d3_amg['setup_s']:.3f} s, {d3_amg['ms_per_newton']:.2f} ms per Newton iteration "
        f"(reference CPU: 6691 ms)"
    )
    print(f"structured 32^3 on {smi}: {flow['structured_ms']:.3f} ms per Newton step (median of 7); "
          f"Newton steps to the floor, card and host: {flow['structured_newton']}; unstructured {flow['tpfa_newton']}")
    for tag, t in flow["turns"].items():
        print(f"{tag} 32^3 flow step on {smi}, in turns: FlowCycle route {t['ms']['new']} ms, host BiCGStab "
              f"over the jvps {t['ms']['old']} ms per Newton step")
    for n, r in report["flow_floor"].items():
        print(f"flow cycle stencil float32 at {n}^3 (grid {r['grid']}) on {smi}: {r['iterations']} iterations, device "
              f"{r['us_per_iteration']:.3f} us an iteration (graph replay), a solve's start {r['us_start']:.2f} us")
    for tag, r in report["flow_cycles"].items():
        print(f"flow cycle {tag} at 32^3 (grid {r['grid']}) on {smi}: {r['iterations']} iterations, device {r['us_per_iteration']:.3f} "
              f"us an iteration (graph replay), host {r['host_us']:.2f} us a launch, a solve {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.2f} ms, bound {1e3 * r['bound_it'][0]:.3f} us an iteration; linearization "
              f"{r['lin_ms']:.4f} ms, plain {r['lin_plain_ms']:.4f} ms")
    for tag, b in (("AMG", biot), ("dense", biot_dense)):
        print(
            f"biot 1/64 on {smi}, {tag}: setup {b['setup_s']:.3f} s (discretization by K10 "
            f"{b['disc_k10_s']:.3f} s), {b['ms_per_newton']:.2f} ms per Newton iteration, "
            f"{b['newton']} Newton / {b['krylov']} Krylov in the blocks (reference CPU: 567 ms)"
        )
    print(f"biot 1/64 discretization in turns on {smi}: host LAPACK {biot['disc_host_turns']} s, K10 {biot['disc_k10_turns']} s")
    for tag, r in (("jax_bicgstab", bicg), ("jax_gmres", gmres)):
        print(
            f"biot 1/64 on {smi}, {tag}: {r['ms_per_newton']:.2f} ms per Newton iteration ({r['newton']} "
            f"Newton, {r['iters_mean']:.1f} Krylov iterations per solve), host assembly {r['assemble_ms']:.2f} ms, "
            f"solve {r['solve_ms']:.2f} ms per Newton iteration"
        )
    print(
        f"md 1/128 sharded on {smi}, one-rank NCCL group: solve_once {sharded['sharded_ms']:.2f} ms "
        f"(median of 3) against the unsharded assembly and solve {sharded['unsharded_ms']:.2f} ms, "
        f"increments {sharded['dx_diff']:.3e} apart; a time step in {sharded['newton']} Newton iterations; "
        f"one solve_once {sharded['per_solve']}"
    )
    for (size, tag), t in sharded["routes"].items():
        for route, r in t.items():
            print(f"K19 at md 1/128, {size} shard(s), {tag}, {route}, per shard call on {smi}: host us {r['host_us']}, "
                  f"device us {r['device_us']}, ms {r['ms']}, launches a matvec {r['launches']}")
    for tag, r in (("1/32, AMG", tracer), ("1/64, dense (reference CPU at 1/64: 132 ms)", tracer_dense)):
        print(
            f"tracer {tag} on {smi}: setup {r['setup_s']:.3f} s, {r['ms_per_newton']:.2f} ms per Newton "
            f"iteration, {r['newton']} Newton / {r['krylov']} Krylov in the blocks"
        )
    print(
        f"DarcysLawAd 1/128 on {smi}: setup {darcy_ad['setup_s']:.3f} s, {darcy_ad['ms_per_newton']:.2f} ms per "
        f"Newton iteration, {darcy_ad['newton']} Newton / {darcy_ad['krylov']} Krylov in the blocks"
    )
    for tag, r in (("tracer 1/64", tracer_dense), ("DarcysLawAd 1/128", darcy_ad)):
        t = r["assembly_turns"]
        print(f"{tag} assembly (dual route) on {smi}, in turns: plain versions {t['plain']} ms, K14/K15 kernels {t['kernels']} ms")
    for tag, r in (
        ("md 1/128", md), ("3d 32^3", d3_amg), ("biot 1/64", biot), ("tracer 1/64", tracer_dense),
        ("DarcysLawAd 1/128", darcy_ad), ("md 1/256", md256), ("thm 1/16", bench["thm"]),
        ("berre3d", bench["berre3d"]), ("fb2d4 5 m", bench["fb2d4"]), ("fb3d3 refinement 0", bench["fb3d3"]),
    ):
        t = r["routes"]
        print(
            f"{tag} assembly on {smi}, in turns: functorch {t['turns']['functorch']} ms, dual route "
            f"{t['turns']['dual']} ms, {sum(t['launches'].values())} launches an assembly {t['launches']}"
        )
    f = md256["functorch"]
    print(
        f"md 1/256 ({md256['dofs']} dofs) on {smi}: setup {md256['setup_s']:.3f} s, {md256['ms_per_newton']:.2f} ms "
        f"per Newton iteration, {md256['newton']} Newton / {md256['krylov']} Krylov in the blocks; through the "
        f"functorch route {f['ms_per_newton']:.2f} ms, {f['newton']} / {f['krylov']}"
    )
    for tag, m in (("md 1/128", md), ("md 1/256", md256)):
        for shape, r in m["k1"].items():
            print(
                f"K1 at {tag}'s Jacobian, {shape}, on {smi}: device {r['product']['device_us']:.2f} us a launch "
                f"({r['epilogue']['device_us']:.2f} with c - A x), bound {1e3 * r['product']['bound_ms']:.2f} us "
                f"({100 * r['product']['share']:.1f}%), host us a call {r['product']['host_us']}, plain "
                f"{r['plain_ms']:.4f} ms, CSR yardstick {r['library_ms']:.4f} ms"
            )
    for tag, m in (("md 1/128", md), ("md 1/256", md256), ("3d 32^3 AMG", d3_amg), ("biot 1/64 AMG", biot)):
        for r in m["k3"]["all"]:
            print(f"K3 (one V-cycle apply, one amg_vcycle launch) at {tag}, levels {r['levels']}, on {smi}: device "
                  f"us {r['device_us']} (graph replay), host us {r['host_us']}, ms back to back {r['ms_turns']}, "
                  f"bound {1e3 * r['bound_ms']:.3f} us ({100 * r['share']:.1f}%), launches an apply "
                  f"{r['launches']} (composition {r['composition_launches']})")
    for tag, k in (("tracer 1/64's", tracer_dense["k2"]), ("the contact case's", contact_k2)):
        for s_, r in k["by_s"].items():
            print(f"K2 (jacobi_sweeps) at {tag} Jacobi block (n {k['n']}, K {k['K']}), s = {s_}, on {smi}: "
                  f"{r['ms']:.4f} ms ({r['device_us']:.2f} us device), {s_} one-sweep launches "
                  f"{r['one_sweep_ms']:.4f} ms ({r['one_sweep_device_us']:.2f} us device), plain "
                  f"{r['plain_ms']:.4f} ms, bound {1e3 * r['bound_ms']:.3f} us")
    for dt in ("float32", "float64"):
        for j, r in md["k4"][dt]["timed"].items():
            print(f"K4 (one FGMRES Arnoldi step, one fgmres_arnoldi launch) at md 1/128's Jacobian, {dt}, column "
                  f"{j}, on {smi}, in turns with the parent's composition: device us {r['device_us']} (graph "
                  f"replay), host us {r['host_us']}, bound {r['bound_us']:.3f} us ({r['bound_by']}, "
                  f"{100 * r['share']:.1f}%), plain {r['plain_ms']:.3f} ms")
    a = report["bicgstab_cycle"]
    print(f"K18a (one BiCGStab solve's launch, {a['iters']} iterations, matvecs inside) on {smi}: {a['ms']:.4f} ms, "
          f"{a['us_per_iteration']} us an iteration, {a['host_us']} us of host time a launch, plain "
          f"{a['plain_ms']:.1f} ms, bound {1e3 * a['bound_it'][0]:.3f} us an iteration")
    for k in ("tpfa_ad_flux", "tpfa_ad_trace"):
        for r in (report[k], report[k]["cube"]):
            print(f"K14 {k} (one launch: the value and the tangents), {r['label']}, on {smi}: device "
                  f"{r['device_us']:.2f} us (graph replay), host {r['host_us']:.2f} us a call, {r['ms']:.4f} ms by "
                  f"events, plain {r['plain_ms']:.4f} ms, bound {1e6 * r['bytes'] / 3.35e12:.3f} us")
    for k in ("upwind_flux", "upwind_select"):
        r = report[k]
        print(f"K15 {k} (one upwind_dual launch: the value and the tangents), {r['label']}, on {smi}: device "
              f"{r['device_us']:.2f} us (graph replay), host {r['host_us']:.2f} us a call, {r['ms']:.4f} ms by "
              f"events, plain {r['plain_ms']:.4f} ms, bound {1e6 * r['bytes'] / 3.35e12:.3f} us")
    r = report["upwind_flux"]["synthetic"]
    print(f"upwind_flux at the synthetic tracer 1/64 shapes, 16 seeds (the entry points' value and tangent "
          f"launches) on {smi}: device {r['device_us']:.2f} us (graph replay), bound {1e6 * r['bytes'] / 3.35e12:.3f} us")
    ro = md["routes"]["roots"]
    print(f"K8's roots at md 1/128 (the gather inside each root's launch) on {smi}, in turns: device us (graph "
          f"replay) scatter {ro['turns']['new']['device_us']}, parent (rows + jac_gather) "
          f"{ro['turns']['parent']['device_us']}; host us {ro['turns']['new']['host_us']} / "
          f"{ro['turns']['parent']['host_us']}; bound {ro['bound_us']:.3f} us; plain {ro['plain_ms']:.4f} ms; the "
          f"gather by index_select x2 + cat x2 + negation {ro['library_ms']:.4f} ms ({ro['library_device_us']:.2f} us "
          f"device)")
    for tag, r in (("md 1/128", md), ("md 1/256", md256), ("tracer 1/64", tracer_dense), ("biot 1/64", biot),
                   ("DarcysLawAd 1/128", darcy_ad), ("3d 32^3", d3_amg), ("thm 1/16", bench["thm"]),
                   ("berre3d", bench["berre3d"]), ("fb2d4 5 m", bench["fb2d4"]),
                   ("fb3d3 refinement 0", bench["fb3d3"])):
        t = r["routes"]["parent_turns"]
        print(f"{tag} assembly on {smi}, the roots' scatter against the parent's route in turns: least ms "
              f"{t['turns']['new']['least']} / {t['turns']['parent']['least']}, median {t['turns']['new']['median']} / "
              f"{t['turns']['parent']['median']}, host us {t['turns']['new']['host_us']} / "
              f"{t['turns']['parent']['host_us']}; launches an assembly {sum(t['launches']['new'].values())} "
              f"{t['launches']['new']} / {sum(t['launches']['parent'].values())}; from the functorch route "
              f"{r['routes']['functorch_diff']}")
    rt = md["retime"]
    print(f"K5/K7/K9 at md 1/128 on {smi}: a solve {rt['solve_ms']:.3f} ms by events ({rt['krylov_iters']} Krylov), "
          f"card busy {rt['busy_ms']:.3f} of {rt['traced_ms']:.3f} ms traced; a K7 apply {rt['apply_device_us']:.2f} "
          f"us device, {rt['apply_host_us']:.2f} us host; {md['ms_per_newton']:.2f} ms per Newton iteration")
    fo, ft = flow["tpfa_operands"], flow["tpfa_parent_steps"]
    print(f"K13 step operands at 32^3 on {smi}, in turns: device us {fo['turns']['new']['device_us']} against the "
          f"parent route's {fo['turns']['parent']['device_us']} (its tpfa_linearize alone {fo['parent_linearize_us']}), "
          f"host us {fo['turns']['new']['host_us']} / {fo['turns']['parent']['host_us']}, launches {fo['launches']}; "
          f"an unstructured step {ft['ms']['new']} / {ft['ms']['parent']} ms")
    fr, fs = flow["round"], flow["parent_steps"]
    print(f"K12 refinement round at 32^3 on {smi}, in turns: device us {fr['turns']['new']['device_us']} against the "
          f"parent's {fr['turns']['parent']['device_us']}, host us {fr['turns']['new']['host_us']} / "
          f"{fr['turns']['parent']['host_us']}; a structured step {fs['ms']['new']} / {fs['ms']['parent']} ms; the "
          f"residual/tangent kernels' device us {dict((k, round(v['device_us'], 2)) for k, v in report['flow_kernels'].items())}")
    for k, us in (("upwind_select", report["upwind_select"]["synthetic"]["device_us"]),
                  ("segment_sum_sorted", report["segment_sum_sorted"]["device_us"])):
        print(f"{k} at its phase 19 synthetic shapes on {smi}, device us (graph replay, in turns): kernel "
              f"{us['kernel']}, one PyTorch call {us['library']}")
    g6 = report["gj_pivot_inverse"]
    print(f"K6 gj_pivot_inverse, one 128^2 f32 block (the dense build's launch) on {smi}: device us in turns "
          f"{g6['device_us_turns']['kernel']}, torch.linalg.inv_ex {g6['device_us_turns']['inv_ex']}; the dense "
          f"build's Gauss-Jordan at 32^3's size, s in turns: kernel route {g6['gj_s_turns']['kernel']}, plain route "
          f"{g6['gj_s_turns']['plain']}")
    e8 = report["dual_ew"]
    p8 = md["routes"]["dual_ew_programs"]
    sums = p8["sums"]["launchers"]
    print(f"K8 dual_ew at phase 22's program on {smi}: {e8['device_us']:.2f} us device (graph replay), "
          f"{e8['host_us']:.2f} us host a launcher call; md 1/128's {p8['calls']} calls of an assembly, summed: "
          f"device us {[round(t['device_us'], 2) for t in sums]}, host us {[round(t['host_us'], 2) for t in sums]}; "
          f"at most {p8['max_slots']} slots")
    for tag, m in (("md 1/128", md), ("md 1/256", md256)):
        print(f"{tag} on {smi}: Newton / Krylov per block {[(rec['newton_iters'], rec['krylov_iters']) for rec in m['blocks']]}")
    d = report["dual_gather"]
    print(f"dual_gather at md 1/128's shapes on {smi}, in turns: launchers {d['turns']['launchers']} ms, functional "
          f"wrappers {d['turns']['wrappers']} ms, index_select x2 + cat {d['turns']['library']} ms; host us a "
          f"call {d['host_us']}")
    g = report["gmres_cycle"]
    print(f"K18b (one GMRES(30) restart, 31 matvecs inside) on {smi}: {g['ms_turns']} ms, {g['host_us']:.2f} us "
          f"of host time a launch, grid {g['grid']} blocks, plain {g['plain_ms']:.4f} ms, bound {g['bound'][0]:.6f} ms; "
          f"torch.mv(V, w) {g['mv_ms']:.4f} ms")
    bench_summary(bench, smi)
    for case, v in verification.items():
        if case == "line_search":
            print(f"line search on {smi}: Newton iterations plain / line search {v['newton'][False]} / "
                  f"{v['newton'][True]}, {v['evaluations']} indicator evaluations and {v['residuals']} residual "
                  f"assemblies in {v['searches']} searches, launches inside them {v['launches']}; tractions "
                  f"{v['diff']:.3e} apart, plain Newton's {v['host_diff']:.3e} from the host's")
        elif case != "seconds":
            print(f"{case} on {smi}: {v['dofs']} dofs, {v['s']:.3f} s by device_gmres, errors "
                  f"{ {f: float(f'{e[-1]:.6e}') for f, e in v['errors'].items()} } at the last time, launches "
                  f"{sum(v['launches'].values())}")
    g = damage["gates"]
    print(f"damage 1/128 ({damage['dofs']} dofs, 3 steps) on {smi}: {damage['run_s']:.3f} s, {damage['newton']} Newton, "
          f"{damage['ms_per_newton']:.2f} ms per Newton iteration over the run, {damage['loop_ms_per_newton']:.2f} in "
          f"the Newton loops; per step (update, compile, Newton loop) s "
          f"{[(round(r['update_s'], 3), round(r['compile_s'], 3), round(r['newton_s'], 3)) for r in damage['steps']]}, "
          f"the preconditioner's builds {[round(t, 3) for t in damage['builds']]} s; route {damage['methods']} "
          f"{damage['sizes']} dense {damage['dense']}, {'fused device' if all(r['fused'] for r in damage['steps']) else 'host'} "
          f"Newton loops; launches {sum(damage['launches'].values())} {damage['launches']}; max h {g['h_max']:.6e}, "
          f"the damage laws from numpy within {max(g['friction_damage'], g['dilation_damage']):.3e}; 1/32 against "
          f"the host {damage['small']}; isotropic against anisotropic {damage['iso_vs_aniso']:.3e}; phase 30 "
          f"{damage['seconds']:.1f} s")
    print(f"propagation 64 x 64 ({PROPAGATION_STEPS} steps) on {smi}: {propagation['run_s']:.3f} s, the rebuilds "
          f"{[round(r['rebuild_s'], 3) for r in propagation['steps']]} s, the rebuilt systems' compiles "
          f"{[round(r['compile_s'], 3) for r in propagation['steps']]} s, the preconditioner's builds "
          f"{[round(t, 3) for t in propagation['builds']]} s, allocated MiB after each rebuild "
          f"{[round(m / 2**20, 2) for m in propagation['memory']]}, fracture cells "
          f"{[r['cells'] for r in propagation['steps']]}; launches {sum(propagation['launches'].values())} "
          f"{propagation['launches']}; 16 x 16 against the host: SIFs {propagation['small_sif_diff']:.3e} apart; "
          f"phase 31 {propagation['seconds']:.1f} s")
    for e in entries:
        print(f"kernel {e['name']} on {smi}: {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, "
              f"bound {e['bound_ms']:.6f} ms ({e['bound_by']}), library {e['library_ms']}, launches {e['launches']}")
    print(smi)
    print(json.dumps(kernels_line))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
