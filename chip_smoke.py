#!/usr/bin/env python3
"""On-card smoke check of the PyTorch port's main paths: batched 2Q process
tomography (BASELINE config 2), batched quantum volume (config 5), batched
1Q process tomography, the per-problem process-MLE routes, the Jacobi CP
projection, batched state tomography (config 1), batched RB decay fits
(config 3), channel distances with batched diamond norms (config 4), the
tomography protocol end to end on the port's QVM (``do_tomography``), the
Clifford-engine protocols, and quantum volume from circuits (config 5),
entangled states, the ripple-carry adder and the sharded entry points, the
example scripts and notebooks of ``examples_torch/``, and the entry step
with its dry run over a four-shard mesh, and the measurement harnesses
``bench`` and ``bench_all``.

Run from the root of a checkout on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases, each of which must pass:

1. the card: ``nvidia-smi`` name and power limit, ``torch`` device name;
2. build: compile the CUDA kernels from the sources in the checkout; print
   each kernel's registers and spills, and a summary line for the one-qubit
   fused kernel and the CP kernel;
3. kernel against plain version, both fused schedules, at B = 256 (with a
   third schedule there that uses the (outer, dykstra, sweeps, sweeps_rest)
   phase form and ``final_sweeps_rest``), at
   B = 253 (not a multiple of the four problems per block: the last block
   runs empty slots) and at the main path's B = 16384: the kernel's f32 result,
   the plain PyTorch version's f32 result and its f64 result, all on the
   card, from the same counts and warm start. Bar: the kernel's max
   elementwise deviation from f64 is at most 2 x the plain f32 deviation +
   1e-5, and its trace-preserving (TP) violation is under 1e-5;
4. the main path at full size: A from ``process_tomo_A_matrix(2)``,
   B = 16384 problems, 2000 shots per setting, through
   ``tomography.pgdb_process_estimate_batched(method="apg",
   cp_method="pallas")`` with the headline and parity schedules; the kernel's
   launch counter, zeroed just before, must move for each, outputs must be
   finite, the mean relative Frobenius error against the true Choi matrices
   under 0.12 and the TP violation under 1e-5;
5. timing with CUDA events (one warm-up, median of 3) at B = 16384 of the
   warm start, of the kernel and of the plain version of the solve (both
   from the same warm start); the B = 16384 check of phase 3 uses the
   outputs of these timed runs. Beside the kernel time: the problems per
   block, the bytes of A it reads from L2 per solve
   (``apg_fused_l2_bytes_per_solve``) and the L2 rate they imply, and the
   one-problem-per-block design's times for comparison (text). Then the
   split of the kernel's time: the kernel timed on a schedule of 31 passes
   over A and no projection, and on two of 20 Dykstra iterations (1 and 3
   sweeps) and one pass, give the time of a pass, of an iteration and of a
   further sweep, and so each schedule's time in passes and projections;
6. the quantum-volume kernels against their plain versions on the same
   inputs, at depth 8 and T = 256, depth 7 (odd) and T = 256, and depth 8
   and T = 500 (a last tile of 4 of its 8 trajectories), C = 16 circuits,
   2% two-qubit depolarizing noise. Ideal: within 2e-6 of the plain f32
   version and 1e-5 of the plain f64 version. Trajectory: more than 97% of
   trajectories within 1e-4 of the plain f32 version (the rest flip a branch
   where u is within f32 round-off of a cumulative sum), columns summing to
   1 within 1e-5. Then, on a generator of their own, the trajectory kernel
   at depths 2, 3, 5, 9 and 10 and with K = 1 and K = 32 operators (random
   CPTP stacks), small C and T, under the same bar; and at depths 5, 8 and
   10, T = 500: the kernel run on the first 256 and on the first 7
   uniforms gives bitwise the first columns of the run on all 500 (a
   column does not depend on its block-mates). The ideal kernel, on a
   generator of its own, at every depth from 2 to 10 at C = 16 (2, 3, 4, 5,
   6, 9, 10; 7 and 8 above) and at a tail count (``ideal_tail_circuits``:
   the last block, and at depths below 7 the last warp's lane groups, part
   empty), under the same bars; the first rows of each tail count rerun
   alone give bitwise the same floats;
7. the quantum-volume main path at full width through
   ``quantum_volume.sample_heavy_outputs_batched(device="cuda")``: depth 8,
   C = 1600 circuits, 1000 shots, ideal and with 2% depolarizing noise by
   the trajectory method at T = 1000. Each kernel's launch counter, zeroed
   just before, must move; the heavy-output probability must lie in
   [0.83, 0.87] (ideal; the asymptote is (1 + ln 2)/2 = 0.847) and
   [0.60, 0.72] (noisy), and within 4 binomial sigma of the same path run
   on the card with the plain versions in place of the kernels;
8. timing with CUDA events (one warm-up, median of 3) at C = 1600 (T = 1000)
   of each quantum-volume kernel alone (on laid-out inputs), of its wrapper
   (and the wrapper's time beyond the kernel's) and of its plain version,
   with circuits/s, the bound and the share of the bound; the ideal kernel
   and its wrapper also as the mean of ``QUEUED`` calls enqueued behind a
   device sleep (``queued_ms``: the card runs them back to back, so the
   host's time per call stays out), beside the host's time per wrapper
   call, at depths 8 and 4; the full-size kernel-against-plain check uses
   these outputs; the registers, spills and stack of every depth
   instantiation of both kernels (ptxas); a ``torch.profiler`` pass over
   each wrapper alone: the trajectory wrapper must launch no matrix product
   (W and M' are formed in the kernel), the ideal wrapper nothing but the
   ideal kernel, once (it forms the boundary maps itself). The
   Haar draw of a depth-8 call (Gram-Schmidt) beside ``torch.linalg.qr``
   on a draw of the same size (one warm-up, one run). Then
   ``quantum_volume.measure_quantum_volume_batched(max_depth=8,
   num_circuits=1600)`` end to end, ideal and noisy (depths 2-6 by the
   density method, 7-8 by trajectories), on the host clock, and a
   ``torch.profiler`` pass over one main-path call each, ideal and noisy:
   kernel launches, device busy time, the top kernels and host operations.

9. the dim = 2 (one-qubit) fused kernel against its plain f32 and f64
   versions at B = 256 (here) and B = 16384 (phase 10), default schedule,
   on the same counts and warm start. Bar: at the median and the 90th
   percentile of the per-problem max deviation from f64, the kernel's is
   at most 2 x the plain f32 one's + 1e-5; the 99th percentile of the
   per-problem TP violation is under 1e-5, the largest under 1e-3, and at
   most 2 x + 2 as many problems exceed 1e-5 as in the plain f32 solve.
   Not the maxima, as at dim = 4: the default
   schedule amplifies f32 round-off on a few problems in a thousand (the
   plain f32 version on the host CPU and on the card differ as much on the
   same inputs, printed here), and leaves a few in ten thousand far from
   the physical set (counted in phase 10), where f32 cannot hold TP to
   1e-5 (the plain f32 version neither); the maxima are printed. Then the
   same bar at B = 261 (``TAIL_BATCH_1Q``: the last block of 64 problems
   part empty, and its last warp of eight), on a generator of its own, and
   the first 5, 17 and 69 of those problems solved alone must be bitwise
   those of the B = 261 run (a problem does not depend on its warp- or
   block-mates);
10. the one-qubit main path: A from ``process_tomo_A_matrix(1)``,
   B = 16384 problems, 2000 shots, through
   ``tomography.pgdb_process_estimate_batched(dim=2, method="apg",
   cp_method="pallas")``; the launch counter, zeroed just before, must
   move, outputs must be finite, the mean relative Frobenius error within
   2% of the plain f64 solve's on the same counts, and the TP violation
   within phase 9's bar. Then CUDA-event timings (one warm-up, median of
   3) of the kernel alone and of the plain f32 version, whose outputs make
   phase 9's B = 16384 check;
11. the per-problem routes on the card, float32: ``method="pgdb"`` with the
   default arguments and the warm-start APG route (``method="apg",
   warm_start=True, loop_dyk_iters=1``), at dim = 2 and dim = 4 on the
   first ``ROUTE_BATCH`` problems of the main paths. Each prints its host
   clock and ``torch.linalg.eigh`` calls, the port kernels' launch counters
   (no kernel runs there), the device kernel launches, busy time,
   synchronizations and top kernels from ``torch.profiler`` over a second
   run, and the deviation from the fused kernel's estimate
   (median and maximum, beside the JAX package's 1e-3 for PGDB against
   APG). Bar: finite, TP violation under 1e-5, and a mean relative
   Frobenius error against the truth at most 5% above the fused kernel's;
12. the Jacobi CP projection ``ops.pallas_eigh.cp_project_pallas(h,
   sweeps=6)`` on the linear-inversion estimates of the config-2 main path
   (B = 256, then the main path at B = 16384 with the launch counter zeroed
   just before) and on Gaussian Hermitian matrices (B = 256): within 1e-4
   of ``proj_choi_to_completely_positive`` in float64; then, on a
   generator of its own, B = 259 Gaussian matrices (``TAIL_BATCH_CP``: the
   last block of eight matrices part empty): within 1e-4 of eigh in f64
   after 6 sweeps and of the plain f32 version after 1 sweep (far from
   converged: it holds the rotations to the plain version's round order),
   and the first 3 and 9 matrices projected alone bitwise those of the
   B = 259 run;
13. CUDA-event timings at B = 16384 of the CP kernel, its plain version and
   the library route ``proj_choi_to_completely_positive`` (``torch.linalg.eigh``),
   with the bounds of both new kernels and their shares;
14. BASELINE config 1 (``bench_all.py:57``), plain PyTorch: B = 262144 Haar
   one-qubit pure states (normalized complex Gaussian 2-vectors) and 2000
   shots per Pauli drawn on the card; linear inversion (r = e) and
   ``tomography.iterative_mle_state_estimate_batched(XYZ, e, 3 * shots,
   tol=1e-7, maxiter=60, warm_start=True, representation="bloch")``, with
   each problem's fidelity (1 + r . r_true)/2 against its true state, in
   float32 and float64 on the card. Bars: finite (B,) fidelity arrays, the
   float32 mean MLE fidelity within 1e-4 of the float64 one, mean
   fidelities >= 0.999 (linear inversion) and >= 0.99 (MLE), and no launch
   of a hand kernel; |r32 - r64| at the median, 99th percentile and
   maximum. Then, per dtype, CUDA events (one warm-up, median of 3), the
   host clock, solves/s, the Bloch steps run and
   ``mle_bloch_flops_per_solve`` with the bound and its share, and a
   ``torch.profiler`` pass (launches, busy time, synchronizations, top
   kernels). Then the general route: 2Q, all 15 traceless Paulis,
   B = 4096, warm start, tol = 1e-7, at most 300 steps, complex64 and
   complex128, the host clock, iterations, launches, busy time and
   synchronizations; the float32 mean fidelity within 1e-4 of float64's;
15. BASELINE config 3 (``bench_all.py:131``), plain PyTorch: B = 65536
   survival curves at depths 2, 6, ..., 30, 500 shots, decays uniform in
   [0.9, 0.995], fitted by ``analysis.fitting.fit_model_batched(
   _base_param_decay_p, ..., p0=[0.5, 0.95, 0.5], num_iters=50)`` in
   float32 and float64 on the card. Bars: finite outputs of the right
   shapes, float32 within 1e-4 of float64 in mean |decay error|, which is
   at most 0.02, and no launch of a hand kernel. Per dtype, CUDA events,
   host clock, fits/s, ``lm_flops_per_fit(8, 3, 50)`` with the bound and
   its share, and a profiler pass; the final covariance's batched
   ``pinv`` timed alone. The first 64 curves fitted in float64 to
   convergence (300 steps) against scipy's ``curve_fit``: each within
   1e-5 on every parameter, or, where the minimum lies in a flat valley,
   at a cost no higher than scipy's, or a curve where scipy finds no
   minimum (the counts of each are printed). Then
   ``randomized_benchmarking.simulate_rb_survival_batched`` on the card
   (float64) over 32 random one-qubit sequences of 2 to 16 unitaries that
   compose to the identity: survival 1 without noise and
   (1 + 0.9^L)/2 under depolarizing noise (1e-10), and
   ``fit_rb_results`` of 5000-shot samples recovers the decay 0.9 (0.02).
16. BASELINE config 4 (``bench_all.py:176``), plain PyTorch: 2 x 1024 and
   2 x 2048 2Q BCSZ Choi matrices (Kraus rank 16), float64, drawn on the
   card from the phase's own generator before any timing (float32 runs use
   their complex64 casts). The distance step at B = 1024,
   ``process_fidelity(choi2pauli_liouville(c0), choi2pauli_liouville(c1))``
   and ``trace_distance(c0 / 4, c1 / 4)``: finite (B,) outputs, float32
   within 1e-5 of float64 in both, and no launch of a hand kernel; per
   dtype CUDA events (median of 3 after a warm-up), pairs/s, the host
   clock and a profiler pass (launches, busy time, synchronizations); the
   float32 step with the generation of its channels, as the JAX row times
   it. The diamond norm at B = 2048 through ``diamond_norm_distance``
   (``method="auto"``), float32: it must take the fused route
   (``ops/lanes_dnorm.dnorm_planes``, one call) and launch no hand kernel;
   CUDA events, dnorms/s, the host clock, the launches, busy time and
   synchronizations of the call (profiled at 1 and 9 of its fixed Adam
   steps, the difference scaled to its 96: a profile of the whole call's
   ~236 k launches took most of the phase), the mean diamond
   norm, ``dnorm_flops_per_problem`` with the bound and its share; the
   dense route (``method="dense"``) at the same B with its Adam steps, for
   comparison. The first 64 pairs' fused values within 1e-5 of a float64
   dense gold on the card (800 steps, ``stop_tol=0``, two restarts), with
   the max and mean error. Analytic cases in float32 on the card through
   ``method="auto"``, held to 1e-5: dnorm(I, X) = 2, depolarizing (p = 0.1,
   0.3, 0.7) against the identity = 1.5 p, and a channel against itself 0
   with no NaN (1Q and 2Q).
17. the tomography protocol on the card, plain PyTorch but for part (c):
   circuit -> experiment -> grouped settings -> compiled programs -> the
   port's QVM (complex128) -> symmetrized shots -> moments -> calibration
   -> estimate, through ``tomography.do_tomography`` at its defaults (1000
   shots, exhaustive symmetrization, greedy grouping, calibration). With
   every launch counter zeroed first: (a) 2Q process tomography of CZ(0, 1)
   with 2% two-qubit depolarizing noise on CZ and readout confusion of 2%
   (0 -> 1) and 5% (1 -> 0) per qubit: 540 settings in 324 groups and 15
   calibration programs; every program's probabilities on the card within
   1e-12 of the port's CPU result; the process fidelity to the true
   channel at least 0.85 (on the CPU, ``scripts/tomography_protocol_cpu.py``:
   the JAX package 0.925-0.968 over 8 seeds, the port 0.893-0.971 over 20).
   (b) 3Q GHZ state tomography, same readout confusion: 27 groups of 8
   flip patterns, fidelity in [0.95, 1.05] (JAX 0.990-1.018 over 15 seeds,
   the port 0.985-1.022; calibrated expectations leave [-1, 1], so the
   diluted MLE's estimate need not be positive). Each with the host clock
   of acquisition, calibration and estimation, circuits/s, and a
   ``torch.profiler`` pass (launches, busy time, synchronizations); no hand
   kernel launches. (c) the fused kernel on data from circuits: the process
   experiments of pairs (0, 1) and (2, 3) merged, acquired in one
   ``estimate_observables`` run (4-qubit density matrices, 16 patterns) and
   split by ``get_results_by_qubit_groups``; each pair's rows permuted into
   (a)'s order by setting, where their A must equal (a)'s bitwise. The
   batch is (a)'s counts before calibration, the two pairs', and (a)'s
   calibrated counts; one call each of ``apg_fused`` with its default
   schedule and of ``pgdb_process_estimate_batched(cp_method="pallas")``
   with the tuned headline and parity schedules, each one launch. The
   default schedule's first three estimates within 1e-2 relative
   Frobenius of ``pgdb_process_estimate`` on the same results, and the
   kernel within phase 3's bar of its plain version on them; the tuned
   schedules' gaps and the calibrated row's are printed, not held (the
   tuned step, and any step on negative counts, diverges on these
   near-unitary channels, in the JAX package as here: PERF.md). CUDA-event
   times of the kernel, its plain version and the call, with the bound.

18. the protocols of the Clifford engine on the card, plain PyTorch, with
   every launch counter zeroed first and no hand kernel launched; the
   port's QVM (complex128) on the card throughout. ``clifford_group(2)``'s
   breadth-first search is timed first (host). (a) ``do_rb``, with a
   channel attached to every Clifford (``clifford_noise`` wraps the
   module's ``group_sequences_into_parallel_experiments`` for the call, as
   the JAX suite's ``add_noise_to_sequences`` does before grouping): 1Q RB
   under the Pauli channel of ``test_randomized_benchmarking.py:31`` (decay
   within 2.5 sigma of 0.85), 2Q RB under 5% depolarizing (within 2.5
   sigma of 0.95), 1Q IRB with 4% depolarizing per Clifford and 10% on the
   interleaved RX(pi/2) (``irb_decay_to_gate_error`` within 2.5 sigma of
   0.05), and 1Q unitarity under depolarizing decay 0.9 (within 0.02 of
   0.81, the implied RB decay within 0.02 of 0.9). (b) ``do_t1_or_t2``
   for T1 = 12 us (within 1 us), T2* and T2 echo at T2 = 9 us (within
   1.5 us), 4000 shots. (c) ``do_dfe``, state and process, of a random 2Q
   Clifford drawn from ``clifford_group(2)``: noiseless at least 0.99;
   with 10% two-qubit depolarizing after it, within 0.02 of 1 - 3p/4
   (config 4's DFE half). (d) ``do_rpe`` of RZ(0.3), RZ(1.1) and RZ(2.5)
   within 0.05 rad. (e) ``estimate_joint_confusion_in_set`` over qubit
   pairs of three qubits with a known readout confusion on two: every
   entry within 5 binomial sigma. Each run is timed by stage (generation,
   acquisition, fit) with the circuits simulated, circuits/s and the
   executor cache's hits and misses; the acquisition of one run an item
   (of 1Q and 2Q RB in (a)) is profiled again (launches, busy time,
   synchronizations); a sample of every run's
   programs has its probabilities on the card within 1e-12 of the CPU's.
   (f) BASELINE config 3 from circuits: 1000 2Q RB sequences from the
   Clifford engine (200 at each of depths 2, 4, 8, 16 and 32) and 1000
   with an interleaved CZ; ``sequences_to_ptm_stack`` on the host,
   ``simulate_rb_survival_batched`` on the card (float64, 2% two-qubit
   depolarizing PTM after every element, 500 shots), ``fit_rb_results``;
   both decays within 0.01 of the analytic ones (0.98 and 0.98^2), each
   stage timed, the simulation profiled, and exact survivals of a sample of
   sequences on the card within 1e-12 of the CPU's.

19. this slice on the card, the port's QVM in complex64, with the launch
   counters zeroed before each path and read after it. (a) BASELINE config
   5 from circuits: ``measure_quantum_volume`` on 8 qubits at the JAX
   package's defaults (100 circuits, 1000 shots, depths 2-8, 700
   circuits, ``RandomState(0)``), each depth timed by stage (drawing,
   programs, ``qvm.run``, heavy sets, the shot count on the host) with
   circuits/s and the executor cache's hits and misses, and a profiled
   sample of 5 circuits a depth (launches, synchronizations, busy time a
   program); it launches no hand kernel. Then
   ``measure_quantum_volume_batched`` at the same sizes on the card (one
   ideal-kernel launch a depth). At every depth the two heavy-output
   probabilities differ by at most the sum of their 2-sigma widths, and
   both give QV 2^8. (b) the same with 2% depolarizing on each qubit of
   every ``QVGATE`` (``define_noisy_gate``; the per-circuit path takes the
   QVM's density route), ``stop_when_fail``, against the batched path with
   the same Kraus stack (density to depth 6, the trajectory kernel from 7):
   the same bar at the depths both reached, QV below 2^8 for both. (c) the
   router: ``topology_restricted_program_generator`` on an 8-qubit line
   with 50% depolarizing on each qubit of every SWAP, depth 5, 100
   circuits: every 2Q gate of the routed circuits on a line edge, and the
   heavy-output probability below the all-to-all run's. (d) GHZ on a
   branching 8-qubit tree (share of 2000 shots > 0.99), the 8-cycle graph
   state's stabilizers within 1e-5 of 1, and
   ``compiled_parametric_graph_state``: natives only, its probabilities on
   the card within 1e-5 of the uncompiled program's on the CPU. (e)
   ``get_n_bit_adder_results`` for 3 bits, 64 summand pairs, in the Z and
   X bases (every success probability 1) and with the adder example's
   noisy readout (mean success printed), with circuits/s and cache misses.
   (f) the sharded entry points on ``make_mesh()`` (one device on a
   one-card machine) and on a mesh that repeats the card twice (its shards
   run one after the other): ``apg_fused_sharded`` at B = 16384 (headline
   schedule) bitwise equal to ``apg_fused``, one kernel launch a shard, by
   CUDA events; ``sample_heavy_outputs_sharded`` at depth 8, C = 1600,
   ideal and by trajectories (T = 1000), bitwise equal to the per-shard
   ``sample_heavy_outputs_batched`` runs with ``fold_in``, one launch of
   each kernel a shard; ``dnorm_fused_sharded`` at B = 2048 (2Q BCSZ, Kraus
   rank 16) within 1e-5 of ``dnorm_fused``, on the host clock; and
   ``batch_sharded`` around ``simulate_rb_survival_batched`` within 1e-12
   of the unsharded run.

20. every script of ``examples_torch/`` (the counterparts of the JAX
   package's ``examples/``), in this process, through its
   ``main(device="cuda", out_dir="build/examples")``, with the launch
   counters zeroed before each and read after it: the host seconds, the
   counters, the script's own lines, and the figures it returns (what it
   prints), each held to its bar in ``EXAMPLE_BARS`` (the bars of the
   tests of ``examples_torch/``; the scripts compute in float64 /
   complex128 on the card, so the round-off bars stay 1e-12). The ideal QV
   kernel's counter must move in ``quantum_volume``; the route of its noisy
   batched scan (the density method or the trajectory kernel, as
   ``quantum_volume`` picks it) is printed. Without matplotlib, the
   plotting example runs as far as its first figure call, which must raise
   ImportError; with it, the figures drawn from the card's tensors must be
   bitwise those drawn from the same tensors on the CPU. Budget: 90 s.

21. every notebook of ``examples_torch/notebooks/`` (the counterparts of
   the JAX package's 23 notebooks), in this process, through the
   plain-Python cell runner ``examples_torch/notebooks/_runner.py`` with
   ``DEVICE`` the card, the launch counters zeroed before each notebook
   and read after each cell: the host seconds, the counters (by cell),
   the notebook's own lines, and the quantities it prints, each held to
   its bar in ``NOTEBOOK_BARS`` (the bars of the notebook tests). Every
   figure cell must raise ImportError where matplotlib is absent (the
   runner checks it; with matplotlib it draws with Agg). The ideal QV
   kernel must launch in ``quantum_volume`` and the trajectory kernel in
   the trajectory cell of ``quantum_volume_noisy``. Budget: 120 s.
22. ``entry.entry()``'s step once at B = 64 (finite process fidelities of
   shape (64,)) and ``entry.dryrun_multichip(4)`` on a mesh of the card
   repeated four times (the first four cards where a machine has them):
   its five legs print their lines and hold the JAX package's bars (the
   sharded APG solve and the sharded ideal QV bitwise equal to the
   unsharded and per-shard runs), and the APG, trajectory and ideal
   kernels' counters must move.
23. the measurement harnesses at the JAX package's sizes, with the launch
   counters zeroed before and read after: ``bench.main()`` (config 2 at
   B = 16384: both fused schedules, the sustained figure, the comparison
   routes, the f64 parity half on the CPU) and ``bench_all.main()`` (its
   eight sections, lines also in ``chiprun_out/bench_all.jsonl``). Every
   line they print is printed again and must parse; no ``errors`` or
   ``error`` key and no null figure; mean relative Frobenius errors under
   0.12, ``fused_parity_dev_f64`` under 1e-6, ``headline_llr_statistic_f64``
   under 4, ``max_deviation_vs_oracle_f64`` at most 2.2e-15 x 10
   (``ORACLE_BAR``); config 1 mean MLE fidelity >= 0.99, config 3 mean
   |decay error| <= 0.02, QV heavy-output probability in [0.83, 0.87]
   ideal and [0.60, 0.72] noisy at depth 8 (both trajectory counts),
   config 4's diamond norms by the fused route; the APG, trajectory and
   ideal kernels must launch. The harness's throughputs are printed beside
   the earlier phases' figures for the same work (phases 5, 7, 14-16); a
   gap over 1.5x is printed as a finding, not a failure. Budget: 150 s.

Before it, one JSON line ``{"tomography": ...}`` holds phase 17's figures,
one ``{"protocols": ...}`` phase 18's, one ``{"slice13": ...}`` phase
19's, one ``{"examples": {name: {"s": ..., "launches": {...}}}}`` phase
20's, one ``{"notebooks": {name: {"s": ..., "launches": {...}}}}`` phase
21's, one ``{"entry": ...}`` phase 22's and one ``{"harness": ...}`` phase
23's (seconds, launches, clock gaps).
The second-to-last line is the per-kernel JSON record: ``launches`` from
the main paths; ``ms``/``plain_ms``: the kernel alone and the plain version
at the main path's size (APG: headline schedule); ``bound_ms``: the larger
of the operations over 67 TFLOP/s (f32 outside the tensor cores) and the
bytes of the function's own inputs, each read once, and its output, written
once, over 3.35 TB/s (not the layouts a wrapper derives from them);
``max_abs_err``: APG, the largest |kernel - plain f64| of the B = 16384
check; ideal, the largest |kernel - plain f32| at C = 1600, with ``ms`` and
``wrapper_ms`` from ``queued_ms`` and ``registers`` by depth; trajectory, the
same over the trajectories whose branch choices agree (column deviation
under 1e-4), with ``agree_share``, the share of trajectories that do, and
``max_abs_err_all``, the largest deviation over all of them; one-qubit APG,
the largest |kernel - plain f64| of the B = 16384 check, with the median
and 99th percentile over problems; CP projection, the largest
|kernel - eigh f64| at B = 16384, with ``library_ms`` the time of
``proj_choi_to_completely_positive``; both with ``registers`` and
``spill_bytes`` (stores, loads) from ptxas. The last line
is ``{"ok": true, ...}``. Exits non-zero,
printing no result, if CUDA is unavailable or any phase fails.
"""
import contextlib
import functools
import inspect
import io
import itertools
import json
import math
import pathlib
import re
import statistics
import sys
import time

import numpy as np
import torch

from forest_benchmarking_tpu_torch.bench import bound_ms, card as smi_card

SEED = 2024
BATCH = 16384
SHOTS = 2000
CHECK_BATCH = 256
TAIL_BATCH = 253       # not a multiple of PROBLEMS_PER_BLOCK_2Q
TAIL_BATCH_1Q = 261    # not a multiple of PROBLEMS_PER_BLOCK_1Q, nor of 8
TAIL_BATCH_CP = 259    # not a multiple of CP_PER_BLOCK
SCHEDULES = ("headline", "parity")
# a schedule with the JAX package's (outer, dykstra, sweeps, sweeps_rest)
# phase form and final_sweeps_rest, held to the same bar at B = 256
SPLIT_SCHEDULE = dict(phases=((4, 2, 1, 0), (3, 1, 1), (3, 3, 2, 1)),
                      init_iters=2, init_sweeps=3, final_iters=3,
                      final_sweeps=2, final_sweeps_rest=1, mu=1.5 / 32)
QV_DEPTH = 8
QV_CIRCUITS = 1600
QV_SHOTS = 1000
QV_TRAJ = 1000
QV_DEPOL = 0.02
QV_CHECK_C = 16        # circuits of the phase-6 check
QV_CHECKS = ((QV_DEPTH, 256), (QV_DEPTH - 1, 256), (QV_DEPTH, 500))
# the trajectory kernel's further checks, on a generator of their own:
# (depth, circuits, trajectories, Kraus operators; 16 = depolarizing)
QV_TRAJ_CHECKS = ((2, 16, 256, 16), (3, 16, 256, 16), (5, 16, 256, 16),
                  (9, 8, 128, 16), (10, 4, 64, 16), (QV_DEPTH, 16, 256, 1),
                  (QV_DEPTH, 16, 256, 32), (10, 4, 64, 32))
QV_TAIL = (5, 8, 10)   # depths of the bitwise check of a part-full block
ROUTE_BATCH = 256      # problems of each per-problem route in phase 11
CP_SWEEPS = 6
PROBLEMS_PER_BLOCK_2Q = 4   # PROBLEMS_2Q of csrc/apg_fused.cu
PROBLEMS_PER_BLOCK_1Q = 64  # PROBLEMS_1Q: one problem a quad of lanes
CP_PER_BLOCK = 8            # CP_PER_BLOCK: one matrix a warp
IDEAL_WARPS = 4             # IDEAL_WARPS of csrc/qv_traj.cu: warps a block
QUEUED = 100                # calls a sample of queued_ms times
SLEEP_CYCLES = 40_000_000   # the device sleep ahead of them (~20 ms)
STATE_BATCH = 262144   # config 1 (bench_all.py:57): 1Q states per dispatch
STATE_SHOTS = 2000     # shots per Pauli
MLE_TOL, MLE_MAXITER = 1e-7, 60
GENERAL_BATCH = 4096   # the 2Q general-route check of phase 14
GENERAL_TOL, GENERAL_MAXITER = 1e-7, 300
RB_BATCH = 65536       # config 3 (bench_all.py:131): decay curves
RB_DEPTHS = 8          # depths 2, 6, ..., 30
RB_SHOTS = 500
RB_ITERS = 50
RB_P0 = (0.5, 0.95, 0.5)
SCIPY_BATCH = 64       # curves held against scipy's curve_fit
SCIPY_ITERS = 300      # LM steps of that check: converged, not capped
DIST_BATCH = 1024      # config 4 (bench_all.py:176): channel pairs
DNORM_BATCH = 2048     # config 4: diamond norms
GOLD_PAIRS = 64        # pairs held against the f64 dense gold
DNORM_BAR = 1e-5       # the JAX package's on-chip bar (bench_all.py:182)
PROFILE_STEPS = (1, 9)  # Adam steps of phase 16's two fused-dnorm profiles
TOMO_DEPOL = 0.02        # two-qubit depolarizing probability on CZ
TOMO_READOUT = (0.98, 0.95)   # p(0|0), p(1|1): 2% 0->1, 5% 1->0
PROB_BAR = 1e-12         # card against CPU probabilities, complex128
PROCESS_FID_BAR = 0.85   # CPU: JAX 0.925-0.968 (8 seeds), port 0.893-0.971
STATE_FID_BAR = (0.95, 1.05)  # CPU: JAX 0.990-1.018, port 0.985-1.022
FUSED_PGDB_BAR = 1e-2    # relative Frobenius, fused against PGDB
# the dim = 4 kernel with one problem per block, B = 16384, headline /
# parity schedule (PERF.md, NVIDIA H100 80GB HBM3 at 700 W)
ONE_PER_BLOCK_MS = (64.658, 584.640)


def ideal_tail_circuits(depth: int) -> int:
    """A circuit count that leaves the ideal kernel's last block part empty
    and, where a warp holds several circuits (a group of 2^(depth-2) lanes a
    circuit below depth 7), its last warp's lane groups too."""
    per_warp = 32 >> (depth - 2) if depth < 7 else 1
    return IDEAL_WARPS * per_warp + per_warp + max(per_warp // 2, 1)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def tp_per_problem(est: torch.Tensor, dim: int) -> torch.Tensor:
    """(B,) max |Tr_out(E) - I| of each Choi matrix of the batch."""
    pt = torch.diagonal(est.reshape(-1, dim, dim, dim, dim), dim1=2,
                        dim2=4).sum(-1)
    return (pt - torch.eye(dim, device=est.device)).abs().amax(dim=(1, 2))


def tp_violation(est: torch.Tensor, dim: int = 4) -> float:
    """max |Tr_out(E) - I| over a (B, dim^2, dim^2) batch of Choi matrices."""
    return tp_per_problem(est, dim).max().item()


def rel_frobenius(est: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    return (torch.linalg.norm(est - truth, dim=(1, 2))
            / torch.linalg.norm(truth, dim=(1, 2)))


def cuda_ms(fn, reps: int = 3, warmup: bool = True):
    """(median milliseconds of ``fn()`` over ``reps`` runs after one warm-up
    (unless ``warmup`` is False), the last run's result)."""
    if warmup:
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def queued_ms(fn, launches: int = QUEUED, reps: int = 3):
    """(median milliseconds per call of ``fn()``, host milliseconds per
    call): each of ``reps`` samples enqueues ``launches`` calls behind a
    device sleep, so that the card runs them back to back and the host's
    time per call stays out of the device time; one warm-up."""
    fn()
    torch.cuda.synchronize()
    times, host = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for _ in range(launches):
            fn()
        host.append(1e3 * (time.perf_counter() - t0) / launches)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times), statistics.median(host)


def against_plain(lanes_apg, name, kern, in32, in64, n, cfg, plain32=None):
    """Hold the kernel's (B, 16, 16) result on counts ``n`` against the plain
    version's f32 and f64 solves from the same warm start; returns
    max |kernel - plain f64|."""
    if plain32 is None:
        rho0 = lanes_apg.linear_inversion_start(in32.a_pinv, n, 4)
        plain32 = torch.complex(*lanes_apg.apg_fused_reference(
            in32.ar, in32.ai, n, *rho0, dim=4, **cfg))
    n64 = n.double()
    rho0 = lanes_apg.linear_inversion_start(in64.a_pinv, n64, 4)
    plain64 = torch.complex(*lanes_apg.apg_fused_reference(
        in64.ar, in64.ai, n64, *rho0, dim=4, **cfg))
    torch.cuda.synchronize()
    dev_k = (kern.to(plain64.dtype) - plain64).abs().max().item()
    dev_p = (plain32.to(plain64.dtype) - plain64).abs().max().item()
    err = (kern - plain32).abs().max().item()
    tp = tp_violation(kern)
    print(f"check {name}: B={n.shape[0]} max|kernel-f64|={dev_k:.3e} "
          f"max|plain32-f64|={dev_p:.3e} (bar {2 * dev_p + 1e-5:.3e}) "
          f"max|kernel-plain32|={err:.3e} TP violation={tp:.3e}")
    check(bool(torch.isfinite(kern).all()), f"{name}: non-finite output")
    check(dev_k <= 2 * dev_p + 1e-5,
          f"{name}: kernel deviates from f64 by {dev_k:.3e} > "
          f"2 x {dev_p:.3e} + 1e-5")
    check(tp < 1e-5, f"{name}: kernel TP violation {tp:.3e}")
    return dev_k


QUANTILES = (0.5, 0.9, 0.99)


def check_tp_1q(name, est, plain32):
    """The TP bar at dim = 2: the 99th percentile under 1e-5, the largest
    under 1e-3, and at most 2 x + 2 as many problems over 1e-5 as the plain
    f32 solve has (which problems diverge differs between the two)."""
    tk, tp = tp_per_problem(est, 2), tp_per_problem(plain32, 2)
    q99 = torch.quantile(tk.double(), 0.99).item()
    over_k, over_p = int((tk > 1e-5).sum()), int((tp > 1e-5).sum())
    print(f"check {name}: TP violation q99 {q99:.3e} max "
          f"{tk.max().item():.3e} (plain32 max {tp.max().item():.3e}), "
          f"{over_k} of {tk.numel()} problems over 1e-5 (plain32 {over_p})")
    check(q99 < 1e-5, f"{name}: TP violation q99 {q99:.3e}")
    check(tk.max().item() < 1e-3, f"{name}: TP violation {tk.max().item()}")
    check(over_k <= 2 * over_p + 2, f"{name}: {over_k} problems over 1e-5 "
          f"against the plain f32 solve's {over_p}")


def against_plain_1q(kern, plain32, plain64):
    """Hold the dim = 2 kernel's (B, 4, 4) result against the plain f32 and
    f64 solves of the same counts and warm start, at the median and 90th
    percentile of the per-problem max deviation from f64, and its TP
    violation by :func:`check_tp_1q`; returns (max |kernel - plain f64|,
    its median, its 99th percentile)."""
    def per_problem(x):
        return (x.to(plain64.dtype) - plain64).abs().amax(dim=(1, 2))

    dk, dp = per_problem(kern), per_problem(plain32)
    q = torch.tensor(QUANTILES, dtype=dk.dtype, device=dk.device)
    qk, qp = torch.quantile(dk, q).tolist(), torch.quantile(dp, q).tolist()
    print(f"check apg_fused_1q: B={kern.shape[0]} kernel-f64 q50/q90/q99/max "
          + "/".join(f"{x:.3e}" for x in (*qk, dk.max().item()))
          + " plain32-f64 "
          + "/".join(f"{x:.3e}" for x in (*qp, dp.max().item())))
    check(bool(torch.isfinite(kern).all()), "apg_fused_1q: non-finite output")
    for level, k, p in list(zip(QUANTILES, qk, qp))[:2]:
        check(k <= 2 * p + 1e-5, f"apg_fused_1q: kernel deviates from f64 by "
              f"{k:.3e} > 2 x {p:.3e} + 1e-5 at quantile {level}")
    check_tp_1q("apg_fused_1q", kern, plain32)
    return dk.max().item(), qk[0], qk[2]


def plain_1q(lanes_apg, in_1q, n, dtype):
    """The plain dim = 2 solve of counts ``n`` (default schedule) on the
    card in ``dtype``, from its own warm start."""
    inp = in_1q[dtype]
    rho0 = lanes_apg.linear_inversion_start(inp.a_pinv, n.to(dtype), 2)
    return torch.complex(*lanes_apg.apg_fused_reference(
        inp.ar, inp.ai, n.to(dtype), *rho0, dim=2))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@contextlib.contextmanager
def counting_calls(owner, name: str):
    """Count the calls of ``owner.name`` in the block; yields a one-element
    list that holds the count."""
    count, real = [0], getattr(owner, name)

    def counted(*args, **kwargs):
        count[0] += 1
        return real(*args, **kwargs)

    setattr(owner, name, counted)
    try:
        yield count
    finally:
        setattr(owner, name, real)


def print_top(top) -> None:
    """One line for each of the top device kernels of a profile."""
    for ev in top:
        print(f"  device {ev.self_device_time_total / 1e3:9.3f} ms "
              f"x{ev.count:<6d} {ev.key[:64]}")


@contextlib.contextmanager
def plain_versions(pallas_traj):
    """Run the quantum-volume entry points with the kernels' plain versions
    in their place (the module attributes the entry points call)."""
    saved = pallas_traj.ideal_probs, pallas_traj.traj_probs
    pallas_traj.ideal_probs = pallas_traj.ideal_probs_reference
    pallas_traj.traj_probs = pallas_traj.traj_probs_reference
    try:
        yield
    finally:
        pallas_traj.ideal_probs, pallas_traj.traj_probs = saved


def qv_inputs(quantum_volume, haar_rand_unitary, gen, depth, circuits,
              n_traj):
    """Circuits and uniforms drawn on the card in the entry point's order."""
    perms = quantum_volume._sample_perms(gen, circuits, depth)
    gates = haar_rand_unitary(gen, 4, batch=(circuits, depth, depth // 2),
                              dtype=torch.float32)
    uniforms = torch.rand((circuits, depth, depth // 2, n_traj),
                          generator=gen, device=gen.device)
    return perms, gates, uniforms


def random_kraus(haar_rand_unitary, gen, n_kraus: int) -> torch.Tensor:
    """A random CPTP stack of ``n_kraus`` 4x4 operators: the blocks of the
    first four columns of a Haar unitary of side 4K."""
    u = haar_rand_unitary(gen, 4 * n_kraus, dtype=torch.float32)
    return u[:, :4].reshape(n_kraus, 4, 4).contiguous()


def depth_ptxas(log: str, kernel: str) -> dict:
    """{depth: (registers, spill stores, spill loads, stack bytes)} of the
    depth instantiations of ``kernel`` in a ``-Xptxas -v`` build log."""
    out, depth, props = {}, None, (0, 0, 0)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(rf"{kernel}ILi(\d+)E", line)
            depth = int(m.group(1)) if m else None
        elif depth is not None and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            props = (nums[1], nums[2], nums[0])
        elif depth is not None and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out[depth] = (regs, *props)
            depth = None
    return dict(sorted(out.items()))


def kernel_ptxas(log: str, name: str):
    """(registers, spill stores, spill loads) of the first instantiation of
    the kernel ``name`` in a ``-Xptxas -v`` build log."""
    found, spill = False, None
    for line in log.splitlines():
        found = found or ("Compiling entry function" in line and name in line)
        if found and "spill stores" in line:
            spill = [int(x) for x in re.findall(r"(\d+) bytes", line)]
        elif found and spill and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            return regs, spill[1], spill[2]
    raise SmokeFailure(f"no ptxas report for {name}")


def check_ideal(pallas_traj, perms, gates, depth: int) -> torch.Tensor:
    """The ideal kernel's result, held within 2e-6 of the plain f32 version
    and 1e-5 of the plain f64 version on the same circuits."""
    kern = pallas_traj.ideal_probs_kernel(perms, gates, depth)
    plain32 = pallas_traj.ideal_probs_reference(perms, gates, depth)
    plain64 = pallas_traj.ideal_probs_reference(
        perms, gates.to(torch.complex128), depth)
    torch.cuda.synchronize()
    e32 = (kern - plain32).abs().max().item()
    e64 = (kern.double() - plain64).abs().max().item()
    print(f"check ideal_probs: depth {depth} C={perms.shape[0]} "
          f"max|kernel-plain32|={e32:.3e} max|kernel-plain64|={e64:.3e}")
    check(e32 <= 2e-6 and e64 <= 1e-5, f"ideal_probs depth {depth} "
          f"C={perms.shape[0]}: {e32:.3e} / {e64:.3e}")
    return kern


def traj_agreement(kern: torch.Tensor, plain: torch.Tensor):
    """(share of trajectories within 1e-4 of the plain version, the largest
    deviation over those, the largest over all, the largest column-sum error
    of the kernel)."""
    col = (kern - plain).abs().amax(dim=1)
    agree = col < 1e-4
    return (agree.float().mean().item(),
            col[agree].max().item() if bool(agree.any()) else float("nan"),
            col.max().item(), (kern.sum(1) - 1).abs().max().item())


def host_ms(fn, reps: int = 3) -> float:
    """Median host milliseconds of ``fn()`` through a synchronize, over
    ``reps`` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def profiled(fn):
    """(device kernel launches, device busy ms, stream/device
    synchronizations, the top device kernels, fn's result) of one ``fn()``
    under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    gpu = sorted((e for e in ev
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.self_device_time_total, reverse=True)
    return (sum(e.count for e in gpu),
            sum(e.self_device_time_total for e in gpu) / 1e3,
            sum(e.count for e in ev if "Synchronize" in e.key), gpu[:4], out)


def port_launches():
    """The launch counters of the port's hand-written kernels."""
    from forest_benchmarking_tpu_torch.ops import (
        lanes_apg, pallas_eigh, pallas_traj)
    return (lanes_apg.apg_fused, pallas_eigh.cp_project_pallas,
            pallas_traj.ideal_probs, pallas_traj.traj_probs)


def phase_state_tomography(card: str, dev: torch.device) -> float:
    """14. BASELINE config 1 at bench_all.py:57's size; see the module
    docstring. Returns the f32 call's CUDA-event milliseconds."""
    t_phase = time.perf_counter()
    from forest_benchmarking_tpu_torch import tomography
    from forest_benchmarking_tpu_torch.utils import pauli_basis_matrices
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    z = torch.randn((STATE_BATCH, 2, 2), generator=g, device=dev)
    psi = torch.complex(z[..., 0], z[..., 1])
    psi = psi / torch.linalg.vector_norm(psi, dim=-1, keepdim=True)
    ab = psi[:, 0].conj() * psi[:, 1]
    r_true = torch.stack([2 * ab.real, 2 * ab.imag,
                          psi[:, 0].abs() ** 2 - psi[:, 1].abs() ** 2], -1)
    e = 2 * torch.binomial(torch.full_like(r_true, STATE_SHOTS),
                           (1 + r_true) / 2, generator=g) / STATE_SHOTS - 1
    obs = pauli_basis_matrices(1)[1:]

    def estimate(e, r_true):
        """Linear inversion (r = e for X, Y, Z) and the diluted MLE, with
        each problem's fidelity against its true state."""
        nm = torch.full(e.shape[:1], 3.0 * STATE_SHOTS, dtype=e.dtype,
                        device=e.device)
        r = tomography.iterative_mle_state_estimate_batched(
            obs, e, nm, tol=MLE_TOL, maxiter=MLE_MAXITER, warm_start=True,
            representation="bloch")
        return ((1 + (e * r_true).sum(-1)) / 2,
                (1 + (r * r_true).sum(-1)) / 2, r)

    counters = port_launches()
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    f_lin, f_mle, r32 = estimate(e, r_true)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    hand = [c.launches for c in counters]
    f_lin64, f_mle64, r64 = estimate(e.double(), r_true.double())
    dr = (r32.double() - r64).abs().amax(-1)
    q = torch.quantile(dr, torch.tensor([0.5, 0.99], dtype=dr.dtype,
                                        device=dev)).tolist()
    means = [x.double().mean().item() for x in (f_lin, f_mle, f_lin64,
                                                 f_mle64)]
    print(f"main path state tomography: B={STATE_BATCH} shots={STATE_SHOTS} "
          f"maxiter={MLE_MAXITER} tol={MLE_TOL} f32 host clock {wall:.3f} ms "
          f"(first call); hand-kernel launches {hand} (the path runs none); "
          f"mean fidelity linear inversion {means[0]:.6f} (f64 "
          f"{means[2]:.6f}), MLE {means[1]:.6f} (f64 {means[3]:.6f}); "
          f"|r32 - r64| median {q[0]:.3e} q99 {q[1]:.3e} max "
          f"{dr.max().item():.3e}")
    check(f_lin.shape == f_mle.shape == (STATE_BATCH,) and all(
        bool(torch.isfinite(x).all()) for x in (f_lin, f_mle, r32)),
          "state tomography: output not finite or of the wrong shape")
    check(abs(means[1] - means[3]) <= 1e-4,
          f"state tomography: f32 mean MLE fidelity {means[1]} against f64 "
          f"{means[3]}")
    check(means[0] >= 0.999 and means[1] >= 0.99,
          f"state tomography: mean fidelities {means[0]} / {means[1]}")
    check(sum(hand) == 0, f"state tomography launched hand kernels {hand}")
    steps = tomography._mle_bloch_kernel(e, 0.1, MLE_TOL, MLE_MAXITER,
                                         True)[1]
    ms_by = {}
    for name, ee, rt in (("f32", e, r_true),
                         ("f64", e.double(), r_true.double())):
        ms, _ = cuda_ms(lambda: estimate(ee, rt))
        ms_by[name] = ms
        host = host_ms(lambda: estimate(ee, rt))
        flops = (tomography.mle_bloch_flops_per_solve(steps)
                 + 2 * 3 * 2) * STATE_BATCH
        bound = bound_ms(flops, nbytes(ee, rt) + 2 * STATE_BATCH
                         * ee.element_size())
        launches, busy, syncs, top, _ = profiled(lambda: estimate(ee, rt))
        print(f"timing state tomography {name}: B={STATE_BATCH} {steps} "
              f"Bloch steps; CUDA events {ms:.3f} ms, host clock {host:.3f} "
              f"ms, {STATE_BATCH / (ms / 1e3):.0f} solves/s; "
              f"mle_bloch_flops_per_solve({steps}) = "
              f"{tomography.mle_bloch_flops_per_solve(steps)}; bound "
              f"{bound[0]:.4f} ms ({bound[1]}), {100 * bound[0] / ms:.3f}% "
              f"of it; profiled: {launches} device launches, busy "
              f"{busy:.3f} ms, {syncs} synchronizations on {card}")
        print_top(top)

    # the general route: 2Q, all 15 traceless Paulis, warm start
    z = torch.randn((GENERAL_BATCH, 4, 2), generator=g, device=dev,
                    dtype=torch.float64)
    psi = torch.complex(z[..., 0], z[..., 1])
    psi = psi / torch.linalg.vector_norm(psi, dim=-1, keepdim=True)
    obs2 = torch.tensor(pauli_basis_matrices(2)[1:], device=dev)
    exact = torch.einsum("sij,bj,bi->bs", obs2, psi, psi.conj()).real
    e2 = 2 * torch.binomial(torch.full_like(exact, STATE_SHOTS),
                            (1 + exact) / 2, generator=g) / STATE_SHOTS - 1
    nm2 = torch.full((GENERAL_BATCH,), 15.0 * STATE_SHOTS, device=dev,
                     dtype=torch.float64)
    fid = {}
    for cdtype, rdtype in ((torch.complex64, torch.float32),
                           (torch.complex128, torch.float64)):
        ob, ee = obs2.to(cdtype), e2.to(rdtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rho = tomography.iterative_mle_state_estimate_batched(
            ob, ee, nm2, tol=GENERAL_TOL, maxiter=GENERAL_MAXITER,
            warm_start=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fid[cdtype] = torch.einsum("bi,bij,bj->b", psi.conj().to(cdtype), rho,
                                   psi.to(cdtype)).real.double()
        _, its = tomography._mle_general_batched(
            ob, ee, nm2, 0.1, 0.0, 0.0, GENERAL_TOL, GENERAL_MAXITER, True)
        print(f"general route {cdtype}: 2Q B={GENERAL_BATCH} warm start "
              f"tol={GENERAL_TOL} maxiter={GENERAL_MAXITER}: host clock "
              f"{wall:.3f} s; iterations max {its.max().item()} mean "
              f"{its.float().mean().item():.1f}; mean fidelity "
              f"{fid[cdtype].mean().item():.6f}")
        check(bool(torch.isfinite(rho).all()), "general route: not finite")
    # one profiled call (complex64): a profile of ~50 k launches takes
    # tens of seconds to gather
    launches, busy, syncs, top, _ = profiled(
        lambda: tomography.iterative_mle_state_estimate_batched(
            obs2.to(torch.complex64), e2.float(), nm2, tol=GENERAL_TOL,
            maxiter=GENERAL_MAXITER, warm_start=True))
    print(f"profile general route complex64: {launches} device launches, "
          f"busy {busy:.3f} ms, {syncs} synchronizations")
    print_top(top)
    gap = abs(fid[torch.complex64].mean() - fid[torch.complex128].mean())
    check(gap.item() <= 1e-4, f"general route: f32 mean fidelity "
          f"{gap.item():.3e} from f64")
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    return ms_by["f32"]


def phase_rb_fits(card: str, dev: torch.device) -> float:
    """15. BASELINE config 3 at bench_all.py:131's size; see the module
    docstring. Returns the f32 fit's CUDA-event milliseconds."""
    t_phase = time.perf_counter()
    from scipy.optimize import curve_fit
    from forest_benchmarking_tpu_torch import randomized_benchmarking as rb
    from forest_benchmarking_tpu_torch.analysis import fitting
    from forest_benchmarking_tpu_torch.ops.calculational import pinv
    from forest_benchmarking_tpu_torch.ops.random_operators import (
        haar_rand_unitary)
    g = torch.Generator(device=dev).manual_seed(SEED + 15)
    depths = torch.arange(2, 2 + 4 * RB_DEPTHS, 4, dtype=torch.float64,
                          device=dev)
    decays = 0.9 + 0.095 * torch.rand(RB_BATCH, generator=g, device=dev,
                                      dtype=torch.float64)
    surv = 0.5 + 0.5 * decays[:, None] ** depths
    y = torch.binomial(torch.full_like(surv, RB_SHOTS), surv,
                       generator=g) / RB_SHOTS

    def fit(dtype, iters=RB_ITERS, rows=slice(None)):
        return fitting.fit_model_batched(
            fitting._base_param_decay_p, depths.to(dtype), y[rows].to(dtype),
            None, RB_P0, num_iters=iters)

    counters = port_launches()
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    p32, chi32, cov32 = fit(torch.float32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hand = [c.launches for c in counters]
    p64, _, _ = fit(torch.float64)
    err32 = (p32[:, 1].double() - decays).abs()
    err64 = (p64[:, 1] - decays).abs()
    print(f"main path RB fits: B={RB_BATCH} depths {depths.tolist()} "
          f"shots={RB_SHOTS} num_iters={RB_ITERS} f32 host clock {wall:.3f} "
          f"s (first call); hand-kernel launches {hand} (the path runs "
          f"none); mean |decay error| f32 {err32.mean().item():.6f} f64 "
          f"{err64.mean().item():.6f} (max {err32.max().item():.5f} / "
          f"{err64.max().item():.5f})")
    check(all(bool(torch.isfinite(x).all()) for x in (p32, chi32, cov32))
          and p32.shape == (RB_BATCH, 3) and cov32.shape == (RB_BATCH, 3, 3),
          "RB fits: output not finite or of the wrong shape")
    check(abs(err32.mean() - err64.mean()).item() <= 1e-4,
          "RB fits: f32 mean |decay error| off the f64 one")
    check(err32.mean().item() <= 0.02, f"RB fits: mean |decay error| "
          f"{err32.mean().item()}")
    check(sum(hand) == 0, f"RB fits launched hand kernels {hand}")
    ms_by = {}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        ms, _ = cuda_ms(lambda: fit(dtype))
        ms_by[name] = ms
        host = host_ms(lambda: fit(dtype), reps=1)
        flops = fitting.lm_flops_per_fit(RB_DEPTHS, 3, RB_ITERS) * RB_BATCH
        size = torch.empty((), dtype=dtype).element_size()
        bound = bound_ms(flops, size * (RB_DEPTHS + 3 + RB_BATCH
                                        * (RB_DEPTHS + 3 + 1 + 9)))
        launches, busy, syncs, top, _ = profiled(lambda: fit(dtype))
        print(f"timing RB fits {name}: B={RB_BATCH} CUDA events {ms:.3f} "
              f"ms, host clock {host:.3f} ms, {RB_BATCH / (ms / 1e3):.0f} "
              f"fits/s; lm_flops_per_fit({RB_DEPTHS}, 3, {RB_ITERS}) = "
              f"{fitting.lm_flops_per_fit(RB_DEPTHS, 3, RB_ITERS)}; bound "
              f"{bound[0]:.4f} ms ({bound[1]}), {100 * bound[0] / ms:.3f}% "
              f"of it; profiled: {launches} device launches, busy "
              f"{busy:.3f} ms, {syncs} synchronizations on {card}")
        print_top(top)
    # the final covariance's pseudo-inverse alone, on J^T J of that size
    jtj = torch.linalg.inv(cov32.double()).float().contiguous()
    ms_pinv, _ = cuda_ms(lambda: pinv(jtj))
    launches, busy, _, top, _ = profiled(lambda: pinv(jtj))
    ms_svd, _ = cuda_ms(lambda: torch.linalg.svd(jtj))
    print(f"timing pinv covariance f32 (B={RB_BATCH}, 3x3): CUDA events "
          f"{ms_pinv:.3f} ms (torch.linalg.svd alone {ms_svd:.3f} ms); "
          f"{launches} device launches, busy {busy:.3f} ms"
          + "".join(f"; {ev.key[:40]} {ev.self_device_time_total / 1e3:.3f} "
                    f"ms x{ev.count}" for ev in top))

    # the first curves in float64 against scipy's curve_fit
    p_sc, _, _ = fit(torch.float64, iters=SCIPY_ITERS,
                     rows=slice(0, SCIPY_BATCH))
    x_np, y_np = depths.cpu().numpy(), y[:SCIPY_BATCH].cpu().numpy()
    ours = p_sc.cpu().numpy()

    def model(x, a, d, b):
        return b + a * d ** x

    close = lower = no_minimum = 0
    worst = 0.0
    for i in range(SCIPY_BATCH):
        try:
            popt, _ = curve_fit(model, x_np, y_np[i], p0=list(RB_P0))
        except RuntimeError:
            # scipy finds no minimum (a decay running to 1 with amplitude
            # and baseline growing without bound)
            no_minimum += 1
            check(bool(np.isfinite(ours[i]).all()), f"scipy check: curve {i}")
            continue
        dev_i = np.abs(popt - ours[i]).max()
        if dev_i <= 1e-5:
            close += 1
            worst = max(worst, dev_i)
            continue
        cost_ours = ((model(x_np, *ours[i]) - y_np[i]) ** 2).sum()
        cost_sc = ((model(x_np, *popt) - y_np[i]) ** 2).sum()
        check(cost_ours <= cost_sc * (1 + 1e-9),
              f"scipy check: curve {i} {dev_i:.3e} from scipy at cost "
              f"{cost_ours:.12e} against scipy's {cost_sc:.12e}")
        lower += 1
        print(f"  scipy check: curve {i}: {dev_i:.3e} from scipy's "
              f"{popt.round(5).tolist()}, ours {ours[i].round(5).tolist()} "
              f"at cost {cost_ours:.12e} <= scipy's {cost_sc:.12e}")
    print(f"scipy check f64 (num_iters={SCIPY_ITERS}): {close} of "
          f"{SCIPY_BATCH} curves "
          f"within 1e-5 of curve_fit on every parameter (largest "
          f"{worst:.3e}); {lower} in a flat valley at a cost no higher than "
          f"scipy's; {no_minimum} where scipy finds no minimum")

    # the RB simulator: random 1Q sequences that compose to the identity
    rb_depths = [d for d in (2, 6, 10, 16) for _ in range(8)]
    us = haar_rand_unitary(torch.Generator(device=dev).manual_seed(SEED + 16),
                           2, batch=(len(rb_depths), max(rb_depths))
                           ).cpu().numpy()
    ptms = np.tile(np.eye(4), (len(rb_depths), max(rb_depths), 1, 1))
    for i, depth in enumerate(rb_depths):
        total = np.eye(2)
        for j in range(depth - 1):
            ptms[i, j] = rb.unitary_to_ptm_np(us[i, j])
            total = us[i, j] @ total
        ptms[i, depth - 1] = rb.unitary_to_ptm_np(total.conj().T)
    noise = np.diag([1.0, 0.9, 0.9, 0.9])
    ideal = rb.simulate_rb_survival_batched(ptms, lengths=rb_depths)
    exact = rb.simulate_rb_survival_batched(ptms, noise, lengths=rb_depths)
    want = 0.5 + 0.5 * 0.9 ** torch.tensor(rb_depths, dtype=torch.float64,
                                           device=exact.device)
    sampled = rb.simulate_rb_survival_batched(
        ptms, noise, torch.Generator(device=dev).manual_seed(SEED + 17),
        num_shots=5000, lengths=rb_depths)
    decay = rb.fit_rb_results(rb_depths, [[2 * s - 1] for s in
                                          sampled.tolist()],
                              [[0.01]] * len(rb_depths)).params["decay"].value
    dev_ideal = (ideal - 1).abs().max().item()
    dev_exact = (exact - want).abs().max().item()
    print(f"RB simulator on {ideal.device}: noiseless max |survival - 1| "
          f"{dev_ideal:.3e}; depolarizing max |survival - (1 + 0.9^L)/2| "
          f"{dev_exact:.3e}; 5000 shots, fit_rb_results decay {decay:.5f} "
          f"(0.9)")
    check(ideal.device.type == "cuda", "RB simulator: not on the card")
    check(dev_ideal <= 1e-10 and dev_exact <= 1e-10,
          f"RB simulator: {dev_ideal:.3e} / {dev_exact:.3e}")
    check(abs(decay - 0.9) < 0.02, f"RB simulator: decay {decay}")
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
    return ms_by["f32"]


def phase_distances(card: str, dev: torch.device) -> dict:
    """16. BASELINE config 4 at bench_all.py:176's size; see the module
    docstring. Returns the CUDA-event milliseconds of the f32 distance step
    (``"distance_ms"``) and of the fused diamond norm (``"dnorm_ms"``)."""
    t_phase = time.perf_counter()
    from forest_benchmarking_tpu_torch import distance_measures as dm
    from forest_benchmarking_tpu_torch.ops import lanes_dnorm
    from forest_benchmarking_tpu_torch.ops.random_operators import (
        rand_map_with_BCSZ_dist)
    from forest_benchmarking_tpu_torch.ops.superoperator_transformations \
        import choi2pauli_liouville, kraus2choi
    g = torch.Generator(device=dev).manual_seed(SEED + 18)

    def draw(batch, dtype=torch.float64):
        return [rand_map_with_BCSZ_dist(g, 4, 16, batch=(batch,), dtype=dtype)
                for _ in range(2)]

    dist64, dnorm64 = draw(DIST_BATCH), draw(DNORM_BATCH)
    dist32 = [c.to(torch.complex64) for c in dist64]
    dnorm32 = [c.to(torch.complex64) for c in dnorm64]

    def step(c0, c1):
        pf = dm.process_fidelity(choi2pauli_liouville(c0),
                                 choi2pauli_liouville(c1))
        return pf, dm.trace_distance(c0 / 4, c1 / 4)

    # the main path: the distance step and the diamond norms in f32
    counters = port_launches()
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    with counting_calls(lanes_dnorm, "dnorm_planes") as fused_calls:
        pf32, td32 = step(*dist32)
        t0 = time.perf_counter()
        dn32 = dm.diamond_norm_distance(*dnorm32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    hand = [c.launches for c in counters]
    pf64, td64 = step(*dist64)
    err_pf = (pf32.double() - pf64).abs().max().item()
    err_td = (td32.double() - td64).abs().max().item()
    print(f"main path config 4: distance step B={DIST_BATCH}: mean process "
          f"fidelity {pf64.mean().item():.6f}, mean trace distance "
          f"{td64.mean().item():.6f}; f32 against f64 on the card: process "
          f"fidelity {err_pf:.3e}, trace distance {err_td:.3e}; diamond "
          f"norm B={DNORM_BATCH} (method auto, f32): {fused_calls[0]} fused "
          f"call(s), host clock {wall:.3f} s (first call), mean "
          f"{dn32.double().mean().item():.6f}; hand-kernel launches {hand} "
          f"(the path runs none) on {card}")
    check(pf32.shape == td32.shape == (DIST_BATCH,)
          and dn32.shape == (DNORM_BATCH,)
          and all(bool(torch.isfinite(x).all()) for x in (pf32, td32, dn32)),
          "config 4: output not finite or of the wrong shape")
    check(err_pf <= 1e-5 and err_td <= 1e-5,
          f"config 4: f32 distance step {err_pf:.3e} / {err_td:.3e} from f64")
    check(fused_calls[0] == 1, f"diamond norm: {fused_calls[0]} fused calls, "
          "want 1 (method auto on the card)")
    check(sum(hand) == 0, f"config 4 launched hand kernels {hand}")

    ms_by = {}
    for name, pair in (("f32", dist32), ("f64", dist64)):
        ms, _ = cuda_ms(lambda: step(*pair))
        ms_by[name] = ms
        host = host_ms(lambda: step(*pair))
        launches, busy, syncs, top, _ = profiled(lambda: step(*pair))
        print(f"timing distance step {name}: B={DIST_BATCH} CUDA events "
              f"{ms:.3f} ms, {DIST_BATCH / (ms / 1e3):.0f} pairs/s, host "
              f"clock {host:.3f} ms; profiled: {launches} device launches, "
              f"busy {busy:.3f} ms, {syncs} synchronizations on {card}")
        print_top(top)
    ms_gen, _ = cuda_ms(lambda: step(*draw(DIST_BATCH, torch.float32)))
    print(f"timing distance step f32 with the generation of its channels: "
          f"B={DIST_BATCH} CUDA events {ms_gen:.3f} ms, "
          f"{DIST_BATCH / (ms_gen / 1e3):.0f} pairs/s on {card}")

    ms_f, _ = cuda_ms(lambda: dm.diamond_norm_distance(*dnorm32))
    host_f = host_ms(lambda: dm.diamond_norm_distance(*dnorm32), reps=1)
    # a profile of the whole call gathers ~236 k launches and took most of
    # the phase; the schedule is fixed, so profile it at PROFILE_STEPS Adam
    # steps and scale the difference (the steps' share) to the call's
    steps_f = inspect.signature(dm.diamond_norm_distance).parameters[
        "fused_iters"].default
    (l_lo, b_lo, s_lo, _, _), (l_hi, b_hi, s_hi, top, _) = (
        profiled(lambda: dm.diamond_norm_distance(*dnorm32, fused_iters=k))
        for k in PROFILE_STEPS)
    scale = (steps_f - PROFILE_STEPS[0]) / (PROFILE_STEPS[1]
                                            - PROFILE_STEPS[0])
    launches = round(l_lo + scale * (l_hi - l_lo))
    busy = b_lo + scale * (b_hi - b_lo)
    syncs = round(s_lo + scale * (s_hi - s_lo))
    flops = lanes_dnorm.dnorm_flops_per_problem(4)
    bound = bound_ms(DNORM_BATCH * flops, nbytes(*dnorm32)
                     + DNORM_BATCH * dn32.element_size())
    print(f"timing diamond norm fused f32: B={DNORM_BATCH} CUDA events "
          f"{ms_f:.3f} ms, {DNORM_BATCH / (ms_f / 1e3):.0f} dnorms/s, host "
          f"clock {host_f:.3f} ms; profiled at {PROFILE_STEPS[0]} and "
          f"{PROFILE_STEPS[1]} Adam steps ({l_lo} / {l_hi} device launches, "
          f"busy {b_lo:.3f} / {b_hi:.3f} ms, {s_lo} / {s_hi} "
          f"synchronizations), scaled to {steps_f}: {launches} device "
          f"launches, busy {busy:.3f} ms ({100 * busy / ms_f:.1f}% of the "
          f"call), {syncs} synchronizations; dnorm_flops_per_problem(4) = "
          f"{flops:.0f}; bound {bound[0]:.4f} ms ({bound[1]}), "
          f"{100 * bound[0] / ms_f:.4f}% of it on {card}")
    print_top(top)
    j32 = 0.5 * ((dnorm32[0] - dnorm32[1])
                 + (dnorm32[0] - dnorm32[1]).mH)
    steps = dm._dnorm_dense(j32, 200, 1, 7, True, 3e-7, 24, 50.0)[1]
    ms_d, dense32 = cuda_ms(
        lambda: dm.diamond_norm_distance(*dnorm32, method="dense"), reps=1)
    launches, busy, syncs, _, _ = profiled(
        lambda: dm.diamond_norm_distance(*dnorm32, method="dense"))
    print(f"timing diamond norm dense f32: B={DNORM_BATCH} {steps} Adam "
          f"steps; CUDA events {ms_d:.3f} ms, "
          f"{DNORM_BATCH / (ms_d / 1e3):.0f} dnorms/s; profiled: {launches} "
          f"device launches, busy {busy:.3f} ms, {syncs} synchronizations; "
          f"max |dense - fused| {(dense32 - dn32).abs().max().item():.3e} on "
          f"{card}")

    gold = dm.diamond_norm_distance(
        dnorm64[0][:GOLD_PAIRS], dnorm64[1][:GOLD_PAIRS], method="dense",
        num_iters=800, stop_tol=0.0, num_restarts=2)
    err = (dn32[:GOLD_PAIRS].double() - gold).abs()
    print(f"diamond norm accuracy: first {GOLD_PAIRS} pairs, fused f32 "
          f"against the f64 dense gold (800 steps, two restarts) on the "
          f"card: max {err.max().item():.3e}, mean {err.mean().item():.3e}")
    check(err.max().item() <= DNORM_BAR,
          f"diamond norm: fused f32 {err.max().item():.3e} from the f64 gold")

    c = torch.complex64
    eye = kraus2choi(torch.eye(2, dtype=c, device=dev)[None])
    x = kraus2choi(torch.tensor([[0, 1], [1, 0]], dtype=c, device=dev)[None])
    ps = torch.tensor([0.1, 0.3, 0.7], device=dev)
    depol = ((1 - ps[:, None, None]) * eye
             + ps[:, None, None] * torch.eye(4, dtype=c, device=dev) / 2)
    with counting_calls(lanes_dnorm, "dnorm_planes") as fused_calls:
        ix = dm.diamond_norm_distance(eye, x).item()
        dep = dm.diamond_norm_distance(depol, eye.expand(3, 4, 4))
        self1 = dm.diamond_norm_distance(depol, depol)
        self2 = dm.diamond_norm_distance(dnorm32[0][:8], dnorm32[0][:8])
    dep_err = (dep - 1.5 * ps).abs().max().item()
    self_max = max(self1.abs().max().item(), self2.abs().max().item())
    print(f"diamond norm analytic, f32 on the card (fused): dnorm(I, X) = "
          f"{ix:.7f}; depolarizing max |dnorm - 1.5 p| {dep_err:.3e}; "
          f"self-distance max {self_max:.3e}")
    check(fused_calls[0] == 4, f"analytic cases: {fused_calls[0]} fused "
          "calls, want 4")
    check(abs(ix - 2.0) <= DNORM_BAR and dep_err <= DNORM_BAR,
          f"diamond norm analytic: I/X {ix}, depolarizing {dep_err:.3e}")
    check(bool(torch.isfinite(self1).all() and torch.isfinite(self2).all())
          and self_max <= DNORM_BAR, f"diamond norm self-distance {self_max}")
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s")
    return {"distance_ms": ms_by["f32"], "dnorm_ms": ms_f}


def noisy_cz(circuits, noise, pair):
    """CZ on ``pair`` with two-qubit depolarizing noise attached to it and
    the per-qubit readout confusion of phase 17."""
    p = TOMO_DEPOL
    kraus = noise.pauli_kraus_map([1 - 15 * p / 16] + [p / 16] * 15)
    prog = circuits.Circuit([circuits.CZ(*pair)])
    prog.define_noisy_gate("CZ", list(pair), kraus)
    for q in pair:
        prog.define_noisy_readout(q, *TOMO_READOUT)
    return prog, kraus


@contextlib.contextmanager
def module_clock(module, stages):
    """Host seconds by stage of the functions of ``module`` named in
    ``stages`` (name -> stage), each through a synchronize, for the block;
    results that are iterators are listed."""
    clock = {}
    saved = {}

    def wrap(real, stage):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            if hasattr(out, "__next__"):
                out = list(out)
            torch.cuda.synchronize()
            clock[stage] = clock.get(stage, 0.0) + time.perf_counter() - t0
            return out
        return run

    for name, stage in stages.items():
        saved[name] = getattr(module, name)
        setattr(module, name, wrap(saved[name], stage))
    try:
        yield clock
    finally:
        for name, real in saved.items():
            setattr(module, name, real)


# the stages of do_tomography: the module functions it calls
TOMO_STAGES = {"estimate_observables": "acquisition",
               "calibrate_observable_estimates": "calibration",
               "pgdb_process_estimate": "estimation",
               "iterative_mle_state_estimate": "estimation"}


def tomography_run(name, card, tomography, qvm, prog, qubits, kind):
    """``do_tomography`` at its defaults on the card, timed by stage, then
    once more under ``torch.profiler``: the whole call for a process, the
    acquisition and calibration for a state (its diluted MLE runs up to
    10,000 steps, one synchronization each, too many launches to gather in
    a profile here; its steps are counted instead). Returns (estimate,
    experiment, results, record)."""
    steps = []
    real_mle = tomography._mle_general_batched

    def counted_mle(*args, **kwargs):
        out = real_mle(*args, **kwargs)
        steps.append(int(out[1].max()))
        return out

    tomography._mle_general_batched = counted_mle
    try:
        with module_clock(tomography, TOMO_STAGES) as clock:
            t0 = time.perf_counter()
            est, expt, results = tomography.do_tomography(qvm, prog, qubits,
                                                          kind)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        tomography._mle_general_batched = real_mle
    n_cal = len({r.setting.observable.operations_as_set() for r in results})
    circuits = len(expt) + n_cal

    def acquire():
        res = list(tomography.estimate_observables(qvm, expt, num_shots=1000,
                                                   symm_type=-1))
        return list(tomography.calibrate_observable_estimates(
            qvm, res, num_shots=1000, symm_type=-1, noisy_program=prog))

    launches, busy, syncs, top, _ = profiled(
        (lambda: tomography.do_tomography(qvm, prog, qubits, kind))
        if kind == "process" else acquire)
    what = "the whole call" if kind == "process" else (
        f"acquisition and calibration; the estimation ran {steps} MLE steps")
    rec = dict(groups=len(expt), results=len(results),
               calibration_programs=n_cal, host_s=wall,
               circuits_per_s=circuits / (clock["acquisition"]
                                          + clock["calibration"]),
               launches=launches, busy_ms=busy, syncs=syncs, profiled=what,
               **{f"{k}_s": v for k, v in clock.items()})
    print(f"timing {name}: {len(expt)} groups + {n_cal} calibration "
          f"programs, 1000 shots each; host clock {wall:.3f} s (acquisition "
          f"{clock['acquisition']:.3f} s, calibration "
          f"{clock['calibration']:.3f} s, estimation "
          f"{clock['estimation']:.3f} s), {rec['circuits_per_s']:.1f} "
          f"circuits/s; profiled ({what}): {launches} device launches, busy "
          f"{busy:.3f} ms, {syncs} synchronizations on {card}")
    print_top(top)
    return est, expt, results, rec


def setting_key(result, qubits):
    """A setting with its qubits renamed to their positions in ``qubits``."""
    pos = {q: i for i, q in enumerate(qubits)}
    states = tuple(sorted((pos[s.qubit], s.label, s.index)
                          for s in result.setting.in_state.states))
    ops = tuple(sorted((pos[q], op) for q, op in result.setting.observable))
    return states, ops


def phase_tomography(card: str, dev: torch.device) -> dict:
    """17. The tomography protocol on the card; see the module docstring."""
    t_phase = time.perf_counter()
    from forest_benchmarking_tpu_torch import circuits, tomography
    from forest_benchmarking_tpu_torch import distance_measures as dm
    from forest_benchmarking_tpu_torch.benchmarks import inputs_from_numpy
    from forest_benchmarking_tpu_torch.observable_estimation import (
        estimate_observables, generate_experiment_programs,
        get_calibration_program, get_results_by_qubit_groups,
        merge_disjoint_experiments)
    from forest_benchmarking_tpu_torch.ops import lanes_apg
    from forest_benchmarking_tpu_torch.ops.superoperator_transformations \
        import choi2pauli_liouville, kraus2choi
    from forest_benchmarking_tpu_torch.sim import QVM, noise
    record = {}
    counters = port_launches()
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0

    # (a) 2Q process tomography of a noisy CZ, do_tomography's defaults
    prog, kraus = noisy_cz(circuits, noise, (0, 1))
    qvm = QVM(seed=SEED + 17, device=dev)
    est, expt, res_a, rec = tomography_run(
        "process tomography 2Q", card, tomography, qvm, prog, [0, 1],
        "process")
    truth = kraus2choi(torch.tensor(np.stack(noise.append_kraus_to_gate(
        kraus, circuits.gate_matrix("CZ"))), device=dev))
    fid = dm.process_fidelity(choi2pauli_liouville(truth),
                              choi2pauli_liouville(est)).item()
    programs, meas = generate_experiment_programs(expt)
    obs = {r.setting.observable.copy(coefficient=1.0) for r in res_a}
    programs += [get_calibration_program(o, prog) for o in obs]
    meas += [o.get_qubits() for o in obs]
    cpu = QVM(device="cpu")
    prob_err = max(
        (qvm.probabilities(p, m).cpu() - cpu.probabilities(p, m)).abs().max()
        .item() for p, m in zip(programs, meas))
    print(f"main path process tomography 2Q: CZ with {TOMO_DEPOL} "
          f"depolarizing, readout {TOMO_READOUT}; {len(res_a)} settings in "
          f"{len(expt)} groups; process fidelity to the true channel "
          f"{fid:.6f} (bar >= {PROCESS_FID_BAR}); {len(programs)} programs, "
          f"max |card - CPU| probability {prob_err:.3e} (bar {PROB_BAR})")
    check(len(res_a) == 540 and len(programs) == len(expt) + 15,
          f"process tomography: {len(res_a)} results, {len(programs)} "
          "programs")
    check(est.shape == (16, 16) and bool(torch.isfinite(est).all()),
          "process tomography: estimate not finite or of the wrong shape")
    check(fid >= PROCESS_FID_BAR, f"process fidelity {fid}")
    check(prob_err <= PROB_BAR, f"card against CPU probabilities {prob_err}")
    record["process_2q"] = dict(rec, fidelity=fid, max_prob_err=prob_err,
                                part_s=time.perf_counter() - t_phase)
    t_part = time.perf_counter()

    # (b) 3Q GHZ state tomography
    ghz = circuits.Circuit([circuits.H(0), circuits.CNOT(0, 1),
                            circuits.CNOT(1, 2)])
    for q in range(3):
        ghz.define_noisy_readout(q, *TOMO_READOUT)
    rho, expt_b, res_b, rec = tomography_run(
        "state tomography 3Q GHZ", card, tomography, qvm, ghz, [0, 1, 2],
        "state")
    psi = torch.zeros(8, dtype=rho.dtype, device=dev)
    psi[0] = psi[7] = 2 ** -0.5
    fid_b = dm.fidelity(torch.outer(psi, psi.conj()), rho).item()
    print(f"main path state tomography 3Q GHZ: {len(res_b)} settings in "
          f"{len(expt_b)} groups of 8 flip patterns; fidelity to GHZ "
          f"{fid_b:.6f} (bar {STATE_FID_BAR})")
    check(len(expt_b) == 27 and rho.shape == (8, 8)
          and bool(torch.isfinite(rho).all()), "state tomography: shape")
    check(STATE_FID_BAR[0] <= fid_b <= STATE_FID_BAR[1],
          f"state fidelity {fid_b}")
    record["state_3q"] = dict(rec, fidelity=fid_b,
                              part_s=time.perf_counter() - t_part)
    t_part = time.perf_counter()
    hand = [c.launches for c in counters]
    check(sum(hand) == 0, f"do_tomography launched hand kernels {hand}")

    # (c) the fused kernel on data from circuits: two disjoint pairs in one
    # acquisition, stacked with (a)'s counts
    pairs = ((0, 1), (2, 3))
    expts = [tomography.generate_process_tomography_experiment(
        noisy_cz(circuits, noise, p)[0], list(p)) for p in pairs]
    t0 = time.perf_counter()
    merged = merge_disjoint_experiments(expts)
    res_c = list(estimate_observables(qvm, merged, num_shots=1000,
                                      symm_type=-1))
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    by_pair = get_results_by_qubit_groups(res_c, pairs)
    # (a)'s results before calibration: a calibrated expectation past +-1
    # makes a negative count, on which the fused solver diverges (its
    # calibrated counts go in last, printed and not held)
    raw_a = [tomography.ExperimentResult(
        setting=r.setting, expectation=r.raw_expectation,
        std_err=r.raw_std_err, total_counts=r.total_counts) for r in res_a]
    a_np, n_raw = tomography._extract_from_results(raw_a, [0, 1])
    n_cal = tomography._extract_from_results(res_a, [0, 1])[1]
    order = {setting_key(r, [0, 1]): i for i, r in enumerate(res_a)}
    ns, same_a = [n_raw], True
    for p in pairs:
        a_p, n_p = tomography._extract_from_results(by_pair[p], list(p))
        idx = np.empty(len(res_a), dtype=np.int64)
        for i, r in enumerate(by_pair[p]):
            idx[order[setting_key(r, list(p))]] = i
        rows = np.stack([2 * idx, 2 * idx + 1], axis=1).reshape(-1)
        same_a &= np.array_equal(a_p[rows], a_np)
        ns.append(n_p[rows])
    print(f"main path fused from circuits: pairs {pairs} merged into "
          f"{len(merged)} groups (4-qubit density matrices, 16 patterns), "
          f"{len(res_c)} results in {wall_c:.3f} s host clock; rows permuted "
          f"into (a)'s order, A bitwise equal: {same_a}")
    check(same_a and all(len(by_pair[p]) == 540 for p in pairs),
          "fused from circuits: the pairs' A do not match (a)'s by setting")
    n_np = np.stack(ns + [n_cal])
    a = torch.tensor(a_np, dtype=torch.complex64, device=dev)
    n = torch.tensor(n_np, dtype=torch.float32, device=dev)
    # the default schedule (apg_fused's own: PARITY_PHASES, step 1/mu =
    # 2 d^2 / 3) and the two tuned dim = 4 schedules of
    # pgdb_process_estimate_batched, one batched call each
    calls = {"default": lambda: lanes_apg.apg_fused(a, n, 4)}
    for name in SCHEDULES:
        calls[name] = functools.partial(
            tomography.pgdb_process_estimate_batched, a, n, dim=4,
            method="apg", cp_method="pallas", fused_schedule=name)
    fused, moved = {}, {}
    for name, call in calls.items():
        before = lanes_apg.apg_fused.launches
        fused[name] = call()
        torch.cuda.synchronize()
        moved[name] = lanes_apg.apg_fused.launches - before
    launches = lanes_apg.apg_fused.launches
    t0 = time.perf_counter()
    pgdb = torch.stack([tomography.pgdb_process_estimate(r, q, device=dev)
                        for r, q in ((raw_a, [0, 1]), (by_pair[pairs[0]],
                                                       list(pairs[0])),
                                     (by_pair[pairs[1]], list(pairs[1])))]
                       + [est])
    torch.cuda.synchronize()
    wall_pgdb = time.perf_counter() - t0
    gaps = {name: rel_frobenius(est.to(pgdb.dtype), pgdb).tolist()
            for name, est in fused.items()}
    for name in calls:
        print(f"fused {name} from circuits: {moved[name]} launch(es); max "
              f"|estimate| {fused[name].abs().max().item():.4g}; rel "
              f"Frobenius to pgdb_process_estimate (complex128, "
              f"{wall_pgdb:.3f} s for the three) of (a) before calibration, "
              f"the two pairs, and (a) calibrated: "
              + ", ".join(f"{g:.3e}" for g in gaps[name])
              + (f" (bar {FUSED_PGDB_BAR} on the first three)"
                 if name == "default" else
                 " (printed, not held: the tuned step diverges on "
                 "near-unitary channels, in the JAX package as here)"))
        check(moved[name] == 1, f"{name}: {moved[name]} launches, want 1")
    check(max(gaps["default"][:3]) <= FUSED_PGDB_BAR,
          f"default schedule: fused {max(gaps['default'][:3]):.3e} from PGDB")
    # the kernel against its plain version on the three uncalibrated rows
    in32 = inputs_from_numpy(a_np, n_np[:3], device=dev)
    in64 = inputs_from_numpy(a_np, n_np[:3], device=dev, dtype=torch.float64)
    kern = lanes_apg.apg_fused(in32.a, in32.n, 4, a_pinv=in32.a_pinv)
    rho0 = lanes_apg.linear_inversion_start(in32.a_pinv, in32.n, 4)
    # the plain version takes seconds here (thousands of small launches):
    # one timed run, whose output the check below reuses
    ms_p, plain32 = cuda_ms(lambda: torch.complex(
        *lanes_apg.apg_fused_reference(in32.ar, in32.ai, in32.n, *rho0,
                                       dim=4)), reps=1, warmup=False)
    err = against_plain(lanes_apg, "default from circuits", kern, in32, in64,
                        in32.n, {}, plain32=plain32)
    ms_k, _ = cuda_ms(lambda: lanes_apg.apg_fused_kernel(
        in32.ar, in32.ai, in32.n, *rho0, dim=4))
    ms_l, _ = cuda_ms(calls["default"])
    bound = bound_ms(3 * lanes_apg.apg_fused_flops_per_solve(
        a_np.shape[0], 4), nbytes(in32.ar, in32.ai, in32.n, *rho0, *rho0))
    print(f"timing fused default from circuits: B=3 (the uncalibrated rows) "
          f"kernel {ms_k:.3f} ms, "
          f"plain {ms_p:.3f} ms, the batched call (pinv and warm start "
          f"included, B=4) {ms_l:.3f} ms; bound {bound[0]:.4f} ms ({bound[1]}), "
          f"{100 * bound[0] / ms_k:.2f}% of it on {card}")
    record["fused_from_circuits"] = dict(
        launches=launches, launches_per_call=moved, max_abs_err=err,
        rel_frobenius_to_pgdb=gaps, ms=ms_k, plain_ms=ms_p, call_ms=ms_l,
        bound_ms=bound[0], bound_by=bound[1], acquisition_s=wall_c,
        pgdb_s=wall_pgdb, part_s=time.perf_counter() - t_part)
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s")
    return record


PROTO_SEED = SEED + 18
RB_PAULI_1Q = (0.85 + 0.15 / 4, 0.06, 0.04, 0.0125)  # decay 0.85
RB_DEPOL_2Q = 0.05          # 2Q depolarizing per Clifford: decay 0.95
IRB_CLIFFORD, IRB_GATE = 0.04, 0.1   # 1Q depolarizing p per Clifford, gate
UNITARITY_DECAY = 0.9       # depolarizing decay per Clifford: unitarity 0.81
T1, T2 = 12e-6, 9e-6
DFE_DEPOL = 0.1             # 2Q depolarizing after the Clifford
RPE_ANGLES = (0.3, 1.1, 2.5)
CONFUSION = {0: (0.9, 0.8), 1: (0.97, 0.85)}   # p(0|0), p(1|1)
CONFIG3_DEPTHS = (2, 4, 8, 16, 32)
CONFIG3_PER_DEPTH = 200
CONFIG3_DEPOL = 0.02        # 2Q depolarizing PTM after every element
CONFIG3_SHOTS = 500
SIGMAS = 2.5                # the decay bars of the JAX suite, in sigma
CONFUSION_SIGMAS = 5


def noise_carrier(circuits, qubits, kraus, name):
    """A no-op custom gate and the annotation that attaches ``kraus`` to it
    (the JAX suite's pattern for noise that survives compilation)."""
    eye = np.eye(2 ** len(qubits), dtype=complex)
    return circuits.Gate(name, (), tuple(qubits),
                         matrix=tuple(map(tuple, eye))), (name, kraus)


@contextlib.contextmanager
def clifford_noise(rb, circuits, kraus, every=1):
    """For the block, ``do_rb`` attaches ``kraus`` after every ``every``-th
    element of each sequence (the Cliffords; every other element of an
    interleaved sequence): the module's
    ``group_sequences_into_parallel_experiments`` is wrapped to add the
    noise before it merges the sequences, as the JAX suite's
    ``add_noise_to_sequences`` does."""
    real = rb.group_sequences_into_parallel_experiments

    def noisy(parallel, groups, *args, **kwargs):
        for seqs, group in zip(parallel, groups):
            gate, (name, k) = noise_carrier(circuits, group, kraus,
                                            "seqnoise")
            for seq in seqs:
                for circ in seq[::every]:
                    circ.gates.append(gate)
                    circ.define_noisy_gate(name, list(group), k)
        return real(parallel, groups, *args, **kwargs)

    rb.group_sequences_into_parallel_experiments = noisy
    try:
        yield
    finally:
        rb.group_sequences_into_parallel_experiments = real


class Planned:
    """Counts the circuits a QVM simulates (its ``_plan`` calls)."""

    def __init__(self, qvm):
        self.count = 0
        real = qvm._plan

        def plan(*args, **kwargs):
            self.count += 1
            return real(*args, **kwargs)
        qvm._plan = plan


def card_against_cpu(qvm, programs, meas, **qvm_kw):
    """The largest |card - CPU| probability over the programs (complex128,
    the CPU QVM with the same T1 and T2)."""
    from forest_benchmarking_tpu_torch.sim import QVM
    cpu = QVM(device="cpu", **qvm_kw)
    return max((qvm.probabilities(p, m).cpu() - cpu.probabilities(p, m))
               .abs().max().item() for p, m in zip(programs, meas))


def experiment_programs(expts, limit=4):
    """The compiled programs (and measured qubits) of the first ``limit``
    experiments."""
    from forest_benchmarking_tpu_torch.observable_estimation import (
        generate_experiment_programs)
    programs, meas = [], []
    for expt in list(expts)[:limit]:
        p, m = generate_experiment_programs(expt)
        programs += p
        meas += m
    return programs, meas


def protocol_run(name, card, module, stages, call, qvm, acquire=None):
    """``call()`` timed by stage (``module_clock``), with the executor's
    cache hits and misses and the circuits ``qvm`` simulated; then, when
    ``acquire`` is given, ``acquire(call's result)()`` (the run's
    acquisition again) under ``torch.profiler``. Returns (call's result,
    record)."""
    from forest_benchmarking_tpu_torch.sim.executor import (
        executor_cache_info)
    planned = Planned(qvm)
    before = executor_cache_info()
    with module_clock(module, stages) as clock:
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    after = executor_cache_info()
    rec = dict(host_s=wall, **{f"{k}_s": v for k, v in clock.items()},
               cache_hits=after["hits"] - before["hits"],
               cache_misses=after["misses"] - before["misses"],
               circuits=planned.count,
               circuits_per_s=planned.count / clock["acquisition"])
    text = (f"timing {name}: host clock {wall:.3f} s ("
            + ", ".join(f"{k} {v:.3f} s" for k, v in clock.items())
            + f"), {planned.count} circuits, {rec['circuits_per_s']:.1f} "
            f"circuits/s; executor cache {rec['cache_hits']} hits, "
            f"{rec['cache_misses']} misses")
    if acquire is not None:
        launches, busy, syncs, _, _ = profiled(acquire(out))
        rec.update(launches=launches, busy_ms=busy, syncs=syncs,
                   launches_per_circuit=launches / planned.count)
        text += (f"; the acquisition profiled again: {launches} device "
                 f"launches ({launches / planned.count:.0f} a circuit), "
                 f"busy {busy:.3f} ms, {syncs} synchronizations")
    print(text + f" on {card}")
    return out, rec


def phase_protocols(card: str, dev: torch.device) -> dict:
    """18. The Clifford-engine protocols on the card; see the module
    docstring."""
    t_phase = time.perf_counter()
    from forest_benchmarking_tpu_torch import (
        circuits, clifford, direct_fidelity_estimation as dfe, readout,
        qubit_spectroscopy as qs, randomized_benchmarking as rb,
        robust_phase_estimation as rpe)
    from forest_benchmarking_tpu_torch.observable_estimation import (
        get_calibration_program)
    from forest_benchmarking_tpu_torch.sim import QVM, noise
    from forest_benchmarking_tpu_torch.utils import (
        parameterized_bitstring_prep)
    record = {}
    counters = port_launches()
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    rb_stages = {"generate_rb_experiments": "generation",
                 "generate_unitarity_experiments": "generation",
                 "acquire_rb_data": "acquisition",
                 "fit_rb_results": "fit", "fit_unitarity_results": "fit"}

    # (a) do_rb on the card: 1Q RB, 2Q RB, 1Q IRB, 1Q unitarity
    t_part = time.perf_counter()
    clifford.clifford_group.cache_clear()
    t0 = time.perf_counter()
    clifford.clifford_group(2)
    record["clifford_group_2_s"] = time.perf_counter() - t0
    print(f"clifford_group(2): {len(clifford.clifford_group(2)[0])} "
          f"elements by breadth-first search in "
          f"{record['clifford_group_2_s']:.3f} s (host)")

    def rb_item(name, groups, depths, kraus, every=1, seed=0, profile=False,
                **kw):
        qvm = QVM(seed=PROTO_SEED + seed, device=dev)

        def call():
            with clifford_noise(rb, circuits, kraus, every):
                return rb.do_rb(qvm, groups, depths, random_seed=seed, **kw)
        (decays, expts, results), rec = protocol_run(
            name, card, rb, rb_stages, call, qvm, (lambda out: lambda: (
                rb.acquire_rb_data(qvm, out[1], kw["num_shots"])))
            if profile else None)
        stats = rb.get_stats_by_qubit_group(groups, results)[tuple(groups[0])]
        fit = (rb.fit_unitarity_results(depths, stats["expectation"],
                                        stats["std_err"], device=dev)
               if kw.get("is_unitarity_expt") else
               rb.fit_rb_results(depths, stats["expectation"],
                                 stats["std_err"], kw.get("num_shots", 1000),
                                 device=dev))
        decay, sigma = fit.params["decay"].value, fit.params["decay"].stderr
        check(decay == decays[tuple(groups[0])], f"{name}: the refit moved")
        prob_err = card_against_cpu(qvm, *experiment_programs(expts))
        check(prob_err <= PROB_BAR, f"{name}: card against CPU {prob_err}")
        return decay, sigma, dict(rec, decay=decay, stderr=sigma,
                                  max_prob_err=prob_err, sequences=len(expts))

    depths_1q = [d for d in (2, 4, 8, 12, 16, 24) for _ in range(10)]
    decay, sigma, rec = rb_item(
        "RB 1Q", [(0,)], depths_1q, noise.pauli_kraus_map(RB_PAULI_1Q),
        seed=1, profile=True, num_shots=500)
    print(f"main path RB 1Q (Pauli channel per Clifford): decay {decay:.5f} "
          f"+- {sigma:.5f}, want 0.85 within {SIGMAS} sigma")
    check(abs(decay - 0.85) <= SIGMAS * max(sigma, 1e-3), f"RB 1Q {decay}")
    record["rb_1q"] = rec

    p = RB_DEPOL_2Q
    depths_2q = [d for d in (2, 4, 8, 12, 16) for _ in range(8)]
    decay, sigma, rec = rb_item(
        "RB 2Q", [(0, 1)], depths_2q,
        noise.pauli_kraus_map([1 - 15 * p / 16] + [p / 16] * 15), seed=2,
        profile=True, num_shots=500)
    print(f"main path RB 2Q (depolarizing {p} per Clifford): decay "
          f"{decay:.5f} +- {sigma:.5f}, want {1 - p} within {SIGMAS} sigma")
    check(abs(decay - (1 - p)) <= SIGMAS * max(sigma, 1e-3), f"RB 2Q {decay}")
    record["rb_2q"] = rec

    gate = circuits.Circuit([circuits.RX(np.pi / 2, 0)])
    carrier, (cname, ck) = noise_carrier(
        circuits, (0,), noise.depolarizing_kraus_map(IRB_GATE), "gnoise")
    gate += carrier
    gate.define_noisy_gate(cname, [0], ck)
    kraus_c = noise.depolarizing_kraus_map(IRB_CLIFFORD)
    depths_irb = [d for d in (2, 4, 8, 12, 16) for _ in range(10)]
    rb_decay, rb_sigma, rec_rb = rb_item(
        "IRB reference 1Q", [(0,)], depths_irb, kraus_c, seed=3,
        num_shots=1000)
    irb_decay, irb_sigma, rec_irb = rb_item(
        "IRB interleaved 1Q", [(0,)], depths_irb, kraus_c, every=2, seed=4,
        num_shots=1000, interleaved_gate=gate)
    error = rb.irb_decay_to_gate_error(irb_decay, rb_decay, 2)
    err_sigma = 0.5 * math.hypot(irb_sigma / rb_decay,
                                 irb_decay * rb_sigma / rb_decay ** 2)
    print(f"main path IRB 1Q (depolarizing {IRB_CLIFFORD} per Clifford, "
          f"{IRB_GATE} on RX(pi/2)): decays {rb_decay:.5f} / "
          f"{irb_decay:.5f}, gate error {error:.5f} +- {err_sigma:.5f}, want "
          f"{IRB_GATE / 2} within {SIGMAS} sigma")
    check(abs(error - IRB_GATE / 2) <= SIGMAS * max(err_sigma, 1e-3),
          f"IRB gate error {error}")
    record["irb_1q"] = dict(reference=rec_rb, interleaved=rec_irb,
                            gate_error=error, gate_error_stderr=err_sigma)

    f = UNITARITY_DECAY
    depths_u = [d for d in (1, 4, 7, 10) for _ in range(8)]
    unitarity, _, rec = rb_item(
        "unitarity 1Q", [(0,)], depths_u,
        noise.pauli_kraus_map([f + (1 - f) / 4] + [(1 - f) / 4] * 3),
        seed=5, num_shots=3000, is_unitarity_expt=True)
    implied = rb.unitarity_to_rb_decay(unitarity, 2)
    print(f"main path unitarity 1Q (depolarizing decay {f}): unitarity "
          f"{unitarity:.5f} (want {f ** 2:.2f} within 0.02), implied RB "
          f"decay {implied:.5f} (want {f} within 0.02)")
    check(abs(unitarity - f ** 2) <= 0.02 and abs(implied - f) <= 0.02,
          f"unitarity {unitarity}")
    record["unitarity_1q"] = rec
    record["a_s"] = time.perf_counter() - t_part

    # (b) do_t1_or_t2 with T1 and T2 at DELAY
    t_part = time.perf_counter()
    qs_stages = {name: "generation" for name in (
        "generate_t1_experiments", "generate_t2_star_experiments",
        "generate_t2_echo_experiments")}
    qs_stages.update(acquire_qubit_spectroscopy_data="acquisition",
                     fit_t1_results="fit", fit_t2_results="fit")
    for seed, (kind, truth, bar, times) in enumerate((
            ("t1", T1, 1.0, np.linspace(1e-6, 40e-6, 15)),
            ("t2_star", T2, 1.5, np.linspace(0.5e-6, 20e-6, 25)),
            ("t2_echo", T2, 1.5, np.linspace(0.5e-6, 20e-6, 25)))):
        kw = dict(t1s={0: T1 if kind == "t1" else 100e-6},
                  t2s={} if kind == "t1" else {0: T2})
        qvm = QVM(seed=PROTO_SEED + 10 + seed, device=dev, **kw)
        (times_by_q, expts, _), rec = protocol_run(
            kind, card, qs, qs_stages, functools.partial(
                qs.do_t1_or_t2, qvm, [0], times, kind, num_shots=4000), qvm,
            (lambda out: lambda: qs.acquire_qubit_spectroscopy_data(
                qvm, out[1], 4000)) if kind == "t1" else None)
        prob_err = card_against_cpu(qvm, *experiment_programs(expts, 25),
                                    **kw)
        print(f"main path {kind}: {times_by_q[0]:.4f} us, want "
              f"{truth / 1e-6:.1f} within {bar} us; {len(expts)} programs, "
              f"max |card - CPU| probability {prob_err:.3e}")
        check(abs(times_by_q[0] - truth / 1e-6) < bar, f"{kind} {times_by_q}")
        check(prob_err <= PROB_BAR, f"{kind}: card against CPU {prob_err}")
        record[kind] = dict(rec, decay_time_us=times_by_q[0],
                            max_prob_err=prob_err)
    record["b_s"] = time.perf_counter() - t_part

    # (c) do_dfe of a seeded random 2Q Clifford (config 4's DFE half)
    t_part = time.perf_counter()
    t0 = time.perf_counter()
    (program,), _ = clifford.random_clifford_circuits(
        [0, 1], 1, np.random.RandomState(PROTO_SEED))
    group_s = time.perf_counter() - t0
    p = DFE_DEPOL
    carrier, (cname, ck) = noise_carrier(
        circuits, (0, 1), noise.pauli_kraus_map(
            [1 - 15 * p / 16] + [p / 16] * 15), "noise")
    noisy = program.copy()
    noisy += carrier
    noisy.define_noisy_gate(cname, [0, 1], ck)
    dfe_stages = {name: "generation" for name in dfe.__all__
                  if name.startswith("generate_")}
    dfe_stages.update(acquire_dfe_data="acquisition", estimate_dfe="fit")
    print(f"main path DFE: a random 2Q Clifford drawn from "
          f"clifford_group(2) in {group_s:.4f} s, {len(program.gates)} "
          f"gates: " + "; ".join(str(g) for g in program.gates))
    runs = [(prog, shots, want, bar, kind)
            for prog, shots, want, bar in ((program, 2000, 1.0, None),
                                           (noisy, 5000, 1 - 3 * p / 4, 0.02))
            for kind in ("state", "process")]
    for seed, (prog, shots, want, bar, kind) in enumerate(runs):
        qvm = QVM(seed=PROTO_SEED + 20 + seed, device=dev)
        ((fid, err), expt, results), rec = protocol_run(
            f"DFE {kind} {'noisy' if bar else 'noiseless'}", card, dfe,
            dfe_stages, functools.partial(dfe.do_dfe, qvm, prog, [0, 1],
                                          kind, num_shots=shots), qvm,
            (lambda out: lambda: dfe.acquire_dfe_data(
                qvm, out[1], num_shots=shots))
            if bar and kind == "process" else None)
        programs, meas = experiment_programs([expt], limit=1)
        obs = list(dict.fromkeys(r.setting.observable.copy(
            coefficient=1.0) for r in results))
        programs += [get_calibration_program(o, prog) for o in obs]
        meas += [o.get_qubits() for o in obs]
        prob_err = card_against_cpu(qvm, programs[::4], meas[::4])
        ok = fid >= 0.99 if bar is None else abs(fid - want) <= bar
        print(f"main path DFE {kind} {'noisy' if bar else 'noiseless'}: "
              f"{len(results)} settings, fidelity {fid:.5f} +- "
              f"{err:.5f} (want "
              + (">= 0.99" if bar is None else f"{want} within {bar}")
              + f"); max |card - CPU| probability {prob_err:.3e}")
        check(ok, f"DFE {kind}: {fid}")
        check(prob_err <= PROB_BAR, f"DFE: card against CPU {prob_err}")
        record[f"dfe_{kind}_{'noisy' if bar else 'noiseless'}"] = dict(
            rec, fidelity=fid, stderr=err, max_prob_err=prob_err,
            settings=len(results))
    record["c_s"] = time.perf_counter() - t_part

    # (d) do_rpe of RZ(theta)
    t_part = time.perf_counter()
    rpe_stages = {"generate_rpe_experiments": "generation",
                  "acquire_rpe_data": "acquisition",
                  "robust_phase_estimate": "fit"}
    for i, angle in enumerate(RPE_ANGLES):
        qvm = QVM(seed=PROTO_SEED + 30 + i, device=dev)
        (estimates, expts, _), rec = protocol_run(
            f"RPE RZ({angle})", card, rpe, rpe_stages, functools.partial(
                rpe.do_rpe, qvm, circuits.Circuit([circuits.RZ(angle, 0)]),
                [circuits.Circuit()], [(0,)], num_depths=6,
                multiplicative_factor=10.0), qvm,
            (lambda out: lambda: rpe.acquire_rpe_data(
                qvm, out[1], multiplicative_factor=10.0)) if i == 0 else None)
        est = estimates[(0,)]
        prob_err = card_against_cpu(qvm, *experiment_programs(expts, 6))
        print(f"main path RPE RZ({angle}): {est:.5f} rad, want within 0.05; "
              f"max |card - CPU| probability {prob_err:.3e}")
        check(abs(est - angle) <= 0.05, f"RPE {angle}: {est}")
        check(prob_err <= PROB_BAR, f"RPE: card against CPU {prob_err}")
        record[f"rpe_{angle}"] = dict(rec, estimate=est,
                                      max_prob_err=prob_err)
    record["d_s"] = time.perf_counter() - t_part

    # (e) estimate_joint_confusion_in_set under a known readout confusion
    t_part = time.perf_counter()

    class ConfusedQVM(QVM):
        def run(self, circuit, qubits, num_shots):
            confused = circuit.copy()
            for q, (p00, p11) in CONFUSION.items():
                confused.define_noisy_readout(q, p00=p00, p11=p11)
            return super().run(confused, qubits, num_shots)

    shots = 4000
    qvm = ConfusedQVM(seed=PROTO_SEED + 40, device=dev)
    cms, rec = protocol_run(
        "joint confusion", card, readout,
        {"estimate_joint_confusion_in_set": "acquisition"},
        lambda: readout.estimate_joint_confusion_in_set(
            qvm, qubits=[0, 1, 2], num_shots=shots, joint_group_size=2), qvm,
        lambda out: lambda: readout.estimate_joint_confusion_in_set(
            qvm, qubits=[0, 1, 2], num_shots=shots, joint_group_size=2))
    worst = 0.0
    for group, cm in cms.items():
        truth = np.ones((1, 1))
        for q in group:
            p00, p11 = CONFUSION.get(q, (1.0, 1.0))
            truth = np.kron(truth, [[p00, 1 - p00], [1 - p11, p11]])
        sigma = np.sqrt(truth * (1 - truth) / shots)
        worst = max(worst, float(np.max(
            np.abs(cm - truth) / np.maximum(sigma, 1e-12)
            * (np.abs(cm - truth) > 1e-12))))
    programs = []
    for bits in itertools.product([0, 1], repeat=2):
        prog = parameterized_bitstring_prep([0, 1], bits)
        for q, (p00, p11) in CONFUSION.items():
            prog.define_noisy_readout(q, p00=p00, p11=p11)
        programs.append(prog)
    prob_err = card_against_cpu(qvm, programs, [[0, 1]] * len(programs))
    print(f"main path joint confusion: groups {sorted(cms)}, the largest "
          f"deviation from the true confusion {worst:.3f} binomial sigma "
          f"(bar {CONFUSION_SIGMAS}); max |card - CPU| probability "
          f"{prob_err:.3e}")
    check(set(cms) == {(0, 1), (0, 2), (1, 2)} and worst <= CONFUSION_SIGMAS,
          f"joint confusion: {worst} sigma")
    check(prob_err <= PROB_BAR, f"confusion: card against CPU {prob_err}")
    record["confusion"] = dict(rec, worst_sigma=worst, max_prob_err=prob_err)
    record["e_s"] = time.perf_counter() - t_part

    # (f) BASELINE config 3 from circuits
    t_part = time.perf_counter()
    depths = [d for d in CONFIG3_DEPTHS for _ in range(CONFIG3_PER_DEPTH)]
    cz = circuits.Circuit([circuits.CZ(0, 1)])
    p = CONFIG3_DEPOL
    noise_ptm = np.diag([1.0] + [1 - p] * 15)
    gen = torch.Generator(device=dev).manual_seed(PROTO_SEED)
    rec = {}
    decays = {}
    for name, gate, want in (("rb", None, 1 - p), ("irb", cz, (1 - p) ** 2)):
        t0 = time.perf_counter()
        seqs = rb.generate_rb_experiment_sequences(
            (0, 1), depths, gate, random_seed=PROTO_SEED + len(name))
        t_gen = time.perf_counter() - t0
        t0 = time.perf_counter()
        ptms, lengths = rb.sequences_to_ptm_stack(seqs, (0, 1))
        t_ptm = time.perf_counter() - t0
        t0 = time.perf_counter()
        ptms_dev = torch.tensor(ptms, device=dev)
        torch.cuda.synchronize()
        t_copy = time.perf_counter() - t0

        def simulate():
            return rb.simulate_rb_survival_batched(
                ptms_dev, noise_ptm, gen, num_shots=CONFIG3_SHOTS,
                lengths=lengths)
        t0 = time.perf_counter()
        surv = simulate()
        torch.cuda.synchronize()
        t_sim = time.perf_counter() - t0
        launches, busy, syncs, _, _ = profiled(simulate)
        s = surv.cpu().numpy()
        t0 = time.perf_counter()
        var = np.clip(s * (1 - s), 1 / CONFIG3_SHOTS, None) / CONFIG3_SHOTS
        fit = rb.fit_rb_results(depths, [[2 * v - 1] for v in s],
                                [[2 * np.sqrt(v)] for v in var], device=dev)
        t_fit = time.perf_counter() - t0
        decays[name] = fit.params["decay"].value
        # exact survivals of a sample of sequences, card against CPU
        sample = slice(0, None, 97)
        exact = rb.simulate_rb_survival_batched(
            ptms_dev[sample], noise_ptm, lengths=lengths[sample])
        exact_cpu = rb.simulate_rb_survival_batched(
            ptms[sample], noise_ptm, lengths=lengths[sample], device="cpu")
        sim_err = (exact.cpu() - exact_cpu).abs().max().item()
        elements = int(lengths.sum())
        print(f"main path config 3 {name.upper()} from circuits: "
              f"{len(seqs)} 2Q sequences at depths {CONFIG3_DEPTHS}, "
              f"{elements} elements; generation {t_gen:.3f} s, PTM stack "
              f"{t_ptm:.3f} s ({elements / t_ptm:.0f} elements/s, "
              f"{len(seqs) / (t_gen + t_ptm):.1f} circuits/s), copy "
              f"{t_copy:.3f} s, simulation {1e3 * t_sim:.3f} ms "
              f"({launches} launches, busy {busy:.3f} ms, {syncs} "
              f"synchronizations), fit {t_fit:.3f} s; decay "
              f"{decays[name]:.5f}, want {want:.5f} within 0.01; exact "
              f"survivals card against CPU {sim_err:.3e} on {card}")
        check(abs(decays[name] - want) <= 0.01, f"config 3 {name}: "
              f"{decays[name]}")
        check(sim_err <= PROB_BAR, f"config 3 {name}: card against CPU "
              f"{sim_err}")
        rec[name] = dict(sequences=len(seqs), elements=elements,
                         generation_s=t_gen, ptm_stack_s=t_ptm, copy_s=t_copy,
                         simulation_ms=1e3 * t_sim, launches=launches,
                         busy_ms=busy, syncs=syncs, fit_s=t_fit,
                         decay=decays[name], max_prob_err=sim_err,
                         circuits_per_s=len(seqs) / (t_gen + t_ptm))
        del ptms, ptms_dev
    gate_error = rb.irb_decay_to_gate_error(decays["irb"], decays["rb"], 4)
    print(f"main path config 3: CZ error from IRB {gate_error:.5f} (the "
          f"depolarizing channel's {0.75 * p:.5f})")
    record["config3"] = dict(rec, cz_error=gate_error,
                             part_s=time.perf_counter() - t_part)
    hand = [c.launches for c in counters]
    check(sum(hand) == 0, f"the protocols launched hand kernels {hand}")
    record["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 18: {record['phase_s']:.1f} s")
    return record

S13_SEED = SEED + 19
QV13_QUBITS = 8             # BASELINE config 5: quantum volume to 8 qubits
QV13_CIRCUITS = 100         # the JAX package's defaults for circuits, shots
QV13_SHOTS = 1000
QV13_PROFILED = 5           # circuits a depth of the profiled sample
ROUTER_DEPTH = 5
ROUTER_SWAP_DEPOL = 0.5     # 1Q depolarizing on each qubit of a SWAP
GHZ_TREE = ((0, 1), (0, 2), (1, 3), (1, 4), (2, 5), (2, 6), (5, 7))
GHZ_SHOTS = 2000
CYCLE = 8
STABILIZER_BAR = 1e-5       # complex64 expectations against 1
ADDER_BITS = 3
ADDER_SHOTS = 100
ADDER_READOUT = (0.95, 0.92)   # p00, p11 of the adder example
RB_SHARD_DEPTHS = (2, 6, 10, 16)


def two_qubit_depolarizing(noise, p: float) -> np.ndarray:
    """The (16, 4, 4) Kraus stack of 1Q depolarizing ``p`` on each qubit of
    a pair (the JAX suite's noisy-QV construction)."""
    ks = noise.depolarizing_kraus_map(p)
    return np.stack([np.kron(a, b) for a in ks for b in ks])


def noisy_qvm(qvm_cls, gate: str, kraus: np.ndarray, **kw):
    """A QVM that attaches ``kraus`` after every ``gate`` of each circuit it
    runs (the JAX suite's ``NoisyQVM``)."""
    class Noisy(qvm_cls):
        def run(self, circuit, qubits, num_shots):
            noisy = circuit.copy()
            noisy.define_noisy_gate(gate, None, list(kraus))
            return super().run(noisy, qubits, num_shots)
    return Noisy(**kw)


@contextlib.contextmanager
def per_depth_clock(qv, qvm, log):
    """For the block, every ``sample_rand_circuits_for_heavy_out`` call of
    ``measure_quantum_volume`` appends to ``log`` its depth, host seconds,
    circuits, the executor cache's hits and misses, and the host seconds of
    its stages: drawing the circuits, building the programs, ``qvm.run``
    (through a synchronize) and the heavy sets; the rest of the call is
    the shot count on the host (``bit_array_to_int`` a shot)."""
    from forest_benchmarking_tpu_torch.sim.executor import (
        executor_cache_info)
    real = qv.sample_rand_circuits_for_heavy_out
    stages = {"generate_abstract_qv_circuit": "generation",
              "abstract_circuit_to_circuit": "program",
              "collect_heavy_outputs": "heavy_sets"}
    real_run = qvm.run

    def sample(q, qubits, depth, *args, **kwargs):
        before, planned = executor_cache_info(), Planned(qvm)
        sim = [0.0]

        def run(*a, **k):
            t0 = time.perf_counter()
            out = real_run(*a, **k)
            torch.cuda.synchronize()
            sim[0] += time.perf_counter() - t0
            return out
        qvm.run = run
        try:
            with module_clock(qv, stages) as clock:
                t0 = time.perf_counter()
                out = real(q, qubits, depth, *args, **kwargs)
                wall = time.perf_counter() - t0
        finally:
            del qvm.run, qvm._plan
        after = executor_cache_info()
        parts = dict(clock, simulation=sim[0])
        log.append(dict(depth=int(depth), host_s=wall,
                        circuits=planned.count,
                        circuits_per_s=planned.count / wall,
                        cache_hits=after["hits"] - before["hits"],
                        cache_misses=after["misses"] - before["misses"],
                        **{f"{k}_s": v for k, v in parts.items()},
                        shot_count_s=wall - sum(parts.values())))
        return out

    qv.sample_rand_circuits_for_heavy_out = sample
    try:
        yield log
    finally:
        qv.sample_rand_circuits_for_heavy_out = real


def within_widths(per_circuit, batched, name):
    """Hold two QV scans depth by depth: the heavy-output probabilities
    differ by at most the sum of their 2-sigma widths (probability - lower
    bound) at every depth both reached. Returns the depths compared."""
    depths = sorted(set(per_circuit) & set(batched))
    check(bool(depths), f"{name}: no common depth")
    for d in depths:
        (p1, lb1), (p2, lb2) = per_circuit[d], batched[d]
        gap, bar = abs(p1 - p2), (p1 - lb1) + (p2 - lb2)
        print(f"  {name} depth {d}: per-circuit {p1:.4f} (lower bound "
              f"{lb1:.4f}), batched {p2:.4f} ({lb2:.4f}), gap {gap:.4f}, "
              f"bar {bar:.4f}")
        check(gap <= bar, f"{name} depth {d}: gap {gap} > {bar}")
    return depths


def phase_slice13(card: str, dev: torch.device) -> dict:
    """19. Entangled states, the adder, quantum volume from circuits and the
    sharded entry points on the card; see the module docstring."""
    t_phase = time.perf_counter()
    from forest_benchmarking_tpu_torch import (
        classical_logic, entangled_states, quantum_volume as qv,
        randomized_benchmarking as rb)
    from forest_benchmarking_tpu_torch.benchmarks import (
        process_tomo_A_matrix, synth_process_datasets)
    from forest_benchmarking_tpu_torch.ops import (
        lanes_apg, lanes_dnorm, pallas_traj)
    from forest_benchmarking_tpu_torch.ops.random_operators import (
        rand_map_with_BCSZ_dist)
    from forest_benchmarking_tpu_torch.parallel import (
        batch_sharded, fold_in, make_mesh)
    from forest_benchmarking_tpu_torch.paulis import sX, sZ
    from forest_benchmarking_tpu_torch.sim import QVM, noise
    from forest_benchmarking_tpu_torch.sim.executor import (
        executor_cache_info)
    record = {}
    counters = port_launches()
    ideal, traj = pallas_traj.ideal_probs, pallas_traj.traj_probs
    qubits = list(range(QV13_QUBITS))

    # (a) config 5 from circuits, ideal: the per-circuit path on the card's
    # QVM against the batched kernel path
    t_part = time.perf_counter()
    qvm = QVM(seed=S13_SEED, dtype=torch.complex64, device=dev)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    log = []
    with per_depth_clock(qv, qvm, log):
        t0 = time.perf_counter()
        res_c = qv.measure_quantum_volume(
            qvm, qubits=range(QV13_QUBITS), num_circuits=QV13_CIRCUITS,
            num_shots=QV13_SHOTS, rng=np.random.RandomState(0),
            stop_when_fail=False)
        wall_c = time.perf_counter() - t0
    hand = [c.launches for c in counters]
    check(sum(hand) == 0, f"the per-circuit QV path launched {hand}")
    t0 = time.perf_counter()
    res_b = qv.measure_quantum_volume_batched(
        max_depth=QV13_QUBITS, num_circuits=QV13_CIRCUITS,
        num_shots=QV13_SHOTS, stop_when_fail=False, device=dev)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    launches_b = ideal.launches
    for row in log:
        d = row["depth"]
        launches, busy, syncs, _, _ = profiled(
            lambda: qv.sample_rand_circuits_for_heavy_out(
                qvm, qubits, d, None, QV13_PROFILED, QV13_SHOTS,
                rng=np.random.RandomState(d)))
        row.update(launches_per_program=launches / QV13_PROFILED,
                   syncs_per_program=syncs / QV13_PROFILED,
                   busy_ms_per_program=busy / QV13_PROFILED,
                   probability=res_c[d][0], lower_bound=res_c[d][1])
        print(f"timing QV from circuits depth {d}: {row['circuits']} "
              f"circuits in {row['host_s']:.3f} s, "
              f"{row['circuits_per_s']:.1f} circuits/s (generation "
              f"{row['generation_s']:.3f} s, programs {row['program_s']:.3f} "
              f"s, qvm.run {row['simulation_s']:.3f} s, heavy sets "
              f"{row['heavy_sets_s']:.3f} s, shot count "
              f"{row['shot_count_s']:.3f} s); executor cache "
              f"{row['cache_hits']} hits, {row['cache_misses']} misses; "
              f"profiled sample: {row['launches_per_program']:.1f} launches, "
              f"{row['syncs_per_program']:.1f} synchronizations, busy "
              f"{row['busy_ms_per_program']:.3f} ms a program on {card}")
    qv_c, qv_b = (int(qv.extract_quantum_volume_from_results(r))
                  for r in (res_c, res_b))
    print(f"main path config 5 from circuits: per-circuit "
          f"{QV13_CIRCUITS * len(res_c)} circuits in {wall_c:.3f} s "
          f"({QV13_CIRCUITS * len(res_c) / wall_c:.1f} circuits/s), QV "
          f"{qv_c}; batched kernel path {wall_b:.3f} s, {launches_b} ideal "
          f"kernel launches, QV {qv_b} on {card}")
    within_widths(res_c, res_b, "ideal")
    check(qv_c == qv_b == 2 ** QV13_QUBITS, f"ideal QV {qv_c} / {qv_b}")
    check(launches_b == QV13_QUBITS - 1,
          f"batched ideal QV: {launches_b} ideal kernel launches")
    record["ideal"] = dict(per_depth=log, host_s=wall_c, batched_s=wall_b,
                           ideal_launches=launches_b, qv=qv_c,
                           part_s=time.perf_counter() - t_part)

    # (b) config 5 from circuits, noisy: 2Q depolarizing on every QVGATE
    t_part = time.perf_counter()
    kraus = two_qubit_depolarizing(noise, QV_DEPOL)
    nqvm = noisy_qvm(QVM, "QVGATE", kraus, seed=S13_SEED + 1,
                     dtype=torch.complex64, device=dev)
    for c in counters:
        c.launches = 0
    log_n = []
    with per_depth_clock(qv, nqvm, log_n):
        t0 = time.perf_counter()
        res_nc = qv.measure_quantum_volume(
            nqvm, qubits=range(QV13_QUBITS), num_circuits=QV13_CIRCUITS,
            num_shots=QV13_SHOTS, rng=np.random.RandomState(1))
        wall_nc = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_nb = qv.measure_quantum_volume_batched(
        torch.Generator(device=dev).manual_seed(S13_SEED + 2),
        max_depth=QV13_QUBITS, num_circuits=QV13_CIRCUITS,
        num_shots=QV13_SHOTS, kraus=kraus, device=dev)
    torch.cuda.synchronize()
    wall_nb = time.perf_counter() - t0
    for row in log_n:
        print(f"timing noisy QV from circuits depth {row['depth']}: "
              f"{row['circuits_per_s']:.1f} circuits/s (qvm.run "
              f"{row['simulation_s']:.3f} s of {row['host_s']:.3f}); cache "
              f"{row['cache_hits']} hits, {row['cache_misses']} misses")
    qv_nc, qv_nb = (int(qv.extract_quantum_volume_from_results(r))
                    for r in (res_nc, res_nb))
    print(f"main path noisy config 5 (p = {QV_DEPOL}): per-circuit depths "
          f"{sorted(map(int, res_nc))} in {wall_nc:.3f} s, QV {qv_nc}; batched "
          f"depths "
          f"{sorted(res_nb)} in {wall_nb:.3f} s, QV {qv_nb}, kernel "
          f"launches ideal {ideal.launches} trajectory {traj.launches} on "
          f"{card}")
    within_widths(res_nc, res_nb, "noisy")
    check(qv_nc < 2 ** QV13_QUBITS and qv_nb < 2 ** QV13_QUBITS,
          f"noisy QV {qv_nc} / {qv_nb}")
    check(ideal.launches == len(res_nb), f"noisy batched QV: "
          f"{ideal.launches} ideal launches for {len(res_nb)} depths")
    check(traj.launches == sum(d > 6 for d in res_nb),
          f"noisy batched QV: {traj.launches} trajectory launches")
    record["noisy"] = dict(per_depth=log_n, host_s=wall_nc,
                           batched_s=wall_nb, qv=qv_nc, qv_batched=qv_nb,
                           results={int(d): v for d, v in res_nc.items()},
                           results_batched={int(d): v
                                            for d, v in res_nb.items()},
                           part_s=time.perf_counter() - t_part)

    # (c) the router: an 8-qubit line with noisy SWAPs against all-to-all
    t_part = time.perf_counter()
    line = [(q, q + 1) for q in range(QV13_QUBITS - 1)]
    router = qv.topology_restricted_program_generator(line)
    routed = []

    def recording(*args):
        routed.append(router(*args))
        return routed[-1]
    swap_kraus = two_qubit_depolarizing(noise, ROUTER_SWAP_DEPOL)
    runs = {}
    for name, gen_ in (("line", recording), ("all-to-all", None)):
        sqvm = noisy_qvm(QVM, "SWAP", swap_kraus, seed=S13_SEED + 3,
                         dtype=torch.complex64, device=dev)
        t0 = time.perf_counter()
        runs[name] = qv.measure_quantum_volume(
            sqvm, qubits=qubits, program_generator=gen_,
            num_circuits=QV13_CIRCUITS, num_shots=QV13_SHOTS,
            depths=np.array([ROUTER_DEPTH]),
            rng=np.random.RandomState(2))[ROUTER_DEPTH]
        runs[name] += (time.perf_counter() - t0,)
    swaps = sum(g.name == "SWAP" for c in routed for g in c.gates)
    off_line = [g for c in routed for g in c.gates
                if len(g.qubits) == 2 and abs(g.qubits[0] - g.qubits[1]) != 1]
    print(f"router: depth {ROUTER_DEPTH} on an {QV13_QUBITS}-qubit line, "
          f"{len(routed)} circuits, {swaps} SWAPs, heavy-output probability "
          f"{runs['line'][0]:.4f} ({runs['line'][2]:.3f} s) against "
          f"all-to-all {runs['all-to-all'][0]:.4f} "
          f"({runs['all-to-all'][2]:.3f} s); {len(off_line)} 2Q gates off "
          f"the line on {card}")
    check(len(routed) == QV13_CIRCUITS and not off_line,
          f"router: {len(off_line)} gates off the line")
    check(runs["line"][0] < runs["all-to-all"][0],
          f"router: line {runs['line'][0]} not below all-to-all "
          f"{runs['all-to-all'][0]}")
    record["router"] = dict(swaps=swaps, line=runs["line"],
                            all_to_all=runs["all-to-all"],
                            part_s=time.perf_counter() - t_part)

    # (d) entangled states on the card
    t_part = time.perf_counter()
    program, nodes = entangled_states.create_ghz_program(GHZ_TREE)
    stats = entangled_states.ghz_state_statistics(
        qvm.run(program, nodes, GHZ_SHOTS))
    share = stats["bell"] / stats["total"]
    cycle = [(q, (q + 1) % CYCLE) for q in range(CYCLE)]
    graph_state = entangled_states.create_graph_state(cycle)
    stab = []
    for v in range(CYCLE):
        term = sX(v) * sZ((v - 1) % CYCLE) * sZ((v + 1) % CYCLE)
        stab.append(qvm.expectation(graph_state, list(range(CYCLE)), term))
    stab_err = max(abs(x - 1) for x in stab)
    compiled, meas = entangled_states.compiled_parametric_graph_state(
        cycle, 0, theta=0.5)
    names = sorted({g.name for g in compiled.gates})
    uncompiled = graph_state + entangled_states.measure_graph_state(
        cycle, 0, theta=0.5)[0]
    comp_err = (qvm.probabilities(compiled, meas).cpu().double()
                - QVM(device="cpu").probabilities(uncompiled, meas)
                ).abs().max().item()
    print(f"entangled states: GHZ on the {len(nodes)}-qubit tree "
          f"{GHZ_TREE}: share {share:.4f} of {GHZ_SHOTS} shots; "
          f"{CYCLE}-cycle graph state: max |<K_v> - 1| = {stab_err:.2e}; "
          f"compiled graph state ({len(compiled.gates)} gates, {names}): "
          f"card against the uncompiled program on the CPU {comp_err:.2e} "
          f"on {card}")
    check(share > 0.99, f"GHZ share {share}")
    check(stab_err <= STABILIZER_BAR, f"graph-state stabilizers {stab}")
    check(set(names) <= {"RX", "RZ", "CZ", "XY", "I"},
          f"compiled graph state gates {names}")
    check(comp_err <= STABILIZER_BAR, f"compiled graph state {comp_err}")
    record["entangled"] = dict(ghz_share=share, stabilizer_err=stab_err,
                               compiled_err=comp_err,
                               part_s=time.perf_counter() - t_part)

    # (e) the 3-bit adder in both bases, then with noisy readout
    t_part = time.perf_counter()
    adder, hamming = {}, []
    for name, run_qvm, x_basis in (
            ("Z", qvm, False), ("X", qvm, True),
            ("Z readout", QVM(seed=S13_SEED + 4, dtype=torch.complex64,
                              device=dev), False)):
        if name == "Z readout":
            real_run = run_qvm.run

            def with_readout(circuit, qs, shots, real_run=real_run):
                noisy = circuit.copy()
                for q in qs:
                    noisy.define_noisy_readout(q, *ADDER_READOUT)
                return real_run(noisy, qs, shots)
            run_qvm.run = with_readout
        planned, before = Planned(run_qvm), executor_cache_info()
        t0 = time.perf_counter()
        results = classical_logic.get_n_bit_adder_results(
            run_qvm, ADDER_BITS, in_x_basis=x_basis, num_shots=ADDER_SHOTS)
        wall = time.perf_counter() - t0
        del run_qvm._plan
        after = executor_cache_info()
        probs = classical_logic.get_success_probabilities_from_results(
            results)
        adder[name] = dict(
            pairs=len(probs), mean_success=float(np.mean(probs)),
            min_success=float(np.min(probs)), host_s=wall,
            circuits_per_s=planned.count / wall,
            cache_hits=after["hits"] - before["hits"],
            cache_misses=after["misses"] - before["misses"])
        hamming = classical_logic.get_error_hamming_distributions_from_results(
            results)
        print(f"adder {ADDER_BITS}-bit {name} basis: {len(probs)} summand "
              f"pairs, success mean {np.mean(probs):.4f} min "
              f"{np.min(probs):.4f}; {planned.count} circuits in {wall:.3f} "
              f"s ({planned.count / wall:.1f} circuits/s), executor cache "
              f"{adder[name]['cache_hits']} hits, "
              f"{adder[name]['cache_misses']} misses on {card}")
        check(len(probs) == 4 ** ADDER_BITS, f"adder {name}: {len(probs)}")
        if name != "Z readout":
            check(min(probs) == 1.0, f"adder {name}: success {min(probs)}")
    print("adder with noisy readout: mean error Hamming-weight "
          f"distribution {np.round(np.mean(hamming, axis=0), 4).tolist()}")
    record["adder"] = dict(adder, part_s=time.perf_counter() - t_part)

    # (f) the sharded entry points, with the kernels
    t_part = time.perf_counter()
    mesh1, mesh2 = make_mesh(), make_mesh([dev, dev])
    print(f"sharding: make_mesh() has {len(mesh1.devices)} device(s); the "
          f"2-shard mesh repeats {dev} (its shards run one after the other "
          f"on one stream)")
    g = torch.Generator(device=dev).manual_seed(S13_SEED + 5)
    a = torch.tensor(process_tomo_A_matrix(2), dtype=torch.complex64,
                     device=dev)
    a_pinv = torch.linalg.pinv(a)
    n, _ = synth_process_datasets(g, a, 4, BATCH, SHOTS)
    cfg = lanes_apg.HEADLINE_TUNED_2Q
    ms_u, want = cuda_ms(lambda: lanes_apg.apg_fused(a, n, 4, a_pinv=a_pinv,
                                                     **cfg))
    rec_f = {"apg_unsharded_ms": ms_u}
    for mesh in (mesh1, mesh2):
        shards = len(mesh.devices)
        for c in counters:
            c.launches = 0
        got = lanes_apg.apg_fused_sharded(a, n, mesh, dim=4, a_pinv=a_pinv,
                                          **cfg)
        torch.cuda.synchronize()
        moved = lanes_apg.apg_fused.launches
        ms_s, _ = cuda_ms(lambda: lanes_apg.apg_fused_sharded(
            a, n, mesh, dim=4, a_pinv=a_pinv, **cfg))
        equal = torch.equal(got, want)
        print(f"apg_fused_sharded: B={BATCH} headline on {shards} shard(s): "
              f"{moved} kernel launches, bitwise equal to apg_fused: "
              f"{equal} (max |diff| {(got - want).abs().max().item():.3e}); "
              f"{ms_s:.3f} ms against {ms_u:.3f} ms unsharded (CUDA events) "
              f"on {card}")
        check(moved == shards, f"apg_fused_sharded: {moved} launches for "
              f"{shards} shards")
        check(equal, f"apg_fused_sharded on {shards} shards differs")
        rec_f[f"apg_{shards}_shards_ms"] = ms_s

    kraus_t = torch.tensor(two_qubit_depolarizing(noise, QV_DEPOL),
                           dtype=torch.complex64, device=dev)
    parent = torch.Generator(device=dev).manual_seed(S13_SEED + 6)
    per = QV_CIRCUITS // 2
    for label, kw in (("ideal", {}), ("trajectory", dict(
            kraus=kraus_t, noisy_method="trajectory",
            num_trajectories=QV_TRAJ))):
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        got = qv.sample_heavy_outputs_sharded(
            parent, mesh2, depth=QV_DEPTH, num_circuits=QV_CIRCUITS,
            num_shots=QV_SHOTS, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        moved = (ideal.launches, traj.launches)
        want = torch.cat([qv.sample_heavy_outputs_batched(
            fold_in(parent, i, dev), QV_DEPTH, per, QV_SHOTS, device=dev,
            **kw) for i in range(2)])
        equal = torch.equal(got, want)
        prob = got.sum().item() / (QV_CIRCUITS * QV_SHOTS)
        print(f"sample_heavy_outputs_sharded {label}: depth {QV_DEPTH}, "
              f"C={QV_CIRCUITS} on 2 shards, heavy-output probability "
              f"{prob:.4f}, launches ideal {moved[0]} trajectory "
              f"{moved[1]}, bitwise equal to the per-shard runs: {equal}; "
              f"host clock {1e3 * wall:.3f} ms on {card}")
        check(equal, f"sample_heavy_outputs_sharded {label} differs")
        check(moved == (2, 2 if kw else 0), f"sharded QV {label}: {moved}")
        rec_f[f"qv_{label}"] = dict(probability=prob, host_ms=1e3 * wall,
                                    launches=moved)

    c0, c1 = (rand_map_with_BCSZ_dist(g, 4, 16, batch=(DNORM_BATCH,),
                                      dtype=torch.float32) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = lanes_dnorm.dnorm_fused(c0, c1)
    torch.cuda.synchronize()
    wall_u = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = lanes_dnorm.dnorm_fused_sharded(c0, c1, mesh2)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    err = (got - want).abs().max().item()
    print(f"dnorm_fused_sharded: B={DNORM_BATCH} on 2 shards, max |sharded "
          f"- unsharded| {err:.3e} (bar {DNORM_BAR}); host clock {wall_s:.3f}"
          f" s against {wall_u:.3f} s unsharded on {card}")
    check(got.shape == want.shape and err <= DNORM_BAR,
          f"dnorm_fused_sharded: {err}")
    rec_f.update(dnorm_err=err, dnorm_sharded_s=wall_s,
                 dnorm_unsharded_s=wall_u)

    seqs = rb.generate_rb_experiment_sequences(
        (0,), [d for d in RB_SHARD_DEPTHS for _ in range(4)], random_seed=5)
    ptms, lengths = rb.sequences_to_ptm_stack(seqs, (0,))
    ptms = torch.tensor(ptms, device=dev)
    lengths = torch.tensor(lengths, device=dev)
    noise_ptm = torch.diag(torch.tensor([1.0, 0.9, 0.9, 0.9],
                                        dtype=torch.float64, device=dev))
    want = rb.simulate_rb_survival_batched(ptms, noise_ptm, lengths=lengths)
    got = batch_sharded(lambda shared, batched: rb.simulate_rb_survival_batched(
        batched[0], shared, lengths=batched[1]), mesh2)(
            noise_ptm, (ptms, lengths))
    err = (got - want).abs().max().item()
    print(f"batch_sharded RB simulation: {len(seqs)} sequences on 2 shards, "
          f"max |sharded - unsharded| {err:.3e} (bar 1e-12) on {card}")
    check(err <= 1e-12, f"batch_sharded RB: {err}")
    rec_f.update(rb_err=err, part_s=time.perf_counter() - t_part)
    record["sharding"] = rec_f
    record["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 19: {record['phase_s']:.1f} s")
    return record


# ----------------------------------------------------------------------
# 20. the example scripts of examples_torch/ on the card
# ----------------------------------------------------------------------

EXAMPLES = ("state_and_process_tomography", "quantum_volume",
            "distance_measures", "superoperator_tools",
            "observable_estimation", "randomized_benchmarking",
            "qubit_spectroscopy", "direct_fidelity_estimation",
            "robust_phase_estimation", "readout_characterization",
            "entangled_states", "ripple_carry_adder", "chip_scan", "plotting")
ROUND_OFF = 1e-12      # the scripts compute in float64 / complex128 on the card
# (low, high) of every figure phase 20 holds, by script: the bars of
# tests/test_torch_examples.py and tests/test_torch_examples_protocols.py,
# which hold these tables equal to their own
EXAMPLE_BARS = {
    "state_and_process_tomography": {
        "state_fidelity": (0.95, 1.05), "process_fidelity": (0.85, 1.05)},
    "quantum_volume": {
        "ideal_qv": (16, 16), **{f"ideal_prob_d{d}": (0.75, 0.95)
                                 for d in (2, 3, 4)},
        "per_circuit_prob_d2": (0.7, 0.95), "per_circuit_prob_d3": (0.7, 0.95),
        "line_prob_d3": (0.7, 0.95), "noisy_prob_d2": (0.6, 0.8),
        "noisy_qv": (2, 4)},
    "distance_measures": {
        "fidelity_error": (0, ROUND_OFF), "trace_distance_error": (0, ROUND_OFF),
        "purity_error": (0, ROUND_OFF), "bures_angle_error": (0, ROUND_OFF),
        "process_fidelity_error": (0, ROUND_OFF),
        "entanglement_fidelity_error": (0, ROUND_OFF),
        "diamond_norm_error": (0, 1e-4), "watrous_error": (0, ROUND_OFF)},
    "superoperator_tools": {
        "cptp": (1, 1), "unital": (0, 0), "chi00_error": (0, ROUND_OFF),
        "ptm_error": (0, ROUND_OFF), "apply_agreement": (0, ROUND_OFF),
        "corrupted_cptp": (0, 0), "repaired_cptp": (1, 1),
        "unitarity": (0, ROUND_OFF), "ginibre_purity": (0.5, 1),
        "bures_purity": (0.5, 1), "bcsz_cptp": (1, 1)},
    "observable_estimation": {
        "runs_ungrouped": (4, 4), "runs_grouped": (3, 3),
        "ideal_correlator_error": (0, 0.05), "ideal_z0": (-0.05, 0.05),
        "calibrated_correlator_error": (0, 0.08)},
    "randomized_benchmarking": {
        "decay_sigmas": (0, 3.0), "irb_lower": (0, 1), "irb_upper": (1, 2),
        "unitarity_error": (0, 0.02)},
    "qubit_spectroscopy": {
        "t1_error_us": (0, 1.0), "t2_echo_us": (5.5, 33.0),
        "rabi_error": (0, 0.02), "cz_phase_error": (0, 0.05)},
    "direct_fidelity_estimation": {
        "ghz_error": (0, 0.01), "depolarized_error": (0, 0.02),
        "cnot_error": (0, 0.05)},
    "robust_phase_estimation": {"rz_error": (0, 0.05), "rx_error": (0, 0.05)},
    "readout_characterization": {
        "confusion_sigmas": (0, 5), "joint_sigmas": (0, 5),
        "marginal_sigmas": (0, 5)},
    "entangled_states": {"ghz_bell_share": (0.99, 1), "zzz_sigmas": (0, 5)},
    "ripple_carry_adder": {
        "success_Z": (1, 1), "success_X": (1, 1), "hamming_weight_0": (1, 1),
        "noisy_success_sigmas": (0, 5)},
    "chip_scan": {
        "worst_p00": (1, 1), "min_state_fidelity": (0.95, 1.05),
        "t1_error_us": (0, 4.0), "max_rb_error": (0, 1e-3),
        "cz_fidelity_error": (0, 0.01)},
    "plotting": {"ptm_diagonal_error": (0, ROUND_OFF),
                 "smallest_png_bytes": (1, math.inf)},
}
READOUT_P00_P11 = (0.97, 0.90)   # readout_characterization's noise
ADDER_P00_P11 = (0.95, 0.92)     # ripple_carry_adder's noisy readout
EXAMPLE_BUDGET_S = 90


def binomial_sigmas(est, truth, shots) -> float:
    """The largest |est - truth| over the entries, in binomial sigma of
    ``shots`` shots a row."""
    truth = np.asarray(truth, dtype=float)
    return float(np.max(np.abs(np.asarray(est) - truth)
                        / np.sqrt(truth * (1 - truth) / shots)))


def example_figures(name: str, out: dict) -> dict:
    """The figures of ``examples_torch/<name>.py`` that phase 20 holds to
    ``EXAMPLE_BARS[name]``, from what its ``main`` returns (the figures it
    prints), as distances from the analytic or injected values where the
    bar is one."""
    f = {k: float(v) for k, v in out.items() if np.ndim(v) == 0}
    err = lambda value, want: float(np.max(np.abs(np.asarray(value) - want)))
    if name == "distance_measures":
        want = dict(fidelity=0.5, trace_distance=0.5, purity=0.5,
                    bures_angle=np.pi / 4, process_fidelity=0.9,
                    entanglement_fidelity=0.85, diamond_norm=0.3)
        f = {f"{k}_error": err(out[k], v) for k, v in want.items()}
        # the nuclear norm of the Choi difference, 3p, and d^2 times it
        f["watrous_error"] = err([out["watrous_lower"], out["watrous_upper"]],
                                 [0.6, 2.4])
    elif name == "superoperator_tools":
        p = 0.1      # amplitude damping
        f["chi00_error"] = err(out["chi00"], (1 + np.sqrt(1 - p)) ** 2 / 4)
        f["ptm_error"] = err(out["ptm"], [
            [1, 0, 0, 0], [0, np.sqrt(1 - p), 0, 0],
            [0, 0, np.sqrt(1 - p), 0], [p, 0, 0, 1 - p]])
    elif name == "observable_estimation":
        f["ideal_correlator_error"] = err(out["ideal"][:3], [1, -1, 1])
        f["ideal_z0"] = float(out["ideal"][3])
        f["calibrated_correlator_error"] = err(out["calibrated"][:3],
                                               [1, -1, 1])
    elif name == "randomized_benchmarking":
        f["decay_sigmas"] = abs(out["decay"] - 0.9) / out["decay_stderr"]
        f["unitarity_error"] = abs(out["unitarity"] - 1)
    elif name == "qubit_spectroscopy":
        phase = out["cz_phase"] % (2 * np.pi)
        f = {"t1_error_us": abs(out["t1_us"] - 18.0),
             "t2_echo_us": out["t2_echo_us"],
             "rabi_error": abs(out["rabi_ratio"] - 1),
             "cz_phase_error": min(phase, 2 * np.pi - phase)}
    elif name == "direct_fidelity_estimation":
        f = {"ghz_error": abs(out["ghz"] - 1),
             "depolarized_error": abs(out["depolarized"] - (1 - 0.15 / 2)),
             "cnot_error": abs(out["cnot"] - 1)}
    elif name == "robust_phase_estimation":
        f = {"rz_error": abs(out["rz"] - 1.234),
             "rx_error": abs(out["rx"] - 0.777)}
    elif name == "readout_characterization":
        p00, p11 = READOUT_P00_P11
        one = np.array([[p00, 1 - p00], [1 - p11, p11]])
        f = {"confusion_sigmas": binomial_sigmas(out["confusion"], one, 20000),
             "joint_sigmas": binomial_sigmas(out["joint"], np.kron(one, one),
                                             5000),
             "marginal_sigmas": binomial_sigmas(out["marginal"], one, 10000)}
    elif name == "entangled_states":
        # the parity of 2000 shots has variance (1 - <ZZZ>^2) / 2000
        want = np.asarray(out["zzz_expected"])
        f["zzz_sigmas"] = float(np.max(
            np.abs(out["zzz"] - want)
            / np.sqrt(np.maximum(1 - want ** 2, 1e-12) / 2000)))
    elif name == "ripple_carry_adder":
        f["hamming_weight_0"] = float(out["hamming"][0])
        # every summand pair of 2 bits, its 3-bit sum read bit by bit
        p00, p11 = ADDER_P00_P11
        want = np.mean([np.prod([p11 if (a + b) >> k & 1 else p00
                                 for k in range(3)])
                        for a in range(4) for b in range(4)])
        f["noisy_success_sigmas"] = binomial_sigmas(out["success_noisy"],
                                                    want, 16 * 100)
    elif name == "chip_scan":
        f["t1_error_us"] = err(out["t1_us"], 20.0)
        f["cz_fidelity_error"] = err(out["cz_fidelity"], 1.0)
    elif name == "plotting":
        f = {"ptm_diagonal_error": err(out["ptm_diagonal"], [1, .7, .7, .7]),
             "smallest_png_bytes": float(np.min(out["png_bytes"]))}
    return {k: f[k] for k in EXAMPLE_BARS[name]}


def example_failures(name: str, figures: dict) -> list:
    """The figures of ``name`` outside their bars, as text."""
    return [f"{name}: {k} = {v!r} outside [{lo}, {hi}]"
            for k, v in figures.items()
            for lo, hi in [EXAMPLE_BARS[name][k]] if not lo <= v <= hi]


def load_example(name: str):
    """The module of ``examples_torch/<name>.py`` (``main`` not run)."""
    import importlib.util
    path = pathlib.Path(__file__).resolve().parent / "examples_torch" / \
        f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def agg_rgba(fig) -> np.ndarray:
    """The RGBA buffer of a figure drawn by Agg."""
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba()).copy()


def plotting_on_the_card(module, dev: torch.device, out_dir: str, buf):
    """Run the plotting example, its lines into ``buf``. Without
    matplotlib: as far as its first figure call, which must raise
    ImportError (and so must the port's ``hinton``); returns the figures
    held then. With it: the whole script, and the three figures drawn from
    the card's tensors must be bitwise those drawn from the same tensors on
    the CPU."""
    from forest_benchmarking_tpu_torch.plotting import hinton
    bell, plus_pl, ptm = module.figures(dev)
    ptm_error = float((torch.diagonal(ptm).cpu()
                       - torch.tensor([1, .7, .7, .7], dtype=ptm.dtype))
                      .abs().max())
    try:
        import matplotlib
    except ImportError:
        for call, says in ((lambda: module.main(device=dev, out_dir=out_dir),
                            "matplotlib"),
                           (lambda: hinton(bell), "plotting needs matplotlib")):
            try:
                with contextlib.redirect_stdout(buf):
                    call()
            except ImportError as err:
                check(says in str(err), str(err))
            else:
                raise SmokeFailure("plotting drew without matplotlib")
        print("plotting example: not drawn, no matplotlib on this machine")
        return None, {"ptm_diagonal_error": ptm_error}
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    with contextlib.redirect_stdout(buf):
        out = module.main(device=dev, out_dir=out_dir)
    card = module.draw(bell, plus_pl, ptm)
    host = module.draw(bell.cpu(), plus_pl.cpu(), ptm.cpu())
    for name in card:
        same = np.array_equal(agg_rgba(card[name]), agg_rgba(host[name]))
        print(f"plotting example: {name} from the card's tensors "
              f"{'bitwise equal to' if same else 'DIFFERS from'} the CPU's")
        check(same, f"plotting: {name} differs between card and CPU tensors")
    plt.close("all")
    return out, None


def phase_examples(card: str, dev: torch.device) -> dict:
    """20. Every script of examples_torch/ on the card; see the module
    docstring."""
    t_phase = time.perf_counter()
    out_dir = pathlib.Path("build") / "examples"
    out_dir.mkdir(parents=True, exist_ok=True)
    counters = port_launches()
    record, failures = {}, []
    for name in EXAMPLES:
        module = load_example(name)
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        before = {c.__name__: c.launches for c in counters}
        buf = io.StringIO()
        t0 = time.perf_counter()
        if name == "plotting":
            out, figures = plotting_on_the_card(module, dev, str(out_dir), buf)
        else:
            with contextlib.redirect_stdout(buf):
                out = module.main(device=dev, out_dir=str(out_dir))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        after = {c.__name__: c.launches for c in counters}
        if out is not None:
            figures = example_figures(name, out)
        failures += example_failures(name, figures)
        record[name] = {"s": seconds, "launches": after}
        print(f"example {name}: {seconds:.3f} s (host) on {card}; kernel "
              f"launches before {before}, after {after}")
        for line in buf.getvalue().splitlines():
            print(f"  | {line}")
        print(f"  figures: {json.dumps(figures, default=float)}")
    moved = record["quantum_volume"]["launches"]
    print(f"quantum_volume example: {moved['ideal_probs']} ideal-kernel "
          f"launches; its noisy batched scan took the "
          f"{'trajectory kernel' if moved['traj_probs'] else 'density method'}")
    check(moved["ideal_probs"] > 0,
          "quantum_volume example: the ideal QV kernel was not launched")
    check(not failures, "; ".join(failures))
    record["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 20: {record['phase_s']:.1f} s (budget "
          f"{EXAMPLE_BUDGET_S} s)")
    return record


# ----------------------------------------------------------------------
# 21. the notebooks of examples_torch/notebooks/ on the card
# ----------------------------------------------------------------------

NOTEBOOKS = ("chip_scan", "direct_fidelity_estimation", "distance_measures",
             "entangled_states", "hinton_plots", "observable_estimation",
             "quantum_volume", "quantum_volume_noisy",
             "qubit_spectroscopy_cz_ramsey", "qubit_spectroscopy_rabi",
             "qubit_spectroscopy_t1", "qubit_spectroscopy_t2",
             "random_operators", "randomized_benchmarking",
             "randomized_benchmarking_interleaved",
             "randomized_benchmarking_unitarity", "readout_error_estimation",
             "ripple_adder_benchmark", "robust_phase_estimation",
             "state_and_process_plots", "superoperator_tools",
             "tomography_process", "tomography_state")
# (low, high) of every quantity phase 21 holds, by notebook: the bars of
# tests/test_torch_notebooks*.py, which hold this table equal to their own
NOTEBOOK_BARS = {
    "chip_scan": {
        "worst_p00": (0.95, 1), "min_state_fidelity": (0.95, 1.05),
        "t1_error_us": (0, 10.0), "max_rb_error": (0, 0.05),
        "min_cz_fidelity": (0.9, 1.05)},
    "direct_fidelity_estimation": {
        "ghz_error": (0, 0.02), "depolarized_error": (0, 0.02),
        "cnot_error": (0, 0.05), "exhaustive_settings_error": (0, 0)},
    "distance_measures": {
        "states_error": (0, ROUND_OFF), "chernoff_error": (0, 1e-2),
        "fuchs_van_de_graaf": (1, 1), "infidelity_error": (0, ROUND_OFF),
        "diamond_error": (0, 1e-4), "watrous_error": (0, ROUND_OFF),
        "entanglement_fidelity_error": (0, ROUND_OFF),
        "tvd_error": (0, ROUND_OFF)},
    "entangled_states": {
        "ghz_bell_share": (0.99, 1), "parity_sigmas": (0, 5),
        "local_sigmas": (0, 5)},
    "hinton_plots": {"ptm_error": (0, ROUND_OFF)},
    "observable_estimation": {
        "runs_grouped": (3, 3), "ideal_correlator_error": (0, 0.05),
        "ideal_z0": (-0.08, 0.08), "raw_stabilizer_max": (0.6, 0.85),
        "calibrated_sigmas": (0, 4), "y_on_plus_x": (-0.11, 0.11)},
    "quantum_volume": {
        "qv": (32, 32), **{f"prob_d{d}": (0.75, 0.95) for d in (2, 3, 4, 5)},
        "per_circuit_prob_d2": (0.7, 0.95), "per_circuit_prob_d3": (0.7, 0.95),
        "per_circuit_gap": (0, 0.05)},
    "quantum_volume_noisy": {
        "ideal_qv": (2, 16), "noisy_qv": (1, 16),
        **{f"ideal_prob_d{d}": (0.7, 0.95) for d in (2, 3, 4)},
        **{f"noisy_prob_d{d}": (0.6, 0.9) for d in (2, 3, 4)},
        "density_fraction": (0.6, 0.9), "trajectory_fraction": (0.6, 0.9),
        "density_trajectory_gap": (0, 0.05)},
    "qubit_spectroscopy_cz_ramsey": {
        "ideal_offset_sigmas": (0, 5), "injected_sigmas": (0, 5)},
    "qubit_spectroscopy_rabi": {
        "ratio_sigmas": (0, 5), "overdrive_sigmas": (0, 5)},
    "qubit_spectroscopy_t1": {
        "t1_error_q0_us": (0, 3.0), "t1_error_q1_us": (0, 6.0)},
    "qubit_spectroscopy_t2": {
        "t2_star_us": (6.0, 48.0), "t2_echo_us": (6.0, 36.0),
        "frequency_error_mhz": (0, 0.05)},
    "random_operators": {
        "unitarity": (0, 1e-10), "trace_sigmas": (0, 5),
        "overlap_sigmas": (0, 3), "purity_gap": (0, 1),
        "rank2_tail": (0, 1e-10)},
    "randomized_benchmarking": {
        "decay_sigmas": (0, 3), "simultaneous_sigmas": (0, 3),
        "ptm_decay_error": (0, 1e-6)},
    "randomized_benchmarking_interleaved": {
        "decay_sigmas": (0, 3), "irb_lower": (0, 1), "irb_upper": (1, 2)},
    "randomized_benchmarking_unitarity": {
        "decay_sigmas": (0, 3), "unitarity_sigmas": (0, 4),
        "coherent_unitarity": (0.99, 1.06)},
    "readout_error_estimation": {
        "confusion_sigmas": (0, 5), "joint_sigmas": (0, 5),
        "marginal_sigmas": (0, 5)},
    "ripple_adder_benchmark": {
        "success_Z": (1, 1), "success_X": (1, 1),
        "noisy_success_sigmas": (0, 5)},
    "robust_phase_estimation": {
        "rz_error": (0, 0.05), "rx_error": (0, 0.05),
        "deepest_error_over_bound": (0, 3), "radius_error": (0, 0.1)},
    "state_and_process_plots": {
        "coords_error": (0, ROUND_OFF), "ptm_error": (0, ROUND_OFF),
        "cz_square_error": (0, ROUND_OFF)},
    "superoperator_tools": {
        "chi00_error": (0, ROUND_OFF), "round_trip": (0, ROUND_OFF),
        "apply_agreement": (0, ROUND_OFF), "kraus_recovered": (2, 2),
        "cptp": (1, 1), "unital": (0, 0), "corrupted_cptp": (0, 0),
        "repaired_cptp": (1, 1), "rank1_purity_error": (0, ROUND_OFF),
        "rank2_mean_purity": (0.5, 1)},
    "tomography_process": {
        "state_fidelity": (0.95, 1.05), "process_fidelity": (0.85, 1.05),
        "noisy_process_fidelity": (0.8, 0.99)},
    "tomography_state": {
        "mle_fidelity": (0.95, 1.05), "mle_min_eigenvalue": (-1e-9, 1),
        "bootstrap_purity_error": (0, 0.03), "bootstrap_fidelity": (0.95, 1.05)},
}
NOTEBOOK_BUDGET_S = 120
NB_P00_P11 = {"observable_estimation": (0.95, 0.90),
              "readout_error_estimation": (0.97, 0.90),
              "ripple_adder_benchmark": (0.95, 0.92)}


def notebook_figures(name: str, ns: dict) -> dict:
    """The quantities of ``examples_torch/notebooks/<name>.ipynb`` that
    phase 21 holds to ``NOTEBOOK_BARS[name]``, read from the namespace its
    cells leave (what they print), as distances from the analytic or
    injected values where the bar is one."""
    err = lambda value, want: float(np.max(np.abs(
        np.asarray(value, dtype=float) - np.asarray(want, dtype=float))))
    sig = lambda value, want, stderr: float(abs(value - want) / stderr)
    f = {}
    if name == "chip_scan":
        f = {"worst_p00": min(ns["p00"].values()),
             "min_state_fidelity": min(ns["fids"].values()),
             "t1_error_us": err(list(ns["t1s"].values()), 20.0),
             "max_rb_error": max(ns["errors"].values()),
             "min_cz_fidelity": min(ns["cz_fids"].values())}
    elif name == "direct_fidelity_estimation":
        p = ns["p"]
        f = {"ghz_error": abs(ns["ghz_fid"] - 1),
             "depolarized_error": abs(ns["dep_fid"] - (1 - p / 2)),
             "cnot_error": abs(ns["cnot_fid"] - 1),
             "exhaustive_settings_error": err(
                 ns["exh_counts"], [2 ** n - 1 for n in ns["ns"]])}
    elif name == "distance_measures":
        s = ns["states"]
        ps = ns["ps"]
        f = {"states_error": err(
                [s["fidelity"], s["trace_distance"], s["purity"],
                 s["bures_angle"], s["bures_distance"],
                 s["hilbert_schmidt_ip"]],
                [0.5, 0.5, 0.5, np.pi / 4, np.sqrt(2 - np.sqrt(2)), 0.5]),
             "chernoff_error": abs(float(ns["qcb"]) - 0.5),
             "fuchs_van_de_graaf": float(np.all(
                 (1 - np.sqrt(ns["Fs"]) <= ns["Ts"] + 1e-12)
                 & (ns["Ts"] <= np.sqrt(1 - ns["Fs"]) + 1e-12))),
             "infidelity_error": err(
                 ns["infid_dep"] + ns["infid_rot"],
                 list(np.maximum(ps, 1e-9) / 2)
                 + list(2 * np.sin(ps / 2) ** 2 / 3)),
             "diamond_error": err(ns["dn_dep"] + ns["dn_rot"],
                                  list(1.5 * np.maximum(ps, 1e-9))
                                  + list(2 * np.sin(ps / 2))),
             "watrous_error": err([ns["lo"], ns["hi"]], [0.6, 2.4]),
             "entanglement_fidelity_error": abs(ns["ent_fid"] - 0.85),
             "tvd_error": abs(ns["tvd"] - 0.075)}
    elif name == "entangled_states":
        st = ns["stats"]
        want = -np.sin(ns["thetas"])
        f = {"ghz_bell_share": st["bell"] / st["total"],
             "parity_sigmas": float(np.max(
                 np.abs(np.asarray(ns["parities"]) - want)
                 / np.sqrt(np.maximum(1 - want ** 2, 1e-12) / 1500))),
             "local_sigmas": float(np.max(np.abs(ns["locals_"]))
                                   / np.sqrt(1 / 1500))}
    elif name == "hinton_plots":
        p = ns["p"]
        f = {"ptm_error": err(ns["ptm"], [
            [1, 0, 0, 0], [0, np.sqrt(1 - p), 0, 0],
            [0, 0, np.sqrt(1 - p), 0], [p, 0, 0, 1 - p]])}
    elif name == "observable_estimation":
        p00, p11 = NB_P00_P11[name]
        ideal = [r.expectation for r in ns["results"]]
        cal = ns["cal"]
        want = [1, -1, 1, (p00 - p11) / (p00 + p11 - 1)]
        f = {"runs_grouped": len(ns["grouped"]),
             "ideal_correlator_error": err(ideal[:3], [1, -1, 1]),
             "ideal_z0": ideal[3],
             "raw_stabilizer_max": float(np.max(np.abs(
                 [r.expectation for r in ns["raw"][:3]]))),
             "calibrated_sigmas": max(sig(r.expectation, w, r.std_err)
                                      for r, w in zip(cal, want)),
             "y_on_plus_x": ns["r"].expectation}
    elif name == "quantum_volume":
        res, per = ns["results"], ns["qvm_results"]
        f = {"qv": ns["qv"],
             **{f"prob_d{d}": res[d][0] for d in (2, 3, 4, 5)},
             **{f"per_circuit_prob_d{d}": per[d][0] for d in (2, 3)},
             "per_circuit_gap": max(abs(per[d][0] - res[d][0]) for d in per)}
    elif name == "quantum_volume_noisy":
        ideal, noisy = ns["ideal"], ns["noisy"]
        total = ns["total"]
        f = {"ideal_qv": ns["ideal_qv"], "noisy_qv": ns["noisy_qv"],
             **{f"ideal_prob_d{d}": ideal[d][0] for d in (2, 3, 4)},
             **{f"noisy_prob_d{d}": noisy[d][0] for d in (2, 3, 4)},
             "density_fraction": ns["n_dens"] / total,
             "trajectory_fraction": ns["n_traj"] / total,
             "density_trajectory_gap": abs(ns["n_dens"] - ns["n_traj"])
             / total}
    elif name == "qubit_spectroscopy_cz_ramsey":
        off = ns["fit"].params["offset"]
        bad = ns["off"]
        f = {"ideal_offset_sigmas": abs(off.value) / off.stderr,
             "injected_sigmas": abs(abs(bad.value) - ns["phi"])
             / max(bad.stderr, 2e-2)}
    elif name == "qubit_spectroscopy_rabi":
        fr = ns["fit"].params["frequency"]
        ratio = ns["ratio"]
        f = {"ratio_sigmas": abs(fr.value - 1) / fr.stderr,
             "overdrive_sigmas": abs(ratio.value - ns["overdrive"])
             / max(ratio.stderr, 1e-3)}
    elif name == "qubit_spectroscopy_t1":
        t1s = ns["t1s"]
        f = {"t1_error_q0_us": abs(t1s[0] - 18.0),
             "t1_error_q1_us": abs(t1s[1] - 32.0)}
    elif name == "qubit_spectroscopy_t2":
        f = {"t2_star_us": ns["t2_stars"][0],
             "t2_echo_us": ns["t2_echoes"][0],
             "frequency_error_mhz": abs(
                 ns["fit"].params["frequency"].value - 1)}
    elif name == "random_operators":
        tr2, F = ns["tr2"], ns["F"]
        purity = ns["purity"]
        f = {"unitarity": float(ns["unitarity"]),
             "trace_sigmas": abs(tr2.mean() - 1)
             / (tr2.std() / np.sqrt(len(tr2))),
             "overlap_sigmas": abs(F.mean() - 1 / ns["d"])
             / (F.std() / np.sqrt(len(F))),
             "purity_gap": float(purity(ns["rho_bu"]).mean()
                                 - purity(ns["rho_hs"]).mean()),
             "rank2_tail": float(np.abs(ns["ev_r2"][:, 2:]).max())}
    elif name == "randomized_benchmarking":
        decay = ns["fit"].params["decay"]
        f = {"decay_sigmas": sig(decay.value, ns["expected_decay"],
                                 decay.stderr),
             "simultaneous_sigmas": max(
                 sig(v, ns["injected"][g], e)
                 for g, (v, e) in ns["simultaneous"].items()),
             "ptm_decay_error": abs(ns["fit2"].params["decay"].value
                                    - ns["p_noise"])}
    elif name == "randomized_benchmarking_interleaved":
        decay = ns["fit"].params["decay"]
        f = {"decay_sigmas": sig(decay.value, ns["expected_decay"],
                                 decay.stderr),
             "irb_lower": ns["lo"], "irb_upper": ns["hi"]}
    elif name == "randomized_benchmarking_unitarity":
        decay = ns["rb_fit"].params["decay"]
        u = ns["u_fit"].params["decay"]
        f = {"decay_sigmas": sig(decay.value, ns["expected_decay"],
                                 decay.stderr),
             "unitarity_sigmas": sig(u.value, ns["expected_decay"] ** 2,
                                     u.stderr),
             "coherent_unitarity": ns["u_c"]}
    elif name == "readout_error_estimation":
        p00, p11 = NB_P00_P11[name]
        one = np.array([[p00, 1 - p00], [1 - p11, p11]])
        f = {"confusion_sigmas": binomial_sigmas(ns["cm"], one, 20000),
             "joint_sigmas": binomial_sigmas(ns["cm01"], np.kron(one, one),
                                             5000),
             "marginal_sigmas": binomial_sigmas(ns["marg"], one, 10000)}
    elif name == "ripple_adder_benchmark":
        p00, p11 = NB_P00_P11[name]
        want = np.mean([np.prod([p11 if (a + b) >> k & 1 else p00
                                 for k in range(3)])
                        for a in range(4) for b in range(4)])
        f = {"success_Z": ns["success"]["Z"], "success_X": ns["success"]["X"],
             "noisy_success_sigmas": binomial_sigmas(
                 np.mean(ns["probs_n"]), want, 16 * 200)}
    elif name == "robust_phase_estimation":
        f = {"rz_error": abs(ns["estimates"][(0,)] - ns["angle"]),
             "rx_error": abs(ns["est_x"][(0,)] - ns["angle_x"]),
             "deepest_error_over_bound": ns["errs"][-1] / ns["bounds"][-1],
             "radius_error": err(ns["radii"], 1.0)}
    elif name == "state_and_process_plots":
        theta = ns["theta"]
        c, s = np.cos(theta), np.sin(theta)
        f = {"coords_error": err(
                np.concatenate([ns["coords"][k] for k in ns["states"]]),
                [0.5, 0, 0, 0.5, 0.5, 0.5, 0, 0, 0.5, 0, 0, 0]),
             "ptm_error": err(np.stack(list(ns["ptms"].values())), [
                 [[1, 0, 0, 0], [0, 0, 0, 1], [0, 0, -1, 0], [0, 1, 0, 0]],
                 [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, c, -s], [0, 0, s, c]],
                 np.diag([1, 0.7, 0.7, 0.7])]),
             "cz_square_error": err(ns["ptm2"] @ ns["ptm2"], np.eye(16))}
    elif name == "superoperator_tools":
        p = 0.1
        purities = ns["purities"]
        f = {"chi00_error": abs(float(ns["chi"][0, 0].real)
                                - (1 + np.sqrt(1 - p)) ** 2 / 4),
             "round_trip": float((ns["superop2choi"](ns["sop_"])
                                  - ns["choi"]).abs().max()),
             "apply_agreement": float((ns["out_k"] - ns["out_c"])
                                      .abs().max()),
             "kraus_recovered": len(ns["kraus_back"]),
             "cptp": float(ns["choi_is_cptp"](ns["choi"])),
             "unital": float(ns["choi_is_unital"](ns["choi"])),
             "corrupted_cptp": float(ns["choi_is_cptp"](ns["corrupted"])),
             "repaired_cptp": float(ns["choi_is_cptp"](ns["repaired"],
                                                       atol=1e-3)),
             "rank1_purity_error": err(purities[1], 1.0),
             "rank2_mean_purity": float(purities[2].mean())}
    elif name == "tomography_process":
        f = {"state_fidelity": ns["state_fidelity"],
             "process_fidelity": float(ns["pf"].real),
             "noisy_process_fidelity": float(ns["pf_noisy"].real)}
    elif name == "tomography_state":
        f = {"mle_fidelity": ns["fids"]["MLE"],
             "mle_min_eigenvalue": ns["min_eigs"]["iterative MLE"],
             "bootstrap_purity_error": abs(ns["mean_p"] - float(np.real(
                 np.trace(ns["rho_true"] @ ns["rho_true"])))),
             "bootstrap_fidelity": ns["mean_f"]}
    return {k: float(v) for k, v in f.items()}


def notebook_failures(name: str, figures: dict) -> list:
    """The quantities of ``name`` outside their bars, as text."""
    return [f"{name}: {k} = {v!r} outside [{lo}, {hi}]"
            for k, v in figures.items()
            for lo, hi in [NOTEBOOK_BARS[name][k]] if not lo <= v <= hi]


@functools.lru_cache(maxsize=None)
def load_runner():
    """``examples_torch/notebooks/_runner.py`` as a module (registered as
    ``notebook_runner``)."""
    import importlib.util
    path = pathlib.Path(__file__).resolve().parent / "examples_torch" / \
        "notebooks" / "_runner.py"
    spec = importlib.util.spec_from_file_location("notebook_runner", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def phase_notebooks(card: str, dev: torch.device) -> dict:
    """21. Every notebook of examples_torch/notebooks/ on the card, with the
    runner's default ``DEVICE = "cuda"`` as a user runs them (``dev`` is
    the card that is); see the module docstring."""
    t_phase = time.perf_counter()
    runner = load_runner()
    counters = port_launches()
    drawing = runner.have_matplotlib()
    record, failures = {}, []
    for name in NOTEBOOKS:
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        per_cell = []

        def on_cell(run, per_cell=per_cell):
            per_cell.append((run, {c.__name__: c.launches for c in counters}))

        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            ns, runs = runner.run_notebook(name, on_cell=on_cell)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        after = {c.__name__: c.launches for c in counters}
        figures = notebook_figures(name, ns)
        failures += notebook_failures(name, figures)
        figure_cells = [r for r in runs if r.cell.figure]
        moved, before = {}, {c.__name__: 0 for c in counters}
        for run, seen in per_cell:
            delta = {k: seen[k] - before[k] for k in seen if seen[k] > before[k]}
            if delta:
                moved[run.cell.index] = delta
            before = seen
        record[name] = {"s": seconds, "launches": after,
                        "cells": len(runs), "figure_cells": len(figure_cells),
                        "launches_by_cell": moved}
        print(f"notebook {name}: {seconds:.3f} s (host) on {card}; "
              f"{len(runs)} code cells, {len(figure_cells)} figure cells "
              + ("drawn (Agg)" if drawing else "raised ImportError (no "
                 "matplotlib)")
              + f"; kernel launches {after}, by cell {moved}")
        for line in buf.getvalue().splitlines():
            print(f"  | {line}")
        print(f"  quantities: {json.dumps(figures)}")
    qv = record["quantum_volume"]["launches"]
    print(f"quantum_volume notebook: {qv['ideal_probs']} ideal-kernel "
          f"launches")
    check(qv["ideal_probs"] > 0,
          "quantum_volume notebook: the ideal QV kernel was not launched")
    runner_cells = {c.index: c for c in
                    runner.code_cells("quantum_volume_noisy")}
    traj_cells = [i for i, c in runner_cells.items()
                  if 'noisy_method="trajectory"' in c.source]
    moved = [record["quantum_volume_noisy"]["launches_by_cell"].get(i, {})
             .get("traj_probs", 0) for i in traj_cells]
    print(f"quantum_volume_noisy notebook: trajectory cell(s) {traj_cells} "
          f"launched the trajectory kernel {moved} time(s)")
    check(traj_cells and all(m > 0 for m in moved),
          "quantum_volume_noisy: the trajectory kernel was not launched in "
          "its trajectory cell")
    check(not failures, "; ".join(failures))
    record["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 21: {record['phase_s']:.1f} s (budget {NOTEBOOK_BUDGET_S} "
          f"s) for {len(NOTEBOOKS)} notebooks")
    return record


# ----------------------------------------------------------------------
# 22. the entry step and the multi-device dry run on the card
# ----------------------------------------------------------------------

DRYRUN_DEVICES = 4


def phase_entry(card: str, dev: torch.device) -> dict:
    """22. ``entry.entry()`` once and ``entry.dryrun_multichip(4)`` on the
    card; see the module docstring."""
    t_phase = time.perf_counter()
    from forest_benchmarking_tpu_torch import entry
    counters = port_launches()
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    step, args = entry.entry()
    t0 = time.perf_counter()
    pf, mean_pf = step(*args)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    check(pf.shape == (entry.ENTRY_BATCH,) and bool(torch.isfinite(pf).all()),
          f"entry(): pf {tuple(pf.shape)}")
    step_launches = {c.__name__: c.launches for c in counters}
    print(f"entry(): step at B = {entry.ENTRY_BATCH} ran in {step_s:.3f} s "
          f"(host) on {pf.device}, pf mean {float(mean_pf):.4f}, finite; "
          f"kernel launches {step_launches}")
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    legs = entry.dryrun_multichip(DRYRUN_DEVICES)
    torch.cuda.synchronize()
    dry_s = time.perf_counter() - t0
    moved = {c.__name__: c.launches for c in counters}
    print(f"dryrun_multichip({DRYRUN_DEVICES}): {dry_s:.3f} s (host) on "
          f"{card}; kernel launches {moved}")
    for name in ("apg_fused", "traj_probs", "ideal_probs"):
        check(moved[name] > 0, f"dryrun_multichip: {name} did not launch")
    record = {"step_s": step_s, "step_mean_pf": float(mean_pf),
              "step_launches": step_launches, "dryrun_s": dry_s,
              "dryrun_launches": moved, "legs": legs,
              "phase_s": time.perf_counter() - t_phase}
    print(f"phase 22: {record['phase_s']:.1f} s")
    return record


HARNESS_OUT = "chiprun_out/bench_all.jsonl"
HARNESS_BUDGET_S = 150
LLR_BAR = 4.0                # headline likelihood-ratio statistic (bench.py)
PARITY_DEV_BAR = 1e-6        # fused parity against the tight optimum, f64
# PGDB against the numpy oracle: the JAX receipt's 2.2e-15 times 10. The
# two sum in different orders (MKL and numpy's eigh and products), so the
# gap is round-off of a few ulps of the estimate, 3.6e-15 on a CPU of the
# port's test machine; 10 keeps it at round-off on another CPU's library
ORACLE_BAR = 2.2e-15 * 10
CLOCK_GAP = 1.5              # harness against phase figures: a finding
# bars of PERF.md section 2, by bench_all line: (key, low, high)
SECTION_BARS = {
    "config1": (("mean_fidelity_mle", 0.99, 1.0),),
    "config3": (("mean_decay_error", 0.0, 0.02),),
    "config5_ideal": (("heavy_output_prob", 0.83, 0.87),),
    "config5_noisy_d8": (("heavy_output_prob", 0.60, 0.72),),
    "config5_noisy_d8_t500": (("heavy_output_prob", 0.60, 0.72),),
}


def run_printing(fn, *args):
    """(fn's return, the JSON objects of every line it printed): each line
    is printed again here, prefixed, and must parse."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    parsed = []
    for line in buf.getvalue().splitlines():
        print(f"harness: {line}")
        try:
            parsed.append(json.loads(line))
        except json.JSONDecodeError:
            raise SmokeFailure(f"harness printed a line that is not JSON: "
                               f"{line[:200]}") from None
    return out, parsed


def phase_harness(card: str, dev: torch.device, phase_figures: dict) -> dict:
    """23. ``bench.main()`` and ``bench_all.main()`` at the JAX sizes on the
    card; see the module docstring. ``phase_figures`` maps (line, key) to
    (the same figure per millisecond from an earlier phase, how it was
    taken)."""
    t_phase = time.perf_counter()
    from forest_benchmarking_tpu_torch import bench, bench_all
    counters = port_launches()
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    _, printed = run_printing(bench.main)
    bench_s = time.perf_counter() - t0
    check(len(printed) == 1, f"bench printed {len(printed)} lines, want 1")
    line = printed[0]
    t0 = time.perf_counter()
    _, lines = run_printing(bench_all.main, [HARNESS_OUT])
    torch.cuda.synchronize()
    all_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    print(f"harness: bench {bench_s:.1f} s, bench_all {all_s:.1f} s (lines "
          f"in {HARNESS_OUT}); kernel launches {launches} on {card}")

    sections = [name for name, _ in bench_all.sections()]
    check(len(lines) == len(sections),
          f"bench_all printed {len(lines)} lines, want {len(sections)}")
    by_name = dict(zip(sections, lines))
    check("errors" not in line, f"bench: errors {line.get('errors')}")
    nulls = [k for k, v in line.items() if v is None]
    check(not nulls, f"bench: null figures {nulls}")
    check(line["device"] == card, f"bench: device {line['device']!r}")
    for name, x in by_name.items():
        check("error" not in x and "errors" not in x,
              f"bench_all {name}: {x.get('error') or x.get('errors')}")
        nulls = [k for k, v in x.items() if v is None and not (
            k == "vs_baseline" and name != "config2")]
        check(not nulls, f"bench_all {name}: null figures {nulls}")
    for key in ("mean_rel_frob_err_f32", "mean_rel_frob_err_parity_f32"):
        check(line[key] < 0.12, f"bench: {key} {line[key]}")
    check(line["fused_parity_dev_f64"] < PARITY_DEV_BAR,
          f"bench: fused_parity_dev_f64 {line['fused_parity_dev_f64']}")
    check(line["headline_llr_statistic_f64"] < LLR_BAR,
          f"bench: headline LLR {line['headline_llr_statistic_f64']}")
    check(line["max_deviation_vs_oracle_f64"] <= ORACLE_BAR,
          f"bench: PGDB {line['max_deviation_vs_oracle_f64']} from the "
          f"numpy oracle, bar {ORACLE_BAR:.1e}")
    for name, bars in SECTION_BARS.items():
        for key, lo, hi in bars:
            check(lo <= by_name[name][key] <= hi,
                  f"bench_all {name}: {key} {by_name[name][key]} outside "
                  f"[{lo}, {hi}]")
    check(by_name["config4"]["dnorm_method"] == "fused",
          f"bench_all config4: dnorm_method "
          f"{by_name['config4']['dnorm_method']}")
    for name in ("apg_fused", "traj_probs", "ideal_probs"):
        check(launches[name] > 0, f"harness: {name} did not launch")

    # the two clocks: the harness's figure against the earlier phases' for
    # the same work
    found = []
    for (where, key), (per_ms, how) in phase_figures.items():
        ours = (line if where == "bench" else by_name[where])[key]
        theirs = 1e3 * per_ms
        ratio = ours / theirs
        print(f"harness {where} {key}: {ours:.2f} against {theirs:.2f} "
              f"({how}): {ratio:.3f}x")
        if max(ratio, 1 / ratio) > CLOCK_GAP:
            found.append(f"{where} {key} {ratio:.3f}x")
    print("finding: harness and phase clocks differ by more than "
          f"{CLOCK_GAP}x: {found}" if found else
          f"harness and phase clocks agree within {CLOCK_GAP}x")
    phase_s = time.perf_counter() - t_phase
    print(f"phase 23: {phase_s:.1f} s (budget {HARNESS_BUDGET_S} s)")
    return {"bench_s": bench_s, "bench_all_s": all_s, "launches": launches,
            "clock_gaps": found, "phase_s": phase_s}


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    from forest_benchmarking_tpu_torch import (
        kernels, quantum_volume, tomography)
    from forest_benchmarking_tpu_torch.benchmarks import (
        inputs_from_numpy, process_tomo_A_matrix, synth_process_datasets)
    from forest_benchmarking_tpu_torch.ops import (
        lanes_apg, pallas_eigh, pallas_traj, project_superoperators)
    from forest_benchmarking_tpu_torch.ops.random_operators import (
        haar_rand_unitary)
    from forest_benchmarking_tpu_torch.sim.noise import depolarizing_kraus_map

    dev = torch.device("cuda", 0)
    configs = {"headline": lanes_apg.HEADLINE_TUNED_2Q,
               "parity": lanes_apg.PARITY_TUNED_2Q}

    # 1. the card
    card = smi_card()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch device: {kind}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    kernels.load()
    print(f"build: {time.perf_counter() - t0:.2f} s; dim = 4 fused kernel "
          f"with {PROBLEMS_PER_BLOCK_2Q} problems per block")
    for line in kernels.build_log().splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            print(f"  ptxas: {line.strip()}")
    warp_regs = {name: kernel_ptxas(kernels.build_log(), name)
                 for name in ("apg_fused_1q_kernel", "cp_project_kernel")}
    print("ptxas " + "; ".join(
        f"{name}: {r} registers, {st}/{ld} B spill stores/loads"
        for name, (r, st, ld) in warp_regs.items())
        + f" ({PROBLEMS_PER_BLOCK_1Q} problems a block, one a quad of "
        f"lanes; {CP_PER_BLOCK} matrices a block, one a warp)")

    a_np = process_tomo_A_matrix(2)
    in32 = inputs_from_numpy(a_np, np.zeros((1, a_np.shape[0])), device=dev)
    in64 = inputs_from_numpy(a_np, np.zeros((1, a_np.shape[0])), device=dev,
                             dtype=torch.float64)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # 3. kernel against plain version at B = 256 and at a batch that leaves
    # the last block part empty (B = 16384 in phase 5); the tail batch has
    # its own generator, so that the later phases draw what they drew before
    for batch, g_chk in ((CHECK_BATCH, gen), (TAIL_BATCH, torch.Generator(
            device=dev).manual_seed(SEED + 4))):
        n_chk, _ = synth_process_datasets(g_chk, in32.a, 4, batch, SHOTS)
        for name in SCHEDULES + (("split",) if batch == CHECK_BATCH else ()):
            cfg = configs.get(name, SPLIT_SCHEDULE)
            kern = lanes_apg.apg_fused(in32.a, n_chk, 4, a_pinv=in32.a_pinv,
                                       **cfg)
            against_plain(lanes_apg, name, kern, in32, in64, n_chk, cfg)

    # 4. the main path at full size
    a = torch.tensor(a_np, dtype=torch.complex64, device=dev)
    n, chois = synth_process_datasets(gen, a, 4, BATCH, SHOTS)
    torch.cuda.synchronize()
    lanes_apg.apg_fused.launches = 0
    results = {}
    for name in SCHEDULES:
        before = lanes_apg.apg_fused.launches
        est = tomography.pgdb_process_estimate_batched(
            a, n, dim=4, method="apg", cp_method="pallas",
            fused_schedule=name)
        torch.cuda.synchronize()
        results[name] = (lanes_apg.apg_fused.launches - before, est)
    launches = lanes_apg.apg_fused.launches
    for name in SCHEDULES:
        moved, est = results[name]
        err = rel_frobenius(est, chois)
        tp = tp_violation(est)
        print(f"main path {name}: B={BATCH} shots={SHOTS} launches={moved} "
              f"mean rel Frobenius err={err.mean().item():.5f} "
              f"TP violation={tp:.3e}")
        check(moved > 0, f"{name}: the kernel was not launched")
        check(est.shape == (BATCH, 16, 16), f"{name}: shape {est.shape}")
        check(bool(torch.isfinite(est).all()), f"{name}: non-finite output")
        check(err.mean().item() < 0.12,
              f"{name}: mean relative Frobenius error {err.mean().item()}")
        check(tp < 1e-5, f"{name}: TP violation {tp:.3e}")

    # 5. timing at full size, and the kernel against plain version there
    ms_warm, rho0 = cuda_ms(
        lambda: lanes_apg.linear_inversion_start(in32.a_pinv, n, 4))
    print(f"timing warm start: B={BATCH} {ms_warm:.3f} ms on {card}")
    timing, max_abs_err = {}, 0.0
    for name, ms_one in zip(SCHEDULES, ONE_PER_BLOCK_MS):
        cfg = configs[name]
        ms_k, kern = cuda_ms(lambda: lanes_apg.apg_fused_kernel(
            in32.ar, in32.ai, n, *rho0, dim=4, **cfg))
        ms_p, plain32 = cuda_ms(lambda: lanes_apg.apg_fused_reference(
            in32.ar, in32.ai, n, *rho0, dim=4, **cfg))
        timing[name] = (ms_k, ms_p)
        l2 = lanes_apg.apg_fused_l2_bytes_per_solve(
            a_np.shape[0], 4, PROBLEMS_PER_BLOCK_2Q, **cfg)
        print(f"timing {name}: B={BATCH} kernel {ms_k:.3f} ms "
              f"({BATCH / ms_k * 1e3:.0f} solves/s), plain {ms_p:.3f} ms "
              f"({BATCH / ms_p * 1e3:.0f} solves/s) on {card}")
        print(f"  {PROBLEMS_PER_BLOCK_2Q} problems per block: A read from L2 "
              f"{l2 / 1e6:.3f} MB per solve, {BATCH * l2 / ms_k / 1e9:.3f} "
              f"TB/s at the kernel time; one problem per block took "
              f"{ms_one:.3f} ms (PERF.md, NVIDIA H100 80GB HBM3, 700 W)")
        max_abs_err = max(max_abs_err, against_plain(
            lanes_apg, name, torch.complex(*kern), in32, in64, n, cfg,
            plain32=torch.complex(*plain32)))

    # where the kernel's time goes: a schedule of passes over A alone (no
    # projection) and two of projections alone (one pass, the first cost)
    mu = configs["headline"]["mu"]
    split = {}
    for key, cfg in (("passes", dict(phases=((10, 0, 1),), init_iters=0,
                                     final_iters=0)),
                     ("dykstra1", dict(phases=(), init_iters=0,
                                       final_iters=20, final_sweeps=1)),
                     ("dykstra3", dict(phases=(), init_iters=0,
                                       final_iters=20, final_sweeps=3))):
        split[key], _ = cuda_ms(lambda: lanes_apg.apg_fused_kernel(
            in32.ar, in32.ai, n, *rho0, dim=4, mu=mu, **cfg))
    ms_pass = split["passes"] / 31
    ms_iter = (split["dykstra1"] - ms_pass) / 20
    ms_sweep = (split["dykstra3"] - split["dykstra1"]) / 40
    a_bytes = 2 * a_np.shape[0] * 256 * 4
    print(f"split: B={BATCH} one pass over A {ms_pass:.3f} ms "
          f"({BATCH * a_bytes / PROBLEMS_PER_BLOCK_2Q / ms_pass / 1e9:.3f} "
          f"TB/s of A from L2), "
          f"one Dykstra iteration of 1 sweep {ms_iter:.3f} ms, each further "
          f"sweep {ms_sweep:.3f} ms (schedules of 31 passes: "
          f"{split['passes']:.3f} ms; 20 iterations at 1 and 3 sweeps: "
          f"{split['dykstra1']:.3f} / {split['dykstra3']:.3f} ms)")
    for name in SCHEDULES:
        cfg = configs[name]
        passes = lanes_apg._a_passes(cfg["phases"])
        steps = [(cfg["init_iters"], cfg["init_sweeps"]),
                 (cfg["final_iters"], cfg["final_sweeps"])] + [
                     (outer * ld, sw) for outer, ld, sw in cfg["phases"]]
        proj = sum(it * (ms_iter + (sw - 1) * ms_sweep) for it, sw in steps)
        print(f"split {name}: {passes} passes {passes * ms_pass:.3f} ms + "
              f"{sum(it for it, _ in steps)} Dykstra iterations "
              f"({sum(it * sw for it, sw in steps)} sweeps) {proj:.3f} ms = "
              f"{passes * ms_pass + proj:.3f} ms against {timing[name][0]:.3f} "
              f"ms measured; passes "
              f"{100 * passes * ms_pass / (passes * ms_pass + proj):.1f}%")

    apg_bounds = {name: bound_ms(
        BATCH * lanes_apg.apg_fused_flops_per_solve(a_np.shape[0],
                                                    **configs[name]),
        nbytes(in32.ar, in32.ai, n, *rho0, *rho0))   # output: as rho0
        for name in SCHEDULES}
    for name, (ms_b, by) in apg_bounds.items():
        print(f"bound apg_fused {name}: {ms_b:.3f} ms ({by}), kernel at "
              f"{100 * ms_b / timing[name][0]:.1f}% of it")
    apg_bound = apg_bounds["headline"]

    # 6. the quantum-volume kernels against their plain versions
    ks = depolarizing_kraus_map(QV_DEPOL)
    kraus = torch.tensor(np.stack([np.kron(x, y) for x in ks for y in ks]),
                         dtype=torch.complex64, device=dev)
    for depth, n_traj in QV_CHECKS:
        perms, gates, uni = qv_inputs(quantum_volume, haar_rand_unitary,
                                      gen, depth, QV_CHECK_C, n_traj)
        check_ideal(pallas_traj, perms, gates, depth)
        kern = pallas_traj.traj_probs_kernel(perms, gates, kraus, uni, depth)
        plain = pallas_traj.traj_probs_reference(perms, gates, kraus, uni,
                                                 depth)
        share, dev_max, dev_all, norm = traj_agreement(kern, plain)
        print(f"check traj_probs: depth {depth} C={QV_CHECK_C} "
              f"T={n_traj} within 1e-4: {100 * share:.2f}% "
              f"(max there {dev_max:.3e}, over all {dev_all:.3e}) "
              f"column-sum error {norm:.3e}")
        check(share > 0.97 and norm < 1e-5,
              f"traj_probs depth {depth}: {share:.4f} agree, sums {norm:.3e}")
    # every depth layout, K = 1 and 32, on a generator of their own (the
    # later phases draw from `gen` what they drew before)
    g_qv = torch.Generator(device=dev).manual_seed(SEED + 5)
    for depth, circuits, n_traj, n_kraus in QV_TRAJ_CHECKS:
        perms, gates, uni = qv_inputs(quantum_volume, haar_rand_unitary,
                                      g_qv, depth, circuits, n_traj)
        ops = (kraus if n_kraus == kraus.shape[0]
               else random_kraus(haar_rand_unitary, g_qv, n_kraus))
        kern = pallas_traj.traj_probs_kernel(perms, gates, ops, uni, depth)
        plain = pallas_traj.traj_probs_reference(perms, gates, ops, uni,
                                                 depth)
        share, dev_max, dev_all, norm = traj_agreement(kern, plain)
        print(f"check traj_probs: depth {depth} C={circuits} T={n_traj} "
              f"K={n_kraus} within 1e-4: {100 * share:.2f}% (max there "
              f"{dev_max:.3e}, over all {dev_all:.3e}) column-sum error "
              f"{norm:.3e}")
        check(share > 0.97 and norm < 1e-5, f"traj_probs depth {depth} "
              f"K={n_kraus}: {share:.4f} agree, sums {norm:.3e}")
    # a trajectory's column does not depend on its block-mates
    for depth in QV_TAIL:
        perms, gates, uni = qv_inputs(quantum_volume, haar_rand_unitary,
                                      g_qv, depth, 4, 500)
        full = pallas_traj.traj_probs_kernel(perms, gates, kraus, uni, depth)
        same = [torch.equal(pallas_traj.traj_probs_kernel(
            perms, gates, kraus, uni[..., :t].contiguous(), depth),
            full[..., :t]) for t in (256, 7)]
        print(f"check traj_probs: depth {depth} T=500, the first 256 and 7 "
              f"columns rerun alone bitwise equal: {same}")
        check(all(same), f"traj_probs depth {depth}: a column depends on "
              f"its block-mates")
    # the ideal kernel at every depth layout, at C = 16 and at a tail count,
    # on a generator of its own; a row does not depend on its warp- and
    # block-mates
    g_id = torch.Generator(device=dev).manual_seed(SEED + 8)
    for depth in range(2, 11):
        counts = (() if depth in (7, 8) else (QV_CHECK_C,)) + (
            ideal_tail_circuits(depth),)
        for c in counts:
            perms = quantum_volume._sample_perms(g_id, c, depth)
            gates = haar_rand_unitary(g_id, 4, batch=(c, depth, depth // 2),
                                      dtype=torch.float32)
            kern = check_ideal(pallas_traj, perms, gates, depth)
        same = [torch.equal(pallas_traj.ideal_probs_kernel(
            perms[:k], gates[:k], depth), kern[:k]) for k in (1, 3, c - 2)]
        print(f"check ideal_probs: depth {depth} C={c}, the first 1, 3 and "
              f"{c - 2} rows rerun alone bitwise equal: {same}")
        check(all(same), f"ideal_probs depth {depth}: a row depends on its "
              f"warp- or block-mates")

    # 7. the quantum-volume main path at full width
    def heavy_call(seed, noisy):
        kw = (dict(kraus=kraus, noisy_method="trajectory",
                   num_trajectories=QV_TRAJ) if noisy else {})
        return quantum_volume.sample_heavy_outputs_batched(
            torch.Generator(device=dev).manual_seed(seed), QV_DEPTH,
            QV_CIRCUITS, QV_SHOTS, device="cuda", **kw)

    def heavy_path(seed, noisy):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        counts = heavy_call(seed, noisy)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        check(counts.shape == (QV_CIRCUITS,) and bool(
            ((counts >= 0) & (counts <= QV_SHOTS)).all()),
            "heavy counts out of range")
        return (counts.sum().item() / (QV_CIRCUITS * QV_SHOTS),
                torch.cuda.max_memory_allocated() / 2 ** 30, wall)

    qv_launches = {}
    for name, noisy, lo, hi in (("ideal", False, 0.83, 0.87),
                                ("noisy", True, 0.60, 0.72)):
        pallas_traj.ideal_probs.launches = 0
        pallas_traj.traj_probs.launches = 0
        prob, peak, wall = heavy_path(SEED + 1, noisy)
        moved = (pallas_traj.ideal_probs.launches,
                 pallas_traj.traj_probs.launches)
        with plain_versions(pallas_traj):
            prob_p, peak_p, wall_p = heavy_path(SEED + 1, noisy)
        total = QV_CIRCUITS * QV_SHOTS
        sigma = math.sqrt((prob * (1 - prob) + prob_p * (1 - prob_p)) / total)
        print(f"main path QV {name}: depth {QV_DEPTH} C={QV_CIRCUITS} "
              f"shots={QV_SHOTS}{f' T={QV_TRAJ} p={QV_DEPOL}' if noisy else ''}"
              f" launches ideal/traj={moved[0]}/{moved[1]} heavy-output "
              f"probability {prob:.5f} (plain versions {prob_p:.5f}, "
              f"|diff| = {abs(prob - prob_p) / sigma:.2f} sigma) peak memory "
              f"{peak:.2f} GiB (plain {peak_p:.2f} GiB) host clock "
              f"{wall:.3f} ms (plain {wall_p:.3f} ms)")
        check(moved[0] > 0, f"QV {name}: the ideal kernel was not launched")
        check(moved[1] > 0 or not noisy,
              f"QV {name}: the trajectory kernel was not launched")
        check(lo <= prob <= hi, f"QV {name}: heavy-output probability {prob}")
        check(abs(prob - prob_p) <= 4 * sigma,
              f"QV {name}: kernel and plain paths differ by "
              f"{abs(prob - prob_p) / sigma:.2f} sigma")
        qv_launches["ideal_probs"] = qv_launches.get("ideal_probs", 0) + moved[0]
        qv_launches["traj_probs"] = qv_launches.get("traj_probs", 0) + moved[1]
    # the same calls warm, by CUDA events with the counts fetched (the
    # clock phase 23 holds the harness's config-5 figures against)
    qv_warm_ms = {name: cuda_ms(lambda: heavy_call(SEED + 1, noisy).cpu())[0]
                  for name, noisy in (("ideal", False), ("noisy", True))}
    print(f"main path QV warm: ideal {qv_warm_ms['ideal']:.3f} ms, noisy "
          f"{qv_warm_ms['noisy']:.3f} ms (CUDA events, median of 3 after a "
          f"warm-up) on {card}")

    # 8. timing at full width, and the kernels against plain versions there
    perms, gates, uni = qv_inputs(quantum_volume, haar_rand_unitary, gen,
                                  QV_DEPTH, QV_CIRCUITS, QV_TRAJ)
    ideal_in = pallas_traj._ideal_kernel_inputs(perms, gates, QV_DEPTH)
    ms_i1, kern_i = cuda_ms(lambda: pallas_traj._ideal_launch(*ideal_in,
                                                              QV_DEPTH))
    ms_iw1, _ = cuda_ms(lambda: pallas_traj.ideal_probs_kernel(perms, gates,
                                                               QV_DEPTH))
    ms_ip, plain_i = cuda_ms(lambda: pallas_traj.ideal_probs_reference(
        perms, gates, QV_DEPTH))
    err_i = (kern_i - plain_i).abs().max().item()
    # calls queued behind a device sleep: the kernel's own time, and the
    # wrapper's on the card (and on the host), at depth 8 and at depth 4
    g_q = torch.Generator(device=dev).manual_seed(SEED + 9)
    for depth, (p_q, u_q) in ((QV_DEPTH, (perms, gates)), (4, (
            quantum_volume._sample_perms(g_q, QV_CIRCUITS, 4),
            haar_rand_unitary(g_q, 4, batch=(QV_CIRCUITS, 4, 2),
                              dtype=torch.float32)))):
        q_in = pallas_traj._ideal_kernel_inputs(p_q, u_q, depth)
        ms_q, _ = queued_ms(lambda: pallas_traj._ideal_launch(*q_in, depth))
        ms_qw, host_qw = queued_ms(lambda: pallas_traj.ideal_probs_kernel(
            p_q, u_q, depth))
        print(f"timing ideal_probs queued: depth {depth} C={QV_CIRCUITS} "
              f"kernel {ms_q:.4f} ms, wrapper {ms_qw:.4f} ms a call "
              f"(wrapper - kernel {ms_qw - ms_q:.4f} ms; host {host_qw:.4f} "
              f"ms a wrapper call), means of {QUEUED} queued calls, on {card}")
        if depth == QV_DEPTH:
            ms_i, ms_iw = ms_q, ms_qw
    print(f"timing ideal_probs one call a sample: depth {QV_DEPTH} kernel "
          f"{ms_i1:.4f} ms, wrapper {ms_iw1:.4f} ms")
    ideal_bound = bound_ms(
        QV_CIRCUITS * pallas_traj.traj_flops_per_circuit(
            QV_DEPTH, num_trajectories=1, noiseless=True),
        nbytes(perms, gates, kern_i))
    traj_in = pallas_traj._traj_kernel_inputs(perms, gates, kraus, uni,
                                              QV_DEPTH)
    ms_t, kern_t = cuda_ms(lambda: pallas_traj._traj_launch(*traj_in,
                                                            QV_DEPTH))
    ms_tw, _ = cuda_ms(lambda: pallas_traj.traj_probs_kernel(
        perms, gates, kraus, uni, QV_DEPTH))
    torch.cuda.reset_peak_memory_stats()
    ms_tp, plain_t = cuda_ms(lambda: pallas_traj.traj_probs_reference(
        perms, gates, kraus, uni, QV_DEPTH))
    peak_tp = torch.cuda.max_memory_allocated() / 2 ** 30
    share_t, err_t, err_t_all, norm_t = traj_agreement(kern_t, plain_t)
    traj_bound = bound_ms(
        QV_CIRCUITS * pallas_traj.traj_flops_per_circuit(
            QV_DEPTH, kraus.shape[0], QV_TRAJ),
        nbytes(perms, gates, kraus, uni, kern_t))
    for name, ms_k, ms_w, ms_p, bound in (
            ("ideal_probs", ms_i, ms_iw, ms_ip, ideal_bound),
            ("traj_probs", ms_t, ms_tw, ms_tp, traj_bound)):
        print(f"timing {name}: depth {QV_DEPTH} C={QV_CIRCUITS}"
              f"{f' T={QV_TRAJ}' if name == 'traj_probs' else ''} kernel "
              f"{ms_k:.3f} ms ({QV_CIRCUITS / ms_k * 1e3:.0f} circuits/s), "
              f"wrapper {ms_w:.3f} ms (wrapper - kernel {ms_w - ms_k:.3f} "
              f"ms), plain {ms_p:.3f} ms "
              f"({QV_CIRCUITS / ms_p * 1e3:.0f} circuits/s); bound "
              f"{bound[0]:.3f} ms ({bound[1]}), kernel at "
              f"{100 * bound[0] / ms_k:.1f}% of it, on {card}")
    print(f"check ideal_probs: C={QV_CIRCUITS} max|kernel-plain32|="
          f"{err_i:.3e}; traj_probs: T={QV_TRAJ} within 1e-4: "
          f"{100 * share_t:.3f}% (max there {err_t:.3e}, over all "
          f"{err_t_all:.3e}) column-sum error {norm_t:.3e}; plain traj_probs "
          f"peak memory {peak_tp:.2f} GiB")
    check(err_i <= 2e-6, f"ideal_probs at full width: {err_i:.3e}")
    check(share_t > 0.97 and norm_t < 1e-5,
          f"traj_probs at full width: {share_t:.4f} agree, sums {norm_t:.3e}")
    del kern_t, plain_t, traj_in
    qv_regs = {}
    for kernel in ("traj_probs_kernel", "ideal_probs_kernel"):
        qv_regs[kernel] = depth_ptxas(kernels.build_log(), kernel)
        for d, (r, st, ld, sf) in qv_regs[kernel].items():
            print(f"ptxas {kernel}<{d}>: {r} registers, {st}/{ld} B spill "
                  f"stores/loads, {sf} B stack")
        check(sorted(qv_regs[kernel]) == list(range(2, 11)),
              f"{kernel} instantiations {sorted(qv_regs[kernel])}")

    # the Haar draw of one depth-8 call, against the library QR it replaces
    batch = (QV_CIRCUITS, QV_DEPTH, QV_DEPTH // 2)
    ms_h, _ = cuda_ms(lambda: haar_rand_unitary(gen, 4, batch=batch,
                                                dtype=torch.float32))
    z = torch.complex(torch.randn((*batch, 4, 4), generator=gen, device=dev),
                      torch.randn((*batch, 4, 4), generator=gen, device=dev))
    ms_q, _ = cuda_ms(lambda: torch.linalg.qr(z), reps=1)
    print(f"timing Haar draw of {math.prod(batch)} 4x4 gates: Gram-Schmidt "
          f"{ms_h:.3f} ms, torch.linalg.qr alone {ms_q:.3f} ms, on {card}")

    for name, kw in (("ideal", {}), ("noisy", dict(kraus=kraus))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = quantum_volume.measure_quantum_volume_batched(
            torch.Generator(device=dev).manual_seed(SEED + 2), max_depth=8,
            num_circuits=QV_CIRCUITS, num_shots=QV_SHOTS,
            stop_when_fail=False, device="cuda", **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(sorted(res) == list(range(2, 9)), f"QV scan {name}: {res}")
        print(f"measure_quantum_volume_batched {name}: max_depth=8 "
              f"C={QV_CIRCUITS} shots={QV_SHOTS} {secs:.3f} s; QV = "
              f"{quantum_volume.extract_quantum_volume_from_results(res)}; "
              + " ".join(f"d{d}={p:.4f}/{c:.4f}" for d, (p, c) in res.items()))

    # where the time of one main-path call goes
    from torch.profiler import ProfilerActivity, profile

    def is_matmul(e):
        key = e.key.lower()
        return key in ("aten::mm", "aten::bmm", "aten::matmul") or (
            e.device_type == torch.autograd.DeviceType.CUDA
            and "gemm" in key)

    # the trajectory wrapper alone launches no matrix product: W and M'
    # are formed in the kernel
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pallas_traj.traj_probs_kernel(perms, gates, kraus, uni, QV_DEPTH)
        torch.cuda.synchronize()
    ev = prof.key_averages()
    launched = sorted(e.key[:48] for e in ev if e.device_type
                      == torch.autograd.DeviceType.CUDA)
    products = sum(e.count for e in ev if is_matmul(e))
    print(f"profile traj_probs wrapper: device kernels {launched}; "
          f"matrix-product calls and launches: {products}")
    check(products == 0, f"the trajectory wrapper ran {products} matrix "
          "products")
    # the ideal wrapper alone: one launch, the ideal kernel's (the boundary
    # maps are formed in the kernel)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pallas_traj.ideal_probs_kernel(perms, gates, QV_DEPTH)
        torch.cuda.synchronize()
    launched = [(e.key[:64], e.count) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"profile ideal_probs wrapper: device kernels {launched}")
    check(len(launched) == 1 and launched[0][1] == 1
          and "ideal_probs_kernel" in launched[0][0],
          f"the ideal wrapper launched {launched}")

    for name, kw in (("ideal", {}), ("noisy", dict(
            kraus=kraus, noisy_method="trajectory",
            num_trajectories=QV_TRAJ))):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            quantum_volume.sample_heavy_outputs_batched(
                torch.Generator(device=dev).manual_seed(SEED + 3), QV_DEPTH,
                QV_CIRCUITS, QV_SHOTS, device="cuda", **kw)
            torch.cuda.synchronize()
        ev = prof.key_averages()
        gpu = sorted((e for e in ev
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
        busy = sum(e.self_device_time_total for e in gpu) / 1e3
        print(f"profile QV {name}: {sum(e.count for e in gpu)} kernel "
              f"launches, device busy {busy:.3f} ms, matrix-product launches "
              f"{sum(e.count for e in gpu if is_matmul(e))}")
        for e in gpu[:5]:
            print(f"  device {e.self_device_time_total / 1e3:9.3f} ms "
                  f"x{e.count:<6d} {e.key[:64]}")
        for e in sorted(ev, key=lambda e: e.self_cpu_time_total,
                        reverse=True)[:5]:
            print(f"  host   {e.self_cpu_time_total / 1e3:9.3f} ms "
                  f"x{e.count:<6d} {e.key[:64]}")

    # 9. the one-qubit kernel against its plain versions at B = 256
    a1_np = process_tomo_A_matrix(1)
    in_1q = {dt: inputs_from_numpy(a1_np, np.zeros((1, a1_np.shape[0])),
                                   device=dev, dtype=dt)
             for dt in (torch.float32, torch.float64)}
    a1 = in_1q[torch.float32].a
    n1_chk, _ = synth_process_datasets(gen, a1, 2, CHECK_BATCH, SHOTS)
    kern = lanes_apg.apg_fused(a1, n1_chk, 2,
                               a_pinv=in_1q[torch.float32].a_pinv)
    plain32 = plain_1q(lanes_apg, in_1q, n1_chk, torch.float32)
    against_plain_1q(kern, plain32,
                     plain_1q(lanes_apg, in_1q, n1_chk, torch.float64))
    # the same plain f32 solve on the host CPU: how far round-off alone
    # moves the result
    inp = in_1q[torch.float32]
    start = lanes_apg.linear_inversion_start(inp.a_pinv, n1_chk, 2)
    host = torch.complex(*lanes_apg.apg_fused_reference(
        inp.ar.cpu(), inp.ai.cpu(), n1_chk.cpu(), *(x.cpu() for x in start),
        dim=2)).to(dev)
    spread = (host - plain32).abs().amax(dim=(1, 2)).double()
    q = torch.tensor(QUANTILES, dtype=spread.dtype, device=dev)
    print("plain32 on the host CPU against plain32 on the card: q50/q90/q99/"
          "max " + "/".join(f"{x:.3e}" for x in (
              *torch.quantile(spread, q).tolist(), spread.max().item())))
    # a batch that leaves the last block and its last warp part empty, on
    # a generator of its own (the later phases draw from `gen` what they
    # drew before); the first problems solved alone give bitwise the same
    # estimates
    n1_tail, _ = synth_process_datasets(
        torch.Generator(device=dev).manual_seed(SEED + 6), a1, 2,
        TAIL_BATCH_1Q, SHOTS)
    start = lanes_apg.linear_inversion_start(inp.a_pinv, n1_tail, 2)

    def solve_1q(k):
        return torch.complex(*lanes_apg.apg_fused_kernel(
            inp.ar, inp.ai, n1_tail[:k].contiguous(),
            *(x[:k].contiguous() for x in start), dim=2))

    kern = solve_1q(TAIL_BATCH_1Q)
    against_plain_1q(kern, plain_1q(lanes_apg, in_1q, n1_tail, torch.float32),
                     plain_1q(lanes_apg, in_1q, n1_tail, torch.float64))
    alone = [torch.equal(solve_1q(k), kern[:k]) for k in (5, 17, 69)]
    print(f"check apg_fused_1q: B={TAIL_BATCH_1Q}, the first 5, 17 and 69 "
          f"problems solved alone bitwise equal: {alone}")
    check(all(alone), "apg_fused_1q: a problem depends on its warp- or "
          "block-mates")

    # 10. the one-qubit main path at full size, then its timing
    n1, chois1 = synth_process_datasets(gen, a1, 2, BATCH, SHOTS)
    torch.cuda.synchronize()
    lanes_apg.apg_fused.launches = 0
    est1 = tomography.pgdb_process_estimate_batched(
        a1, n1, dim=2, method="apg", cp_method="pallas")
    torch.cuda.synchronize()
    launches_1q = lanes_apg.apg_fused.launches
    plain64_1q = plain_1q(lanes_apg, in_1q, n1, torch.float64)
    err1 = rel_frobenius(est1, chois1).mean().item()
    err1_64 = rel_frobenius(plain64_1q,
                            chois1.to(plain64_1q.dtype)).mean().item()
    print(f"main path 1Q: B={BATCH} shots={SHOTS} launches={launches_1q} "
          f"mean rel Frobenius err={err1:.5f} (plain f64 {err1_64:.5f}, "
          f"ratio {err1 / err1_64:.4f})")
    check(launches_1q > 0, "1Q: the kernel was not launched")
    check(est1.shape == (BATCH, 4, 4), f"1Q: shape {est1.shape}")
    check(bool(torch.isfinite(est1).all()), "1Q: non-finite output")
    check(abs(err1 / err1_64 - 1) <= 0.02,
          f"1Q: mean relative Frobenius error {err1} against {err1_64}")
    in32_1q = in_1q[torch.float32]
    rho0_1q = lanes_apg.linear_inversion_start(in32_1q.a_pinv, n1, 2)
    ms_k1, kern1 = cuda_ms(lambda: lanes_apg.apg_fused_kernel(
        in32_1q.ar, in32_1q.ai, n1, *rho0_1q, dim=2))
    ms_p1, plain1 = cuda_ms(lambda: lanes_apg.apg_fused_reference(
        in32_1q.ar, in32_1q.ai, n1, *rho0_1q, dim=2))
    print(f"timing apg_fused_1q: B={BATCH} kernel {ms_k1:.3f} ms "
          f"({BATCH / ms_k1 * 1e3:.0f} solves/s), plain {ms_p1:.3f} ms "
          f"({BATCH / ms_p1 * 1e3:.0f} solves/s) on {card}")
    plain1 = torch.complex(*plain1)
    # a 1Q CPTP Choi matrix has trace 2, so no entry above 2 in magnitude
    print("problems with an entry above 2 in magnitude (not converged): "
          + ", ".join(f"{name} {int((x.abs().amax(dim=(1, 2)) > 2).sum())}"
                      for name, x in (("main path", est1),
                                      ("kernel", torch.complex(*kern1)),
                                      ("plain f32", plain1),
                                      ("plain f64", plain64_1q))))
    check_tp_1q("main path 1Q", est1, plain1)
    err_1q = against_plain_1q(torch.complex(*kern1), plain1, plain64_1q)
    del plain64_1q, kern1, plain1

    # 11. the per-problem routes on the card
    routes = (("pgdb", {}),
              ("apg-warm", dict(method="apg", warm_start=True,
                                loop_dyk_iters=1, return_iters=True)))
    for dim, a_r, n_r, truth, fused in (
            (2, a1, n1, chois1, est1),
            (4, a, n, chois, results["parity"][1])):
        n_r, truth, fused = (x[:ROUTE_BATCH] for x in (n_r, truth, fused))
        err_fused = rel_frobenius(fused, truth).mean().item()
        for name, kw in routes:
            lanes_apg.apg_fused.launches = 0
            pallas_eigh.cp_project_pallas.launches = 0
            with counting_calls(torch.linalg, "eigh") as eighs:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = tomography.pgdb_process_estimate_batched(
                    a_r, n_r, dim=dim, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            ours = (lanes_apg.apg_fused.launches,
                    pallas_eigh.cp_project_pallas.launches)
            est, iters = out if kw.get("return_iters") else (out, None)
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                tomography.pgdb_process_estimate_batched(a_r, n_r, dim=dim,
                                                         **kw)
                torch.cuda.synchronize()
            ev = prof.key_averages()
            gpu = sorted((e for e in ev
                          if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: e.self_device_time_total, reverse=True)
            busy = sum(e.self_device_time_total for e in gpu) / 1e3
            syncs = sum(e.count for e in ev if "Synchronize" in e.key)
            dev_f = (est - fused).abs().amax(dim=(1, 2))
            err = rel_frobenius(est, truth).mean().item()
            tp = tp_violation(est, dim)
            print(f"route {name} dim={dim}: B={ROUTE_BATCH} host clock "
                  f"{wall:.3f} s, {eighs[0]} eigh calls, port kernel launches "
                  f"apg/cp={ours[0]}/{ours[1]}; profiled "
                  f"({time.perf_counter() - t0:.1f} s): "
                  f"{sum(e.count for e in gpu)} device launches, device busy "
                  f"{busy:.3f} ms, {syncs} stream/device synchronizations"
                  + (f"; iterations max {iters.max().item()} mean "
                     f"{iters.float().mean().item():.1f}"
                     if iters is not None else ""))
            for e in gpu[:3]:
                print(f"  device {e.self_device_time_total / 1e3:9.3f} ms "
                      f"x{e.count:<7d} {e.key[:64]}")
            print(f"route {name} dim={dim}: deviation from the fused kernel "
                  f"median {dev_f.median().item():.3e} max "
                  f"{dev_f.max().item():.3e} (JAX PGDB-vs-APG bar 1e-3); "
                  f"mean rel Frobenius err {err:.5f} (fused {err_fused:.5f}) "
                  f"TP violation {tp:.3e}")
            check(bool(torch.isfinite(est).all()),
                  f"route {name} dim={dim}: non-finite output")
            check(tp < 1e-5, f"route {name} dim={dim}: TP violation {tp:.3e}")
            check(err <= 1.05 * err_fused,
                  f"route {name} dim={dim}: mean rel Frobenius err {err} "
                  f"against the fused kernel's {err_fused}")

    # 12. the Jacobi CP projection against eigh, and its main path
    h_li = torch.complex(*rho0)          # config-2 linear-inversion estimates
    x = torch.randn((CHECK_BATCH, 16, 16), generator=gen, device=dev,
                    dtype=torch.complex64)
    for name, h in (("linear inversion", h_li[:CHECK_BATCH]),
                    ("Gaussian", (x + x.transpose(1, 2).conj()) / 2)):
        kern = pallas_eigh.cp_project_pallas(h, sweeps=CP_SWEEPS)
        exact = project_superoperators.proj_choi_to_completely_positive(
            h.to(torch.complex128))
        err = (kern.to(exact.dtype) - exact).abs().max().item()
        print(f"check cp_project: {name} B={h.shape[0]} sweeps={CP_SWEEPS} "
              f"max|kernel-eigh f64|={err:.3e}")
        check(err < 1e-4, f"cp_project {name}: {err:.3e} from eigh")
    torch.cuda.synchronize()
    pallas_eigh.cp_project_pallas.launches = 0
    pos = pallas_eigh.cp_project_pallas(h_li, sweeps=CP_SWEEPS)
    torch.cuda.synchronize()
    launches_cp = pallas_eigh.cp_project_pallas.launches
    exact = project_superoperators.proj_choi_to_completely_positive(
        h_li.to(torch.complex128))
    err_cp = (pos.to(exact.dtype) - exact).abs().max().item()
    print(f"main path cp_project: B={BATCH} launches={launches_cp} "
          f"max|kernel-eigh f64|={err_cp:.3e}")
    check(launches_cp > 0, "cp_project: the kernel was not launched")
    check(bool(torch.isfinite(pos).all()), "cp_project: non-finite output")
    check(err_cp < 1e-4, f"cp_project at B={BATCH}: {err_cp:.3e} from eigh")
    del exact
    # a batch that leaves the last block part empty, on a generator of its
    # own: against eigh, against the plain version after one sweep, and
    # the first matrices projected alone
    x = torch.randn((TAIL_BATCH_CP, 16, 16), device=dev, dtype=torch.complex64,
                    generator=torch.Generator(device=dev).manual_seed(SEED + 7))
    h = (x + x.transpose(1, 2).conj()) / 2
    kern = pallas_eigh.cp_project_pallas(h, sweeps=CP_SWEEPS)
    exact = project_superoperators.proj_choi_to_completely_positive(
        h.to(torch.complex128))
    err = (kern.to(exact.dtype) - exact).abs().max().item()
    err1 = (pallas_eigh.cp_project_pallas(h, sweeps=1)
            - pallas_eigh.cp_project_reference(h, 1)).abs().max().item()
    alone = [torch.equal(pallas_eigh.cp_project_pallas(
        h[:k].contiguous(), sweeps=CP_SWEEPS), kern[:k]) for k in (3, 9)]
    print(f"check cp_project: Gaussian B={TAIL_BATCH_CP} "
          f"max|kernel-eigh f64|={err:.3e}; 1 sweep max|kernel-plain32|="
          f"{err1:.3e}; the first 3 and 9 projected alone bitwise equal: "
          f"{alone}")
    check(err < 1e-4 and err1 < 1e-4,
          f"cp_project at B={TAIL_BATCH_CP}: {err:.3e} / {err1:.3e}")
    check(all(alone), "cp_project: a matrix depends on its block-mates")
    del exact, kern, h, x

    # 13. timing of the CP projection, and both new kernels' bounds
    ms_cp, _ = cuda_ms(lambda: pallas_eigh.cp_project_pallas(
        h_li, sweeps=CP_SWEEPS))
    ms_cpp, _ = cuda_ms(lambda: pallas_eigh.cp_project_reference(
        h_li, CP_SWEEPS))
    ms_lib, _ = cuda_ms(lambda: project_superoperators
                        .proj_choi_to_completely_positive(h_li))
    ms_eigh, _ = cuda_ms(lambda: torch.linalg.eigh(h_li))
    cp_bound = bound_ms(BATCH * pallas_eigh.cp_project_flops(CP_SWEEPS),
                        2 * nbytes(h_li))
    bound_1q = bound_ms(
        BATCH * lanes_apg.apg_fused_flops_per_solve(a1_np.shape[0], 2),
        nbytes(in32_1q.ar, in32_1q.ai, n1, *rho0_1q, *rho0_1q))
    print(f"timing cp_project: B={BATCH} sweeps={CP_SWEEPS} kernel "
          f"{ms_cp:.3f} ms, plain {ms_cpp:.3f} ms, "
          f"proj_choi_to_completely_positive {ms_lib:.3f} ms (torch.linalg."
          f"eigh alone {ms_eigh:.3f} ms) on {card}")
    for name, ms_k, bound in (("apg_fused_1q", ms_k1, bound_1q),
                              ("cp_project", ms_cp, cp_bound)):
        print(f"bound {name}: {bound[0]:.3f} ms ({bound[1]}), kernel at "
              f"{100 * bound[0] / ms_k:.1f}% of it")

    # 14. BASELINE config 1, and 15. config 3 (plain torch: these paths
    # run no TPU kernel)
    ms_state = phase_state_tomography(card, dev)
    ms_rb = phase_rb_fits(card, dev)

    # 16. BASELINE config 4 (plain torch: no TPU kernel on this path)
    ms_dist = phase_distances(card, dev)

    # 17. the tomography protocol on the card (the fused kernel on data
    # from circuits in its part (c))
    tomo_record = phase_tomography(card, dev)

    # 18. the Clifford-engine protocols on the card (plain PyTorch: no TPU
    # kernel on these paths)
    proto_record = phase_protocols(card, dev)

    # 19. entangled states, the adder, QV from circuits and the sharded
    # entry points (the APG, ideal and trajectory kernels in part (f))
    slice13_record = phase_slice13(card, dev)

    # 20. every script of examples_torch/ (the ideal QV kernel in the
    # quantum-volume example)
    examples_record = phase_examples(card, dev)

    # 21. every notebook of examples_torch/notebooks/ (the ideal QV kernel
    # in quantum_volume, the trajectory kernel in quantum_volume_noisy)
    notebooks_record = phase_notebooks(card, dev)

    # 22. the entry step and the dry run over a 4-shard mesh (the APG,
    # trajectory and ideal kernels)
    entry_record = phase_entry(card, dev)

    # 23. the measurement harnesses at the JAX sizes (the APG, ideal and
    # trajectory kernels), beside the earlier phases' figures for the same
    # work
    events = "CUDA events"
    harness_record = phase_harness(card, dev, {
        ("bench", "value"): (BATCH / (ms_warm + timing["headline"][0]),
                             "phase 5, warm start + kernel, " + events),
        ("bench", "parity_solves_per_sec"): (
            BATCH / (ms_warm + timing["parity"][0]),
            "phase 5, warm start + kernel, " + events),
        ("config1", "value"): (STATE_BATCH / ms_state, "phase 14, " + events),
        ("config3", "value"): (RB_BATCH / ms_rb, "phase 15, " + events),
        ("config4", "value"): (DIST_BATCH / ms_dist["distance_ms"],
                               "phase 16, " + events),
        ("config4", "diamond_norms_per_sec"): (
            DNORM_BATCH / ms_dist["dnorm_ms"], "phase 16, " + events),
        ("config5_ideal", "value"): (QV_CIRCUITS / qv_warm_ms["ideal"],
                                     "phase 7, warm, " + events),
        ("config5_noisy_d8", "value"): (QV_CIRCUITS / qv_warm_ms["noisy"],
                                        "phase 7, warm, " + events)})

    def record(name, source, replaces, launch_count, err, ms_k, ms_p, bound,
               library_ms=None):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launch_count,
                "max_abs_err": err, "ms": ms_k, "plain_ms": ms_p,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": library_ms}

    qv_src = "forest_benchmarking_tpu_torch/csrc/qv_traj.cu"
    apg_src = "forest_benchmarking_tpu_torch/csrc/apg_fused.cu"
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"tomography": tomo_record}))
    print(json.dumps({"protocols": proto_record}))
    print(json.dumps({"slice13": slice13_record}, default=float))
    print(json.dumps({"examples": {k: v for k, v in examples_record.items()
                                   if k != "phase_s"}}))
    print(json.dumps({"notebooks": {
        k: {"s": v["s"], "launches": v["launches"]}
        for k, v in notebooks_record.items() if k != "phase_s"}}))
    print(json.dumps({"entry": entry_record}, default=float))
    print(json.dumps({"harness": harness_record}))
    print(json.dumps({"kernels": [
        record("apg_fused", apg_src,
               "forest_benchmarking_tpu/ops/lanes_apg.py:674", launches,
               max_abs_err, timing["headline"][0], timing["headline"][1],
               apg_bound),
        dict(record("apg_fused_1q", apg_src,
                    "forest_benchmarking_tpu/ops/lanes_apg.py:674",
                    launches_1q, err_1q[0], ms_k1, ms_p1, bound_1q),
             median_abs_err=err_1q[1], q99_abs_err=err_1q[2],
             registers=warp_regs["apg_fused_1q_kernel"][0],
             spill_bytes=warp_regs["apg_fused_1q_kernel"][1:]),
        dict(record("cp_project", apg_src,
                    "forest_benchmarking_tpu/ops/pallas_eigh.py:68",
                    launches_cp, err_cp, ms_cp, ms_cpp, cp_bound,
                    library_ms=ms_lib),
             registers=warp_regs["cp_project_kernel"][0],
             spill_bytes=warp_regs["cp_project_kernel"][1:]),
        dict(record("traj_probs", qv_src,
                    "forest_benchmarking_tpu/ops/pallas_traj.py:301",
                    qv_launches["traj_probs"], err_t, ms_t, ms_tp, traj_bound),
             agree_share=share_t, max_abs_err_all=err_t_all, wrapper_ms=ms_tw,
             registers={d: r[0] for d, r in
                        qv_regs["traj_probs_kernel"].items()}),
        dict(record("ideal_probs", qv_src,
                    "forest_benchmarking_tpu/ops/pallas_traj.py:410",
                    qv_launches["ideal_probs"], err_i, ms_i, ms_ip,
                    ideal_bound),
             wrapper_ms=ms_iw,
             registers={d: r[0] for d, r in
                        qv_regs["ideal_probs_kernel"].items()}),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
