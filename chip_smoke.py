#!/usr/bin/env python3
"""On-card smoke check of the PyTorch port's main paths: batched 2Q process
tomography (BASELINE config 2), batched quantum volume (config 5), batched
1Q process tomography, the per-problem process-MLE routes, the Jacobi CP
projection, batched state tomography (config 1), batched RB decay fits
(config 3) and channel distances with batched diamond norms (config 4).

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
   CUDA events, dnorms/s, the host clock, a profiler pass, the mean diamond
   norm, ``dnorm_flops_per_problem`` with the bound and its share; the
   dense route (``method="dense"``) at the same B with its Adam steps, for
   comparison. The first 64 pairs' fused values within 1e-5 of a float64
   dense gold on the card (800 steps, ``stop_tol=0``, two restarts), with
   the max and mean error. Analytic cases in float32 on the card through
   ``method="auto"``, held to 1e-5: dnorm(I, X) = 2, depolarizing (p = 0.1,
   0.3, 0.7) against the identity = 1.5 p, and a channel against itself 0
   with no NaN (1Q and 2Q).

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
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

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
PEAK_FLOPS = 67e12     # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12   # H100 SXM, HBM3
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


def cuda_ms(fn, reps: int = 3):
    """(median milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    the last run's result)."""
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


def bound_ms(flops: float, n_bytes: float):
    """(least time in ms, what bounds it) at the card's published peaks."""
    t_ops, t_bytes = flops / PEAK_FLOPS, n_bytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


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


def phase_state_tomography(card: str, dev: torch.device) -> None:
    """14. BASELINE config 1 at bench_all.py:57's size; see the module
    docstring."""
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
    for name, ee, rt in (("f32", e, r_true),
                         ("f64", e.double(), r_true.double())):
        ms, _ = cuda_ms(lambda: estimate(ee, rt))
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


def phase_rb_fits(card: str, dev: torch.device) -> None:
    """15. BASELINE config 3 at bench_all.py:131's size; see the module
    docstring."""
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
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        ms, _ = cuda_ms(lambda: fit(dtype))
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


def phase_distances(card: str, dev: torch.device) -> None:
    """16. BASELINE config 4 at bench_all.py:176's size; see the module
    docstring."""
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

    for name, pair in (("f32", dist32), ("f64", dist64)):
        ms, _ = cuda_ms(lambda: step(*pair))
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
    launches, busy, syncs, top, _ = profiled(
        lambda: dm.diamond_norm_distance(*dnorm32))
    flops = lanes_dnorm.dnorm_flops_per_problem(4)
    bound = bound_ms(DNORM_BATCH * flops, nbytes(*dnorm32)
                     + DNORM_BATCH * dn32.element_size())
    print(f"timing diamond norm fused f32: B={DNORM_BATCH} CUDA events "
          f"{ms_f:.3f} ms, {DNORM_BATCH / (ms_f / 1e3):.0f} dnorms/s, host "
          f"clock {host_f:.3f} ms; profiled: {launches} device launches, "
          f"busy {busy:.3f} ms ({100 * busy / ms_f:.1f}% of the call), "
          f"{syncs} synchronizations; dnorm_flops_per_problem(4) = "
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
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
    ms_w, rho0 = cuda_ms(
        lambda: lanes_apg.linear_inversion_start(in32.a_pinv, n, 4))
    print(f"timing warm start: B={BATCH} {ms_w:.3f} ms on {card}")
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
    def heavy_path(seed, noisy):
        kw = (dict(kraus=kraus, noisy_method="trajectory",
                   num_trajectories=QV_TRAJ) if noisy else {})
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        counts = quantum_volume.sample_heavy_outputs_batched(
            torch.Generator(device=dev).manual_seed(seed), QV_DEPTH,
            QV_CIRCUITS, QV_SHOTS, device="cuda", **kw)
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
    phase_state_tomography(card, dev)
    phase_rb_fits(card, dev)

    # 16. BASELINE config 4 (plain torch: no TPU kernel on this path)
    phase_distances(card, dev)

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
