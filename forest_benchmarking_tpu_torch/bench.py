"""Performance harness: batched 2Q process-tomography MLE on one card.

The port's counterpart of the JAX package's ``bench.py``: BASELINE config 2
at B = 16384 problems and 2000 shots a setting. Run on a machine with an
NVIDIA GPU:

    python -m forest_benchmarking_tpu_torch.bench

It prints ONE JSON line with the keys of the JAX line, two of them renamed
(``xla_warm_apg_*`` -> ``warm_apg_*``, ``mean_rel_frob_err_xla_warm_f32``
-> ``mean_rel_frob_err_warm_f32``; ``parity_fraction_vpu_peak`` ->
``parity_fraction_f32_peak``, against the card's f32 rate outside the
tensor cores), plus ``device`` (the card's name and power limit) and
``statistic`` (how each time was taken):

- ``value`` (headline): the fused solver (``ops.lanes_apg.apg_fused``, the
  CUDA kernel) at ``HEADLINE_TUNED_2Q``, solves/s; ``vs_baseline`` is
  ``value / 1e4``;
- ``parity_solves_per_sec``: the same solver at ``PARITY_TUNED_2Q``;
- ``sustained_solves_per_sec``: four headline solves queued back to back
  with one synchronization at the end;
- the comparison routes of ``tomography.pgdb_process_estimate_batched``:
  warm-started APG at B = 16384, cold APG and PGDB on the first 4096
  problems, with the warm route's mean iteration count;
- the analytic FLOPs a solve (:func:`fused_apg_flops_per_solve`,
  :func:`headline_flops_per_solve`) and the rates they imply;
- the relative Frobenius error of every route against the true Choi
  matrices, in float32;
- the f64 parity half (:func:`cpu_parity`): on the CPU in float64, outside
  every timed window, PGDB against an independent numpy PGD
  (``max_deviation_vs_oracle_f64``), the APG routes and the fused schedules
  against the converged optimum, and the likelihood-ratio statistics.

The data are drawn on the card from a ``torch.Generator`` seeded 0 before
any timing; ``pinv(A)`` is computed once on the host in float64 and passed
in, as production callers do. A timed run is the solve plus the fetch of
its (B,) relative-Frobenius vector to the host, timed with CUDA events
(the host clock on the CPU); each figure is the median of 4 runs after one
warm-up. A stage that raises is recorded under ``errors`` and its figures
are ``null``: no other route's figure stands in for it, and :func:`main`
still prints its line and returns.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from forest_benchmarking_tpu_torch.benchmarks import (
    process_tomo_A_matrix, synth_process_datasets)
from forest_benchmarking_tpu_torch.ops.lanes_apg import (
    HEADLINE_TUNED_2Q, PARITY_TUNED_2Q, apg_fused)
from forest_benchmarking_tpu_torch.ops.superoperator_transformations import (
    vec)
from forest_benchmarking_tpu_torch.tomography import (
    pgdb_process_estimate_batched)

__all__ = ["main", "throughput", "cpu_parity", "parity_figures",
           "fused_apg_flops_per_solve", "headline_flops_per_solve",
           "bound_ms", "timed", "card", "PEAK_FLOPS", "PEAK_BYTES", "BATCH",
           "SHOTS", "TARGET_SOLVES_PER_SEC"]

N_QUBITS = 2
DIM = 2 ** N_QUBITS
BATCH = 16384          # the headline batch; cold APG and PGDB take 4096
COMPARISON_BATCH = 4096
SHOTS = 2000
TARGET_SOLVES_PER_SEC = 1.0e4
REPS = 4               # timed runs after one warm-up; the median is reported
SUSTAINED_SOLVES = 4   # solves queued back to back in the sustained figure
SUSTAINED_REPS = 3
STATISTIC = (f"median of {REPS} runs after one warm-up (sustained: of "
             f"{SUSTAINED_REPS}), each the solve and the fetch of its (B,) "
             "errors; CUDA events on the card, the host clock on the CPU")

# H100 SXM published peaks at its 700 W limit: f32 outside the tensor
# cores, and HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound_ms(flops: float, n_bytes: float):
    """(least time in ms, what bounds it) at the card's published peaks."""
    t_ops, t_bytes = flops / PEAK_FLOPS, n_bytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def fused_apg_flops_per_solve(phases, init_iters=8, init_sweeps=3,
                              final_iters=20, final_sweeps=1,
                              dim=DIM, a_rows=None) -> float:
    """Analytic FLOPs of one fused-APG solve, as the JAX package's
    ``bench.fused_apg_flops_per_solve`` counts them.

    Counted per problem:
    - each Dykstra iteration: hermitianize (2n^2) + basis rotation
      M = V^dag H V (two complex n x n matmuls, 8n^3 each) + s Jacobi sweeps
      (n-1 rounds of rotations on A columns+rows and V columns, ~36n^2 per
      round) + eigen-reconstruction (8n^3) + TP projection (~4n^2);
    - each outer iteration: p = Re(A x) and the gradient A^T eta (two
      R x n^2 real mat-vecs, 2 R n^2 each), the cost reduction (~2R), and
      momentum/update elementwise terms (~10 n^2);
    with n = dim^2 and R the A-matrix row count. The CUDA kernel's count,
    ``ops.lanes_apg.apg_fused_flops_per_solve`` (the bounds of PERF.md),
    charges a pass over the complex A 4 R n^2 and makes 1 + 3 passes a
    step, so it is 2.0x (parity) to 2.5x (headline) this one.
    """
    n = dim * dim
    if a_rows is None:
        a_rows = 1080  # 2Q process-tomography A-matrix rows
    per_sweep = 36.0 * n * n * (n - 1)
    per_dyk = lambda s: 2 * n * n + 16.0 * n ** 3 + s * per_sweep \
        + 8.0 * n ** 3 + 4 * n * n  # noqa: E731
    per_outer = 2 * (2.0 * a_rows * n * n) + 2 * a_rows + 10 * n * n
    total = init_iters * per_dyk(init_sweeps) \
        + final_iters * per_dyk(final_sweeps)
    for phase in phases:
        outer, ld, s = phase[:3]
        srest = phase[3] if len(phase) == 4 else s
        total += outer * (per_outer + per_dyk(s) + (ld - 1) * per_dyk(srest))
    return total


def headline_flops_per_solve(mean_iters: float, dim=DIM,
                             a_rows=1080) -> float:
    """Estimated FLOPs of one warm-start APG solve (the warm comparison
    route), as the JAX package's ``bench.headline_flops_per_solve``.

    Per outer iteration: the two R x n^2 gradient mat-vecs (4 R n^2), one
    Dykstra iteration whose 16x16 complex eigh is charged at ~30 n^3, the
    reconstruction 8 n^3, and ~12 n^2 of elementwise updates. Plus ~6
    Dykstra iterations of fixed overhead (warm-start projection + the final
    converged projection). ``mean_iters`` is measured per batch
    (``return_iters=True``), not assumed.
    """
    n = dim * dim
    per_dyk = 30.0 * n ** 3 + 8.0 * n ** 3 + 6 * n * n
    per_outer = 4.0 * a_rows * n * n + per_dyk + 12 * n * n
    return mean_iters * per_outer + 6 * per_dyk


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn: Callable, device, reps: Optional[int] = None):
    """(the last run's result, median seconds of ``fn()`` over ``reps`` runs
    (``REPS`` by default) after one warm-up): CUDA events on the card, the
    host clock elsewhere. ``fn`` fetches its outputs to the host, so a run
    ends with them."""
    device = torch.device(device)
    reps = REPS if reps is None else reps
    out = fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t0)
    return out, statistics.median(times)


def _sustained(solve: Callable, device) -> float:
    """Median seconds a solve when ``SUSTAINED_SOLVES`` solves are queued
    back to back and their outputs fetched at the end of the stream."""
    def stream():
        outs = [solve() for _ in range(SUSTAINED_SOLVES)]
        return [o.cpu() for o in outs]

    _sync(torch.device(device))
    return timed(stream, device, SUSTAINED_REPS)[1] / SUSTAINED_SOLVES


def _rel_frob(est: torch.Tensor, chois: torch.Tensor) -> torch.Tensor:
    err = torch.linalg.vector_norm(est - chois, dim=(1, 2))
    return err / torch.linalg.vector_norm(chois, dim=(1, 2))


def _error(e: BaseException) -> str:
    return f"{type(e).__name__}: {e}"[:300]


def _stage(label: str, errors: dict, fn: Callable):
    """``fn()``, or None with the failure recorded under ``label``."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — each stage reports on its own
        errors[label] = _error(e)
        return None


def _route(a, n, chois, method, maxiter, loop_dyk_iters=None,
           warm_start=False, stop_tol=1e-6):
    """A timed call of a per-problem route: its (B,) errors on the host."""
    est = pgdb_process_estimate_batched(
        a, n, dim=DIM, stop_tol=stop_tol, maxiter=maxiter, dyk_tol=1e-4,
        dyk_iters=20, method=method, loop_dyk_iters=loop_dyk_iters,
        warm_start=warm_start)
    return _rel_frob(est, chois).cpu()


def throughput(errors: Optional[dict] = None, comparisons: bool = True, *,
               batch: int = BATCH, device="cuda") -> dict:
    """Measure the config-2 figures on ``device`` (the port of the JAX
    package's ``bench.tpu_throughput``).

    ``comparisons=False`` measures only the two first-class figures (fused
    headline and parity), for ``bench_all``'s config-2 line. ``batch`` and
    ``device`` let the CPU tests run it small; :func:`main` runs the JAX
    sizes on the card. Raises only if the data cannot be made.
    """
    errors = {} if errors is None else errors
    device = torch.device(device)
    a_np = process_tomo_A_matrix(N_QUBITS)
    a = torch.tensor(a_np, dtype=torch.complex64, device=device)
    n, chois = synth_process_datasets(
        torch.Generator(device=device).manual_seed(0), a, DIM, batch, SHOTS)
    # pinv(A) once per experiment design, on the host in float64
    a_pinv = torch.tensor(np.linalg.pinv(a_np.astype(np.complex128)),
                          dtype=torch.complex64, device=device)
    _sync(device)

    def fused(cfg):
        def solve():
            return _rel_frob(apg_fused(a, n, DIM, a_pinv=a_pinv, **cfg),
                             chois)
        return solve

    err_warm = dt_warm = mean_iters = warm_flops = None
    if comparisons:
        timed_warm = _stage("warm_apg", errors, lambda: timed(
            lambda: _route(a, n, chois, "apg", 25, loop_dyk_iters=1,
                           warm_start=True, stop_tol=1e-4), device))
        if timed_warm is not None:
            err_warm, dt_warm = timed_warm
            iters = _stage("warm_apg_iters", errors, lambda: (
                pgdb_process_estimate_batched(
                    a, n, dim=DIM, stop_tol=1e-4, maxiter=25, dyk_tol=1e-4,
                    dyk_iters=20, method="apg", loop_dyk_iters=1,
                    warm_start=True, return_iters=True)[1].cpu()))
            if iters is not None:
                mean_iters = float(iters.double().mean())
                warm_flops = headline_flops_per_solve(mean_iters)

    head_flops = fused_apg_flops_per_solve(**{
        k: v for k, v in HEADLINE_TUNED_2Q.items() if k != "mu"})
    solve_head = fused(HEADLINE_TUNED_2Q)
    err_head, dt_head = _stage(
        "headline_fused", errors,
        lambda: timed(lambda: solve_head().cpu(), device)) or (None, None)
    dt_sustained = None
    if dt_head is not None:
        dt_sustained = _stage("headline_sustained", errors,
                              lambda: _sustained(solve_head, device))

    par_flops = fused_apg_flops_per_solve(**{
        k: v for k, v in PARITY_TUNED_2Q.items() if k != "mu"})
    solve_par = fused(PARITY_TUNED_2Q)
    err_par, dt_par = _stage(
        "parity_fused", errors,
        lambda: timed(lambda: solve_par().cpu(), device)) or (None, None)

    # the comparison routes at their own batch: without the warm start the
    # per-problem loops' tail grows with the batch
    sub = min(COMPARISON_BATCH, batch)
    err_cold = err_pgdb = dt_cold = dt_pgdb = None
    if comparisons:
        n4, c4 = n[:sub], chois[:sub]
        err_cold, dt_cold = _stage("apg_cold", errors, lambda: timed(
            lambda: _route(a, n4, c4, "apg", 25, loop_dyk_iters=2),
            device)) or (None, None)
        err_pgdb, dt_pgdb = _stage("pgdb", errors, lambda: timed(
            lambda: _route(a, n4, c4, "pgdb", 60), device)) or (None, None)

    def per_sec(count, dt):
        return None if dt is None else count / dt

    def gflops(flops, dt):
        return None if dt is None else flops * batch / dt / 1e9

    def mean(err):
        return None if err is None else float(err.double().mean())

    par_gflops = gflops(par_flops, dt_par)
    return {
        "solves_per_sec": per_sec(batch, dt_head),
        "sustained_solves_per_sec": per_sec(batch, dt_sustained),
        "headline_flops_per_solve": head_flops,
        "headline_achieved_gflops": gflops(head_flops, dt_head),
        "warm_apg_solves_per_sec": per_sec(batch, dt_warm),
        "warm_apg_mean_iters": mean_iters,
        "warm_apg_flops_per_solve": warm_flops,
        "parity_solves_per_sec": per_sec(batch, dt_par),
        "parity_flops_per_solve": par_flops,
        "parity_achieved_gflops": par_gflops,
        "parity_fraction_f32_peak": (None if par_gflops is None
                                     else par_gflops * 1e9 / PEAK_FLOPS),
        "mean_rel_frob_err_parity": mean(err_par),
        "apg_cold_solves_per_sec": per_sec(sub, dt_cold),
        "pgdb_solves_per_sec": per_sec(sub, dt_pgdb),
        "batch": batch,
        "sec_per_batch": dt_head,
        "mean_rel_frob_err": mean(err_head),
        "mean_rel_frob_err_warm": mean(err_warm),
        "mean_rel_frob_err_cold": mean(err_cold),
        "mean_rel_frob_err_pgdb": mean(err_pgdb),
        "errors": errors,
    }


# ---------------------------------------------------------------------------
# the f64 parity half, on the CPU

PARITY_BATCH = 4
PARITY_SHOTS = 1000
PARITY_SEED = 7


def _np_proj_cp(c):
    h = (c + c.conj().T) / 2
    w, v = np.linalg.eigh(h)
    return (v * np.clip(w, 0, None)) @ v.conj().T


def _np_proj_tp(c):
    dim = int(np.sqrt(c.shape[0]))
    pt = np.trace(c.reshape(dim, dim, dim, dim), axis1=1, axis2=3)
    return c - np.kron((pt - np.eye(dim)) / dim, np.eye(dim))


def _np_proj_cptp(choi, tol=1e-4):
    """Dykstra's alternating CP / TP projections with the Birgin stopping
    criterion, in numpy."""
    old_cp = np.zeros_like(choi)
    old_tp = np.zeros_like(choi)
    last_cp_proj = np.zeros_like(choi)
    last = choi
    while True:
        pre_cp = last - old_cp
        cp_proj = _np_proj_cp(pre_cp)
        new_cp = cp_proj - pre_cp
        pre_tp = cp_proj - old_tp
        new = _np_proj_tp(pre_tp)
        new_tp = new - pre_tp
        crit = (np.linalg.norm(new_cp - old_cp) ** 2
                + np.linalg.norm(new_tp - old_tp) ** 2
                + 2 * abs(np.vdot(old_tp, new - last))
                + 2 * abs(np.vdot(old_cp, cp_proj - last_cp_proj)))
        if crit < tol:
            return new
        old_cp, old_tp, last_cp_proj, last = new_cp, new_tp, cp_proj, new


def _np_pgdb(a, n, dim, stop_tol=1e-10):
    """Projected gradient descent with backtracking [PGD], in plain numpy:
    est0 = I/d, mu = 3/(2 d^2), gamma = 0.3; the oracle PGDB is held to."""
    def npvec(m):
        return m.T.reshape(-1)

    def npunvec(v):
        d2 = int(np.sqrt(v.size))
        return v.reshape(d2, d2).T

    def cost(est):
        p = np.clip(np.real(a @ npvec(est)), 1e-6, None)
        return -np.sum(n * np.log(p))

    def grad(est):
        p = np.clip(np.real(a @ npvec(est)), 1e-6, None)
        return npunvec(-(a.conj().T @ (n / p)))

    est = np.eye(dim * dim, dtype=complex) / dim
    old_cost = cost(est)
    mu = 3 / (2 * dim ** 2)
    gamma = 0.3
    while True:
        g = grad(est)
        update = _np_proj_cptp(est - g / mu) - est
        alpha = 1.0
        change = gamma * np.real(np.vdot(update, g))
        new_cost = cost(est + alpha * update)
        while new_cost > old_cost + change:
            alpha *= 0.5
            change *= 0.5
            new_cost = cost(est + alpha * update)
            if alpha < 1e-15:
                break
        est = est + alpha * update
        if old_cost - new_cost < stop_tol:
            return est
        old_cost = new_cost


def parity_figures(a_np: np.ndarray, n_np: np.ndarray,
                   shots: int) -> Dict[str, float]:
    """The seven f64 parity figures of the JAX package's ``PARITY_SNIPPET``
    on given counts, on the CPU in float64.

    ``a_np`` is the (R, 256) 2Q process-tomography A-matrix, ``n_np`` the
    (B, R) normalized counts and ``shots`` the shots a setting (for the
    grand total N = shots x setting pairs).

    - ``max_deviation_vs_oracle``: PGDB against the numpy PGD oracle;
    - ``apg_vs_converged_pgdb``: APG (40 steps, no stop) against PGDB
      converged (stop_tol 1e-12, 3000 steps, 200 Dykstra iterations);
    - ``warm_apg_*``: the warm comparison route at its production settings,
      its deviation from the converged PGDB and its likelihood-ratio
      statistic 2 N deltaLL;
    - ``headline_*``: the same for the fused ``HEADLINE_TUNED_2Q``;
    - ``fused_parity_dev``: the fused ``PARITY_TUNED_2Q`` against PGDB
      converged with tight projections (dyk_tol 1e-10, 500 iterations).
    """
    a = torch.tensor(a_np, dtype=torch.complex128)
    n = torch.tensor(n_np, dtype=torch.float64)

    def pgdb(**kw):
        return pgdb_process_estimate_batched(a, n, dim=DIM, **kw).numpy()

    ours = pgdb()
    dev = max(np.max(np.abs(ours[i] - _np_pgdb(a_np, n_np[i], DIM)))
              for i in range(n_np.shape[0]))
    apg = pgdb(stop_tol=0.0, maxiter=40, method="apg")
    conv = pgdb(stop_tol=1e-12, maxiter=3000, dyk_iters=200)
    warm = pgdb(stop_tol=1e-4, maxiter=25, dyk_tol=1e-4, dyk_iters=20,
                method="apg", warm_start=True, loop_dyk_iters=1)

    def cost(est):
        v = vec(torch.from_numpy(est))[..., 0].numpy()
        p = np.maximum((v @ a_np.T).real, 1e-12)
        return -(n_np * np.log(p)).sum(axis=1)

    grand_total = shots * (a_np.shape[0] // 2)

    def llr(est):
        return float(np.max(cost(est) - cost(conv)) * 2 * grand_total)

    head = apg_fused(a, n, DIM, use_pallas=False,
                     **HEADLINE_TUNED_2Q).numpy()
    tight = pgdb(stop_tol=1e-14, maxiter=3000, dyk_tol=1e-10, dyk_iters=500)
    fused = apg_fused(a, n, DIM, use_pallas=False, **PARITY_TUNED_2Q).numpy()
    return {"max_deviation_vs_oracle": float(dev),
            "apg_vs_converged_pgdb": float(np.max(np.abs(apg - conv))),
            "warm_apg_vs_converged_pgdb": float(np.max(np.abs(warm - conv))),
            "warm_apg_llr_statistic": llr(warm),
            "headline_vs_converged_pgdb": float(np.max(np.abs(head - conv))),
            "headline_llr_statistic": llr(head),
            "fused_parity_dev": float(np.max(np.abs(fused - tight)))}


def cpu_parity() -> Dict[str, float]:
    """:func:`parity_figures` on the JAX snippet's sizes (B = 4 datasets at
    1000 shots), drawn on the CPU in float64 from a generator seeded 7."""
    cpu = torch.device("cpu")
    a_np = process_tomo_A_matrix(N_QUBITS)
    n, _ = synth_process_datasets(
        torch.Generator(device=cpu).manual_seed(PARITY_SEED),
        torch.tensor(a_np, dtype=torch.complex128, device=cpu), DIM,
        PARITY_BATCH, PARITY_SHOTS, dtype=torch.float64)
    return parity_figures(a_np, n.numpy(), PARITY_SHOTS)


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _r(x, ndigits=None):
    """round() that passes None through."""
    if x is None:
        return None
    return round(x, ndigits) if ndigits is not None else round(x)


def _ratio(x, y):
    return None if x is None else round(x / y, 4)


def main() -> dict:
    """Measure, print the one JSON line, and return it as a dict."""
    errors = {}
    try:
        perf = throughput(errors)
    except Exception as e:  # noqa: BLE001 — the line is printed regardless
        errors["throughput"] = _error(e)
        perf = {"batch": BATCH}
    parity = _stage("parity", errors, cpu_parity) or {}
    g, p = perf.get, parity.get
    result = {
        "metric": "2q_process_tomography_mle_throughput",
        "value": _r(g("solves_per_sec"), 2),
        "unit": "solves/sec",
        "vs_baseline": _ratio(g("solves_per_sec"), TARGET_SOLVES_PER_SEC),
        "sustained_solves_per_sec": _r(g("sustained_solves_per_sec"), 2),
        "headline_llr_statistic_f64": p("headline_llr_statistic"),
        "headline_vs_converged_pgdb_f64": p("headline_vs_converged_pgdb"),
        "headline_flops_per_solve": _r(g("headline_flops_per_solve")),
        "headline_achieved_gflops": _r(g("headline_achieved_gflops"), 1),
        "warm_apg_solves_per_sec": _r(g("warm_apg_solves_per_sec"), 2),
        "warm_apg_mean_iters": _r(g("warm_apg_mean_iters"), 2),
        "warm_apg_flops_per_solve": _r(g("warm_apg_flops_per_solve")),
        "parity_solves_per_sec": _r(g("parity_solves_per_sec"), 2),
        "parity_vs_baseline": _ratio(g("parity_solves_per_sec"),
                                     TARGET_SOLVES_PER_SEC),
        "parity_flops_per_solve": _r(g("parity_flops_per_solve")),
        "parity_achieved_gflops": _r(g("parity_achieved_gflops"), 1),
        "parity_fraction_f32_peak": _r(g("parity_fraction_f32_peak"), 4),
        "fused_parity_dev_f64": p("fused_parity_dev"),
        "mean_rel_frob_err_parity_f32": _r(g("mean_rel_frob_err_parity"), 5),
        "batch": g("batch"),
        "apg_cold_solves_per_sec": _r(g("apg_cold_solves_per_sec"), 2),
        "pgdb_solves_per_sec": _r(g("pgdb_solves_per_sec"), 2),
        "mean_rel_frob_err_f32": _r(g("mean_rel_frob_err"), 5),
        "mean_rel_frob_err_warm_f32": _r(g("mean_rel_frob_err_warm"), 5),
        "mean_rel_frob_err_cold_f32": _r(g("mean_rel_frob_err_cold"), 5),
        "mean_rel_frob_err_pgdb_f32": _r(g("mean_rel_frob_err_pgdb"), 5),
        "max_deviation_vs_oracle_f64": p("max_deviation_vs_oracle"),
        "apg_vs_converged_pgdb_f64": p("apg_vs_converged_pgdb"),
        "warm_apg_vs_converged_pgdb_f64": p("warm_apg_vs_converged_pgdb"),
        "warm_apg_llr_statistic_f64": p("warm_apg_llr_statistic"),
        "statistic": STATISTIC,
        "device": _stage("device", errors, card),
    }
    if errors:
        result["errors"] = errors
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
