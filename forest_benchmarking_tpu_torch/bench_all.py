"""The five BASELINE configurations on one card, one JSON line each.

The port's counterpart of the JAX package's ``bench_all.py``, with its
eight sections in its order and its sizes:

  1. 1Q state tomography: linear inversion + Bloch MLE, B = 262144;
  2. 2Q process tomography (``bench.throughput(comparisons=False)``);
  3. RB decay fits, B = 65536 curves, 8 depths, 50 LM steps;
  4. channel distances at B = 1024 pairs and diamond norms at B = 2048;
  5. quantum volume: ideal at depth 8, noisy at depth 4 by ``"auto"``,
     noisy at depth 8 by trajectories at T = 1000 and T = 500.

Run on a machine with an NVIDIA GPU:

    python -m forest_benchmarking_tpu_torch.bench_all [out.jsonl]

``out.jsonl`` (``chiprun_out/bench_all.jsonl`` by default) is rewritten
by each run, as the JAX harness's file is: each section's line is printed,
written and flushed as soon as the section ends.
A section that raises gives ``{"metric": name, "value": null, "error":
...}`` and the next one runs. Every random draw comes from a
``torch.Generator`` seeded as the JAX keys are, on the card and outside the
timed window; a time is the median of 3 runs after one warm-up, each
fetching its outputs to the host, by CUDA events (``bench.timed``). Every
section takes ``device`` (the card by default) and its sizes as keyword
arguments.
"""
from __future__ import annotations

import json
import math
import pathlib
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from forest_benchmarking_tpu_torch import bench
from forest_benchmarking_tpu_torch.analysis.fitting import (
    _base_param_decay_p, fit_model_batched, lm_flops_per_fit)
from forest_benchmarking_tpu_torch.distance_measures import (
    diamond_norm_distance, process_fidelity, trace_distance)
from forest_benchmarking_tpu_torch.ops import lanes_dnorm
from forest_benchmarking_tpu_torch.ops.pallas_traj import (
    traj_flops_per_circuit)
from forest_benchmarking_tpu_torch.ops.random_operators import (
    rand_map_with_BCSZ_dist)
from forest_benchmarking_tpu_torch.ops.superoperator_transformations import (
    choi2pauli_liouville)
from forest_benchmarking_tpu_torch.quantum_volume import (
    _noisy_method, sample_heavy_outputs_batched)
from forest_benchmarking_tpu_torch.sim.noise import depolarizing_kraus_map
from forest_benchmarking_tpu_torch.tomography import (
    iterative_mle_state_estimate_batched, mle_bloch_flops_per_solve)
from forest_benchmarking_tpu_torch.utils import pauli_basis_matrices

__all__ = ["main", "config1_state_tomo", "config2_process_tomo",
           "config3_rb_fits", "config4_dfe_distances",
           "config5_quantum_volume", "config5_noisy_quantum_volume",
           "DEFAULT_OUT"]

DT = torch.float32
REPS = 3
DEFAULT_OUT = "chiprun_out/bench_all.jsonl"


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def timed(fn, device):
    """(outputs on the host, median seconds) of ``fn()``: ``bench.timed``
    with the outputs fetched inside each timed run."""
    def run():
        out = fn()
        return (tuple(x.cpu() for x in out) if isinstance(out, tuple)
                else out.cpu())
    return bench.timed(run, device, REPS)


def config1_state_tomo(batch=262144, shots=2000, *, device="cuda"):
    """1Q state tomography: linear inversion and the Bloch MLE of Pauli
    shots, with each problem's fidelity to its true state.

    Haar 1Q pure states (normalized complex Gaussian 2-vectors) and
    binomial shots per Pauli are drawn first; the timed region is the two
    estimators and the two (B,) fidelity arrays. For XYZ data the linear
    inversion Bloch vector is r = e; the MLE runs from the projected linear
    inversion start for 60 steps (``representation="bloch"``); fidelity
    against the pure state is (1 + r . r_true) / 2.
    """
    g = _generator(0, device)
    z = torch.randn((batch, 2, 2), generator=g, device=g.device, dtype=DT)
    psi = torch.complex(z[..., 0], z[..., 1])
    psi = psi / torch.linalg.vector_norm(psi, dim=-1, keepdim=True)
    ab = psi[:, 0].conj() * psi[:, 1]
    r_true = torch.stack([2 * ab.real, 2 * ab.imag,
                          psi[:, 0].abs() ** 2 - psi[:, 1].abs() ** 2], -1)
    k = torch.binomial(torch.full_like(r_true, float(shots)),
                       (1 + r_true) / 2, generator=g)
    e = 2 * k / shots - 1
    obs = pauli_basis_matrices(1)[1:]
    num_meas = torch.full((batch,), 3.0 * shots, dtype=DT, device=g.device)

    def step():
        r_mle = iterative_mle_state_estimate_batched(
            obs, e, num_meas, tol=1e-7, maxiter=60, warm_start=True,
            representation="bloch")
        f_lin = (1 + (e * r_true).sum(-1)) / 2
        f_mle = (1 + (r_mle * r_true).sum(-1)) / 2
        return f_lin, f_mle

    (f_lin, f_mle), dt = timed(step, device)
    flops = mle_bloch_flops_per_solve(60) + 2 * 3 * 2  # + the two fidelities
    return {
        "metric": "1q_state_tomography_lininv_plus_mle_throughput",
        "value": round(batch / dt, 2), "unit": "solves/sec",
        "vs_baseline": None, "batch": batch,
        "mle_flops_per_solve": flops,
        "achieved_gflops": round(flops * batch / dt / 1e9, 2),
        "mean_fidelity_lin": round(float(f_lin.double().mean()), 5),
        "mean_fidelity_mle": round(float(f_mle.double().mean()), 5),
    }


def config3_rb_fits(batch=65536, n_depths=8, shots=500, *, device="cuda"):
    """Batched LM decay fits over synthetic RB survival data: decays
    uniform in [0.9, 0.995), depths 2, 6, ..., binomial shots; the timed
    region is ``fit_model_batched`` (50 steps) and the fitted decays."""
    g = _generator(1, device)
    depths = torch.arange(2, 2 + 4 * n_depths, 4, dtype=DT, device=g.device)
    decays = 0.9 + 0.095 * torch.rand(batch, generator=g, device=g.device,
                                      dtype=DT)
    survivals = 0.5 + 0.5 * decays[:, None] ** depths[None, :]
    y = torch.binomial(torch.full_like(survivals, float(shots)), survivals,
                       generator=g) / shots
    x = depths.expand(batch, n_depths)
    p0 = torch.tensor([0.5, 0.95, 0.5], dtype=DT, device=g.device)

    def step():
        params, _, _ = fit_model_batched(_base_param_decay_p, x, y, None, p0,
                                         num_iters=50)
        return params[:, 1]

    fit_decays, dt = timed(step, device)
    errs = (fit_decays - decays.cpu()).abs()
    flops = lm_flops_per_fit(n_depths, 3, 50)
    # decays near 1 at shallow depths are weakly identified, so the max
    # error is statistics-dominated; the mean is the quality figure
    return {
        "metric": "rb_decay_fit_throughput", "value": round(batch / dt, 2),
        "unit": "fits/sec", "vs_baseline": None, "batch": batch,
        "lm_flops_per_fit": flops,
        "achieved_gflops": round(flops * batch / dt / 1e9, 2),
        "mean_decay_error": round(float(errs.double().mean()), 5),
        "max_decay_error": round(float(errs.max()), 5),
    }


def config4_dfe_distances(batch=1024, dnorm_batch=2048, *, device="cuda"):
    """Distance measures over random 2Q channels (BCSZ, Kraus rank 16) and
    batched diamond norms (``method="auto"``: the fused route on the card).

    The channel stacks are drawn before the timed regions; the figure with
    the generation of its channels is ``incl_generation_pairs_per_sec``.
    ``dnorm_method`` is the route the diamond norms took: "fused" when
    ``ops.lanes_dnorm.dnorm_planes`` ran, else "dense".
    """
    def draw(seed, n):
        g = _generator(seed, device)
        return [rand_map_with_BCSZ_dist(g, 4, 16, batch=(n,), dtype=DT)
                for _ in range(2)]

    dist = draw(2, batch)
    dnorm = draw(3, dnorm_batch)

    def dist_step(chois1, chois2):
        pf = process_fidelity(choi2pauli_liouville(chois1),
                              choi2pauli_liouville(chois2))
        return pf.real, trace_distance(chois1 / 4, chois2 / 4)

    _, dt_dist = timed(lambda: dist_step(*dist), device)
    _, dt_incl = timed(lambda: dist_step(*draw(2, batch)), device)
    fused_calls = [0]
    planes = lanes_dnorm.dnorm_planes

    def counted(*args, **kwargs):
        fused_calls[0] += 1
        return planes(*args, **kwargs)

    lanes_dnorm.dnorm_planes = counted
    try:
        dn, dt_dnorm = timed(lambda: diamond_norm_distance(*dnorm), device)
    finally:
        lanes_dnorm.dnorm_planes = planes
    return {
        "metric": "channel_distance_throughput",
        "value": round(batch / dt_dist, 2), "unit": "channel-pairs/sec",
        "vs_baseline": None, "batch": batch,
        "incl_generation_pairs_per_sec": round(batch / dt_incl, 2),
        "diamond_norms_per_sec": round(dnorm_batch / dt_dnorm, 2),
        "dnorm_batch": dnorm_batch,
        "dnorm_method": "fused" if fused_calls[0] else "dense",
        "mean_diamond_norm": round(float(dn.double().mean()), 4),
    }


def config5_quantum_volume(depth=8, num_circuits=1600, shots=1000, *,
                           device="cuda"):
    """Ideal heavy-output sampling over a batch of circuits (the ideal QV
    kernel on the card); every timed call draws the same circuits."""
    def step():
        return sample_heavy_outputs_batched(
            _generator(4, device), depth, num_circuits, shots, dtype=DT,
            device=device)

    num_heavy, dt = timed(step, device)
    prob = int(num_heavy.sum()) / (num_circuits * shots)
    return {
        "metric": f"qv_depth{depth}_heavy_output_sim_throughput",
        "value": round(num_circuits / dt, 2), "unit": "circuits/sec",
        "vs_baseline": None, "num_circuits": num_circuits,
        "heavy_output_prob": round(prob, 4),
        "ideal_asymptote": round((1 + math.log(2)) / 2, 4),
    }


def config5_noisy_quantum_volume(depth=4, num_circuits=800, shots=1000,
                                 depol_p=0.02, noisy_method="auto",
                                 num_trajectories=None, *, device="cuda"):
    """Noisy heavy-output sampling, one call for the whole circuit batch,
    with 2Q depolarizing noise (the tensor square of the 1Q channel) after
    every gate: ``"density"`` is exact, ``"trajectory"`` the Kraus
    unravelling (the trajectory kernel on the card); ``"auto"`` takes the
    density method to depth 6.

    ``traj_flops_per_circuit`` counts the trajectory kernel's work for this
    call: ``num_trajectories`` (else ``shots``) noisy trajectories and the
    one noiseless evolution of the heavy set. The JAX count pads both to
    its 128-lane block; the CUDA kernel runs no padding.
    """
    ks = depolarizing_kraus_map(depol_p)
    kraus = torch.tensor(np.stack([np.kron(a, b) for a in ks for b in ks]),
                         dtype=torch.complex64, device=torch.device(device))

    def step():
        return sample_heavy_outputs_batched(
            _generator(6, device), depth, num_circuits, shots, dtype=DT,
            kraus=kraus, noisy_method=noisy_method,
            num_trajectories=num_trajectories, device=device)

    num_heavy, dt = timed(step, device)
    out = {
        "metric": f"qv_depth{depth}_noisy_heavy_output_sim_throughput",
        "value": round(num_circuits / dt, 2), "unit": "circuits/sec",
        "vs_baseline": None, "num_circuits": num_circuits,
        "depolarizing_p": depol_p,
        "heavy_output_prob": round(
            int(num_heavy.sum()) / (num_circuits * shots), 4),
    }
    if noisy_method != "auto":
        out["noisy_method"] = noisy_method
    if num_trajectories is not None:
        out["num_trajectories"] = num_trajectories
    if _noisy_method(depth, noisy_method) == "trajectory":
        t = shots if num_trajectories is None else num_trajectories
        flops = traj_flops_per_circuit(depth, kraus.shape[0], t) \
            + traj_flops_per_circuit(depth, num_trajectories=1,
                                     noiseless=True)
        out["traj_flops_per_circuit"] = round(flops)
        out["traj_achieved_gflops"] = round(
            flops * num_circuits / dt / 1e9, 1)
    return out


def config2_process_tomo(*, batch=bench.BATCH, device="cuda"):
    """The north-star configuration in compact form: the two fused figures
    (``bench.throughput(comparisons=False)``); ``python -m
    forest_benchmarking_tpu_torch.bench`` is the full receipt."""
    errors = {}
    perf = bench.throughput(errors, comparisons=False, batch=batch,
                            device=device)
    out = {
        "metric": "2q_process_tomography_mle_throughput",
        "value": bench._r(perf["solves_per_sec"], 2), "unit": "solves/sec",
        "vs_baseline": bench._ratio(perf["solves_per_sec"],
                                    bench.TARGET_SOLVES_PER_SEC),
        "batch": perf["batch"],
        "sustained_solves_per_sec": bench._r(
            perf["sustained_solves_per_sec"], 2),
        "parity_solves_per_sec": bench._r(perf["parity_solves_per_sec"], 2),
        "parity_achieved_gflops": bench._r(perf["parity_achieved_gflops"], 1),
        "full_receipt": "python -m forest_benchmarking_tpu_torch.bench",
    }
    if errors:
        out["errors"] = errors
    return out


def sections():
    """(name, zero-argument callable) of the eight sections, in order, at
    the JAX package's sizes on the card."""
    return [
        ("config1", lambda: config1_state_tomo()),
        ("config2", lambda: config2_process_tomo()),
        ("config3", lambda: config3_rb_fits()),
        ("config4", lambda: config4_dfe_distances()),
        ("config5_ideal", lambda: config5_quantum_volume()),
        ("config5_noisy_d4", lambda: config5_noisy_quantum_volume()),
        ("config5_noisy_d8", lambda: config5_noisy_quantum_volume(
            depth=8, num_circuits=1600, noisy_method="trajectory")),
        ("config5_noisy_d8_t500", lambda: config5_noisy_quantum_volume(
            depth=8, num_circuits=1600, noisy_method="trajectory",
            num_trajectories=500)),
    ]


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Run every section; print each line and write it to the file (made
    anew) as the section ends. Return the lines as dicts."""
    argv = sys.argv[1:] if argv is None else argv
    path = pathlib.Path(argv[0] if argv else DEFAULT_OUT)
    path.parent.mkdir(parents=True, exist_ok=True)
    results = []
    with open(path, "w") as f:
        for name, fn in sections():
            try:
                line = fn()
            except Exception as e:  # noqa: BLE001 — the next section runs
                line = {"metric": name, "value": None,
                        "error": bench._error(e)}
            results.append(line)
            text = json.dumps(line)
            print(text, flush=True)
            f.write(text + "\n")
            f.flush()
    return results


if __name__ == "__main__":
    main()
