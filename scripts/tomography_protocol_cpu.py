#!/usr/bin/env python3
"""The bars of ``chip_smoke.py`` phase 17, measured on the CPU.

Run from the root of a checkout:

    python3 scripts/tomography_protocol_cpu.py fidelity --package jax \\
        --kind process --seeds 1 2 3
    python3 scripts/tomography_protocol_cpu.py fidelity --package torch \\
        --kind state --seeds 1 2 3
    python3 scripts/tomography_protocol_cpu.py fused --seeds 2041

``fidelity`` runs ``do_tomography`` at its defaults (1000 shots,
exhaustive symmetrization, greedy grouping, calibration) on phase 17's
programs with the QVM of the JAX package (``--package jax``, on the CPU
in float64) or of the port (``--package torch``, ``device="cpu"``), one
QVM seed after another: ``process`` is CZ(0, 1) with 2% two-qubit
depolarizing noise on CZ and readout confusion p(0|0) = 0.98, p(1|1) = 0.95
on both qubits, scored by the process fidelity to the true channel;
``state`` is the 3Q GHZ state under the same readout confusion, scored by
its fidelity to GHZ. It prints each seed's figure and the range.

``fused`` takes the port's process tomography of each seed, on the CPU,
and solves its counts before and after calibration with the fused APG
solver of both packages (plain versions, float64) under the default
schedule and the two tuned dim = 4 schedules, and prints each estimate's
relative Frobenius distance to ``pgdb_process_estimate`` on the same
results: the bar of phase 17(c).

The JAX package is imported only with ``--package jax`` and by ``fused``.
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

DEPOL = 0.02
READOUT = (0.98, 0.95)


def programs(circuits, noise):
    """(noisy CZ, its Kraus set, the GHZ program) in one package."""
    kraus = noise.pauli_kraus_map([1 - 15 * DEPOL / 16] + [DEPOL / 16] * 15)
    cz = circuits.Circuit([circuits.CZ(0, 1)])
    cz.define_noisy_gate("CZ", [0, 1], kraus)
    ghz = circuits.Circuit([circuits.H(0), circuits.CNOT(0, 1),
                            circuits.CNOT(1, 2)])
    for q in range(3):
        ghz.define_noisy_readout(q, *READOUT)
        if q < 2:
            cz.define_noisy_readout(q, *READOUT)
    return cz, kraus, ghz


def jax_modules():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from forest_benchmarking_tpu import circuits, tomography
    from forest_benchmarking_tpu import distance_measures as dm
    from forest_benchmarking_tpu.ops import choi2pauli_liouville, kraus2choi
    from forest_benchmarking_tpu.sim import QVM, noise
    return dict(circuits=circuits, tomography=tomography, dm=dm, noise=noise,
                qvm=lambda seed: QVM(seed=seed), tensor=jnp.asarray,
                c2pl=choi2pauli_liouville, k2c=kraus2choi)


def torch_modules():
    import torch
    from forest_benchmarking_tpu_torch import circuits, tomography
    from forest_benchmarking_tpu_torch import distance_measures as dm
    from forest_benchmarking_tpu_torch.ops import (
        choi2pauli_liouville, kraus2choi)
    from forest_benchmarking_tpu_torch.sim import QVM, noise
    return dict(circuits=circuits, tomography=tomography, dm=dm, noise=noise,
                qvm=lambda seed: QVM(seed=seed, device="cpu"),
                tensor=torch.tensor, c2pl=choi2pauli_liouville,
                k2c=kraus2choi)


def fidelity(m, kind, seed):
    cz, kraus, ghz = programs(m["circuits"], m["noise"])
    if kind == "process":
        est, _, _ = m["tomography"].do_tomography(m["qvm"](seed), cz, [0, 1],
                                                  "process")
        truth = m["k2c"](m["tensor"](np.stack(m["noise"].append_kraus_to_gate(
            kraus, m["circuits"].gate_matrix("CZ")))))
        return float(np.real(np.asarray(m["dm"].process_fidelity(
            m["c2pl"](truth), m["c2pl"](est)))))
    est, _, _ = m["tomography"].do_tomography(m["qvm"](seed), ghz, [0, 1, 2],
                                              "state")
    psi = np.zeros(8, dtype=complex)
    psi[0] = psi[7] = 2 ** -0.5
    return float(np.real(np.asarray(m["dm"].fidelity(
        m["tensor"](np.outer(psi, psi.conj())), est))))


def fused(seed):
    import jax.numpy as jnp
    import torch
    from forest_benchmarking_tpu.ops import lanes_apg as jax_lanes
    from forest_benchmarking_tpu_torch.benchmarks import inputs_from_numpy
    from forest_benchmarking_tpu_torch.ops import lanes_apg
    m = torch_modules()
    tomo = m["tomography"]
    cz, _, _ = programs(m["circuits"], m["noise"])
    _, _, res = tomo.do_tomography(m["qvm"](seed), cz, [0, 1], "process")
    raw = [tomo.ExperimentResult(setting=r.setting, total_counts=r.total_counts,
                                 expectation=r.raw_expectation,
                                 std_err=r.raw_std_err) for r in res]
    schedules = {"default": {}, "headline": lanes_apg.HEADLINE_TUNED_2Q,
                 "parity": lanes_apg.PARITY_TUNED_2Q}
    for name, results in (("before calibration", raw), ("calibrated", res)):
        a, n = tomo._extract_from_results(results, [0, 1])
        pgdb = tomo.pgdb_process_estimate(results, [0, 1], device="cpu")
        inp = inputs_from_numpy(a, n[None], device="cpu", dtype=torch.float64)
        for sched, cfg in schedules.items():
            est = lanes_apg.apg_fused(inp.a, inp.n, 4, a_pinv=inp.a_pinv,
                                      **cfg)[0]
            want = np.asarray(jax_lanes.apg_fused(
                jnp.asarray(a), jnp.asarray(n[None]), dim=4,
                use_pallas=False, **cfg))[0]
            gap = (torch.linalg.norm(est - pgdb) / torch.linalg.norm(pgdb))
            print(f"seed {seed} {name} {sched}: min count {n.min():.3e}, "
                  f"fused rel Frobenius to PGDB {gap.item():.3e}, max "
                  f"|estimate| {est.abs().max().item():.4g}, max |port - "
                  f"JAX| {np.abs(est.numpy() - want).max():.3e}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("what", choices=("fidelity", "fused"))
    parser.add_argument("--package", choices=("jax", "torch"), default="torch")
    parser.add_argument("--kind", choices=("process", "state"),
                        default="process")
    parser.add_argument("--seeds", type=int, nargs="+", default=[1])
    args = parser.parse_args()
    if args.what == "fused":
        for seed in args.seeds:
            fused(seed)
        return 0
    m = jax_modules() if args.package == "jax" else torch_modules()
    figures = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        figures.append(fidelity(m, args.kind, seed))
        print(f"{args.package} {args.kind} seed {seed}: fidelity "
              f"{figures[-1]:.6f} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    print(f"{args.package} {args.kind}: {len(figures)} seeds, fidelity "
          f"{min(figures):.6f} to {max(figures):.6f}, mean "
          f"{np.mean(figures):.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
