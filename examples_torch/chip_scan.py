"""Example: scan a whole device graph in a handful of simultaneous campaigns.

The port's counterpart of ``examples/chip_scan.py``: given a chip topology,
characterize every qubit and every edge with a few merged experiments
instead of one experiment per qubit or pair:

  1. readout confusion matrices for every qubit;
  2. single-shot simultaneous 1Q state tomography of all qubits at once
     (one merged ObservablesExperiment via merge_disjoint_experiments,
     results re-bucketed per qubit with get_results_by_qubit_groups);
  3. simultaneous T1 on all qubits under an injected decoherence model;
  4. simultaneous single-qubit RB on all qubits in one campaign;
  5. two-qubit process tomography on a set of disjoint edges (a graph
     matching) in one merged acquisition.

The QVM and the estimators run on the chosen device. Run on the card with
``python examples_torch/chip_scan.py``, or on the CPU with ``--device cpu``.
"""
import argparse
import sys
from pathlib import Path

if __name__ == "__main__":   # a script: import the port from this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from forest_benchmarking_tpu_torch.circuits import CZ, RX, Circuit
from forest_benchmarking_tpu_torch.distance_measures import fidelity
from forest_benchmarking_tpu_torch.observable_estimation import (
    estimate_observables, get_results_by_qubit_groups,
    merge_disjoint_experiments)
from forest_benchmarking_tpu_torch.ops.superoperator_transformations import (
    kraus2choi)
from forest_benchmarking_tpu_torch.qubit_spectroscopy import do_t1_or_t2
from forest_benchmarking_tpu_torch.randomized_benchmarking import (
    do_rb, rb_decay_to_gate_error)
from forest_benchmarking_tpu_torch.readout import (
    estimate_joint_confusion_in_set)
from forest_benchmarking_tpu_torch.sim import QVM
from forest_benchmarking_tpu_torch.tomography import (
    generate_process_tomography_experiment,
    generate_state_tomography_experiment, iterative_mle_state_estimate,
    pgdb_process_estimate)

# ----- the chip: a 2x3 lattice ------------------------------------------------
#   0 - 1 - 2
#   |   |   |
#   3 - 4 - 5
QUBITS = [0, 1, 2, 3, 4, 5]
EDGES = [(0, 1), (1, 2), (0, 3), (1, 4), (2, 5), (3, 4), (4, 5)]
MATCHING = [(0, 1), (2, 5), (3, 4)]      # disjoint edges -> one campaign


def main(device="cuda", out_dir="/tmp"):
    qvm = QVM(seed=11, t1s={q: 20e-6 for q in QUBITS},
              t2s={q: 15e-6 for q in QUBITS}, device=device)
    dev = qvm.device

    # ----- 1. readout characterization, all qubits ---------------------------
    confusion = estimate_joint_confusion_in_set(qvm, qubits=QUBITS,
                                                num_shots=400,
                                                joint_group_size=1)
    worst_f00 = min(confusion[(q,)][0, 0] for q in QUBITS)
    out = {"worst_p00": float(worst_f00)}
    print(f"readout: worst p(0|0) across {len(QUBITS)} qubits = "
          f"{worst_f00:.3f}")

    # ----- 2. simultaneous 1Q state tomography -------------------------------
    # characterize the RX(pi/2) state on every qubit with ONE merged
    # experiment (disjoint qubit sets share acquisition shots)
    merged = merge_disjoint_experiments([
        generate_state_tomography_experiment(Circuit([RX(np.pi / 2, q)]), [q])
        for q in QUBITS])
    results = list(estimate_observables(qvm, merged, num_shots=400))
    by_qubit = get_results_by_qubit_groups(results, [(q,) for q in QUBITS])
    target = torch.tensor([[0.5, 0.5j], [-0.5j, 0.5]],   # RX(pi/2)|0>
                          dtype=torch.complex128, device=dev)
    fids = []
    for q in QUBITS:
        rho = iterative_mle_state_estimate(by_qubit[(q,)], [q], maxiter=2000,
                                           device=dev)
        fids.append(float(fidelity(target, rho).real))
    out["min_state_fidelity"] = min(fids)
    print(f"state tomo: {len(QUBITS)} qubits in one campaign, "
          f"min F(|+y-ish>) = {min(fids):.4f}")

    # ----- 3. simultaneous T1 ------------------------------------------------
    times = np.linspace(1e-6, 30e-6, 6)
    t1s, _, _ = do_t1_or_t2(qvm, QUBITS, times, kind="t1", num_shots=200)
    out["t1_us"] = np.array([t1s[q] for q in QUBITS])
    print("T1 (us), injected 20:", {q: round(t, 1) for q, t in t1s.items()})

    # ----- 4. simultaneous 1Q RB ---------------------------------------------
    groups = [(q,) for q in QUBITS]
    depths = [d for d in [2, 8, 16] for _ in range(4)]
    decays, _, _ = do_rb(qvm, groups, depths, num_shots=60, random_seed=5)
    errs = {g[0]: rb_decay_to_gate_error(d, 1) for g, d in decays.items()}
    out["max_rb_error"] = max(errs.values())
    print(f"simultaneous RB on {len(groups)} qubits: max avg gate error "
          f"{max(errs.values()):.2e}")

    # ----- 5. process tomography on a graph matching -------------------------
    cz_expts = [generate_process_tomography_experiment(Circuit([CZ(a, b)]),
                                                       [a, b])
                for (a, b) in MATCHING]
    merged_cz = merge_disjoint_experiments(cz_expts)
    cz_results = list(estimate_observables(qvm, merged_cz, num_shots=300))
    by_edge = get_results_by_qubit_groups(cz_results, MATCHING)
    cz = torch.tensor(np.diag([1, 1, 1, -1]).astype(complex), device=dev)
    cz_choi = kraus2choi(cz[None])
    out["cz_fidelity"] = []
    for (a, b) in MATCHING:
        est = pgdb_process_estimate(by_edge[(a, b)], [a, b], maxiter=200,
                                    device=dev)
        f_pro = float(fidelity(cz_choi / 4, est / 4).real)
        out["cz_fidelity"].append(f_pro)
        print(f"edge ({a},{b}): CZ process fidelity {f_pro:.3f}")

    print(f"chip scan complete: {len(QUBITS)} qubits + {len(MATCHING)} edges "
          "in 5 merged campaigns")
    out["cz_fidelity"] = np.array(out["cz_fidelity"])
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
