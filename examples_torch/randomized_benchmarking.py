"""Example: standard RB with injected noise, recovering the decay parameter.

The port's counterpart of ``examples/randomized_benchmarking.py``: standard
RB under a depolarizing channel per Clifford, then interleaved RB and
unitarity RB on a noiseless QVM. Sequences come from seeded numpy draws, as
in the JAX package; shots from the QVM's ``torch.Generator``; the fits run
on the QVM's device.

Run on the card with ``python examples_torch/randomized_benchmarking.py``,
or on the CPU with ``--device cpu``.
"""
import argparse
import sys
from pathlib import Path

if __name__ == "__main__":   # a script: import the port from this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from forest_benchmarking_tpu_torch.circuits import Circuit, Gate, X
from forest_benchmarking_tpu_torch.randomized_benchmarking import (
    acquire_rb_data, do_rb, fit_rb_results, generate_rb_experiment_sequences,
    get_stats_by_qubit_group, group_sequences_into_parallel_experiments,
    interleaved_gate_fidelity_bounds, rb_decay_to_gate_error,
    unitarity_to_rb_decay)
from forest_benchmarking_tpu_torch.sim import QVM
from forest_benchmarking_tpu_torch.sim.noise import pauli_kraus_map


def main(device="cuda", out_dir="/tmp"):
    expected_decay = 0.9
    kraus = pauli_kraus_map([expected_decay + 0.1 / 4] + [0.1 / 4] * 3)

    qubits = (0,)
    depths = [d for d in [2, 6, 10, 16, 24] for _ in range(10)]
    sequences = generate_rb_experiment_sequences(qubits, depths, random_seed=1)

    # attach a depolarizing channel once per Clifford via a no-op noise gate
    eye = np.eye(2, dtype=complex)
    for seq in sequences:
        for circ in seq:
            circ.gates.append(Gate("noise", (), (0,),
                                   matrix=tuple(map(tuple, eye))))
            circ.define_noisy_gate("noise", (0,), kraus)

    expts = group_sequences_into_parallel_experiments([sequences], [qubits])
    qvm = QVM(seed=7, device=device)
    results = acquire_rb_data(qvm, expts, num_shots=100)
    stats = get_stats_by_qubit_group([qubits], results)[qubits]
    fit = fit_rb_results(depths, stats["expectation"], stats["std_err"],
                         device=qvm.device)

    decay = fit.params["decay"].value
    out = {"decay": decay, "decay_stderr": fit.params["decay"].stderr}
    print(f"injected decay {expected_decay}, recovered {decay:.4f} "
          f"+- {out['decay_stderr']:.4f}")
    print(f"average Clifford error: {rb_decay_to_gate_error(decay, 2):.4f}")

    # --- interleaved RB: bound the fidelity of a specific gate [IRB]
    qvm2 = QVM(seed=11, device=device)
    depths2 = [d for d in [2, 6, 10, 16] for _ in range(8)]
    std_decays, _, _ = do_rb(qvm2, [(0,)], depths2, num_shots=300,
                             random_seed=2)
    irb_decays, _, _ = do_rb(qvm2, [(0,)], depths2,
                             interleaved_gate=Circuit([X(0)]),
                             num_shots=300, random_seed=3)
    lo, hi = interleaved_gate_fidelity_bounds(irb_decay=irb_decays[(0,)],
                                              rb_decay=std_decays[(0,)],
                                              dim=2)
    out["irb_lower"], out["irb_upper"] = float(lo), float(hi)
    print(f"interleaved X gate fidelity bounds (noiseless sim): "
          f"[{lo:.4f}, {hi:.4f}]")

    # --- unitarity RB: purity decay separates coherent from stochastic noise
    unit_decays, _, _ = do_rb(qvm2, [(0,)], depths2, is_unitarity_expt=True,
                              num_shots=300, random_seed=4)
    out["unitarity"] = unit_decays[(0,)]
    print(f"unitarity (noiseless sim, expect ~1): {out['unitarity']:.4f}; "
          f"implied RB-decay bound "
          f"{unitarity_to_rb_decay(out['unitarity'], 2):.4f}")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
