"""Example: benchmarking with the CDKM ripple-carry adder (classical logic).

The port's counterpart of ``examples/ripple_carry_adder.py``: run a 2-bit
adder over every pair of summands, report per-pair success probability and
the Hamming-weight distribution of output errors, in both the Z
(computational) and X bases, then with noisy readout.

Run on the card with ``python examples_torch/ripple_carry_adder.py``, or on
the CPU with ``--device cpu``.
"""
import argparse
import sys
from pathlib import Path

if __name__ == "__main__":   # a script: import the port from this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from forest_benchmarking_tpu_torch.classical_logic import (
    get_error_hamming_distributions_from_results, get_n_bit_adder_results,
    get_success_probabilities_from_results)
from forest_benchmarking_tpu_torch.sim import QVM


class NoisyReadoutQVM(QVM):
    """Asymmetric readout noise on every measured qubit."""

    def run(self, circuit, qubits, num_shots):
        noisy = circuit.copy()
        for q in qubits:
            noisy.define_noisy_readout(q, p00=0.95, p11=0.92)
        return super().run(noisy, qubits, num_shots)


def main(device="cuda", out_dir="/tmp"):
    qvm = QVM(seed=0, device=device)

    out = {}
    for in_x_basis in (False, True):
        basis = "X" if in_x_basis else "Z"
        results = get_n_bit_adder_results(qvm, n_bits=2, in_x_basis=in_x_basis,
                                          num_shots=100)
        probs = get_success_probabilities_from_results(results)
        out[f"success_{basis}"] = float(np.mean(probs))
        print(f"{basis}-basis 2-bit adder: mean success over all "
              f"{len(probs)} summand pairs = {np.mean(probs):.3f}")

    # noiseless distribution of output-error Hamming weights is a delta at 0
    distrs = get_error_hamming_distributions_from_results(results)
    out["hamming"] = np.mean(distrs, axis=0)
    print(f"error Hamming-weight distribution (noiseless): "
          f"{np.round(out['hamming'], 3)}")

    # with noisy readout, success degrades and error weights spread out
    results = get_n_bit_adder_results(NoisyReadoutQVM(seed=1, device=device),
                                      n_bits=2, num_shots=100)
    probs = get_success_probabilities_from_results(results)
    distrs = get_error_hamming_distributions_from_results(results)
    out["success_noisy"] = float(np.mean(probs))
    out["hamming_noisy"] = np.mean(distrs, axis=0)
    print(f"with 5-8% readout error: mean success = {np.mean(probs):.3f}, "
          f"error weights {np.round(out['hamming_noisy'], 3)}")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
