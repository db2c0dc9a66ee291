"""Example: readout-error characterization (confusion matrices).

The port's counterpart of ``examples/readout_characterization.py``:
estimate single-qubit and joint confusion matrices on a QVM with asymmetric
readout noise, then marginalize the joint matrix back down to one qubit.

Run on the card with ``python examples_torch/readout_characterization.py``,
or on the CPU with ``--device cpu``.
"""
import argparse
import sys
from pathlib import Path

if __name__ == "__main__":   # a script: import the port from this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from forest_benchmarking_tpu_torch.readout import (
    estimate_confusion_matrix, estimate_joint_confusion_in_set,
    marginalize_confusion_matrix)
from forest_benchmarking_tpu_torch.sim import QVM


class NoisyReadoutQVM(QVM):
    """Inject asymmetric readout noise on every qubit at run time."""

    def run(self, circuit, qubits, num_shots):
        noisy = circuit.copy()
        for q in qubits:
            noisy.define_noisy_readout(q, p00=0.97, p11=0.90)
        return super().run(noisy, qubits, num_shots)


def main(device="cuda", out_dir="/tmp"):
    qvm = NoisyReadoutQVM(seed=0, device=device)

    cm = estimate_confusion_matrix(qvm, qubit=0, num_shots=20000)
    print("1Q confusion matrix (expect diag ~ [0.97, 0.90]):")
    print(np.round(cm, 3))

    joint = estimate_joint_confusion_in_set(qvm, qubits=[0, 1],
                                            joint_group_size=2,
                                            num_shots=5000)
    cm01 = joint[(0, 1)]
    print("\njoint (0,1) confusion matrix diagonal:",
          np.round(np.diag(cm01), 3))

    marg = marginalize_confusion_matrix(cm01, all_qubits=[0, 1],
                                        marginal_subset=(0,))
    print("\nmarginalized back to qubit 0 (matches 1Q estimate):")
    print(np.round(marg, 3))
    return {"confusion": cm, "joint": cm01, "marginal": marg}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
