"""Example: robust phase estimation of an RZ rotation angle.

The port's counterpart of ``examples/robust_phase_estimation.py``: an RZ
angle (no change of basis) and an RX angle (a change of basis to the X
eigenvectors), each beside its true value.

Run on the card with ``python examples_torch/robust_phase_estimation.py``,
or on the CPU with ``--device cpu``.
"""
import argparse
import sys
from pathlib import Path

if __name__ == "__main__":   # a script: import the port from this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from forest_benchmarking_tpu_torch.circuits import RX, RZ, Circuit
from forest_benchmarking_tpu_torch.robust_phase_estimation import (
    bloch_rotation_to_eigenvectors, change_of_basis_matrix_to_circuit, do_rpe,
    get_change_of_basis_from_eigvecs, get_variance_upper_bound)
from forest_benchmarking_tpu_torch.sim import QVM


def main(device="cuda", out_dir="/tmp"):
    qvm = QVM(seed=11, device=device)

    # estimate an RZ angle (eigenvectors are the computational basis: no
    # change of basis)
    angle = 1.234
    estimates, expts, results = do_rpe(qvm, Circuit([RZ(angle, 0)]),
                                       [Circuit()], [(0,)], num_depths=6,
                                       multiplicative_factor=10.0)
    bound = np.sqrt(get_variance_upper_bound(6, multiplicative_factor=10.0))
    out = {"rz": float(estimates[(0,)])}
    print(f"RZ angle: true {angle}, estimated {estimates[(0,)]:.4f} "
          f"(variance bound std {bound:.4f})")

    # estimate an RX angle via a change of basis mapping |0>,|1> to the X
    # eigenvectors
    evecs = bloch_rotation_to_eigenvectors(np.pi / 2, 0)
    cob = change_of_basis_matrix_to_circuit(
        [0], get_change_of_basis_from_eigvecs(evecs))
    angle = 0.777
    estimates, _, _ = do_rpe(qvm, Circuit([RX(angle, 0)]), [cob], [(0,)],
                             num_depths=6, multiplicative_factor=10.0)
    out["rx"] = float(estimates[(0,)])
    print(f"RX angle: true {angle}, estimated {estimates[(0,)]:.4f}")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
