"""Example: direct fidelity estimation of states and processes.

The port's counterpart of ``examples/direct_fidelity_estimation.py``:
exhaustive state DFE of a GHZ state, state DFE under depolarizing noise
beside its analytic value, and Monte Carlo process DFE of a CNOT.

Run on the card with ``python examples_torch/direct_fidelity_estimation.py``,
or on the CPU with ``--device cpu``.
"""
import argparse
import sys
from pathlib import Path

if __name__ == "__main__":   # a script: import the port from this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from forest_benchmarking_tpu_torch.circuits import CNOT, Circuit, Gate, H
from forest_benchmarking_tpu_torch.direct_fidelity_estimation import do_dfe
from forest_benchmarking_tpu_torch.sim import QVM
from forest_benchmarking_tpu_torch.sim.noise import depolarizing_kraus_map


def main(device="cuda", out_dir="/tmp"):
    qvm = QVM(seed=0, device=device)

    # exhaustive state DFE of a noiseless GHZ state
    ghz = Circuit([H(0), CNOT(0, 1), CNOT(1, 2)])
    (fid, err), expt, results = do_dfe(qvm, ghz, [0, 1, 2], "state",
                                       num_shots=1000)
    out = {"ghz": fid}
    print(f"GHZ state fidelity (noiseless): {fid:.4f} +/- {err:.4f} "
          f"({len(expt)} settings)")

    # state DFE with depolarizing noise: fidelity of (1-p)|+><+| + p I/2 is
    # 1-p/2
    p = 0.15
    eye = np.eye(2, dtype=complex)
    noisy_plus = Circuit([H(0), Gate("noise", (), (0,),
                                     matrix=tuple(map(tuple, eye)))])
    noisy_plus.define_noisy_gate("noise", (0,), depolarizing_kraus_map(p))
    (fid, err), _, _ = do_dfe(qvm, noisy_plus, [0], "state", num_shots=20000)
    out["depolarized"] = fid
    print(f"depolarized |+>: expected {1 - p / 2:.3f}, "
          f"measured {fid:.4f} +/- {err:.4f}")

    # Monte Carlo process DFE of a CNOT (constant number of settings)
    rng = np.random.RandomState(1)
    (fid, err), expt, _ = do_dfe(qvm, Circuit([CNOT(0, 1)]), [0, 1], "process",
                                 mc_n_terms=40, num_shots=500, rng=rng)
    out["cnot"] = fid
    print(f"CNOT avg gate fidelity (MC DFE, {len(expt)} settings): "
          f"{fid:.4f} +/- {err:.4f}")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
