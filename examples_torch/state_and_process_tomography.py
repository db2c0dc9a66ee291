"""Example: state and process tomography end-to-end on the port's QVM.

The port's counterpart of ``examples/state_and_process_tomography.py``:
state tomography of a Bell state and process tomography of RY(0.7), each
held against the true state or gate.

Run on the card with ``python examples_torch/state_and_process_tomography.py``,
or on the CPU with ``--device cpu``.
"""
import argparse
import sys
from pathlib import Path

if __name__ == "__main__":   # a script: import the port from this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch

from forest_benchmarking_tpu_torch import distance_measures as dm
from forest_benchmarking_tpu_torch.circuits import CNOT, RY, Circuit, H, gate_matrix
from forest_benchmarking_tpu_torch.ops import (
    choi2pauli_liouville, kraus2choi, project_state_matrix_to_physical)
from forest_benchmarking_tpu_torch.sim import QVM
from forest_benchmarking_tpu_torch.sim.statevector import run_statevector
from forest_benchmarking_tpu_torch.tomography import do_tomography


def main(device="cuda", out_dir="/tmp"):
    qvm = QVM(seed=42, device=device)

    # --- state tomography of a Bell state ---------------------------------
    bell = Circuit([H(0), CNOT(0, 1)])
    rho_est, expt, results = do_tomography(qvm, bell, [0, 1], "state",
                                           num_shots=4000)
    rho_est = project_state_matrix_to_physical(rho_est)

    psi = run_statevector(bell, [0, 1], device=qvm.device)
    rho_true = torch.outer(psi, psi.conj())
    out = {"state_fidelity": float(dm.fidelity(rho_true, rho_est).real)}
    print(f"state tomography: fidelity to true Bell state = "
          f"{out['state_fidelity']:.4f}")

    # --- process tomography of RY(0.7) ------------------------------------
    gate = Circuit([RY(0.7, 0)])
    choi_est, expt, results = do_tomography(qvm, gate, [0], "process",
                                            num_shots=3000)
    choi_true = kraus2choi(torch.tensor(gate_matrix("RY", (0.7,)),
                                        device=qvm.device)[None])
    pf = dm.process_fidelity(choi2pauli_liouville(choi_true),
                             choi2pauli_liouville(choi_est))
    out["process_fidelity"] = float(pf.real)
    print(f"process tomography: average gate fidelity = "
          f"{out['process_fidelity']:.4f}")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
