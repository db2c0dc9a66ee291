"""Example: the observable-estimation data model, grouping, and calibration.

The port's counterpart of ``examples/observable_estimation.py``: build an
ObservablesExperiment, group compatible settings into tensor-product bases
(fewer runs), estimate expectations on the port's QVM, and calibrate away
readout error with symmetrized calibration runs.

Run on the card with ``python examples_torch/observable_estimation.py``,
or on the CPU with ``--device cpu``.
"""
import argparse
import sys
from pathlib import Path

if __name__ == "__main__":   # a script: import the port from this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from forest_benchmarking_tpu_torch.circuits import CNOT, Circuit, H
from forest_benchmarking_tpu_torch.observable_estimation import (
    ExperimentSetting, ObservablesExperiment, calibrate_observable_estimates,
    estimate_observables, group_settings, zeros_state)
from forest_benchmarking_tpu_torch.paulis import PauliTerm
from forest_benchmarking_tpu_torch.sim import QVM


class NoisyReadoutQVM(QVM):
    """Asymmetric readout noise on every measured qubit. The QVM runs all
    the flip patterns of a symmetrized run in one batched call, not through
    ``run``, so both entry points attach the noise."""

    @staticmethod
    def _noisy(circuit, qubits):
        noisy = circuit.copy()
        for q in qubits:
            noisy.define_noisy_readout(q, p00=0.95, p11=0.90)
        return noisy

    def run(self, circuit, qubits, num_shots):
        return super().run(self._noisy(circuit, qubits), qubits, num_shots)

    def run_symmetrized_readout(self, circuit, num_shots, symm_type=-1,
                                meas_qubits=None):
        if meas_qubits is None:
            meas_qubits = sorted(circuit.get_qubits())
        return super().run_symmetrized_readout(
            self._noisy(circuit, meas_qubits), num_shots, symm_type,
            meas_qubits)


def main(device="cuda", out_dir="/tmp"):
    # Bell state; estimate XX, YY, ZZ, ZI (expect +1, -1, +1, 0)
    program = Circuit([H(0), CNOT(0, 1)])
    qubits = [0, 1]
    settings = [ExperimentSetting(zeros_state(qubits), PauliTerm(obs))
                for obs in ([(0, "X"), (1, "X")], [(0, "Y"), (1, "Y")],
                            [(0, "Z"), (1, "Z")], [(0, "Z")])]
    expt = ObservablesExperiment(settings, program)
    print(f"ungrouped: {len(expt)} runs")
    grouped = group_settings(expt)
    print(f"grouped into tensor-product bases: {len(grouped)} runs")
    out = {"runs_ungrouped": len(expt), "runs_grouped": len(grouped)}

    qvm = QVM(seed=0, device=device)
    results = list(estimate_observables(qvm, grouped, num_shots=4000))
    out["ideal"] = np.array([r.expectation for r in results])
    for r in results:
        print(f"  <{r.setting.observable}> = {r.expectation:+.3f} "
              f"+/- {r.std_err:.3f}")

    # readout calibration: with asymmetric readout noise the raw estimates
    # shrink; calibration divides out the measured symmetrized readout
    # attenuation
    noisy = NoisyReadoutQVM(seed=1, device=device)
    raw = list(estimate_observables(noisy, grouped, num_shots=4000))
    cal = list(calibrate_observable_estimates(noisy, raw, num_shots=4000))
    out["raw"] = np.array([r.expectation for r in raw])
    out["calibrated"] = np.array([r.expectation for r in cal])
    print("\nwith 5-10% readout error (raw -> calibrated):")
    for r0, r1 in zip(raw, cal):
        print(f"  <{r0.setting.observable}>: {r0.expectation:+.3f} -> "
              f"{r1.expectation:+.3f}")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
