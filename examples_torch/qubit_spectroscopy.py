"""Example: T1/T2 spectroscopy with an injected decoherence model, plus Rabi.

The port's counterpart of ``examples/qubit_spectroscopy.py``: T1 and T2
(echo) recovered from a QVM with T1 = 18 us and T2 = 11 us, a Rabi scan of a
calibrated RX, and the CZ phase Ramsey. The fits run on the QVM's device.

Run on the card with ``python examples_torch/qubit_spectroscopy.py``, or on
the CPU with ``--device cpu``.
"""
import argparse
import sys
from pathlib import Path

if __name__ == "__main__":   # a script: import the port from this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from forest_benchmarking_tpu_torch.qubit_spectroscopy import (
    acquire_qubit_spectroscopy_data, do_t1_or_t2, fit_cz_phase_ramsey_results,
    fit_rabi_results, generate_cz_phase_ramsey_experiments,
    generate_rabi_experiments, get_stats_by_qubit)
from forest_benchmarking_tpu_torch.sim import QVM


def main(device="cuda", out_dir="/tmp"):
    # simulator with an injected decoherence model: T1 = 18 us, T2 = 11 us
    qvm = QVM(seed=0, t1s={0: 18e-6}, t2s={0: 11e-6}, device=device)

    times = np.linspace(1e-6, 50e-6, 20)
    t1s, _, _ = do_t1_or_t2(qvm, [0], times, "t1", num_shots=3000)
    print(f"T1: injected 18.0 us, measured {t1s[0]:.1f} us")

    times = np.linspace(0.5e-6, 25e-6, 25)
    t2s, _, _ = do_t1_or_t2(qvm, [0], times, "t2_echo", num_shots=3000)
    print(f"T2 (echo): injected 11.0 us, measured {t2s[0]:.1f} us")
    out = {"t1_us": t1s[0], "t2_echo_us": t2s[0]}

    # Rabi: perfectly calibrated RX
    angles = np.linspace(0, 2 * np.pi, 20)
    expts = generate_rabi_experiments([0], angles)
    results = acquire_qubit_spectroscopy_data(qvm, expts, num_shots=2000)
    stats = get_stats_by_qubit(results)
    fit = fit_rabi_results(angles, stats[0]["expectation"], stats[0]["std_err"],
                           device=qvm.device)
    out["rabi_ratio"] = fit.params["frequency"].value
    print(f"Rabi frequency ratio (actual/intended): {out['rabi_ratio']:.4f}")

    # --- CZ phase Ramsey: estimate the effective RZ the CZ imparts on one qubit
    angles = np.linspace(0, 2 * np.pi, 25)
    cz_expts = generate_cz_phase_ramsey_experiments([0, 1], 0, angles)
    cz_results = acquire_qubit_spectroscopy_data(qvm, cz_expts, num_shots=2000)
    cz_stats = get_stats_by_qubit(cz_results)
    cz_fit = fit_cz_phase_ramsey_results(angles, cz_stats[0]["expectation"],
                                         cz_stats[0]["std_err"],
                                         device=qvm.device)
    out["cz_phase"] = cz_fit.params["offset"].value
    print(f"CZ-imparted RZ on qubit 0 (control in |0>, expect ~0): "
          f"{out['cz_phase']:.4f} rad")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
