"""Example: state and process distance measures, including the diamond norm.

The port's counterpart of ``examples/distance_measures.py``: fidelities,
trace distance, purity, and for processes the average gate / process
fidelities and the diamond-norm distance, each beside its analytic value.

Run on the card with ``python examples_torch/distance_measures.py``, or on
the CPU with ``--device cpu``.
"""
import argparse
import sys
from pathlib import Path

if __name__ == "__main__":   # a script: import the port from this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from forest_benchmarking_tpu_torch.distance_measures import (
    bures_angle, diamond_norm_distance, entanglement_fidelity, fidelity,
    process_fidelity, purity, trace_distance, watrous_bounds)
from forest_benchmarking_tpu_torch.ops import choi2pauli_liouville, kraus2choi
from forest_benchmarking_tpu_torch.sim.noise import depolarizing_kraus_map
from forest_benchmarking_tpu_torch.utils import entry_device


def main(device="cuda", out_dir="/tmp"):
    dev = entry_device(device)
    t = lambda x: torch.tensor(np.asarray(x, dtype=complex), device=dev)

    # --- states
    plus = t([[0.5, 0.5], [0.5, 0.5]])
    zero = t([[1, 0], [0, 0]])
    mixed = t(np.eye(2) / 2)
    out = {"fidelity": float(fidelity(plus, zero).real),
           "trace_distance": float(trace_distance(zero, mixed)),
           "purity": float(purity(mixed).real),
           "bures_angle": float(bures_angle(plus, zero))}
    print("F(|+>,|0>) =", out["fidelity"], " (analytic 0.5)")
    print("T(|0>,I/2) =", out["trace_distance"], " (analytic 0.5)")
    print("purity(I/2) =", out["purity"], " bures_angle(|+>,|0>) =",
          out["bures_angle"])

    # --- processes: identity vs p-depolarizing channel
    p = 0.2
    eye_choi = kraus2choi(t(np.eye(2))[None])
    dep_choi = kraus2choi(t(np.stack(depolarizing_kraus_map(p))))
    pl_i = choi2pauli_liouville(eye_choi)
    pl_d = choi2pauli_liouville(dep_choi)
    print(f"\ndepolarizing p={p} vs identity (I w.p. 1-3p/4, X/Y/Z w.p. p/4):")
    # reference convention: process_fidelity is the AVERAGE GATE fidelity
    # (d*F_ent + 1)/(d+1); entanglement_fidelity is the process-matrix overlap
    out["process_fidelity"] = float(process_fidelity(pl_i, pl_d).real)
    out["entanglement_fidelity"] = float(
        entanglement_fidelity(pl_i, pl_d).real)
    print("  process (avg gate) fidelity:", out["process_fidelity"],
          f" (analytic {1 - p / 2})")
    print("  entanglement fidelity:", out["entanglement_fidelity"],
          f" (analytic {1 - 3 * p / 4})")

    # diamond norm: ||I - Dep_p||_diamond = 3p/2 for this convention
    out["diamond_norm"] = float(diamond_norm_distance(eye_choi, dep_choi))
    lo, hi = (float(x) for x in watrous_bounds(eye_choi - dep_choi))
    out["watrous_lower"], out["watrous_upper"] = lo, hi
    print(f"  diamond norm: {out['diamond_norm']:.4f} (analytic "
          f"{3 * p / 2:.4f}), watrous bounds [{lo:.3f}, {hi:.3f}]")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
