"""Example: GHZ and graph states (entangled-state benchmarks).

The port's counterpart of ``examples/entangled_states.py``: build a GHZ
state over a CNOT tree and count Bell-consistent outcomes; build a graph
state and sweep the focal-node measurement angle to trace out the expected
fringe. The tree and the path are edge lists (no networkx).

Run on the card with ``python examples_torch/entangled_states.py``, or on
the CPU with ``--device cpu``.
"""
import argparse
import sys
from pathlib import Path

if __name__ == "__main__":   # a script: import the port from this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from forest_benchmarking_tpu_torch.entangled_states import (
    create_ghz_program, create_graph_state, ghz_state_statistics,
    measure_graph_state)
from forest_benchmarking_tpu_torch.sim import QVM


def main(device="cuda", out_dir="/tmp"):
    qvm = QVM(seed=0, device=device)

    # GHZ over a 5-qubit star-shaped CNOT tree, as (parent, child) edges
    tree = [(0, 1), (0, 2), (1, 3), (1, 4)]
    program, qubits = create_ghz_program(tree)
    bitstrings = qvm.run(program, qubits, num_shots=2000)
    stats = ghz_state_statistics(bitstrings)
    out = {"ghz_bell_share": stats["bell"] / stats["total"], "zzz": [],
           "zzz_expected": []}
    print(f"GHZ(5): {stats['bell']}/{stats['total']} Bell-consistent outcomes")

    # graph state on the path 0 - 1 - 2; rotate the focal node by RY(theta)
    # and read the stabilizer fringe: <Z_f Z_n1 Z_n2> = -sin(theta) *
    # <X_f Z_n1 Z_n2> where X_f Z_n1 Z_n2 is a +1 stabilizer of the graph
    # state (the Z-Z part has zero expectation), so the joint parity traces
    # a clean sine in theta even though the focal marginal stays maximally
    # mixed.
    graph = [(0, 1), (1, 2)]
    state_prep = create_graph_state(graph)
    for theta in np.linspace(0, np.pi, 5):
        meas, order = measure_graph_state(graph, focal_node=1, theta=theta)
        shots = np.asarray(qvm.run(state_prep + meas, order, num_shots=2000))
        parity = float(np.mean(1 - 2 * (np.sum(shots, axis=1) % 2)))
        out["zzz"].append(parity)
        out["zzz_expected"].append(-np.sin(theta))
        print(f"theta={theta:5.2f}: <ZZZ> = {parity:+.3f}  "
              f"(expected {-np.sin(theta):+.3f})")
    return {k: np.asarray(v) for k, v in out.items()}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
