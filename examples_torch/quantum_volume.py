"""Example: quantum volume, both the per-circuit API and the batched path.

The port's counterpart of ``examples/quantum_volume.py``. On the card the
batched scan runs the ideal-probability kernel (``csrc/qv_traj.cu``) at
every depth; the noisy batched scan takes the density method or the
trajectory kernel by depth, as ``quantum_volume`` routes it.

Run on the card with ``python examples_torch/quantum_volume.py``, or on the
CPU with ``--device cpu``.
"""
import argparse
import sys
from pathlib import Path

if __name__ == "__main__":   # a script: import the port from this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from forest_benchmarking_tpu_torch.quantum_volume import (
    _noisy_method, extract_quantum_volume_from_results, measure_quantum_volume,
    measure_quantum_volume_batched, topology_restricted_program_generator)
from forest_benchmarking_tpu_torch.sim import QVM
from forest_benchmarking_tpu_torch.sim.noise import depolarizing_kraus_map
from forest_benchmarking_tpu_torch.utils import entry_device


def main(device="cuda", out_dir="/tmp"):
    dev = entry_device(device)

    # fully-batched ideal-device scan (one call per depth)
    gen = torch.Generator(device=dev).manual_seed(0)
    results = measure_quantum_volume_batched(gen, max_depth=4,
                                             num_circuits=120, num_shots=300,
                                             device=dev)
    for depth, (prob, conf) in results.items():
        print(f"depth {depth}: heavy-output prob {prob:.3f} "
              f"(lower bound {conf:.3f})")
    out = {f"ideal_prob_d{d}": p for d, (p, _) in results.items()}
    out["ideal_qv"] = extract_quantum_volume_from_results(results)
    print("quantum volume (ideal device):", out["ideal_qv"])

    # per-circuit path through the QVM (supports noise models)
    rng = np.random.RandomState(0)
    qvm = QVM(seed=1, device=dev)
    results = measure_quantum_volume(qvm, qubits=[0, 1, 2], num_circuits=100,
                                     num_shots=100, depths=[2, 3], rng=rng)
    out.update({f"per_circuit_prob_d{d}": p for d, (p, _) in results.items()})
    print("per-circuit path:", {d: round(p, 3) for d, (p, _) in results.items()})

    # noisy device, batched: a 2Q depolarizing channel after every Haar
    # gate, one call per depth (heavy sets still come from the ideal
    # circuits); quantum_volume picks the density method or the
    # trajectories by depth
    ks = depolarizing_kraus_map(0.08)
    two_q = np.stack([np.kron(a, b) for a in ks for b in ks])
    noisy = measure_quantum_volume_batched(
        torch.Generator(device=dev).manual_seed(0), max_depth=3,
        num_circuits=80, num_shots=200, kraus=two_q, device=dev)
    out.update({f"noisy_prob_d{d}": p for d, (p, _) in noisy.items()})
    out["noisy_qv"] = extract_quantum_volume_from_results(noisy)
    print("noisy batched (8% depolarizing):",
          {d: round(p, 3) for d, (p, _) in noisy.items()},
          "-> QV", out["noisy_qv"])
    print("noisy batched route by depth:",
          {d: _noisy_method(d) for d in noisy})

    # restricted connectivity: route model circuits onto a line topology with
    # SWAP chains; noisy SWAPs then price the routing overhead
    line_gen = topology_restricted_program_generator([(0, 1), (1, 2)])
    line_res = measure_quantum_volume(QVM(seed=2, device=dev), qubits=[0, 1, 2],
                                      program_generator=line_gen,
                                      num_circuits=100, num_shots=100,
                                      depths=[3], rng=np.random.RandomState(1))
    out.update({f"line_prob_d{d}": p for d, (p, _) in line_res.items()})
    print("line-topology routed (ideal gates):",
          {d: round(p, 3) for d, (p, _) in line_res.items()})
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
