"""The ``qv8`` configuration: set-up from the seed, one call of the
program's public entry point, and the check against the plain reference.

Set-up makes the Kraus stack of the configuration's depolarizing noise (for
a noisy cell), one ``torch.Generator`` on the card seeded from the seed,
and runs ``warmup_calls`` calls. Call i is
``quantum_volume.sample_heavy_outputs_batched`` on ``circuits`` model
circuits of depth 8 and 1000 shots, drawing new circuits from the same
generator, which advances from call to call; it ends with the (C,) heavy
tallies on the host. The route: ``ideal_probs.launches`` rises by one a
call, and ``traj_probs.launches`` too in a noisy cell.

The check replays each kept call in the reference from the generator's
state before it (the same draws) and compares the tallies:
``tally_gap_max`` is the largest difference of a circuit's heavy count.
The control puts the reference in bfloat16 in the program's place.
"""
from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from forest_benchmarking_tpu_torch import quantum_volume
from forest_benchmarking_tpu_torch.ops import pallas_traj

_PAULIS = (np.eye(2), np.array([[0, 1], [1, 0]]),
           np.array([[0, -1j], [1j, 0]]), np.array([[1, 0], [0, -1]]))


def depolarizing_pair_kraus(p: float) -> np.ndarray:
    """(16, 4, 4) complex128 Kraus stack of one-qubit depolarizing noise of
    strength p on each qubit of a pair: sqrt(w_a w_b) P_a (x) P_b with
    w = (1 - 3p/4, p/4, p/4, p/4) over (I, X, Y, Z), the first qubit's
    Pauli outermost."""
    w = (1 - 3 * p / 4, p / 4, p / 4, p / 4)
    return np.stack([np.sqrt(w[a] * w[b]) * np.kron(_PAULIS[a], _PAULIS[b])
                     for a, b in itertools.product(range(4), repeat=2)]
                    ).astype(np.complex128)


class QuantumVolume:
    """The set-up cell (see :func:`qcvv_bench.harness.run_window`)."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, reference):
        self.reference = reference
        self.config = config
        self.device = device
        self.depth, self.shots = config["depth"], config["shots"]
        self.circuits = traffic["circuits"]
        self.work_per_call = self.circuits
        self.kraus = None
        self.trajectories = 0
        kw = dict(dtype=torch.float32, device=device)
        if traffic["noisy"]:
            self.kraus = depolarizing_pair_kraus(config["depolarizing_p"])
            self.trajectories = traffic["trajectories"]
            kw.update(kraus=torch.tensor(self.kraus, dtype=torch.complex64,
                                         device=device),
                      noisy_method=traffic["noisy_method"],
                      num_trajectories=self.trajectories)
        self.kwargs = kw
        self.launches_per_call = (1, 1 if traffic["noisy"] else 0)
        self.generator = torch.Generator(device=device).manual_seed(seed)
        for i in range(traffic["warmup_calls"]):
            t0 = time.perf_counter()
            self.fetch(self.entry(i))
            self.warm_seconds = time.perf_counter() - t0

    def launches(self):
        return (pallas_traj.ideal_probs.launches,
                pallas_traj.traj_probs.launches)

    def before(self, i: int) -> torch.Tensor:
        return self.generator.get_state()

    def entry(self, i: int) -> torch.Tensor:
        return quantum_volume.sample_heavy_outputs_batched(
            self.generator, self.depth, self.circuits, self.shots,
            **self.kwargs)

    def fetch(self, out: torch.Tensor) -> torch.Tensor:
        return out.cpu()

    def release(self) -> None:
        self.kwargs = None

    def _tallies(self, state, dtype) -> torch.Tensor:
        return self.reference.tallies(
            state, self.device, depth=self.depth, circuits=self.circuits,
            shots=self.shots, kraus=self.kraus,
            trajectories=self.trajectories, dtype=dtype).cpu()

    def check(self, kept) -> dict:
        """``tally_gap_max`` of the kept calls' tallies."""
        gap = 0
        for _, state, tallies in kept:
            ref = self._tallies(state, torch.float64)
            gap = max(gap, int((tallies - ref).abs().max()))
        return {"tally_gap_max": gap}

    def control(self, kept) -> dict:
        """``tally_gap_max`` of the reference in bfloat16 in the program's
        place, on the kept calls' draws."""
        gap = 0
        for _, state, _ in kept:
            ctl = self._tallies(state, torch.bfloat16)
            ref = self._tallies(state, torch.float64)
            gap = max(gap, int((ctl - ref).abs().max()))
        return {"tally_gap_max": gap}


def setup(config: dict, traffic: dict, seed: int, device: torch.device,
          reference) -> QuantumVolume:
    return QuantumVolume(config, traffic, seed, device, reference)
