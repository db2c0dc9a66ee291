"""The ``ptomo2q`` configuration: set-up from the seed, one call of the
program's public entry point, and the check against the plain reference.

Set-up makes the Pauli-basis A-matrix on the host, a pool of ``pool``
batches of ``batch`` problems each on the card from the seed (BCSZ channels,
binomial counts), and runs ``warmup_calls`` calls. Call i estimates pool
batch i mod ``pool`` with ``tomography.pgdb_process_estimate_batched`` on
the fused route, with no ``a_pinv``, as users call it; it ends with the
(B, 16, 16) estimates on the host. The route: ``apg_fused.launches`` rises
by one a call.

The check compares every estimate of the kept calls with the reference's
estimate of the same problem, worked out again from the A-matrix and the
same counts in float64: ``est_gap_max`` is the largest relative Frobenius
distance. The control puts the reference with TF32 products in the
program's place.
"""
from __future__ import annotations

import time

import torch

from forest_benchmarking_tpu_torch import tomography
from forest_benchmarking_tpu_torch.ops import lanes_apg

from qcvv_bench.tomo_inputs import process_tomo_a_matrix, tomography_counts

REFERENCE_ROWS = 16384   # problems the reference solves at a time


class Tomography:
    """The set-up cell (see :func:`qcvv_bench.harness.run_window`)."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, reference):
        self.reference = reference
        self.config = config
        self.device = device
        self.dim = config["dim"]
        self.schedule = reference.SCHEDULES[config["fused_schedule"]]
        self.a_np = process_tomo_a_matrix(config["qubits"])
        self.a = torch.tensor(self.a_np, dtype=torch.complex64, device=device)
        self.work_per_call = traffic["batch"]
        g = torch.Generator(device=device).manual_seed(seed)
        self.pool = [tomography_counts(
            g, self.a, self.dim, traffic["batch"], config["shots_per_setting"],
            config["kraus_rank"])[0] for _ in range(traffic["pool"])]
        self.kwargs = dict(dim=self.dim, method="apg", cp_method="pallas",
                           fused_schedule=config["fused_schedule"])
        self.launches_per_call = (1,)
        for i in range(traffic["warmup_calls"]):
            t0 = time.perf_counter()
            self.fetch(self.entry(i))
            self.warm_seconds = time.perf_counter() - t0

    def launches(self):
        return (lanes_apg.apg_fused.launches,)

    def before(self, i: int) -> int:
        return i % len(self.pool)

    def entry(self, i: int) -> torch.Tensor:
        return tomography.pgdb_process_estimate_batched(
            self.a, self.pool[i % len(self.pool)], **self.kwargs)

    def fetch(self, out: torch.Tensor) -> torch.Tensor:
        return out.cpu()

    def release(self) -> None:
        self.a = None

    def _reference(self, batches, precision: str) -> dict:
        """{pool batch: the reference's (B, 16, 16) estimates}, the batches
        solved together (the solve is elementwise in the batch), at most
        ``REFERENCE_ROWS`` problems at a time."""
        a = torch.tensor(self.a_np, device=self.device)
        batches = sorted(set(batches))
        n = torch.cat([self.pool[b] for b in batches])
        est = torch.cat([
            self.reference.fused_apg(a, blk, self.dim, **self.schedule,
                                     precision=precision)
            for blk in n.split(REFERENCE_ROWS)])
        return dict(zip(batches, est.split(self.work_per_call)))

    def check(self, kept) -> dict:
        """``est_gap_max`` of the kept calls' estimates."""
        refs = self._reference([b for _, b, _ in kept], "f64")
        gap = max(float(self.reference.rel_frobenius_gap(
            est.to(self.device), refs[b]).max()) for _, b, est in kept)
        return {"est_gap_max": gap}

    def control(self, kept) -> dict:
        """``est_gap_max`` of the reference with TF32 products in the
        program's place, on the kept calls' batches."""
        batches = [b for _, b, _ in kept]
        refs = self._reference(batches, "f64")
        ctl = self._reference(batches, "tf32")
        gap = max(float(self.reference.rel_frobenius_gap(
            ctl[b], refs[b]).max()) for b in refs)
        return {"est_gap_max": gap}


def setup(config: dict, traffic: dict, seed: int, device: torch.device,
          reference) -> Tomography:
    return Tomography(config, traffic, seed, device, reference)
