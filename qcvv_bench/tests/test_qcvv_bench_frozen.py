"""The benchmark's frozen copies against the program's functions today.

The yardstick (inputs, operation counts, the trace's reduction, the plain
references) is copied into ``qcvv_bench/`` so that a change of the program
cannot move it; these tests show the copies equal to the originals on the
same inputs, so that a later change of either shows up as a failure here.
"""
from __future__ import annotations

import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from forest_benchmarking_tpu_torch import bench
from forest_benchmarking_tpu_torch.benchmarks import (
    process_tomo_A_matrix, synth_process_datasets)
from forest_benchmarking_tpu_torch.ops import lanes_apg, pallas_traj
from forest_benchmarking_tpu_torch.quantum_volume import (
    sample_heavy_outputs_batched)
from forest_benchmarking_tpu_torch.sim.noise import depolarizing_kraus_map
from forest_benchmarking_tpu_torch.tomography import (
    pgdb_process_estimate_batched)

from qcvv_bench import harness, tomo_inputs, tracing

BENCH = Path(harness.__file__).resolve().parent


def _load(rel: str):
    return harness.load_module(BENCH / rel, "frozen_" + rel.replace("/", "_")
                               .replace(".", "_"))


@pytest.mark.parametrize("n_qubits", [1, 2])
def test_a_matrix_equals_the_programs(n_qubits):
    ours = tomo_inputs.process_tomo_a_matrix(n_qubits)
    theirs = process_tomo_A_matrix(n_qubits)
    assert ours.shape == theirs.shape == (2 * 6 ** n_qubits
                                          * (4 ** n_qubits - 1), 16 ** n_qubits)
    assert np.abs(ours - theirs).max() < 1e-15


@pytest.mark.parametrize("seed,batch,rank", [(5, 16, 16), (2 ** 33 + 1, 7, 4)])
def test_bcsz_counts_equal_the_programs(seed, batch, rank):
    a = torch.tensor(process_tomo_A_matrix(2), dtype=torch.complex64)
    n0, c0 = synth_process_datasets(torch.Generator().manual_seed(seed), a, 4,
                                    batch, 2000, kraus_rank=rank)
    n1, c1 = tomo_inputs.tomography_counts(torch.Generator().manual_seed(seed),
                                           a, 4, batch, 2000, rank)
    assert torch.equal(n0, n1) and torch.equal(c0, c1)


@pytest.mark.parametrize("schedule", [lanes_apg.HEADLINE_TUNED_2Q,
                                      lanes_apg.PARITY_TUNED_2Q,
                                      dict(phases=lanes_apg.PARITY_PHASES)])
def test_apg_flops_equal_the_programs(schedule):
    metric = _load("metrics/apg_fused_roofline_pct.py")
    kw = {k: v for k, v in schedule.items() if k != "mu"}
    assert metric.fused_apg_flops_per_solve(**kw) == \
        bench.fused_apg_flops_per_solve(**kw)


def test_apg_headline_schedule_is_the_programs():
    metric = _load("metrics/apg_fused_roofline_pct.py")
    ref = _load("reference/ptomo2q.py")
    program = {k: v for k, v in lanes_apg.HEADLINE_TUNED_2Q.items()}
    assert ref.HEADLINE == program
    program.pop("mu")
    assert metric.SCHEDULES["headline"] == program
    # the bound of the B = 16384 cell: 135.2 GFLOP at 67 TFLOP/s
    least, by = metric.bound_seconds(16384, "headline")
    assert by == "operations" and abs(least - 2.017e-3) < 1e-5


@pytest.mark.parametrize("depth,kraus,trajectories,noiseless", [
    (8, 16, 1000, False), (8, 16, 1, True), (5, 4, 37, False), (10, 1, 8, True)])
def test_traj_flops_equal_the_programs(depth, kraus, trajectories, noiseless):
    metric = _load("metrics/traj_probs_roofline_pct.py")
    assert metric.traj_flops_per_circuit(depth, kraus, trajectories,
                                         noiseless) == \
        pallas_traj.traj_flops_per_circuit(depth, kraus, trajectories,
                                           noiseless)


def test_kraus_stack_is_the_tensor_square_of_the_programs_channel():
    qv8 = _load("configs/qv8.py")
    ks = depolarizing_kraus_map(0.02)
    theirs = np.stack([np.kron(a, b) for a in ks for b in ks])
    assert np.abs(qv8.depolarizing_pair_kraus(0.02) - theirs).max() < 1e-15


def _function_event(name, start, end, device):
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import FunctionEvent
    return FunctionEvent(id=0, name=name, thread=1, start_us=start,
                         end_us=end, stack=[],
                         use_device="cuda" if device else None,
                         device_type=DeviceType.CUDA if device
                         else DeviceType.CPU)


def test_trace_summary_equals_chip_smoke_profiled(monkeypatch):
    """``chip_smoke.profiled``'s reduction and the summary of the same
    events give the same launches, busy time and time by kernel."""
    from torch.autograd.profiler_util import EventList
    rows = [("qcvv.call", 0, 100, False), ("aten::mm", 5, 20, False),
            ("cudaLaunchKernel", 6, 8, False),
            ("cudaStreamSynchronize", 30, 90, False),
            ("kernel_a", 10, 30, True), ("kernel_b", 31, 36, True),
            ("kernel_a", 40, 70, True), ("Memcpy DtoH", 72, 88, True),
            ("qcvv.call", 100, 200, False), ("kernel_b", 120, 150, True)]
    events = EventList([_function_event(*r) for r in rows])
    events._build_tree()

    class Profile:
        def __init__(self, *args, **kw):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return events.key_averages()

        def events(self):
            return events

    import chip_smoke
    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    launches, busy_ms, syncs, top, _ = chip_smoke.profiled(lambda: None)
    summary = tracing.summarize(tracing.events_from_profile(Profile()))
    assert summary.launches == launches == 5
    assert summary.syncs == syncs == 1
    assert abs(summary.busy_s * 1e3 - busy_ms) < 1e-12
    assert {e.key: e.self_device_time_total / 1e6 for e in top} == \
        pytest.approx(summary.device_s)
    assert summary.calls == 2 and summary.window_s == pytest.approx(200e-6)
    # idle, named at each gap's middle: 0-10 under aten::mm, 30-31, 36-40
    # and 70-72 under the synchronization, 88-120 and 150-200 under the
    # second call's span
    assert summary.gaps_s == pytest.approx({
        "aten::mm": 10e-6, "cudaStreamSynchronize": 1e-6 + 4e-6 + 2e-6,
        "qcvv.call": 32e-6 + 50e-6})
    assert summary.busy_s == pytest.approx(200e-6 - 99e-6)


def test_reference_solve_is_the_programs_plain_solve_in_float64():
    """The frozen fused APG solve in float64 is the program's plain version
    in float64: the same steps, so the two part by rounding alone (the warm
    start's product runs on real planes here, complex in the program)."""
    ref = _load("reference/ptomo2q.py")
    a = torch.tensor(process_tomo_A_matrix(2))
    n, _ = tomo_inputs.tomography_counts(torch.Generator().manual_seed(3),
                                         a.to(torch.complex64), 4, 6, 2000, 16)
    ours = ref.fused_apg(a, n.double(), 4, **ref.HEADLINE)
    theirs = lanes_apg.apg_fused(a, n.double(), 4,
                                 **lanes_apg.HEADLINE_TUNED_2Q)
    assert float(ref.rel_frobenius_gap(theirs, ours).max()) < 1e-12


@pytest.mark.parametrize("noisy", [False, True])
def test_reference_tallies_replay_the_programs_draws(noisy):
    """On the CPU the program runs its plain versions in float32; the
    reference in float64 from the same generator state gives the same
    heavy tallies."""
    ref = _load("reference/qv8.py")
    qv8 = _load("configs/qv8.py")
    g = torch.Generator().manual_seed(2 ** 35 + 11)
    kw, rkw = {}, {}
    if noisy:
        kraus = qv8.depolarizing_pair_kraus(0.02)
        kw = dict(kraus=kraus, noisy_method="trajectory")
        rkw = dict(kraus=kraus, trajectories=100)
    circuits, shots = (3, 100) if noisy else (16, 1000)
    for _ in range(2):
        state = g.get_state()
        theirs = sample_heavy_outputs_batched(g, 8, circuits, shots,
                                              device="cpu", **kw)
        ours = ref.tallies(state, "cpu", depth=8, circuits=circuits,
                           shots=shots, **rkw)
        assert torch.equal(ours, theirs)


def test_frozen_files_import_nothing_of_the_program():
    for rel in ("tomo_inputs.py", "tracing.py",
                "metrics/apg_fused_roofline_pct.py",
                "metrics/traj_probs_roofline_pct.py"):
        text = (BENCH / rel).read_text()
        assert "forest_benchmarking_tpu" not in text.replace(
            "``forest_benchmarking_tpu_torch", ""), rel
    assert isinstance(sys.modules["qcvv_bench.tracing"], types.ModuleType)
