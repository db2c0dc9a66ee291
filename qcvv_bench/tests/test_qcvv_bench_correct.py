"""What decides ``correct``: the controls fail the cells' limits, and a run
with the timed path broken underneath comes out not correct.

On the CPU the program runs its plain versions; the faults are planted in
them (or in the entry's answer) and the rest of a run is the harness's own,
with the look for a card skipped. Each cell runs on one card and keeps no
state between calls, so of the faults a cell can have these are: a step
that returns its state unchanged, half of the batch left out, and an answer
altered where it is produced (there is no exchange between chips).
"""
from __future__ import annotations

import json

import pytest
import torch

from forest_benchmarking_tpu_torch import quantum_volume
from forest_benchmarking_tpu_torch.ops import lanes_apg, pallas_traj

from qcvv_bench import harness

import qcvv_bench_helpers as helpers

TOMO = ["ptomo2q.fused_b16384", "ptomo2q.fused_b41"]
QV = ["qv8.traj_c1600", "qv8.ideal_c1600"]


def _tomo_fault(kind):
    plain = lanes_apg.apg_fused_reference

    def broken(ar, ai, n, rho0_r, rho0_i, **kw):
        est_r, est_i = plain(ar, ai, n, rho0_r, rho0_i, **kw)
        if kind == "state_unchanged":          # the solve returns its start
            return rho0_r.clone(), rho0_i.clone()
        est_r, est_i = est_r.clone(), est_i.clone()
        if kind == "half_batch":               # the second half left unsolved
            h = n.shape[0] // 2
            est_r[h:], est_i[h:] = rho0_r[h:], rho0_i[h:]
        else:                                  # one answer swapped for another
            est_r[-1], est_i[-1] = est_r[0], est_i[0]
        return est_r, est_i
    return broken


def _qv_fault(kind, cell):
    noisy = cell == "qv8.traj_c1600"
    name = "traj_probs_reference" if noisy else "ideal_probs_reference"
    plain = getattr(pallas_traj, name)

    def broken(perms, gates, *args):
        out = plain(perms, gates, *args)
        if kind == "state_unchanged":          # no layer applied: |0...0>
            out = torch.zeros_like(out)
            out[:, 0] = 1.0
        elif kind == "half_batch":             # the second half of the
            h = out.shape[0] // 2              # circuits not simulated
            out = out.clone()
            out[h:] = out[:out.shape[0] - h]
        return out
    return name, broken


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch",
                                  "answer_altered"])
@pytest.mark.parametrize("cell", TOMO + QV)
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, cell, kind):
    root = helpers.copy_benchmark(tmp_path)
    if cell in QV:
        # enough circuits that half of them are some
        path = root / "qcvv_bench" / "workloads" / f"{cell}.json"
        w = json.loads(path.read_text())
        w["traffic_params"]["circuits"] = 4
        path.write_text(json.dumps(w))
    helpers.count_plain_routes(monkeypatch)
    if cell in TOMO:
        monkeypatch.setattr(lanes_apg, "apg_fused_reference", _tomo_fault(kind))
    elif kind == "answer_altered":             # one tally counts the light set
        entry = quantum_volume.sample_heavy_outputs_batched

        def altered(generator, depth, circuits, shots, **kw):
            out = entry(generator, depth, circuits, shots, **kw).clone()
            out[-1] = shots - out[-1]
            return out
        monkeypatch.setattr(quantum_volume, "sample_heavy_outputs_batched",
                            altered)
    else:
        monkeypatch.setattr(pallas_traj, *_qv_fault(kind, cell))
    rc, result, err = helpers.run(root, cell, seconds=0.2)
    assert rc == 0, err
    # the calls ran on their route; the comparison is what fails
    assert result["failed"] == 0
    assert result["correct"] is False
    (name, check), = result["checks"].items()
    assert check["value"] > check["limit"], err


@pytest.mark.parametrize("cell,seeds", [
    ("ptomo2q.fused_b16384", (2 ** 31 + 11, 7, 123456789)),
    ("qv8.ideal_c1600", (2 ** 31 + 11, 7, 123456789)),
    ("qv8.traj_c1600", (2 ** 31 + 11, 7, 123456789))])
def test_the_control_fails_the_limit(cell, seeds):
    """The reference in the precision below the configuration's, put in the
    program's place (TF32 products for the tomography, bfloat16 for quantum
    volume), reads above the cell's limit, at a size the CPU holds."""
    options = harness.Options(device="cpu", require_cuda=False)
    spec = json.loads((helpers.ROOT / "BENCHMARK.json").read_text())
    c = harness.find_cell(options, spec, cell)
    traffic = dict(c.workload["traffic_params"], warmup_calls=1)
    traffic.update({"ptomo2q.fused_b16384": dict(batch=32, pool=1),
                    "qv8.ideal_c1600": dict(circuits=256),
                    "qv8.traj_c1600": dict(circuits=48)}[cell])
    limits = c.workload["limits"]
    for seed in seeds:
        sut = c.program.setup(c.config, traffic, seed, torch.device("cpu"),
                              c.reference)
        kept = [(0, sut.before(0), sut.fetch(sut.entry(0)))]
        readings = sut.control(kept)
        assert set(readings) == set(limits)
        assert any(readings[k] > limits[k] for k in limits), readings
