"""A QVM subclass that overrides only ``run`` keeps its noise in
symmetrized runs.

The JAX package's QVM on the CPU, like pyquil, runs each flip pattern of
``run_symmetrized_readout`` through ``self.run``; three of its notebooks
(``observable_estimation``, ``readout_error_estimation``,
``ripple_adder_benchmark``) add readout noise in a ``run`` override and
rely on it. The port takes that route whenever ``run`` is overridden, and
keeps one batched call for a plain ``QVM``.
"""
import numpy as np
import pytest
import torch

import forest_benchmarking_tpu.circuits as jcircuits
import forest_benchmarking_tpu.observable_estimation as jobs
import forest_benchmarking_tpu.paulis as jpaulis
import forest_benchmarking_tpu.sim as jsim
import forest_benchmarking_tpu_torch.circuits as circuits
import forest_benchmarking_tpu_torch.observable_estimation as obs
import forest_benchmarking_tpu_torch.paulis as paulis
import forest_benchmarking_tpu_torch.sim as sim
from forest_benchmarking_tpu_torch.sim import qvm as qvm_module

torch.set_num_threads(1)

P00, P11 = 0.95, 0.90      # observable_estimation.ipynb's readout noise


def noisy_readout_qvm(sim_module, p00=P00, p11=P11):
    """The notebooks' subclass: readout noise added in ``run`` only."""
    class NoisyReadoutQVM(sim_module.QVM):
        def run(self, circuit, qubits, num_shots):
            noisy = circuit.copy()
            for q in qubits:
                noisy.define_noisy_readout(q, p00=p00, p11=p11)
            return super().run(noisy, qubits, num_shots)
    return NoisyReadoutQVM


@pytest.mark.parametrize("symm_type", [-1, 1, 2])
def test_run_only_subclass_keeps_its_readout_noise(symm_type):
    """|0> on two qubits, symmetrized: each flip pattern reads its state
    through the noisy ``run``, so a bit reads 0 with probability
    (p00 + p11) / 2, not 1; the shot count is ``num_shots``."""
    qvm = noisy_readout_qvm(sim, 0.9, 0.8)(seed=4, device="cpu")
    shots = 20000
    bits = qvm.run_symmetrized_readout(
        circuits.Circuit([circuits.I(0), circuits.I(1)]), shots, symm_type,
        [0, 1])
    assert bits.shape == (shots, 2)
    p0 = (0.9 + 0.8) / 2
    sigma = np.sqrt(p0 * (1 - p0) / shots)
    assert np.all(np.abs((1 - bits.mean(axis=0)) - p0) < 5 * sigma), \
        bits.mean(axis=0)


def test_plain_qvm_makes_one_batched_call(monkeypatch):
    """A plain QVM samples every pattern in one call of the batched
    sampler and never goes through ``run``; a ``run``-only subclass goes
    through ``run`` once a pattern and never through the batched
    sampler."""
    calls = {"batched": 0, "run": 0}
    batched = qvm_module.sample_bits_symmetrized
    run = sim.QVM.run

    def count_batched(*args, **kw):
        calls["batched"] += 1
        return batched(*args, **kw)

    def count_run(self, *args, **kw):
        calls["run"] += 1
        return run(self, *args, **kw)

    monkeypatch.setattr(qvm_module, "sample_bits_symmetrized", count_batched)
    circuit = circuits.Circuit([circuits.H(0), circuits.CNOT(0, 1)])
    bits = sim.QVM(seed=1, device="cpu").run_symmetrized_readout(
        circuit, 1001, -1, [0, 1])
    assert bits.shape == (1001, 2)
    assert calls == {"batched": 1, "run": 0}

    class Subclass(sim.QVM):
        def run(self, circuit, qubits, num_shots):
            return count_run(self, circuit, qubits, num_shots)

    bits = Subclass(seed=1, device="cpu").run_symmetrized_readout(
        circuit, 1001, -1, [0, 1])
    assert bits.shape == (1001, 2)
    assert calls == {"batched": 1, "run": 4}


def bell_calibration(circuits_m, paulis_m, obs_m, sim_module, **kw):
    """observable_estimation.ipynb's set-up: the Bell state's XX, YY, ZZ
    and ZI, grouped, 4000 shots, on its noisy QVM (seed 1), then
    calibrated; returns the calibrated expectations and standard
    errors."""
    program = circuits_m.Circuit([circuits_m.H(0), circuits_m.CNOT(0, 1)])
    qubits = [0, 1]
    settings = [obs_m.ExperimentSetting(obs_m.zeros_state(qubits),
                                        paulis_m.PauliTerm(o))
                for o in ([(0, "X"), (1, "X")], [(0, "Y"), (1, "Y")],
                          [(0, "Z"), (1, "Z")], [(0, "Z")])]
    grouped = obs_m.group_settings(obs_m.ObservablesExperiment(settings,
                                                               program))
    noisy = noisy_readout_qvm(sim_module)(seed=1, **kw)
    raw = list(obs_m.estimate_observables(noisy, grouped, num_shots=4000))
    cal = list(obs_m.calibrate_observable_estimates(noisy, raw,
                                                    num_shots=4000))
    return (np.array([r.expectation for r in cal]),
            np.array([r.std_err for r in cal]),
            np.array([r.expectation for r in raw]))


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_calibration_recovers_the_bell_stabilizers(package):
    """After calibration XX, YY and ZZ land within 3 sigma of +1, -1, +1
    in both packages. ZI carries the readout's own bias: the raw runs are
    not symmetrized (``estimate_observables`` defaults to ``symm_type=0``),
    so <ZI> reads p00 - p11 and calibration divides it by
    p00 + p11 - 1. Without the noisy calibration runs the calibrated
    values would equal the raw ones (~0.72 for the stabilizers)."""
    if package == "torch":
        cal, err, raw = bell_calibration(circuits, paulis, obs, sim,
                                         device="cpu")
    else:
        cal, err, raw = bell_calibration(jcircuits, jpaulis, jobs, jsim)
    want = np.array([1, -1, 1, (P00 - P11) / (P00 + P11 - 1)])
    assert np.all(np.abs(cal - want) < 3 * err), (cal, err)
    assert np.all(np.abs(raw[:3]) < 0.8), raw
