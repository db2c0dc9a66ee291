"""The circuit half of the port's qubit spectroscopy, on its QVM.

Mirrors the generator and ``do_t1_or_t2`` tests of
tests/test_qubit_spectroscopy.py on ``QVM(device="cpu")`` at the JAX
suite's bars: T1 within 1 us, T2* and T2 echo within 1.5 us, the Rabi
frequency and amplitude within 0.02, the CZ-Ramsey offsets within 0.05.
Against the JAX package: the five generators give the same settings and
programs (the T1 and T2* times rounded to 100 ns, the echo's half-delays
unrounded), ``get_stats_by_qubit`` the same series, ``do_t1_or_t2``'s T1
and T2-echo fits of the same results agree by the LM rule of
``torch_lm_ties`` (its T2* fit lands on JAX's minimum, along a direction
flat to round-off: see its test), and the
QVM's probabilities for the programs (with T1 and T2 at each DELAY) lie
within 1e-12 of the JAX package's float64 simulator.
"""
import numpy as np
import pytest
import torch

import forest_benchmarking_tpu.qubit_spectroscopy as jqs
from forest_benchmarking_tpu_torch.circuits import Circuit, RZ
from forest_benchmarking_tpu_torch.observable_estimation import (
    ExperimentResult, ExperimentSetting, ObservablesExperiment, minusY,
    zeros_state)
from forest_benchmarking_tpu_torch.paulis import PauliTerm, str_to_pauli_term
from forest_benchmarking_tpu_torch.qubit_spectroscopy import (
    MICROSECOND, generate_t1_experiments, do_t1_or_t2,
    generate_t2_star_experiments, generate_t2_echo_experiments,
    fit_t1_results, fit_t2_results, generate_rabi_experiments,
    fit_rabi_results, generate_cz_phase_ramsey_experiments,
    fit_cz_phase_ramsey_results, acquire_qubit_spectroscopy_data,
    get_stats_by_qubit)
from forest_benchmarking_tpu_torch.sim import QVM
from torch_lm_ties import hold_against_jax
from torch_protocols import (
    PROB_BAR, experiment_probability_gap, experiment_signature, jax_results,
    same_gates)

torch.set_num_threads(1)

T_DECAY = dict(t1s={0: 100e-6, 1: 30e-6}, t2s={0: 9e-6, 1: 20e-6})


def qvm(seed, **kw):
    return QVM(seed=seed, device="cpu", **kw)


# --- the JAX suite's generator and do_t1_or_t2 tests on the port -------------

@pytest.fixture(scope="module")
def decay_runs():
    """``do_t1_or_t2`` for T1, T2* and T2 echo at the JAX tests' sizes."""
    t1, t2 = 12e-6, 9e-6
    return {
        "t1": (t1, np.linspace(1e-6, 40e-6, 15), do_t1_or_t2(
            qvm(1, t1s={0: t1}), [0], np.linspace(1e-6, 40e-6, 15), "t1",
            num_shots=4000)),
        "t2_star": (t2, np.linspace(0.5e-6, 20e-6, 25), do_t1_or_t2(
            qvm(2, t1s={0: 100e-6}, t2s={0: t2}), [0],
            np.linspace(0.5e-6, 20e-6, 25), "t2_star", num_shots=4000)),
        "t2_echo": (t2, np.linspace(0.5e-6, 20e-6, 25), do_t1_or_t2(
            qvm(3, t1s={0: 100e-6}, t2s={0: t2}), [0],
            np.linspace(0.5e-6, 20e-6, 25), "t2_echo", num_shots=4000)),
    }


@pytest.mark.parametrize("kind,bar", [("t1", 1.0), ("t2_star", 1.5),
                                      ("t2_echo", 1.5)])
def test_decay_time_recovery(decay_runs, kind, bar):
    truth, _, (decay_times, _, _) = decay_runs[kind]
    assert abs(decay_times[0] - truth / MICROSECOND) < bar


def test_do_t1_or_t2_bad_kind():
    with pytest.raises(ValueError):
        do_t1_or_t2(qvm(4), [0], [1e-6], "banana")


def test_rabi_calibrated_gate():
    angles = np.linspace(0, 2 * np.pi, 20)
    results = acquire_qubit_spectroscopy_data(
        qvm(5), generate_rabi_experiments([0], angles), num_shots=2000)
    stats = get_stats_by_qubit(results)
    fit = fit_rabi_results(angles, stats[0]["expectation"],
                           stats[0]["std_err"], device="cpu")
    assert abs(fit.params["frequency"].value - 1.0) < 0.02
    assert abs(abs(fit.params["amplitude"].value) - 0.5) < 0.02


def test_cz_phase_ramsey():
    angles = np.linspace(-np.pi, np.pi, 20)
    expts = generate_cz_phase_ramsey_experiments((0, 1), 0, angles)
    stats = get_stats_by_qubit(acquire_qubit_spectroscopy_data(
        qvm(6), expts, num_shots=2000))
    fit = fit_cz_phase_ramsey_results(angles, stats[0]["expectation"],
                                      stats[0]["std_err"], device="cpu")
    offset = fit.params["offset"].value % (2 * np.pi)
    assert min(offset, 2 * np.pi - offset) < 0.05


def test_effective_rz_phase_detected():
    angles = np.linspace(-np.pi, np.pi, 20)
    phase = 0.4
    expts = [ObservablesExperiment(
        [[ExperimentSetting(minusY(0), PauliTerm([(0, "Y")]))]],
        Circuit([RZ(phase, 0), RZ(angle, 0)])) for angle in angles]
    stats = get_stats_by_qubit(acquire_qubit_spectroscopy_data(
        qvm(7), expts, num_shots=2000))
    fit = fit_cz_phase_ramsey_results(angles, stats[0]["expectation"],
                                      stats[0]["std_err"], device="cpu")
    assert abs(fit.params["offset"].value - phase) < 0.05


def test_get_stats_by_qubit_rejects_multiqubit():
    res = ExperimentResult(
        ExperimentSetting(zeros_state([0, 1]),
                          str_to_pauli_term("ZZ", [0, 1])),
        expectation=1.0, total_counts=100)
    with pytest.raises(ValueError):
        get_stats_by_qubit([[res]])


def test_t1_experiment_structure():
    expts = generate_t1_experiments([0, 1], [1e-6, 2e-6])
    assert len(expts) == 2
    assert len(expts[0]) == 1
    assert len(expts[0][0]) == 2


def test_t2_echo_delays_sum_exactly_to_labeled_time():
    times = [3e-7, 4.5e-7, 9e-7, 1.05e-6]
    for t, expt in zip(times, generate_t2_echo_experiments([0], times)):
        delays = [g.params[0] for g in expt.program.gates
                  if g.name == "DELAY"]
        assert len(delays) == 2
        assert delays[0] == delays[1]
        assert delays[0] + delays[1] == t


# --- against the JAX package on the same inputs ------------------------------

def generator_pairs():
    times = [1.23456789e-6, 3e-7, 4.5e-7, 1.05e-6, 2e-5]
    angles = np.linspace(-np.pi, np.pi, 5)
    return [
        (generate_t1_experiments([0, 1], times),
         jqs.generate_t1_experiments([0, 1], times)),
        (generate_t2_star_experiments([1, 0], times, detuning=2e6),
         jqs.generate_t2_star_experiments([1, 0], times, detuning=2e6)),
        (generate_t2_echo_experiments([0, 1], times),
         jqs.generate_t2_echo_experiments([0, 1], times)),
        (generate_rabi_experiments([0, 2], angles),
         jqs.generate_rabi_experiments([0, 2], angles)),
        (generate_cz_phase_ramsey_experiments((0, 1), 1, angles),
         jqs.generate_cz_phase_ramsey_experiments((0, 1), 1, angles))]


def test_generators_equal_jax():
    for ours, theirs in generator_pairs():
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert experiment_signature(a)[0] == experiment_signature(b)[0]
            assert same_gates([a.program], [b.program], bar=0.0)


def test_spectroscopy_probabilities_equal_jax():
    """Every generator's programs, with T1 and T2 at DELAY."""
    for ours, _ in generator_pairs():
        assert experiment_probability_gap(ours, **T_DECAY) < PROB_BAR


@pytest.mark.parametrize("kind", ["t1", "t2_echo"])
def test_do_t1_or_t2_statistics_and_fits_equal_jax(monkeypatch, decay_runs,
                                                   kind):
    _, times, (decay_times, expts, results) = decay_runs[kind]
    stats = get_stats_by_qubit(results)
    assert stats == jqs.get_stats_by_qubit(
        [jax_results(r) for r in results])
    port_fit, jax_fit = ((fit_t1_results, jqs.fit_t1_results) if kind == "t1"
                         else (fit_t2_results, jqs.fit_t2_results))
    x = np.asarray(times) / MICROSECOND
    e, s = stats[0]["expectation"], stats[0]["std_err"]
    fit = port_fit(x, e, s, device="cpu")
    got = hold_against_jax(
        monkeypatch,
        lambda: [port_fit(x, e, s, device="cpu").best_values[k]
                 for k in fit.param_names],
        [jax_fit(x, e, s).best_values[k] for k in fit.param_names])
    assert got[0][fit.param_names.index("decay_time")] == decay_times[0]


def test_t2_star_fit_lands_on_jaxs_minimum(decay_runs):
    """The T2* fit of this run's data parts from JAX's by 3.8e-8 on the
    decay time (4.4e-9 relative), more than one step tie explains: both
    fits stop on the same minimum, whose decay-time direction is flat to
    round-off. They are held to equal chi-square (1e-12 relative) and to
    parameters within 1e-6 of their standard errors (measured: 1.6e-15 and
    6.1e-8)."""
    _, times, (decay_times, _, results) = decay_runs["t2_star"]
    stats = get_stats_by_qubit(results)
    assert stats == jqs.get_stats_by_qubit(
        [jax_results(r) for r in results])
    x = np.asarray(times) / MICROSECOND
    e, s = stats[0]["expectation"], stats[0]["std_err"]
    ours = fit_t2_results(x, e, s, device="cpu")
    want = jqs.fit_t2_results(x, e, s)
    assert ours.params["decay_time"].value == decay_times[0]
    assert abs(ours.chisqr - want.chisqr) <= 1e-12 * want.chisqr
    for k in ours.param_names:
        assert abs(ours.params[k].value - want.params[k].value) \
            <= 1e-6 * ours.params[k].stderr, k
