"""Qubit spectroscopy: T1, T2*, T2 echo, Rabi and CZ phase Ramsey.

Port of ``forest_benchmarking_tpu/qubit_spectroscopy.py``, with its public
names: the experiment generators, acquisition on ``qc`` (the port's QVM,
whose per-qubit ``t1s`` and ``t2s`` decohere each DELAY, so closed-loop
recovery works), the per-qubit statistics, :func:`do_t1_or_t2`, and the
T1, T2 (Ramsey / echo), Rabi and CZ phase-Ramsey fits on the batched
fitter of :mod:`.analysis.fitting`. The fits take numpy arrays or lists
and run on the card unless called with ``device="cpu"``;
:func:`do_t1_or_t2` fits on ``qc.device``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
from numpy import pi

from forest_benchmarking_tpu_torch.analysis.fitting import (
    FitResult, errs_to_weights, fit_decay_time_param_decay,
    fit_decaying_cosine, fit_shifted_cosine)
from forest_benchmarking_tpu_torch.circuits import (
    Circuit, DELAY, RX, RY, RZ, CZ)
from forest_benchmarking_tpu_torch.observable_estimation import (
    ObservablesExperiment, ExperimentResult, ExperimentSetting,
    estimate_observables, minusZ, plusZ, minusY)
from forest_benchmarking_tpu_torch.paulis import PauliTerm
from forest_benchmarking_tpu_torch.utils import (
    progress_iter, transform_pauli_moments_to_bit)

__all__ = [
    "MICROSECOND", "MHZ", "acquire_qubit_spectroscopy_data",
    "get_stats_by_qubit", "generate_t1_experiments", "fit_t1_results",
    "do_t1_or_t2", "generate_t2_star_experiments",
    "generate_t2_echo_experiments", "fit_t2_results",
    "generate_rabi_experiments", "fit_rabi_results",
    "generate_cz_phase_ramsey_experiments", "fit_cz_phase_ramsey_results",
]

MICROSECOND = 1e-6
MHZ = 1e6


def acquire_qubit_spectroscopy_data(qc,
                                    experiments: Sequence[ObservablesExperiment],
                                    num_shots: int = 500,
                                    show_progress_bar: bool = False) \
        -> List[List[ExperimentResult]]:
    """Run each experiment in series; one result list per experiment."""
    results = []
    for expt in progress_iter(list(experiments), show_progress_bar,
                              desc="acquire_qubit_spectroscopy_data"):
        results.append(list(estimate_observables(qc, expt, num_shots)))
    return results


def get_stats_by_qubit(expt_results: List[List[ExperimentResult]]) \
        -> Dict[int, Dict[str, List[float]]]:
    """Arrange the results of one-qubit observables into per-qubit series."""
    stats_by_qubit = {}
    for results in expt_results:
        for res in results:
            qubits = res.setting.observable.get_qubits()
            if len(qubits) > 1:
                raise ValueError("This method is intended for single qubit "
                                 "observables.")
            qubit = qubits[0]
            if qubit not in stats_by_qubit:
                stats_by_qubit[qubit] = {"expectation": [], "std_err": []}
            stats_by_qubit[qubit]["expectation"].append(res.expectation)
            stats_by_qubit[qubit]["std_err"].append(res.std_err)
    return stats_by_qubit


def _pauli_to_weights(expectations: Sequence[float],
                      std_errs: Sequence[float] = None):
    """(probability of one, weights) from negated Pauli expectations."""
    expectations = np.asarray(expectations)
    if std_errs is not None:
        probability_one, var = transform_pauli_moments_to_bit(
            -1 * expectations, np.asarray(std_errs) ** 2)
        return probability_one, errs_to_weights(np.sqrt(var))
    probability_one, _ = transform_pauli_moments_to_bit(-1 * expectations, 0)
    return probability_one, None


# ---------------------------------- T1 --------------------------------------

def generate_t1_experiments(qubits: Sequence[int], times: Sequence[float]) \
        -> List[ObservablesExperiment]:
    """Prepare each qubit in |1>, delay t, measure Z: one experiment per
    time (rounded to 100 ns)."""
    expts = []
    for t in times:
        t = round(t, 7)
        program = Circuit()
        settings = []
        for q in qubits:
            program += DELAY(t, q)
            settings.append(ExperimentSetting(minusZ(q),
                                              PauliTerm([(q, "Z")])))
        expts.append(ObservablesExperiment([settings], program))
    return expts


def fit_t1_results(times: Sequence[float], z_expectations: Sequence[float],
                   z_std_errs: Sequence[float] = None,
                   param_guesses: tuple = (1.0, 15, 0.0),
                   device=None) -> FitResult:
    """Fit P(1) against time to an exponential; T1 is
    ``params['decay_time']``."""
    probability_one, weights = _pauli_to_weights(z_expectations, z_std_errs)
    return fit_decay_time_param_decay(np.asarray(times), probability_one,
                                      weights, param_guesses, device=device)


def do_t1_or_t2(qc, qubits: Sequence[int], times: Sequence[float],
                kind: str, num_shots: int = 500,
                show_progress_bar: bool = False) \
        -> Tuple[Dict[int, float], List[ObservablesExperiment],
                 List[List[ExperimentResult]]]:
    """Generate, acquire and fit a T1, T2* or T2-echo experiment per qubit;
    the circuits run and the fits run on ``qc.device``."""
    if kind.lower() == "t1":
        gen_method, fit_method = generate_t1_experiments, fit_t1_results
    elif kind.lower() == "t2_star":
        gen_method, fit_method = generate_t2_star_experiments, fit_t2_results
    elif kind.lower() == "t2_echo":
        gen_method, fit_method = generate_t2_echo_experiments, fit_t2_results
    else:
        raise ValueError("Kind must be one of 't1', 't2_star', or 't2_echo'.")

    expts = gen_method(qubits, times)
    results = acquire_qubit_spectroscopy_data(qc, expts, num_shots,
                                              show_progress_bar)
    stats = get_stats_by_qubit(results)
    decay_time_by_qubit = {}
    for qubit in qubits:
        fit = fit_method(np.asarray(times) / MICROSECOND,
                         stats[qubit]["expectation"], stats[qubit]["std_err"],
                         device=qc.device)
        decay_time_by_qubit[qubit] = float(fit.params["decay_time"].value)
    return decay_time_by_qubit, expts, results


# ------------------------------- T2* / T2 echo -------------------------------

def generate_t2_star_experiments(qubits: Sequence[int],
                                 times: Sequence[float],
                                 detuning: float = 1e6) \
        -> List[ObservablesExperiment]:
    """Prepare minusY, delay t and detune by RZ, measure Y: Ramsey
    fringes."""
    expts = []
    for t in times:
        t = round(t, 7)
        program = Circuit()
        settings = []
        for q in qubits:
            program += DELAY(t, q)
            program += RZ(2 * pi * t * detuning, q)
            settings.append(ExperimentSetting(minusY(q),
                                              PauliTerm([(q, "Y")])))
        expts.append(ObservablesExperiment([settings], program))
    return expts


def generate_t2_echo_experiments(qubits: Sequence[int],
                                 times: Sequence[float],
                                 detuning: float = 1e6) \
        -> List[ObservablesExperiment]:
    """Like T2*, with an RY(pi) echo splitting the delay.

    As in the JAX package (a departure from the reference), the half-delay
    is not rounded to 100 ns: the two half-delays sum to exactly the
    labelled time, which the detuning phase and the fit axis use.
    """
    expts = []
    for t in times:
        half_time = t / 2
        program = Circuit()
        settings = []
        for q in qubits:
            program += DELAY(half_time, q)
            program += RY(pi, q)
            program += DELAY(half_time, q)
            program += RZ(2 * pi * t * detuning, q)
            settings.append(ExperimentSetting(minusY(q),
                                              PauliTerm([(q, "Y")])))
        expts.append(ObservablesExperiment([settings], program))
    return expts


def fit_t2_results(times: Sequence[float], y_expectations: Sequence[float],
                   y_std_errs: Sequence[float] = None, detuning: float = 1e6,
                   param_guesses: tuple = None, device=None) -> FitResult:
    """Fit P(1) against time to a decaying cosine; T2 is
    ``params['decay_time']``."""
    if param_guesses is None:
        param_guesses = (.5, 10, 0.0, 0.5, detuning / MHZ)
    probability_one, weights = _pauli_to_weights(y_expectations, y_std_errs)
    return fit_decaying_cosine(np.asarray(times), probability_one, weights,
                               param_guesses, device=device)


# --------------------------------- Rabi --------------------------------------

def generate_rabi_experiments(qubits: Sequence[int],
                              angles: Sequence[float]) \
        -> List[ObservablesExperiment]:
    """RX(angle) from |0>, measure Z: one experiment per angle."""
    expts = []
    for angle in angles:
        program = Circuit()
        settings = []
        for q in qubits:
            program += RX(angle, q)
            settings.append(ExperimentSetting(plusZ(q),
                                              PauliTerm([(q, "Z")])))
        expts.append(ObservablesExperiment([settings], program))
    return expts


def fit_rabi_results(angles: Sequence[float], z_expectations: Sequence[float],
                     z_std_errs: Sequence[float] = None,
                     param_guesses: tuple = (-.5, 0, .5, 1.),
                     device=None) -> FitResult:
    """Fit P(1) against the control angle to a shifted cosine; 'frequency'
    is the ratio of the actual to the intended rotation angle."""
    probability_one, weights = _pauli_to_weights(z_expectations, z_std_errs)
    return fit_shifted_cosine(np.asarray(angles), probability_one, weights,
                              param_guesses, device=device)


# ---------------------------- CZ phase Ramsey --------------------------------

def generate_cz_phase_ramsey_experiments(cz_qubits: Sequence[int],
                                         measure_qubit: int,
                                         angles: Sequence[float]) \
        -> List[ObservablesExperiment]:
    """CZ, then RZ(angle) on the measure qubit prepared in minusY; measure
    Y."""
    expts = []
    for angle in angles:
        program = Circuit()
        program += CZ(*cz_qubits)
        program += RZ(angle, measure_qubit)
        settings = [ExperimentSetting(minusY(measure_qubit),
                                      PauliTerm([(measure_qubit, "Y")]))]
        expts.append(ObservablesExperiment([settings], program))
    return expts


def fit_cz_phase_ramsey_results(angles: Sequence[float],
                                y_expectations: Sequence[float],
                                y_std_errs: Sequence[float] = None,
                                param_guesses: tuple = (.5, 0, .5, 1.),
                                device=None) -> FitResult:
    """Fit P(1) against the angle to a shifted cosine; 'offset' estimates
    the effective RZ the CZ imparts on the measure qubit."""
    probability_one, weights = _pauli_to_weights(y_expectations, y_std_errs)
    return fit_shifted_cosine(np.asarray(angles), probability_one, weights,
                              param_guesses, device=device)
