"""Direct fidelity estimation (exhaustive and Monte Carlo, state and
process).

Port of ``forest_benchmarking_tpu/direct_fidelity_estimation.py``, with its
public names: the experiment generators (Pauli conjugation by the ideal
Clifford program through :func:`.clifford.apply_clifford_to_pauli`, no
quilc benchmarker), :func:`acquire_dfe_data` with readout calibration,
:func:`estimate_dfe` with the identity-weighting bias correction and
:func:`do_dfe`. The Monte Carlo samplers draw from an explicit numpy
``RandomState`` (or the global ``np.random``), so a seeded draw gives the
JAX package's settings. The circuits run on ``qc``'s device; the estimate
is host numpy.
"""
from __future__ import annotations

import functools
import itertools
from typing import List, Optional, Tuple

import numpy as np

from forest_benchmarking_tpu_torch.circuits import Circuit
from forest_benchmarking_tpu_torch.paulis import (
    str_to_pauli_term, all_traceless_pauli_z_terms)
from forest_benchmarking_tpu_torch.clifford import apply_clifford_to_pauli
from forest_benchmarking_tpu_torch.observable_estimation import (
    ExperimentResult, ExperimentSetting, ObservablesExperiment,
    TensorProductState, _OneQState, zeros_state, estimate_observables,
    calibrate_observable_estimates, group_settings)

__all__ = [
    "generate_exhaustive_process_dfe_experiment",
    "generate_exhaustive_state_dfe_experiment",
    "generate_monte_carlo_state_dfe_experiment",
    "generate_monte_carlo_process_dfe_experiment",
    "acquire_dfe_data", "estimate_dfe", "do_dfe",
]


def generate_exhaustive_process_dfe_experiment(program: Circuit, qubits: list) \
        -> ObservablesExperiment:
    """Process DFE over every non-identity Pauli [DFE1][DFE2].

    Each input Pauli is prepared in all of its +-1 product eigenstates (with the
    sign folded into the observable) and the conjugated Pauli C P C^dag is
    measured at the output.
    """
    settings = []
    for pauli_labels in ["".join(x) for x in
                         itertools.product("IXYZ", repeat=len(qubits))][1:]:
        observable = apply_clifford_to_pauli(
            program, str_to_pauli_term(pauli_labels, qubits), qubits)
        non_identity_idx = [0 if label == "I" else 1 for label in pauli_labels]
        state_labels = ["Z" if label == "I" else label for label in pauli_labels]
        for eigenstate in itertools.product([0, 1], repeat=len(qubits)):
            in_state = TensorProductState(
                _OneQState(l, s, q) for l, s, q in
                zip(state_labels, eigenstate, qubits))
            sign_contribution = (-1) ** np.dot(eigenstate, non_identity_idx)
            settings.append(ExperimentSetting(
                in_state=in_state,
                observable=observable * int(sign_contribution)))
    return ObservablesExperiment(settings, program=program)


def generate_exhaustive_state_dfe_experiment(program: Circuit, qubits: list) \
        -> ObservablesExperiment:
    """State DFE over the stabilizer group of the ideal state [DFE1][DFE2]."""
    settings = [ExperimentSetting(
        in_state=zeros_state(qubits),
        observable=apply_clifford_to_pauli(program, iz_pauli, qubits))
        for iz_pauli in all_traceless_pauli_z_terms(qubits)]
    return ObservablesExperiment(settings, program=program)


def generate_monte_carlo_state_dfe_experiment(program: Circuit, qubits: List[int],
                                              n_terms: int = 200,
                                              rng: Optional[np.random.RandomState] = None) \
        -> ObservablesExperiment:
    """Sampled state DFE: constant overhead in the number of qubits."""
    if rng is None:
        rng = np.random
    rand_iz_paulis = rng.choice(["I", "Z"], size=(n_terms, len(qubits)))

    settings = []
    for iz_pauli in rand_iz_paulis:
        while "Z" not in iz_pauli:
            iz_pauli = rng.choice(["I", "Z"], size=len(qubits))
        obs = apply_clifford_to_pauli(
            program, str_to_pauli_term("".join(iz_pauli), qubits), qubits)
        settings.append(ExperimentSetting(zeros_state(qubits), obs))
    return ObservablesExperiment(settings, program=program)


def generate_monte_carlo_process_dfe_experiment(program: Circuit, qubits: List[int],
                                                n_terms: int = 200,
                                                rng: Optional[np.random.RandomState] = None) \
        -> ObservablesExperiment:
    """Sampled process DFE: constant overhead in the number of qubits."""
    if rng is None:
        rng = np.random
    single_q_paulis = ["I", "X", "Y", "Z"]
    rand_paulis = rng.randint(len(single_q_paulis), size=(n_terms, len(qubits)))

    settings = []
    for pauli_idxs in rand_paulis:
        while sum(pauli_idxs) == 0:
            pauli_idxs = rng.randint(len(single_q_paulis), size=len(qubits))
        pauli_str = "".join(single_q_paulis[idx] for idx in pauli_idxs)
        pauli = str_to_pauli_term(pauli_str, qubits)
        observable = apply_clifford_to_pauli(program, pauli, qubits)
        state_labels = ["Z" if label == "I" else label for label in pauli_str]
        eigenstate = rng.randint(2, size=len(qubits))
        in_state = TensorProductState(
            _OneQState(l, s, q) for l, s, q in
            zip(state_labels, eigenstate, qubits))
        sign_contribution = (-1) ** np.dot(eigenstate,
                                           [min(1, idx) for idx in pauli_idxs])
        settings.append(ExperimentSetting(
            in_state=in_state, observable=observable * int(sign_contribution)))
    return ObservablesExperiment(settings, program=program)


def acquire_dfe_data(qc, expt: ObservablesExperiment, num_shots: int = 10_000,
                     active_reset: bool = False, symm_type: int = -1,
                     calibrate_observables: bool = True,
                     show_progress_bar: bool = False) -> List[ExperimentResult]:
    """Run a DFE experiment (optionally with readout calibration)."""
    res = list(estimate_observables(qc, expt, num_shots=num_shots,
                                    symm_type=symm_type,
                                    active_reset=active_reset,
                                    show_progress_bar=show_progress_bar))
    if calibrate_observables:
        res = list(calibrate_observable_estimates(qc, res, num_shots=num_shots,
                                                  symm_type=symm_type,
                                                  active_reset=active_reset))
    return res


def estimate_dfe(results: List[ExperimentResult], kind: str) -> Tuple[float, float]:
    """(fidelity, std_err) from DFE results, with the identity-weighting bias
    correction (see the long discussion at reference :268-303): the unmeasured
    identity expectation (always 1) is folded in with weight 1/d (state) or
    1/d^2 (process), and the measured non-trivial Paulis are reweighted by
    (d-1)/d or (d^2-1)/d^2 respectively. Process results are converted to
    average gate fidelity (d^2 p + d)/(d^2 + d) [Nie].
    """
    qubits = list(functools.reduce(lambda x, y: set(x) | set(y),
                                   [res.setting.observable.get_qubits()
                                    for res in results]))
    d = 2 ** len(qubits)
    expectations = [res.expectation for res in results]
    std_errs = np.asarray([res.std_err for res in results])

    if kind.lower() == "state":
        mean_est = (d - 1) / d * np.mean(expectations) + 1.0 / d
        var_est = (d - 1) ** 2 / d ** 2 * np.sum(std_errs ** 2) \
            / len(expectations) ** 2
    elif kind.lower() == "process":
        p_mean = (d ** 2 - 1) / d ** 2 * np.mean(expectations) + 1.0 / d ** 2
        mean_est = (d ** 2 * p_mean + d) / (d ** 2 + d)
        var_est = d ** 2 / (d + 1) ** 2 * (d ** 2 - 1) ** 2 / d ** 4 \
            * np.sum(std_errs ** 2) / len(expectations) ** 2
    else:
        raise ValueError("Kind can only be 'state' or 'process'.")
    return mean_est, float(np.sqrt(var_est))


def do_dfe(qc, program: Circuit, qubits: List[int], kind: str,
           mc_n_terms: Optional[int] = None, num_shots: int = 1_000,
           active_reset: bool = False, group_tpb_settings: bool = False,
           symm_type: int = -1, calibrate_observables: bool = True,
           show_progress_bar: bool = False,
           rng: Optional[np.random.RandomState] = None) \
        -> Tuple[Tuple[float, float], ObservablesExperiment, List[ExperimentResult]]:
    """Generate, acquire, and estimate a DFE experiment end-to-end.

    Unlike the reference (:310) no benchmarker is needed — Pauli conjugation
    happens in-process via the tableau engine.
    """
    if kind.lower() not in ["state", "process"]:
        raise ValueError("Kind must be either 'state' or 'process'.")

    if mc_n_terms is None:
        if kind.lower() == "state":
            expt = generate_exhaustive_state_dfe_experiment(program, qubits)
        else:
            expt = generate_exhaustive_process_dfe_experiment(program, qubits)
    else:
        if kind.lower() == "state":
            expt = generate_monte_carlo_state_dfe_experiment(program, qubits,
                                                             mc_n_terms, rng)
        else:
            expt = generate_monte_carlo_process_dfe_experiment(program, qubits,
                                                               mc_n_terms, rng)
    if group_tpb_settings:
        expt = group_settings(expt)

    results = acquire_dfe_data(qc, expt, num_shots, active_reset=active_reset,
                               symm_type=symm_type,
                               calibrate_observables=calibrate_observables,
                               show_progress_bar=show_progress_bar)
    fid, std_err = estimate_dfe(results, kind)
    return (fid, std_err), expt, results
