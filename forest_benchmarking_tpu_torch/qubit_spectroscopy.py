"""Qubit spectroscopy: the fits.

Port of the fit half of ``forest_benchmarking_tpu/qubit_spectroscopy.py``:
T1, T2 (Ramsey / echo), Rabi and CZ phase-Ramsey fits of Pauli expectation
series on the batched fitter of :mod:`.analysis.fitting`. Experiment
generation and ``do_t1_or_t2`` wait for ROADMAP.md queue 1, item 10 (the
circuit data model and the QVM they run on are ported). The fits take
numpy arrays or lists and run on the card unless called with
``device="cpu"``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from forest_benchmarking_tpu_torch.analysis.fitting import (
    FitResult, errs_to_weights, fit_decay_time_param_decay,
    fit_decaying_cosine, fit_shifted_cosine)
from forest_benchmarking_tpu_torch.utils import transform_pauli_moments_to_bit

__all__ = ["MICROSECOND", "MHZ", "fit_t1_results", "fit_t2_results",
           "fit_rabi_results", "fit_cz_phase_ramsey_results"]

MICROSECOND = 1e-6
MHZ = 1e6


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


def fit_t1_results(times: Sequence[float], z_expectations: Sequence[float],
                   z_std_errs: Sequence[float] = None,
                   param_guesses: tuple = (1.0, 15, 0.0),
                   device=None) -> FitResult:
    """Fit P(1) against time to an exponential; T1 is
    ``params['decay_time']``."""
    probability_one, weights = _pauli_to_weights(z_expectations, z_std_errs)
    return fit_decay_time_param_decay(np.asarray(times), probability_one,
                                      weights, param_guesses, device=device)


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


def fit_rabi_results(angles: Sequence[float], z_expectations: Sequence[float],
                     z_std_errs: Sequence[float] = None,
                     param_guesses: tuple = (-.5, 0, .5, 1.),
                     device=None) -> FitResult:
    """Fit P(1) against the control angle to a shifted cosine; 'frequency'
    is the ratio of the actual to the intended rotation angle."""
    probability_one, weights = _pauli_to_weights(z_expectations, z_std_errs)
    return fit_shifted_cosine(np.asarray(angles), probability_one, weights,
                              param_guesses, device=device)


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
