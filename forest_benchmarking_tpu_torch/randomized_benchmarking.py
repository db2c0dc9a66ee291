"""Randomized benchmarking: the numeric half.

Port of the parts of ``forest_benchmarking_tpu/randomized_benchmarking.py``
that need no circuits: survival statistics from I/Z-observable data, the RB
and unitarity decay fits (on the batched fitter of
:mod:`.analysis.fitting`), the purity estimates, the interleaved-RB algebra,
``unitary_to_ptm_np`` and the batched PTM-composition survival simulator
:func:`simulate_rb_survival_batched`. Sequence generation,
``circuit_unitary_np``, ``sequences_to_ptm_stack`` and ``do_rb`` need the
Clifford group (``clifford.py``) and wait for ROADMAP.md queue 1, item 10.

The fits and the simulator take numpy arrays or lists and run on the card
unless called with ``device="cpu"``; the simulator takes tensors where they
lie.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from forest_benchmarking_tpu_torch.analysis.fitting import (
    FitResult, errs_to_weights, fit_base_param_decay)
from forest_benchmarking_tpu_torch.ops.lanes_apg import full_f32_matmul
from forest_benchmarking_tpu_torch.ops.superoperator_transformations import (
    _p2c_np)
from forest_benchmarking_tpu_torch.utils import (
    entry_device, is_pos_pow_two, pauli_label_strings)

__all__ = [
    "covariances_of_all_iz_obs", "z_obs_stats_to_survival_statistics",
    "fit_rb_results", "estimate_purity", "estimate_purity_err",
    "fit_unitarity_results", "unitarity_to_rb_decay", "coherence_angle",
    "gamma", "interleaved_gate_fidelity_bounds", "gate_error_to_irb_decay",
    "irb_decay_to_gate_error", "average_gate_error_to_rb_decay",
    "rb_decay_to_gate_error", "unitary_to_ptm_np",
    "simulate_rb_survival_batched",
]


def _group_dim(expectations: Sequence[float]) -> int:
    dim = len(expectations) + 1
    if not is_pos_pow_two(dim):
        raise ValueError(f"{len(expectations)} expectations: a qubit group "
                         f"has 2**n - 1 I/Z observables")
    return dim


def covariances_of_all_iz_obs(expectations: Sequence[float], num_shots: int):
    """Summed pairwise covariance of the I/Z-product observables.

    The product of two distinct I/Z observables is a third from the same
    list, so the covariance is a function of the expectations alone: over
    the dim - 1 non-zero Z-strings, a xor b = k with a != b has dim - 2
    ordered solutions for each k. As in the JAX package, this departs from
    the reference's "2 * sum", which holds only for dim <= 4.
    """
    dim = _group_dim(expectations)
    covariance = (dim - 2) * sum(expectations)
    covariance -= sum(e1 * e2 for i, e1 in enumerate(expectations)
                      for j, e2 in enumerate(expectations) if i != j)
    return covariance / num_shots


def z_obs_stats_to_survival_statistics(expectations: Sequence[float],
                                       std_errs: Sequence[float],
                                       num_shots: Optional[int] = None,
                                       obs_are_independent: bool = False) \
        -> Tuple[float, float]:
    """(survival probability, variance) of the all-zeros outcome from I/Z
    statistics."""
    dim = _group_dim(expectations)
    survival_probability = (sum(expectations) + 1) / dim
    survival_var = sum(np.asarray(std_errs) ** 2) / dim ** 2
    if dim > 2 and not obs_are_independent:
        if num_shots is None:
            raise ValueError("The number of shots is necessary information for "
                             "computing the sample covariance.")
        survival_var += covariances_of_all_iz_obs(expectations,
                                                  num_shots) / dim ** 2
    return survival_probability, survival_var


def fit_rb_results(depths: Sequence[int],
                   z_expectations: Sequence[Sequence[float]],
                   z_std_errs: Sequence[Sequence[float]],
                   num_shots: Optional[int] = None,
                   param_guesses: Optional[tuple] = None,
                   device=None) -> FitResult:
    """Fit survival probabilities to the decay model; the decay is
    ``params['decay']``."""
    if len(depths) != len(z_expectations):
        raise ValueError("There should be one expectation per sequence and "
                         "depths should give the depth of each sequence.")
    survivals, variances = [], []
    for expectations, std_errs in zip(z_expectations, z_std_errs):
        survival_prob, survival_var = z_obs_stats_to_survival_statistics(
            expectations, std_errs, num_shots)
        survivals.append(survival_prob)
        variances.append(survival_var)
    if param_guesses is None:
        param_guesses = (survivals[0] - survivals[-1], 0.95, survivals[-1])
    weights = errs_to_weights(np.sqrt(variances))
    return fit_base_param_decay(np.asarray(depths), np.asarray(survivals),
                                weights, param_guesses, device=device)


def estimate_purity(dim: int, op_expect: np.ndarray, renorm: bool = True):
    """(Shifted) purity from Pauli expectations, eq. 10 of [ECN]."""
    purity = (1 / dim) * sum(op_expect ** 2)
    if renorm:
        purity = (dim / (dim - 1.0)) * (purity - 1.0 / dim)
    return purity


def estimate_purity_err(dim: int, op_expect: np.ndarray,
                        op_expect_var: np.ndarray, renorm=True):
    """Propagate expectation variances to a purity standard error
    (independent expectations assumed)."""
    var_of_square = (2 * np.abs(op_expect)) ** 2 * op_expect_var
    need_second_order = np.isclose([0.] * len(var_of_square), var_of_square,
                                   atol=1e-6)
    var_of_square[need_second_order] = op_expect_var[need_second_order] ** 2
    purity_var = (1 / dim) ** 2 * np.sum(var_of_square)
    if renorm:
        purity_var = (dim / (dim - 1.0)) ** 2 * purity_var
    return np.sqrt(purity_var)


def fit_unitarity_results(depths: Sequence[int],
                          expectations: Sequence[Sequence[float]],
                          std_errs: Sequence[Sequence[float]],
                          param_guesses: Optional[tuple] = None,
                          device=None) -> FitResult:
    """Fit shifted purities to the decay model; the unitarity is
    ``params['decay']``."""
    if len(depths) != len(expectations):
        raise ValueError("There should be one group of 4**(num_qubits) - 1 "
                         "expectations per sequence and depths should give "
                         "the depth of each sequence.")
    shifted_purities, shifted_purity_errs = [], []
    for exps, errs in zip(expectations, std_errs):
        dim = int(np.sqrt(len(exps) + 1))
        exps = np.asarray(list(exps) + [1.])
        op_vars = np.asarray(list(errs) + [0.]) ** 2
        shifted_purities.append(estimate_purity(dim, exps))
        shifted_purity_errs.append(estimate_purity_err(dim, exps, op_vars))
    if param_guesses is None:
        param_guesses = (shifted_purities[0], 0.95, 0)
    weights = errs_to_weights(shifted_purity_errs)
    return fit_base_param_decay(np.asarray(depths),
                                np.asarray(shifted_purities), weights,
                                param_guesses, device=device)


def unitarity_to_rb_decay(unitarity, dimension) -> float:
    """Upper bound on the RB decay from the unitarity (Prop. 8 of [ECN],
    saturated for purely stochastic noise)."""
    r = (np.sqrt(unitarity) - 1) * (1 - dimension) / dimension
    return average_gate_error_to_rb_decay(r, dimension)


# ----------------------------- IRB analysis ---------------------------------

def coherence_angle(rb_decay: float, unitarity: float):
    """Eq. 29 of [U+IRB]."""
    return np.arccos(rb_decay / np.sqrt(unitarity))


def gamma(irb_decay: float, unitarity: float):
    """Corollary 5 of [U+IRB], second line."""
    return irb_decay / np.sqrt(unitarity)


def interleaved_gate_fidelity_bounds(irb_decay: float, rb_decay: float,
                                     dim: int,
                                     unitarity: Optional[float] = None):
    """(lower, upper) bounds on the interleaved gate fidelity ([IRB];
    tighter with the unitarity, [U+IRB] Corollary 5)."""
    if unitarity is not None:
        theta = coherence_angle(rb_decay, unitarity)
        g = gamma(irb_decay, unitarity)
        decay_bounds = [sign * (sign * g * np.cos(theta)
                                + np.sin(theta) * np.sqrt(1 - g ** 2))
                        for sign in (-1, 1)]
        return [1 - rb_decay_to_gate_error(decay, dim)
                for decay in decay_bounds]
    e1 = (abs(rb_decay - irb_decay / rb_decay) + (1 - rb_decay)) \
        * (dim - 1) / dim
    e2 = 2 * (dim ** 2 - 1) * (1 - rb_decay) / (rb_decay * dim ** 2) + \
        4 * np.sqrt(1 - rb_decay) * np.sqrt(dim ** 2 - 1) / rb_decay
    e = min(e1, e2)
    error = irb_decay_to_gate_error(irb_decay, rb_decay, dim)
    return [1 - error - e, 1 - error + e]


def gate_error_to_irb_decay(irb_error: float, rb_decay: float, dim: int):
    """Inversion of eq. 4 of [IRB]."""
    return (1 - irb_error * (dim / (dim - 1))) * rb_decay


def irb_decay_to_gate_error(irb_decay: float, rb_decay: float, dim: int):
    """Eq. 4 of [IRB]: the interleaved gate's error from both decays."""
    return ((dim - 1) / dim) * (1 - irb_decay / rb_decay)


def average_gate_error_to_rb_decay(gate_error: float, dimension: int):
    """Inversion of eq. 5 of [RB]."""
    return (gate_error - 1 + 1 / dimension) / (1 / dimension - 1)


def rb_decay_to_gate_error(rb_decay: float, dimension: int):
    """Eq. 5 of [RB]: the average Clifford error from the decay."""
    return 1 - rb_decay - (1 - rb_decay) / dimension


# ----------------------- batched on-device RB simulator ----------------------

def unitary_to_ptm_np(u: np.ndarray) -> np.ndarray:
    """Pauli transfer matrix of a unitary, in numpy (host side)."""
    d = u.shape[0]
    p2c = _p2c_np(d)
    c2p = p2c.conj().T / d
    superop = np.kron(u.conj(), u)
    return np.real(c2p @ superop @ c2p.conj().T * d)


def simulate_rb_survival_batched(ptms, noise_ptm=None,
                                 generator: Optional[torch.Generator] = None,
                                 num_shots: int = 0, dtype=None, lengths=None,
                                 device=None) -> torch.Tensor:
    """Survival probabilities of a batch of RB sequences by PTM composition.

    :param ptms: (S, L, d^2, d^2) sequence PTMs. Each sequence is applied
        left to right with ``noise_ptm`` (if given) after every element, the
        'noise per Clifford' RB model.
    :param lengths: (S,) true sequence lengths; the identity padding past a
        sequence's length gets no noise. Default: all of L.
    :param generator: with ``num_shots`` > 0, draw binomial survival
        estimates from this ``torch.Generator`` (on the run's device; the
        JAX package's ``key``); otherwise return the exact probabilities.
    :param device: where numpy inputs run, the card by default; tensors run
        where ``ptms`` lies.
    :return: (S,) survival probabilities (exact or sampled).
    """
    dev = entry_device(device, ptms, noise_ptm, lengths)
    ptms = torch.as_tensor(ptms, dtype=dtype, device=dev)
    s, length, d2, _ = ptms.shape
    d = int(np.sqrt(d2))
    noise = (torch.eye(d2, dtype=ptms.dtype, device=dev) if noise_ptm is None
             else torch.as_tensor(noise_ptm, dtype=ptms.dtype, device=dev))
    lengths = (torch.full((s,), length, device=dev) if lengths is None
               else torch.as_tensor(lengths, device=dev))
    # PL coordinates of |0..0><0..0|: 1 on every I/Z string
    iz = torch.tensor([all(c in "IZ" for c in lab)
                       for lab in pauli_label_strings(int(np.log2(d)))],
                      dtype=ptms.dtype, device=dev)
    r = iz.expand(s, d2)
    with full_f32_matmul():
        for j in range(length):
            step = (noise @ (ptms[:, j] @ r[..., None]))[..., 0]
            r = torch.where((j < lengths)[:, None], step, r)
    # p(0..0) = (1/d) sum over the I/Z strings of the PL coordinates
    survival = (r * iz).sum(-1) / d
    if generator is None or num_shots == 0:
        return survival
    if torch.device(generator.device).type != dev.type:
        raise ValueError(f"generator on {generator.device} but the "
                         f"simulation runs on {dev}")
    k = torch.binomial(torch.full_like(survival, num_shots),
                       survival.clamp(0.0, 1.0), generator=generator)
    return k / num_shots
