"""Readout and reset error characterization.

Port of ``forest_benchmarking_tpu/readout.py``, with its public names.
Bitstring preparations run on ``qc`` (the port's QVM, on its device) and
the confusion rows are counted on the host with ``np.bincount``.
``use_param_program`` selects the three-gate-per-qubit preparation the
reference's parameterized program uses. The QVM's reset is ideal, so
:func:`estimate_joint_reset_confusion` measures no reset physics, as in the
JAX package.
"""
from __future__ import annotations

import itertools
from math import pi
from typing import Dict, Sequence, Tuple

import numpy as np

from forest_benchmarking_tpu_torch.circuits import Circuit, RX
from forest_benchmarking_tpu_torch.utils import (
    bitstring_prep, parameterized_bitstring_prep, bit_arrays_to_ints,
    progress_iter)

__all__ = ["get_flipped_circuit", "estimate_confusion_matrix",
           "estimate_joint_confusion_in_set", "marginalize_confusion_matrix",
           "estimate_joint_reset_confusion"]


def get_flipped_circuit(circuit: Circuit, qubits: Sequence[int]) -> Circuit:
    """Append X flips on the measured qubits (for readout symmetrization).

    The reference rewrites MEASURE instructions in place (:15); here measurement
    is implicit, so the flips go at the end of the circuit.
    """
    flipped = circuit.copy()
    for q in qubits:
        flipped += RX(pi, q)
    return flipped


def estimate_confusion_matrix(qc, qubit: int, num_shots: int = 10000) -> np.ndarray:
    """2x2 confusion matrix [[p(0|0), p(1|0)], [p(0|1), p(1|1)]] for a qubit."""
    should_be_0 = qc.run(Circuit(), [qubit], num_shots)
    should_be_1 = qc.run(Circuit([RX(pi, qubit)]), [qubit], num_shots)
    p00 = 1 - np.mean(should_be_0)
    p11 = np.mean(should_be_1)
    return np.array([[p00, 1 - p00], [1 - p11, p11]])


def estimate_joint_confusion_in_set(qc, qubits: Sequence[int] = None,
                                    num_shots: int = 1000,
                                    joint_group_size: int = 1,
                                    use_param_program: bool = True,
                                    use_active_reset: bool = False,
                                    show_progress_bar: bool = False) \
        -> Dict[Tuple[int, ...], np.ndarray]:
    """Joint confusion matrix for every size-``joint_group_size`` qubit group.

    Rows index the prepared bitstring, columns the measured bitstring (most
    significant bit = smallest qubit label); each row sums to one.
    """
    if qubits is None:
        raise ValueError("Specify the qubits to characterize.")
    qubits = sorted(qubits)
    groups = list(itertools.combinations(qubits, joint_group_size))
    confusion_matrices = {}
    dim = 2 ** joint_group_size
    for group in progress_iter(groups, show_progress_bar,
                               desc="joint confusion groups"):
        matrix = np.zeros((dim, dim))
        for row, bitstring in enumerate(itertools.product([0, 1],
                                                          repeat=joint_group_size)):
            if use_param_program:
                prep = parameterized_bitstring_prep(group, bitstring)
            else:
                prep = bitstring_prep(group, bitstring)
            results = qc.run(prep, list(group), num_shots)
            observed = bit_arrays_to_ints(results)
            matrix[row] = np.bincount(observed, minlength=dim) / num_shots
        confusion_matrices[group] = matrix
    return confusion_matrices


def marginalize_confusion_matrix(confusion_matrix: np.ndarray,
                                 all_qubits: Sequence[int],
                                 marginal_subset: Tuple[int, ...]) -> np.ndarray:
    """Marginalize a joint confusion matrix onto a subset of its qubits.

    Sums out the row/column axes of qubits not in the subset, renormalized by
    2^(num qubits removed) (reference :183-233).
    """
    all_indices = np.arange(len(all_qubits))
    is_subset = np.isin(all_qubits, marginal_subset)
    subset_indices = np.compress(is_subset, all_indices)
    assert len(subset_indices) == len(marginal_subset)

    n = len(all_qubits)
    reshaped = np.asarray(confusion_matrix).reshape([2] * (2 * n))
    axes_labels = np.arange(2 * n, dtype=int)
    keep_axes = np.concatenate([subset_indices, n + subset_indices])
    marginal = np.einsum(reshaped, [int(i) for i in axes_labels],
                         [int(i) for i in keep_axes])
    renorm = 2 ** (n - len(marginal_subset))
    dim = 2 ** len(marginal_subset)
    return marginal.reshape(dim, dim) / renorm


def estimate_joint_reset_confusion(qc, qubits: Sequence[int] = None,
                                   num_trials: int = 10,
                                   joint_group_size: int = 1,
                                   use_active_reset: bool = True,
                                   show_progress_bar: bool = False) \
        -> Dict[Tuple[int, ...], np.ndarray]:
    """Reset 'confusion matrix': prepare each bitstring, reset, and measure.

    Mirrors the reference's trial structure (prep with up to 10 retries, then
    reset and measure). The in-process QVM's reset is ideal, so with a perfect
    simulator every row concentrates on column 0; noise models (readout
    confusion on the prep measurement) still exercise the retry logic.
    """
    if qubits is None:
        raise ValueError("Specify the qubits to characterize.")
    qubits = sorted(qubits)
    groups = list(itertools.combinations(qubits, joint_group_size))
    confusion_matrices = {}
    dim = 2 ** joint_group_size
    for group in progress_iter(groups, show_progress_bar,
                               desc="reset confusion groups"):
        matrix = np.zeros((dim, dim))
        for row, bitstring in enumerate(itertools.product([0, 1],
                                                          repeat=joint_group_size)):
            for _ in range(num_trials):
                # try preparation at most 10 times
                for _ in range(10):
                    prep = parameterized_bitstring_prep(group, bitstring)
                    result = qc.run(prep, list(group), 1)
                    if np.array_equal(result[0], list(bitstring)):
                        break
                # reset: a fresh program on the simulator starts from |0...0>
                results = qc.run(Circuit(), list(group), 1)
                observed = bit_arrays_to_ints(results)
                matrix[row] += np.bincount(observed, minlength=dim) / num_trials
        confusion_matrices[group] = matrix
    return confusion_matrices
