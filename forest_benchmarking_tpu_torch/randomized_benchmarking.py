"""Randomized benchmarking: standard, interleaved, unitarity, simultaneous.

Port of ``forest_benchmarking_tpu/randomized_benchmarking.py``, with its
public names. Clifford sequences come from the port's tableau engine
(:mod:`.clifford`), drawn from an explicit numpy ``RandomState``, so a
seed gives the JAX package's sequences gate for gate. The experiments run
on ``qc`` (the port's QVM, on its device); the survival statistics, the
purity estimates and the interleaved-RB algebra are host numpy; the RB and
unitarity decay fits run on the batched fitter of :mod:`.analysis.fitting`.
:func:`sequences_to_ptm_stack` builds a (sequences, length, d^2, d^2) PTM
stack on the host for :func:`simulate_rb_survival_batched`, the batched
PTM-composition survival simulator.

The fits and the simulator take numpy arrays or lists and run on the card
unless called with ``device="cpu"``; the simulator takes tensors where they
lie. :func:`do_rb` fits on ``qc.device``.
"""
from __future__ import annotations

from math import pi
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from forest_benchmarking_tpu_torch.analysis.fitting import (
    FitResult, errs_to_weights, fit_base_param_decay)
from forest_benchmarking_tpu_torch.circuits import (
    Circuit, Gate, RX, RZ, CZ, merge_circuits)
from forest_benchmarking_tpu_torch.clifford import (
    generate_rb_sequence as _clifford_rb_sequence)
from forest_benchmarking_tpu_torch.observable_estimation import (
    ExperimentSetting, ExperimentResult, ObservablesExperiment, zeros_state,
    estimate_observables, group_settings, get_results_by_qubit_groups)
from forest_benchmarking_tpu_torch.ops.lanes_apg import full_f32_matmul
from forest_benchmarking_tpu_torch.ops.superoperator_transformations import (
    _p2c_np)
from forest_benchmarking_tpu_torch.paulis import all_traceless_pauli_z_terms
from forest_benchmarking_tpu_torch.tomography import _state_tomo_settings
from forest_benchmarking_tpu_torch.utils import (
    entry_device, is_pos_pow_two, pauli_label_strings, progress_iter)

__all__ = [
    "get_stats_by_qubit_group", "oneq_rb_gateset", "twoq_rb_gateset",
    "get_rb_gateset", "merge_sequences", "generate_rb_sequence",
    "generate_rb_experiment_sequences",
    "group_sequences_into_parallel_experiments", "generate_rb_experiments",
    "acquire_rb_data", "covariances_of_all_iz_obs",
    "z_obs_stats_to_survival_statistics", "fit_rb_results",
    "generate_unitarity_experiments", "estimate_purity",
    "estimate_purity_err", "fit_unitarity_results", "unitarity_to_rb_decay",
    "do_rb", "coherence_angle", "gamma", "interleaved_gate_fidelity_bounds",
    "gate_error_to_irb_decay", "irb_decay_to_gate_error",
    "average_gate_error_to_rb_decay", "rb_decay_to_gate_error",
    "unitary_to_ptm_np", "circuit_unitary_np", "sequences_to_ptm_stack",
    "simulate_rb_survival_batched",
]


def get_stats_by_qubit_group(qubit_groups: Sequence[Sequence[int]],
                             expt_results: Iterable[Iterable[ExperimentResult]]) \
        -> Dict[Tuple[int, ...], Dict[str, List[List[float]]]]:
    """Collect per-sequence expectation and std_err lists for each qubit
    group (keyed by the caller's tuple, whose order is significant)."""
    qubits = [tuple(group) for group in qubit_groups]
    stats = {group: {"expectation": [], "std_err": []} for group in qubits}
    for results in expt_results:
        by_group = get_results_by_qubit_groups(results, qubits)
        for group in qubits:
            res_list = by_group[tuple(sorted(group))]
            stats[group]["expectation"].append(
                [res.expectation for res in res_list])
            stats[group]["std_err"].append(
                [res.std_err for res in res_list])
    return stats


def oneq_rb_gateset(qubit: int) -> Iterable[Gate]:
    """The native one-qubit RB gateset: RX and RZ at +-pi, +-pi/2."""
    for angle in [-pi, -pi / 2, pi / 2, pi]:
        for gate in [RX, RZ]:
            yield gate(angle, qubit)


def twoq_rb_gateset(q1: int, q2: int) -> Iterable[Gate]:
    """Two one-qubit gatesets plus CZ."""
    yield from oneq_rb_gateset(q1)
    yield from oneq_rb_gateset(q2)
    yield CZ(q1, q2)


def get_rb_gateset(qubits: Sequence[int]) -> List[Gate]:
    if len(qubits) == 1:
        return list(oneq_rb_gateset(qubits[0]))
    if len(qubits) == 2:
        return list(twoq_rb_gateset(*qubits))
    raise ValueError("No RB gateset for more than two qubits.")


def merge_sequences(sequences: List[List[Circuit]]) -> List[Circuit]:
    """Element-wise merge of equal-length sequences of circuits."""
    depth = len(sequences[0])
    assert all(len(s) == depth for s in sequences)
    return [merge_circuits([seq[idx] for seq in sequences])
            for idx in range(depth)]


def generate_rb_sequence(qubits: Sequence[int], depth: int,
                         interleaved_gate: Optional[Circuit] = None,
                         random_seed: Optional[int] = None) -> List[Circuit]:
    """A self-inverting sequence of ``depth`` Cliffords in native gates,
    from the tableau engine (the reference asks quilc's benchmarker)."""
    rng = np.random.RandomState(random_seed) if random_seed is not None \
        else None
    return _clifford_rb_sequence(qubits, depth, interleaved_gate, rng=rng,
                                 use_basic_compile=True)


def generate_rb_experiment_sequences(qubits: Sequence[int],
                                     depths: Sequence[int],
                                     interleaved_gate: Optional[Circuit] = None,
                                     random_seed: Optional[int] = None,
                                     use_self_inv_seqs: bool = True) \
        -> List[List[Circuit]]:
    """One Clifford sequence per depth for a single qubit group; a given
    seed is raised by one before each depth."""
    sequences = []
    for depth in depths:
        if random_seed is not None:
            random_seed += 1
        if use_self_inv_seqs:
            sequence = generate_rb_sequence(qubits, depth, interleaved_gate,
                                            random_seed)
        else:
            # one deeper, then strip the inverse (unitarity experiments)
            sequence = generate_rb_sequence(qubits, depth + 1,
                                            random_seed=random_seed)[:-1]
        sequences.append(sequence)
    return sequences


def group_sequences_into_parallel_experiments(
        parallel_expts_seqs: Sequence[List[List[Circuit]]],
        qubit_groups: Sequence[Sequence[int]],
        is_unitarity_expt: bool = False) -> List[ObservablesExperiment]:
    """Merge per-group sequences into 'parallel RB' ObservablesExperiments.

    Parallel is not simultaneous: decays measured in parallel include
    crosstalk and need not match isolated decays.
    """
    expts = []
    for parallel_sequence_group in zip(*parallel_expts_seqs):
        program = merge_circuits(merge_sequences(list(parallel_sequence_group)))
        if is_unitarity_expt:
            settings = [sett for group in qubit_groups
                        for sett in _state_tomo_settings(group)]
            expt = group_settings(ObservablesExperiment(settings, program))
        else:
            settings = [ExperimentSetting(zeros_state(group), op)
                        for group in qubit_groups
                        for op in all_traceless_pauli_z_terms(group)]
            expt = ObservablesExperiment([settings], program)
        expts.append(expt)
    return expts


def generate_rb_experiments(qubit_groups: Sequence[Sequence[int]],
                            depths: Sequence[int],
                            interleaved_gate: Optional[Circuit] = None,
                            random_seed: Optional[int] = None) \
        -> List[ObservablesExperiment]:
    """Simultaneous RB (or IRB [IRB]) experiments over disjoint qubit
    groups [RB]."""
    parallel_sequences = []
    for group in qubit_groups:
        if random_seed is not None:
            random_seed += len(depths)
        parallel_sequences.append(generate_rb_experiment_sequences(
            group, depths, interleaved_gate, random_seed))
    return group_sequences_into_parallel_experiments(parallel_sequences,
                                                     qubit_groups)


def acquire_rb_data(qc, experiments: Iterable[ObservablesExperiment],
                    num_shots: int = 500, active_reset: bool = False,
                    show_progress_bar: bool = False) \
        -> List[List[ExperimentResult]]:
    """Run each experiment on ``qc``; one list of results per experiment."""
    results = []
    for expt in progress_iter(list(experiments), show_progress_bar,
                              desc="acquire_rb_data"):
        results.append(list(estimate_observables(qc, expt, num_shots,
                                                 active_reset=active_reset)))
    return results


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



def generate_unitarity_experiments(qubit_groups: Sequence[Sequence[int]],
                                   depths: Sequence[int],
                                   random_seed: Optional[int] = None,
                                   use_self_inv_seqs: bool = False) \
        -> List[ObservablesExperiment]:
    """Simultaneous unitarity experiments [ECN] (sequences that do not
    invert themselves, measured by state tomography)."""
    parallel_sequences = []
    for group in qubit_groups:
        if random_seed is not None:
            random_seed += len(depths)
        parallel_sequences.append(generate_rb_experiment_sequences(
            group, depths, random_seed=random_seed,
            use_self_inv_seqs=use_self_inv_seqs))
    return group_sequences_into_parallel_experiments(parallel_sequences,
                                                     qubit_groups,
                                                     is_unitarity_expt=True)


def do_rb(qc, qubit_groups: Sequence[Sequence[int]], depths: Sequence[int],
          interleaved_gate: Optional[Circuit] = None,
          is_unitarity_expt: bool = False, num_shots: int = 1_000,
          active_reset: bool = False, show_progress_bar: bool = False,
          random_seed: Optional[int] = None) \
        -> Tuple[Dict[Tuple[int, ...], float], List[ObservablesExperiment],
                 List[List[ExperimentResult]]]:
    """Generate, acquire and fit a (simultaneous) RB, IRB or unitarity
    experiment; the circuits run and the decays are fitted on
    ``qc.device``."""
    if is_unitarity_expt:
        expts = generate_unitarity_experiments(qubit_groups, depths,
                                               random_seed=random_seed)
    else:
        expts = generate_rb_experiments(qubit_groups, depths,
                                        interleaved_gate=interleaved_gate,
                                        random_seed=random_seed)
    results = acquire_rb_data(qc, expts, num_shots, active_reset=active_reset,
                              show_progress_bar=show_progress_bar)
    stats_by_group = get_stats_by_qubit_group(qubit_groups, results)
    decays = {}
    for group, stats in stats_by_group.items():
        if is_unitarity_expt:
            fit = fit_unitarity_results(depths, stats["expectation"],
                                        stats["std_err"], device=qc.device)
        else:
            fit = fit_rb_results(depths, stats["expectation"],
                                 stats["std_err"], num_shots,
                                 device=qc.device)
        decays[group] = fit.params["decay"].value
    return decays, expts, results

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


# ----------------------- batched PTM-composition RB -------------------------

def unitary_to_ptm_np(u: np.ndarray) -> np.ndarray:
    """Pauli transfer matrix of a unitary, in numpy (host side)."""
    d = u.shape[0]
    p2c = _p2c_np(d)
    c2p = p2c.conj().T / d
    superop = np.kron(u.conj(), u)
    return np.real(c2p @ superop @ c2p.conj().T * d)



def circuit_unitary_np(circuit: Circuit, qubits: Sequence[int]) -> np.ndarray:
    """Dense unitary of a circuit, in numpy (host side)."""
    n = len(qubits)
    pos = {q: i for i, q in enumerate(qubits)}
    d = 2 ** n
    u = np.eye(d, dtype=complex)
    for gate in circuit.gates:
        g = gate.get_matrix()
        # lift with a kron and an axis permutation
        k = len(gate.qubits)
        axes = [pos[q] for q in gate.qubits]
        rest = [i for i in range(n) if i not in axes]
        perm = list(axes) + rest
        full = np.kron(g, np.eye(2 ** (n - k), dtype=complex))
        t = full.reshape((2,) * (2 * n))
        inv = np.argsort(perm)
        t = np.transpose(t, list(inv) + [n + i for i in inv])
        u = t.reshape(d, d) @ u
    return u


def sequences_to_ptm_stack(sequences: List[List[Circuit]],
                           qubits: Sequence[int]) \
        -> Tuple[np.ndarray, np.ndarray]:
    """(ptms, lengths): the padded PTM stack (n_seq, max_len, d^2, d^2)
    float64 and the (n_seq,) true sequence lengths, on the host.

    Shorter sequences are padded with identity PTMs, so that the whole
    experiment is one rectangular array for the batched simulator.
    """
    d2 = 4 ** len(qubits)
    max_len = max(len(seq) for seq in sequences)
    out = np.tile(np.eye(d2, dtype=np.float64),
                  (len(sequences), max_len, 1, 1))
    lengths = np.array([len(seq) for seq in sequences])
    for i, seq in enumerate(sequences):
        for j, circ in enumerate(seq):
            out[i, j] = unitary_to_ptm_np(circuit_unitary_np(circ, qubits))
    return out, lengths

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
