"""Robust phase estimation (RPE) of rotation angles [RPE][RPE2].

Port of ``forest_benchmarking_tpu/robust_phase_estimation.py``, with its
public names: the change-of-basis helpers (the unitary embedded as a
custom-matrix gate the simulator runs as it is), the eigenvector prep and
measurement settings, one grouped experiment per depth 2^j, the
Heisenberg-scaling shot schedule (eqs. V.11 and V.17), acquisition on
``qc``'s device, the iterative arctan phase estimate with its
decoherence warning, multi-qubit post-selection and :func:`do_rpe`. The
analysis is host numpy; :func:`plot_rpe_iterations` imports ``matplotlib``
inside the function.
"""
from __future__ import annotations

import itertools
import warnings
from functools import reduce
from operator import mul
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
from numpy import pi

from forest_benchmarking_tpu_torch.circuits import (
    Circuit, Gate, merge_circuits)
from forest_benchmarking_tpu_torch.paulis import PauliTerm
from forest_benchmarking_tpu_torch.utils import (
    bloch_vector_to_standard_basis, is_pos_pow_two, progress_iter)
from forest_benchmarking_tpu_torch.observable_estimation import (
    ExperimentSetting, ExperimentResult, ObservablesExperiment, _OneQState,
    TensorProductState, plusX, plusZ, minusZ, estimate_observables,
    calibrate_observable_estimates, group_settings,
    get_results_by_qubit_groups)

__all__ = [
    "bloch_rotation_to_eigenvectors", "get_change_of_basis_from_eigvecs",
    "change_of_basis_matrix_to_circuit", "all_eigenvector_prep_meas_settings",
    "pick_two_eigenvecs_prep_meas_settings", "generate_rpe_experiments",
    "get_additive_error_factor", "num_trials", "acquire_rpe_data",
    "get_variance_upper_bound", "estimate_phase_from_moments",
    "robust_phase_estimate", "plot_rpe_iterations", "do_rpe",
]


def bloch_rotation_to_eigenvectors(theta: float, phi: float) -> Sequence[np.ndarray]:
    """Eigenvectors (along the rotation axis) of a 1q rotation about the Bloch
    vector (theta, phi), ordered by the right-hand rule convention."""
    eig1 = np.array([bloch_vector_to_standard_basis(theta, phi)]).T
    eig2 = np.array([bloch_vector_to_standard_basis(pi - theta, pi + phi)]).T
    return eig1, eig2


def get_change_of_basis_from_eigvecs(eigenvectors: Sequence[np.ndarray]) -> np.ndarray:
    """Unitary sending each computational basis state to the given eigenvector."""
    assert len(eigenvectors) > 1 and is_pos_pow_two(len(eigenvectors)), \
        "Specification of all dim-many eigenvectors is required."
    # U = sum_k |e_k><k| is simply the matrix whose k-th COLUMN is e_k
    # (inputs may be 1d vectors or row/column 2d vectors).
    return np.column_stack([np.asarray(e).reshape(-1) for e in eigenvectors])


def change_of_basis_matrix_to_circuit(qubits: Sequence[int],
                                      change_of_basis: np.ndarray) -> Circuit:
    """Circuit implementing the change-of-basis unitary on the qubits.

    The unitary is embedded as a custom-matrix gate the simulator executes
    natively (the reference instead compiles through quilc, :82-108).
    """
    mat = np.asarray(change_of_basis, dtype=complex)
    return Circuit([Gate("COB", (), tuple(qubits),
                         matrix=tuple(map(tuple, mat)))])


def all_eigenvector_prep_meas_settings(qubits: Sequence[int],
                                       change_of_basis: Circuit):
    """Prep/pre-measure circuits + settings probing all relative phases."""
    prep_prog = Circuit() + change_of_basis
    pre_meas_prog = (Circuit() + change_of_basis).dagger()
    init_state = reduce(mul, [plusX(q) for q in qubits], TensorProductState())

    settings = []
    for xy_q in qubits:
        z_qubits = [q for q in qubits if q != xy_q]
        xy_terms = [PauliTerm([(xy_q, "X")]), PauliTerm([(xy_q, "Y")])]
        iz_terms = [PauliTerm(())]
        iz_terms += [PauliTerm([(q, "Z")]) for q in z_qubits]
        settings += [ExperimentSetting(init_state, xy_term * term)
                     for xy_term in xy_terms for term in iz_terms]
    return prep_prog, pre_meas_prog, settings


def pick_two_eigenvecs_prep_meas_settings(fix_qubit: Tuple[int, int],
                                          rotate_qubit: int,
                                          change_of_basis: Optional[Circuit] = None):
    """Probe the single relative phase between two chosen eigenvectors."""
    prep_prog = Circuit()
    if change_of_basis is not None:
        prep_prog += change_of_basis
    if fix_qubit[1] == 1:
        fixed_q_state = minusZ(fix_qubit[0])
    else:
        fixed_q_state = plusZ(fix_qubit[0])
    init_state = fixed_q_state * plusX(rotate_qubit)
    fixed_q_ops = [PauliTerm(()), PauliTerm([(fix_qubit[0], "Z")])]
    rot_q_ops = [PauliTerm([(rotate_qubit, "X")]), PauliTerm([(rotate_qubit, "Y")])]
    settings = [ExperimentSetting(init_state, t1 * t2)
                for t1 in fixed_q_ops for t2 in rot_q_ops]
    return prep_prog, prep_prog.dagger(), settings


def generate_rpe_experiments(rotation: Circuit, prep_prog: Circuit,
                             pre_meas_prog: Circuit,
                             settings: Sequence[ExperimentSetting],
                             num_depths: int = 6) -> List[ObservablesExperiment]:
    """One grouped experiment per depth 2^j, j < num_depths [RPE]."""
    expts = []
    for exponent in range(num_depths):
        depth = 2 ** exponent
        program = prep_prog + merge_circuits([rotation] * depth) + pre_meas_prog
        expts.append(group_settings(ObservablesExperiment(list(settings),
                                                          program)))
    return expts


def get_additive_error_factor(m_j: float, max_additive_error: float) -> float:
    """Shot multiplier preserving Heisenberg scaling under additive errors
    (eq. V.17 of [RPE]; valid for max_additive_error < 1/sqrt(8))."""
    return np.log(.5 * (1 - np.sqrt(8) * max_additive_error) ** (1 / m_j)) \
        / np.log(1 - .5 * (1 - np.sqrt(8) * max_additive_error) ** 2)


def num_trials(depth, max_depth, multiplicative_factor: float = 1.0,
               additive_error: Optional[float] = None, alpha: float = 5 / 2,
               beta: float = 1 / 2) -> int:
    """Optimal shots for the depth-2^(j-1) iteration (eqs. V.11, V.17 [RPE])."""
    j = np.log2(depth) + 1
    k = np.log2(max_depth) + 1
    m_j = alpha * (k - j) + beta
    if additive_error:
        multiplicative_factor *= get_additive_error_factor(m_j, additive_error)
    return int(np.ceil(m_j * multiplicative_factor))


def acquire_rpe_data(qc, experiments: Sequence[ObservablesExperiment],
                     multiplicative_factor: float = 1.0,
                     additive_error: Optional[float] = None,
                     min_shots: int = 500, active_reset: bool = False,
                     mitigate_readout_errors: bool = False,
                     show_progress_bar: bool = False) \
        -> List[List[ExperimentResult]]:
    """Run each depth with its Heisenberg-schedule shot count (>= min_shots)."""
    depths = [2 ** idx for idx in range(len(experiments))]
    max_depth = max(depths)
    results = []
    for depth, expt in progress_iter(list(zip(depths, experiments)),
                                     show_progress_bar, desc="acquire_rpe_data"):
        theoretical_optimum = num_trials(depth, max_depth,
                                         multiplicative_factor, additive_error)
        num_shots = max(min_shots, theoretical_optimum)
        if mitigate_readout_errors:
            res = list(estimate_observables(qc, expt, num_shots=num_shots,
                                            active_reset=active_reset,
                                            symm_type=-1))
            results.append(list(calibrate_observable_estimates(
                qc, res, num_shots=num_shots)))
        else:
            results.append(list(estimate_observables(
                qc, expt, num_shots=num_shots, active_reset=active_reset)))
    return results


# --------------------------------- analysis ---------------------------------

def _p_max(m_j: int) -> float:
    """Upper bound on per-iteration estimate error probability (eq. V.6)."""
    return (1 / np.sqrt(2 * pi * m_j)) * (2 ** -m_j)


def _xci(h: int) -> float:
    """Max error after h error-free iterations (eq. V.7)."""
    return 2 * pi / (2 ** h)


def get_variance_upper_bound(num_depths: int, multiplicative_factor: float = 1.0,
                             additive_error: Optional[float] = None) -> float:
    """Variance upper bound for the phase estimate (eq. V.9 of [RPE])."""
    depths = [2 ** idx for idx in range(num_depths)]
    max_depth = max(depths)
    k = int(np.log2(max_depth)) + 1
    m_js = [num_trials(d, max_depth, multiplicative_factor, additive_error)
            for d in depths]
    return (1 - _p_max(m_js[k - 1])) * _xci(k + 1) ** 2 + sum(
        _xci(i + 1) ** 2 * _p_max(m_j) for i, m_j in enumerate(m_js))


def estimate_phase_from_moments(xs: List, ys: List, x_stds: List, y_stds: List,
                                bloch_data: Optional[List] = None) -> float:
    """Iterative arctan range-narrowing phase estimate (section V of [RPE];
    reference robust_phase_estimation.py:361-405).

    Iteration j measures the Bloch angle of the depth-2^j rotation, which
    determines the phase modulo 2π/2^j; the running estimate selects the
    unique representative inside the half-open window of width 2π/2^j
    centered on the previous estimate. Stops early (with a warning) once the
    measured Bloch-vector radius drops below its own standard error — past
    that depth decoherence has scrambled the signal and deeper iterations
    carry no phase information.
    """
    estimate = 0.0
    for depth, x, y, x_std, y_std in zip(
            (2 ** j for j in itertools.count()), xs, ys, x_stds, y_stds):
        radius = np.hypot(x, y)
        if radius < np.hypot(x_std, y_std):
            warnings.warn(
                f"RPE stopped at depth {depth // 2}: the Bloch-vector radius "
                f"fell below its standard error, so the phase (current "
                f"estimate {estimate % (2 * pi):.3f}) is decoherence-limited "
                f"at greater depths. Raising additive_error or "
                f"multiplicative_factor buys more shots per depth.")
            break
        # angle of the depth-fold rotation, i.e. the phase modulo 2*pi/depth
        measured = np.arctan2(y, x) / depth
        half_window = pi / depth
        # representative of `measured` (mod 2*half_window) inside
        # [estimate - half_window, estimate + half_window)
        estimate += (measured - estimate + half_window) % (2 * half_window) \
            - half_window
        if bloch_data is not None:
            bloch_data.append((radius, estimate * depth))
    return estimate % (2 * pi)


def robust_phase_estimate(results: List[List[ExperimentResult]],
                          qubits: Sequence[int]) -> Union[float, Sequence[float]]:
    """Phase estimate(s) from RPE results; handles multi-qubit post-selection.

    For multiple qubits, returns up to 2**(len(qubits) - 1) relative phases,
    formed by post-selecting the spectator qubit(s) on |0> or |1> via sums and
    differences of I/Z-augmented expectations (reference :436-521).
    """
    if len(qubits) == 1:
        q = qubits[0]
        x_results = [res for depth in results for res in depth
                     if res.setting.observable[q] == "X"]
        y_results = [res for depth in results for res in depth
                     if res.setting.observable[q] == "Y"]
        return estimate_phase_from_moments(
            [r.expectation for r in x_results],
            [r.expectation for r in y_results],
            [r.std_err for r in x_results],
            [r.std_err for r in y_results])

    relative_phases = []
    for xy_q in qubits:
        expectations = []
        z_qubits = [q for q in qubits if q != xy_q]
        for label in ["X", "Y"]:
            results_by_z_qubit = {q: [] for q in z_qubits}
            i_results = []
            for depth in results:
                ress = [res for res in depth
                        if res.setting.observable[xy_q] == label]
                if len(ress) == 0:
                    break
                for res in ress:
                    for z_q in z_qubits:
                        if res.setting.observable[z_q] == "Z":
                            results_by_z_qubit[z_q].append(res)
                            break
                    else:
                        i_results.append(res)
            if len(i_results) == 0:
                break

            # every moment series for this label, kept as (exp, err) pairs so
            # the value and its uncertainty travel together
            label_series = []
            if max(len(ress) for ress in results_by_z_qubit.values()) == 0:
                label_series.append([(r.expectation, r.std_err)
                                     for r in i_results])
            else:
                for q, ress in results_by_z_qubit.items():
                    try:
                        in_state = i_results[0].setting.in_state[q]
                    except IndexError:
                        in_state = None
                    for post_state, sign in ((0, +1.0), (1, -1.0)):
                        if in_state == _OneQState("Z", 1 - post_state, q):
                            continue
                        label_series.append([
                            (i_res.expectation + sign * res.expectation,
                             np.sqrt(res.std_err ** 2 + i_res.std_err ** 2))
                            for res, i_res in zip(ress, i_results)])
            expectations.append(label_series)

        if len(expectations) != 2:
            # X or Y moment series missing for this qubit (truncated or
            # filtered results) -> no phase estimate is possible. The
            # reference unpacks unconditionally and crashes with an opaque
            # ValueError on the same input (:512-516); skipping is the
            # documented deviation.
            continue
        x_series, y_series = expectations
        for xp, yp in zip(x_series, y_series):
            x_exp, x_err = (list(t) for t in zip(*xp))
            y_exp, y_err = (list(t) for t in zip(*yp))
            relative_phases.append(
                estimate_phase_from_moments(x_exp, y_exp, x_err, y_err))
    return relative_phases


def plot_rpe_iterations(xs, ys, x_stds, y_stds,
                        expected_positions: Optional[List] = None):
    """Polar plot of the per-iteration state position (reference :529)."""
    import matplotlib.pyplot as plt
    positions = []
    estimate_phase_from_moments(xs, ys, x_stds, y_stds, positions)
    rs = [pos[0] for pos in positions]
    angles = [pos[1] for pos in positions]
    ax = plt.subplot(111, projection="polar")
    ax.scatter(angles, rs)
    for j, (radius, angle) in enumerate(positions):
        ax.annotate("Ob" + str(j), (angle, radius), color="blue")
    if expected_positions:
        expected_rs = [pos[0] for pos in expected_positions]
        expected_angles = [pos[1] for pos in expected_positions]
        ax.scatter(expected_angles, expected_rs)
        for j, (radius, angle) in enumerate(expected_positions):
            ax.annotate("Ex" + str(j), (angle, radius), color="orange")
        ax.set_title("RPE Iterations Observed(O) and Expected(E)", va="bottom")
    else:
        ax.set_title("Observed Position per RPE Iteration")
    ax.set_rmax(1.5)
    ax.set_rticks([0.5, 1, 1.5])
    ax.set_rlabel_position(-22.5)
    ax.grid(True)
    return ax


def do_rpe(qc, rotation: Circuit, changes_of_basis: List[Circuit],
           qubit_groups: Sequence[Sequence[int]], num_depths: int = 6,
           multiplicative_factor: float = 1.0,
           additive_error: Optional[float] = None, active_reset: bool = False,
           mitigate_readout_errors: bool = False,
           show_progress_bar: bool = False) \
        -> Tuple[Dict[Tuple[int, ...], Union[float, Sequence[float]]],
                 List[ObservablesExperiment], List[List[ExperimentResult]]]:
    """Generate, acquire, and estimate RPE end-to-end over qubit groups."""
    prep_prog_tot = Circuit()
    pre_meas_prog_tot = Circuit()
    all_settings = []
    for qubits, cob in zip(qubit_groups, changes_of_basis):
        prep_prog, pre_meas_prog, settings = \
            all_eigenvector_prep_meas_settings(qubits, cob)
        prep_prog_tot += prep_prog
        pre_meas_prog_tot += pre_meas_prog
        all_settings += settings

    expts = generate_rpe_experiments(rotation, prep_prog_tot,
                                     pre_meas_prog_tot, all_settings,
                                     num_depths)
    results = acquire_rpe_data(qc, expts,
                               multiplicative_factor=multiplicative_factor,
                               additive_error=additive_error,
                               active_reset=active_reset,
                               mitigate_readout_errors=mitigate_readout_errors,
                               show_progress_bar=show_progress_bar)
    results_by_group = [get_results_by_qubit_groups(depth_results, qubit_groups)
                        for depth_results in results]
    estimates = {}
    for qubits in qubit_groups:
        group_results = [res[tuple(qubits)] for res in results_by_group]
        estimates[tuple(qubits)] = robust_phase_estimate(group_results, qubits)
    return estimates, expts, results
