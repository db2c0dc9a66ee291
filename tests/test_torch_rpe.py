"""The port's robust phase estimation on its QVM.

Mirrors tests/test_robust_phase_estimation.py on ``QVM(device="cpu")`` at
the JAX suite's bars (angles within 0.05 rad, ``do_rpe`` and the readout-
mitigated run within 0.1). The JAX suite marks its two-qubit CZ test slow;
the port's runs here, at the JAX test's size and bar (0.1 rad), in about a
second. Against the JAX package on the same inputs: the prep, pre-measure
and settings of both helpers, the grouped experiments of every depth, the
shot schedule and variance bound, ``estimate_phase_from_moments`` and
``robust_phase_estimate`` (one and two qubits) of the same results within
1e-12, and the QVM's probabilities for the programs within 1e-12 of the
JAX package's float64 simulator.
"""
import warnings

import numpy as np
import pytest
import torch

import forest_benchmarking_tpu.robust_phase_estimation as jrpe
from forest_benchmarking_tpu_torch.circuits import Circuit, RZ, RX, CZ
from forest_benchmarking_tpu_torch.robust_phase_estimation import (
    bloch_rotation_to_eigenvectors, get_change_of_basis_from_eigvecs,
    change_of_basis_matrix_to_circuit, all_eigenvector_prep_meas_settings,
    pick_two_eigenvecs_prep_meas_settings, generate_rpe_experiments,
    num_trials, get_additive_error_factor, acquire_rpe_data,
    get_variance_upper_bound, estimate_phase_from_moments,
    robust_phase_estimate, plot_rpe_iterations, do_rpe)
from forest_benchmarking_tpu_torch.sim import QVM
from torch_protocols import (
    PROB_BAR, experiment_probability_gap, experiment_signature, jax_results,
    same_gates, to_jax_circuit)

torch.set_num_threads(1)


def qvm(seed):
    return QVM(seed=seed, device="cpu")


def run_1q_rpe(rotation, angle_qubit, num_depths=6, seed=1, cob=None):
    if cob is None:
        cob = Circuit()
    prep, pre_meas, settings = all_eigenvector_prep_meas_settings(
        [angle_qubit], cob)
    expts = generate_rpe_experiments(rotation, prep, pre_meas, settings,
                                     num_depths=num_depths)
    results = acquire_rpe_data(qvm(seed), expts, multiplicative_factor=10.0)
    return robust_phase_estimate(results, [angle_qubit])


class NoisyQVM(QVM):
    """The port's QVM with a readout confusion on qubit 0 (the JAX suite's
    subclass pattern)."""

    def run(self, circuit, qubits, num_shots):
        noisy = circuit.copy()
        noisy.define_noisy_readout(0, p00=0.92, p11=0.9)
        return super().run(noisy, qubits, num_shots)


# --- tests/test_robust_phase_estimation.py on the port -----------------------

def test_rpe_rz_angle():
    for angle in (0.3, 1.1, 2.5):
        est = run_1q_rpe(Circuit([RZ(angle, 0)]), 0, seed=int(angle * 10))
        assert abs(est - angle) < 0.05, (angle, est)


def test_rpe_rz_negative_angle():
    angle = -0.7
    est = run_1q_rpe(Circuit([RZ(angle, 0)]), 0, seed=3)
    assert abs(est - (angle % (2 * np.pi))) < 0.05


def test_rpe_rx_with_change_of_basis():
    angle = 0.9
    evecs = bloch_rotation_to_eigenvectors(np.pi / 2, 0)
    cob = change_of_basis_matrix_to_circuit(
        [0], get_change_of_basis_from_eigvecs(evecs))
    est = run_1q_rpe(Circuit([RX(angle, 0)]), 0, seed=4, cob=cob)
    assert abs(est - angle) < 0.05


def test_rpe_estimate_within_variance_bound():
    angle = 1.5
    num_depths = 6
    est = run_1q_rpe(Circuit([RZ(angle, 0)]), 0, num_depths=num_depths,
                     seed=5)
    bound = np.sqrt(get_variance_upper_bound(num_depths,
                                             multiplicative_factor=10.0))
    assert abs(est - angle) < max(5 * bound, 0.05)


def test_cob_matrix_properties():
    u = get_change_of_basis_from_eigvecs(
        bloch_rotation_to_eigenvectors(np.pi / 2, 0))
    assert np.allclose(u @ u.conj().T, np.eye(2), atol=1e-12)
    plus = np.array([1, 1]) / np.sqrt(2)
    assert np.allclose(np.abs(u @ np.array([1, 0])), np.abs(plus),
                       atol=1e-12)


def test_num_trials_schedule():
    max_depth = 2 ** 5
    trials = [num_trials(2 ** j, max_depth) for j in range(6)]
    assert all(a >= b for a, b in zip(trials, trials[1:]))
    assert trials[-1] >= 1
    assert num_trials(2, max_depth, additive_error=0.1) >= num_trials(
        2, max_depth)


def test_additive_error_factor_positive():
    assert get_additive_error_factor(10, 0.1) > 0


def test_estimate_phase_from_moments_exact():
    phi = 0.713
    depths = [2 ** j for j in range(7)]
    stds = [0.001] * len(depths)
    est = estimate_phase_from_moments([np.cos(d * phi) for d in depths],
                                      [np.sin(d * phi) for d in depths],
                                      stds, stds)
    assert abs(est - phi) < 1e-3


def test_decoherence_limited_warning():
    with pytest.warns(UserWarning):
        est = estimate_phase_from_moments([0.9, 0.001], [0.1, 0.001],
                                          [0.01, 0.01], [0.01, 0.01])
    assert est >= 0


def test_do_rpe_wrapper():
    angle = 0.8
    estimates, expts, results = do_rpe(qvm(6), Circuit([RZ(angle, 0)]),
                                       [Circuit()], [(0,)], num_depths=5,
                                       multiplicative_factor=10.0)
    assert abs(estimates[(0,)] - angle) < 0.1


@pytest.fixture(scope="module")
def cz_run():
    """The JAX suite's two-qubit CZ run (its slow test) on the port."""
    prep, pre_meas, settings = all_eigenvector_prep_meas_settings(
        [0, 1], Circuit())
    expts = generate_rpe_experiments(Circuit([CZ(0, 1)]), prep, pre_meas,
                                     settings, num_depths=4)
    return expts, acquire_rpe_data(qvm(7), expts, multiplicative_factor=20.0)


def test_2q_rpe_cz_phases(cz_run):
    # CZ: the phase on one qubit is 0 with the other in |0>, pi in |1>
    phases = robust_phase_estimate(cz_run[1], [0, 1])
    assert len(phases) == 4

    def circ_dist(p, e):
        d = abs((p - e) % (2 * np.pi))
        return min(d, 2 * np.pi - d)

    assert sum(circ_dist(p, 0.0) < 0.1 for p in phases) == 2, phases
    assert sum(circ_dist(p, np.pi) < 0.1 for p in phases) == 2, phases


def test_pick_two_eigenvecs_settings():
    prep, pre_meas, settings = pick_two_eigenvecs_prep_meas_settings((0, 0),
                                                                     1)
    assert len(settings) == 4
    assert len({str(s.observable) for s in settings}) == 4


def test_rpe_with_readout_mitigation():
    angle = 1.3
    prep, pre_meas, settings = all_eigenvector_prep_meas_settings([0],
                                                                  Circuit())
    expts = generate_rpe_experiments(Circuit([RZ(angle, 0)]), prep,
                                     pre_meas, settings, num_depths=5)
    results = acquire_rpe_data(NoisyQVM(seed=8, device="cpu"), expts,
                               multiplicative_factor=20.0,
                               mitigate_readout_errors=True)
    assert abs(robust_phase_estimate(results, [0]) - angle) < 0.1


def test_plot_rpe_iterations_draws_the_iterations():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    phi = 0.5
    depths = [2 ** j for j in range(4)]
    stds = [0.01] * 4
    ax = plot_rpe_iterations([np.cos(d * phi) for d in depths],
                             [np.sin(d * phi) for d in depths], stds, stds,
                             expected_positions=[(1.0, d * phi)
                                                 for d in depths])
    assert len(ax.collections) == 2
    plt.close("all")


# --- against the JAX package on the same inputs ------------------------------

def test_settings_and_experiments_equal_jax():
    cob = change_of_basis_matrix_to_circuit(
        [0, 1], np.kron(get_change_of_basis_from_eigvecs(
            bloch_rotation_to_eigenvectors(0.7, 0.3)), np.eye(2)))
    rotation = Circuit([RZ(0.4, 0), CZ(0, 1)])
    for qubits in ([0], [0, 1]):
        c = cob if len(qubits) == 2 else Circuit()
        ours = all_eigenvector_prep_meas_settings(qubits, c)
        theirs = jrpe.all_eigenvector_prep_meas_settings(
            qubits, to_jax_circuit(c))
        assert same_gates(ours[:2], theirs[:2], bar=0.0)
        assert [str(s) for s in ours[2]] == [str(s) for s in theirs[2]]
        expts = generate_rpe_experiments(rotation, *ours, num_depths=4)
        j_expts = jrpe.generate_rpe_experiments(
            to_jax_circuit(rotation), *theirs, num_depths=4)
        assert [experiment_signature(e) for e in expts] == \
            [experiment_signature(e) for e in j_expts]
    for fix, c in (((0, 1), cob), ((1, 0), None)):
        ours = pick_two_eigenvecs_prep_meas_settings(fix, 2, c)
        theirs = jrpe.pick_two_eigenvecs_prep_meas_settings(
            fix, 2, None if c is None else to_jax_circuit(c))
        assert same_gates(ours[:2], theirs[:2], bar=0.0)
        assert [str(s) for s in ours[2]] == [str(s) for s in theirs[2]]


def test_schedule_and_bounds_equal_jax():
    for max_depth in (8, 32):
        for depth in (1, 2, max_depth):
            for kw in ({}, dict(multiplicative_factor=3.0),
                       dict(additive_error=0.1)):
                assert num_trials(depth, max_depth, **kw) == \
                    jrpe.num_trials(depth, max_depth, **kw)
    for m_j, err in ((10, 0.1), (3.5, 0.2)):
        assert get_additive_error_factor(m_j, err) == \
            jrpe.get_additive_error_factor(m_j, err)
    for kw in ({}, dict(multiplicative_factor=10.0),
               dict(additive_error=0.05)):
        assert get_variance_upper_bound(6, **kw) == \
            jrpe.get_variance_upper_bound(6, **kw)
    evecs = bloch_rotation_to_eigenvectors(1.1, -0.4)
    assert np.array_equal(get_change_of_basis_from_eigvecs(evecs),
                          jrpe.get_change_of_basis_from_eigvecs(
                              jrpe.bloch_rotation_to_eigenvectors(1.1, -0.4)))


def test_estimate_phase_from_moments_equals_jax():
    rng = np.random.RandomState(3)
    for phi in (0.1, 2.9, 5.5):
        depths = [2 ** j for j in range(6)]
        radius = 0.97 ** np.array(depths)
        xs = list(radius * np.cos(np.array(depths) * phi)
                  + rng.normal(0, 0.02, 6))
        ys = list(radius * np.sin(np.array(depths) * phi)
                  + rng.normal(0, 0.02, 6))
        stds = list(rng.uniform(0.005, 0.03, 6))
        ours, theirs = [], []
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            a = estimate_phase_from_moments(xs, ys, stds, stds, ours)
            b = jrpe.estimate_phase_from_moments(xs, ys, stds, stds, theirs)
        assert abs(a - b) < 1e-12
        assert np.max(np.abs(np.array(ours) - np.array(theirs))) < 1e-12
    # the decoherence warning stops both at the same depth
    with pytest.warns(UserWarning):
        a = estimate_phase_from_moments([0.9, 0.5, 0.001], [0.1, 0.4, 0.0],
                                        [0.01] * 3, [0.01] * 3)
    with pytest.warns(UserWarning):
        b = jrpe.estimate_phase_from_moments([0.9, 0.5, 0.001],
                                             [0.1, 0.4, 0.0], [0.01] * 3,
                                             [0.01] * 3)
    assert abs(a - b) < 1e-12


def test_robust_phase_estimate_equals_jax(cz_run):
    """The same results (one qubit, and the CZ run's two) give the same
    phases."""
    expts, results = cz_run
    ours = robust_phase_estimate(results, [0, 1])
    theirs = jrpe.robust_phase_estimate(
        [jax_results(r) for r in results], [0, 1])
    assert len(ours) == len(theirs) == 4
    assert np.max(np.abs(np.array(ours) - np.array(theirs))) < 1e-12
    estimates, _, one_q = do_rpe(qvm(9), Circuit([RZ(2.2, 0)]), [Circuit()],
                                 [(0,)], num_depths=4)
    assert abs(estimates[(0,)] - jrpe.robust_phase_estimate(
        [jax_results(r) for r in one_q], [0])) < 1e-12


def test_rpe_probabilities_equal_jax(cz_run):
    cob = change_of_basis_matrix_to_circuit(
        [0], get_change_of_basis_from_eigvecs(
            bloch_rotation_to_eigenvectors(np.pi / 2, 0)))
    prep, pre_meas, settings = all_eigenvector_prep_meas_settings([0], cob)
    expts = generate_rpe_experiments(Circuit([RX(0.9, 0)]), prep, pre_meas,
                                     settings, num_depths=6)
    assert experiment_probability_gap(expts) < PROB_BAR
    assert experiment_probability_gap(cz_run[0]) < PROB_BAR
