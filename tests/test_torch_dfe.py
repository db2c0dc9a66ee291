"""The port's direct fidelity estimation on its QVM.

Mirrors tests/test_direct_fidelity_estimation.py on ``QVM(device="cpu")``
at the JAX suite's bars (noiseless fidelities within 0.01 or 0.02 of 1,
depolarized ones within 0.02 of 1 - p/2, Monte Carlo within 0.05). Against
the JAX package on the same inputs: the exhaustive state and process
experiments setting for setting, the Monte Carlo experiments that a seeded
``np.random.RandomState`` draws (and ``do_dfe``'s grouped settings),
``estimate_dfe`` of the same results within 1e-12, and the QVM's
probabilities for the programs (calibration programs included) within
1e-12 of the JAX package's float64 simulator.
"""
import numpy as np
import pytest
import torch

import forest_benchmarking_tpu.direct_fidelity_estimation as jdfe
import forest_benchmarking_tpu.observable_estimation as joe
from forest_benchmarking_tpu_torch.circuits import (
    Circuit, Gate, H, CNOT, X, S, CZ)
from forest_benchmarking_tpu_torch.direct_fidelity_estimation import (
    generate_exhaustive_state_dfe_experiment,
    generate_exhaustive_process_dfe_experiment,
    generate_monte_carlo_state_dfe_experiment,
    generate_monte_carlo_process_dfe_experiment,
    acquire_dfe_data, estimate_dfe, do_dfe)
from forest_benchmarking_tpu_torch.observable_estimation import (
    get_calibration_program, group_settings)
from forest_benchmarking_tpu_torch.sim import QVM
from forest_benchmarking_tpu_torch.sim.noise import depolarizing_kraus_map
from torch_protocols import (
    PROB_BAR, experiment_probability_gap, experiment_signature, jax_results,
    max_probability_gap, to_jax_circuit)

torch.set_num_threads(1)


def qvm(seed):
    return QVM(seed=seed, device="cpu")


def noisy_circuit(gates, qubits, kraus_ops):
    """The gates, then a no-op 'noise' gate (which survives basic_compile)
    carrying the channel: the JAX suite's pattern."""
    eye = np.eye(2 ** len(qubits), dtype=complex)
    c = Circuit(list(gates) + [Gate("noise", (), tuple(qubits),
                                    matrix=tuple(map(tuple, eye)))])
    c.define_noisy_gate("noise", qubits, kraus_ops)
    return c


# --- tests/test_direct_fidelity_estimation.py on the port --------------------

def test_exhaustive_state_dfe_settings_count():
    expt = generate_exhaustive_state_dfe_experiment(
        Circuit([H(0), CNOT(0, 1)]), [0, 1])
    assert len(expt) == 3


def test_exhaustive_process_dfe_settings_count():
    expt = generate_exhaustive_process_dfe_experiment(Circuit([H(0)]), [0])
    assert len(expt) == 3 * 2


def test_state_dfe_bell_noiseless():
    (fid, err), expt, results = do_dfe(qvm(1), Circuit([H(0), CNOT(0, 1)]),
                                       [0, 1], "state", num_shots=2000)
    assert abs(fid - 1.0) < 0.01


def test_process_dfe_noiseless():
    (fid, err), expt, results = do_dfe(qvm(2), Circuit([H(0)]), [0],
                                       "process", num_shots=2000)
    assert abs(fid - 1.0) < 0.01


def test_process_dfe_2q_noiseless():
    (fid, err), expt, results = do_dfe(qvm(3), Circuit([CZ(0, 1)]), [0, 1],
                                       "process", num_shots=1000)
    assert abs(fid - 1.0) < 0.02


def test_state_dfe_with_depolarizing_noise():
    # |+> under depolarizing p: fidelity 1 - p/2
    p = 0.2
    program = noisy_circuit([H(0)], (0,), depolarizing_kraus_map(p))
    (fid, err), expt, results = do_dfe(qvm(4), program, [0], "state",
                                       num_shots=20000)
    assert abs(fid - (1 - p / 2)) < 0.02


def test_process_dfe_with_depolarizing_noise():
    # depolarizing p after H: average gate fidelity 1 - p/2
    p = 0.3
    program = noisy_circuit([H(0)], (0,), depolarizing_kraus_map(p))
    (fid, err), expt, results = do_dfe(qvm(5), program, [0], "process",
                                       num_shots=20000)
    assert abs(fid - (1 - p / 2)) < 0.02


def test_monte_carlo_state_dfe():
    expt = generate_monte_carlo_state_dfe_experiment(
        Circuit([H(0), CNOT(0, 1)]), [0, 1], n_terms=20,
        rng=np.random.RandomState(0))
    assert len(expt) == 20
    fid, err = estimate_dfe(acquire_dfe_data(qvm(6), expt, num_shots=500),
                            "state")
    assert abs(fid - 1.0) < 0.05


def test_monte_carlo_process_dfe():
    expt = generate_monte_carlo_process_dfe_experiment(
        Circuit([S(0)]), [0], n_terms=20, rng=np.random.RandomState(1))
    assert len(expt) == 20
    fid, err = estimate_dfe(acquire_dfe_data(qvm(7), expt, num_shots=500),
                            "process")
    assert abs(fid - 1.0) < 0.05


def test_estimate_dfe_bad_kind_raises():
    q = qvm(8)
    program = Circuit([X(0)])
    expt = generate_exhaustive_state_dfe_experiment(program, [0])
    results = acquire_dfe_data(q, expt, num_shots=100)
    with pytest.raises(ValueError):
        estimate_dfe(results, "banana")
    with pytest.raises(ValueError):
        do_dfe(q, program, [0], "banana")


# --- against the JAX package on the same inputs ------------------------------

PROGRAMS = (Circuit([H(0), CNOT(0, 1), S(1)]), [0, 1])
PROGRAM_3Q = (Circuit([H(2), CNOT(2, 0), CZ(0, 1), S(0)]), [0, 1, 2])


def same_experiment(ours, theirs):
    return experiment_signature(ours) == experiment_signature(theirs)


@pytest.mark.parametrize("program,qubits", [PROGRAMS, PROGRAM_3Q])
def test_exhaustive_experiments_equal_jax(program, qubits):
    jp = to_jax_circuit(program)
    assert same_experiment(
        generate_exhaustive_state_dfe_experiment(program, qubits),
        jdfe.generate_exhaustive_state_dfe_experiment(jp, qubits))
    assert same_experiment(
        generate_exhaustive_process_dfe_experiment(program, qubits),
        jdfe.generate_exhaustive_process_dfe_experiment(jp, qubits))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("program,qubits", [PROGRAMS, PROGRAM_3Q])
def test_monte_carlo_settings_equal_jax(program, qubits, seed):
    """A seeded RandomState draws the same settings, in order, in both
    packages, and ``group_settings`` groups them alike."""
    jp = to_jax_circuit(program)
    for ours_gen, jax_gen in (
            (generate_monte_carlo_state_dfe_experiment,
             jdfe.generate_monte_carlo_state_dfe_experiment),
            (generate_monte_carlo_process_dfe_experiment,
             jdfe.generate_monte_carlo_process_dfe_experiment)):
        ours = ours_gen(program, qubits, 40, np.random.RandomState(seed))
        theirs = jax_gen(jp, qubits, 40, np.random.RandomState(seed))
        assert same_experiment(ours, theirs)
        assert same_experiment(group_settings(ours),
                               joe.group_settings(theirs))


def test_global_random_state_draws_equal_jax():
    """Without ``rng`` the samplers draw from the global ``np.random``."""
    program, qubits = PROGRAMS
    np.random.seed(11)
    ours = generate_monte_carlo_process_dfe_experiment(program, qubits, 12)
    np.random.seed(11)
    theirs = jdfe.generate_monte_carlo_process_dfe_experiment(
        to_jax_circuit(program), qubits, 12)
    assert same_experiment(ours, theirs)


@pytest.fixture(scope="module")
def dfe_runs():
    """``do_dfe`` state and process runs on a noisy two-qubit program,
    exhaustive (grouped) and Monte Carlo."""
    program = noisy_circuit([H(0), CNOT(0, 1), S(1)], (0, 1),
                            [np.kron(k, np.eye(2)) for k in
                             depolarizing_kraus_map(0.1)])
    runs = {}
    for kind in ("state", "process"):
        runs[kind] = do_dfe(qvm(20), program, [0, 1], kind, num_shots=300,
                            group_tpb_settings=True)
        runs[kind + "_mc"] = do_dfe(qvm(21), program, [0, 1], kind,
                                    mc_n_terms=16, num_shots=300,
                                    rng=np.random.RandomState(3))
    return program, runs


@pytest.mark.parametrize("kind", ["state", "process", "state_mc",
                                  "process_mc"])
def test_estimate_dfe_equals_jax(dfe_runs, kind):
    _, runs = dfe_runs
    (fid, err), expt, results = runs[kind]
    j_fid, j_err = jdfe.estimate_dfe(jax_results(results), kind[:-3]
                                     if kind.endswith("_mc") else kind)
    assert abs(fid - j_fid) < 1e-12 and abs(err - j_err) < 1e-12
    assert (fid, err) == estimate_dfe(results, kind.split("_")[0])


def test_dfe_probabilities_equal_jax(dfe_runs):
    """The grouped programs and the calibration programs of the runs."""
    program, runs = dfe_runs
    for kind, (_, expt, results) in runs.items():
        assert experiment_probability_gap([expt]) < PROB_BAR, kind
        obs = list(dict.fromkeys(r.setting.observable.copy(coefficient=1.0)
                                 for r in results))
        cal = [get_calibration_program(o, program) for o in obs]
        assert max_probability_gap(cal, [o.get_qubits() for o in obs]) \
            < PROB_BAR, kind
