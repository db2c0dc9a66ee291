"""The circuit half of the port's randomized benchmarking, on its QVM.

Mirrors the circuit and protocol tests of
tests/test_randomized_benchmarking.py on ``QVM(device="cpu")`` at the JAX
suite's bars (the RB decay within 2.5 x max(stderr, 1e-3) of 0.85, the
unitarity within 0.02). The JAX suite marks its two-qubit recovery slow;
the port's runs here at the JAX test's size and bar (3 x max(stderr,
5e-3)), since its acquisition takes well under a second on the CPU.

Against the JAX package on the same inputs: seeded sequences (one and two
qubits, interleaved CZ, three qubits through synthesis, and the unitarity
sequences) gate for gate with parameters within 1e-12; the grouped RB and
unitarity experiments setting for setting; ``circuit_unitary_np`` and
``sequences_to_ptm_stack`` within 1e-12; ``get_stats_by_qubit_group``
exactly; ``do_rb``'s RB, IRB and unitarity fits of the same results by the
LM rule of ``torch_lm_ties``; and the QVM's probabilities for the
protocols' programs within 1e-12 of the JAX package's float64 simulator.
Shots come from the port's ``torch.Generator``, so end-to-end results are
held by recovery of a known truth, not by equality with JAX.
"""
import numpy as np
import pytest
import torch

import forest_benchmarking_tpu.randomized_benchmarking as jrb
from forest_benchmarking_tpu_torch.circuits import (
    Circuit, Gate, CZ, H, CNOT, RX, RZ)
from forest_benchmarking_tpu_torch.observable_estimation import (
    ExperimentResult, ExperimentSetting, zeros_state)
from forest_benchmarking_tpu_torch.paulis import PauliTerm
from forest_benchmarking_tpu_torch.randomized_benchmarking import (
    generate_rb_experiment_sequences,
    group_sequences_into_parallel_experiments, generate_rb_experiments,
    generate_unitarity_experiments, acquire_rb_data,
    get_stats_by_qubit_group, fit_rb_results, fit_unitarity_results,
    unitarity_to_rb_decay, irb_decay_to_gate_error, get_rb_gateset,
    oneq_rb_gateset, twoq_rb_gateset, merge_sequences, generate_rb_sequence,
    do_rb, circuit_unitary_np, sequences_to_ptm_stack,
    simulate_rb_survival_batched)
from forest_benchmarking_tpu_torch.sim import QVM
from forest_benchmarking_tpu_torch.sim.noise import (
    depolarizing_kraus_map, pauli_kraus_map)
from forest_benchmarking_tpu_torch.sim.statevector import run_statevector
from torch_lm_ties import hold_against_jax
from torch_protocols import (
    PROB_BAR, experiment_probability_gap, experiment_signature, gate_list,
    jax_results, same_gates, to_jax_circuit)

torch.set_num_threads(1)


def qvm(seed):
    return QVM(seed=seed, device="cpu")


def noise_carrier(qubits, name="seqnoise"):
    """A no-op custom gate, to which a circuit attaches a channel."""
    eye = np.eye(2 ** len(qubits), dtype=complex)
    return Gate(name, (), tuple(qubits), matrix=tuple(map(tuple, eye)))


def add_noise_to_sequences(sequences, qubits, kraus_ops, every=1):
    """Append a no-op noise gate carrying the channel to every ``every``-th
    element of each sequence (the JAX suite's helper, with a stride)."""
    gate = noise_carrier(qubits)
    for seq in sequences:
        for circ in seq[::every]:
            circ.gates.append(gate)
            circ.define_noisy_gate("seqnoise", qubits, kraus_ops)


def params(fit):
    return [fit.best_values[k] for k in fit.param_names]


# --- the JAX suite's circuit and protocol tests on the port ------------------

def test_1q_general_pauli_noise():
    expected_decay = .85
    probs = [expected_decay + .15 / 4, .06, .04, .0125]
    depths = [d for d in [2, 8, 10, 16, 25] for _ in range(10)]
    qubits = (0,)
    sequences = generate_rb_experiment_sequences(qubits, depths,
                                                 random_seed=1)
    add_noise_to_sequences(sequences, qubits, pauli_kraus_map(probs))
    expts = group_sequences_into_parallel_experiments([sequences], [qubits])
    results = acquire_rb_data(qvm(1), expts, 60)
    stats = get_stats_by_qubit_group([qubits], results)[qubits]
    fit = fit_rb_results(depths, stats["expectation"], stats["std_err"],
                         device="cpu")
    observed = fit.params["decay"].value
    err = fit.params["decay"].stderr
    np.testing.assert_allclose(expected_decay, observed,
                               atol=2.5 * max(err, 1e-3))


def test_2q_general_pauli_noise():
    # for two qubits the twirled decay of a Pauli channel is
    # (16 p_I - 1) / 15 (the JAX suite's note)
    probs = [.85, .06] + [0] * 12 + [.04, .05]
    expected_decay = (16 * probs[0] - 1) / 15
    depths = [d for d in [2, 10, 12, 25] for _ in range(5)]
    qubits = (0, 1)
    sequences = generate_rb_experiment_sequences(qubits, depths,
                                                 random_seed=2)
    add_noise_to_sequences(sequences, qubits, pauli_kraus_map(probs))
    expts = group_sequences_into_parallel_experiments([sequences], [qubits])
    results = acquire_rb_data(qvm(2), expts, 50)
    stats = get_stats_by_qubit_group([qubits], results)[qubits]
    fit = fit_rb_results(depths, stats["expectation"], stats["std_err"], 50,
                         device="cpu")
    observed = fit.params["decay"].value
    err = fit.params["decay"].stderr
    np.testing.assert_allclose(expected_decay, observed,
                               atol=3 * max(err, 5e-3))


def test_noiseless_rb_survival_is_one():
    expts = generate_rb_experiments([(0,)], [2, 5, 9], random_seed=3)
    for res_group in acquire_rb_data(qvm(3), expts, num_shots=100):
        for res in res_group:
            assert np.isclose(res.expectation, 1.0), res


def test_unitarity_of_depolarizing_noise():
    expected_decay = 0.9
    probs = [expected_decay + 0.1 / 4] + [0.1 / 4] * 3
    qubits = (0,)
    depths = [d for d in [1, 4, 7, 10] for _ in range(8)]
    sequences = [
        generate_rb_experiment_sequences(qubits, [d], random_seed=10 + i,
                                         use_self_inv_seqs=False)[0]
        for i, d in enumerate(depths)]
    add_noise_to_sequences(sequences, qubits, pauli_kraus_map(probs))
    expts = group_sequences_into_parallel_experiments(
        [sequences], [qubits], is_unitarity_expt=True)
    # 3000 shots, not the JAX test's 300: at 300 the unitarity's shot noise
    # alone has a standard deviation of ~0.02, the bar itself, and the test
    # passes on 14 of 20 QVM seeds in the port and 8 of 12 in the JAX
    # package; at 3000 it is ~0.008
    results = acquire_rb_data(qvm(4), expts, num_shots=3000)
    stats = get_stats_by_qubit_group([qubits], results)[qubits]
    fit = fit_unitarity_results(depths, stats["expectation"],
                                stats["std_err"], device="cpu")
    observed_unitarity = fit.params["decay"].value
    np.testing.assert_allclose(observed_unitarity, expected_decay ** 2,
                               atol=0.02)
    np.testing.assert_allclose(unitarity_to_rb_decay(observed_unitarity, 2),
                               expected_decay, atol=0.02)


def test_get_rb_gateset():
    assert len(get_rb_gateset([0])) == 8
    assert len(get_rb_gateset([0, 1])) == 17
    with pytest.raises(ValueError):
        get_rb_gateset([0, 1, 2])


def test_do_rb_end_to_end():
    depths = [d for d in [2, 6, 10] for _ in range(4)]
    decays, expts, results = do_rb(qvm(5), [(0,)], depths, num_shots=100,
                                   random_seed=7)
    # noiseless: the decay is only weakly identified; require a high one
    assert decays[(0,)] >= 0.9
    for res_group in results:
        for res in res_group:
            assert res.expectation > 0.9


def test_batched_rb_simulator_from_circuits():
    """The PTM stack of the port's own sequences: exact survivals, and the
    decay recovered from sampled ones."""
    qubits = (0,)
    depths = [d for d in [2, 6, 10, 16] for _ in range(6)]
    sequences = generate_rb_experiment_sequences(qubits, depths,
                                                 random_seed=11)
    ptms, lengths = sequences_to_ptm_stack(sequences, qubits)
    surv = simulate_rb_survival_batched(ptms, lengths=lengths,
                                        device="cpu").numpy()
    assert np.allclose(surv, 1.0, atol=1e-10)
    p = 0.1
    noise_ptm = np.diag([1.0, 1 - p, 1 - p, 1 - p])
    exact = simulate_rb_survival_batched(ptms, noise_ptm, lengths=lengths,
                                         device="cpu").numpy()
    for depth, s in zip(depths, exact):
        assert abs(s - (0.5 + 0.5 * (1 - p) ** depth)) < 1e-10
    sampled = simulate_rb_survival_batched(
        ptms, noise_ptm, torch.Generator().manual_seed(0), num_shots=5000,
        lengths=lengths, device="cpu").numpy()
    fit = fit_rb_results(depths, [[2 * s - 1] for s in sampled],
                         [[0.01] for _ in sampled], device="cpu")
    assert abs(fit.params["decay"].value - (1 - p)) < 0.02


def test_circuit_unitary_np_matches_sim():
    c = Circuit([H(0), CNOT(0, 1), RZ(0.3, 1)])
    u = circuit_unitary_np(c, [0, 1])
    psi = run_statevector(c, [0, 1], device="cpu").numpy()
    assert np.allclose(u[:, 0], psi, atol=1e-12)
    assert np.allclose(u @ u.conj().T, np.eye(4), atol=1e-12)


def test_simultaneous_rb_two_groups():
    """Two disjoint groups: qubit 1's readout error lowers its survivals
    and leaves qubit 0's."""
    qubit_groups = [(0,), (1,)]
    depths = [d for d in [2, 6, 10] for _ in range(6)]
    expts = generate_rb_experiments(qubit_groups, depths, random_seed=21)
    for expt in expts:
        expt.program.define_noisy_readout(1, p00=0.95, p11=0.95)
    results = acquire_rb_data(qvm(21), expts, num_shots=300)
    stats = get_stats_by_qubit_group(qubit_groups, results)
    fit0 = fit_rb_results(depths, stats[(0,)]["expectation"],
                          stats[(0,)]["std_err"], device="cpu")
    fit1 = fit_rb_results(depths, stats[(1,)]["expectation"],
                          stats[(1,)]["std_err"], device="cpu")
    surv0 = np.mean([np.mean(e) for e in stats[(0,)]["expectation"]])
    surv1 = np.mean([np.mean(e) for e in stats[(1,)]["expectation"]])
    assert surv0 > 0.98
    assert surv1 < 0.95
    assert fit0.success and fit1.success


def test_get_stats_by_qubit_group_accepts_unsorted_groups():
    res = ExperimentResult(
        setting=ExperimentSetting(zeros_state([0, 1]),
                                  PauliTerm([(0, "Z"), (1, "Z")])),
        expectation=0.25, total_counts=100, std_err=0.05)
    stats = get_stats_by_qubit_group([(1, 0)], [[res]])
    assert stats[(1, 0)]["expectation"] == [[0.25]]
    assert stats[(1, 0)]["std_err"] == [[0.05]]


def interleaved_noisy_gate(p_gate):
    """RX(pi/2) followed by a no-op carrier of depolarizing(p_gate)."""
    gate = Circuit([RX(np.pi / 2, 0), noise_carrier((0,), "gnoise")])
    gate.define_noisy_gate("gnoise", (0,), depolarizing_kraus_map(p_gate))
    return gate


def test_irb_recovers_the_interleaved_gate_error():
    """IRB with depolarizing(p_c) after every Clifford and depolarizing
    (p_g) on the interleaved gate: ``irb_decay_to_gate_error`` of the two
    fitted decays within 2.5 sigma of p_g / 2."""
    p_c, p_g = 0.04, 0.1
    depths = [d for d in [2, 4, 8, 12, 16] for _ in range(8)]
    decays, sigmas = [], []
    for seed, gate in ((31, None), (32, interleaved_noisy_gate(p_g))):
        sequences = generate_rb_experiment_sequences((0,), depths, gate,
                                                     random_seed=seed)
        # the Cliffords sit at the even places of an interleaved sequence
        add_noise_to_sequences(sequences, (0,), depolarizing_kraus_map(p_c),
                               every=1 if gate is None else 2)
        expts = group_sequences_into_parallel_experiments([sequences],
                                                          [(0,)])
        stats = get_stats_by_qubit_group(
            [(0,)], acquire_rb_data(qvm(seed), expts, 400))[(0,)]
        fit = fit_rb_results(depths, stats["expectation"], stats["std_err"],
                             device="cpu")
        decays.append(fit.params["decay"].value)
        sigmas.append(fit.params["decay"].stderr)
    rb_decay, irb_decay = decays
    assert abs(rb_decay - (1 - p_c)) < 2.5 * max(sigmas[0], 1e-3)
    error = irb_decay_to_gate_error(irb_decay, rb_decay, 2)
    sigma = 0.5 * np.hypot(sigmas[1] / rb_decay,
                           irb_decay * sigmas[0] / rb_decay ** 2)
    assert abs(error - p_g / 2) < 2.5 * max(sigma, 1e-3), (error, sigma)


# --- against the JAX package on the same inputs ------------------------------

@pytest.mark.parametrize("seed", [0, 5, 19])
@pytest.mark.parametrize("qubits,interleaved,self_inv", [
    ((0,), False, True), ((0, 1), False, True), ((0, 1), True, True),
    ((0, 1, 2), False, True), ((0,), False, False), ((0, 1), False, False)])
def test_rb_experiment_sequences_equal_jax(seed, qubits, interleaved,
                                           self_inv):
    """Seeded sequences (the seed raised by one a depth): the same gates in
    the same order, parameters within 1e-12."""
    gate = Circuit([CZ(0, 1)]) if interleaved else None
    depths = [2, 3, 7] if len(qubits) < 3 else [2, 4]
    ours = generate_rb_experiment_sequences(
        qubits, depths, gate, random_seed=seed, use_self_inv_seqs=self_inv)
    theirs = jrb.generate_rb_experiment_sequences(
        qubits, depths, None if gate is None else to_jax_circuit(gate),
        random_seed=seed, use_self_inv_seqs=self_inv)
    assert [len(s) for s in ours] == [len(s) for s in theirs]
    for a, b in zip(ours, theirs):
        assert same_gates(a, b)


def test_gatesets_and_merged_sequences_equal_jax():
    assert gate_list([Circuit(list(oneq_rb_gateset(3)))]) == gate_list(
        [to_jax_circuit(Circuit(list(jrb.oneq_rb_gateset(3))))])
    assert gate_list([Circuit(list(twoq_rb_gateset(2, 0)))]) == gate_list(
        [Circuit(list(jrb.twoq_rb_gateset(2, 0)))])
    a = generate_rb_sequence((0,), 4, random_seed=8)
    b = generate_rb_sequence((1,), 4, random_seed=9)
    ours = merge_sequences([a, b])
    theirs = jrb.merge_sequences([
        [to_jax_circuit(c) for c in a], [to_jax_circuit(c) for c in b]])
    assert same_gates(ours, theirs, bar=0.0)


def test_rb_and_unitarity_experiments_equal_jax():
    """Simultaneous RB and IRB over two groups, and unitarity (grouped by
    ``group_settings``): the same settings, groups and programs."""
    groups = [(0,), (2, 1)]
    depths = [2, 5]
    cz = Circuit([CZ(0, 1)])
    for ours, theirs in (
            (generate_rb_experiments(groups, depths, random_seed=4),
             jrb.generate_rb_experiments(groups, depths, random_seed=4)),
            (generate_rb_experiments([(0, 1)], depths, cz, random_seed=6),
             jrb.generate_rb_experiments([(0, 1)], depths,
                                         to_jax_circuit(cz), random_seed=6)),
            (generate_unitarity_experiments(groups, depths, random_seed=5),
             jrb.generate_unitarity_experiments(groups, depths,
                                                random_seed=5))):
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            sa, sb = experiment_signature(a), experiment_signature(b)
            assert sa[0] == sb[0]
            assert same_gates([a.program], [b.program])


def test_ptm_stack_and_unitaries_equal_jax():
    qubits = (0, 1)
    sequences = generate_rb_experiment_sequences(qubits, [2, 3, 5],
                                                 Circuit([CZ(0, 1)]),
                                                 random_seed=12)
    j_sequences = [[to_jax_circuit(c) for c in s] for s in sequences]
    ptms, lengths = sequences_to_ptm_stack(sequences, qubits)
    j_ptms, j_lengths = jrb.sequences_to_ptm_stack(j_sequences, qubits)
    assert ptms.shape == (3, 9, 16, 16) and ptms.dtype == np.float64
    assert np.array_equal(lengths, j_lengths)
    assert np.max(np.abs(ptms - j_ptms)) < 1e-12
    for circ, j_circ in zip(sequences[2], j_sequences[2]):
        assert np.max(np.abs(circuit_unitary_np(circ, [1, 0])
                             - jrb.circuit_unitary_np(j_circ, [1, 0]))) \
            < 1e-12


class NoisyRX(QVM):
    """The port's QVM with depolarizing noise after every RX gate, which
    ``do_rb``'s native Cliffords carry (the JAX suite's pattern of a QVM
    subclass that edits each circuit it runs)."""

    def run(self, circuit, qubits, num_shots):
        noisy = circuit.copy()
        noisy.define_noisy_gate("RX", None, depolarizing_kraus_map(0.06))
        return super().run(noisy, qubits, num_shots)


@pytest.fixture(scope="module")
def do_rb_runs():
    """``do_rb`` (RB over two groups, IRB with a noisy interleaved gate,
    unitarity) on the port's QVM with noise after every RX."""
    runs = {}
    depths = [d for d in [2, 6, 12, 20] for _ in range(3)]
    kw = dict(num_shots=200, random_seed=3)
    runs["rb"] = (depths, None, do_rb(NoisyRX(seed=8, device="cpu"),
                                      [(0,), (1,)], depths, **kw))
    runs["irb"] = (depths, None, do_rb(
        NoisyRX(seed=9, device="cpu"), [(0,)], depths,
        interleaved_gate=interleaved_noisy_gate(0.1), **kw))
    u_depths = [d for d in [1, 4, 8, 14] for _ in range(3)]
    runs["unitarity"] = (u_depths, True, do_rb(
        NoisyRX(seed=10, device="cpu"), [(0,)], u_depths,
        is_unitarity_expt=True, **kw))
    return runs


@pytest.mark.parametrize("kind", ["rb", "irb", "unitarity"])
def test_do_rb_statistics_and_fits_equal_jax(monkeypatch, do_rb_runs, kind):
    """The same results give the same statistics in both packages and the
    same decays (LM tie rule); ``do_rb``'s decays are its fits'."""
    depths, unitarity, (decays, expts, results) = do_rb_runs[kind]
    groups = list(decays)
    stats = get_stats_by_qubit_group(groups, results)
    j_stats = jrb.get_stats_by_qubit_group(
        groups, [jax_results(r) for r in results])
    assert stats == j_stats
    for group in groups:
        e, s = stats[group]["expectation"], stats[group]["std_err"]
        if unitarity:
            fits = (lambda: fit_unitarity_results(depths, e, s, device="cpu"),
                    lambda: jrb.fit_unitarity_results(depths, e, s))
        else:
            fits = (lambda: fit_rb_results(depths, e, s, 200, device="cpu"),
                    lambda: jrb.fit_rb_results(depths, e, s, 200))
        fit = fits[0]()
        got = hold_against_jax(monkeypatch, lambda: params(fits[0]()),
                               params(fits[1]()))
        assert got[0][fit.param_names.index("decay")] == decays[group]


def test_rb_probabilities_equal_jax(do_rb_runs):
    """The port's QVM against the JAX package's float64 simulator on the
    programs of RB, IRB (gate noise on the interleaved gate) and unitarity
    runs, and on a noisy two-qubit RB experiment."""
    for kind, (_, _, (_, expts, _)) in do_rb_runs.items():
        assert experiment_probability_gap(expts[:4]) < PROB_BAR, kind
    probs = [.85, .06] + [0] * 12 + [.04, .05]
    sequences = generate_rb_experiment_sequences((0, 1), [3, 6],
                                                 random_seed=2)
    add_noise_to_sequences(sequences, (0, 1), pauli_kraus_map(probs))
    expts = group_sequences_into_parallel_experiments([sequences], [(0, 1)])
    assert experiment_probability_gap(expts) < PROB_BAR
