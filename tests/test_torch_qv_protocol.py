"""The port's per-circuit quantum-volume path against the JAX package.

- ``generate_abstract_qv_circuit`` bit for bit under the same numpy
  ``RandomState``, and ``collect_heavy_outputs`` equal.
- ``abstract_circuit_to_circuit`` and ``topology_restricted_program_generator``
  gate for gate (line, all-to-all, a spare qubit, a grid), with the JAX
  suite's routing cases (``tests/test_quantum_volume.py:287-341``) on the
  port's simulator: routed and unrouted distributions within 1e-10.
- The QVM's probabilities of model circuits (ideal, routed, with noisy
  QVGATEs) within ``PROB_BAR`` (1e-12) of the JAX package's float64 QVM.
- ``sample_rand_circuits_for_heavy_out`` and ``measure_quantum_volume`` on a
  stand-in ``qc`` that returns the same shots to both packages: the same
  programs and the same counts; the counting functions and
  ``calculate_prob_est_and_err`` exactly equal.
- On the port's own QVM, whose shots come from a ``torch.Generator``, the
  JAX suite's cases held by distribution: ideal heavy-output probability,
  QV of a noisy device that fails early (``:115-135``), and a line with
  noisy SWAPs below all-to-all (``:343-377``).
"""
import warnings

import numpy as np
import pytest
import torch

import forest_benchmarking_tpu.quantum_volume as jqv
from forest_benchmarking_tpu_torch.ops.pallas_traj import _simulate_qv_circuit
from forest_benchmarking_tpu_torch.quantum_volume import (
    generate_abstract_qv_circuit, collect_heavy_outputs,
    abstract_circuit_to_circuit, topology_restricted_program_generator,
    sample_rand_circuits_for_heavy_out, measure_quantum_volume,
    calculate_prob_est_and_err, count_heavy_hitters_sampled,
    get_prob_sample_heavy_by_depth, extract_quantum_volume_from_results)
from forest_benchmarking_tpu_torch.sim import QVM
from forest_benchmarking_tpu_torch.sim.noise import depolarizing_kraus_map
from forest_benchmarking_tpu_torch.sim.statevector import run_statevector
from torch_protocols import (
    PROB_BAR, max_probability_gap, same_gates, to_jax_circuit)

torch.set_num_threads(1)

TOPOLOGIES = {
    "line": [(0, 1), (1, 2), (2, 3), (3, 4)],
    "all-to-all": [(i, j) for i in range(5) for j in range(5) if i < j],
    "spare": [(0, 9), (9, 1), (1, 2), (2, 3), (3, 8), (8, 4)],
    "grid": [(0, 1), (1, 2), (3, 4), (4, 5), (0, 3), (1, 4), (2, 5)],
}


def two_qubit_depolarizing(p):
    ks = depolarizing_kraus_map(p)
    return [np.kron(a, b) for a in ks for b in ks]


def draws(seed, depths):
    """The abstract circuits of one RandomState, in order."""
    rng = np.random.RandomState(seed)
    return [(d, *generate_abstract_qv_circuit(d, rng)) for d in depths]


@pytest.mark.parametrize("seed", [0, 5])
def test_abstract_circuits_equal_jax_bit_for_bit(seed):
    depths = [2, 3, 4, 5, 6, 7, 8, 3]
    rng = np.random.RandomState(seed)
    for depth, perms, gates in draws(seed, depths):
        theirs_perms, theirs_gates = jqv.generate_abstract_qv_circuit(depth,
                                                                      rng)
        assert all(np.array_equal(a, b) for a, b in zip(perms, theirs_perms))
        assert gates.shape == (depth, depth // 2, 4, 4)
        assert np.array_equal(gates, theirs_gates)
        assert collect_heavy_outputs(depth, perms, gates) == \
            jqv.collect_heavy_outputs(depth, theirs_perms, theirs_gates)


def test_heavy_outputs_equal_the_batched_simulator():
    """The host heavy sets equal those of the batched path's simulator on
    the same circuit (``test_batched_simulation_matches_host_sim``)."""
    for depth, perms, gates in draws(3, [3, 4, 5, 6]):
        probs = _simulate_qv_circuit(torch.tensor(np.stack(perms)),
                                     torch.tensor(gates), depth).numpy()
        med = np.median(probs)
        assert set(collect_heavy_outputs(depth, perms, gates)) == \
            {i for i, p in enumerate(probs) if p > med}


def test_abstract_circuit_to_circuit_equals_jax():
    for depth, perms, gates in draws(1, [2, 3, 5]):
        for qubits in (list(range(depth)), [7, 3, 5, 1, 0, 2][:depth] + [9]):
            assert same_gates(
                [abstract_circuit_to_circuit(qubits, perms, gates)],
                [jqv.abstract_circuit_to_circuit(qubits, perms, gates)])


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_router_equals_jax(name):
    ours = topology_restricted_program_generator(TOPOLOGIES[name])
    theirs = jqv.topology_restricted_program_generator(TOPOLOGIES[name])
    for depth, perms, gates in draws(11, [3, 4, 5]):
        qubits = list(range(depth))
        assert same_gates([ours(None, qubits, perms, gates)],
                          [theirs(None, qubits, perms, gates)])
    with pytest.raises(ValueError, match="not in the topology"):
        ours(None, [0, 1, 7], *draws(2, [3])[0][1:])


def test_router_preserves_the_distribution():
    """``tests/test_quantum_volume.py:287-313`` on the port."""
    (depth, perms, gates), = draws(11, [4])
    qubits = list(range(depth))
    routed = topology_restricted_program_generator(
        [(0, 1), (1, 2), (2, 3)])(None, qubits, perms, gates)
    for g in routed.gates:
        if len(g.qubits) == 2:
            assert abs(g.qubits[0] - g.qubits[1]) == 1
    unrouted = abstract_circuit_to_circuit(qubits, perms, gates)
    p_routed = run_statevector(routed, qubits, device="cpu").abs() ** 2
    p_ideal = run_statevector(unrouted, qubits, device="cpu").abs() ** 2
    np.testing.assert_allclose(p_routed.numpy(), p_ideal.numpy(), atol=1e-10)
    full = topology_restricted_program_generator(
        [(i, j) for i in qubits for j in qubits if i < j])
    assert all(g.name != "SWAP" for g in full(None, qubits, perms,
                                              gates).gates)


def test_router_through_spare_qubit():
    """``tests/test_quantum_volume.py:316-341`` on the port."""
    (depth, perms, gates), = draws(5, [3])
    routed = topology_restricted_program_generator(
        [(0, 9), (9, 1), (1, 2)])(None, [0, 1, 2], perms, gates)
    for g in routed.gates:
        if len(g.qubits) == 2:
            assert tuple(sorted(g.qubits)) in {(0, 9), (1, 9), (1, 2)}
    unrouted = abstract_circuit_to_circuit([0, 1, 2], perms, gates)
    p4 = (run_statevector(routed, [0, 1, 2, 9], device="cpu").abs() ** 2
          ).numpy()
    p_ideal = (run_statevector(unrouted, [0, 1, 2], device="cpu").abs() ** 2
               ).numpy()
    np.testing.assert_allclose(p4[0::2], p_ideal, atol=1e-10)
    np.testing.assert_allclose(p4[1::2], 0.0, atol=1e-12)


def test_model_circuit_probabilities_equal_jax():
    programs, meas = [], []
    line = topology_restricted_program_generator(TOPOLOGIES["line"])
    for depth, perms, gates in draws(4, [2, 3, 4, 5]):
        qubits = list(range(depth))
        programs += [abstract_circuit_to_circuit(qubits, perms, gates),
                     line(None, qubits, perms, gates)]
        meas += [qubits, qubits]
        noisy = abstract_circuit_to_circuit(qubits, perms, gates)
        noisy.define_noisy_gate("QVGATE", None, two_qubit_depolarizing(0.05))
        programs.append(noisy)
        meas.append(qubits)
    assert max_probability_gap(programs, meas) <= PROB_BAR


class ScriptedQC:
    """A stand-in ``qc``: records each program and returns shots drawn
    from a numpy generator of its own, the same for both packages."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)
        self.programs = []

    def run(self, program, qubits, num_shots):
        self.programs.append(program)
        return self.rng.randint(0, 2, size=(num_shots, len(qubits)))


def test_sampling_and_measurement_equal_jax_on_the_same_shots():
    for generator in (None, TOPOLOGIES["line"]):
        ours_qc, theirs_qc = ScriptedQC(3), ScriptedQC(3)
        kw = dict(num_circuits=6, num_shots=40)
        ours = sample_rand_circuits_for_heavy_out(
            ours_qc, [0, 1, 2, 3, 4], 4, generator and
            topology_restricted_program_generator(generator),
            rng=np.random.RandomState(8), **kw)
        theirs = jqv.sample_rand_circuits_for_heavy_out(
            theirs_qc, [0, 1, 2, 3, 4], 4, generator and
            jqv.topology_restricted_program_generator(generator),
            rng=np.random.RandomState(8), **kw)
        assert ours == theirs
        assert same_gates(ours_qc.programs, theirs_qc.programs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = measure_quantum_volume(
            ScriptedQC(4), qubits=[0, 1, 2, 3], num_circuits=5,
            num_shots=30, rng=np.random.RandomState(9), stop_when_fail=False)
        theirs = jqv.measure_quantum_volume(
            ScriptedQC(4), qubits=[0, 1, 2, 3], num_circuits=5,
            num_shots=30, rng=np.random.RandomState(9), stop_when_fail=False)
    assert ours == theirs and sorted(ours) == [2, 3, 4]


def test_measure_quantum_volume_checks_its_arguments():
    with pytest.warns(UserWarning, match="greater than 100"):
        with pytest.raises(ValueError, match="Specify the qubits"):
            measure_quantum_volume(ScriptedQC(0), num_circuits=5)


def test_counting_functions_equal_jax():
    rng = np.random.RandomState(6)
    results = [rng.randint(0, 2, size=(50, 3)) for _ in range(4)]
    heavy = [sorted(rng.choice(8, 4, replace=False).tolist())
             for _ in range(4)]
    ours = list(count_heavy_hitters_sampled(results, heavy))
    assert ours == list(jqv.count_heavy_hitters_sampled(results, heavy))
    assert list(count_heavy_hitters_sampled(
        [np.array([[0, 0], [0, 1], [1, 1]])], [[0, 3]])) == [2]
    depths, shots = [2, 2, 3, 3], [50, 50, 50, 50]
    assert get_prob_sample_heavy_by_depth(depths, ours, shots) == \
        jqv.get_prob_sample_heavy_by_depth(depths, ours, shots)
    out = get_prob_sample_heavy_by_depth([2, 2, 3], [80, 90, 70],
                                         [100, 100, 100])
    assert set(out) == {2, 3} and np.isclose(out[2][0], (80 + 90) / 200)
    for args in ((700, 100, 10), (8512, 100, 100), (0, 3, 5)):
        assert calculate_prob_est_and_err(*args) == \
            jqv.calculate_prob_est_and_err(*args)
    for results_ in ({2: (0.9, 0.8), 3: (0.85, 0.7), 4: (0.6, 0.5)},
                     {2: (0.5, 0.4)}, {3: (0.9, 0.8), 2: (0.9, 0.7)}):
        assert extract_quantum_volume_from_results(results_) == \
            jqv.extract_quantum_volume_from_results(results_)


# --- the JAX suite's QVM cases, held by distribution ------------------------

def test_ideal_sampling_matches_heavy_sets():
    num_heavy = sample_rand_circuits_for_heavy_out(
        QVM(seed=2, device="cpu"), list(range(3)), 3, None, 30, 300,
        rng=np.random.RandomState(2))
    assert 0.7 < num_heavy / (30 * 300) < 0.95


def test_ideal_heavy_probability_agrees_with_jax_within_sigma():
    """The same circuits (one ``RandomState``) on both QVMs: the heavy
    counts agree within 4 binomial sigma."""
    kw = dict(num_circuits=20, num_shots=200)
    ours = sample_rand_circuits_for_heavy_out(
        QVM(seed=3, device="cpu"), [0, 1, 2, 3], 4, None,
        rng=np.random.RandomState(10), **kw)
    theirs = jqv.sample_rand_circuits_for_heavy_out(
        jqv_qvm(3), [0, 1, 2, 3], 4, None, rng=np.random.RandomState(10),
        **kw)
    n = kw["num_circuits"] * kw["num_shots"]
    p = theirs / n
    assert abs(ours - theirs) <= 4 * np.sqrt(2 * n * p * (1 - p))


def jqv_qvm(seed):
    from forest_benchmarking_tpu.sim import QVM as JaxQVM
    return JaxQVM(seed=seed)


class NoisyQVM(QVM):
    """The port's QVM with a noisy gate attached to every circuit it runs
    (the JAX suite's subclass pattern)."""

    def __init__(self, gate, kraus, **kw):
        super().__init__(device="cpu", **kw)
        self.gate, self.kraus = gate, kraus

    def run(self, circuit, qubits, num_shots):
        noisy = circuit.copy()
        noisy.define_noisy_gate(self.gate, None, self.kraus)
        return super().run(noisy, qubits, num_shots)


def test_measure_quantum_volume_noisy_fails_early():
    qvm = NoisyQVM("QVGATE", two_qubit_depolarizing(0.9), seed=4)
    with pytest.warns(UserWarning):
        results = measure_quantum_volume(qvm, qubits=[0, 1, 2],
                                         num_circuits=20, num_shots=100,
                                         rng=np.random.RandomState(5))
    assert extract_quantum_volume_from_results(results) == 2 ** 1


def test_qv_on_line_topology_with_noisy_swaps_fails_earlier():
    kraus = two_qubit_depolarizing(0.5)
    runs = {}
    for name, gen in (("line", topology_restricted_program_generator(
            [(0, 1), (1, 2)])), ("full", None)):
        with pytest.warns(UserWarning):
            runs[name] = measure_quantum_volume(
                NoisyQVM("SWAP", kraus, seed=3), qubits=[0, 1, 2],
                program_generator=gen, num_circuits=15, num_shots=60,
                depths=np.array([3]), rng=np.random.RandomState(12))
    assert runs["full"][3][0] > runs["line"][3][0]


def test_noisy_qvgate_programs_equal_jax():
    """The programs the noisy QVM runs carry the same channel as the JAX
    suite's: the same probabilities (to_jax_circuit keeps the noise)."""
    (depth, perms, gates), = draws(7, [3])
    circ = abstract_circuit_to_circuit(list(range(depth)), perms, gates)
    circ.define_noisy_gate("QVGATE", None, two_qubit_depolarizing(0.2))
    jcirc = to_jax_circuit(circ)
    assert len(jcirc.gate_noise) == 1
    assert max_probability_gap([circ], [list(range(depth))]) <= PROB_BAR
