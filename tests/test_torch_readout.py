"""The port's readout characterization on its QVM.

Mirrors the readout tests of tests/test_readout_and_logic.py on
``QVM(device="cpu")`` at the JAX suite's bars (the ideal confusion within
0.01 of the identity, a p(0|0) = 0.9, p(1|1) = 0.8 confusion within 0.01,
the joint and marginal matrices within 0.05 of the identity), and holds a
known joint confusion within 5 binomial standard deviations. Against the
JAX package: ``marginalize_confusion_matrix`` of the same matrix within
1e-12, the same flipped circuits, and the QVM's
probabilities for the preparation programs (with readout confusion) within
1e-12 of the JAX package's float64 simulator.
"""
import itertools

import numpy as np
import torch

import forest_benchmarking_tpu.readout as jro
from forest_benchmarking_tpu_torch.circuits import Circuit, H
from forest_benchmarking_tpu_torch.readout import (
    get_flipped_circuit, estimate_confusion_matrix,
    estimate_joint_confusion_in_set, marginalize_confusion_matrix,
    estimate_joint_reset_confusion)
from forest_benchmarking_tpu_torch.sim import QVM
from forest_benchmarking_tpu_torch.utils import (
    bitstring_prep, parameterized_bitstring_prep)
from torch_protocols import (
    PROB_BAR, max_probability_gap, same_gates, to_jax_circuit)

torch.set_num_threads(1)

CONFUSION = {0: (0.9, 0.8), 1: (0.97, 0.85)}   # p(0|0), p(1|1) per qubit


class ConfusedQVM(QVM):
    """The port's QVM with a readout confusion on some qubits (the JAX
    suite's subclass pattern)."""

    def __init__(self, confusion, **kw):
        super().__init__(device="cpu", **kw)
        self.confusion = confusion

    def run(self, circuit, qubits, num_shots):
        noisy = circuit.copy()
        for q, (p00, p11) in self.confusion.items():
            noisy.define_noisy_readout(q, p00=p00, p11=p11)
        return super().run(noisy, qubits, num_shots)


# --- the readout tests of tests/test_readout_and_logic.py on the port --------

def test_confusion_matrix_ideal():
    cm = estimate_confusion_matrix(QVM(seed=1, device="cpu"), 0,
                                   num_shots=2000)
    assert np.allclose(cm, np.eye(2), atol=0.01)


def test_confusion_matrix_noisy():
    cm = estimate_confusion_matrix(ConfusedQVM({0: (0.9, 0.8)}, seed=2), 0,
                                   num_shots=30000)
    assert abs(cm[0, 0] - 0.9) < 0.01
    assert abs(cm[1, 1] - 0.8) < 0.01


def test_joint_confusion_and_marginalization():
    q = QVM(seed=3, device="cpu")
    cms = estimate_joint_confusion_in_set(q, qubits=[0, 1], num_shots=500,
                                          joint_group_size=2)
    assert set(cms.keys()) == {(0, 1)}
    joint = cms[(0, 1)]
    assert joint.shape == (4, 4)
    assert np.allclose(joint, np.eye(4), atol=0.05)
    marg = marginalize_confusion_matrix(joint, [0, 1], (0,))
    assert np.allclose(marg, np.eye(2), atol=0.05)
    cms1 = estimate_joint_confusion_in_set(q, qubits=[0, 1], num_shots=500,
                                           joint_group_size=1)
    assert set(cms1.keys()) == {(0,), (1,)}


def test_reset_confusion_ideal():
    cms = estimate_joint_reset_confusion(QVM(seed=4, device="cpu"),
                                         qubits=[0], num_trials=5)
    assert np.allclose(cms[(0,)][:, 0], 1.0)


def test_get_flipped_circuit():
    assert len(get_flipped_circuit(Circuit([H(0)]), [0, 1]).gates) == 3


def true_joint_confusion(qubits):
    """The product of the per-qubit confusions (rows: prepared bitstring,
    columns: measured; the first qubit the most significant bit)."""
    out = np.ones((1, 1))
    for q in qubits:
        p00, p11 = CONFUSION.get(q, (1.0, 1.0))
        out = np.kron(out, np.array([[p00, 1 - p00], [1 - p11, p11]]))
    return out


def test_joint_confusion_recovers_a_known_confusion():
    """Both preparation patterns, two-qubit groups over three qubits: each
    entry within 5 binomial standard deviations of the truth."""
    shots = 4000
    for use_param in (True, False):
        cms = estimate_joint_confusion_in_set(
            ConfusedQVM(CONFUSION, seed=5), qubits=[2, 0, 1],
            num_shots=shots, joint_group_size=2,
            use_param_program=use_param)
        assert set(cms) == {(0, 1), (0, 2), (1, 2)}
        for group, cm in cms.items():
            truth = true_joint_confusion(group)
            sigma = np.sqrt(truth * (1 - truth) / shots)
            assert np.all(np.abs(cm - truth) <= 5 * sigma + 1e-12), group
            assert np.allclose(cm.sum(1), 1.0)


# --- against the JAX package on the same inputs ------------------------------

def test_marginalize_confusion_matrix_equals_jax():
    rng = np.random.RandomState(2)
    for n in (2, 3):
        cm = rng.dirichlet(np.ones(2 ** n), size=2 ** n)
        qubits = [5, 1, 3][:n]
        for k in range(1, n + 1):
            for subset in itertools.combinations(qubits, k):
                ours = marginalize_confusion_matrix(cm, qubits, subset)
                theirs = jro.marginalize_confusion_matrix(cm, qubits, subset)
                assert np.max(np.abs(ours - theirs)) < 1e-12
                assert np.allclose(ours.sum(1), 1.0)


def test_flipped_circuits_equal_jax():
    c = Circuit([H(0)])
    assert same_gates([get_flipped_circuit(c, [0, 2])],
                      [jro.get_flipped_circuit(to_jax_circuit(c), [0, 2])],
                      bar=0.0)


def test_readout_probabilities_equal_jax():
    """Every preparation program of a two-qubit joint confusion, both
    patterns, with readout confusion, against the JAX simulator."""
    programs, meas = [], []
    for bits in itertools.product([0, 1], repeat=2):
        for prep in (parameterized_bitstring_prep, bitstring_prep):
            p = prep([0, 1], bits)
            for q, (p00, p11) in CONFUSION.items():
                p.define_noisy_readout(q, p00=p00, p11=p11)
            programs.append(p)
            meas.append([0, 1])
    assert max_probability_gap(programs, meas) < PROB_BAR
