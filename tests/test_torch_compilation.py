"""The port's ``basic_compile``: a mirror of tests/test_compilation.py on the
port's simulator (CPU, complex128). Every decomposition equals the original
up to a global phase; its gate-by-gate equality with the JAX package is in
tests/test_torch_observable_estimation.py."""
import numpy as np
import pytest
import torch

from forest_benchmarking_tpu_torch.circuits import (
    Circuit, Gate, H, X, T, RX, RY, RZ, CNOT, CZ, SWAP, CCNOT, XY)
from forest_benchmarking_tpu_torch.compilation import (
    basic_compile, match_global_phase, is_magic_angle)
from forest_benchmarking_tpu_torch.sim import run_density_matrix, run_statevector
from forest_benchmarking_tpu_torch.sim.noise import damping_kraus_map

torch.set_num_threads(1)


def unitary_of(circuit, qubits):
    """The unitary, by simulating every basis input."""
    n = len(qubits)
    cols = []
    for i in range(2 ** n):
        prep = Circuit([X(qubits[j]) for j in range(n)
                        if (i >> (n - 1 - j)) & 1])
        cols.append(run_statevector(prep + circuit, qubits,
                                    device="cpu").numpy())
    return np.stack(cols, axis=1)


@pytest.mark.parametrize("circuit,qubits", [
    (Circuit([H(0)]), [0]),
    (Circuit([X(0)]), [0]),
    (Circuit([T(0)]), [0]),
    (Circuit([T(0).dag()]), [0]),
    (Circuit([RY(0.43, 0)]), [0]),
    (Circuit([RX(0.2, 0)]), [0]),      # non-magic angle
    (Circuit([RX(np.pi / 2, 0)]), [0]),
    (Circuit([RZ(1.2, 0)]), [0]),
    (Circuit([CNOT(0, 1)]), [0, 1]),
    (Circuit([SWAP(0, 1)]), [0, 1]),
    (Circuit([CZ(0, 1)]), [0, 1]),
    (Circuit([XY(0.77, 0, 1)]), [0, 1]),
    (Circuit([CCNOT(0, 1, 2)]), [0, 1, 2]),
    (Circuit([H(0), CNOT(0, 1), RY(0.3, 1), T(0)]), [0, 1]),
])
def test_basic_compile_preserves_unitary(circuit, qubits):
    a, b = match_global_phase(unitary_of(circuit, qubits),
                              unitary_of(basic_compile(circuit), qubits))
    assert np.max(np.abs(a - b)) < 1e-10


def test_compiled_gates_are_native_and_daggers_fold():
    c = Circuit([H(0), CNOT(0, 1), RY(0.3, 1), CCNOT(0, 1, 2), SWAP(1, 2)])
    for g in basic_compile(c).gates:
        assert g.name in ("RX", "RZ", "CZ", "XY", "I"), g
        if g.name == "RX":
            assert is_magic_angle(g.params[0])
    compiled = basic_compile(Circuit([RZ(0.3, 0).dag()]))
    assert compiled.gates[0].params[0] == -0.3
    assert not compiled.gates[0].dagger


def test_custom_matrix_passthrough_unknown_gate_and_magic_angles():
    g = Gate("CUSTOM", (), (0,),
             matrix=tuple(map(tuple, np.eye(2).astype(complex))))
    assert basic_compile(Circuit([g])).gates[0].name == "CUSTOM"
    with pytest.raises(ValueError):
        basic_compile(Circuit([Gate("FOO", (), (0,))]))
    assert is_magic_angle(np.pi / 2) and is_magic_angle(-np.pi)
    assert is_magic_angle(0.0) and not is_magic_angle(0.3)


def test_basic_compile_preserves_noise_annotated_gates():
    noisy = Circuit([RY(0.6, 0)])
    noisy.define_noisy_gate("RY", (0,), damping_kraus_map(0.3))
    compiled = basic_compile(noisy)
    assert any(g.name == "RY" for g in compiled.gates)
    np.testing.assert_allclose(
        run_density_matrix(compiled, [0], device="cpu").numpy(),
        run_density_matrix(noisy, [0], device="cpu").numpy(), atol=1e-12)
    plain = basic_compile(Circuit([RY(0.6, 0)]))
    assert all(g.name in ("RX", "RZ") for g in plain.gates)
