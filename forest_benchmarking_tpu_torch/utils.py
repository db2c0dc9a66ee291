"""Host-side utilities: Pauli operator bases as stacked arrays, bitstring
helpers, moment transforms, the Pauli-eigenstate circuit constructors, and
:func:`entry_device`, which picks the device an entry point runs on.

Port of ``forest_benchmarking_tpu/utils.py`` (numpy, as there), with the
same public names and conventions: the first character of a Pauli string
(and the first qubit) is the left-most tensor factor; the right-most bit of
a bit array is the least significant. ``pandas`` (:func:`metadata_save`)
and ``tqdm`` (:func:`progress_iter`) are imported inside the functions
that use them, so that nothing else needs them.
"""
from __future__ import annotations

import functools
import itertools
from typing import List, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "I_MAT", "X_MAT", "Y_MAT", "Z_MAT", "H_MAT",
    "PAULI_MATS", "PAULI_LABELS",
    "is_pos_pow_two", "bit_array_to_int", "int_to_bit_array", "bit_arrays_to_ints",
    "ints_to_bit_arrays",
    "bloch_vector_to_standard_basis", "standard_basis_to_bloch_vector",
    "OperatorBasis", "PAULI_BASIS", "COMPUTATIONAL_BASIS",
    "n_qubit_pauli_basis", "n_qubit_computational_basis",
    "pauli_basis_matrices", "pauli_label_strings",
    "all_traceless_pauli_strings", "all_traceless_pauli_choice_strings",
    "all_traceless_pauli_z_strings",
    "transform_pauli_moments_to_bit", "transform_bit_moments_to_pauli",
    "pauli_string_to_matrix", "progress_iter", "entry_device",
]

# single-qubit constants (complex128 host constants; device code casts as needed)
I_MAT = np.eye(2, dtype=np.complex128)
X_MAT = np.array([[0, 1], [1, 0]], dtype=np.complex128)
Y_MAT = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
Z_MAT = np.array([[1, 0], [0, -1]], dtype=np.complex128)
H_MAT = np.array([[1, 1], [1, -1]], dtype=np.complex128) / np.sqrt(2)

PAULI_LABELS = ("I", "X", "Y", "Z")
PAULI_MATS = {"I": I_MAT, "X": X_MAT, "Y": Y_MAT, "Z": Z_MAT}


def is_pos_pow_two(x: int) -> bool:
    """Check that an integer is a positive power of two."""
    return x > 0 and (x & (x - 1)) == 0


def bit_array_to_int(bit_array: Sequence[int]) -> int:
    """Convert a bit array to an integer; the right-most bit is least significant."""
    out = 0
    for bit in bit_array:
        out = (out << 1) | int(bit)
    return out


def int_to_bit_array(num: int, n_bits: int) -> List[int]:
    """Convert an integer to a bit array; the right-most bit is least significant."""
    return [(num >> b) & 1 for b in range(n_bits - 1, -1, -1)]


def bit_arrays_to_ints(bit_arrays: np.ndarray) -> np.ndarray:
    """Vectorized ``bit_array_to_int`` over the last axis of a (..., n_bits) array."""
    bit_arrays = np.asarray(bit_arrays)
    n_bits = bit_arrays.shape[-1]
    weights = 1 << np.arange(n_bits - 1, -1, -1)
    return bit_arrays @ weights


def ints_to_bit_arrays(nums: np.ndarray, n_bits: int) -> np.ndarray:
    """Vectorized ``int_to_bit_array``: (...,) ints -> (..., n_bits) bits."""
    nums = np.asarray(nums)
    shifts = np.arange(n_bits - 1, -1, -1)
    return (nums[..., None] >> shifts) & 1


def bloch_vector_to_standard_basis(theta: float, phi: float) -> Tuple[complex, complex]:
    """Spherical Bloch coordinates -> (a, b) for a|0> + b|1>, a real."""
    return np.cos(theta / 2), np.exp(1j * phi) * np.sin(theta / 2)


def standard_basis_to_bloch_vector(qubit_state: Sequence[complex]) -> Tuple[float, float]:
    """(a, b) for a|0> + b|1> -> spherical Bloch coordinates (theta, phi)."""
    alpha, beta = complex(qubit_state[0]), complex(qubit_state[1])
    phi = np.angle(beta)
    if alpha.imag != 0:
        phi -= np.angle(alpha)
        alpha = abs(alpha)
    theta = 2 * np.arccos(np.real(alpha))
    return theta, phi


class OperatorBasis:
    """A complete set of basis operators, stored as stacked arrays.

    Unlike the reference (utils.py:328) which keeps a list of matrices, this
    class keeps a single stacked ``(num_ops, d, d)`` numpy array so device code
    can consume the whole basis in one einsum.
    """

    def __init__(self, labels_ops):
        labels, ops = zip(*labels_ops)
        self.labels = list(labels)
        self.ops = np.stack([np.asarray(op, dtype=np.complex128) for op in ops])
        self.dim = len(self.labels)

    @property
    def ops_by_label(self):
        return dict(zip(self.labels, self.ops))

    def product(self, *bases: "OperatorBasis") -> "OperatorBasis":
        """Tensor product with one or more other bases."""
        if len(bases) > 1:
            rest = bases[0].product(*bases[1:])
        else:
            rest = bases[0]
        labels = [l1 + l2 for l1 in self.labels for l2 in rest.labels]
        # batched kron: (n1, r1, c1) x (n2, r2, c2) -> (n1*n2, r1*r2, c1*c2)
        a, b = self.ops, rest.ops
        n1, r1, c1 = a.shape
        n2, r2, c2 = b.shape
        ops = np.einsum("nij,mkl->nmikjl", a, b).reshape(n1 * n2, r1 * r2, c1 * c2)
        return OperatorBasis(list(zip(labels, ops)))

    def __iter__(self):
        for label, op in zip(self.labels, self.ops):
            yield label, op

    def __pow__(self, n: int) -> "OperatorBasis":
        if not isinstance(n, int):
            raise TypeError("Can only accept an integer number of factors")
        if n < 1:
            raise ValueError("Need positive number of factors")
        if n == 1:
            return self
        return self.product(*([self] * (n - 1)))

    def __repr__(self):
        return "<span[{}]>".format(",".join(self.labels))


PAULI_BASIS = OperatorBasis([("I", I_MAT), ("X", X_MAT), ("Y", Y_MAT), ("Z", Z_MAT)])

COMPUTATIONAL_BASIS = OperatorBasis([
    ("0", np.array([[1], [0]], dtype=np.complex128)),
    ("1", np.array([[0], [1]], dtype=np.complex128)),
])


@functools.lru_cache(maxsize=None)
def n_qubit_pauli_basis(n: int) -> OperatorBasis:
    """The tensor-product Pauli basis on ``n`` qubits (reference utils.py:398)."""
    if n < 1:
        raise ValueError(f"n = {n} should be at least 1.")
    return PAULI_BASIS ** n


@functools.lru_cache(maxsize=None)
def n_qubit_computational_basis(n: int) -> OperatorBasis:
    if n < 1:
        raise ValueError(f"n = {n} should be at least 1.")
    return COMPUTATIONAL_BASIS ** n


@functools.lru_cache(maxsize=None)
def pauli_basis_matrices(n: int) -> np.ndarray:
    """Stacked unnormalized n-qubit Pauli basis, shape ``(4**n, 2**n, 2**n)``.

    Ordering matches itertools.product('IXYZ', repeat=n) with the first qubit as
    the left-most (most significant) tensor factor.
    """
    return n_qubit_pauli_basis(n).ops


@functools.lru_cache(maxsize=None)
def pauli_label_strings(n: int) -> Tuple[str, ...]:
    """Labels for :func:`pauli_basis_matrices`, e.g. ('II', 'IX', ...)."""
    return tuple(n_qubit_pauli_basis(n).labels)


def all_traceless_pauli_strings(n: int) -> List[str]:
    """All non-identity Pauli strings on n qubits (reference utils.py:146)."""
    return ["".join(x) for x in itertools.product("IXYZ", repeat=n)][1:]


def all_traceless_pauli_choice_strings(n: int, pauli_choice: str) -> List[str]:
    """All strings of I and the chosen Pauli with weight > 0 (utils.py:159)."""
    return ["".join(x) for x in itertools.product("I" + pauli_choice.upper(), repeat=n)][1:]


def all_traceless_pauli_z_strings(n: int) -> List[str]:
    """All I/Z strings with weight > 0 (reference utils.py:175)."""
    return ["".join(x) for x in itertools.product("IZ", repeat=n)][1:]


def pauli_string_to_matrix(pauli_str: str) -> np.ndarray:
    """Dense matrix of a Pauli string, first character = left-most tensor factor."""
    mat = np.array([[1.0 + 0j]])
    for ch in pauli_str:
        mat = np.kron(mat, PAULI_MATS[ch.upper()])
    return mat


def transform_pauli_moments_to_bit(mean_p, var_p):
    """Pauli-operator moments on [-1, 1] -> bit (Bernoulli) moments on [0, 1]."""
    return (mean_p + 1) / 2, var_p / 4


def transform_bit_moments_to_pauli(mean_c, var_c):
    """Bit (Bernoulli) moments on [0, 1] -> Pauli-operator moments on [-1, 1]."""
    return 2 * mean_c - 1, 4 * var_c


# ---------------------------------------------------------------------------
# Circuit-building helpers (reference utils.py:86-325,461-545)
# ---------------------------------------------------------------------------

def prepare_state_on_bloch_sphere(qubit: int, theta: float, phi: float):
    """Circuit preparing the qubit at (theta, phi) on the Bloch sphere from |0>
    using native RX(+-pi/2)/RZ rotations (reference utils.py:86)."""
    from forest_benchmarking_tpu_torch.circuits import Circuit, RX, RZ
    return Circuit([RX(np.pi / 2, qubit), RZ(theta, qubit),
                    RX(-np.pi / 2, qubit), RZ(phi, qubit)])


def local_pauli_eig_prep(op: str, qubit: int):
    """Circuit preparing the +1 eigenstate of the given Pauli from |0> (:187)."""
    from forest_benchmarking_tpu_torch.circuits import Circuit, RX, RY, I
    if op == "X":
        return Circuit([RY(np.pi / 2, qubit)])
    if op == "Y":
        return Circuit([RX(-np.pi / 2, qubit)])
    if op == "Z":
        return Circuit([I(qubit)])
    raise ValueError("Unknown gate operation")


def local_pauli_eigs_prep(op: str, qubit: int):
    """Circuits preparing both eigenstates of the given Pauli (:209)."""
    from forest_benchmarking_tpu_torch.circuits import Circuit, RX, RY, I
    if op == "X":
        gates = [RY(np.pi / 2, qubit), RY(-np.pi / 2, qubit)]
    elif op == "Y":
        gates = [RX(-np.pi / 2, qubit), RX(np.pi / 2, qubit)]
    elif op == "Z":
        gates = [I(qubit), RX(np.pi, qubit)]
    else:
        raise ValueError("Unknown gate operation")
    return [Circuit([g]) for g in gates]


def random_local_pauli_eig_prep(circuit, op: str, qubit: int,
                                rng=None):
    """Append a random eigenstate prep of the Pauli; returns its label (:230)."""
    from forest_benchmarking_tpu_torch.circuits import RX, RY, I
    if rng is None:
        rng = np.random
    pick = rng.random() > 0.5 if hasattr(rng, "random") else rng.rand() > 0.5
    if op == "X":
        gate, descr = (RY(np.pi / 2, qubit), "+X") if pick else (RY(-np.pi / 2, qubit), "-X")
    elif op == "Y":
        gate, descr = (RX(-np.pi / 2, qubit), "+Y") if pick else (RX(np.pi / 2, qubit), "-Y")
    elif op == "Z":
        gate, descr = (I(qubit), "+Z") if pick else (RX(np.pi, qubit), "-Z")
    else:
        raise ValueError("Unknown gate operation")
    circuit += gate
    return descr


def local_pauli_eig_meas(op: str, qubit: int):
    """Circuit rotating the Pauli eigenbasis onto the Z basis (:276)."""
    from forest_benchmarking_tpu_torch.circuits import Circuit, RX, RY, I
    if op == "X":
        return Circuit([RY(-np.pi / 2, qubit)])
    if op == "Y":
        return Circuit([RX(np.pi / 2, qubit)])
    if op == "Z":
        return Circuit([I(qubit)])
    raise ValueError("Unknown gate operation")


def prepare_prod_pauli_eigenstate(pauli_term):
    """Circuit preparing the +1 product eigenstate of the PauliTerm (:293)."""
    from forest_benchmarking_tpu_torch.circuits import Circuit
    prog = Circuit()
    for qubit, op in pauli_term.operations_as_set():
        prog += local_pauli_eig_prep(op, qubit)
    return prog


def measure_prod_pauli_eigenstate(pauli_term):
    """Circuit rotating the product eigenbasis onto Z measurements (:307)."""
    from forest_benchmarking_tpu_torch.circuits import Circuit
    prog = Circuit()
    for qubit, op in pauli_term.operations_as_set():
        prog += local_pauli_eig_meas(op, qubit)
    return prog


def bitstring_prep(qubits, bitstring, append_measure: bool = False,
                   in_x_basis: bool = False):
    """Circuit preparing the given bitstring via RX(pi) flips (:506).

    ``append_measure`` is accepted for API parity; measurement is implicit in
    QVM.run for the in-process simulator.
    """
    from forest_benchmarking_tpu_torch.circuits import Circuit, RX, H
    assert len(qubits) == len(bitstring)
    program = Circuit()
    for qubit, bit in zip(qubits, bitstring):
        if bit:
            program += RX(np.pi * bit, qubit)
        if in_x_basis:
            program += H(qubit)
    return program


def parameterized_bitstring_prep(qubits, bitstring, append_measure: bool = False,
                                 in_x_basis: bool = False):
    """Three-gate-per-qubit bitstring prep (reference :461).

    The reference parameterizes the RZ angle at run time on the QPU; in-process
    there is no run-time parameterization, so this takes the bitstring directly
    but uses the same RX(pi/2) RZ(pi b) RX(-pi/2) gate pattern.
    """
    from forest_benchmarking_tpu_torch.circuits import Circuit, RX, RZ, H
    program = Circuit()
    for qubit, bit in zip(qubits, bitstring):
        program += RX(np.pi / 2, qubit)
        program += RZ(np.pi * bit, qubit)
        program += RX(-np.pi / 2, qubit)
        if in_x_basis:
            program += H(qubit)
    return program


def metadata_save(qc, repo_path: str = None, filename: str = None):
    """Save run metadata (date/time, git sha, simulator info) to a DataFrame
    (reference utils.py:548)."""
    import pandas as pd
    from datetime import date, datetime
    the_repo = the_branch = the_commit = None
    if repo_path is not None:
        import subprocess
        def _git(*args):
            return subprocess.run(["git", "-C", repo_path, *args],
                                  capture_output=True, text=True).stdout.strip()
        the_repo = _git("rev-parse", "--git-dir")
        the_branch = _git("rev-parse", "--abbrev-ref", "HEAD")
        the_commit = _git("rev-parse", "--short", "HEAD")
    metadata = {
        "Date": [str(date.today())],
        "Time": [str(datetime.now().time())],
        "Repository": [the_repo],
        "Branch": [the_branch],
        "Git_commit": [the_commit],
        "Device_name": [getattr(qc, "name", str(qc))],
    }
    df = pd.DataFrame(metadata)
    if filename:
        df.to_json(filename)
    return df


def pack_shot_data(shot_data) -> np.ndarray:
    """Pack a (shots, n_bits) 0/1 array into bytes along the bit axis
    (reference: utils.py:123). Host-side compression for shot archives;
    unpack with ``np.unpackbits(..., axis=1)[:, :n_bits]``."""
    return np.packbits(np.asarray(shot_data, dtype=np.uint8), axis=1)


def prepare_random_prod_pauli_eigenstate(pauli_term, rng=None):
    """Circuit preparing a uniformly random (+/-1 per factor) product
    eigenstate of the PauliTerm (reference: utils.py:315). The chosen
    labels (e.g. ``"+X-Z"``) are recoverable by inspecting the circuit;
    pass ``rng`` (``numpy.random.Generator``) for reproducibility."""
    from forest_benchmarking_tpu_torch.circuits import Circuit
    prog = Circuit()
    # operations_as_set() is a frozenset: iterate in qubit order so the same
    # rng consumes draws in the same qubit order in every process (set order
    # varies with str-hash randomization, which would break reproducibility)
    for qubit, op in sorted(pauli_term.operations_as_set()):
        random_local_pauli_eig_prep(prog, op, qubit, rng=rng)
    return prog


def prepare_all_prod_pauli_eigenstates(pauli_term):
    """All circuits preparing every product eigenstate of the PauliTerm (:322)."""
    import itertools
    from forest_benchmarking_tpu_torch.circuits import Circuit
    opset = sorted(pauli_term.operations_as_set())  # deterministic order
    prod_preps = itertools.product(
        *[local_pauli_eigs_prep(op, qubit) for qubit, op in opset])
    out = []
    for prod in prod_preps:
        c = Circuit()
        for p in prod:
            c += p
        out.append(c)
    return out


def progress_iter(iterable, enabled: bool = False, desc: str = None,
                  total: int = None):
    """Wrap an iterable in a tqdm progress bar when ``enabled``.

    Backs every public ``show_progress_bar`` kwarg (the analog of tqdm
    threading in reference observable_estimation.py:902). Falls back to the
    bare iterable if tqdm is unavailable, so acquisition never hard-depends
    on it.
    """
    if not enabled:
        return iterable
    try:
        from tqdm import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable, desc=desc, total=total)


def entry_device(device=None, *values) -> torch.device:
    """The device an entry point runs on.

    Where one of ``values`` is a tensor, the first such tensor's device:
    functions run where their tensors lie, and a ``device`` that names
    another raises ``ValueError``. Otherwise (numpy arrays, lists) ``device``,
    by default the card. Without a card, the card raises ``RuntimeError``
    unless the caller passes ``device="cpu"``: nothing falls back to the CPU.
    """
    tensors = [v for v in values if isinstance(v, torch.Tensor)]
    if tensors:
        dev = tensors[0].device
        want = dev if device is None else torch.device(device)
        if want.type != dev.type or want.index not in (None, dev.index):
            raise ValueError(f"device={device} but the inputs lie on {dev}")
        return dev
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this entry point runs on the "
                           "card unless called with device='cpu'")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
