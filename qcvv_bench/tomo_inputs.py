"""Process-tomography inputs the benchmark makes itself: the Pauli-basis
A-matrix and seeded BCSZ channels with binomial counts.

Frozen copies of ``forest_benchmarking_tpu_torch.benchmarks``'
``process_tomo_A_matrix`` and ``synth_process_datasets`` (with the BCSZ
draw of ``ops.random_operators``), so that the inputs stay what they are
when the program changes; ``qcvv_bench/tests/test_qcvv_bench_frozen.py``
holds them equal to the program's functions. Imports nothing of the
program.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

PAULIS = {
    "I": np.eye(2, dtype=complex),
    "X": np.array([[0, 1], [1, 0]], dtype=complex),
    "Y": np.array([[0, -1j], [1j, 0]], dtype=complex),
    "Z": np.array([[1, 0], [0, -1]], dtype=complex),
}
# the six Pauli eigenstates in the order of the program's process-tomography
# settings: +X, -X, +Y, -Y, +Z, -Z
EIGENSTATES = [(np.eye(2) + sign * PAULIS[p]) / 2
               for p in "XYZ" for sign in (1, -1)]


def _kron_all(mats):
    out = np.array([[1.0 + 0j]])
    for m in mats:
        out = np.kron(out, m)
    return out


def process_tomo_a_matrix(n_qubits: int) -> np.ndarray:
    """The (R, d^4) complex128 A-matrix of Pauli-basis process tomography,
    p = A vec(choi) (column-stacking vec, Choi on H_in (x) H_out): for each
    input eigenstate product (qubit 0 outermost) and each non-identity Pauli
    string (``itertools.product("IXYZ")`` order), the rows of the + and -
    projectors, divided by d^2. R = 2 * 6^n * (4^n - 1): 1080 at n = 2."""
    dim = 2 ** n_qubits
    eye = np.eye(dim)
    strings = list(itertools.product("IXYZ", repeat=n_qubits))[1:]
    rows = []
    for states in itertools.product(EIGENSTATES, repeat=n_qubits):
        in_mat = _kron_all(states)
        for s in strings:
            op = _kron_all(PAULIS[p] for p in s)
            for proj in ((eye + op) / 2, (eye - op) / 2):
                rows.append(np.kron(in_mat, proj.T).T.reshape(-1))
    return np.stack(rows) / dim ** 2


def _dag(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2).conj()


def bcsz_chois(generator: torch.Generator, dim: int, kraus_rank: int,
               batch: int) -> torch.Tensor:
    """(batch, dim^2, dim^2) Choi matrices of BCSZ random channels of Kraus
    rank ``kraus_rank``, drawn on the generator's device: a complex Ginibre
    (dim^2, rank) matrix X (real parts, then imaginary parts, float32),
    rho = X X^dag normalized by kron(W, I) on both sides, W = (Tr_out
    rho)^(-1/2)."""
    shape = (batch, dim * dim, kraus_rank)
    kw = dict(generator=generator, dtype=torch.float32,
              device=generator.device)
    x = torch.complex(torch.randn(shape, **kw), torch.randn(shape, **kw))
    rho = x @ _dag(x)
    red = torch.diagonal(rho.reshape(batch, dim, dim, dim, dim),
                         dim1=2, dim2=4).sum(-1)
    w, v = torch.linalg.eigh(red)
    inv_sqrt = (v * (1.0 / torch.sqrt(w))[..., None, :].to(v.dtype)) @ _dag(v)
    eye = torch.eye(dim, dtype=rho.dtype, device=rho.device)
    q = (inv_sqrt[..., :, None, :, None] * eye[None, None, :, None, :]
         ).reshape(batch, dim * dim, dim * dim)
    return q @ rho @ q


def tomography_counts(generator: torch.Generator, a: torch.Tensor, dim: int,
                      batch: int, shots: int, kraus_rank: int):
    """(n, chois): ``batch`` BCSZ channels and their simulated data, drawn on
    the generator's device; ``a`` is the (R, d^4) complex A-matrix there.
    ``n`` is (batch, R), binomial counts of ``shots`` a setting over the
    grand total; the products run in full float32."""
    chois = bcsz_chois(generator, dim, kraus_rank, batch)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        vec = chois.transpose(-1, -2).reshape(batch, -1)
        p = (vec @ a.to(chois.dtype).T).real
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    p = p.clamp(0.0, 1.0)
    pp, pm = p[:, 0::2], p[:, 1::2]
    bern = pp / (pp + pm).clamp(min=1e-12)
    k = torch.binomial(torch.full_like(bern, float(shots)), bern,
                       generator=generator)
    counts = torch.stack([k, shots - k], dim=-1).reshape(batch, -1)
    return counts / (shots * pp.shape[1]), chois
