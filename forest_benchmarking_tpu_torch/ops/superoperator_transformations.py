"""Conversions between representations of superoperators (column-stacking
convention), batched over leading axes.

Port of ``forest_benchmarking_tpu/ops/superoperator_transformations.py``:
``vec``/``unvec``, the Pauli <-> computational basis matrices (host-side
cached numpy, moved once to each device and dtype) and the twenty
conversions ``kraus2*``, ``chi2*``, ``superop2*``, ``pauli_liouville2*`` and
``choi2*``. Kraus sets are stacked tensors (..., K, r, c); a list or tuple
of operators is stacked. As in the JAX package, chi conversions use the
congruence ``chi = c2p @ choi @ c2p^dag``, and :func:`choi2kraus`, whose
number of operators depends on the data, is host-side numpy and unbatched;
the conversions that return Kraus lists go through it. Float32 products
run in full float32, not TF32.
"""
from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from forest_benchmarking_tpu_torch.ops.calculational import dag
from forest_benchmarking_tpu_torch.ops.lanes_apg import full_f32_matmul
from forest_benchmarking_tpu_torch.utils import (
    entry_device, pauli_basis_matrices)

__all__ = [
    "vec", "unvec",
    "kraus2chi", "kraus2superop", "kraus2pauli_liouville", "kraus2choi",
    "chi2pauli_liouville", "chi2kraus", "chi2superop", "chi2choi",
    "superop2kraus", "superop2chi", "superop2pauli_liouville", "superop2choi",
    "pauli_liouville2kraus", "pauli_liouville2chi", "pauli_liouville2superop",
    "pauli_liouville2choi",
    "choi2kraus", "choi2chi", "choi2superop", "choi2pauli_liouville",
    "pauli2computational_basis_matrix", "computational2pauli_basis_matrix",
]


def vec(matrix: torch.Tensor) -> torch.Tensor:
    """Vectorize a (..., N, M) matrix by column stacking -> (..., N*M, 1)."""
    t = matrix.transpose(-1, -2)
    return t.reshape(*t.shape[:-2], -1, 1)


def unvec(vector: torch.Tensor,
          shape: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Invert :func:`vec`: (..., N*M, 1) or (..., N*M) -> (..., N, M)."""
    if vector.shape[-1] == 1 and vector.dim() >= 2:
        vector = vector[..., 0]
    size = vector.shape[-1]
    if shape is None:
        dim = math.isqrt(size)
        if dim * dim != size:
            raise ValueError(f"{size} is not a perfect square; pass `shape`.")
        shape = (dim, dim)
    n, m = shape
    return vector.reshape(*vector.shape[:-1], m, n).transpose(-1, -2)


def _stack_kraus(kraus_ops) -> torch.Tensor:
    """Normalize input to a stacked (..., K, r, c) tensor."""
    if isinstance(kraus_ops, (list, tuple)):
        return torch.stack([torch.as_tensor(k) for k in kraus_ops], dim=-3)
    if kraus_ops.dim() == 2:  # single Kraus op
        return kraus_ops[None]
    return kraus_ops


@functools.lru_cache(maxsize=None)
def _p2c_np(dim: int) -> np.ndarray:
    """Host-side cached Pauli -> computational basis transform (dim**2 x
    dim**2): column k is vec(P_k), column stacking."""
    n_qubits = int(np.log2(dim))
    paulis = pauli_basis_matrices(n_qubits)
    return np.swapaxes(paulis, -1, -2).reshape(dim * dim, dim * dim).T.copy()


@functools.lru_cache(maxsize=None)
def _basis(dim: int, inverse: bool, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """p2c (or c2p = p2c^dag / dim) as a tensor of ``dtype`` on ``device``,
    made once per key and shared: callers must not write to it."""
    m = _p2c_np(dim)
    if inverse:
        m = m.conj().T / dim
    return torch.tensor(m, device=device).to(dtype)


def pauli2computational_basis_matrix(dim: int, device=None) -> torch.Tensor:
    r"""Matrix sending unnormalized-Pauli-basis coordinates to vec'd
    matrices: ``p2c @ e_k = vec(sigma_k)``, complex128. On the card unless
    ``device`` names another
    (:func:`forest_benchmarking_tpu_torch.utils.entry_device`)."""
    return _basis(dim, False, torch.complex128, entry_device(device)).clone()


def computational2pauli_basis_matrix(dim: int, device=None) -> torch.Tensor:
    r"""Inverse transform: ``c2p = p2c^dag / dim``."""
    return _basis(dim, True, torch.complex128, entry_device(device)).clone()


def _dim(matrix: torch.Tensor) -> int:
    """d of a (..., d^2, d^2) superoperator."""
    return math.isqrt(matrix.shape[-1])


def _congruence(basis: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """basis @ m @ basis^dag."""
    with full_f32_matmul():
        return basis @ m @ dag(basis)


# ------------------------------------------------------------------ kraus -> *

def kraus2superop(kraus_ops) -> torch.Tensor:
    r"""Kraus -> superoperator: :math:`\sum_i \bar K_i \otimes K_i` (column
    stacking). Accepts non-square Kraus operators: (..., K, r, c) ->
    (..., r**2, c**2)."""
    k = _stack_kraus(kraus_ops)
    r, c = k.shape[-2:]
    with full_f32_matmul():
        out = torch.einsum("...nij,...nkl->...ikjl", k.conj(), k)
    return out.reshape(*out.shape[:-4], r * r, c * c)


def kraus2choi(kraus_ops) -> torch.Tensor:
    r"""Kraus -> Choi:
    :math:`\sum_i |K_i\rangle\rangle \langle\langle K_i|`."""
    k = _stack_kraus(kraus_ops)
    v = vec(k)[..., 0]  # (..., K, r*c)
    with full_f32_matmul():
        return torch.einsum("...na,...nb->...ab", v, v.conj())


def kraus2chi(kraus_ops) -> torch.Tensor:
    """Kraus -> chi (process) matrix: c_i = c2p |K_i>>, chi = sum c c^dag."""
    k = _stack_kraus(kraus_ops)
    c2p = _basis(k.shape[-1], True, k.dtype, k.device)
    with full_f32_matmul():
        c = torch.einsum("ab,...nb->...na", c2p, vec(k)[..., 0])
        return torch.einsum("...na,...nb->...ab", c, c.conj())


def kraus2pauli_liouville(kraus_ops) -> torch.Tensor:
    """Kraus -> Pauli-Liouville (Pauli transfer matrix)."""
    return superop2pauli_liouville(kraus2superop(kraus_ops))


# ------------------------------------------------------------------ chi -> *

def chi2choi(chi_matrix: torch.Tensor) -> torch.Tensor:
    """chi -> Choi: congruence by the Pauli -> computational transform."""
    p2c = _basis(_dim(chi_matrix), False, chi_matrix.dtype, chi_matrix.device)
    return _congruence(p2c, chi_matrix)


def chi2pauli_liouville(chi_matrix: torch.Tensor) -> torch.Tensor:
    return choi2pauli_liouville(chi2choi(chi_matrix))


def chi2superop(chi_matrix: torch.Tensor) -> torch.Tensor:
    return choi2superop(chi2choi(chi_matrix))


def chi2kraus(chi_matrix: torch.Tensor) -> List[torch.Tensor]:
    """chi -> list of Kraus operators (host-side; see :func:`choi2kraus`)."""
    return choi2kraus(chi2choi(chi_matrix))


# --------------------------------------------------------------- superop -> *

def superop2choi(superop: torch.Tensor) -> torch.Tensor:
    """Superoperator -> Choi (an involution: a swap of tensor factors)."""
    dim = _dim(superop)
    batch = superop.shape[:-2]
    t = superop.reshape(*batch, dim, dim, dim, dim).transpose(-4, -1)
    return t.reshape(*batch, dim * dim, dim * dim)


def superop2pauli_liouville(superop: torch.Tensor) -> torch.Tensor:
    """Superoperator -> Pauli-Liouville: ``c2p @ S @ c2p^dag * dim``."""
    dim = _dim(superop)
    c2p = _basis(dim, True, superop.dtype, superop.device)
    return _congruence(c2p, superop) * dim


def superop2kraus(superop: torch.Tensor) -> List[torch.Tensor]:
    return choi2kraus(superop2choi(superop))


def superop2chi(superop: torch.Tensor) -> torch.Tensor:
    return kraus2chi(torch.stack(superop2kraus(superop), dim=-3))


# ------------------------------------------------------------------ PL -> *

def pauli_liouville2superop(pl_matrix: torch.Tensor) -> torch.Tensor:
    """Pauli-Liouville -> superoperator: ``p2c @ R @ p2c^dag / dim``."""
    dim = _dim(pl_matrix)
    p2c = _basis(dim, False, pl_matrix.dtype, pl_matrix.device)
    return _congruence(p2c, pl_matrix) / dim


def pauli_liouville2choi(pl_matrix: torch.Tensor) -> torch.Tensor:
    return superop2choi(pauli_liouville2superop(pl_matrix))


def pauli_liouville2kraus(pl_matrix: torch.Tensor) -> List[torch.Tensor]:
    return choi2kraus(pauli_liouville2choi(pl_matrix))


def pauli_liouville2chi(pl_matrix: torch.Tensor) -> torch.Tensor:
    return kraus2chi(torch.stack(pauli_liouville2kraus(pl_matrix), dim=-3))


# ------------------------------------------------------------------ choi -> *

def choi2superop(choi: torch.Tensor) -> torch.Tensor:
    """Choi -> superoperator (the involution of :func:`superop2choi`)."""
    return superop2choi(choi)


def choi2pauli_liouville(choi: torch.Tensor) -> torch.Tensor:
    return superop2pauli_liouville(choi2superop(choi))


def choi2chi(choi: torch.Tensor) -> torch.Tensor:
    """Choi -> chi by direct congruence with c2p (equal to the reference's
    round trip through Kraus operators, without the eigendecomposition)."""
    c2p = _basis(_dim(choi), True, choi.dtype, choi.device)
    return _congruence(c2p, choi)


def choi2kraus(choi, tol: Optional[float] = None) -> List[torch.Tensor]:
    """Choi -> list of Kraus operators, dropping eigenvalues with
    |lambda| <= tol.

    Host-side numpy and unbatched (the number of operators depends on the
    data); the operators are computed as in the JAX package and returned
    as tensors on the input's device (the CPU for a numpy input). ``tol``
    defaults to
    the larger of the reference's 1e-9 and ``10 d eps |lambda|_max``: in
    float32, eigh noise on a rank-deficient Choi matrix is ~1e-6 relative,
    so the fixed 1e-9 would keep up to d^2 spurious operators of a unitary
    channel.
    """
    device = choi.device if isinstance(choi, torch.Tensor) else None
    arr = (choi.detach().cpu().resolve_conj().numpy()
           if isinstance(choi, torch.Tensor) else np.asarray(choi))
    if arr.ndim != 2:
        raise ValueError("choi2kraus is host-side and unbatched.")
    eigvals, v = np.linalg.eigh(arr)
    if tol is None:
        tol = max(1e-9, 10 * arr.shape[-1] * np.finfo(eigvals.dtype).eps
                  * float(np.max(np.abs(eigvals), initial=0.0)))
    d = math.isqrt(arr.shape[-1])
    kraus = []
    for lam, evec in zip(eigvals, v.T):
        if abs(lam) > tol:
            # np.lib.scimath.sqrt: a negative eigenvalue gives an imaginary
            # coefficient
            coeff = np.sqrt(lam) if lam >= 0 else 1j * np.sqrt(-lam)
            k = torch.as_tensor(coeff * evec.reshape(d, d).T)  # numpy unvec
            kraus.append(k.to(device) if device is not None else k)
    return kraus
