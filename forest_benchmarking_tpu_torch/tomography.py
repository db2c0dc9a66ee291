"""Process tomography: the batched PGDB/APG maximum-likelihood routes.

Port of the process path of ``forest_benchmarking_tpu/tomography.py``:

- the host-side helpers that build the PGDB A-matrix rows from the Pauli
  process-tomography settings (pure numpy; the six +-X/Y/Z eigenstate
  densities come from the same rotation matrices, applied in the same order,
  as ``observable_estimation._one_q_state_prep`` in the JAX package);
- the per-problem solvers :func:`_pgdb_kernel` (projected gradient with
  backtracking) and :func:`_apg_kernel` (FISTA with function restart), each
  projecting with
  :func:`~forest_benchmarking_tpu_torch.ops.project_superoperators.proj_choi_to_physical`;
- :func:`pgdb_process_estimate_batched`, which routes to them or to the
  fused solver :func:`~forest_benchmarking_tpu_torch.ops.lanes_apg.apg_fused`
  (``method="apg", cp_method="pallas"``).

JAX writes each solver for one problem and batches it with ``vmap`` over
``lax.while_loop``. Here each solver is written batch-first: every loop
runs while any problem is still going and computes only those, so each
problem stops exactly where its own JAX loop stops. Each loop iteration
reads the number of problems still going back to the host (one
synchronization per iteration on the card).

The results-level API (``pgdb_process_estimate``,
``linear_inv_process_estimate``, ``_extract_from_results``) needs the
experiment data model and waits for ROADMAP.md queue 1, item 13.

Conventions: column-stacking vec; the first qubit is the left-most tensor
factor.
"""
from __future__ import annotations

import functools
import itertools
from math import pi
from typing import Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from forest_benchmarking_tpu_torch.ops.calculational import dag
from forest_benchmarking_tpu_torch.ops.lanes_apg import full_f32_matmul
from forest_benchmarking_tpu_torch.ops.project_superoperators import (
    proj_choi_to_physical)
from forest_benchmarking_tpu_torch.ops.superoperator_transformations import (
    unvec, vec)
from forest_benchmarking_tpu_torch.utils import all_traceless_pauli_strings

__all__ = ["state_to_density", "pgdb_a_row_pair",
           "pgdb_process_estimate_batched"]

# The Pauli-eigenstate inputs of process tomography, as (Pauli, index) with
# index 0 the +1 eigenstate: plusX, minusX, plusY, minusY, plusZ, minusZ.
_EIGENSTATES: Tuple[Tuple[str, int], ...] = (
    ("X", 0), ("X", 1), ("Y", 0), ("Y", 1), ("Z", 0), ("Z", 1))


def _rx(theta: float) -> np.ndarray:
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array([[c, -1j * s], [-1j * s, c]], dtype=complex)


def _ry(theta: float) -> np.ndarray:
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array([[c, -s], [s, c]], dtype=complex)


# preparation rotations of each eigenstate from |0>, applied in order
_PREPS = {("X", 0): (_ry(pi / 2),), ("X", 1): (_ry(-pi / 2),),
          ("Y", 0): (_rx(-pi / 2),), ("Y", 1): (_rx(pi / 2),),
          ("Z", 0): (), ("Z", 1): (_rx(pi),)}


def _pauli_process_tomo_settings(n_qubits: int
                                 ) -> Iterator[Tuple[Tuple[Tuple[str, int], ...], str]]:
    """(input eigenstates, observable) pairs: +-XYZ eigenstate inputs on
    every qubit x all non-identity Pauli observables, in the JAX package's
    order."""
    for states in itertools.product(_EIGENSTATES, repeat=n_qubits):
        for obs in all_traceless_pauli_strings(n_qubits):
            yield states, obs


@functools.lru_cache(maxsize=None)
def _oneq_state_density(label: str, index: int) -> np.ndarray:
    """Density matrix of a Pauli eigenstate, from its preparation rotations."""
    psi = np.array([1.0, 0.0], dtype=complex)
    for gate in _PREPS[(label, index)]:
        psi = gate @ psi
    return np.outer(psi, psi.conj())


def state_to_density(states: Sequence[Tuple[str, int]]) -> np.ndarray:
    """Dense density matrix of a tensor product of Pauli eigenstates, given
    as (Pauli, index) per qubit, first qubit = left-most factor."""
    rho = np.array([[1.0 + 0j]])
    for label, index in states:
        rho = np.kron(rho, _oneq_state_density(label, index))
    return rho


def pgdb_a_row_pair(in_mat: np.ndarray, op: np.ndarray,
                    eye: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(+ row, - row) of the PGDB A-matrix (eq. A1 of [PGD]) for one
    (input state, coefficient-1 observable) setting, column-stacking vec."""
    proj_plus = (eye + op) / 2
    proj_minus = (eye - op) / 2
    return (np.kron(in_mat, proj_plus.T).T.reshape(-1),
            np.kron(in_mat, proj_minus.T).T.reshape(-1))


def _mle_cost_grad(a: torch.Tensor):
    """(cost, grad_cost) of the negative log-likelihood -sum n log(A vec E)
    for (B, d^2, d^2) estimates E and (B, R) counts n: the shared core of
    the PGDB and APG solvers. The products run in full float32 (the line
    search and restart rules compare small cost differences)."""
    cdtype = a.dtype

    def probs(est):
        with full_f32_matmul():
            p = (vec(est)[..., 0] @ a.T).real
        return p.clamp(min=1e-6)

    def cost(est, n):
        return -(n * torch.log(probs(est))).sum(-1)

    def grad_cost(est, n):
        eta = (n / probs(est)).to(cdtype)
        with full_f32_matmul():
            return unvec(-(eta @ a.conj()))

    return cost, grad_cost


def _warm_start_choi(a: torch.Tensor, n: torch.Tensor, dim: int, proj):
    """The projection ``proj`` of the rescaled linear-inversion estimates
    unvec(pinv(A) n): the warm start of both solvers. pinv(A) is computed
    once for the batch."""
    cdtype = a.dtype
    with full_f32_matmul():
        rho0 = unvec(n.to(cdtype) @ torch.linalg.pinv(a).T)
    rho0 = (rho0 + dag(rho0)) / 2
    tr = torch.diagonal(rho0, dim1=-2, dim2=-1).sum(-1).real
    scale = dim / torch.where(tr.abs() < 1e-12, 1.0, tr)
    return proj(rho0 * scale.to(cdtype)[:, None, None])


def _start(a: torch.Tensor, n: torch.Tensor, dim: int, proj, warm_start: bool):
    if warm_start:
        return _warm_start_choi(a, n, dim, proj)
    d2 = dim * dim
    eye = torch.eye(d2, dtype=a.dtype, device=a.device) / dim
    return eye.expand(n.shape[0], d2, d2).clone()


def _backtrack(cost, est, update, gradient, old_cost, n, gamma: float):
    """Per-problem backtracking line search of PGDB: halve the step while
    the cost exceeds the Armijo line and the step is at least 1e-15.
    Returns (alpha, new_cost)."""
    change = gamma * (update.conj() * gradient).sum(dim=(-2, -1)).real
    new_cost = cost(est + update, n)
    alpha = torch.ones_like(old_cost)
    going = torch.nonzero((new_cost > old_cost + change)
                          & (alpha >= 1e-15)).squeeze(1)
    while going.numel():
        alpha[going] = 0.5 * alpha[going]
        change[going] = 0.5 * change[going]
        new_cost[going] = cost(est[going] + alpha[going, None, None]
                               * update[going], n[going])
        going = going[(new_cost[going] > old_cost[going] + change[going])
                      & (alpha[going] >= 1e-15)]
    return alpha, new_cost


def _pgdb_kernel(a: torch.Tensor, n: torch.Tensor, dim: int,
                 trace_preserving: bool, stop_tol: float, maxiter: int,
                 dyk_tol: float, dyk_iters: int, cp_method: str = "eigh",
                 ns_iters: int = 24, warm_start: bool = False):
    """Projected gradient descent with backtracking [PGD], batch-first.

    Starts from I/d (or, with ``warm_start``, from the CPTP projection of
    the linear-inversion estimate), steps by 1/mu = 2 d^2 / 3 into the
    Dykstra projection, backtracks with gamma = 0.3, and stops a problem
    once its cost decrease falls below ``stop_tol`` or after ``maxiter``
    iterations. Returns (estimates (B, d^2, d^2), iterations (B,))."""
    cost, grad_cost = _mle_cost_grad(a)
    n = n.to(a.real.dtype)
    mu = 3.0 / (2 * dim ** 2)
    gamma = 0.3
    proj = functools.partial(
        proj_choi_to_physical, make_trace_preserving=trace_preserving,
        tol=dyk_tol, max_iters=dyk_iters, cp_method=cp_method,
        ns_iters=ns_iters)
    est = _start(a, n, dim, proj, warm_start)
    old_cost = cost(est, n)
    its = torch.zeros(n.shape[0], dtype=torch.int32, device=n.device)
    active = torch.arange(n.shape[0] if maxiter > 0 else 0, device=n.device)
    while active.numel():
        e, nn, oc = est[active], n[active], old_cost[active]
        gradient = grad_cost(e, nn)
        update = proj(e - gradient / mu) - e
        alpha, new_cost = _backtrack(cost, e, update, gradient, oc, nn, gamma)
        est[active] = e + alpha.to(e.dtype)[:, None, None] * update
        old_cost[active] = new_cost
        its[active] += 1
        active = active[(oc - new_cost >= stop_tol) & (its[active] < maxiter)]
    return est, its


def _apg_kernel(a: torch.Tensor, n: torch.Tensor, dim: int,
                trace_preserving: bool, stop_tol: float, maxiter: int,
                dyk_tol: float, dyk_iters: int, cp_method: str = "eigh",
                ns_iters: int = 24, loop_dyk_iters: Optional[int] = None,
                warm_start: bool = False):
    """Accelerated projected gradient (FISTA with O'Donoghue-Candes function
    restart) [APG-QPT], batch-first.

    Same cost, gradient and projection as PGDB, with Nesterov momentum and
    the fixed step 1/mu = 2 d^2 / 3, no backtracking. A problem stops once
    |cost decrease| falls below ``stop_tol`` or after ``maxiter`` steps.
    ``loop_dyk_iters`` caps the Dykstra loop inside the descent (inexact
    proximal steps); the result then gets one final projection at the full
    ``dyk_iters``/``dyk_tol``. Returns (estimates (B, d^2, d^2),
    iterations (B,))."""
    cost, grad_cost = _mle_cost_grad(a)
    n = n.to(a.real.dtype)
    mu = 3.0 / (2 * dim ** 2)
    proj_full = functools.partial(
        proj_choi_to_physical, make_trace_preserving=trace_preserving,
        tol=dyk_tol, max_iters=dyk_iters, cp_method=cp_method,
        ns_iters=ns_iters)
    proj = (proj_full if loop_dyk_iters is None else
            functools.partial(proj_full, max_iters=loop_dyk_iters))
    est = _start(a, n, dim, proj, warm_start)
    prev = est.clone()
    t = torch.ones(n.shape[0], dtype=n.dtype, device=n.device)
    old_cost = cost(est, n)
    its = torch.zeros(n.shape[0], dtype=torch.int32, device=n.device)
    active = torch.arange(n.shape[0] if maxiter > 0 else 0, device=n.device)
    while active.numel():
        e, ep, tk, oc = est[active], prev[active], t[active], old_cost[active]
        t_next = (1 + torch.sqrt(1 + 4 * tk * tk)) / 2
        beta = ((tk - 1) / t_next).to(e.dtype)[:, None, None]
        y = e + beta * (e - ep)
        cand = proj(y - grad_cost(y, n[active]) / mu)
        new_cost = cost(cand, n[active])
        t[active] = torch.where(new_cost > oc, 1.0, t_next)
        prev[active], est[active] = e, cand
        old_cost[active] = new_cost
        its[active] += 1
        active = active[((oc - new_cost).abs() >= stop_tol)
                        & (its[active] < maxiter)]
    if loop_dyk_iters is not None:
        est = proj_full(est)
    return est, its


def pgdb_process_estimate_batched(a: torch.Tensor, n: torch.Tensor, dim: int,
                                  trace_preserving: bool = True,
                                  stop_tol: float = 1e-10, maxiter: int = 1000,
                                  dyk_tol: float = 1e-4,
                                  dyk_iters: int = 1000,
                                  cp_method: str = "eigh",
                                  ns_iters: int = 24,
                                  method: str = "pgdb",
                                  loop_dyk_iters: Optional[int] = None,
                                  warm_start: bool = False,
                                  return_iters: bool = False,
                                  fused_schedule: str = "parity"
                                  ) -> Union[torch.Tensor,
                                             Tuple[torch.Tensor, torch.Tensor]]:
    """Batched PGDB: (R, d^4) shared A-matrix, (B, R) counts -> (B, d^2, d^2).

    Routes and arguments as the JAX function's; the computation runs where
    ``a`` and ``n`` lie.

    - ``method="pgdb"`` (default): projected gradient with backtracking
      (:func:`_pgdb_kernel`); ``method="apg"``: FISTA with function restart
      (:func:`_apg_kernel`). Both project with Dykstra
      (``dyk_tol``/``dyk_iters``), whose CP step is ``cp_method="eigh"``
      (exact, ``torch.linalg.eigh``) or ``"ns"`` (Newton-Schulz,
      ``ns_iters``), and stop per problem (``stop_tol``/``maxiter``).
      ``warm_start`` starts from the projected linear-inversion estimate;
      ``loop_dyk_iters`` (APG only) caps the Dykstra loop inside the descent;
      ``return_iters`` (APG only) also returns the (B,) iteration counts.
    - ``cp_method="pallas"`` (with ``method="apg"``) selects the fused solver
      :func:`~forest_benchmarking_tpu_torch.ops.lanes_apg.apg_fused`: the CUDA
      kernel for tensors on the card, its plain PyTorch version on the CPU.
      Its schedule is static, so ``stop_tol``, ``maxiter``, ``dyk_*``,
      ``ns_iters``, ``warm_start`` and ``loop_dyk_iters`` do not apply and
      are ignored, as in the JAX package. ``fused_schedule`` picks
      ``"parity"`` (strict <1e-6 f64 deviation from the converged optimum)
      or ``"headline"`` (statistical equivalence); the tuned schedules are
      for dim=4, and other dims run the default parity schedule.
    """
    if cp_method == "pallas":
        if method != "apg":
            raise ValueError("cp_method='pallas' requires method='apg'")
        if not trace_preserving:
            raise ValueError("cp_method='pallas' implements the CPTP "
                             "projection only (trace_preserving=True)")
        if return_iters:
            raise ValueError("return_iters is not available for the fused "
                             "solver (its iteration schedule is static)")
        if fused_schedule not in ("parity", "headline"):
            raise ValueError(f"Unknown fused_schedule '{fused_schedule}'")
        from forest_benchmarking_tpu_torch.ops.lanes_apg import (
            apg_fused, PARITY_TUNED_2Q, HEADLINE_TUNED_2Q)
        if dim == 4:
            cfg = (PARITY_TUNED_2Q if fused_schedule == "parity"
                   else HEADLINE_TUNED_2Q)
            return apg_fused(a, n, dim=dim, **cfg)
        if fused_schedule != "parity":
            raise ValueError(
                f"fused_schedule='{fused_schedule}' is only tuned/validated "
                f"for dim=4 (2Q); dim={dim} runs the conservative default "
                f"schedule — pass fused_schedule='parity' explicitly")
        return apg_fused(a, n, dim=dim)
    if loop_dyk_iters is not None and loop_dyk_iters < 1:
        raise ValueError(f"loop_dyk_iters must be >= 1, got {loop_dyk_iters}")
    if cp_method not in ("eigh", "ns"):
        raise ValueError(f"Unknown cp_method '{cp_method}'")
    if n.device != a.device:
        raise ValueError(f"counts on {n.device} but A on {a.device}")
    args = (a, n, dim, trace_preserving, stop_tol, maxiter, dyk_tol,
            dyk_iters, cp_method, ns_iters)
    if method == "pgdb":
        if loop_dyk_iters is not None:
            raise ValueError("loop_dyk_iters is only supported with "
                             "method='apg' (PGDB keeps the reference's exact "
                             "in-loop projections)")
        if return_iters:
            raise ValueError("return_iters requires method='apg'")
        return _pgdb_kernel(*args, warm_start=warm_start)[0]
    if method != "apg":
        raise ValueError(f"Unknown method '{method}'")
    est, iters = _apg_kernel(*args, loop_dyk_iters=loop_dyk_iters,
                             warm_start=warm_start)
    return (est, iters) if return_iters else est
