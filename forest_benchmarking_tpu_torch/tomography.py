"""State and process tomography: the experiments, the results-level
estimators, ``do_tomography``, and the batched array-level routes.

Port of ``forest_benchmarking_tpu/tomography.py``, with its public names:

- experiments: :func:`generate_state_tomography_experiment` and
  :func:`generate_process_tomography_experiment` (Pauli or SIC inputs),
  over the data model of :mod:`.observable_estimation`;
- the results level, which takes a list of ``ExperimentResult``:
  :func:`linear_inv_state_estimate`, :func:`iterative_mle_state_estimate`,
  :func:`state_log_likelihood`, :func:`estimate_variance`,
  :func:`linear_inv_process_estimate`, :func:`pgdb_process_estimate` and
  :func:`do_tomography`, which acquires the data on the port's QVM and
  estimates where the QVM runs. The host-side bridges
  (:func:`state_to_density`, ``_extract_from_results``) are numpy; the
  estimators run in complex128 on ``device``, the card by default;
- state tomography at the array level:
  :func:`iterative_mle_state_estimate_batched` with its two routes, the
  general diluted-MLE loop :func:`_mle_general_batched` (with the MaxEnt
  and hedged variants and the projected linear-inversion warm start) and
  the closed-form one-qubit update on Bloch vectors
  :func:`_mle_bloch_kernel`; and ``bloch_to_density``,
  ``mle_bloch_flops_per_solve`` and ``_is_xyz_pauli_stack``;
- process tomography at the array level: the per-problem solvers
  :func:`_pgdb_kernel` (projected gradient with backtracking) and
  :func:`_apg_kernel` (FISTA with function restart), each projecting with
  :func:`~forest_benchmarking_tpu_torch.ops.project_superoperators.proj_choi_to_physical`;
  and :func:`pgdb_process_estimate_batched`, which routes to them or to the
  fused solver :func:`~forest_benchmarking_tpu_torch.ops.lanes_apg.apg_fused`
  (``method="apg", cp_method="pallas"``).

JAX writes each iterative solver for one problem and batches it with
``vmap`` over ``lax.while_loop``. Here each is written batch-first: every
loop runs while any problem is still going and computes only those, so each
problem stops exactly where its own JAX loop stops. Each loop iteration
reads the number of problems still going back to the host (one
synchronization per iteration on the card). The Bloch update instead runs
the whole batch and freezes the problems that have converged, reading
whether any is still going once per chunk of eight iterations.

Conventions: column-stacking vec; the first qubit is the left-most tensor
factor.
"""
from __future__ import annotations

import functools
import itertools
import math
from operator import mul
from typing import (Callable, Iterator, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from forest_benchmarking_tpu_torch import distance_measures as dm
from forest_benchmarking_tpu_torch.circuits import Circuit
from forest_benchmarking_tpu_torch.observable_estimation import (
    ExperimentResult, ExperimentSetting, ObservablesExperiment,
    TensorProductState, _OneQState, SIC0, SIC1, SIC2, SIC3, plusX, minusX,
    plusY, minusY, plusZ, minusZ, zeros_state, group_settings,
    estimate_observables, calibrate_observable_estimates, _one_q_state_prep)
from forest_benchmarking_tpu_torch.ops.calculational import dag, pinv
from forest_benchmarking_tpu_torch.ops.lanes_apg import full_f32_matmul
from forest_benchmarking_tpu_torch.ops.project_state_matrix import (
    project_state_matrix_to_physical)
from forest_benchmarking_tpu_torch.ops.project_superoperators import (
    proj_choi_to_physical)
from forest_benchmarking_tpu_torch.ops.superoperator_transformations import (
    unvec, vec)
from forest_benchmarking_tpu_torch.paulis import (
    all_traceless_pauli_terms, pauli_term_to_matrix)
from forest_benchmarking_tpu_torch.utils import (
    entry_device, pauli_basis_matrices)

__all__ = [
    "generate_state_tomography_experiment", "generate_process_tomography_experiment",
    "state_to_density", "linear_inv_state_estimate", "iterative_mle_state_estimate",
    "iterative_mle_state_estimate_batched", "state_log_likelihood",
    "estimate_variance", "linear_inv_process_estimate", "pgdb_process_estimate",
    "pgdb_process_estimate_batched", "do_tomography", "FRO",
    "bloch_to_density", "mle_bloch_flops_per_solve", "pgdb_a_row_pair",
]

MAXITER = "maxiter"
OPTIMAL = "optimal"
FRO = "fro"  # Frobenius-norm ord string


# ======================================================================
# Experiment generation
# ======================================================================

def _state_tomo_settings(qubits: Sequence[int]) -> Iterator[ExperimentSetting]:
    """Settings over every non-identity Pauli observable on the qubits."""
    for obs in all_traceless_pauli_terms(qubits):
        yield ExperimentSetting(in_state=zeros_state(qubits), observable=obs)


def generate_state_tomography_experiment(program: Circuit, qubits: List[int]) \
        -> ObservablesExperiment:
    """Experiment characterizing the state prepared by ``program``."""
    return ObservablesExperiment(settings=list(_state_tomo_settings(qubits)),
                                 program=program)


def _sic_process_tomo_settings(qubits: Sequence[int]) -> Iterator[ExperimentSetting]:
    """SIC-basis input states x all non-identity Pauli observables."""
    for in_sics in itertools.product([SIC0, SIC1, SIC2, SIC3], repeat=len(qubits)):
        i_state = functools.reduce(mul, (state(q) for state, q in zip(in_sics, qubits)),
                                   TensorProductState())
        for obs in all_traceless_pauli_terms(qubits):
            yield ExperimentSetting(in_state=i_state, observable=obs)


def _pauli_process_tomo_settings(qubits: Sequence[int]) -> Iterator[ExperimentSetting]:
    """+-XYZ eigenstate inputs x all non-identity Pauli observables."""
    for states in itertools.product([plusX, minusX, plusY, minusY, plusZ, minusZ],
                                    repeat=len(qubits)):
        i_state = functools.reduce(mul, (state(q) for state, q in zip(states, qubits)),
                                   TensorProductState())
        for obs in all_traceless_pauli_terms(qubits):
            yield ExperimentSetting(in_state=i_state, observable=obs)


def generate_process_tomography_experiment(program: Circuit, qubits: List[int],
                                           in_basis: str = "pauli") \
        -> ObservablesExperiment:
    """Experiment characterizing the process enacted by ``program``."""
    if in_basis.upper() == "SIC":
        func = _sic_process_tomo_settings
    elif in_basis.upper() == "PAULI":
        func = _pauli_process_tomo_settings
    else:
        raise ValueError(f"Unknown basis {in_basis}")
    return ObservablesExperiment(settings=list(func(qubits)), program=program)


# ======================================================================
# Host-side bridges: settings -> dense arrays
# ======================================================================

@functools.lru_cache(maxsize=None)
def _oneq_state_density(label: str, index: int) -> np.ndarray:
    """Density matrix of a named one-qubit state, from its own prep
    circuit (numpy)."""
    prep = _one_q_state_prep(_OneQState(label, index, 0))
    psi = np.array([1.0, 0.0], dtype=complex)
    for gate in prep.gates:
        psi = gate.get_matrix() @ psi
    return np.outer(psi, psi.conj())


def state_to_density(tps: TensorProductState, qubits: Sequence[int]) -> np.ndarray:
    """Dense density matrix of a TensorProductState on the given qubit order.

    Qubits not named in the state default to |0><0|. The matrices come from
    the prep circuits themselves, so the data model and the estimators
    cannot disagree on conventions.
    """
    named = {s.qubit: s for s in tps.states}
    rho = np.array([[1.0 + 0j]])
    for q in qubits:
        if q in named:
            s = named[q]
            rho = np.kron(rho, _oneq_state_density(s.label, s.index))
        else:
            rho = np.kron(rho, np.array([[1, 0], [0, 0]], dtype=complex))
    return rho


def _results_to_state_arrays(results: List[ExperimentResult], qubits: List[int]):
    obs_mats = np.stack([
        pauli_term_to_matrix(r.setting.observable.copy(coefficient=1.0), qubits)
        for r in results])
    coeffs = np.array([np.real(complex(r.setting.observable.coefficient))
                       for r in results])
    expectations = np.array([r.expectation for r in results], dtype=float) / \
        np.where(coeffs == 0, 1.0, coeffs)
    counts = np.array([r.total_counts for r in results])
    return obs_mats, expectations, counts


def _pinv_solve(rows: np.ndarray, values: np.ndarray, dim: int,
                device) -> torch.Tensor:
    """unvec(pinv(rows) values) + I/dim on the entry point's device, in
    complex128: the linear-inversion estimate with the traceful identity
    part added back."""
    dev = entry_device(device)
    m = torch.tensor(rows, dtype=torch.complex128, device=dev)
    v = torch.tensor(values, dtype=torch.complex128, device=dev)
    est = unvec(torch.linalg.pinv(m) @ v)
    return est + torch.eye(est.shape[-1], dtype=est.dtype, device=dev) / dim


def _logm_psd(rho: torch.Tensor) -> torch.Tensor:
    """Matrix log of a Hermitian PSD matrix via eigh (tiny eigenvalues
    clamped)."""
    w, v = torch.linalg.eigh(rho)
    w = w.clamp(min=torch.finfo(w.dtype).tiny)
    return (v * torch.log(w)[..., None, :].to(v.dtype)) @ dag(v)


def _trace(m: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)[..., None, None]


def _mle_general_batched(obs_mats: torch.Tensor, expectations: torch.Tensor,
                         num_meas: torch.Tensor, epsilon: float,
                         entropy_penalty: float, beta: float, tol: float,
                         maxiter: int, warm_start: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Diluted iterative MLE [DIMLE1], batch-first: (S, d, d) shared
    observables, (B, S) expectations, (B,) shot totals (read only by the
    hedged variant) -> ((B, d, d) estimates, (B,) iterations).

    The JAX package's per-problem ``_mle_kernel`` update: R(rho) from the
    plus/minus projector decomposition of each Pauli, T = R - I with the
    optional MaxEnt [DIMLE2] (``entropy_penalty``) or hedging [HMLE]
    (``beta``) terms, rho <- U rho U / tr with U = I + epsilon T, until the
    Frobenius change falls below ``tol`` or after ``maxiter`` steps, each
    problem on its own. ``warm_start`` starts from the physical projection
    of the linear-inversion estimate (I + sum_s e_s P_s)/d instead of I/d,
    valid when ``obs_mats`` is the full traceless Pauli basis. The dtype is
    that of ``obs_mats``; the products run in full float32 on the card.
    """
    s, d = obs_mats.shape[0], obs_mats.shape[-1]
    cdtype = obs_mats.dtype
    feps = torch.tensor(torch.finfo(cdtype).eps, dtype=cdtype,
                        device=obs_mats.device)
    eye = torch.eye(d, dtype=cdtype, device=obs_mats.device)
    e = expectations.to(cdtype)
    e_plus, e_minus = 1 + e, 1 - e
    b = e.shape[0]
    # tr(P_s rho) = sum_ij rho_ij (P_s)_ji: the predictions are a product
    # of the row-major flattenings of rho and of each P_s^T
    obs_flat = obs_mats.reshape(s, d * d)
    obs_pred = obs_mats.transpose(-1, -2).reshape(s, d * d).T.contiguous()

    def compute_r(rho, e_plus, e_minus):
        pred = rho.reshape(-1, d * d) @ obs_pred
        # the predicted-outcome denominators are clamped to eps, not tiny: a
        # projected (rank-deficient) rho can predict 0 exactly where the
        # measured frequency is positive
        dp, dm = 1 + pred, 1 - pred
        dp = torch.where(dp.abs() < feps.real, feps, dp)
        dm = torch.where(dm.abs() < feps.real, feps, dm)
        cp = e_plus / dp
        cm = e_minus / dm
        id_coef = (cp + cm).sum(-1) / 2
        p_coef = (cp - cm) / 2
        return (id_coef[:, None, None] * eye
                + (p_coef @ obs_flat).reshape(-1, d, d)) / s

    with full_f32_matmul():
        if warm_start:
            rho_lin = (eye + (e @ obs_flat).reshape(b, d, d)) / d
            rho = project_state_matrix_to_physical((rho_lin + dag(rho_lin))
                                                   / 2)
        else:
            rho = (eye / d).expand(b, d, d).clone()
        its = torch.zeros(b, dtype=torch.int32, device=e.device)
        active = torch.arange(b if maxiter > 0 else 0, device=e.device)
        while active.numel():
            r = rho[active]
            tk = compute_r(r, e_plus[active], e_minus[active]) - eye
            if entropy_penalty > 0.0:
                lg = _logm_psd(r)
                tk = tk - entropy_penalty * (lg - eye * _trace(r @ lg))
            if beta > 0.0:
                tk = tk * (num_meas[active] / 2)[:, None, None]
                tk = tk + beta * (pinv(r) - d * eye) / 2
            update_map = eye + epsilon * tk
            new = update_map @ r @ update_map
            new = new / _trace(new)
            diff = torch.linalg.matrix_norm(new - r)
            rho[active] = new
            its[active] += 1
            active = active[(diff >= tol) & (its[active] < maxiter)]
    return rho, its


BLOCH_CHUNK = 8  # Bloch-MLE steps between two host reads of the stop test


def _mle_bloch_kernel(e: torch.Tensor, epsilon: float, tol: float,
                      maxiter: int, warm_start: bool
                      ) -> Tuple[torch.Tensor, int]:
    """One-qubit diluted MLE in the Bloch representation, whole batch at
    once: (B, 3) expectations of X, Y, Z -> ((B, 3) Bloch vectors, steps
    run).

    The same update as :func:`_mle_general_batched` for
    ``obs_mats = [X, Y, Z]`` without MaxEnt or hedging: with
    rho = (I + r.sigma)/2 and U = u0 I + u.sigma it is the real closed form

        r' = [(u0^2 - |u|^2) r + 2 u (u0 + u.r)] / [(u0^2 + |u|^2) + 2 u0 (u.r)],

    elementwise arithmetic on a (3, B) tensor, one plane per component.
    Problems freeze once their change |dr|/sqrt(2) (the Frobenius change of
    rho) falls below ``tol``, and no step runs past ``maxiter``, so the
    result does not depend on how often the loop reads whether any problem
    is still going: once per :data:`BLOCH_CHUNK` steps, one host
    synchronization each on the card.
    """
    feps = torch.finfo(e.dtype).eps
    sqrt2 = math.sqrt(2.0)
    ev = e.T.contiguous()
    if warm_start:
        # the physical projection of the linear-inversion estimate: the 2x2
        # eigenvalues are (1 +/- |e|)/2, so waterfilling clips to the
        # closest point of the unit ball along e
        sq = ev * ev
        r = ev * (1 / torch.sqrt(sq[0] + sq[1] + sq[2]).clamp(min=1.0))
    else:
        r = torch.zeros_like(ev)
    ep, em = 1 + ev, 1 - ev
    diff = torch.full(ev.shape[1:], math.inf, dtype=e.dtype, device=e.device)
    it, going = 0, ev.shape[1] > 0
    while going and it < maxiter:
        for _ in range(min(BLOCH_CHUNK, maxiter - it)):
            dp, dm = 1 + r, 1 - r
            dp = torch.where(dp.abs() < feps, feps, dp)
            dm = torch.where(dm.abs() < feps, feps, dm)
            cp, cm = ep / dp, em / dm
            sc, bc = cp + cm, (cp - cm) / 6
            u0 = 1 + epsilon * ((sc[0] + sc[1] + sc[2]) / 6 - 1)
            u = epsilon * bc
            uu, ur = u * u, u * r
            uu = uu[0] + uu[1] + uu[2]
            ur = ur[0] + ur[1] + ur[2]
            cr = u0 * u0 - uu
            cu = 2 * (u0 + ur)
            den = (u0 * u0 + uu) + 2 * u0 * ur
            new = (cr * r + u * cu) / den
            dd = new - r
            dd = dd * dd
            step = torch.sqrt(dd[0] + dd[1] + dd[2]) / sqrt2
            active = diff >= tol
            r = torch.where(active, new, r)
            diff = torch.where(active, step, diff)
            it += 1
        going = bool((diff >= tol).any())
    return r.T, it


def bloch_to_density(r: torch.Tensor, cdtype=None) -> torch.Tensor:
    """(..., 3) Bloch vectors -> (..., 2, 2) density matrices (I + r.sigma)/2."""
    if cdtype is None:
        cdtype = (torch.complex128 if r.dtype == torch.float64
                  else torch.complex64)
    x, y, z = r.unbind(-1)
    zero = torch.zeros_like(x)
    re = torch.stack([torch.stack([1 + z, x], -1),
                      torch.stack([x, 1 - z], -1)], -2)
    im = torch.stack([torch.stack([zero, -y], -1),
                      torch.stack([y, zero], -1)], -2)
    return (torch.complex(re, im) / 2).to(cdtype)


def mle_bloch_flops_per_solve(maxiter: int) -> int:
    """Real-arithmetic FLOPs per problem of :func:`_mle_bloch_kernel` at its
    iteration cap (counting a division as one): ~57 a step + 11 for the
    warm start."""
    return 57 * maxiter + 11


def _is_xyz_pauli_stack(obs_mats) -> bool:
    """True when ``obs_mats`` (a numpy array or a tensor on any device) is
    a (3, 2, 2) stack equal to [X, Y, Z]. The JAX package answers False for
    tracers and accelerator arrays, whose complex values it cannot fetch on
    every backend; here the values are compared wherever they lie."""
    if isinstance(obs_mats, torch.Tensor):
        obs_mats = obs_mats.detach().resolve_conj().cpu().numpy()
    elif not isinstance(obs_mats, np.ndarray):
        return False
    if obs_mats.shape != (3, 2, 2):
        return False
    return bool(np.allclose(obs_mats, pauli_basis_matrices(1)[1:],
                            atol=1e-12))


def iterative_mle_state_estimate_batched(obs_mats, expectations, num_meas,
                                         epsilon: float = 0.1,
                                         entropy_penalty: float = 0.0,
                                         beta: float = 0.0, tol: float = 1e-9,
                                         maxiter: int = 10_000,
                                         warm_start: bool = False,
                                         method: str = "auto",
                                         representation: str = "density",
                                         device=None) -> torch.Tensor:
    """Batched diluted MLE of states.

    :param obs_mats: (S, d, d) shared observables.
    :param expectations: (B, S) measured expectations per problem.
    :param num_meas: (B,) total shot counts (read only by the hedged
        variant).
    :param warm_start: start from the projected linear-inversion estimate
        (``obs_mats`` must be the full traceless Pauli basis); the same fixed
        point in far fewer iterations.
    :param method: ``"auto"`` sends plain-DIMLE one-qubit problems
        (``obs_mats`` equal to [X, Y, Z], no MaxEnt or hedging) to the Bloch
        update :func:`_mle_bloch_kernel`; ``"bloch"`` forces it (and raises
        where it does not apply); ``"general"`` forces
        :func:`_mle_general_batched`.
    :param representation: ``"density"`` returns (B, d, d) complex density
        matrices; ``"bloch"`` the (B, 3) real Bloch vectors
        (rho = (I + r.sigma)/2), on the Bloch route only.
    :param device: where numpy or list inputs run, the card by default
        (without a card, pass ``device="cpu"``); tensor inputs run where
        ``expectations`` (or, failing that, ``obs_mats``) lies.
    :return: (B, d, d) density matrices or (B, 3) Bloch vectors, each
        problem converged on its own.
    """
    eligible = (entropy_penalty == 0.0 and beta == 0.0
                and _is_xyz_pauli_stack(obs_mats))
    if method == "bloch" and not eligible:
        raise ValueError(
            "method='bloch' requires obs_mats == [X, Y, Z] and "
            "entropy_penalty == beta == 0")
    if method not in ("auto", "bloch", "general"):
        raise ValueError(f"unknown method {method!r}")
    if representation not in ("density", "bloch"):
        raise ValueError(f"unknown representation {representation!r}")
    dev = entry_device(device, expectations, obs_mats, num_meas)
    obs = torch.as_tensor(obs_mats, device=dev)
    e = torch.as_tensor(expectations, device=dev)
    if method != "general" and eligible:
        r, _ = _mle_bloch_kernel(e.real if e.is_complex() else e, epsilon,
                                 tol, maxiter, warm_start)
        if representation == "bloch":
            return r
        return bloch_to_density(r, torch.promote_types(obs.dtype, r.dtype))
    if representation == "bloch":
        raise ValueError("representation='bloch' requires the Bloch route "
                         "(method != 'general' and obs_mats == [X, Y, Z] "
                         "with entropy_penalty == beta == 0)")
    return _mle_general_batched(
        obs, e, torch.as_tensor(num_meas, device=dev), epsilon,
        entropy_penalty, beta, tol, maxiter, warm_start)[0]


def linear_inv_state_estimate(results: List[ExperimentResult],
                              qubits: List[int], device=None) -> torch.Tensor:
    """Linear-inversion state estimate (pinv of the measurement matrix)
    [WOOD], complex128 on ``device`` (the card by default). The traceful
    identity component is fixed to 1/dim and added back at the end."""
    obs_mats, expectations, _ = _results_to_state_arrays(results, qubits)
    dim = 2 ** len(qubits)
    measurement_matrix = np.conj(
        np.swapaxes(obs_mats, -1, -2).reshape(len(results), dim * dim))
    return _pinv_solve(measurement_matrix, expectations, dim, device)


def iterative_mle_state_estimate(results: List[ExperimentResult], qubits: List[int],
                                 epsilon: float = 0.1, entropy_penalty: float = 0.0,
                                 beta: float = 0.0, tol: float = 1e-9,
                                 maxiter: int = 10_000,
                                 device=None) -> torch.Tensor:
    """Diluted iterative MLE state estimate [DIMLE1], with optional MaxEnt
    [DIMLE2] (``entropy_penalty``) or hedging [HMLE/IHMLE] (``beta``)
    variants: :func:`_mle_general_batched` on one problem, complex128 on
    ``device`` (the card by default)."""
    if entropy_penalty != 0.0 and beta != 0.0:
        raise ValueError("One can't sensibly do entropy penalty and hedging. "
                         "Do one or the other but not both.")
    obs_mats, expectations, counts = _results_to_state_arrays(results, qubits)
    dev = entry_device(device)
    rho, _ = _mle_general_batched(
        torch.tensor(obs_mats, device=dev),
        torch.tensor(expectations, device=dev)[None],
        torch.tensor([float(np.sum(counts))], device=dev), epsilon,
        entropy_penalty, beta, tol, maxiter, warm_start=False)
    return rho[0]


def _to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def state_log_likelihood(state, results: Iterator[ExperimentResult],
                         qubits: Sequence[int]) -> float:
    """log10-likelihood of the data given ``state`` (eq. 2 of [DIMLE1]);
    host numpy."""
    results = list(results)
    obs_mats, expectations, counts = _results_to_state_arrays(results, list(qubits))
    pred = np.real(np.einsum("sij,ji->s", obs_mats, _to_numpy(state)))
    ll = 0.0
    for n, e, p in zip(counts, expectations, pred):
        for sign in (1, -1):
            f_j = n * (1 + sign * e) / 2
            pr_j = (1 + sign * p) / 2
            if pr_j <= 0:
                continue
            ll += f_j * np.log10(pr_j)
    return ll


def _resample_expectations_with_beta(results, prior_counts: int = 1,
                                     rng: Optional[np.random.RandomState] = None):
    """Resample each expectation from a beta posterior (additive smoothing)."""
    if rng is None:
        rng = np.random
    resampled = []
    for res in results:
        num_plus = ((res.expectation + 1) / 2) * res.total_counts
        num_minus = res.total_counts - num_plus
        alpha = num_plus + prior_counts
        b = num_minus + prior_counts
        resampled.append(ExperimentResult(
            setting=res.setting,
            expectation=2 * rng.beta(alpha, b) - 1,
            std_err=res.std_err,
            total_counts=res.total_counts))
    return resampled


def estimate_variance(results: List[ExperimentResult], qubits: List[int],
                      tomo_estimator: Callable, functional: Callable,
                      target_state=None, n_resamples: int = 40,
                      project_to_physical: bool = False,
                      rng: Optional[np.random.RandomState] = None) \
        -> Tuple[float, float]:
    """Bootstrap (mean, variance) of a functional of the estimated state.
    The resampling draws from ``rng`` (numpy), as in the JAX package; the
    estimates and the functional run where ``tomo_estimator`` puts them,
    and ``target_state`` is moved there."""
    if functional != dm.purity and target_state is None:
        raise ValueError("You're not using the `purity` functional. "
                         "Please specify a target state.")
    sample_estimate = []
    for _ in range(n_resamples):
        resampled = _resample_expectations_with_beta(results, rng=rng)
        rho = tomo_estimator(resampled, qubits)
        if project_to_physical:
            rho = project_state_matrix_to_physical(rho)
        if functional == dm.purity:
            sample_estimate.append(float(dm.purity(rho, dim_renorm=False).real))
        else:
            target = torch.as_tensor(target_state, dtype=rho.dtype,
                                     device=rho.device)
            sample_estimate.append(float(functional(target, rho).real))
    return float(np.mean(sample_estimate)), float(np.var(sample_estimate))


def linear_inv_process_estimate(results: List[ExperimentResult],
                                qubits: List[int], device=None) -> torch.Tensor:
    """Linear-inversion process estimate; returns a Choi matrix [WOOD],
    complex128 on ``device`` (the card by default)."""
    dim = 2 ** len(qubits)
    rows = []
    expectations = []
    for r in results:
        in_mat = state_to_density(r.setting.in_state, qubits)
        op = pauli_term_to_matrix(r.setting.observable.copy(coefficient=1.0), qubits)
        rows.append(np.kron(in_mat.conj(), op).T.reshape(-1).conj())  # vec()^dag
        # expectations are coeff * <P>; the row is built from the
        # coefficient-1 operator, so divide the coefficient out
        coeff = np.real(complex(r.setting.observable.coefficient))
        expectations.append(r.expectation / (coeff if coeff != 0 else 1.0))
    return _pinv_solve(np.stack(rows), np.array(expectations, dtype=float),
                       dim, device)


def pgdb_a_row_pair(in_mat: np.ndarray, op: np.ndarray,
                    eye: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(+ row, - row) of the PGDB A-matrix (eq. A1 of [PGD]) for one
    (input state, coefficient-1 observable) setting, column-stacking vec."""
    proj_plus = (eye + op) / 2
    proj_minus = (eye - op) / 2
    return (np.kron(in_mat, proj_plus.T).T.reshape(-1),
            np.kron(in_mat, proj_minus.T).T.reshape(-1))


def _extract_from_results(results: List[ExperimentResult], qubits: List[int]):
    """Build (A, n): p = A vec(E) casts outcome probabilities linearly in the
    Choi matrix E (eq. A1 of [PGD]); n are normalized observed counts (host
    numpy). A calibrated expectation outside [-1, 1] gives a negative
    entry of n, as in the JAX package."""
    a_rows = []
    n_vals = []
    grand_total = 0
    dim = 2 ** len(qubits)
    eye = np.eye(dim)
    for result in results:
        in_mat = state_to_density(result.setting.in_state, qubits)
        op = pauli_term_to_matrix(result.setting.observable.copy(coefficient=1.0),
                                  qubits)
        row_plus, row_minus = pgdb_a_row_pair(in_mat, op, eye)
        a_rows.append(row_plus)
        a_rows.append(row_minus)
        # expectations are coeff * <P>: divide the coefficient out before
        # splitting the counts
        coeff = np.real(complex(result.setting.observable.coefficient))
        expected_plus = (1 + result.expectation / (coeff if coeff else 1.0)) / 2
        n_vals.append(result.total_counts * expected_plus)
        n_vals.append(result.total_counts * (1 - expected_plus))
        grand_total += result.total_counts
    a = np.stack(a_rows) / dim ** 2
    n = np.asarray(n_vals) / grand_total
    return a, n


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


def pgdb_process_estimate(results: List[ExperimentResult], qubits: List[int],
                          trace_preserving: bool = True,
                          maxiter: int = 1000,
                          method: str = "pgdb",
                          warm_start: bool = False,
                          loop_dyk_iters: Optional[int] = None,
                          device=None) -> torch.Tensor:
    """Projected-gradient MLE process estimate [PGD]: the Choi matrix,
    complex128 on ``device`` (the card by default).

    The projection onto CPTP (or CP+TNI) is Dykstra's, as in the reference.
    ``method="apg"`` selects the accelerated solver (same optimum, ~3x fewer
    iterations); ``warm_start``/``loop_dyk_iters`` (APG only) as in
    :func:`pgdb_process_estimate_batched`.
    """
    a, n = _extract_from_results(results, qubits)
    dim = 2 ** len(qubits)
    dev = entry_device(device)
    a = torch.tensor(a, dtype=torch.complex128, device=dev)
    n = torch.tensor(n, dtype=torch.float64, device=dev)[None]
    if method == "pgdb":
        if loop_dyk_iters is not None:
            raise ValueError("loop_dyk_iters requires method='apg'")
        return _pgdb_kernel(a, n, dim, trace_preserving, 1e-10, maxiter, 1e-4,
                            1000, warm_start=warm_start)[0][0]
    return pgdb_process_estimate_batched(
        a, n, dim=dim, trace_preserving=trace_preserving, stop_tol=1e-10,
        maxiter=maxiter, dyk_tol=1e-4, dyk_iters=1000, method=method,
        warm_start=warm_start, loop_dyk_iters=loop_dyk_iters)[0]


# ======================================================================
# Wrapper
# ======================================================================

def do_tomography(qc, program: Circuit, qubits: List[int], kind: str,
                  num_shots: int = 1_000, active_reset: bool = False,
                  group_tpb_settings: bool = True, symm_type: int = -1,
                  calibrate_observables: bool = True,
                  show_progress_bar: bool = False) \
        -> Tuple[torch.Tensor, ObservablesExperiment, List[ExperimentResult]]:
    """Generate, acquire, and estimate state or process tomography end to
    end. The circuits run on the QVM ``qc``'s device, and the estimate is
    made there."""
    if kind.lower() == "state":
        expt = generate_state_tomography_experiment(program, qubits)
    elif kind.lower() == "process":
        expt = generate_process_tomography_experiment(program, qubits)
    else:
        raise ValueError("Kind must be either 'state' or 'process'.")

    if group_tpb_settings:
        expt = group_settings(expt)

    results = list(estimate_observables(qc, expt, num_shots=num_shots,
                                        symm_type=symm_type,
                                        active_reset=active_reset,
                                        show_progress_bar=show_progress_bar))
    if calibrate_observables:
        results = list(calibrate_observable_estimates(
            qc, results, num_shots=num_shots, symm_type=symm_type,
            noisy_program=program))

    if kind.lower() == "state":
        est = iterative_mle_state_estimate(results, qubits, device=qc.device)
    else:
        est = pgdb_process_estimate(results, qubits, device=qc.device)
    return est, expt, results
