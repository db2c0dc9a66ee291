"""Quantum volume measurement [QVol] (arXiv:1811.12926), batched paths.

Port of the batched paths of ``forest_benchmarking_tpu/quantum_volume.py``:
``_sample_perms``, the density-matrix forms (``_apply_2q_to_density``,
``_apply_2q_channel_to_density``, ``_simulate_qv_circuit_density``,
``_lift_2q``, ``_simulate_qv_circuit_density_lifted``),
``sample_heavy_outputs_batched``, ``measure_quantum_volume_batched``,
``calculate_prob_est_and_err`` and ``extract_quantum_volume_from_results``.
Its ``_bit_permute_indices`` and ``_simulate_qv_circuit`` live in
:mod:`.ops.pallas_traj`, beside the kernels that use them. The per-circuit
host path (``measure_quantum_volume`` and its program generators) needs the
simulator of ``sim/qvm`` and comes in a later slice.

Gate indexing as in the reference: layer gate j acts on qubits
(perm[j], perm[j+1]); the state is permuted so that old qubit perm[i] sits
at position i and the gates act at the static positions (j, j+1).

Single-circuit functions are written as in the JAX package and batched over
circuits with ``torch.func.vmap``. The ideal probabilities and the
trajectory evolution go through :mod:`.ops.pallas_traj`: its CUDA kernels
on the card at the depths they take, its plain versions elsewhere
(:func:`_use_kernels`). The entry points run on the card unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from forest_benchmarking_tpu_torch.ops import pallas_traj
from forest_benchmarking_tpu_torch.ops.pallas_traj import _bit_permute_indices
from forest_benchmarking_tpu_torch.ops.lanes_apg import full_f32_matmul
from forest_benchmarking_tpu_torch.ops.random_operators import (
    haar_rand_unitary)
from forest_benchmarking_tpu_torch.utils import entry_device

__all__ = ["sample_heavy_outputs_batched", "measure_quantum_volume_batched",
           "calculate_prob_est_and_err",
           "extract_quantum_volume_from_results"]


def _sample_perms(generator: torch.Generator, num_circuits: int,
                  depth: int) -> torch.Tensor:
    """(C, depth, depth) uniform qubit permutations, one per (circuit,
    layer): the argsort of i.i.d. uniforms."""
    u = torch.rand((num_circuits, depth, depth), generator=generator,
                   device=generator.device)
    return torch.argsort(u, dim=-1)


def _apply_2q_to_density(rho_t: torch.Tensor, u4: torch.Tensor, j: int,
                         depth: int) -> torch.Tensor:
    """rho -> U rho U^dag with U a 4x4 on adjacent qubits (j, j+1).

    ``rho_t`` has shape (2,)*depth + (2,)*depth (ket axes then bra axes).
    """
    u_t = u4.reshape(2, 2, 2, 2)
    rho_t = torch.movedim(
        torch.tensordot(u_t, rho_t, dims=([2, 3], [j, j + 1])),
        (0, 1), (j, j + 1))
    bj = depth + j
    return torch.movedim(
        torch.tensordot(u_t.conj(), rho_t, dims=([2, 3], [bj, bj + 1])),
        (0, 1), (bj, bj + 1))


def _apply_2q_channel_to_density(rho_t: torch.Tensor, kraus: torch.Tensor,
                                 j: int, depth: int) -> torch.Tensor:
    """rho -> sum_k K_k rho K_k^dag on adjacent qubits (j, j+1), the whole
    Kraus sum in two stacked tensordots.

    ``rho_t`` has shape (2,)*depth + (2,)*depth; ``kraus`` is (K, 4, 4).
    """
    k_t = kraus.reshape(-1, 2, 2, 2, 2)          # (K, out, out, in, in)
    t = torch.tensordot(k_t, rho_t, dims=([3, 4], [j, j + 1]))
    # the bra axes of rho sit after the remaining ket axes; in t they are
    # shifted by 3 (K, o1, o2) minus the 2 contracted ket axes
    bj = 3 + (depth - 2) + j
    out = torch.tensordot(k_t.conj(), t, dims=([0, 3, 4], [0, bj, bj + 1]))
    # out axes: (b_j, b_j+1, k_j, k_j+1, kets w/o j,j+1..., bras w/o j,j+1...)

    def src_ket(m):
        if m in (j, j + 1):
            return 2 + m - j
        return 4 + (m if m < j else m - 2)

    def src_bra(m):
        if m in (j, j + 1):
            return m - j
        return 4 + (depth - 2) + (m if m < j else m - 2)

    return out.permute([src_ket(m) for m in range(depth)]
                       + [src_bra(m) for m in range(depth)])


def _permute_density(rho: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return rho[idx][:, idx]


def _density_probs(rho: torch.Tensor) -> torch.Tensor:
    p = torch.diagonal(rho).real.clamp(min=0.0)
    return p / p.sum()


def _simulate_qv_circuit_density(perms: torch.Tensor, gates: torch.Tensor,
                                 kraus: torch.Tensor,
                                 depth: int) -> torch.Tensor:
    """Noisy output probabilities of one model circuit by density-matrix
    evolution: each Haar gate is followed by the two-qubit Kraus channel
    ``kraus`` (K, 4, 4) on the same qubit pair."""
    d = 2 ** depth
    rho = torch.zeros((d, d), dtype=gates.dtype, device=gates.device)
    rho[0, 0] = 1.0
    for layer in range(depth):
        fwd = _bit_permute_indices(perms[layer], depth)
        rho_t = _permute_density(rho, fwd).reshape((2,) * (2 * depth))
        for j in range(depth // 2):
            rho_t = _apply_2q_to_density(rho_t, gates[layer, j], j, depth)
            rho_t = _apply_2q_channel_to_density(rho_t, kraus, j, depth)
        rho = _permute_density(rho_t.reshape(d, d), torch.argsort(fwd))
    return _density_probs(rho)


def _lift_2q(mat: torch.Tensor, j: int, depth: int) -> torch.Tensor:
    """kron(I_{2^j}, mat, I_{2^(depth-j-2)}): a 4x4 (or a (K, 4, 4) stack) on
    qubits (j, j+1) lifted to the full 2^depth space."""
    left = torch.eye(2 ** j, dtype=mat.dtype, device=mat.device)
    right = torch.eye(2 ** (depth - j - 2), dtype=mat.dtype, device=mat.device)
    return torch.kron(torch.kron(left, mat), right)


def _simulate_qv_circuit_density_lifted(perms: torch.Tensor,
                                        gates: torch.Tensor,
                                        kraus_lifts, depth: int) -> torch.Tensor:
    """Noisy output probabilities by lifted-matrix density evolution: gates
    and Kraus operators become (2^depth, 2^depth) matrices and every
    application is a matrix product. Same semantics as
    :func:`_simulate_qv_circuit_density`, used from depth 6, where the
    tensor form's 2*depth-dimensional contractions get unwieldy.
    ``kraus_lifts`` holds one (K, 2^depth, 2^depth) stack per gate slot."""
    d = 2 ** depth
    rho = torch.zeros((d, d), dtype=gates.dtype, device=gates.device)
    rho[0, 0] = 1.0
    for layer in range(depth):
        fwd = _bit_permute_indices(perms[layer], depth)
        rho = _permute_density(rho, fwd)
        for j in range(depth // 2):
            u = _lift_2q(gates[layer, j], j, depth)
            rho = u @ rho @ u.mH
            kl = kraus_lifts[j]
            rho = torch.einsum("kac,kbc->ab", kl @ rho, kl.conj())
        rho = _permute_density(rho, torch.argsort(fwd))
    return _density_probs(rho)


def _use_kernels(depth: int, device: torch.device) -> bool:
    """Whether the batched sampler takes the CUDA kernels of
    :mod:`.ops.pallas_traj`: on the card, at every depth they take
    (``MIN_DEPTH`` to ``MAX_DEPTH``), whatever ``dtype``. The kernels then
    get complex64 gates and Kraus stack and float32 uniforms, and their
    output is cast back to ``dtype``, as the JAX package's kernel path does.
    Elsewhere -- on the CPU, or above ``MAX_DEPTH`` on the card -- the plain
    versions run in ``dtype`` where the tensors lie, and no launch counter
    moves. The port's counterpart of the JAX package's
    ``_pallas_qv_routing``, which sends the depths its kernels do not take
    (below 7 there) to the plain simulator."""
    return device.type == "cuda" and pallas_traj.supports_pallas_traj(depth)


def _heavy_outputs(probs: torch.Tensor) -> torch.Tensor:
    """(C, 2^d) bool: outputs with greater-than-median ideal probability.
    The median of an even count is the mean of the two middle values, as
    ``jnp.median`` takes it, so exactly half the outputs are heavy."""
    s = torch.sort(probs, dim=-1).values
    half = probs.shape[-1] // 2
    med = (s[..., half - 1] + s[..., half]) / 2
    return probs > med[..., None]


def _generator(generator: Optional[torch.Generator],
               dev: torch.device) -> torch.Generator:
    if generator is None:
        return torch.Generator(device=dev).manual_seed(0)
    gdev = torch.device(generator.device)
    if gdev.type != dev.type or (dev.type == "cuda" and gdev.index != dev.index):
        raise ValueError(f"generator on {gdev} but device={dev}")
    return generator


def sample_heavy_outputs_batched(generator: Optional[torch.Generator],
                                 depth: int, num_circuits: int,
                                 num_shots: int,
                                 dtype: torch.dtype = torch.float32,
                                 kraus=None, noisy_method: str = "auto",
                                 num_trajectories: Optional[int] = None,
                                 device="cuda") -> torch.Tensor:
    """Sample circuits, find heavy sets, sample shots, count heavy outputs.

    Returns the (num_circuits,) per-circuit heavy-output counts. Draws, in
    order, the permutations, the Haar gates, the branch uniforms (trajectory
    method) and the shots from ``generator`` (a fresh one seeded 0 if None),
    which must live on ``device``.

    The heavy sets come from the ideal circuits
    (:func:`~.ops.pallas_traj.ideal_probs`: the ideal kernel on the card).
    Without ``kraus`` the shots are drawn from the ideal distribution, so
    the heavy-output probability tends to (1 + ln 2) / 2 at large depth.
    With ``kraus`` -- a (K, 4, 4) complex Kraus stack applied after every
    Haar gate on its qubit pair -- they are drawn from the noisy
    distribution:

    - ``noisy_method="density"``: exact density-matrix evolution in plain
      PyTorch (tensor form below depth 6, lifted-matrix form from 6);
    - ``noisy_method="trajectory"``: Kraus-unravelled statevector
      trajectories (:func:`~.ops.pallas_traj.traj_probs`: the trajectory
      kernel on the card). ``num_trajectories`` T (default ``num_shots``)
      must divide ``num_shots``; each trajectory gives num_shots / T shots;
    - ``noisy_method="auto"``: density at depth <= 6, trajectory above.

    On the card the kernels compute in float32 at every ``dtype``
    (:func:`_use_kernels`).
    """
    dev = entry_device(device)
    gen = _generator(generator, dev)
    cdtype = torch.complex64 if dtype == torch.float32 else torch.complex128
    if _use_kernels(depth, dev):
        ideal, trajectories = pallas_traj.ideal_probs, pallas_traj.traj_probs
        kdtype = torch.float32
    else:
        ideal = pallas_traj.ideal_probs_reference
        trajectories = pallas_traj.traj_probs_reference
        kdtype = dtype
    kcdtype = torch.complex64 if kdtype == torch.float32 else torch.complex128
    perms = _sample_perms(gen, num_circuits, depth)
    gates = haar_rand_unitary(gen, 4, batch=(num_circuits, depth, depth // 2),
                              dtype=dtype)
    probs = ideal(perms, gates.to(kcdtype), depth).to(dtype)
    heavy = _heavy_outputs(probs)

    if kraus is not None:
        kraus = torch.as_tensor(kraus).to(device=dev, dtype=cdtype)
        if noisy_method not in ("auto", "density", "trajectory"):
            raise ValueError(f"unknown noisy_method {noisy_method!r}")
        method = noisy_method
        if method == "auto":
            method = "density" if depth <= 6 else "trajectory"
        if method == "trajectory":
            t = num_shots if num_trajectories is None else num_trajectories
            if num_shots % t != 0:
                raise ValueError(f"num_trajectories ({t}) must divide "
                                 f"num_shots ({num_shots})")
            uniforms = torch.rand((num_circuits, depth, depth // 2, t),
                                  generator=gen, device=dev, dtype=kdtype)
            traj = trajectories(perms, gates.to(kcdtype), kraus.to(kcdtype),
                                uniforms, depth).to(dtype)
            # (C, 2^d, T) -> num_shots / T shots from each trajectory
            rows = traj.transpose(1, 2).reshape(num_circuits * t, -1)
            samples = torch.multinomial(rows, num_shots // t, replacement=True,
                                        generator=gen)
            return torch.gather(heavy, 1,
                                samples.reshape(num_circuits, num_shots)).sum(1)
        with full_f32_matmul():
            if depth >= 6:
                lifts = tuple(_lift_2q(kraus, j, depth)
                              for j in range(depth // 2))
                sim = functools.partial(_simulate_qv_circuit_density_lifted,
                                        kraus_lifts=lifts, depth=depth)
            else:
                sim = functools.partial(_simulate_qv_circuit_density,
                                        kraus=kraus, depth=depth)
            probs = torch.func.vmap(sim)(perms, gates)

    samples = torch.multinomial(probs, num_shots, replacement=True,
                                generator=gen)
    return torch.gather(heavy, 1, samples).sum(1)


def measure_quantum_volume_batched(generator: Optional[torch.Generator] = None,
                                   max_depth: int = 8,
                                   num_circuits: int = 200,
                                   num_shots: int = 1000,
                                   achievable_threshold: float = 2 / 3,
                                   stop_when_fail: bool = True,
                                   dtype: torch.dtype = torch.float32,
                                   kraus=None, noisy_method: str = "auto",
                                   num_trajectories: Optional[int] = None,
                                   device="cuda"
                                   ) -> Dict[int, Tuple[float, float]]:
    """Scan depths 2..max_depth with :func:`sample_heavy_outputs_batched`,
    one generator drawn from in turn (a fresh one seeded 0 if None).
    ``kraus`` (optional (K, 4, 4) stack) switches every depth to the noisy
    path; ``noisy_method``/``num_trajectories`` select and tune it. Returns
    {depth: (heavy-output probability, its 2-sigma lower bound)}, stopping
    after the first depth whose bound is at or below
    ``achievable_threshold`` when ``stop_when_fail``."""
    dev = entry_device(device)
    gen = _generator(generator, dev)
    results = {}
    for depth in range(2, max_depth + 1):
        num_heavy = int(sample_heavy_outputs_batched(
            gen, depth, num_circuits, num_shots, dtype=dtype, kraus=kraus,
            noisy_method=noisy_method, num_trajectories=num_trajectories,
            device=dev).sum())
        prob, conf = calculate_prob_est_and_err(num_heavy, num_circuits,
                                                num_shots)
        results[depth] = (prob, conf)
        if stop_when_fail and conf <= achievable_threshold:
            break
    return results


def calculate_prob_est_and_err(num_heavy: int, num_circuits: int,
                               num_shots: int) -> Tuple[float, float]:
    """Heavy-output probability estimate and its 2-sigma one-sided lower
    bound (eq. C3 of [QVol])."""
    total_sampled_outputs = num_circuits * num_shots
    prob_sample_heavy = num_heavy / total_sampled_outputs
    one_sided_confidence_interval = prob_sample_heavy - \
        2 * np.sqrt(num_heavy * (num_shots - num_heavy / num_circuits)) \
        / total_sampled_outputs
    return prob_sample_heavy, one_sided_confidence_interval


def extract_quantum_volume_from_results(
        results: Dict[int, Tuple[float, float]]) -> int:
    """QV = 2^(largest achieved depth) (eq. 7 of [QVol])."""
    max_depth = 1
    for depth in sorted(results.keys()):
        _, lower_bound = results[depth]
        if lower_bound <= 2 / 3:
            break
        max_depth = depth
    return 2 ** max_depth
