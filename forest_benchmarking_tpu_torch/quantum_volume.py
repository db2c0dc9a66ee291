"""Quantum volume measurement [QVol] (arXiv:1811.12926).

Port of ``forest_benchmarking_tpu/quantum_volume.py`` (reference parity:
forest/benchmarking/quantum_volume.py — _naive_program_generator:21,
collect_heavy_outputs:94, generate_abstract_qv_circuit:126,
sample_rand_circuits_for_heavy_out:154, calculate_prob_est_and_err:211
(eq. C3), measure_quantum_volume:234, count_heavy_hitters_sampled:322,
get_prob_sample_heavy_by_depth:344, extract_quantum_volume_from_results:379
(QV = 2^maxdepth)).

Two halves:

- the per-circuit path: ``generate_abstract_qv_circuit`` (numpy
  ``RandomState`` draws, as in the JAX package, so the same ``rng`` gives
  the same circuits), ``collect_heavy_outputs`` (host numpy),
  ``abstract_circuit_to_circuit`` and the SWAP router
  ``topology_restricted_program_generator``, and
  ``measure_quantum_volume``, which runs every circuit where ``qc`` runs
  (``QVM()``: the card) and counts heavy outputs on the host;
- the batched paths: ``_sample_perms``, the density-matrix forms
  (``_apply_2q_to_density``, ``_apply_2q_channel_to_density``,
  ``_simulate_qv_circuit_density``, ``_lift_2q``,
  ``_simulate_qv_circuit_density_lifted``), ``sample_heavy_outputs_batched``,
  ``sample_heavy_outputs_sharded`` and ``measure_quantum_volume_batched``.
  Their ``_bit_permute_indices`` and ``_simulate_qv_circuit`` live in
  :mod:`.ops.pallas_traj`, beside the kernels that use them.

Gate indexing as in the reference: layer gate j acts on qubits
(perm[j], perm[j+1]); the batched state is permuted so that old qubit
perm[i] sits at position i and the gates act at the static positions
(j, j+1).

Single-circuit functions of the batched paths are written as in the JAX
package and batched over circuits with ``torch.func.vmap``. The ideal
probabilities and the trajectory evolution go through
:mod:`.ops.pallas_traj`: its CUDA kernels on the card at the depths they
take, its plain versions elsewhere (:func:`_use_kernels`). The batched
entry points run on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import functools
import logging
import warnings
from statistics import median
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from forest_benchmarking_tpu_torch import tracing
from forest_benchmarking_tpu_torch.circuits import Circuit, Gate
from forest_benchmarking_tpu_torch.ops import pallas_traj
from forest_benchmarking_tpu_torch.ops.pallas_traj import _bit_permute_indices
from forest_benchmarking_tpu_torch.ops.lanes_apg import full_f32_matmul
from forest_benchmarking_tpu_torch.ops.random_operators import (
    haar_rand_unitary)
from forest_benchmarking_tpu_torch.tracing import span
from forest_benchmarking_tpu_torch.utils import (
    bit_array_to_int, entry_device, progress_iter)

log = logging.getLogger(__name__)

__all__ = [
    "generate_abstract_qv_circuit", "collect_heavy_outputs",
    "abstract_circuit_to_circuit", "sample_rand_circuits_for_heavy_out",
    "sample_heavy_outputs_batched", "sample_heavy_outputs_sharded",
    "calculate_prob_est_and_err",
    "topology_restricted_program_generator",
    "measure_quantum_volume", "measure_quantum_volume_batched",
    "count_heavy_hitters_sampled", "get_prob_sample_heavy_by_depth",
    "extract_quantum_volume_from_results",
]


def generate_abstract_qv_circuit(depth: int,
                                 rng: Optional[np.random.RandomState] = None) \
        -> Tuple[List[np.ndarray], np.ndarray]:
    """Random permutations and Haar-random 4x4 gates of a model circuit,
    drawn from ``rng`` (numpy's global state if None) in the JAX package's
    order: the permutations, then each gate's real and imaginary Gaussians,
    QR with the phase fix."""
    if rng is None:
        rng = np.random
    permutations = [rng.permutation(range(depth)) for _ in range(depth)]
    num_gates_per_layer = depth // 2

    def haar4():
        # standard_normal exists on np.random, RandomState and Generator
        z = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
        q, r = np.linalg.qr(z)
        lam = np.diagonal(r) / np.abs(np.diagonal(r))
        return q * lam
    gates = np.asarray([[haar4() for _ in range(num_gates_per_layer)]
                        for _ in range(depth)])
    return permutations, gates


def collect_heavy_outputs(depth: int, permutations: Sequence[np.ndarray],
                          gates: np.ndarray) -> List[int]:
    """Ints of bitstrings output with greater-than-median ideal probability.

    Simulates the model circuit in host numpy (qubit 0 left-most, as
    NumpyWavefunctionSimulator) and takes the median with
    ``statistics.median``, as the JAX package does.
    """
    psi = np.zeros((2,) * depth, dtype=complex)
    psi[(0,) * depth] = 1.0
    for perm, layer in zip(permutations, gates):
        for gate_idx, gate in enumerate(layer):
            axes = (int(perm[gate_idx]), int(perm[gate_idx + 1]))
            g = np.asarray(gate, complex).reshape(2, 2, 2, 2)
            psi = np.tensordot(g, psi, axes=([2, 3], list(axes)))
            psi = np.moveaxis(psi, [0, 1], list(axes))
    probabilities = np.abs(psi.reshape(-1)) ** 2
    median_prob = median(probabilities)
    return [idx for idx, prob in enumerate(probabilities) if prob > median_prob]


def abstract_circuit_to_circuit(qubits: Sequence[int],
                                permutations: Sequence[np.ndarray],
                                gates: np.ndarray) -> Circuit:
    """The analog of _naive_program_generator: custom-matrix gates on the first
    depth-many of ``qubits`` (no ISA restriction — there is no remote compiler).
    """
    num_measure_qubits = len(permutations[0])
    measure_qubits = list(qubits)[:num_measure_qubits]
    circ = Circuit()
    for perm, layer in zip(permutations, gates):
        for gate_idx, gate in enumerate(layer):
            circ += Gate("QVGATE", (), (int(measure_qubits[perm[gate_idx]]),
                                        int(measure_qubits[perm[gate_idx + 1]])),
                         matrix=tuple(map(tuple, np.asarray(gate, complex))))
    return circ


def topology_restricted_program_generator(
        edges: Sequence[Tuple[int, int]]) -> Callable:
    """A ``program_generator`` for :func:`measure_quantum_volume` that routes
    model circuits onto a restricted qubit connectivity graph.

    The analog of the reference's ``_naive_program_generator``
    (quantum_volume.py:62-89), which recompiles onto the qc's ISA/topology via
    the remote compiler: here a naive greedy router inserts SWAP chains
    (shortest path by BFS) to bring each gate's qubits adjacent, applies the
    Haar gate, and finally restores the identity logical->physical mapping so
    the caller's fixed measurement qubits read out the model circuit's
    logical bits. SWAPs are named gates, so noise models attached via
    ``Circuit.define_noisy_gate("SWAP", ...)`` hit exactly the routing
    overhead — enabling QV-vs-connectivity studies.

    :param edges: undirected edges of the available topology (physical qubit
        labels; every qubit passed to measure_quantum_volume must appear).
    :return: a ``program_generator(qc, qubits, permutations, gates)``.
    """
    adj: Dict[int, List[int]] = {}
    for a, b in edges:
        adj.setdefault(int(a), []).append(int(b))
        adj.setdefault(int(b), []).append(int(a))

    def shortest_path(src: int, dst: int) -> List[int]:
        prev = {src: None}
        frontier = [src]
        while frontier:
            nxt = []
            for u in frontier:
                for v in adj.get(u, ()):
                    if v not in prev:
                        prev[v] = u
                        nxt.append(v)
            if dst in prev:
                break
            frontier = nxt
        if dst not in prev:
            raise ValueError(f"No path between qubits {src} and {dst} in the "
                             "given topology")
        path = [dst]
        while path[-1] != src:
            path.append(prev[path[-1]])
        return path[::-1]

    def generator(qc, qubits: Sequence[int], permutations: Sequence[np.ndarray],
                  gates: np.ndarray) -> Circuit:
        depth = len(permutations[0])
        physical = list(qubits)[:depth]
        for q in physical:
            if int(q) not in adj:
                raise ValueError(f"Qubit {q} is not in the topology")
        # occupant[p] = logical qubit currently on physical qubit p (None for
        # spare topology qubits, which routing may freely swap through);
        # loc[l] = physical qubit currently holding logical qubit l.
        occupant: Dict[int, Optional[int]] = {p: None for p in adj}
        for l in range(depth):
            occupant[int(physical[l])] = l
        loc = {l: int(physical[l]) for l in range(depth)}
        circ = Circuit()
        routing_swaps: List[Tuple[int, int]] = []

        def swap(a: int, b: int):
            nonlocal circ
            circ += Gate("SWAP", (), (a, b))
            routing_swaps.append((a, b))
            occupant[a], occupant[b] = occupant[b], occupant[a]
            for p in (a, b):
                if occupant[p] is not None:
                    loc[occupant[p]] = p

        for perm, layer in zip(permutations, gates):
            for gate_idx, gate in enumerate(layer):
                la, lb = int(perm[gate_idx]), int(perm[gate_idx + 1])
                if loc[lb] not in adj.get(loc[la], ()):
                    # walk logical qubit la along a shortest physical path
                    # (possibly through spare qubits) until adjacent to lb
                    for step in shortest_path(loc[la], loc[lb])[1:-1]:
                        swap(loc[la], step)
                pa, pb = loc[la], loc[lb]
                circ += Gate("QVGATE", (), (pa, pb),
                             matrix=tuple(map(tuple, np.asarray(gate, complex))))
        # restore the identity mapping (so measurement qubits read out logical
        # bits) by undoing every routing swap in reverse order — each swap is
        # self-inverse and topology-respecting by construction
        for a, b in reversed(routing_swaps):
            circ += Gate("SWAP", (), (a, b))
        return circ

    return generator


def sample_rand_circuits_for_heavy_out(qc, qubits: Sequence[int], depth: int,
                                       program_generator: Callable = None,
                                       num_circuits: int = 100,
                                       num_shots: int = 1000,
                                       show_progress_bar: bool = False,
                                       rng: Optional[np.random.RandomState] = None) -> int:
    """Count sampled heavy outputs across random model circuits at this depth.

    Runs each circuit on ``qc`` (which may be noisy; ``QVM()`` runs on the
    card) and compares each shot, on the host, against the ideal
    heavy-output set.
    """
    if rng is None:
        rng = np.random
    num_heavy = 0
    for _ in progress_iter(range(num_circuits), show_progress_bar,
                           desc=f"qv depth {depth}"):
        permutations, gates = generate_abstract_qv_circuit(depth, rng)
        if program_generator is None:
            program = abstract_circuit_to_circuit(qubits, permutations, gates)
        else:
            program = program_generator(qc, qubits, permutations, gates)
        measure_qubits = list(qubits)[:depth]
        results = qc.run(program, measure_qubits, num_shots)
        heavy_outputs = set(collect_heavy_outputs(depth, permutations, gates))
        for result in results:
            if bit_array_to_int(result) in heavy_outputs:
                num_heavy += 1
    return num_heavy


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


def _noisy_method(depth: int, noisy_method: str = "auto") -> str:
    """The method of a noisy batched call at ``depth``: ``noisy_method``,
    where ``"auto"`` takes the exact density method to depth 6 and the
    trajectories above."""
    if noisy_method not in ("auto", "density", "trajectory"):
        raise ValueError(f"unknown noisy_method {noisy_method!r}")
    if noisy_method == "auto":
        return "density" if depth <= 6 else "trajectory"
    return noisy_method


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
    if gdev.type == "cuda" and gdev.index is None:
        # torch.Generator(device="cuda") draws on the current card
        gdev = torch.device("cuda", torch.cuda.current_device())
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
    with span(tracing.QV_SAMPLE_HEAVY):
        with span(tracing.QV_DRAWS):
            perms = _sample_perms(gen, num_circuits, depth)
            gates = haar_rand_unitary(gen, 4,
                                      batch=(num_circuits, depth, depth // 2),
                                      dtype=dtype)
        with span(tracing.QV_IDEAL):
            probs = ideal(perms, gates.to(kcdtype), depth).to(dtype)
        with span(tracing.QV_HEAVY_SETS):
            heavy = _heavy_outputs(probs)

        if kraus is not None:
            kraus = torch.as_tensor(kraus).to(device=dev, dtype=cdtype)
            if _noisy_method(depth, noisy_method) == "trajectory":
                t = num_shots if num_trajectories is None else num_trajectories
                if num_shots % t != 0:
                    raise ValueError(f"num_trajectories ({t}) must divide "
                                     f"num_shots ({num_shots})")
                with span(tracing.QV_TRAJECTORIES):
                    uniforms = torch.rand(
                        (num_circuits, depth, depth // 2, t), generator=gen,
                        device=dev, dtype=kdtype)
                    traj = trajectories(perms, gates.to(kcdtype),
                                        kraus.to(kcdtype), uniforms,
                                        depth).to(dtype)
                with span(tracing.QV_SHOTS):
                    # (C, 2^d, T) -> num_shots / T shots from each trajectory
                    rows = traj.transpose(1, 2).reshape(num_circuits * t, -1)
                    samples = torch.multinomial(rows, num_shots // t,
                                                replacement=True,
                                                generator=gen)
                    return torch.gather(
                        heavy, 1,
                        samples.reshape(num_circuits, num_shots)).sum(1)
            with full_f32_matmul():
                if depth >= 6:
                    lifts = tuple(_lift_2q(kraus, j, depth)
                                  for j in range(depth // 2))
                    sim = functools.partial(
                        _simulate_qv_circuit_density_lifted,
                        kraus_lifts=lifts, depth=depth)
                else:
                    sim = functools.partial(_simulate_qv_circuit_density,
                                            kraus=kraus, depth=depth)
                probs = torch.func.vmap(sim)(perms, gates)

        with span(tracing.QV_SHOTS):
            samples = torch.multinomial(probs, num_shots, replacement=True,
                                        generator=gen)
            return torch.gather(heavy, 1, samples).sum(1)


def sample_heavy_outputs_sharded(generator: torch.Generator, mesh,
                                 depth: int, num_circuits: int,
                                 num_shots: int, axis_name: str = "batch",
                                 **kw) -> torch.Tensor:
    """:func:`sample_heavy_outputs_batched` with circuits sharded over a mesh.

    QV heavy-output sampling is embarrassingly parallel in the circuit axis:
    shard i runs :func:`sample_heavy_outputs_batched` on
    ``num_circuits / n_shards`` circuits on its device, drawing from
    ``parallel.fold_in(generator, i, device)``, so the result equals the
    per-shard runs with those generators concatenated (on the card: the
    ideal kernel, and the trajectory kernel for
    ``noisy_method="trajectory"``, once a shard).

    :param generator: the parent ``torch.Generator`` (its ``initial_seed``
        seeds the shards' streams).
    :param mesh: a :class:`~.parallel.Mesh` whose ``axis_name`` axis shards
        the circuit batch; its size must divide ``num_circuits``.
    :param kw: forwarded to :func:`sample_heavy_outputs_batched`
        (``dtype``, ``kraus``, ``noisy_method``, ``num_trajectories``).
    :return: (num_circuits,) per-circuit heavy counts on the mesh's first
        device.
    """
    from forest_benchmarking_tpu_torch.parallel import shard_map_batched

    n_dev = mesh.shape[axis_name]
    if num_circuits % n_dev != 0:
        raise ValueError(f"num_circuits ({num_circuits}) must be divisible "
                         f"by the mesh axis {axis_name!r} size {n_dev}")
    per_dev = num_circuits // n_dev

    def shard(gen):
        return sample_heavy_outputs_batched(
            gen, depth=depth, num_circuits=per_dev, num_shots=num_shots,
            device=gen.device, **kw)

    return shard_map_batched(shard, mesh, batched_argnums=(),
                             fold_key_argnums=(0,),
                             axis_name=axis_name)(generator)


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


def measure_quantum_volume(qc, qubits: Sequence[int] = None,
                           program_generator: Callable = None,
                           num_circuits: int = 100, num_shots: int = 1000,
                           depths: Optional[np.ndarray] = None,
                           achievable_threshold: float = 2 / 3,
                           stop_when_fail: bool = True,
                           show_progress_bar: bool = False,
                           rng: Optional[np.random.RandomState] = None) \
        -> Dict[int, Tuple[float, float]]:
    """Measure quantum volume of the given (possibly noisy) qc [QVol]."""
    if num_circuits < 100:
        warnings.warn("The number of random circuits ran ought to be greater "
                      "than 100 for results to be valid.")
    if qubits is None:
        raise ValueError("Specify the qubits available on the qc.")
    if depths is None:
        depths = np.arange(2, len(qubits) + 1)

    results = {}
    for depth in depths:
        log.info("Starting depth %s", depth)
        num_heavy = sample_rand_circuits_for_heavy_out(
            qc, qubits, depth, program_generator, num_circuits, num_shots,
            show_progress_bar, rng=rng)
        prob_sample_heavy, one_sided = calculate_prob_est_and_err(
            num_heavy, num_circuits, num_shots)
        results[depth] = (prob_sample_heavy, one_sided)
        if stop_when_fail and not one_sided > achievable_threshold:
            break
    return results


def count_heavy_hitters_sampled(qc_results: Iterator[np.ndarray],
                                heavy_hitters: Iterator[List[int]]) -> Iterator[int]:
    """Per-circuit counts of sampled bitstrings that are heavy."""
    for results, hh_list in zip(qc_results, heavy_hitters):
        hh_set = set(hh_list)
        num_heavy = 0
        for result in results:
            if bit_array_to_int(result) in hh_set:
                num_heavy += 1
        yield num_heavy


def get_prob_sample_heavy_by_depth(depths: Iterator[int],
                                   num_hh_sampled: Iterator[int],
                                   num_shots: Iterator[int]) \
        -> Dict[int, Tuple[float, float]]:
    """Per-depth (probability estimate, lower bound) from per-circuit counts."""
    nheavy_by_depth = {}
    for depth, num_heavy, n_shots in zip(depths, num_hh_sampled, num_shots):
        if depth not in nheavy_by_depth:
            nheavy_by_depth[depth] = ([num_heavy], n_shots)
        else:
            nheavy_by_depth[depth][0].append(num_heavy)
            assert n_shots == nheavy_by_depth[depth][1], \
                "The number of shots should be the same for each circuit of a " \
                "given depth."
    results_by_depth = {}
    for depth, (n_heavy, n_shots) in nheavy_by_depth.items():
        results_by_depth[depth] = calculate_prob_est_and_err(
            sum(n_heavy), len(n_heavy), n_shots)
    return results_by_depth


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
