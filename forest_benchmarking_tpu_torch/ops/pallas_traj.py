"""Quantum-volume statevector kernels: plain PyTorch versions and CUDA
kernel wrappers for the noisy trajectory probabilities and the ideal output
probabilities of batched model circuits.

Port of ``forest_benchmarking_tpu/ops/pallas_traj.py`` (``_boundary_maps``,
``traj_probs_pallas``, ``ideal_probs_pallas``, ``traj_flops_per_circuit``),
with the single-circuit helpers the JAX package keeps in its
``quantum_volume.py`` (``_bit_permute_indices``, ``_simulate_qv_circuit``),
so that :mod:`..quantum_volume` depends on this module and not the reverse.
A model circuit of depth d has d layers; layer l permutes the qubits by
``perms[l]`` and applies d//2 Haar 4x4 gates to the qubit pairs (j, j+1) of
the permuted order. The noisy circuit follows every gate with a two-qubit
Kraus channel on the same pair, unravelled into trajectories: each slot
draws one branch with its Born weight from a uniform variate.

- :func:`_boundary_maps` composes the per-layer index maps, so a layer
  starts with ONE gather psi[x] <- psi[h_l[x]]. Every h_l is a bit
  permutation of the index; :func:`_boundary_source_bits` gives its source
  bit positions, which the ideal kernel forms itself from the permutations
  (the trajectory kernel still takes the maps).
- :func:`_fused_channel_ops` forms, for the plain version, W_k = K_k U
  (the gate fused into the sampled Kraus operator) and
  M'_k = U^dag K_k^dag K_k U (the branch weights from the pre-gate state),
  as the JAX package prepares them. The trajectory kernel forms both
  itself, per layer, from the gates and the Kraus stack.
- :func:`traj_probs` and :func:`ideal_probs` dispatch: the CUDA kernels of
  ``csrc/qv_traj.cu`` for tensors on the card, the plain versions
  :func:`traj_probs_reference` and :func:`ideal_probs_reference` for tensors
  on the CPU. Each counts its kernel launches in ``.launches``.
- :func:`heavy_tallies` draws one shot from each trajectory as
  ``torch.multinomial(rows, 1, replacement=True)`` does, from exponential
  variates drawn by the caller, and tallies the heavy ones: the kernel of
  ``csrc/qv_shots.cu`` on the card (no TPU kernel: the JAX package draws
  with ``jax.random.categorical``), the plain version
  :func:`heavy_tallies_reference` on the CPU.

Unlike the TPU kernels, the CUDA kernels take every depth from 2 to 10,
odd depths included (the last qubit of an odd depth has no gate): the JAX
package's depth >= 7 limit comes from the TPU's sublane tiling, not from the
math.
"""
from __future__ import annotations

import functools
import math

import torch

from forest_benchmarking_tpu_torch import kernels
from forest_benchmarking_tpu_torch.ops.lanes_apg import full_f32_matmul
from forest_benchmarking_tpu_torch.sim.statevector import apply_gate_matrix

__all__ = ["traj_probs_reference", "traj_probs_kernel", "traj_probs",
           "ideal_probs_reference", "ideal_probs_kernel", "ideal_probs",
           "heavy_tallies_reference", "heavy_tallies_kernel", "heavy_tallies",
           "traj_flops_per_circuit", "ideal_circuits_per_warp", "MIN_DEPTH",
           "MAX_DEPTH", "MAX_KRAUS", "IDEAL_WARPS", "supports_pallas_traj",
           "traj_probs_pallas", "ideal_probs_pallas"]

MIN_DEPTH, MAX_DEPTH = 2, 10   # depths the CUDA kernels take (QV_*_DEPTH)
MAX_KRAUS = 32                 # one warp lane per Kraus operator (QV_MAX_KRAUS)
IDEAL_WARPS = 4                # warps a block of the ideal kernel (IDEAL_WARPS)


def ideal_circuits_per_warp(depth: int) -> int:
    """Circuits one warp of the ideal kernel holds at ``depth``
    (``IDEAL_CIRCUITS_PER_WARP`` in ``csrc/qv_traj.cu``): a group of
    2^(depth-2) lanes a circuit, four amplitudes a lane, below depth 7; one
    warp a circuit from depth 7 on."""
    return 32 >> (depth - 2) if depth < 7 else 1


def _bit_permute_indices(perm: torch.Tensor, depth: int) -> torch.Tensor:
    """Gather indices so new position i holds old qubit perm[i] (MSB first).
    ``perm`` is (..., depth); the result is (..., 2^depth)."""
    x = torch.arange(2 ** depth, device=perm.device)
    out = torch.zeros_like(x)
    for i in range(depth):
        bit = (x >> (depth - 1 - i)) & 1
        out = out | (bit << (depth - 1 - perm[..., i, None]))
    return out


def _simulate_qv_circuit(perms: torch.Tensor, gates: torch.Tensor,
                         depth: int) -> torch.Tensor:
    """Ideal output probabilities of one model circuit (vmap-safe).

    perms: (depth, depth) int; gates: (depth, depth//2, 4, 4) complex.
    """
    psi = torch.zeros((2,) * depth, dtype=gates.dtype, device=gates.device)
    psi[(0,) * depth] = 1.0
    for layer in range(depth):
        fwd = _bit_permute_indices(perms[layer], depth)
        psi = psi.reshape(-1)[fwd].reshape((2,) * depth)
        for j in range(depth // 2):
            psi = apply_gate_matrix(psi, gates[layer, j], (j, j + 1))
        inv = torch.argsort(fwd)
        psi = psi.reshape(-1)[inv].reshape((2,) * depth)
    return psi.reshape(-1).abs() ** 2


def _boundary_maps(perms: torch.Tensor, depth: int) -> torch.Tensor:
    """Compose per-layer basis permutations into boundary index maps.

    ``fwd_l`` permutes amplitudes so that layer l's gates act at static
    positions (psi_l[x] = psi_orig[fwd_l[x]]). One map per boundary:
    h_0 = fwd_0, h_l = inv_{l-1}[fwd_l] (leave layer l-1's basis and enter
    layer l's in one gather), and h_depth = inv_{depth-1} restores the
    original basis.

    :param perms: (..., depth, depth) int qubit permutations.
    :return: (..., depth + 1, 2^depth) int64 index maps.
    """
    fwd = _bit_permute_indices(perms, depth)              # (..., depth, 2^d)
    inv = torch.argsort(fwd, dim=-1)
    hs = [fwd[..., 0, :]]
    for l in range(1, depth):
        hs.append(torch.gather(inv[..., l - 1, :], -1, fwd[..., l, :]))
    hs.append(inv[..., depth - 1, :])
    return torch.stack(hs, dim=-2)


def _boundary_source_bits(perms: torch.Tensor, depth: int) -> torch.Tensor:
    """The boundary maps of :func:`_boundary_maps` as bit permutations.

    Entry [l, k] is the bit of the index in layer l-1's basis that bit k of
    an index in layer l's basis comes from: h_l[x] = sum_k bit_k(x) <<
    P[l, k]. Bit k = depth-1-i is qubit i's; fwd_l moves it to bit
    depth-1-perm_l[i] and inv_{l-1} on to depth-1-inv(perm_{l-1})[perm_l[i]]
    (perm_depth and inv(perm_-1) are the identity). The ideal kernel of
    ``csrc/qv_traj.cu`` computes the same positions from the permutations,
    per circuit and boundary, and reads no map from memory.

    :param perms: (..., depth, depth) int qubit permutations.
    :return: (..., depth + 1, depth) int64 source bit positions.
    """
    ident = torch.arange(depth, device=perms.device).expand(
        *perms.shape[:-2], 1, depth)
    into = torch.cat([perms.long(), ident], dim=-2)             # perm_l
    back = torch.cat([ident, torch.argsort(perms, dim=-1)], dim=-2)
    return (depth - 1 - torch.gather(back, -1, into)).flip(-1)


def _fused_channel_ops(gates: torch.Tensor, kraus: torch.Tensor):
    """(W, M') for every circuit, layer and slot, each (C, d, d//2, K, 4, 4):
    W_k = K_k U and M'_k = U^dag K_k^dag K_k U, so that the branch weights
    p_k = Re tr(M'_k rho) come from the pre-gate pair density and the
    sampled branch applies one 4x4."""
    with full_f32_matmul():
        m_ops = kraus.mH @ kraus                           # (K, 4, 4)
        u = gates[..., None, :, :]                         # (C, d, s, 1, 4, 4)
        return kraus @ u, u.mH @ m_ops @ u


def _check_depth(depth: int) -> None:
    if not MIN_DEPTH <= depth <= MAX_DEPTH:
        raise ValueError(f"the CUDA kernels take depths {MIN_DEPTH} to "
                         f"{MAX_DEPTH}, got {depth}")


def _check_cuda(name: str, x: torch.Tensor, device: torch.device,
                dtype: torch.dtype, shape) -> None:
    if not x.is_cuda or x.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got "
                         f"{x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")


def _launch(fn, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err} "
                           f"({kernels.error_string(err)})")


# ----------------------------------------------------------------------
# Ideal output probabilities
# ----------------------------------------------------------------------

def ideal_probs_reference(perms: torch.Tensor, gates: torch.Tensor,
                          depth: int) -> torch.Tensor:
    """Ideal output probabilities in plain PyTorch: the JAX package's
    single-circuit :func:`_simulate_qv_circuit` under ``torch.func.vmap``,
    normalized as the kernel normalizes.

    :param perms: (C, depth, depth) int permutations.
    :param gates: (C, depth, depth//2, 4, 4) complex Haar gates.
    :return: (C, 2^depth) probabilities of the gates' real dtype.
    """
    with full_f32_matmul():
        p = torch.func.vmap(functools.partial(_simulate_qv_circuit,
                                              depth=depth))(perms, gates)
    return p / p.sum(-1, keepdim=True)


def _laid_out(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernels read it: contiguous, with a conjugate view's
    conjugation carried out (``data_ptr`` of a view points at the data before
    it). A copy only for such inputs."""
    return x.resolve_conj().contiguous()


def _ideal_kernel_inputs(perms: torch.Tensor, gates: torch.Tensor,
                         depth: int):
    """Check the ideal kernel's inputs, the (C, d, d) int64 permutations and
    (C, d, d//2, 4, 4) complex64 gates on one card, and pass them on as they
    are (the kernel forms the boundary maps itself)."""
    _check_depth(depth)
    c, slots = perms.shape[0], depth // 2
    dev = gates.device
    _check_cuda("gates", gates, dev, torch.complex64, (c, depth, slots, 4, 4))
    _check_cuda("perms", perms, dev, torch.int64, (c, depth, depth))
    perms, gates = _laid_out(perms), _laid_out(gates)
    if gates.data_ptr() % 16:
        raise ValueError("gates must be 16-byte aligned: the kernel reads "
                         "them as float4")
    return perms, gates


def _ideal_launch(perms: torch.Tensor, gates: torch.Tensor,
                  depth: int) -> torch.Tensor:
    """One launch of the ideal kernel on checked inputs; counts it."""
    c = perms.shape[0]
    out = torch.empty((c, 2 ** depth), dtype=torch.float32,
                      device=perms.device)
    _launch(kernels.load().ideal_probs_launch, perms.device,
            perms.data_ptr(), gates.data_ptr(), out.data_ptr(), c, depth)
    ideal_probs.launches += 1
    return out


def ideal_probs_kernel(perms: torch.Tensor, gates: torch.Tensor,
                       depth: int) -> torch.Tensor:
    """Launch the ideal kernel of ``csrc/qv_traj.cu`` on PyTorch's current
    stream: (C, depth, depth) int64 permutations and (C, depth, depth//2, 4,
    4) complex64 gates on the card -> (C, 2^depth) float32, in one device
    launch. Adds one to ``ideal_probs.launches`` per launch."""
    return _ideal_launch(*_ideal_kernel_inputs(perms, gates, depth), depth)


def ideal_probs(perms: torch.Tensor, gates: torch.Tensor,
                depth: int) -> torch.Tensor:
    """Ideal output probabilities (C, 2^depth) of a batch of model circuits:
    the CUDA kernel for gates on the card (complex64), the plain version
    for gates on the CPU. ``ideal_probs.launches`` counts kernel launches."""
    if gates.is_cuda:
        return ideal_probs_kernel(perms, gates, depth)
    if gates.device.type == "cpu":
        return ideal_probs_reference(perms, gates, depth)
    raise ValueError(f"unsupported device {gates.device}")


ideal_probs.launches = 0


# ----------------------------------------------------------------------
# Kraus-trajectory probabilities
# ----------------------------------------------------------------------

def traj_probs_reference(perms: torch.Tensor, gates: torch.Tensor,
                         kraus: torch.Tensor, uniforms: torch.Tensor,
                         depth: int) -> torch.Tensor:
    """Per-trajectory noisy output probabilities in plain PyTorch, the
    kernel's math on a (C, T, 2^depth) state batch: one boundary gather per
    layer, per slot the pair-reduced density, the branch weights through
    M'_k, the branch k* = number of cumulative sums strictly below u
    (clamped to K - 1, where JAX's gather clamps silently) and the apply of
    W_k*, and one renormalization per layer.

    :param perms: (C, depth, depth) int permutations.
    :param gates: (C, depth, depth//2, 4, 4) complex Haar gates.
    :param kraus: (K, 4, 4) complex Kraus stack, applied after every gate.
    :param uniforms: (C, depth, depth//2, T) branch-selection variates.
    :return: (C, 2^depth, T) probabilities (each column sums to one).
    """
    c, t = perms.shape[0], uniforms.shape[-1]
    n, n_kraus = 2 ** depth, kraus.shape[0]
    hmaps = _boundary_maps(perms, depth)
    w, mp = _fused_channel_ops(gates, kraus)
    rows = torch.arange(c, device=gates.device)[:, None]
    psi = torch.zeros((c, t, n), dtype=gates.dtype, device=gates.device)
    psi[..., 0] = 1.0

    def permute(x, h):
        return torch.gather(x, 2, h[:, None, :].expand(-1, t, -1))

    with full_f32_matmul():
        for l in range(depth):
            psi = permute(psi, hmaps[:, l])
            for j in range(depth // 2):
                ps = psi.reshape(c, t, 2 ** j, 4, 2 ** (depth - j - 2))
                rho = torch.einsum("ctlar,ctlbr->ctab", ps, ps.conj())
                p = torch.einsum("ckab,ctba->ckt", mp[:, l, j], rho).real
                p = p.clamp(min=0.0)
                p = p / p.sum(1, keepdim=True)
                below = torch.cumsum(p, 1) < uniforms[:, l, j][:, None, :]
                idx = below.sum(1).clamp(max=n_kraus - 1)          # (C, T)
                psi = torch.einsum("ctab,ctlbr->ctlar", w[:, l, j][rows, idx],
                                   ps).reshape(c, t, n)
            nrm2 = (psi.real ** 2 + psi.imag ** 2).sum(-1, keepdim=True)
            psi = psi * torch.rsqrt(nrm2.clamp(min=1e-30))
        psi = permute(psi, hmaps[:, depth])
    p = psi.real ** 2 + psi.imag ** 2
    return (p / p.sum(-1, keepdim=True)).transpose(1, 2)


def _traj_kernel_inputs(perms: torch.Tensor, gates: torch.Tensor,
                        kraus: torch.Tensor, uniforms: torch.Tensor,
                        depth: int):
    """Check the trajectory kernel's inputs and lay them out for it:
    (C, d+1, 2^d) int32 index maps, and the contiguous gates, Kraus stack
    and uniforms as given (the kernel forms W and M' itself)."""
    _check_depth(depth)
    c, slots, t = perms.shape[0], depth // 2, uniforms.shape[-1]
    n_kraus = kraus.shape[0]
    dev = gates.device
    if not 1 <= n_kraus <= MAX_KRAUS:
        raise ValueError(f"the trajectory kernel takes 1 to {MAX_KRAUS} "
                         f"Kraus operators, got {n_kraus}")
    _check_cuda("gates", gates, dev, torch.complex64, (c, depth, slots, 4, 4))
    _check_cuda("kraus", kraus, dev, torch.complex64, (n_kraus, 4, 4))
    _check_cuda("uniforms", uniforms, dev, torch.float32, (c, depth, slots, t))
    if perms.device != dev or perms.shape != (c, depth, depth):
        raise ValueError(f"perms must be (C, depth, depth) on {dev}")
    hmaps = _boundary_maps(perms, depth).to(torch.int32).contiguous()
    return hmaps, _laid_out(gates), _laid_out(kraus), uniforms.contiguous()


def _traj_launch(hmaps: torch.Tensor, gates: torch.Tensor,
                 kraus: torch.Tensor, uniforms: torch.Tensor,
                 depth: int) -> torch.Tensor:
    """One launch of the trajectory kernel on laid-out inputs; counts it."""
    c, t = hmaps.shape[0], uniforms.shape[-1]
    out = torch.empty((c, 2 ** depth, t), dtype=torch.float32,
                      device=hmaps.device)
    _launch(kernels.load().traj_probs_launch, hmaps.device, hmaps.data_ptr(),
            gates.data_ptr(), kraus.data_ptr(), uniforms.data_ptr(),
            out.data_ptr(), c, depth, kraus.shape[0], t)
    traj_probs.launches += 1
    return out


def traj_probs_kernel(perms: torch.Tensor, gates: torch.Tensor,
                      kraus: torch.Tensor, uniforms: torch.Tensor,
                      depth: int) -> torch.Tensor:
    """Launch the trajectory kernel of ``csrc/qv_traj.cu`` on PyTorch's
    current stream. Takes what :func:`traj_probs_reference` takes, with
    complex64 gates and Kraus operators and float32 uniforms on the card,
    and returns the (C, 2^depth, T) float32 probabilities. Adds one to
    ``traj_probs.launches`` per launch."""
    return _traj_launch(*_traj_kernel_inputs(perms, gates, kraus, uniforms,
                                             depth), depth)


def traj_probs(perms: torch.Tensor, gates: torch.Tensor, kraus: torch.Tensor,
               uniforms: torch.Tensor, depth: int) -> torch.Tensor:
    """Per-trajectory noisy output probabilities (C, 2^depth, T): the CUDA
    kernel for tensors on the card (complex64, float32 uniforms), the plain
    version for tensors on the CPU. ``traj_probs.launches`` counts kernel
    launches."""
    if gates.is_cuda:
        return traj_probs_kernel(perms, gates, kraus, uniforms, depth)
    if gates.device.type == "cpu":
        return traj_probs_reference(perms, gates, kraus, uniforms, depth)
    raise ValueError(f"unsupported device {gates.device}")


traj_probs.launches = 0


# ----------------------------------------------------------------------
# One shot from each trajectory, tallied against the heavy sets
# ----------------------------------------------------------------------

# torch.multinomial's two messages for rows it does not take, and the one
# of the shot kernel's flag, which stands for both
NOT_A_DISTRIBUTION = ("probability tensor contains either `inf`, `nan` or "
                      "element < 0")
ZERO_SUM = "invalid multinomial distribution (sum of probabilities <= 0)"
INVALID_ROWS = f"{NOT_A_DISTRIBUTION}, or {ZERO_SUM}"


def heavy_tallies_reference(traj: torch.Tensor, heavy: torch.Tensor,
                            q: torch.Tensor) -> torch.Tensor:
    """Heavy tallies of one shot from each trajectory, in plain PyTorch:
    what ``torch.multinomial(rows, 1, replacement=True)`` computes once it
    has drawn ``q`` (its single-sample route: the checks by
    ``torch._assert_async``, then the first index of the largest rows / q),
    on ``traj`` as it lies, gathered from the heavy sets and summed per
    circuit.

    :param traj: (C, 2^d, T) trajectory probabilities (:func:`traj_probs`).
    :param heavy: (C, 2^d) bool heavy sets.
    :param q: (C * T, 2^d) Exp(1) variates; the rows, trajectory t of
        circuit c at row c * T + t, are taken in ``q``'s dtype.
    :return: (C,) int64 heavy tallies.
    :raises RuntimeError: with ``torch.multinomial``'s message, where a row
        holds a NaN, an infinity or a negative number, or sums to zero (on
        the card, as there, a device-side assert).
    """
    c, n, t = traj.shape
    # the checks on float32 rows say what they say on the rows widened
    lo, hi = torch.aminmax(traj)
    torch._assert_async((hi < math.inf) & (lo >= 0), NOT_A_DISTRIBUTION)
    torch._assert_async(~(traj.sum(1) == 0).any(), ZERO_SUM)
    samples = torch.argmax(traj / q.view(c, t, n).transpose(1, 2), dim=1)
    return torch.gather(heavy, 1, samples).sum(1)


def _shots_launch(traj: torch.Tensor, heavy: torch.Tensor,
                  q: torch.Tensor) -> torch.Tensor:
    """One launch of the shot kernel on checked inputs; counts it. Returns
    its (C + 4,) int64 output: the tallies, the two checks' counts, the
    blocks' tickets and the flag (1 where no row fails a check)."""
    c, n, t = traj.shape
    out = torch.zeros(c + 4, dtype=torch.int64, device=traj.device)
    _launch(kernels.load().heavy_tallies_launch, traj.device,
            traj.data_ptr(), q.data_ptr(), heavy.data_ptr(), out.data_ptr(),
            c, n.bit_length() - 1, t, q.element_size())
    heavy_tallies.launches += 1
    return out


def heavy_tallies_kernel(traj: torch.Tensor, heavy: torch.Tensor,
                         q: torch.Tensor) -> torch.Tensor:
    """Launch the shot kernel of ``csrc/qv_shots.cu`` on PyTorch's current
    stream: :func:`heavy_tallies_reference` on float32 ``traj``, bool
    ``heavy`` and float32 or float64 ``q`` on one card, in one device launch
    after the zeroed output's fill. Rows that fail ``torch.multinomial``'s
    checks fail a ``torch._assert_async`` on the kernel's flag, as
    ``torch.multinomial``'s do on the card: no host waits for the kernel.
    Adds one to ``heavy_tallies.launches`` per launch."""
    if traj.dim() != 3:
        raise ValueError(f"traj must be (C, 2^depth, T), got {tuple(traj.shape)}")
    c, n, t = traj.shape
    depth = n.bit_length() - 1
    if n != 1 << depth:
        raise ValueError(f"traj's outputs must be 2^depth, got {n}")
    _check_depth(depth)
    dev = traj.device
    _check_cuda("traj", traj, dev, torch.float32, (c, n, t))
    _check_cuda("heavy", heavy, dev, torch.bool, (c, n))
    if q.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"q must be float32 or float64, got {q.dtype}")
    _check_cuda("q", q, dev, q.dtype, (c * t, n))
    traj, heavy, q = traj.contiguous(), heavy.contiguous(), q.contiguous()
    if q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned: the kernel reads it in "
                         "16-byte loads")
    if c * t == 0:
        return torch.zeros(c, dtype=torch.int64, device=dev)
    out = _shots_launch(traj, heavy, q)
    torch._assert_async(out[c + 3], INVALID_ROWS)
    return out[:c]


def heavy_tallies(traj: torch.Tensor, heavy: torch.Tensor,
                  q: torch.Tensor) -> torch.Tensor:
    """(C,) heavy tallies of one shot from each of the (C, 2^d, T)
    trajectories ``traj``, drawn with the (C * T, 2^d) exponential variates
    ``q`` as ``torch.multinomial`` draws one sample: the CUDA kernel for
    tensors on the card, the plain version for tensors on the CPU.
    ``heavy_tallies.launches`` counts kernel launches."""
    if traj.is_cuda:
        return heavy_tallies_kernel(traj, heavy, q)
    if traj.device.type == "cpu":
        return heavy_tallies_reference(traj, heavy, q)
    raise ValueError(f"unsupported device {traj.device}")


heavy_tallies.launches = 0


# ----------------------------------------------------------------------
# The JAX package's entry points, on (2, ...) real/imaginary planes
# ----------------------------------------------------------------------

def supports_pallas_traj(depth: int) -> bool:
    """Whether the CUDA kernels take circuits of ``depth``: ``MIN_DEPTH``
    to ``MAX_DEPTH``, the rule ``quantum_volume._use_kernels`` applies on
    the card (the JAX package's TPU kernels start at depth 7)."""
    return MIN_DEPTH <= depth <= MAX_DEPTH


def _join_planes(ri: torch.Tensor) -> torch.Tensor:
    """(2, ...) real and imaginary planes -> the complex tensor of their
    precision (float32 planes give complex64, the kernels' dtype)."""
    ri = torch.as_tensor(ri)
    return torch.complex(ri[0], ri[1])


def traj_probs_pallas(perms: torch.Tensor, gates_ri: torch.Tensor,
                      kraus_ri: torch.Tensor, uniforms: torch.Tensor,
                      depth: int, interpret: bool = False) -> torch.Tensor:
    """:func:`traj_probs` with the JAX package's signature: (2, C, depth,
    depth//2, 4, 4) gate planes and (2, K, 4, 4) Kraus planes -> (C,
    2^depth, T) probabilities. ``interpret=True`` runs the plain version
    :func:`traj_probs_reference` wherever the tensors lie; otherwise it
    dispatches as :func:`traj_probs` does (the kernel on the card, which
    takes float32 planes, the plain version on the CPU)."""
    gates, kraus = _join_planes(gates_ri), _join_planes(kraus_ri)
    if interpret:
        return traj_probs_reference(perms, gates, kraus, uniforms, depth)
    return traj_probs(perms, gates, kraus, uniforms, depth)


def ideal_probs_pallas(perms: torch.Tensor, gates_ri: torch.Tensor,
                       depth: int, interpret: bool = False,
                       perm_split3: bool = True) -> torch.Tensor:
    """:func:`ideal_probs` with the JAX package's signature: (2, C, depth,
    depth//2, 4, 4) gate planes -> (C, 2^depth) probabilities.
    ``interpret=True`` runs :func:`ideal_probs_reference` wherever the
    tensors lie; otherwise it dispatches as :func:`ideal_probs` does.
    ``perm_split3`` (a TPU matmul split of the boundary permutations) is
    taken and changes nothing: the permutations are gathers here."""
    gates = _join_planes(gates_ri)
    if interpret:
        return ideal_probs_reference(perms, gates, depth)
    return ideal_probs(perms, gates, depth)


def traj_flops_per_circuit(depth: int, n_kraus: int = 16,
                           num_trajectories: int = 1024,
                           noiseless: bool = False) -> float:
    """Floating-point operations of one circuit in the CUDA kernels.

    Per trajectory and layer: per slot (depth//2 of them) either a 4x4 gate
    apply (32 * 2^d, ``noiseless``) or the fused channel step (the hermitian
    pair-reduced density 16 * 2^d, the branch weights 2K * 16, the
    selection ~3K and one 4x4 apply of the sampled W_k 32 * 2^d), and in the
    noisy kernel one renormalization (~7 * 2^d). Plus the final output
    normalization (~4 * 2^d). Unlike the JAX package's count, the
    permutations cost nothing (they are gathers here, not one-hot matmuls),
    the sampled operator is picked by index, not materialized by a (K, 16)
    product, and each weight Re tr(M'_k rho) of two hermitian 4x4 matrices
    takes its 4 diagonal and 6 upper terms, 16 fused multiply-adds, not 16
    complex products.
    """
    d = float(2 ** depth)
    slots = depth // 2
    if noiseless:
        per_slot, renorm = 32 * d, 0.0
    else:
        per_slot = 16 * d + 2 * n_kraus * 16 + 3 * n_kraus + 32 * d
        renorm = 7 * d
    return num_trajectories * (depth * (slots * per_slot + renorm) + 4 * d)
