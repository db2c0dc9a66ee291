"""Structure-keyed circuit execution: the one route of the port's QVM.

Port of ``forest_benchmarking_tpu/sim/executor.py``, with its public names.
A :class:`CircuitPlan` splits a circuit into its *structure* (the qubit
axes of each operation, the shapes of their values, noise slots, readout
confusion, marginalization) and its *values* (gate matrices and Kraus
channels, stacked by shape into one host-to-device copy each, and the
confusion matrix). The JAX package compiles one program per structure; the
port keeps, per structure, what it builds once and reuses for every
circuit of that structure (:class:`_Program`: the tensor axes of every
contraction, the |0..0> start state and the I/X flip pair on the device,
the bit shifts). Circuits that differ only in gate values reuse it;
:func:`executor_cache_info` counts the hits and misses.

On the density route every operation, unitary or Kraus channel, is one
superoperator contraction (:mod:`.density`); the pure route applies the
gate matrices to the state tensor. Readout symmetrization runs all flip
patterns as one batched call: the pattern is a leading batch axis of the
state, the flip layer (I or X per measured qubit) comes after the circuit
and before readout confusion, and the shots of every pattern are drawn in
one ``torch.multinomial`` call from an explicit ``torch.Generator``.
Complex tensors stay on the device; only the bits leave it.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from forest_benchmarking_tpu_torch.circuits import Circuit
from forest_benchmarking_tpu_torch.ops.lanes_apg import full_f32_matmul
from forest_benchmarking_tpu_torch.sim.density import (
    _confusion_np, _gate_channels, _superop_np)
from forest_benchmarking_tpu_torch.sim.statevector import apply_gate_matrix
from forest_benchmarking_tpu_torch.utils import entry_device

__all__ = ["CircuitPlan", "build_plan", "sample_bits", "sample_bits_symmetrized",
           "executor_cache_info", "clear_executor_cache"]

_MAX_CACHE_ENTRIES = 512
_CACHE: "OrderedDict[tuple, _Program]" = OrderedDict()
_CACHE_HITS = 0
_CACHE_MISSES = 0

_X_MAT = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex)
_I_MAT = np.eye(2, dtype=complex)


def executor_cache_info() -> Dict[str, int]:
    return {"entries": len(_CACHE), "hits": _CACHE_HITS, "misses": _CACHE_MISSES}


def clear_executor_cache() -> None:
    global _CACHE_HITS, _CACHE_MISSES
    _CACHE.clear()
    _CACHE_HITS = 0
    _CACHE_MISSES = 0


def _real_dtype(cdtype: torch.dtype) -> torch.dtype:
    return torch.float64 if cdtype == torch.complex128 else torch.float32


class CircuitPlan:
    """Static structure + value pools for one circuit execution.

    ``ops`` is a tuple of (axes, pool_shape, pool_index) descriptors: on the
    density route each value is the superoperator of a gate or of a Kraus
    channel, on the pure route a gate matrix. The values live in ``pools``,
    grouped by shape so that each shape crosses to the device as one
    stacked tensor (:meth:`args`).
    """

    def __init__(self, circuit: Circuit, qubits: Sequence[int], cdtype,
                 t1s: Optional[dict], t2s: Optional[dict], noisy: bool,
                 device=None):
        qubits = list(qubits)
        sim_qubits = sorted(set(circuit.get_qubits()) | set(qubits))
        pos = {q: i for i, q in enumerate(sim_qubits)}
        n = len(sim_qubits)
        needs_density = bool(
            circuit.gate_noise or circuit.readout_confusion or noisy
            or ((t1s or t2s) and any(g.name == "DELAY" for g in circuit.gates)))

        ops: List[Tuple] = []
        pools: Dict[Tuple[int, ...], List[np.ndarray]] = {}

        def push(axes: Tuple[int, ...], value: np.ndarray):
            pool = pools.setdefault(value.shape, [])
            ops.append((axes, value.shape, len(pool)))
            pool.append(value)

        for gate in circuit.gates:
            axes = tuple(pos[q] for q in gate.qubits)
            if not needs_density:
                push(axes, gate.get_matrix())
                continue
            push(axes, _superop_np(gate.get_matrix()[None]))
            for kraus in _gate_channels(circuit, gate, t1s, t2s):
                push(axes, _superop_np(kraus))

        # marginalization of the n-qubit distribution onto `qubits`
        keep = [pos[q] for q in qubits]
        kept_sorted = [q for q in sim_qubits if q in set(qubits)]

        self.n = n
        self.sim_qubits = sim_qubits
        self.meas_axes = tuple(keep)
        self.needs_density = needs_density
        self.ops = tuple(ops)
        self.pool_shapes = tuple(sorted(pools))
        self.pools = pools
        self.confusion = (_confusion_np(circuit, sim_qubits)
                          if needs_density else None)
        self.drop_axes = tuple(i for i in range(n) if i not in keep)
        self.perm = tuple(kept_sorted.index(q) for q in qubits)
        self.cdtype = cdtype
        self.fdtype = _real_dtype(cdtype)
        self.device = entry_device(device)

    # ---- static structure key (what the cached program depends on) ----
    def key(self) -> tuple:
        return (self.n, self.needs_density, self.ops, self.pool_shapes,
                self.confusion is not None, self.drop_axes, self.perm,
                str(self.cdtype), self.meas_axes, str(self.device))

    # ---- the values, on the device ----
    def args(self):
        stacked = tuple(torch.tensor(np.stack(self.pools[s]), dtype=self.cdtype,
                                     device=self.device)
                        for s in self.pool_shapes)
        conf = () if self.confusion is None else (
            torch.tensor(self.confusion, dtype=self.fdtype, device=self.device),)
        return stacked, conf

    def trace_probs(self, stacked, conf,
                    flips: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Probability vector over the measured qubits.

        ``flips``, if given, are extra one-qubit unitaries on the measured
        axes after the circuit and before readout confusion (the
        symmetrization flip layer): (k, 2, 2) gives (2^k,) probabilities,
        (P, k, 2, 2) gives (P, 2^k), one row per pattern.
        """
        return self.program().probs(stacked, conf, flips)

    def program(self) -> "_Program":
        """The cached program of this plan's structure (a hit or a miss of
        :func:`executor_cache_info`)."""
        return _cache_get(self.key(), lambda: _Program(self))


class _Program:
    """What one plan structure needs beyond its values, built once: the
    tensor axes of every contraction, the start state, the I/X flip pair
    and the bit shifts, on the plan's device."""

    def __init__(self, plan: CircuitPlan):
        n, density = plan.n, plan.needs_density
        self.n, self.density = n, density
        index = {s: i for i, s in enumerate(plan.pool_shapes)}
        self.steps = tuple(
            (index[shape], idx,
             list(axes) + ([n + a for a in axes] if density else []))
            for axes, shape, idx in plan.ops)
        width = 2 * n if density else n
        self.start = torch.zeros((2,) * width, dtype=plan.cdtype,
                                 device=plan.device)
        self.start[(0,) * width] = 1.0
        self.meas_axes = plan.meas_axes
        self.drop_axes = plan.drop_axes
        self.perm = plan.perm
        self.flip_pair = torch.tensor(np.stack([_I_MAT, _X_MAT]),
                                      dtype=plan.cdtype, device=plan.device)
        k = len(plan.meas_axes)
        self.shifts = torch.arange(k - 1, -1, -1, device=plan.device)

    def _flip(self, t: torch.Tensor, f: torch.Tensor, axis: int,
              batched: bool) -> torch.Tensor:
        if not batched:
            return apply_gate_matrix(t, f, [axis])
        # f: (P, 2, 2), t: (P, ...) -> out_b = sum_a f[p, b, a] t[p, .., a, ..]
        out = torch.einsum("p...a,pba->p...b", t.movedim(axis, -1), f)
        return out.movedim(-1, axis)

    def probs(self, stacked, conf, flips=None) -> torch.Tensor:
        n = self.n
        t = self.start
        with full_f32_matmul():
            for pool, idx, axes in self.steps:
                t = apply_gate_matrix(t, stacked[pool][idx], axes)
            lead = 0
            if flips is not None:
                batched = flips.dim() == 4
                if batched:
                    lead = 1
                    t = t.expand((flips.shape[0],) + t.shape)
                for i, ax in enumerate(self.meas_axes):
                    f = flips[..., i, :, :]
                    t = self._flip(t, f, lead + ax, batched)
                    if self.density:
                        t = self._flip(t, f.conj(), lead + n + ax, batched)
            shape = t.shape[:lead]
            if self.density:
                d = 2 ** n
                p = torch.diagonal(t.reshape(shape + (d, d)), dim1=-2,
                                   dim2=-1).real.clamp(min=0)
                p = p / p.sum(-1, keepdim=True)
                if conf:
                    p = p @ conf[0].T
            else:
                p = t.reshape(shape + (-1,)).abs() ** 2
                p = p / p.sum(-1, keepdim=True)
        # marginalize + reorder to the requested qubit order
        pt = p.reshape(shape + (2,) * n)
        if self.drop_axes:
            pt = pt.sum(dim=[lead + a for a in self.drop_axes])
        pt = pt.permute(list(range(lead)) + [lead + i for i in self.perm])
        return pt.reshape(shape + (-1,))


def _cache_get(key: tuple, make) -> _Program:
    global _CACHE_HITS, _CACHE_MISSES
    prog = _CACHE.get(key)
    if prog is not None:
        _CACHE_HITS += 1
        _CACHE.move_to_end(key)
        return prog
    _CACHE_MISSES += 1
    prog = make()
    _CACHE[key] = prog
    while len(_CACHE) > _MAX_CACHE_ENTRIES:
        _CACHE.popitem(last=False)
    return prog


def build_plan(circuit: Circuit, qubits: Sequence[int], cdtype,
               t1s=None, t2s=None, noisy: bool = False,
               device=None) -> CircuitPlan:
    return CircuitPlan(circuit, qubits, cdtype, t1s, t2s, noisy, device)


def sample_bits(plan: CircuitPlan, num_shots: int,
                generator: torch.Generator) -> torch.Tensor:
    """(num_shots, k) 0/1 samples on the plan's device, most significant
    bit (the first measured qubit) first, drawn from ``generator``."""
    prog = plan.program()
    ints = torch.multinomial(prog.probs(*plan.args()), num_shots,
                             replacement=True, generator=generator)
    return (ints[..., None] >> prog.shifts) & 1


def sample_bits_symmetrized(plan: CircuitPlan, patterns: np.ndarray,
                            shots_per_pattern: int,
                            generator: torch.Generator) -> torch.Tensor:
    """One batched call for ALL flip patterns.

    Returns (n_patterns, shots_per_pattern, k) bits on the plan's device,
    already XORed with each pattern. The flip layer acts on the state
    before readout confusion: the same distributions as appending X gates
    per pattern.
    """
    prog = plan.program()
    pats = torch.as_tensor(np.asarray(patterns, dtype=np.int64),
                           device=plan.device)
    probs = prog.probs(*plan.args(), prog.flip_pair[pats])
    ints = torch.multinomial(probs, shots_per_pattern, replacement=True,
                             generator=generator)
    return ((ints[..., None] >> prog.shifts) & 1) ^ pats[:, None, :]
