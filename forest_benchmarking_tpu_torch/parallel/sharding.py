"""Multi-device scaling: shard the problem batch across a device mesh.

Port of ``forest_benchmarking_tpu/parallel/sharding.py``. The JAX package
places a global array on a 1-D ``jax.sharding.Mesh`` and lets ``shard_map``
run a kernel on each device's shard. PyTorch has no single-process global
sharded tensor (``DTensor`` needs ``torch.distributed`` process groups), so
here one process drives the devices of a small :class:`Mesh`: the batch is
split on its leading axis into equal shards, each shard's work is queued on
its device, and the outputs are concatenated on the mesh's first device.
The estimators are elementwise in the batch, so a shard's result is what
the same call on that shard alone gives, and no collective is needed.

A mesh may repeat a device (``make_mesh([cpu] * 8)`` in the tests,
``[cuda:0, cuda:0]`` on a one-card machine); its shards then run one after
the other on that device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

__all__ = ["make_mesh", "shard_batch", "replicate", "batch_sharded",
           "shard_map_batched", "fold_in", "Mesh"]

BATCH_AXIS = "batch"

_MASK64 = (1 << 64) - 1


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: its devices, in shard order, and its axis name."""
    devices: Tuple[torch.device, ...]
    axis_name: str = BATCH_AXIS

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_name: len(self.devices)}


class Sharded(tuple):
    """Per-device shards of a batch, in mesh order (:func:`shard_batch`)."""

    @property
    def shape(self) -> torch.Size:
        """The shape of the whole batch, as a sharded JAX array has it."""
        return torch.Size([sum(s.shape[0] for s in self), *self[0].shape[1:]])


class Replicated(tuple):
    """One copy of a value per mesh device (:func:`replicate`)."""


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = BATCH_AXIS) -> Mesh:
    """A 1-D mesh over the given devices (repeats allowed) or, by default,
    over every card of ``torch.cuda.device_count()``; without a card the
    default raises ``RuntimeError``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass the mesh's devices, e.g. "
                               "make_mesh([torch.device('cpu')] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices, axis_name)


def _split(x: torch.Tensor, mesh: Mesh, axis_name: str) -> Sharded:
    n = mesh.shape[axis_name]
    if x.shape[0] % n != 0:
        raise ValueError(f"batch {x.shape[0]} must be divisible by the mesh "
                         f"axis {axis_name!r} size {n}")
    return Sharded(s.to(d) for s, d in zip(torch.chunk(x, n), mesh.devices))


def shard_batch(mesh: Mesh, x, axis_name: str = BATCH_AXIS) -> Sharded:
    """Split a tensor's leading (batch) axis into equal shards, shard i on
    ``mesh.devices[i]``."""
    return _split(torch.as_tensor(x), mesh, axis_name)


def replicate(mesh: Mesh, x) -> Replicated:
    """One copy of a tensor on each device of the mesh."""
    x = torch.as_tensor(x)
    return Replicated(x.to(d) for d in mesh.devices)


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(generator: torch.Generator, index: int,
            device=None) -> torch.Generator:
    """A new generator on ``device`` (the parent's by default) for stream
    ``index`` of ``generator``: seeded with a fixed mix (splitmix64) of the
    parent's ``initial_seed()`` and ``index``, the counterpart of
    ``jax.random.fold_in``. It depends on the parent's seed, not on what
    has been drawn from it."""
    device = generator.device if device is None else torch.device(device)
    seed = _splitmix64(_splitmix64(generator.initial_seed() & _MASK64)
                       ^ (index & _MASK64))
    return torch.Generator(device=device).manual_seed(seed)


def _tree_map(fn, tree):
    if isinstance(tree, (Sharded, Replicated)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _place(x, mesh: Mesh, split: bool, axis_name: str):
    """A tensor split into shards or copied to each device; anything else,
    and what is already placed, as it is."""
    if isinstance(x, (Sharded, Replicated)) or not isinstance(x, torch.Tensor):
        return x
    if split:
        return _split(x, mesh, axis_name)
    return Replicated(x.to(d) for d in mesh.devices)


def _shard_args(args, mesh: Mesh, batched, folded, axis_name: str):
    """Each shard's positional arguments: batched tensors split, generators
    folded, other tensors copied to the shard's device."""
    per_shard = [[] for _ in mesh.devices]
    for i, arg in enumerate(args):
        if i in folded:
            placed = Replicated(fold_in(arg, s, d)
                                for s, d in enumerate(mesh.devices))
        else:
            placed = _tree_map(
                lambda x: _place(x, mesh, i in batched, axis_name), arg)
        for s, shard_args in enumerate(per_shard):
            shard_args.append(_tree_map(
                lambda x: x[s] if isinstance(x, (Sharded, Replicated))
                else x, placed))
    return per_shard


def _concat(outs, device: torch.device):
    first = outs[0]
    if isinstance(first, dict):
        return {k: _concat([o[k] for o in outs], device) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_concat(list(parts), device)
                           for parts in zip(*outs))
    return torch.cat([o.to(device) for o in outs])


def shard_map_batched(fn, mesh: Mesh, batched_argnums: Sequence[int] = (0,),
                      fold_key_argnums: Sequence[int] = (),
                      axis_name: str = BATCH_AXIS, check_vma: bool = False):
    """Map a per-device kernel over a 1-D batch mesh.

    The generalization behind every sharded entry point
    (``ops.lanes_apg.apg_fused_sharded``, ``ops.lanes_dnorm.
    dnorm_fused_sharded``, ``quantum_volume.sample_heavy_outputs_sharded``):
    the tensors of positional args in ``batched_argnums`` (tensors, or
    tuples, lists and dicts of them) are split on their leading axis into
    one shard per device; args in ``fold_key_argnums`` are
    ``torch.Generator``s, and shard i gets ``fold_in(generator, i, device)``;
    every other tensor is copied to each device. ``fn`` runs once per shard
    on that shard's device, every shard queued before the outputs are
    gathered; each output's leading axes are concatenated, in shard order,
    on ``mesh.devices[0]``. So the result equals running each shard alone
    on its device with ``fold_in(generator, shard)`` and concatenating.
    Inputs already placed by :func:`shard_batch` or :func:`replicate` are
    taken as they are.

    ``check_vma`` is accepted at the JAX signature's position and does
    nothing: it switches JAX's varying-manual-axes checker inside
    ``shard_map``, and this one-process map has no such checker, so the
    mapped function is the same for either value.
    """
    del check_vma
    batched = frozenset(batched_argnums)
    folded = frozenset(fold_key_argnums)

    def wrapped(*args):
        outs = []
        for dev, sargs in zip(mesh.devices,
                              _shard_args(args, mesh, batched, folded,
                                          axis_name)):
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    outs.append(fn(*sargs))
            else:
                outs.append(fn(*sargs))
        return _concat(outs, mesh.devices[0])

    return wrapped


def batch_sharded(fn, mesh: Mesh, axis_name: str = BATCH_AXIS):
    """``fn(shared, batched) -> batched`` with the batch axis sharded.

    ``shared`` is replicated (e.g. the A-matrix or a noise PTM); the leading
    axis of every tensor of ``batched`` (a tensor, or a tuple, list or dict
    of them) is split across the mesh, and the outputs' leading axes are
    concatenated on the mesh's first device. The estimators are independent
    per batch element, so every shard's compute is local to its device.
    """
    return shard_map_batched(fn, mesh, batched_argnums=(1,),
                             axis_name=axis_name)
