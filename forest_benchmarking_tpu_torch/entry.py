"""Entry points: the flagship step, and a dry run with the batch sharded
over a device mesh.

The port's counterpart of the JAX package's ``__graft_entry__.py``.

- :func:`entry` returns ``(step, args)``: ``step(a, generator)`` draws 64
  random two-qubit channels and their counts at 1000 shots a setting
  (``benchmarks.synth_process_datasets``), estimates them with the
  headline configuration of the batched process-tomography MLE
  (warm-started APG, one Dykstra iteration in the loop, one converged
  projection at the end) and returns each estimate's process fidelity to
  its channel and their mean.
- :func:`dryrun_multichip` builds an ``n``-device mesh
  (``parallel.make_mesh``) and runs five legs with the problem batch
  sharded over it: the headline step, the fused APG solve (sharded against
  unsharded), noisy quantum volume by trajectories, the fused diamond norm
  (sharded against unsharded) and ideal quantum volume (sharded against
  the per-shard runs). On the card the legs launch the fused APG kernel,
  the trajectory kernel and the ideal kernel; each leg prints a line, and
  a leg outside its bar raises.

Both run on the card unless called with ``device="cpu"``; without a card
they raise. On the CPU the kernels' plain versions run, in float64.

    python -c 'from forest_benchmarking_tpu_torch import entry; \\
               entry.dryrun_multichip(4)'
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from forest_benchmarking_tpu_torch.benchmarks import (
    process_tomo_A_matrix, synth_process_datasets)
from forest_benchmarking_tpu_torch.distance_measures import process_fidelity
from forest_benchmarking_tpu_torch.ops.superoperator_transformations import (
    choi2pauli_liouville)
from forest_benchmarking_tpu_torch.tomography import (
    pgdb_process_estimate_batched)
from forest_benchmarking_tpu_torch.utils import entry_device

__all__ = ["entry", "dryrun_multichip", "estimate", "build_step",
           "N_QUBITS", "DIM", "SHOTS", "ENTRY_BATCH"]

N_QUBITS = 2
DIM = 4
SHOTS = 1000
ENTRY_BATCH = 64


def estimate(a: torch.Tensor, n: torch.Tensor, stop_tol: float = 1e-6,
             maxiter: int = 25, dyk_tol: float = 1e-4,
             dyk_iters: int = 40) -> torch.Tensor:
    """The headline solver configuration: warm-started APG with one
    Dykstra iteration inside the loop and one converged projection at the
    end, per-problem convergence."""
    return pgdb_process_estimate_batched(
        a, n, dim=DIM, stop_tol=stop_tol, maxiter=maxiter, dyk_tol=dyk_tol,
        dyk_iters=dyk_iters, method="apg", loop_dyk_iters=1, warm_start=True)


def build_step(batch: int, mesh=None, **solver) -> Callable:
    """``step(a, generator) -> (pf, mean_pf)`` at ``batch`` problems:
    random channels and their counts drawn from ``generator`` on its
    device, estimated by :func:`estimate` (``solver`` overrides its
    tolerances; with a ``mesh``, each device estimates its shard of the
    batch), scored by the process fidelity of the Pauli-Liouville forms."""
    def solve(a_, n_):
        return estimate(a_, n_, **solver)

    if mesh is not None:
        from forest_benchmarking_tpu_torch.parallel import shard_map_batched
        solve = shard_map_batched(solve, mesh, batched_argnums=(1,))

    def step(a: torch.Tensor, generator: torch.Generator):
        n, true_chois = synth_process_datasets(generator, a, DIM, batch,
                                               SHOTS, dtype=a.real.dtype)
        est = solve(a, n).to(true_chois.device)
        pf = process_fidelity(choi2pauli_liouville(true_chois),
                              choi2pauli_liouville(est)).real
        return pf, pf.mean()
    return step


def _real_dtype(dev: torch.device) -> torch.dtype:
    """float32 on the card (the kernels' type), float64 on the CPU."""
    return torch.float32 if dev.type == "cuda" else torch.float64


def _complex_dtype(dev: torch.device) -> torch.dtype:
    return torch.complex64 if dev.type == "cuda" else torch.complex128


def a_matrix(dev: torch.device) -> torch.Tensor:
    """The (1080, 256) two-qubit A-matrix on ``dev``."""
    return torch.tensor(process_tomo_A_matrix(N_QUBITS),
                        dtype=_complex_dtype(dev), device=dev)


def entry(device=None) -> Tuple[Callable, tuple]:
    """``(step, (a, generator))``: the flagship step at B = 64 and its
    arguments, on the card unless ``device="cpu"``."""
    dev = entry_device(device)
    return build_step(ENTRY_BATCH), (
        a_matrix(dev), torch.Generator(device=dev).manual_seed(0))


def _check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {message}")


def _mesh_devices(n_devices: int, dev: torch.device):
    """The mesh's devices and a line saying which they are: the first
    ``n_devices`` cards, or the machine's cards repeated in turn where it
    has fewer; ``n_devices`` CPU entries on the CPU."""
    if dev.type != "cuda":
        return [dev] * n_devices, f"{n_devices} CPU entries"
    count = torch.cuda.device_count()
    devices = [torch.device("cuda", i % count) for i in range(n_devices)]
    if count >= n_devices:
        return devices, f"the first {n_devices} of {count} card(s)"
    return devices, (f"{count} card(s) repeated to {n_devices} shards (a "
                     f"card runs its shards one after the other)")


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the five legs with the batch sharded over an ``n_devices`` mesh
    (the JAX package's sizes and bars); returns each leg's figures."""
    from forest_benchmarking_tpu_torch.ops.lanes_apg import (
        apg_fused, apg_fused_sharded)
    from forest_benchmarking_tpu_torch.ops.lanes_dnorm import (
        dnorm_fused, dnorm_fused_sharded)
    from forest_benchmarking_tpu_torch.ops.random_operators import (
        rand_map_with_BCSZ_dist)
    from forest_benchmarking_tpu_torch.parallel import fold_in, make_mesh
    from forest_benchmarking_tpu_torch.quantum_volume import (
        sample_heavy_outputs_batched, sample_heavy_outputs_sharded)
    from forest_benchmarking_tpu_torch.sim.noise import depolarizing_kraus_map

    dev = entry_device(device)
    real = _real_dtype(dev)
    devices, which = _mesh_devices(n_devices, dev)
    mesh = make_mesh(devices)
    tag = f"dryrun_multichip({n_devices})"
    print(f"{tag}: mesh over {which}")
    out = {}

    # leg 1: the headline step over the sharded batch, at the JAX dry
    # run's shorter tolerances
    batch = 4 * n_devices
    step = build_step(batch, mesh, stop_tol=1e-4, maxiter=10, dyk_iters=20)
    a = a_matrix(dev)
    pf, mean_pf = step(a, torch.Generator(device=dev).manual_seed(1))
    _check(pf.shape == (batch,), f"headline pf shape {tuple(pf.shape)}")
    _check(bool(torch.isfinite(mean_pf)), f"headline mean pf {mean_pf}")
    out["headline_mean_pf"] = float(mean_pf)
    print(f"{tag}: headline ok — pf mean {float(mean_pf):.4f}, batch {batch} "
          f"sharded over {n_devices} devices")

    # leg 2: the fused APG solve at its default schedule, sharded over the
    # mesh against one unsharded call on the same counts
    fused_batch = 16 * n_devices
    n, true_chois = synth_process_datasets(
        torch.Generator(device=dev).manual_seed(2), a, DIM, fused_batch,
        SHOTS, dtype=real)
    est = apg_fused_sharded(a, n, mesh, dim=DIM)
    est_single = apg_fused(a, n, dim=DIM)
    rel = (torch.linalg.matrix_norm(est - true_chois)
           / torch.linalg.matrix_norm(true_chois)).cpu().numpy()
    gap = float((est - est_single).abs().max())
    _check(rel.shape == (fused_batch,) and bool(np.all(np.isfinite(rel))),
           f"fused relative errors {rel}")
    mean_rel = float(rel.mean())
    # at 1000 shots a setting the converged estimator's relative Frobenius
    # error floor is ~0.12-0.14: a broken solver leaves both bars
    _check(0.08 < mean_rel < 0.20, f"fused mean relative error {mean_rel}")
    _check(float(rel.max()) < 3 * mean_rel,
           f"fused max relative error {rel.max()} against mean {mean_rel}")
    # the solve is elementwise in the batch: bitwise on the card; on the
    # CPU the plain version's products sum in an order that moves with the
    # batch size
    if dev.type == "cuda":
        _check(torch.equal(est, est_single), f"sharded APG differs by {gap}")
    else:
        _check(gap <= 1e-12, f"sharded APG differs by {gap}")
    out.update(fused_mean_rel=mean_rel, fused_max_over_mean=float(
        rel.max()) / mean_rel, fused_shard_gap=gap)
    print(f"{tag}: fused parity config ok — mean rel err {mean_rel:.4f} "
          f"(shot-noise floor ~0.13), max/mean "
          f"{float(rel.max()) / mean_rel:.2f}, sharded-vs-single max gap "
          f"{gap:.2e}, batch {fused_batch} over {n_devices} devices")

    # leg 3: noisy quantum volume by trajectories, circuits sharded
    ks = depolarizing_kraus_map(0.02)
    two_q = torch.tensor(np.stack([np.kron(k1, k2) for k1 in ks for k2 in ks]),
                         dtype=_complex_dtype(dev), device=dev)
    qv_circuits, qv_shots = 4 * n_devices, 64
    counts = sample_heavy_outputs_sharded(
        torch.Generator(device=dev).manual_seed(3), mesh, depth=4,
        num_circuits=qv_circuits, num_shots=qv_shots, dtype=real,
        kraus=two_q, noisy_method="trajectory", num_trajectories=16)
    _check(counts.shape == (qv_circuits,), f"QV counts {tuple(counts.shape)}")
    frac = float(counts.sum()) / (qv_circuits * qv_shots)
    _check(0.2 < frac < 1.0, f"noisy QV heavy fraction {frac}")
    out["noisy_qv_heavy_fraction"] = frac
    print(f"{tag}: sharded noisy QV ok — heavy fraction {frac:.3f}, "
          f"{qv_circuits} circuits over {n_devices} devices")

    # leg 4: the fused diamond norm of 1Q BCSZ pairs, sharded against one
    # unsharded call
    dn_batch = 2 * n_devices
    g = torch.Generator(device=dev).manual_seed(4)
    c0, c1 = (rand_map_with_BCSZ_dist(g, 2, 4, batch=(dn_batch,), dtype=real)
              for _ in range(2))
    vals = dnorm_fused_sharded(c0, c1, mesh, num_iters=32)
    vals_single = dnorm_fused(c0, c1, num_iters=32)
    dn_gap = float((vals - vals_single).abs().max())
    _check(vals.shape == (dn_batch,) and bool(torch.isfinite(vals).all()),
           f"dnorm values {vals}")
    # random BCSZ pairs are well-separated channels
    _check(bool((vals > 0.3).all()) and bool((vals < 2.0 + 1e-5).all()),
           f"dnorm values {vals}")
    _check(dn_gap < 1e-5, f"sharded dnorm differs by {dn_gap}")
    out.update(dnorm_min=float(vals.min()), dnorm_max=float(vals.max()),
               dnorm_shard_gap=dn_gap)
    print(f"{tag}: sharded fused dnorm ok — range [{float(vals.min()):.3f}, "
          f"{float(vals.max()):.3f}], sharded-vs-single max gap "
          f"{dn_gap:.2e}, batch {dn_batch} over {n_devices} devices")

    # leg 5: ideal quantum volume at depth 7, sharded, against every
    # shard's sub-batch run alone with its folded generator
    iq_depth, iq_circuits, iq_shots = 7, 2 * n_devices, 200
    parent = torch.Generator(device=dev).manual_seed(5)
    ideal = sample_heavy_outputs_sharded(
        parent, mesh, depth=iq_depth, num_circuits=iq_circuits,
        num_shots=iq_shots, dtype=real)
    _check(ideal.shape == (iq_circuits,), f"ideal QV {tuple(ideal.shape)}")
    per_dev = iq_circuits // n_devices
    single = torch.cat([
        sample_heavy_outputs_batched(
            fold_in(parent, i, d), depth=iq_depth, num_circuits=per_dev,
            num_shots=iq_shots, dtype=real, device=d).to(ideal.device)
        for i, d in enumerate(mesh.devices)])
    _check(torch.equal(ideal, single),
           f"sharded ideal QV {ideal.tolist()} != per shard {single.tolist()}")
    frac = float(ideal.sum()) / (iq_circuits * iq_shots)
    # the ideal heavy-output probability is near (1 + ln 2)/2 ~ 0.85
    _check(0.6 < frac < 1.0, f"ideal QV heavy fraction {frac}")
    out["ideal_qv_heavy_fraction"] = frac
    print(f"{tag}: sharded ideal QV ok — depth {iq_depth}, heavy fraction "
          f"{frac:.3f}, sharded == single (bit-exact), {iq_circuits} "
          f"circuits over {n_devices} devices")
    return out
