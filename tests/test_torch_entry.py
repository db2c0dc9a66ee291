"""``forest_benchmarking_tpu_torch.entry``, the port's counterpart of the
JAX package's ``__graft_entry__.py``, on the CPU: the flagship step's
shape, its estimator against the JAX package's on the same counts in
float64, and the five-leg dry run on a four-entry CPU mesh."""
import numpy as np
import pytest
import torch

from forest_benchmarking_tpu.tomography import (
    pgdb_process_estimate_batched as jax_pgdb_batched)
from forest_benchmarking_tpu_torch import entry
from forest_benchmarking_tpu_torch.benchmarks import (
    process_tomo_A_matrix, synth_process_datasets)

torch.set_num_threads(1)


def test_entry_step_gives_finite_fidelities_of_shape_64():
    step, (a, generator) = entry.entry(device="cpu")
    assert a.device.type == "cpu" and generator.device.type == "cpu"
    pf, mean_pf = step(a, generator)
    assert pf.shape == (64,)
    assert torch.isfinite(pf).all() and torch.isfinite(mean_pf)
    assert torch.allclose(mean_pf, pf.mean())


def test_entry_needs_the_card_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        entry.entry()
    with pytest.raises(RuntimeError):
        entry.dryrun_multichip(2)


@pytest.fixture(scope="module")
def counts():
    """B = 64 two-qubit count vectors at 1000 shots, float64 numpy."""
    a = torch.tensor(process_tomo_A_matrix(2), dtype=torch.complex128)
    n, _ = synth_process_datasets(torch.Generator().manual_seed(7), a, 4,
                                  entry.ENTRY_BATCH, entry.SHOTS,
                                  dtype=torch.float64)
    return a.numpy(), n.numpy()


def test_estimator_equals_jax_on_the_same_counts(counts):
    """The step's estimator (warm-started APG, one Dykstra iteration in
    the loop, stop_tol 1e-6, 25 iterations, Dykstra 1e-4 / 40) equals the
    JAX package's ``pgdb_process_estimate_batched`` with the same
    arguments (``__graft_entry__.py:47-50``) within 1e-10 in float64."""
    a, n = counts
    ours = entry.estimate(torch.tensor(a), torch.tensor(n)).numpy()
    theirs = np.asarray(jax_pgdb_batched(
        a, n, dim=4, stop_tol=1e-6, maxiter=25, dyk_tol=1e-4, dyk_iters=40,
        method="apg", loop_dyk_iters=1, warm_start=True))
    assert ours.shape == theirs.shape == (entry.ENTRY_BATCH, 16, 16)
    assert np.max(np.abs(ours - theirs)) < 1e-10


def test_dryrun_multichip_on_four_cpu_entries(capsys):
    out = entry.dryrun_multichip(4, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "dryrun_multichip(4): mesh over 4 CPU entries"
    assert [line.split(" ok")[0] for line in lines[1:]] == [
        f"dryrun_multichip(4): {leg}" for leg in (
            "headline", "fused parity config", "sharded noisy QV",
            "sharded fused dnorm", "sharded ideal QV")]
    assert np.isfinite(out["headline_mean_pf"])
    assert 0.08 < out["fused_mean_rel"] < 0.20
    assert out["fused_shard_gap"] <= 1e-12
    assert out["dnorm_shard_gap"] < 1e-5
    assert 0.2 < out["noisy_qv_heavy_fraction"] < 1
    assert 0.6 < out["ideal_qv_heavy_fraction"] < 1
