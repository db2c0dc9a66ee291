"""The port's batch sharding on a CPU mesh of eight entries, against the
JAX package's virtual 8-device mesh (``tests/test_parallel_and_entry.py``).

- ``make_mesh([cpu] * 8)``: the shards' shapes and devices; ``make_mesh()``
  takes every card and raises without one.
- ``batch_sharded`` PGDB within 1e-12 of the JAX package's sharded PGDB on
  the same inputs (``:31-48``).
- ``apg_fused_sharded`` (JAX's short schedule, ``:51-71``): bitwise equal
  to the per-shard ``apg_fused`` runs concatenated, and within 1e-12 of the
  unsharded run. On the CPU the plain version's products are MKL's, whose
  summation order moves with the batch size, so bitwise equality with the
  unsharded run holds on the card, where the kernel is elementwise in the
  batch (``tests/test_torch_cuda.py``), not here.
- ``dnorm_fused_sharded`` within 1e-12 of ``dnorm_fused`` at dim = 2
  (``:181-200``).
- ``sample_heavy_outputs_sharded``, ideal and by trajectories, bitwise
  equal to the per-shard runs with ``fold_in`` (``:92-134``).
- ``fold_in`` streams differ between shards and repeat for the same seed
  and index; the ``batch_sharded`` RB simulation (``:137-160``); the
  "divisible" errors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forest_benchmarking_tpu import parallel as jpar
from forest_benchmarking_tpu.benchmarks import (
    process_tomo_A_matrix as jax_a_matrix,
    synth_process_datasets as jax_synth)
from forest_benchmarking_tpu.randomized_benchmarking import (
    simulate_rb_survival_batched as jax_simulate_rb)
from forest_benchmarking_tpu.tomography import (
    pgdb_process_estimate_batched as jax_pgdb_batched)
from forest_benchmarking_tpu_torch import quantum_volume as qv
from forest_benchmarking_tpu_torch.benchmarks import (
    process_tomo_A_matrix, synth_process_datasets)
from forest_benchmarking_tpu_torch.ops.lanes_apg import (
    apg_fused, apg_fused_sharded)
from forest_benchmarking_tpu_torch.ops.lanes_dnorm import (
    dnorm_fused, dnorm_fused_sharded)
from forest_benchmarking_tpu_torch.ops.random_operators import (
    rand_map_with_BCSZ_dist)
from forest_benchmarking_tpu_torch.parallel import (
    Mesh, batch_sharded, fold_in, make_mesh, replicate, shard_batch,
    shard_map_batched)
from forest_benchmarking_tpu_torch.parallel import sharding
from forest_benchmarking_tpu_torch.randomized_benchmarking import (
    generate_rb_experiment_sequences, sequences_to_ptm_stack,
    simulate_rb_survival_batched)
from forest_benchmarking_tpu_torch.sim.noise import depolarizing_kraus_map
from forest_benchmarking_tpu_torch.tomography import (
    pgdb_process_estimate_batched)

torch.set_num_threads(1)

CPU = torch.device("cpu")
SHORT = dict(dim=4, phases=((4, 1, 1), (4, 2, 1)), init_iters=4,
             final_iters=6)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh([CPU] * 8)


def test_mesh_and_shards(mesh):
    assert isinstance(mesh, Mesh) and mesh.shape == {"batch": 8}
    assert mesh.devices == (CPU,) * 8
    x = torch.arange(16.0).reshape(16, 1)
    shards = shard_batch(mesh, x)
    assert len(shards) == 8 and shards.shape == (16, 1)
    assert all(s.shape == (2, 1) and s.device == CPU for s in shards)
    assert torch.equal(torch.cat(shards), x)
    copies = replicate(mesh, torch.eye(3))
    assert len(copies) == 8 and all(torch.equal(c, torch.eye(3))
                                    for c in copies)
    assert make_mesh(["cpu"], axis_name="shots").shape == {"shots": 1}
    with pytest.raises(ValueError, match="divisible"):
        shard_batch(mesh, torch.zeros(12))
    assert sharding.BATCH_AXIS == "batch"
    assert list(jpar.sharding.__all__) == sharding.__all__[:5]


def test_default_mesh_takes_the_cards_and_raises_without_one():
    if torch.cuda.is_available():
        assert len(make_mesh().devices) == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_batch_sharded_pgdb_equals_jax(mesh):
    a = jnp.asarray(jax_a_matrix(2))
    n, _ = jax_synth(jax.random.PRNGKey(0), a, 4, 16, 500, dtype=jnp.float64)
    jmesh = jpar.make_mesh()
    want = np.asarray(jpar.batch_sharded(
        lambda s, b: jax_pgdb_batched(s, b, dim=4, maxiter=8, dyk_iters=20),
        jmesh)(jpar.replicate(jmesh, a), jpar.shard_batch(jmesh, n)))
    fn = batch_sharded(lambda s, b: pgdb_process_estimate_batched(
        s, b, dim=4, maxiter=8, dyk_iters=20), mesh)
    got = fn(torch.tensor(np.asarray(a)), torch.tensor(np.asarray(n)))
    assert got.shape == (16, 16, 16) and got.device == CPU
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12)


@pytest.fixture(scope="module")
def counts():
    a = torch.tensor(process_tomo_A_matrix(2))
    n, _ = synth_process_datasets(torch.Generator().manual_seed(3), a, 4, 16,
                                  500, dtype=torch.float64)
    return a, n


def test_apg_fused_sharded_equals_the_per_shard_runs(mesh, counts):
    a, n = counts
    got = apg_fused_sharded(a, n, mesh, **SHORT)
    per_shard = torch.cat([apg_fused(a, s, **SHORT) for s in n.split(2)])
    assert torch.equal(got, per_shard)
    np.testing.assert_allclose(got.numpy(), apg_fused(a, n, **SHORT).numpy(),
                               atol=1e-12)
    # placed inputs, as the JAX package's test passes them
    placed = apg_fused_sharded(replicate(mesh, a), shard_batch(mesh, n),
                               mesh, **SHORT)
    assert torch.equal(placed, got)
    with pytest.raises(ValueError, match="divisible"):
        apg_fused_sharded(a, n[:12], mesh, **SHORT)


def test_dnorm_fused_sharded_equals_unsharded(mesh):
    g = torch.Generator().manual_seed(11)
    c0 = rand_map_with_BCSZ_dist(g, 2, 4, batch=(16,))
    c1 = rand_map_with_BCSZ_dist(g, 2, 4, batch=(16,))
    want = dnorm_fused(c0, c1, num_iters=16)
    got = dnorm_fused_sharded(c0, c1, mesh, num_iters=16)
    assert got.shape == (16,)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12)
    with pytest.raises(ValueError, match="divisible"):
        dnorm_fused_sharded(c0[:12], c1[:12], mesh, num_iters=16)


def test_sample_heavy_outputs_sharded_equals_per_shard_streams(mesh):
    parent = torch.Generator().manual_seed(11)
    depth, per_dev, shots = 4, 5, 64
    ks = depolarizing_kraus_map(0.05)
    kraus = np.stack([np.kron(a, b) for a in ks for b in ks])
    for kw in ({}, dict(kraus=kraus, noisy_method="trajectory",
                        num_trajectories=16)):
        got = qv.sample_heavy_outputs_sharded(
            parent, mesh, depth=depth, num_circuits=per_dev * 8,
            num_shots=shots, **kw)
        want = torch.cat([qv.sample_heavy_outputs_batched(
            fold_in(parent, d), depth, per_dev, shots, device="cpu", **kw)
            for d in range(8)])
        assert got.shape == (40,) and torch.equal(got, want)
    with pytest.raises(ValueError, match="divisible"):
        qv.sample_heavy_outputs_sharded(parent, mesh, depth=depth,
                                        num_circuits=17, num_shots=shots)


def test_fold_in_streams():
    parent = torch.Generator().manual_seed(5)
    draws = [torch.rand(4, generator=fold_in(parent, i)) for i in range(8)]
    assert len({tuple(d.tolist()) for d in draws}) == 8
    torch.rand(10, generator=parent)     # drawing from the parent moves nothing
    again = torch.rand(4, generator=fold_in(
        torch.Generator().manual_seed(5), 3))
    assert torch.equal(again, draws[3])
    other = torch.rand(4, generator=fold_in(
        torch.Generator().manual_seed(6), 3))
    assert not torch.equal(other, draws[3])
    assert fold_in(parent, 0, "cpu").device == CPU


def test_batch_sharded_rb_simulation_equals_jax(mesh):
    depths = [d for d in [2, 6, 10, 16] for _ in range(4)]
    seqs = generate_rb_experiment_sequences((0,), depths, random_seed=5)
    ptms, lengths = sequences_to_ptm_stack(seqs, (0,))
    noise = torch.diag(torch.tensor([1.0, 0.9, 0.9, 0.9], dtype=torch.float64))
    want = np.asarray(jax_simulate_rb(jnp.asarray(ptms),
                                      jnp.asarray(noise.numpy()),
                                      lengths=jnp.asarray(lengths)))
    fn = batch_sharded(lambda shared, batched: simulate_rb_survival_batched(
        batched[0], shared, lengths=batched[1]), mesh)
    got = fn(noise, (torch.tensor(ptms), torch.tensor(lengths)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12)
    unsharded = simulate_rb_survival_batched(
        torch.tensor(ptms), noise, lengths=torch.tensor(lengths))
    assert torch.equal(got, unsharded)


def test_shard_map_batched_trees_and_outputs(mesh):
    """Batched trees are split leaf by leaf, other tensors copied, and a
    tuple of outputs concatenated leaf by leaf."""
    seen = []

    def fn(x, pair, scale):
        seen.append(x.shape[0])
        return x * scale, {"sum": pair[0] + pair[1]}

    x = torch.arange(8.0)
    out, d = shard_map_batched(fn, mesh, batched_argnums=(0, 1))(
        x, (x, 2 * x), torch.tensor(3.0))
    assert seen == [1] * 8
    assert torch.equal(out, 3 * x) and torch.equal(d["sum"], 3 * x)


@pytest.mark.parametrize("check_vma", [False, True])
def test_shard_map_batched_takes_jaxs_check_vma(check_vma):
    """JAX's ``check_vma`` keyword (and its position) is accepted and
    changes nothing: on a 2-entry CPU mesh the mapped function equals the
    one made without it, as ``jax.shard_map`` returns a mapped function
    for either value."""
    mesh2 = make_mesh([CPU] * 2)

    def fn(x, scale):
        return x * scale + x.sum()

    x = torch.arange(6.0, dtype=torch.float64)
    scale = torch.tensor(2.0, dtype=torch.float64)
    plain = shard_map_batched(fn, mesh2)(x, scale)
    by_name = shard_map_batched(fn, mesh2, check_vma=check_vma)(x, scale)
    by_position = shard_map_batched(fn, mesh2, (0,), (), "batch",
                                    check_vma)(x, scale)
    jax_mapped = jpar.shard_map_batched(lambda v: v, jpar.make_mesh(
        jax.devices("cpu")[:1]), check_vma=check_vma)
    assert callable(jax_mapped)
    assert torch.equal(by_name, plain) and torch.equal(by_position, plain)
    assert torch.equal(plain, torch.cat([fn(s, scale) for s in x.chunk(2)]))
