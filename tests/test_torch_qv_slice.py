"""The port's batched quantum-volume path against the JAX package: the heavy
set, the exact density forms, the trajectory method against the density
method, the heavy-output probability, the depth scan and the analysis."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forest_benchmarking_tpu import quantum_volume as jax_qv
from forest_benchmarking_tpu.sim import noise as jax_noise
from forest_benchmarking_tpu_torch import quantum_volume as qv
from forest_benchmarking_tpu_torch.benchmarks import qv_inputs_from_numpy
from forest_benchmarking_tpu_torch.sim import noise

torch.set_num_threads(1)


def qv_circuit(seed, depth):
    """One model circuit's (perms, gates) from the JAX package's host
    generator."""
    perms, gates = jax_qv.generate_abstract_qv_circuit(
        depth, np.random.RandomState(seed))
    return np.stack(perms), gates


def depolarizing_2q(p):
    ks = noise.depolarizing_kraus_map(p)
    return np.stack([np.kron(a, b) for a in ks for b in ks])


def port_heavy(depth, circuits, shots, seed, **kw):
    return int(qv.sample_heavy_outputs_batched(
        torch.Generator().manual_seed(seed), depth, circuits, shots,
        dtype=torch.float64, device="cpu", **kw).sum())


def test_noise_maps_equal_jax():
    for p in (0.02, 0.15):
        np.testing.assert_array_equal(
            np.stack(noise.depolarizing_kraus_map(p)),
            np.stack(jax_noise.depolarizing_kraus_map(p)))
    probs = np.random.default_rng(0).dirichlet(np.ones(16))
    np.testing.assert_array_equal(np.stack(noise.pauli_kraus_map(probs)),
                                  np.stack(jax_noise.pauli_kraus_map(probs)))


@pytest.mark.parametrize("depth", [3, 6, 8])
def test_heavy_set_is_jax_median_rule(depth):
    """``probs > median`` with the median of an even count taken as the mean
    of the two middle values, as ``jnp.median`` takes it: exactly half the
    outputs are heavy. (With the strict comparison the lower middle value,
    which ``torch.median`` returns, gives the same set on distinct values;
    ``>=`` against it would mark one more.)"""
    probs = np.random.default_rng(depth).dirichlet(np.ones(2 ** depth),
                                                   size=5)
    got = qv._heavy_outputs(torch.tensor(probs)).numpy()
    want = np.asarray(probs > jnp.median(probs, axis=1, keepdims=True))
    np.testing.assert_array_equal(got, want)
    assert (got.sum(axis=1) == 2 ** (depth - 1)).all()


@pytest.mark.parametrize("depth", [3, 4])
def test_density_tensor_form_matches_jax(depth):
    perms, gates = qv_circuit(30 + depth, depth)
    kraus = depolarizing_2q(0.15)
    inp = qv_inputs_from_numpy(perms[None], gates[None], kraus, device="cpu",
                               dtype=torch.float64)
    got = qv._simulate_qv_circuit_density(inp.perms[0], inp.gates[0],
                                          inp.kraus, depth)
    want = jax_qv._simulate_qv_circuit_density(
        jnp.asarray(perms), jnp.asarray(gates), jnp.asarray(kraus), depth)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)


@pytest.mark.parametrize("depth", [3, 6])
def test_density_lifted_form_matches_jax(depth):
    perms, gates = qv_circuit(40 + depth, depth)
    kraus = depolarizing_2q(0.15)
    inp = qv_inputs_from_numpy(perms[None], gates[None], kraus, device="cpu",
                               dtype=torch.float64)
    lifts = tuple(qv._lift_2q(inp.kraus, j, depth) for j in range(depth // 2))
    jax_lifts = tuple(jax.vmap(lambda m, jj=j: jax_qv._lift_2q(m, jj, depth))(
        jnp.asarray(kraus)) for j in range(depth // 2))
    for mine, theirs in zip(lifts, jax_lifts):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    got = qv._simulate_qv_circuit_density_lifted(inp.perms[0], inp.gates[0],
                                                 lifts, depth)
    want = jax_qv._simulate_qv_circuit_density_lifted(
        jnp.asarray(perms), jnp.asarray(gates), jax_lifts, depth)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)
    if depth < 6:
        tensor_form = qv._simulate_qv_circuit_density(
            inp.perms[0], inp.gates[0], inp.kraus, depth)
        np.testing.assert_allclose(got.numpy(), tensor_form.numpy(),
                                   atol=1e-12)


def test_trajectory_heavy_counts_match_density_path():
    """As the JAX package's test: the trajectory method (one and four shots
    per trajectory) agrees with the exact density method within a 4-sigma
    binomial window (variance bounded by 1/4 per shot) on the same
    circuits."""
    kraus = depolarizing_2q(0.15)
    depth, circuits, shots = 4, 40, 200
    sigma = np.sqrt(2 * 0.25 * circuits * shots)
    n_dens = port_heavy(depth, circuits, shots, 9, kraus=kraus,
                        noisy_method="density")
    for t in (None, 50):
        n_traj = port_heavy(depth, circuits, shots, 9, kraus=kraus,
                            noisy_method="trajectory", num_trajectories=t)
        assert abs(n_dens - n_traj) < 4 * sigma
    with pytest.raises(ValueError, match="must divide"):
        port_heavy(depth, circuits, shots, 9, kraus=kraus,
                   noisy_method="trajectory", num_trajectories=33)
    with pytest.raises(ValueError, match="noisy_method"):
        port_heavy(depth, circuits, shots, 9, kraus=kraus, noisy_method="x")


@pytest.mark.parametrize("noisy", [False, True])
def test_heavy_output_probability_matches_jax(noisy):
    """Depth 4, ideal and 2% depolarizing (the density method). The random
    streams differ, so the two packages are held in distribution: their
    heavy-output probabilities within 4 sigma, sigma from a per-shot
    variance bounded by 1/4 over both samples."""
    depth, circuits, shots = 4, 200, 100
    kraus = depolarizing_2q(0.02) if noisy else None
    mine = port_heavy(depth, circuits, shots, 4, kraus=kraus)
    theirs = int(np.asarray(jax_qv.sample_heavy_outputs_batched(
        jax.random.PRNGKey(4), depth, circuits, shots, dtype=jnp.float64,
        kraus=kraus)).sum())
    total = circuits * shots
    assert 0.7 < mine / total < 0.95
    assert abs(mine - theirs) / total < 4 * np.sqrt(2 * 0.25 / total)


def test_measure_quantum_volume_batched_runs_on_cpu():
    kw = dict(max_depth=4, num_circuits=50, num_shots=100,
              stop_when_fail=False)
    results = qv.measure_quantum_volume_batched(dtype=torch.float64,
                                                device="cpu", **kw)
    jax_results = jax_qv.measure_quantum_volume_batched(
        jax.random.PRNGKey(0), dtype=jnp.float64, **kw)
    assert sorted(results) == sorted(jax_results) == [2, 3, 4]
    for prob, conf in results.values():
        assert 0.7 < prob < 0.95 and conf < prob
    # a failing depth ends the scan
    stopped = qv.measure_quantum_volume_batched(
        max_depth=4, num_circuits=50, num_shots=100, dtype=torch.float64,
        achievable_threshold=0.99, device="cpu")
    assert list(stopped) == [2]


def test_calculate_prob_est_and_err_equals_jax():
    for args in ((700, 100, 10), (1331, 1600, 1), (85000, 100, 1000)):
        assert qv.calculate_prob_est_and_err(*args) == \
            jax_qv.calculate_prob_est_and_err(*args)


def test_extract_quantum_volume_equals_jax():
    for results in ({2: (0.9, 0.8), 3: (0.85, 0.7), 4: (0.6, 0.5)},
                    {2: (0.5, 0.4)}, {3: (0.9, 0.8), 2: (0.9, 0.8)}):
        assert qv.extract_quantum_volume_from_results(results) == \
            jax_qv.extract_quantum_volume_from_results(results)


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        qv.sample_heavy_outputs_batched(None, 4, 2, 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        qv.measure_quantum_volume_batched(max_depth=2, num_circuits=2)
