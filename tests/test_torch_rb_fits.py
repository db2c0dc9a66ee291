"""The numeric half of randomized benchmarking and the qubit-spectroscopy
fits of the port against the JAX package on the same numpy inputs, in
float64 on the CPU.

Bars: 1e-10 where the order of operations matches (the survival and purity
statistics, the IRB algebra, PTMs, the simulator's exact survivals); fits
within 1e-9 of JAX on parameters, or within it after one round-off tie of
a step decision flips (``torch_lm_ties``); the sampled survivals, whose
torch and ``jax.random`` streams differ, by distribution: the mean z-score
of each package's draws against the exact survivals within 4 standard
errors of 0, and the two packages' means within 4 standard errors of each
other; and the JAX suite's own bars for what its tests check.
"""
import numpy as np
import pytest
import jax
import torch

from forest_benchmarking_tpu import qubit_spectroscopy as jax_qs
from forest_benchmarking_tpu import randomized_benchmarking as jax_rb
from forest_benchmarking_tpu.analysis.fitting import (
    decay_time_param_decay, decaying_cosine, shifted_cosine)
from forest_benchmarking_tpu_torch import qubit_spectroscopy as qs
from forest_benchmarking_tpu_torch import randomized_benchmarking as rb
from torch_lm_ties import hold_against_jax

torch.set_num_threads(1)

MATCHED = 1e-10


def _params(fit):
    return [fit.best_values[k] for k in fit.param_names]


def _hold_fit(monkeypatch, port_fit, jax_fit):
    """A port fit (a function of no arguments returning a FitResult) held
    against the JAX package's FitResult; returns the port's."""
    hold_against_jax(monkeypatch, lambda: _params(port_fit()),
                     _params(jax_fit))
    ours = port_fit()
    for k in ours.param_names:
        assert abs(ours.params[k].stderr - jax_fit.params[k].stderr) \
            <= 1e-6 * abs(jax_fit.params[k].stderr)
    return ours


def test_survival_statistics():
    p, v = rb.z_obs_stats_to_survival_statistics([1.0], [0.0])
    assert p == 1.0 and v == 0.0
    p, v = rb.z_obs_stats_to_survival_statistics([0.0], [0.1])
    assert p == 0.5
    with pytest.raises(ValueError):
        rb.z_obs_stats_to_survival_statistics([0.5, 0.5, 0.5], [0.1] * 3)
    p, v = rb.z_obs_stats_to_survival_statistics([1, 1, 1], [0] * 3,
                                                 num_shots=100)
    assert np.isclose(p, 1.0)
    rng = np.random.RandomState(1)
    for n in (1, 2, 3):
        e = rng.uniform(-1, 1, 2 ** n - 1)
        s = rng.uniform(0, 0.1, 2 ** n - 1)
        for indep in (False, True):
            ours = rb.z_obs_stats_to_survival_statistics(e, s, 500, indep)
            want = jax_rb.z_obs_stats_to_survival_statistics(e, s, 500, indep)
            assert np.allclose(ours, want, rtol=0, atol=MATCHED)
    with pytest.raises(ValueError):
        rb.z_obs_stats_to_survival_statistics([0.1, 0.2], [0.1, 0.1], 10)


def test_covariances_of_all_iz_obs():
    assert np.isclose(rb.covariances_of_all_iz_obs([1, 1, 1], 100), 0.0)
    rng = np.random.RandomState(2)
    for n in (1, 2, 3):
        e = list(rng.uniform(-1, 1, 2 ** n - 1))
        assert abs(rb.covariances_of_all_iz_obs(e, 1000)
                   - jax_rb.covariances_of_all_iz_obs(e, 1000)) < MATCHED


def test_purity_estimates():
    dim = 2
    op_expect = np.array([1.0, 0, 0, 1.0])
    assert np.isclose(rb.estimate_purity(dim, op_expect), 1.0)
    assert np.isclose(rb.estimate_purity(dim, np.array([0, 0, 0, 1.0])), 0.0)
    assert rb.estimate_purity_err(dim, op_expect, np.array([0.01] * 4)) > 0
    rng = np.random.RandomState(3)
    for dim in (2, 4):
        e = np.append(rng.uniform(-1, 1, dim * dim - 1), 1.0)
        var = np.append(rng.uniform(0, 1e-3, dim * dim - 1), 0.0)
        var[0] = 1e-9   # the second-order branch
        for renorm in (True, False):
            assert abs(rb.estimate_purity(dim, e, renorm)
                       - jax_rb.estimate_purity(dim, e, renorm)) < MATCHED
            assert abs(rb.estimate_purity_err(dim, e, var.copy(), renorm)
                       - jax_rb.estimate_purity_err(dim, e, var.copy(),
                                                    renorm)) < MATCHED


def test_irb_algebra_round_trips():
    dim = 2
    rb_decay = 0.95
    gate_error = 0.02
    irb = rb.gate_error_to_irb_decay(gate_error, rb_decay, dim)
    assert np.isclose(rb.irb_decay_to_gate_error(irb, rb_decay, dim),
                      gate_error)
    decay = rb.average_gate_error_to_rb_decay(gate_error, dim)
    assert np.isclose(rb.rb_decay_to_gate_error(decay, dim), gate_error)
    lo, hi = rb.interleaved_gate_fidelity_bounds(irb, rb_decay, dim)
    assert lo <= 1 - gate_error <= hi
    lo_u, hi_u = rb.interleaved_gate_fidelity_bounds(irb, rb_decay, dim,
                                                     unitarity=rb_decay ** 2)
    assert hi_u - lo_u <= hi - lo
    assert np.isclose(rb.gamma(irb, rb_decay ** 2), irb / rb_decay)
    assert rb.coherence_angle(rb_decay, 1.0) >= 0
    for dim in (2, 4):
        for args, name in (((irb, rb_decay, dim), "irb_decay_to_gate_error"),
                           ((gate_error, rb_decay, dim),
                            "gate_error_to_irb_decay"),
                           ((gate_error, dim),
                            "average_gate_error_to_rb_decay"),
                           ((rb_decay, dim), "rb_decay_to_gate_error"),
                           ((0.9, dim), "unitarity_to_rb_decay"),
                           ((rb_decay, 0.95), "coherence_angle"),
                           ((irb, 0.95), "gamma")):
            assert abs(getattr(rb, name)(*args)
                       - getattr(jax_rb, name)(*args)) < MATCHED
        for u in (None, 0.95):
            assert np.allclose(
                rb.interleaved_gate_fidelity_bounds(irb, rb_decay, dim, u),
                jax_rb.interleaved_gate_fidelity_bounds(irb, rb_decay, dim,
                                                        u),
                rtol=0, atol=MATCHED)


def test_unitary_to_ptm_equals_jax():
    rng = np.random.RandomState(4)
    for d in (2, 4):
        z = rng.randn(d, d) + 1j * rng.randn(d, d)
        u, _ = np.linalg.qr(z)
        ours = rb.unitary_to_ptm_np(u)
        assert np.max(np.abs(ours - jax_rb.unitary_to_ptm_np(u))) < MATCHED
        assert np.allclose(ours @ ours.T, np.eye(d * d), atol=1e-12)


@pytest.fixture(scope="module")
def rb_sequences():
    """1Q RB sequences of the JAX suite's simulator test, as PTM stacks,
    with the JAX package's exact and sampled survivals."""
    depths = [d for d in [2, 6, 10, 16] for _ in range(6)]
    sequences = jax_rb.generate_rb_experiment_sequences((0,), depths,
                                                        random_seed=11)
    ptms, lengths = jax_rb.sequences_to_ptm_stack(sequences, (0,))
    noise = np.diag([1.0, 0.9, 0.9, 0.9])
    exact = np.asarray(jax_rb.simulate_rb_survival_batched(
        ptms, noise, lengths=lengths))
    sampled = np.asarray(jax_rb.simulate_rb_survival_batched(
        ptms, noise, key=jax.random.PRNGKey(0), num_shots=5000,
        lengths=lengths))
    return depths, ptms, lengths, noise, exact, sampled


def test_batched_rb_simulator_noiseless_and_noisy(rb_sequences):
    depths, ptms, lengths, noise, exact_jax, sampled_jax = rb_sequences
    surv = rb.simulate_rb_survival_batched(ptms, lengths=lengths,
                                           device="cpu").numpy()
    assert np.allclose(surv, 1.0, atol=1e-10)
    exact = rb.simulate_rb_survival_batched(ptms, noise, lengths=lengths,
                                            device="cpu").numpy()
    assert np.max(np.abs(exact - exact_jax)) < MATCHED
    for depth, s in zip(depths, exact):
        assert abs(s - (0.5 + 0.5 * 0.9 ** depth)) < 1e-10
    # identity padding past a sequence's length gets no noise
    padded = np.concatenate([ptms, np.tile(np.eye(4), (len(depths), 3, 1,
                                                       1))], axis=1)
    assert np.max(np.abs(rb.simulate_rb_survival_batched(
        padded, noise, lengths=lengths, device="cpu").numpy() - exact)) \
        < MATCHED
    # sampled: by distribution, and the decay is recovered
    gen = torch.Generator().manual_seed(0)
    sampled = rb.simulate_rb_survival_batched(
        ptms, noise, gen, num_shots=5000, lengths=lengths,
        device="cpu").numpy()
    sigma = np.sqrt(exact * (1 - exact) / 5000)
    n = len(depths)
    for draws in (sampled, sampled_jax):
        assert abs(np.mean((draws - exact) / sigma)) < 4 / np.sqrt(n)
    assert abs(np.mean((sampled - sampled_jax) / sigma)) \
        < 4 * np.sqrt(2 / n)
    assert np.allclose(sampled * 5000, np.round(sampled * 5000), atol=1e-6)
    fit = rb.fit_rb_results(depths, [[2 * s - 1] for s in sampled],
                            [[0.01] for _ in sampled], device="cpu")
    assert abs(fit.params["decay"].value - 0.9) < 0.02


def test_fit_rb_results_equal_jax(monkeypatch, rb_sequences):
    """The RB and unitarity fits of the same statistics as JAX's."""
    depths, _, _, _, _, sampled = rb_sequences
    z = [[2 * s - 1] for s in sampled]
    errs = [[np.sqrt(max(s * (1 - s), 1e-4) / 5000) * 2] for s in sampled]
    ours = _hold_fit(monkeypatch,
                     lambda: rb.fit_rb_results(depths, z, errs,
                                               device="cpu"),
                     jax_rb.fit_rb_results(depths, z, errs))
    assert abs(ours.params["decay"].value - 0.9) < 0.02
    rng = np.random.RandomState(6)
    u_depths = [d for d in [1, 4, 7, 10] for _ in range(8)]
    f = 0.9
    exps = [list(f ** d * np.array([1.0, 0.6, -0.8])
                 + rng.normal(0, 0.01, 3)) for d in u_depths]
    u_errs = [[0.01] * 3 for _ in u_depths]
    fit = _hold_fit(monkeypatch,
                    lambda: rb.fit_unitarity_results(u_depths, exps, u_errs,
                                                     device="cpu"),
                    jax_rb.fit_unitarity_results(u_depths, exps, u_errs))
    assert abs(fit.params["decay"].value - f ** 2) < 0.02
    with pytest.raises(ValueError):
        rb.fit_rb_results(depths[:-1], z, errs, device="cpu")


def test_survival_variance_closes_to_bernoulli_any_group_size():
    rng = np.random.RandomState(5)
    num_shots = 1000
    for n in (1, 2, 3):
        dim = 2 ** n
        p = rng.dirichlet(np.ones(dim))
        outcomes = np.arange(dim)
        expectations, variances = [], []
        for k in range(1, dim):
            signs = (-1.0) ** np.array([bin(k & o).count("1")
                                        for o in outcomes])
            e = float((p * signs).sum())
            expectations.append(e)
            variances.append((1 - e ** 2) / num_shots)
        surv, var = rb.z_obs_stats_to_survival_statistics(
            expectations, np.sqrt(variances), num_shots=num_shots)
        assert np.isclose(surv, p[0], atol=1e-12)
        assert np.isclose(var, p[0] * (1 - p[0]) / num_shots, atol=1e-12), n


def _pauli_series(rng, p_one, shots=4000):
    """(negated-Pauli expectations, their standard errors) of P(1) data."""
    e = 1 - 2 * rng.binomial(shots, np.clip(p_one, 0, 1)) / shots
    return e, np.sqrt(np.clip(1 - e ** 2, 1e-4, None) / shots)


def test_spectroscopy_fits_equal_jax(monkeypatch):
    rng = np.random.RandomState(7)
    cases = []
    times = np.linspace(1, 40, 15)
    cases.append(("fit_t1_results", times,
                  _pauli_series(rng, decay_time_param_decay(times, 1.0, 12.0)),
                  "decay_time", 12.0, 1.0))
    times = np.linspace(0.5, 20, 25)
    cases.append(("fit_t2_results", times,
                  _pauli_series(rng, decaying_cosine(times, 0.5, 9.0, 0.0,
                                                     0.5, 1.0)),
                  "decay_time", 9.0, 1.5))
    angles = np.linspace(0, 2 * np.pi, 20)
    cases.append(("fit_rabi_results", angles,
                  _pauli_series(rng, shifted_cosine(angles, -0.5, 0, 0.5,
                                                    1.0)),
                  "frequency", 1.0, 0.02))
    angles = np.linspace(-np.pi, np.pi, 20)
    cases.append(("fit_cz_phase_ramsey_results", angles,
                  _pauli_series(rng, shifted_cosine(angles, 0.5, 0.4, 0.5,
                                                    1.0)),
                  "offset", 0.4, 0.05))
    for name, x, (e, s), key, truth, bar in cases:
        for errs in (s, None):
            fit = _hold_fit(
                monkeypatch,
                lambda: getattr(qs, name)(x, e, errs, device="cpu"),
                getattr(jax_qs, name)(x, e, errs))
            assert abs(fit.params[key].value - truth) < bar, (name, key)
    for errs in ([0.1, 0.0, 0.2], None):
        ours = qs._pauli_to_weights([0.2, -0.4, 0.9], errs)
        want = jax_qs._pauli_to_weights([0.2, -0.4, 0.9], errs)
        assert np.array_equal(ours[0], want[0])
        assert (ours[1] is None and want[1] is None) or np.allclose(
            ours[1], want[1], rtol=0, atol=MATCHED)
    assert (qs.MICROSECOND, qs.MHZ) == (jax_qs.MICROSECOND, jax_qs.MHZ)


def test_numpy_input_needs_a_card_unless_asked_for_the_cpu(rb_sequences):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    depths, ptms, lengths, noise, _, sampled = rb_sequences
    z = [[2 * s - 1] for s in sampled]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rb.fit_rb_results(depths, z, [[0.01]] * len(z))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rb.simulate_rb_survival_batched(ptms, noise, lengths=lengths)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        qs.fit_t1_results(np.arange(5.0), np.linspace(-1, 0.5, 5))
    # tensors run where they lie
    out = rb.simulate_rb_survival_batched(torch.tensor(ptms), noise,
                                          lengths=lengths)
    assert out.device.type == "cpu"
