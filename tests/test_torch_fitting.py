"""The port's batched Levenberg-Marquardt fitter and models against the JAX
package's on the same numpy inputs, in float64 on the CPU, and against
scipy's ``curve_fit``.

Bars: parameters within 1e-9 of JAX (or within it after one round-off tie
of a step decision flips, ``torch_lm_ties``), standard errors within 1e-6
of JAX's relative to their size; against scipy 1e-5 on parameters and 1e-3
relative on standard errors; 1e-10 where the order of operations matches
(the Cholesky solve), 1e-12 relative for the models; and the JAX suite's own
bars for what its tests check.
"""
import json

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from scipy.optimize import curve_fit

from forest_benchmarking_tpu.analysis import fitting as jax_fitting
from forest_benchmarking_tpu_torch.analysis import fitting
from torch_lm_ties import hold_against_jax

torch.set_num_threads(1)

MATCHED = 1e-10
STDERR = 1e-6


def _data(name):
    """(x, y, fit keyword arguments) of each JAX-suite fit case."""
    if name == "base":
        rng = np.random.RandomState(0)
        x = np.arange(1, 30)
        y = fitting.base_param_decay(x, 0.6, 0.93, 0.4) \
            + rng.normal(0, 0.003, len(x))
        return x, y, {}
    if name == "scipy":
        rng = np.random.RandomState(1)
        x = np.arange(1, 25).astype(float)
        y = fitting.base_param_decay(x, 0.5, 0.9, 0.45) \
            + rng.normal(0, 0.01, len(x))
        return x, y, {}
    if name == "decay_time":
        rng = np.random.RandomState(2)
        x = np.linspace(0, 60, 30)
        y = fitting.decay_time_param_decay(x, 1.0, 15.0) \
            + rng.normal(0, 0.005, len(x))
        return x, y, {}
    if name == "decaying_cosine":
        rng = np.random.RandomState(3)
        x = np.linspace(0, 4, 60)
        y = fitting.decaying_cosine(x, 0.5, 8.0, 0.3, 0.5, 4.8) \
            + rng.normal(0, 0.01, len(x))
        return x, y, dict(param_guesses=(0.5, 10, 0.0, 0.5, 5))
    if name == "shifted_cosine":
        rng = np.random.RandomState(4)
        x = np.linspace(0, 2 * np.pi, 40)
        y = fitting.shifted_cosine(x, 0.5, 0.2, 0.5, 1.0) \
            + rng.normal(0, 0.01, len(x))
        return x, y, {}
    x = np.arange(1, 20).astype(float)   # "weights"
    y = fitting.base_param_decay(x, 0.5, 0.9, 0.5)
    y[-1] += 0.5
    w = np.ones_like(x)
    w[-1] = 1e-6  # effectively ignores the corrupted point
    return x, y, dict(weights=w)


FITS = {"base": "fit_base_param_decay", "scipy": "fit_base_param_decay",
        "decay_time": "fit_decay_time_param_decay",
        "decaying_cosine": "fit_decaying_cosine",
        "shifted_cosine": "fit_shifted_cosine",
        "weights": "fit_base_param_decay"}


@pytest.fixture(scope="module")
def jax_fits():
    """Each case fitted once by the JAX package."""
    out = {}
    for name, fn in FITS.items():
        x, y, kw = _data(name)
        out[name] = getattr(jax_fitting, fn)(x, y, **kw)
    return out


def _port_fit(monkeypatch, jax_fits, name):
    """The port's fit of a case, held against JAX's; returns the FitResult."""
    x, y, kw = _data(name)
    want = jax_fits[name]
    names = want.param_names

    def fit():
        return getattr(fitting, FITS[name])(x, y, device="cpu", **kw)

    hold_against_jax(monkeypatch,
                     lambda: [fit().best_values[k] for k in names],
                     [want.best_values[k] for k in names])
    got = fit()
    assert got.param_names == names
    for k in names:
        assert abs(got.params[k].stderr - want.params[k].stderr) \
            <= STDERR * abs(want.params[k].stderr)
    assert abs(got.chisqr - want.chisqr) <= 1e-9 * want.chisqr + 1e-15
    return got


def test_fit_base_param_decay_recovers_params(monkeypatch, jax_fits):
    fit = _port_fit(monkeypatch, jax_fits, "base")
    assert abs(fit.params["decay"].value - 0.93) < 0.01
    assert abs(fit.params["amplitude"].value - 0.6) < 0.05
    assert fit.params["decay"].stderr < 0.02
    assert fit.success


def test_fit_matches_scipy_curve_fit(monkeypatch, jax_fits):
    ours = _port_fit(monkeypatch, jax_fits, "scipy")
    x, y, _ = _data("scipy")
    popt, pcov = curve_fit(lambda x, a, d, b: b + a * d ** x, x, y,
                           p0=[1.0, 0.9, 0.0])
    names = ("amplitude", "decay", "baseline")
    assert np.allclose([ours.params[k].value for k in names], popt,
                       atol=1e-5)
    assert np.allclose([ours.params[k].stderr for k in names],
                       np.sqrt(np.diag(pcov)), rtol=1e-3)


def test_fit_decay_time(monkeypatch, jax_fits):
    fit = _port_fit(monkeypatch, jax_fits, "decay_time")
    assert abs(fit.params["decay_time"].value - 15.0) < 0.5


def test_fit_decaying_cosine(monkeypatch, jax_fits):
    fit = _port_fit(monkeypatch, jax_fits, "decaying_cosine")
    assert abs(fit.params["frequency"].value - 4.8) < 0.05
    assert abs(fit.params["decay_time"].value - 8.0) < 1.5


def test_fit_shifted_cosine(monkeypatch, jax_fits):
    fit = _port_fit(monkeypatch, jax_fits, "shifted_cosine")
    assert abs(fit.params["amplitude"].value - 0.5) < 0.02
    assert abs(fit.params["frequency"].value - 1.0) < 0.02


def test_weights_affect_fit(monkeypatch, jax_fits):
    fit = _port_fit(monkeypatch, jax_fits, "weights")
    assert abs(fit.params["decay"].value - 0.9) < 0.005
    x, y, kw = _data("weights")
    assert np.allclose(fit.residual, (fit.best_fit - y) * kw["weights"])
    assert np.allclose(fit.residual, jax_fits["weights"].residual,
                       atol=1e-9)


def test_batched_fits_match_singles(monkeypatch):
    rng = np.random.RandomState(5)
    x = np.arange(1, 25).astype(float)
    decays = rng.uniform(0.85, 0.98, 16)
    ys = np.stack([fitting.base_param_decay(x, 0.5, d, 0.5)
                   + rng.normal(0, 0.005, len(x)) for d in decays])
    p0 = np.array([1.0, 0.9, 0.0])
    want, want_chi, want_cov = (np.asarray(v) for v in
                                jax_fitting.fit_model_batched(
                                    jax_fitting._base_param_decay_p, x, ys,
                                    None, p0))

    def fit():
        return fitting.fit_model_batched(fitting._base_param_decay_p, x, ys,
                                         None, p0, device="cpu")[0].numpy()

    params = hold_against_jax(monkeypatch, fit, want)
    _, chis, covs = fitting.fit_model_batched(
        fitting._base_param_decay_p, x, ys, None, p0, device="cpu")
    assert np.allclose(chis.numpy(), want_chi, rtol=1e-9, atol=0)
    assert np.allclose(covs.numpy(), want_cov, rtol=1e-5, atol=0)
    for i in range(16):
        single = fitting.fit_base_param_decay(x, ys[i], device="cpu")
        assert abs(params[i, 1] - single.params["decay"].value) < 1e-8
        assert abs(params[i, 1] - decays[i]) < 0.01


def test_fit_result_to_json(jax_fits):
    x = np.arange(1, 15)
    y = fitting.base_param_decay(x, 0.5, 0.9, 0.5)
    ours = fitting.fit_result_to_json(fitting.fit_base_param_decay(
        x, y, device="cpu"))
    want = jax_fitting.fit_result_to_json(jax_fitting.fit_base_param_decay(
        x, y))
    s = json.dumps(ours)
    assert "chisqr" in s and "decay" in s
    assert ours.keys() == want.keys()
    assert ours["params"].keys() == want["params"].keys()
    for k in ours["best_values"]:
        assert abs(ours["best_values"][k] - want["best_values"][k]) < 1e-9


def test_mismatched_lengths_raise():
    with pytest.raises(ValueError):
        fitting.fit_base_param_decay(np.arange(5), np.arange(6),
                                     device="cpu")
    with pytest.raises(ValueError):
        fitting.fit_base_param_decay(np.arange(5), np.arange(5),
                                     weights=np.arange(4), device="cpu")
    with pytest.raises(ValueError, match="param_guesses"):
        fitting.fit_model(fitting._base_param_decay_p, ("a", "d", "b"),
                          np.arange(5), np.arange(5), device="cpu")


@pytest.mark.parametrize("model,n_params", [
    ("_base_param_decay_p", 3), ("_decay_time_param_decay_p", 3),
    ("_decaying_cosine_p", 5), ("_shifted_cosine_p", 4)])
def test_models_equal_jax(model, n_params):
    rng = np.random.RandomState(n_params)
    x = np.linspace(0.5, 6, 17)
    p = rng.uniform(0.5, 1.0, n_params)
    want = np.asarray(getattr(jax_fitting, model)(jnp.asarray(x),
                                                  jnp.asarray(p)))
    got = getattr(fitting, model)(torch.tensor(x), torch.tensor(p)).numpy()
    assert np.allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("p", [3, 5])
def test_chol_solve_unrolled_equals_jax(p):
    rng = np.random.RandomState(p)
    m = rng.randn(8, p, p)
    a = m @ m.transpose(0, 2, 1) + 0.1 * np.eye(p)
    b = rng.randn(8, p)
    want = np.stack([np.asarray(jax_fitting._chol_solve_unrolled(
        jnp.asarray(a[i]), jnp.asarray(b[i]))) for i in range(8)])
    got = fitting._chol_solve_unrolled(torch.tensor(a),
                                       torch.tensor(b)).numpy()
    assert np.max(np.abs(got - want)) < MATCHED
    assert np.allclose(np.einsum("bij,bj->bi", a, got), b, atol=1e-10)


def test_flop_count_and_weights_equal_jax():
    for args in ((8, 3, 50), (24, 3, 100), (60, 5, 100), (40, 4, 7)):
        assert fitting.lm_flops_per_fit(*args) == \
            jax_fitting.lm_flops_per_fit(*args)
    for errs in ([0.1, 0.0, 0.2], [0.0, 0.0], [0.5]):
        ours, want = (fitting.errs_to_weights(errs),
                      jax_fitting.errs_to_weights(errs))
        assert (ours is None and want is None) or np.array_equal(ours, want)


def test_fit_eval_equals_jax(jax_fits):
    x, y, kw = _data("decaying_cosine")
    ours = fitting.fit_decaying_cosine(x, y, device="cpu", **kw)
    xs = np.linspace(0, 4, 101)
    assert np.allclose(ours.eval(xs), jax_fits["decaying_cosine"].eval(xs),
                       atol=1e-8)
    assert np.allclose(ours.eval(x), ours.best_fit, atol=1e-12)


def test_float32_tensors_fit_in_float32():
    """Tensors fit where they lie, in their dtype: float32 on the CPU
    lands within 1e-4 of the float64 fit of the same curves."""
    rng = np.random.RandomState(7)
    x = np.arange(2, 34, 4).astype(float)
    decays = rng.uniform(0.9, 0.995, 32)
    y = rng.binomial(500, 0.5 + 0.5 * decays[:, None] ** x) / 500
    p0 = np.array([0.5, 0.95, 0.5])
    p32, c32, cov32 = fitting.fit_model_batched(
        fitting._base_param_decay_p, torch.tensor(x, dtype=torch.float32),
        torch.tensor(y, dtype=torch.float32), None, p0, num_iters=50)
    p64, _, _ = fitting.fit_model_batched(
        fitting._base_param_decay_p, x, y, None, p0, num_iters=50,
        device="cpu")
    assert p32.dtype == c32.dtype == cov32.dtype == torch.float32
    assert p32.device.type == "cpu"
    assert abs((p32[:, 1].double() - torch.tensor(decays)).abs().mean()
               - (p64[:, 1] - torch.tensor(decays)).abs().mean()) < 1e-4


def test_numpy_input_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    x, y, _ = _data("scipy")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fitting.fit_model_batched(fitting._base_param_decay_p, x, y, None,
                                  [1.0, 0.9, 0.0])
    for fn in ("fit_base_param_decay", "fit_decay_time_param_decay",
               "fit_decaying_cosine", "fit_shifted_cosine"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(fitting, fn)(x, y)
