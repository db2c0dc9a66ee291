"""The port's plotting (``plotting.hinton``, ``plotting.state_process`` and
``analysis.fitting.plot_figure_for_fit``) against the JAX package's: both
draw on fresh figures of equal size and dpi, and the Agg RGBA buffers must
be bitwise equal. The port's functions take torch tensors (and numpy
arrays); the JAX package's take the same values as numpy arrays. Without
matplotlib the port's modules import, and a drawing call raises
ImportError."""
import importlib
import os
import subprocess
import sys

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from forest_benchmarking_tpu import plotting as jax_plotting  # noqa: E402
from forest_benchmarking_tpu.analysis import fitting as jax_fitting  # noqa: E402
from forest_benchmarking_tpu_torch import plotting  # noqa: E402
from forest_benchmarking_tpu_torch.analysis import fitting  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIGSIZE, DPI = (6.4, 4.8), 72


def pixels(draw):
    """The RGBA buffer of the figure ``draw()`` returns, drawn by Agg. A
    figure of FIGSIZE and DPI is current when ``draw`` is called."""
    plt.close("all")
    plt.figure(figsize=FIGSIZE, dpi=DPI)
    fig = draw()
    fig.set_dpi(DPI)
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba()).copy()
    plt.close("all")
    return buf


def assert_same_pixels(ours, theirs):
    a, b = pixels(ours), pixels(theirs)
    assert a.shape == b.shape
    assert len(np.unique(a.reshape(-1, 4), axis=0)) > 2   # something drawn
    assert np.array_equal(a, b)


def complex_matrix(n=4, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, n) + 1j * rng.randn(n, n)) / 2


@pytest.mark.parametrize("case", ["complex128", "complex64", "numpy",
                                  "conj_view", "max_weight_0"])
def test_hinton_pixels_equal_jax(case):
    m = complex_matrix()
    kw = {}
    if case == "complex64":
        m = m.astype(np.complex64)
    if case == "max_weight_0":
        kw = dict(max_weight=0)
    ours_in = {"numpy": m, "conj_view": torch.tensor(np.conj(m)).conj()}.get(
        case, torch.tensor(m))
    theirs_in = m

    def ours():
        plotting.hinton(ours_in, **kw)
        return plt.gcf()

    def theirs():
        jax_plotting.hinton(theirs_in, **kw)
        return plt.gcf()

    assert_same_pixels(ours, theirs)


@pytest.mark.parametrize("label_top", [True, False])
def test_hinton_real_pixels_equal_jax(label_top):
    m = np.real(complex_matrix(seed=1))
    kw = dict(xlabels=list("abcd"), ylabels=list("wxyz"), title="real",
              label_top=label_top)
    assert_same_pixels(
        lambda: plotting.hinton_real(torch.tensor(m), **kw)[0],
        lambda: jax_plotting.hinton_real(m, **kw)[0])


def test_hinton_real_on_a_given_axis_pixels_equal_jax():
    m = np.real(complex_matrix(seed=2))

    def draw(fn, x):
        fig = plt.gcf()
        fn(x, ax=fig.gca())
        return fig

    assert_same_pixels(lambda: draw(plotting.hinton_real, torch.tensor(m)),
                       lambda: draw(jax_plotting.hinton_real, m))


STATE_PL = np.array([[1 / np.sqrt(2)], [0.3], [-0.2], [1 / np.sqrt(2)]])


def on_axis(fn, *args, **kw):
    def draw():
        fig, ax = plt.subplots(1, figsize=FIGSIZE, dpi=DPI)
        fn(args[0], ax, *args[1:], **kw)
        return fig
    return draw


@pytest.mark.parametrize("shape", ["column", "row"])
def test_pauli_rep_of_state_pixels_equal_jax(shape):
    state = STATE_PL if shape == "column" else STATE_PL.T
    args = (list("IXYZ"), "state")
    assert_same_pixels(
        on_axis(plotting.plot_pauli_rep_of_state, torch.tensor(state), *args),
        on_axis(jax_plotting.plot_pauli_rep_of_state, state, *args))


def test_pauli_bar_rep_of_state_pixels_equal_jax():
    args = (list("IXYZ"), "bars")
    assert_same_pixels(
        on_axis(plotting.plot_pauli_bar_rep_of_state,
                torch.tensor(STATE_PL.T), *args),
        on_axis(jax_plotting.plot_pauli_bar_rep_of_state, STATE_PL.T, *args))


@pytest.mark.parametrize("n_qubits", [1, 2])
def test_pauli_transfer_matrix_pixels_equal_jax(n_qubits):
    d2 = 4 ** n_qubits
    ptm = np.random.RandomState(n_qubits).uniform(-1, 1, (d2, d2))
    ptm[0] = 0
    ptm[0, 0] = 1
    assert_same_pixels(
        on_axis(plotting.plot_pauli_transfer_matrix, torch.tensor(ptm),
                title="ptm"),
        on_axis(jax_plotting.plot_pauli_transfer_matrix, ptm, title="ptm"))


@pytest.mark.parametrize("model", ["base_param_decay", "decaying_cosine"])
def test_plot_figure_for_fit_pixels_equal_jax(model):
    """Seeded noisy data, fitted by each package's own fitter: the noise
    sets the residuals, so their axis scales alike in both figures."""
    rng = np.random.RandomState(7)
    if model == "base_param_decay":
        x = np.arange(1, 30, dtype=float)
        y = jax_fitting.base_param_decay(x, 0.5, 0.9, 0.5)
    else:
        x = np.linspace(0, 20, 40)
        y = jax_fitting.decaying_cosine(x, 0.4, 8.0, 0.3, 0.5, 0.15)
    y = y + rng.normal(0, 0.01, x.shape)
    fit = getattr(fitting, f"fit_{model}")(x, y, device="cpu")
    jax_fit = getattr(jax_fitting, f"fit_{model}")(x, y)
    for k, p in fit.params.items():
        assert abs(p.value - jax_fit.params[k].value) < 1e-8, k
    kw = dict(xlabel="depth", ylabel="survival", title=model)
    assert_same_pixels(
        lambda: fitting.plot_figure_for_fit(fit, **kw)[0],
        lambda: jax_fitting.plot_figure_for_fit(jax_fit, **kw)[0])


def test_pauli_rep_of_state_raises_as_jax_does():
    fig, ax = plt.subplots(1)
    for fn in (plotting.plot_pauli_rep_of_state,
               jax_plotting.plot_pauli_rep_of_state):
        with pytest.raises(ValueError, match="N by 1"):
            fn(STATE_PL.ravel(), ax, list("IXYZ"), "bad")
        with pytest.raises(ValueError, match="real vector"):
            fn(STATE_PL.astype(complex) * 1j, ax, list("IXYZ"), "bad")
    with pytest.raises(ValueError, match="real vector"):
        plotting.plot_pauli_rep_of_state(torch.tensor(STATE_PL * 1j), ax,
                                         list("IXYZ"), "bad")
    plt.close("all")


def test_names_and_constants_equal_jax():
    for name in ("TEAL", "DARK_TEAL", "FUSCHIA", "BEIGE", "GRAY",
                 "FIT_PLOT_KWS", "DEFAULT_FIG_SIZE", "DEFAULT_AXIS_FONT_SIZE",
                 "DEFAULT_REPORT_FONT_SIZE"):
        assert getattr(fitting, name) == getattr(jax_fitting, name), name
    # the packages' ``hinton`` is the function; the modules by their names
    jax_hinton = importlib.import_module("forest_benchmarking_tpu.plotting.hinton")
    jax_sp = importlib.import_module(
        "forest_benchmarking_tpu.plotting.state_process")
    hinton = importlib.import_module(
        "forest_benchmarking_tpu_torch.plotting.hinton")
    state_process = importlib.import_module(
        "forest_benchmarking_tpu_torch.plotting.state_process")
    assert state_process.THREE_COLOR_MAP == jax_sp.THREE_COLOR_MAP
    assert state_process.rigetti_3_color_cm(0.3) == jax_sp.rigetti_3_color_cm(0.3)
    assert hinton.ANGLE_MAPPER.to_rgba(1.0) == jax_hinton.ANGLE_MAPPER.to_rgba(1.0)


_WITHOUT_MATPLOTLIB = """
import importlib, sys
sys.modules["matplotlib"] = None
import numpy as np
import forest_benchmarking_tpu_torch.plotting as plotting
import forest_benchmarking_tpu_torch.analysis.fitting as fitting
hinton = importlib.import_module("forest_benchmarking_tpu_torch.plotting.hinton")
state_process = importlib.import_module(
    "forest_benchmarking_tpu_torch.plotting.state_process")
assert fitting.TEAL == "#6CAFB7"
for call in (lambda: plotting.hinton(np.eye(2)),
             lambda: hinton.ANGLE_MAPPER,
             lambda: state_process.rigetti_3_color_cm):
    try:
        call()
    except ImportError as err:
        assert "plotting needs matplotlib" in str(err), err
    else:
        raise SystemExit("no ImportError")
print("ok")
"""


def test_port_imports_without_matplotlib_and_drawing_raises():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", _WITHOUT_MATPLOTLIB],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"
