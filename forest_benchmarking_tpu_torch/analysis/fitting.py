"""Curve-fit models and a batched Levenberg-Marquardt fitter.

Port of ``forest_benchmarking_tpu/analysis/fitting.py``: the four models in
their named (numpy) and parameter-vector forms, :func:`fit_model_batched`,
:func:`fit_model`, the ``fit_*`` wrappers, :class:`FitResult`,
:func:`fit_result_to_json`, and the plotting half, :func:`plot_figure_for_fit`
with its colour and style constants (matplotlib is imported only when it
draws). Standard errors follow lmfit's convention: the covariance
(J^T W^2 J)^+ scaled by the reduced chi-square.

The fitter runs a fixed number of Levenberg-Marquardt steps on the whole
batch at once, batch-first: the Jacobians come from ``torch.func.jacfwd``
under ``torch.func.vmap``, the damped normal equations are solved by an
unrolled Cholesky on (B,) planes, and nothing in the loop reads a value back
to the host. Entry points that take numpy arrays or lists run on the card
unless called with ``device="cpu"``; tensors run where they lie.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
from numpy import pi
import torch

from forest_benchmarking_tpu_torch.ops.calculational import pinv
from forest_benchmarking_tpu_torch.ops.lanes_apg import full_f32_matmul
from forest_benchmarking_tpu_torch.utils import entry_device

__all__ = [
    "base_param_decay", "fit_base_param_decay",
    "decay_time_param_decay", "fit_decay_time_param_decay",
    "decaying_cosine", "fit_decaying_cosine",
    "shifted_cosine", "fit_shifted_cosine",
    "FitResult", "Param", "fit_model", "fit_model_batched",
    "fit_result_to_json", "plot_figure_for_fit", "errs_to_weights",
    "FIT_PLOT_KWS", "lm_flops_per_fit",
]


def errs_to_weights(errs: Sequence[float]) -> Optional[np.ndarray]:
    """1/err fit weights with zero errors replaced by the smallest non-zero
    one; None when every error is zero (unweighted fit)."""
    non_zero = [v for v in errs if v > 0]
    if len(non_zero) == 0:
        return None
    min_non_zero = min(non_zero)
    return 1 / np.asarray([v if v > 0 else min_non_zero for v in errs])


# ------------------------------- models ------------------------------------
# Each model has a named numpy form with the reference's signature and a
# parameter-vector form model_p(x, p) on tensors for the fitter: x (N,),
# p (P,); the fitter maps it over the batch.

def base_param_decay(x, amplitude, decay, baseline):
    """baseline + amplitude * decay**x (RB survival decay)."""
    return np.asarray(baseline + amplitude * decay ** x)


def _base_param_decay_p(x, p):
    amplitude, decay, baseline = p
    return baseline + amplitude * decay ** x


def decay_time_param_decay(x, amplitude, decay_time, offset=0.0):
    """amplitude * exp(-(x - offset)/decay_time) (T1 decay)."""
    return np.asarray(amplitude * np.exp(-1 * (x - offset) / decay_time))


def _decay_time_param_decay_p(x, p):
    amplitude, decay_time, offset = p
    return amplitude * torch.exp(-1 * (x - offset) / decay_time)


def decaying_cosine(x, amplitude, decay_time, offset, baseline, frequency):
    """amplitude * exp(-x/T) cos(2 pi f x + offset) + baseline (T2 fringes)."""
    return (amplitude * np.exp(-1 * x / decay_time)
            * np.cos(2 * pi * frequency * x + offset) + baseline)


def _decaying_cosine_p(x, p):
    amplitude, decay_time, offset, baseline, frequency = p
    return (amplitude * torch.exp(-1 * x / decay_time)
            * torch.cos(2 * pi * frequency * x + offset) + baseline)


def shifted_cosine(x, amplitude, offset, baseline, frequency):
    """amplitude * cos(f x + offset) + baseline (Rabi / CZ Ramsey)."""
    return np.asarray(amplitude * np.cos(frequency * x + offset) + baseline)


def _shifted_cosine_p(x, p):
    amplitude, offset, baseline, frequency = p
    return amplitude * torch.cos(frequency * x + offset) + baseline


# ------------------------------- fitter -------------------------------------

def _chol_solve_unrolled(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``a x = b`` for a batch of small SPD matrices, (..., P, P) and
    (..., P), by a Cholesky factorization unrolled over P: arithmetic on
    (...,) planes, no pivoting (the damped normal-equations matrix is SPD
    by construction)."""
    p = a.shape[-1]
    tiny = torch.finfo(a.dtype).tiny
    l = [[None] * p for _ in range(p)]
    for i in range(p):
        s = a[..., i, i]
        for k in range(i):
            s = s - l[i][k] * l[i][k]
        l[i][i] = torch.sqrt(s.clamp(min=tiny))
        for j in range(i + 1, p):
            s = a[..., j, i]
            for k in range(i):
                s = s - l[j][k] * l[i][k]
            l[j][i] = s / l[i][i]
    y = [None] * p
    for i in range(p):
        s = b[..., i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    x = [None] * p
    for i in reversed(range(p)):
        s = y[i]
        for k in range(i + 1, p):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return torch.stack(x, -1)


def lm_flops_per_fit(n_points: int, n_params: int, num_iters: int,
                     model_flops: int = 8) -> int:
    """Approximate real-arithmetic FLOPs per curve of :func:`_lm_batched`
    (mul/add/div/exp one each).

    Per step: model and Jacobian ``model_flops * N * (P + 1)``, J^T J
    ``2 N P^2``, gradient ``2 N P``, Cholesky solve ``~P^3/3 + 4 P^2``,
    trial cost ``3 N`` and ~``12 P`` bookkeeping; plus one Jacobian and
    inverse for the final covariance.
    """
    n, p = n_points, n_params
    per_iter = (model_flops * n * (p + 1) + 2 * n * p * p + 2 * n * p
                + p ** 3 // 3 + 4 * p * p + 3 * n + 12 * p)
    final = model_flops * n * (p + 1) + 2 * n * p * p + p ** 3
    return per_iter * (num_iters + 1) + final


@dataclass
class Param:
    value: float
    stderr: Optional[float]


@dataclass
class FitResult:
    """The subset of lmfit.ModelResult that the protocols read."""
    param_names: Tuple[str, ...]
    best_values: Dict[str, float]
    params: Dict[str, Param]
    chisqr: float
    redchi: float
    covar: Optional[np.ndarray]
    best_fit: np.ndarray
    residual: np.ndarray
    success: bool
    x: np.ndarray = field(default=None, repr=False)
    y: np.ndarray = field(default=None, repr=False)
    model_p: Callable = field(default=None, repr=False)

    def eval(self, x):
        """The fitted model at ``x``, evaluated in float64 on the host."""
        p = torch.tensor([self.best_values[k] for k in self.param_names],
                         dtype=torch.float64)
        return self.model_p(torch.as_tensor(np.asarray(x, float)), p).numpy()


def _accept(c_new: torch.Tensor, c: torch.Tensor,
            p_new: torch.Tensor) -> torch.Tensor:
    """The step rule of :func:`_lm_batched`: take a trial step that lowers
    the cost and stays finite."""
    return (c_new < c) & torch.isfinite(p_new).all(-1)


def _lm_batched(model_p: Callable, x: torch.Tensor, y: torch.Tensor,
                w: torch.Tensor, p0: torch.Tensor, num_iters: int = 100):
    """Levenberg-Marquardt with Madsen-Nielsen-Tingleff damping on a batch
    of curves: x, y, w (B, N), p0 (B, P) -> (params (B, P), chisqr (B,),
    unscaled covariance (B, P, P)).

    A step is accepted when it lowers the cost and stays finite; lambda
    then shrinks by max(1/3, 1 - (2 rho - 1)^3) (rho the gain ratio),
    otherwise it grows by nu, which doubles with each rejection. The damped
    matrix carries a dtype-relative jitter eps^2 (1 + max diag J^T J), so it
    stays non-singular where the Jacobian vanishes. The covariance is the
    pseudo-inverse of J^T J at the solution. Products run in full float32
    on the card (no TF32).
    """
    def residual(p, x, y, w):
        return w * (model_p(x, p) - y)

    res = torch.func.vmap(residual)
    jac = torch.func.vmap(torch.func.jacfwd(residual))

    def cost(p):
        r = res(p, x, y, w)
        return (r * r).sum(-1)

    dtype = p0.dtype
    eps, tiny = torch.finfo(dtype).eps, torch.finfo(dtype).tiny
    eye = torch.eye(p0.shape[-1], dtype=dtype, device=p0.device)
    with full_f32_matmul():
        j = jac(p0, x, y, w)
        lam = 1e-3 * torch.diagonal(j.mT @ j, dim1=-2, dim2=-1).amax(-1)
        nu = torch.full_like(lam, 2.0)
        p, c = p0, cost(p0)
        for _ in range(num_iters):
            j = jac(p, x, y, w)
            r = res(p, x, y, w)
            jtj = j.mT @ j
            g = (j.mT @ r[..., None])[..., 0]
            jit_eps = eps ** 2 * (1.0 + torch.diagonal(
                jtj, dim1=-2, dim2=-1).abs().amax(-1))
            a = (jtj + lam[:, None, None] * eye) + jit_eps[:, None, None] * eye
            delta = _chol_solve_unrolled(a, -g)
            p_new = p + delta
            c_new = cost(p_new)
            # predicted reduction: 0.5 delta^T (lam delta - g)
            pred = 0.5 * (delta * (lam[:, None] * delta - g)).sum(-1)
            rho = (c - c_new) / pred.clamp(min=tiny)
            accept = _accept(c_new, c, p_new)
            p = torch.where(accept[:, None], p_new, p)
            c = torch.where(accept, c_new, c)
            shrink = (1.0 - (2.0 * rho - 1.0) ** 3).clamp(min=1.0 / 3.0)
            lam = torch.where(accept, (lam * shrink).clamp(min=1e-14),
                              lam * nu)
            nu = torch.where(accept, 2.0, (nu * 2.0).clamp(max=1e8))
        j = jac(p, x, y, w)
        cov = pinv(j.mT @ j)
    return p, c, cov


def _floating(values) -> torch.dtype:
    """The dtype of the first floating tensor among ``values``, else
    float64 (numpy arrays and lists fit in float64)."""
    return next((v.dtype for v in values if isinstance(v, torch.Tensor)
                 and v.is_floating_point()), torch.float64)


def fit_model_batched(model_p: Callable, x, y, weights, p0,
                      num_iters: int = 100, device=None):
    """Batched LM fit: x, y, (weights) of shape (B, N) (x and weights may
    be (N,)); p0 (B, P) or (P,).

    Numpy or list inputs fit in float64 on ``device``, the card by default;
    tensors fit where ``y`` lies, in its dtype.

    :return: (params (B, P), chisqr (B,), covar (B, P, P)) as tensors;
        covar unscaled (callers apply the reduced chi-square, lmfit's
        convention).
    """
    values = (y, x, weights, p0)
    dev = entry_device(device, *values)
    dtype = _floating(values)

    def tensor(v):
        return torch.atleast_2d(torch.as_tensor(v, dtype=dtype, device=dev))

    x, y = tensor(x), tensor(y)
    b, n = y.shape
    if x.shape[0] == 1:
        x = x.expand(b, n)
    w = (torch.ones_like(y) if weights is None
         else tensor(weights).expand(b, n))
    p0 = torch.as_tensor(p0, dtype=dtype, device=dev)
    if p0.dim() == 1:
        p0 = p0.expand(b, p0.shape[0])
    return _lm_batched(model_p, x, y, w, p0, num_iters=num_iters)


def fit_model(model_p: Callable, param_names: Sequence[str], x, y,
              weights=None, param_guesses: Sequence[float] = None,
              num_iters: int = 100, device=None) -> FitResult:
    """Fit one curve (float64, on ``device``: the card by default); returns
    a FitResult with lmfit-convention standard errors."""
    if param_guesses is None:
        raise ValueError("param_guesses is required (one initial value per "
                         "model parameter); the fit_* wrappers supply "
                         "model-specific defaults.")
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    if len(x) != len(y):
        raise ValueError("Lengths of x and y arrays must be equal.")
    if weights is not None and len(x) != len(weights):
        raise ValueError("Lengths of x and weights arrays must be equal if "
                         "weights is not None.")
    params, chisqr, cov = fit_model_batched(
        model_p, x[None], y[None],
        None if weights is None else np.asarray(weights)[None],
        np.asarray(param_guesses, float), num_iters=num_iters,
        device=device)
    best_fit = model_p(torch.as_tensor(x, device=params.device),
                       params[0]).cpu().numpy()
    p = params[0].cpu().numpy()
    chisqr = float(chisqr[0])
    cov = cov[0].cpu().numpy()
    nfree = len(y) - len(p)
    redchi = chisqr / max(nfree, 1)
    covar = cov * redchi  # lmfit's scale_covar=True convention
    stderr = np.sqrt(np.clip(np.diag(covar), 0, None))
    best_values = {k: float(v) for k, v in zip(param_names, p)}
    return FitResult(
        param_names=tuple(param_names),
        best_values=best_values,
        params={k: Param(float(v), float(s))
                for k, v, s in zip(param_names, p, stderr)},
        chisqr=chisqr, redchi=redchi, covar=covar, best_fit=best_fit,
        # lmfit's convention: the residual is weighted, (model - data) * w
        residual=((best_fit - y) if weights is None
                  else (best_fit - y) * np.asarray(weights, dtype=float)),
        success=bool(np.all(np.isfinite(p))), x=x, y=y, model_p=model_p)


# ------------------------- reference-shaped wrappers -------------------------

def fit_base_param_decay(x, y, weights=None,
                         param_guesses: tuple = (1., .9, 0.),
                         device=None) -> FitResult:
    """Fit y = baseline + amplitude * decay**x."""
    return fit_model(_base_param_decay_p, ("amplitude", "decay", "baseline"),
                     x, y, weights, param_guesses, device=device)


def fit_decay_time_param_decay(x, y, weights=None,
                               param_guesses: tuple = (1., 10, 0),
                               device=None) -> FitResult:
    """Fit y = amplitude * exp(-(x - offset)/decay_time)."""
    return fit_model(_decay_time_param_decay_p,
                     ("amplitude", "decay_time", "offset"),
                     x, y, weights, param_guesses, device=device)


def fit_decaying_cosine(x, y, weights=None,
                        param_guesses: tuple = (.5, 10, 0.0, 0.5, 5),
                        device=None) -> FitResult:
    """Fit y = A exp(-x/T) cos(2 pi f x + offset) + baseline."""
    return fit_model(_decaying_cosine_p,
                     ("amplitude", "decay_time", "offset", "baseline",
                      "frequency"), x, y, weights, param_guesses,
                     device=device)


def fit_shifted_cosine(x, y, weights=None,
                       param_guesses: tuple = (.5, 0, .5, 1.),
                       device=None) -> FitResult:
    """Fit y = A cos(f x + offset) + baseline."""
    return fit_model(_shifted_cosine_p,
                     ("amplitude", "offset", "baseline", "frequency"),
                     x, y, weights, param_guesses, device=device)


def fit_result_to_json(fit_result: FitResult) -> dict:
    """JSON-serializable summary of a fit."""
    return {
        "chisqr": fit_result.chisqr,
        "redchi": fit_result.redchi,
        "best_fit": np.asarray(fit_result.best_fit).tolist(),
        "best_values": fit_result.best_values,
        "covar": (np.asarray(fit_result.covar).tolist()
                  if fit_result.covar is not None else None),
        "params": {k: {"value": p.value, "stderr": p.stderr}
                   for k, p in fit_result.params.items()},
    }


# ------------------------------- plotting -----------------------------------

TEAL = "#6CAFB7"
DARK_TEAL = "#48737F"
FUSCHIA = "#D6619E"
BEIGE = "#EAE8C6"
GRAY = "#494949"

# plot keyword defaults of the reference's lmfit plots, for callers styling
# their own fit plots; plot_figure_for_fit applies the same styling inline
FIT_PLOT_KWS = {
    "data_kws": {"color": "black", "markersize": 4.0},
    "init_kws": {"color": TEAL, "alpha": 0.4, "linestyle": "--"},
    "fit_kws": {"alpha": 1.0, "linewidth": 2.0},
    "numpoints": 1000,
}

DEFAULT_FIG_SIZE = (7, 10)
DEFAULT_AXIS_FONT_SIZE = 14
DEFAULT_REPORT_FONT_SIZE = 11


def plot_figure_for_fit(fit_result: FitResult, xlabel: str = "x",
                        ylabel: str = "y", xscale: float = 1.0,
                        yscale: float = 1.0, title: str = "",
                        figsize=DEFAULT_FIG_SIZE,
                        axis_fontsize=DEFAULT_AXIS_FONT_SIZE,
                        report_fontsize=DEFAULT_REPORT_FONT_SIZE):
    """Fit and residuals on a new figure, with a parameter report; the JAX
    package's figure, artist for artist. Returns (figure, axes)."""
    from forest_benchmarking_tpu_torch.plotting._mpl import require
    plt = require()
    ticker = require("matplotlib.ticker")

    fig, axs = plt.subplots(nrows=2, ncols=1, sharex=True,
                            gridspec_kw={"height_ratios": (3, 1)},
                            figsize=figsize)
    plt.subplots_adjust(hspace=0, top=0.9, bottom=0.3)

    x, y = fit_result.x, fit_result.y
    xs = np.linspace(np.min(x), np.max(x), 1000)
    axs[0].plot(x, y, "o", color="black", markersize=4.0, label="data")
    axs[0].plot(xs, fit_result.eval(xs), color=FUSCHIA, linewidth=2.0,
                label="best fit")
    axs[0].legend()
    axs[1].axhline(0, color=GRAY, linewidth=1)
    axs[1].plot(x, fit_result.residual, "o", color="black", markersize=4.0)

    axs[1].set_ylabel("residuals", fontsize=axis_fontsize)
    axs[1].set_xlabel(xlabel, fontsize=axis_fontsize)
    axs[0].set_ylabel(ylabel, fontsize=axis_fontsize)
    axs[0].set_title(title, fontsize=axis_fontsize)

    xticks = ticker.FuncFormatter(lambda v, pos: "{0:g}".format(v / xscale))
    axs[1].xaxis.set_major_formatter(xticks)
    yticks = ticker.FuncFormatter(lambda v, pos: "{0:g}".format(v / yscale))
    for ax in axs:
        ax.yaxis.set_major_formatter(yticks)

    report_lines = [f"{k:12s} {p.value:+.5g} +/- "
                    f"{p.stderr if p.stderr is not None else float('nan'):.3g}"
                    for k, p in fit_result.params.items()]
    report = "\n".join([f"chi-square     {fit_result.chisqr:.5g}",
                        f"reduced chi-sq {fit_result.redchi:.5g}"] + report_lines)
    fig.suptitle(report, fontsize=report_fontsize, family="monospace",
                 horizontalalignment="left", x=0.1, y=0.25)
    return fig, axs
