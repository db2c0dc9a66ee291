"""Pauli-basis visualizations of states and processes.

Port of ``forest_benchmarking_tpu/plotting/state_process.py``: the same
artists in the same order. Inputs may be torch tensors on any device, numpy
arrays or nested lists. matplotlib is imported when a figure is drawn, and
``rigetti_3_color_cm`` is built on first access.
"""
from __future__ import annotations

import functools
import itertools

import numpy as np

from forest_benchmarking_tpu_torch.plotting._mpl import require, to_host

__all__ = ["plot_pauli_rep_of_state", "plot_pauli_bar_rep_of_state",
           "plot_pauli_transfer_matrix", "rigetti_3_color_cm"]

THREE_COLOR_MAP = ["#48737F", "#FFFFFF", "#D6619E"]

_COEFF_TICKS = [-1 / 2, -1 / 4, 0, 1 / 4, 1 / 2]


@functools.lru_cache(maxsize=None)
def _rigetti_3_color_cm():
    colors = require("matplotlib.colors")
    return colors.LinearSegmentedColormap.from_list(
        "fbtpu", THREE_COLOR_MAP[::-1], N=100)


def __getattr__(name):
    if name == "rigetti_3_color_cm":
        return _rigetti_3_color_cm()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _pauli_ticks(ax, axis: str, labels, rotation: float = 0,
                 fontsize=None) -> None:
    """One tick per Pauli label on the given axis ('x' or 'y')."""
    text_kw = {"rotation": rotation}
    if fontsize is not None:
        text_kw["fontsize"] = fontsize
    which = ax.xaxis if axis == "x" else ax.yaxis
    which.set_ticks(np.arange(len(labels)))
    which.set_ticklabels(labels, **text_kw)


def _finish(ax, title, fontsize=None) -> None:
    pad = {} if fontsize is None else {"fontsize": int(np.floor(1.2 * fontsize)),
                                       "pad": 15}
    ax.set_title(title, **pad)
    ax.grid(False)


def plot_pauli_rep_of_state(state_pl_basis, ax, labels, title):
    """Heat-strip visualization of a state's Pauli-Liouville coefficients."""
    state_pl_basis = to_host(state_pl_basis)
    if len(state_pl_basis.shape) == 1:
        raise ValueError("You must pass in a (N by 1) or a (1 by N) numpy.ndarray")
    if np.iscomplexobj(state_pl_basis):
        raise ValueError("You must pass in a real vector")
    plt = require()

    im = ax.imshow(state_pl_basis, interpolation="nearest", cmap="RdBu",
                   vmin=-1 / 2, vmax=1 / 2)
    rows, cols = state_pl_basis.shape
    # column vector: Pauli labels run down the y axis and the colorbar sits
    # beside the strip; row vector: labels along x, colorbar underneath
    if rows > cols:
        cb = plt.colorbar(im, ax=ax, ticks=_COEFF_TICKS)
        cb.ax.yaxis.set_tick_params(pad=35)
        _pauli_ticks(ax, "y", labels)
        ax.set_ylabel("Pauli Operator")
        ax.set_xlabel("Coefficient")
        ax.set_xticks([])
    else:
        plt.colorbar(im, ax=ax, ticks=_COEFF_TICKS,
                     orientation="horizontal", pad=0.22)
        _pauli_ticks(ax, "x", labels)
        ax.set_xlabel("Pauli Operator")
        ax.set_ylabel("Coefficient")
        ax.set_yticks([])
    _finish(ax, title)


def plot_pauli_bar_rep_of_state(state_pl_basis, ax, labels, title):
    """Bar-graph visualization of a state's Pauli-Liouville coefficients."""
    coeffs = np.real(to_host(state_pl_basis)).ravel()
    ax.bar(np.arange(len(labels)) - .4, coeffs, width=.8)
    _pauli_ticks(ax, "x", labels, rotation=45)
    ax.set_xlabel("Pauli Operator")
    ax.set_ylabel("Coefficient")
    _finish(ax, title)


def plot_pauli_transfer_matrix(ptransfermatrix, ax, labels=None, title="",
                               fontsizes: int = 16):
    """Heatmap of a Pauli transfer matrix with IXYZ-product labels."""
    plt = require()
    ptransfermatrix = np.real_if_close(to_host(ptransfermatrix))
    im = ax.imshow(ptransfermatrix, interpolation="nearest", cmap="RdBu",
                   vmin=-1, vmax=1)
    if labels is None:
        num_qubits = int(np.log2(np.sqrt(ptransfermatrix.shape[0])))
        labels = ["".join(x) for x in
                  itertools.product("IXYZ", repeat=num_qubits)]

    cb = plt.colorbar(im, ax=ax, ticks=np.linspace(-1, 1, 9))
    cb.ax.yaxis.set_tick_params(pad=35)
    tick_fs = int(np.floor(0.7 * fontsizes))
    _pauli_ticks(ax, "x", labels, rotation=45, fontsize=tick_fs)
    _pauli_ticks(ax, "y", labels, fontsize=tick_fs)
    ax.set_xlabel("Input Pauli Operator", fontsize=fontsizes)
    ax.set_ylabel("Output Pauli Operator", fontsize=fontsizes)
    _finish(ax, title, fontsize=fontsizes)
    return ax
