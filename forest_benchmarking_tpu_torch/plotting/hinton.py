"""Hinton diagrams for (complex or real) matrices.

Port of ``forest_benchmarking_tpu/plotting/hinton.py``: square sizes encode
magnitudes; for complex matrices the color encodes the phase, for real
matrices the sign maps to a two-color scheme. Every cell's square is built
in one numpy pass and drawn as a single ``PolyCollection``, in the JAX
package's order, so both draw the same pixels. Inputs may be torch tensors
on any device, numpy arrays or nested lists. matplotlib is imported when a
figure is drawn, and ``ANGLE_MAPPER`` is built on first access.
"""
from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np

from forest_benchmarking_tpu_torch.plotting._mpl import require, to_host

__all__ = ["hinton", "hinton_real"]

# unit square corner offsets, counter-clockwise
_CORNERS = np.array([(-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0)]) / 2


@functools.lru_cache(maxsize=None)
def _angle_mapper():
    cm = require("matplotlib.cm")
    colors = require("matplotlib.colors")
    return cm.ScalarMappable(norm=colors.Normalize(vmin=-np.pi, vmax=np.pi))


def __getattr__(name):
    if name == "ANGLE_MAPPER":
        return _angle_mapper()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _squares(cx: np.ndarray, cy: np.ndarray, side: np.ndarray) -> np.ndarray:
    """(N, 4, 2) vertex array of axis-aligned squares centered at (cx, cy)."""
    centers = np.stack([cx, cy], axis=-1)[:, None, :]
    return centers + side[:, None, None] * _CORNERS[None, :, :]


def hinton(matrix, max_weight: float = 1.0, ax=None):
    """Hinton diagram of a complex matrix: size = |w|, color =
    arctan2(Re w, Im w) (real part first, as in the JAX package).
    ``max_weight=0`` takes the power of two at or above the largest |w|."""
    plt = require()
    collections = require("matplotlib.collections")
    ax = ax if ax is not None else plt.gca()
    matrix = to_host(matrix)
    if not max_weight:
        max_weight = 2 ** np.ceil(np.log(np.abs(matrix).max()) / np.log(2))

    ax.patch.set_facecolor("lightgrey")
    ax.set_aspect("equal", "box")
    ax.xaxis.set_major_locator(plt.NullLocator())
    ax.yaxis.set_major_locator(plt.NullLocator())

    w = matrix.ravel()
    rows, cols = np.divmod(np.arange(w.size), matrix.shape[1])
    colors = _angle_mapper().to_rgba(np.arctan2(w.real, w.imag))
    sides = np.sqrt(np.abs(w) / max_weight)
    ax.add_collection(collections.PolyCollection(
        _squares(rows.astype(float), cols.astype(float), sides),
        facecolors=colors, edgecolors=colors))

    ax.set_xlim((-max_weight / 2, matrix.shape[0] - max_weight / 2))
    ax.set_ylim((-max_weight / 2, matrix.shape[1] - max_weight / 2))
    ax.autoscale_view()
    ax.invert_yaxis()
    return ax


def hinton_real(matrix, max_weight: Optional[float] = None,
                xlabels: Optional[List[str]] = None,
                ylabels: Optional[List[str]] = None,
                title: Optional[str] = None, ax=None, cmap=None,
                label_top: bool = True):
    """Hinton diagram of a real matrix: size = |w|, two colors for the sign.
    The matrix is walked transposed: cell (i, j) is drawn at x = i + 1/2,
    y = height - j - 1/2, as in the JAX package."""
    plt = require()
    mpl = require("matplotlib")
    cm = require("matplotlib.cm")
    collections = require("matplotlib.collections")
    colorbar = require("matplotlib.colorbar")
    fig = None
    if ax is None:
        fig, ax = plt.subplots(1, 1, figsize=(8, 6))
    matrix = to_host(matrix)

    base = cm.RdBu if cmap is None else cmap
    # three-entry map: [negative, background, positive]
    cmap = mpl.colors.ListedColormap([base(0), "gainsboro", base(256)])

    if title and fig:
        ax.set_title(title, y=1.1, fontsize=18)
    ax.set_aspect("equal", "box")
    ax.set_frame_on(False)

    height, width = matrix.shape
    if max_weight is None:
        max_weight = 1.25 * max(abs(np.diag(matrix)))
        if max_weight <= 0.0:
            max_weight = 1.0

    # background canvas, then one PolyCollection of sign-colored squares
    ax.fill(np.array([0, width, width, 0]), np.array([0, 0, height, height]),
            color=cmap(1))
    i_idx, j_idx = np.divmod(np.arange(width * height), height)
    vals = matrix[i_idx, j_idx]
    sides = np.sqrt(np.minimum(1.0, np.abs(vals) / max_weight))
    two_colors = np.array([cmap(0), cmap(2)])
    face = two_colors[(vals.real > 0.0).astype(int)]
    ax.add_collection(collections.PolyCollection(
        _squares(i_idx + 0.5, height - j_idx - 0.5, sides),
        facecolors=face, edgecolors=face))

    bounds = [-max_weight, -0.0001, 0.0001, max_weight]
    norm = mpl.colors.BoundaryNorm(bounds, cmap.N)
    cax, _ = colorbar.make_axes(ax, shrink=0.75, pad=.1)
    colorbar.ColorbarBase(
        cax, norm=norm, cmap=cmap, boundaries=bounds,
        ticks=[-max_weight / 2, 0, max_weight / 2],
    ).set_ticklabels(["$-$", "$0$", "$+$"])
    cax.tick_params(labelsize=14)

    if xlabels:
        ax.set_xticks(np.arange(len(xlabels)) + 0.5)
        ax.set_xticklabels(xlabels)
        if label_top:
            ax.xaxis.tick_top()
    else:
        ax.xaxis.set_major_locator(plt.IndexLocator(1, 0.5))
    if ylabels:
        ax.set_yticks(np.arange(len(ylabels)) + 0.5)
        ax.set_yticklabels(list(reversed(ylabels)))
    else:
        ax.yaxis.set_major_locator(plt.IndexLocator(1, 0.5))
    ax.tick_params(axis="x", labelsize=14)
    ax.tick_params(axis="y", labelsize=14)
    return fig, ax
