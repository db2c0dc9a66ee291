"""Holding the port's Levenberg-Marquardt fits to the JAX package's.

Near a minimum the fitter's step rule compares two costs that agree to the
last bits, and XLA's and PyTorch's round-off can decide such a tie
differently: their exp and cos differ in the last bit, and a weighted cost
sums N such terms, so near a minimum two steps' costs of one fit agree
within a few hundred units of round-off. The JAX package's own batched and
single-curve fits of one curve part by up to ~6e-9 that way.
:func:`hold_against_jax` therefore asks each curve of the port's fit to lie
within 1e-9 of JAX's, or to come within 1e-9 of it when exactly one step
decision whose cost margin is within :data:`TIE` units of round-off of the
cost takes the other branch.
"""
import numpy as np
import torch

from forest_benchmarking_tpu_torch.analysis import fitting

BAR = 1e-9
TIE = 512  # a step decision is a tie within this many units of round-off


def hold_against_jax(monkeypatch, fit, want) -> np.ndarray:
    """``fit()`` runs the port's fit and returns its (B, P) parameters;
    ``want`` holds JAX's. Returns the port's parameters."""
    real = fitting._accept
    margins = []

    def recording(c_new, c, p_new):
        margins.append(((c - c_new).abs()
                        / (torch.finfo(c.dtype).eps * c.abs())).cpu().numpy())
        return real(c_new, c, p_new)

    monkeypatch.setattr(fitting, "_accept", recording)
    ours = np.atleast_2d(fit())
    monkeypatch.setattr(fitting, "_accept", real)
    want = np.atleast_2d(want)
    parted = np.nonzero(np.abs(ours - want).max(-1) > BAR)[0]
    for i in parted:
        # the closest calls first; a zero margin (a step too small to move
        # the cost) last
        ties = sorted((k for k, m in enumerate(margins) if m[i] <= TIE),
                      key=lambda k: (margins[k][i] == 0, margins[k][i]))
        assert any(_flipped(monkeypatch, fit, real, k, i, want[i])
                   for k in ties), (i, np.abs(ours[i] - want[i]).max())
    return ours


def _flipped(monkeypatch, fit, real, step, curve, want) -> bool:
    """Whether the port's fit of ``curve`` comes within the bar of ``want``
    when its decision at ``step`` takes the other branch."""
    calls = [0]

    def flip(c_new, c, p_new):
        accept = real(c_new, c, p_new)
        if calls[0] == step:
            accept = accept.clone()
            accept[curve] = ~accept[curve]
        calls[0] += 1
        return accept

    monkeypatch.setattr(fitting, "_accept", flip)
    ours = np.atleast_2d(fit())[curve]
    monkeypatch.setattr(fitting, "_accept", real)
    return bool(np.abs(ours - want).max() <= BAR)
