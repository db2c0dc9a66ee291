"""What the port's drawing functions share: matplotlib, imported only when
a figure is drawn, and their inputs brought to the host.

The card's machine has no matplotlib, so nothing of the port imports it
when a module loads. A drawing call made without it raises ImportError.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch


def require(name: str = "matplotlib.pyplot"):
    """Import and return ``name``, a matplotlib module; raise ImportError
    saying that plotting needs matplotlib when it is not installed."""
    try:
        return importlib.import_module(name)
    except ImportError as err:
        raise ImportError(f"plotting needs matplotlib, which this Python "
                          f"cannot import ({err})") from err


def to_host(x) -> np.ndarray:
    """A torch tensor on any device, a numpy array or nested lists as a
    numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().resolve_conj().cpu().numpy()
    return np.asarray(x)
