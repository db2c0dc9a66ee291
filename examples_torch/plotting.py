"""Example: Hinton diagrams and Pauli-Liouville visualizations.

The port's counterpart of ``examples/plotting.py``: a Hinton diagram of the
Bell state, the Pauli-Liouville strip of |+>, and the Pauli transfer matrix
of a depolarizing channel, drawn from tensors on the chosen device and
written as PNG files into ``out_dir`` (headless Agg backend). Plotting needs
matplotlib; without it the first figure call raises ImportError.

Run on the card with ``python examples_torch/plotting.py``, or on the CPU
with ``--device cpu``; ``--out-dir`` picks the directory (``/tmp``).
"""
import argparse
import os
import sys
from pathlib import Path

if __name__ == "__main__":   # a script: import the port from this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from forest_benchmarking_tpu_torch.ops import choi2pauli_liouville, kraus2choi
from forest_benchmarking_tpu_torch.plotting import (
    hinton, plot_pauli_rep_of_state, plot_pauli_transfer_matrix)
from forest_benchmarking_tpu_torch.sim.noise import depolarizing_kraus_map
from forest_benchmarking_tpu_torch.utils import entry_device


def figures(device="cuda"):
    """The example's three inputs, as tensors on ``device``: the Bell state
    density matrix, the Pauli-Liouville row of |+>, and the PTM of a
    depolarizing channel (p = 0.3)."""
    dev = entry_device(device)
    bell = torch.zeros((4, 4), dtype=torch.complex128, device=dev)
    bell[0, 0] = bell[0, 3] = bell[3, 0] = bell[3, 3] = 0.5
    # (I + X)/sqrt(2) coordinates of |+>
    plus_pl = torch.tensor([[1.0, 1.0, 0.0, 0.0]], dtype=torch.float64,
                           device=dev) / np.sqrt(2)
    kraus = torch.tensor(np.stack(depolarizing_kraus_map(0.3)), device=dev)
    ptm = choi2pauli_liouville(kraus2choi(kraus)).real
    return bell, plus_pl, ptm


def draw(bell, plus_pl, ptm):
    """The three figures, drawn by the port's plotting functions."""
    import matplotlib.pyplot as plt
    fig_h, ax = plt.subplots()
    hinton(bell, ax=ax)
    ax.set_title("Bell state (Hinton)")
    fig_p, ax = plt.subplots()
    plot_pauli_rep_of_state(plus_pl, ax, ["I", "X", "Y", "Z"], "|+> state")
    fig_t, ax = plt.subplots()
    plot_pauli_transfer_matrix(ptm, ax, title="depolarizing p=0.3")
    return {"hinton_bell.png": fig_h, "pauli_rep_plus.png": fig_p,
            "ptm_depolarizing.png": fig_t}


def main(device="cuda", out_dir="/tmp"):
    bell, plus_pl, ptm = figures(device)
    import matplotlib          # without it, the first figure call raises
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    paths = []
    for name, fig in draw(bell, plus_pl, ptm).items():
        path = os.path.join(out_dir, name)
        fig.savefig(path, dpi=72)
        plt.close(fig)
        paths.append(path)
        print(f"wrote {path}")
    diag = torch.diagonal(ptm).cpu().numpy()
    print("PTM diagonal:", np.round(diag, 3))
    return {"ptm_diagonal": diag,
            "png_bytes": np.array([os.path.getsize(p) for p in paths])}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out-dir", default="/tmp")
    args = parser.parse_args()
    main(args.device, args.out_dir)
