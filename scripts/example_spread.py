#!/usr/bin/env python3
"""Spread of the example scripts' statistical figures over seeds.

Runs ``main`` of each script of ``examples_torch/`` (by default the
statistical ones) on ``--device`` (the CPU by default; ``cuda`` on the
card) once for each of ``--seeds`` seed offsets:
every ``QVM``, ``torch.Generator`` and ``numpy.random.RandomState`` the
script and the port create while it runs is seeded ``1000 * k`` above what
the script asks for. Prints, for every figure ``chip_smoke.py`` holds, its
range over the seeds beside its bar (``chip_smoke.EXAMPLE_BARS``), and the
seeds that leave the bar. A run on the card draws from other streams, so
this spread is what the bars must leave room for.

    python3 scripts/example_spread.py --seeds 20
    python3 scripts/example_spread.py --seeds 5 chip_scan
    python3 scripts/example_spread.py --device cuda --seeds 10

One process, float64; a few minutes for 20 seeds on the CPU.
"""
import argparse
import contextlib
import importlib.util
import io
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from forest_benchmarking_tpu_torch.sim import qvm as qvm_module  # noqa: E402

STATISTICAL = ("quantum_volume", "observable_estimation",
               "randomized_benchmarking", "qubit_spectroscopy",
               "direct_fidelity_estimation", "robust_phase_estimation",
               "readout_characterization", "entangled_states",
               "ripple_carry_adder", "state_and_process_tomography",
               "chip_scan")


@contextlib.contextmanager
def seed_offset(offset: int):
    """Seed every QVM, torch.Generator and RandomState ``offset`` higher."""
    qvm_init = qvm_module.QVM.__init__
    generator, random_state = torch.Generator, np.random.RandomState

    class Generator(generator):
        def manual_seed(self, seed):
            return super().manual_seed(seed + offset)

    class RandomState(random_state):
        def __init__(self, seed=None):
            super().__init__(None if seed is None else seed + offset)

    def init(self, seed=52, *args, **kw):
        qvm_init(self, seed + offset, *args, **kw)

    torch.Generator, np.random.RandomState = Generator, RandomState
    qvm_module.QVM.__init__ = init
    try:
        yield
    finally:
        torch.Generator, np.random.RandomState = generator, random_state
        qvm_module.QVM.__init__ = qvm_init


def load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples_torch" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=20)
    parser.add_argument("--device", default="cpu")
    parser.add_argument("names", nargs="*", default=STATISTICAL)
    args = parser.parse_args()
    torch.set_num_threads(1)
    for name in args.names:
        module = load(name)
        rows = {}
        for k in range(args.seeds):
            with seed_offset(1000 * k), contextlib.redirect_stdout(io.StringIO()):
                out = module.main(device=args.device,
                                  out_dir=str(ROOT / "build"))
            for fig, v in chip_smoke.example_figures(name, out).items():
                rows.setdefault(fig, []).append(v)
        print(f"{name} ({args.seeds} seeds, {args.device}):", flush=True)
        for fig, vals in rows.items():
            lo, hi = chip_smoke.EXAMPLE_BARS[name][fig]
            out_of_bar = [k for k, v in enumerate(vals) if not lo <= v <= hi]
            print(f"  {fig}: min {min(vals):.6g} median {np.median(vals):.6g} "
                  f"max {max(vals):.6g}; bar [{lo}, {hi}]; seeds outside: "
                  f"{out_of_bar}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
