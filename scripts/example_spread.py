#!/usr/bin/env python3
"""Spread of the example scripts' and notebooks' statistical figures over
seeds.

Runs ``main`` of each script of ``examples_torch/`` (by default the
statistical ones), or with ``--notebooks`` each notebook of
``examples_torch/notebooks/`` through its plain-Python runner (by default
all 23), on ``--device`` (the CPU by default; ``cuda`` on the card) once
for each of ``--seeds`` seed offsets:
every ``QVM``, ``torch.Generator`` and ``numpy.random.RandomState`` the
script or notebook and the port create while it runs is seeded ``1000 * k``
above what it asks for. Prints, for every figure ``chip_smoke.py`` holds,
its range over the seeds beside its bar (``chip_smoke.EXAMPLE_BARS``,
``chip_smoke.NOTEBOOK_BARS``), and the seeds that leave the bar. A run on the card draws from other streams, so
this spread is what the bars must leave room for.

    python3 scripts/example_spread.py --seeds 20
    python3 scripts/example_spread.py --seeds 5 chip_scan
    python3 scripts/example_spread.py --device cuda --seeds 10
    python3 scripts/example_spread.py --notebooks --seeds 20
    python3 scripts/example_spread.py --notebooks --seeds 5 quantum_volume

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


def run_script(name: str, device: str) -> dict:
    out = load(name).main(device=device, out_dir=str(ROOT / "build"))
    return chip_smoke.example_figures(name, out)


def run_notebook(name: str, device: str) -> dict:
    namespace, _ = chip_smoke.load_runner().run_notebook(name, device=device)
    return chip_smoke.notebook_figures(name, namespace)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=20)
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--notebooks", action="store_true",
                        help="the notebooks, not the scripts")
    parser.add_argument("names", nargs="*")
    args = parser.parse_args()
    torch.set_num_threads(1)
    if args.notebooks:
        names = args.names or chip_smoke.NOTEBOOKS
        bars, run = chip_smoke.NOTEBOOK_BARS, run_notebook
    else:
        names = args.names or STATISTICAL
        bars, run = chip_smoke.EXAMPLE_BARS, run_script
    for name in names:
        rows, failed = {}, []
        for k in range(args.seeds):
            try:
                with seed_offset(1000 * k), \
                        contextlib.redirect_stdout(io.StringIO()):
                    figures = run(name, args.device)
            except AssertionError as err:   # a notebook's own assert
                failed.append((k, str(err)))
                continue
            for fig, v in figures.items():
                rows.setdefault(fig, []).append(v)
        print(f"{name} ({args.seeds} seeds, {args.device}):", flush=True)
        if failed:
            print(f"  seeds whose own asserts failed: {failed}")
        for fig, vals in rows.items():
            lo, hi = bars[name][fig]
            out_of_bar = [k for k, v in enumerate(vals) if not lo <= v <= hi]
            print(f"  {fig}: min {min(vals):.6g} median {np.median(vals):.6g} "
                  f"max {max(vals):.6g}; bar [{lo}, {hi}]; seeds outside: "
                  f"{out_of_bar}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
