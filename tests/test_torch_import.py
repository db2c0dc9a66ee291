"""The PyTorch port imports without JAX, the JAX package or a kernel
toolchain, and carries the JAX package's schedule constants."""
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from forest_benchmarking_tpu.ops import lanes_apg as jax_lanes
from forest_benchmarking_tpu_torch.benchmarks import (
    process_tomo_A_matrix, synth_process_datasets)
from forest_benchmarking_tpu_torch.ops import lanes_apg

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, json, os, pkgutil, sys
import numpy, torch  # what torch itself imports is not the port's doing
before = set(sys.modules)
import forest_benchmarking_tpu_torch as pkg
from forest_benchmarking_tpu_torch import kernels
build = kernels.BUILD_DIR
files_before = sorted(os.listdir(build)) if build.exists() else None
names = sorted(m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                    pkg.__name__ + '.'))
for name in names:
    importlib.import_module(name)
new = sorted(set(sys.modules) - before)
print(json.dumps({
    "names": names,
    "jax": [m for m in new if m == "jax" or m.startswith("jax.")],
    "jax_package": [m for m in sys.modules if m == "forest_benchmarking_tpu"
                    or m.startswith("forest_benchmarking_tpu.")],
    "triton": "triton" in sys.modules,
    "tests": [m for m, mod in sys.modules.items()
              if os.path.abspath(getattr(mod, "__file__", None) or "")
              .startswith(os.path.join(os.getcwd(), "tests") + os.sep)],
    "optional": [m for m in ("networkx", "pandas", "tqdm", "matplotlib")
                 if any(n == m or n.startswith(m + ".") for n in new)],
    "cpp_extension": "torch.utils.cpp_extension" in sys.modules,
    "loaded": kernels.load.cache_info().currsize,
    "build_unchanged": files_before == (sorted(os.listdir(build))
                                        if build.exists() else None),
}))
"""


def test_port_imports_without_jax_package_or_toolchain():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300,
                         check=True)
    info = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("benchmarks", "tomography", "kernels", "ops.calculational",
                 "ops.lanes_apg", "ops.pallas_eigh", "ops.pallas_traj",
                 "ops.project_state_matrix", "ops.project_superoperators",
                 "ops.random_operators", "ops.superoperator_transformations",
                 "quantum_volume", "sim.noise", "sim.statevector", "utils",
                 "analysis", "analysis.fitting", "randomized_benchmarking",
                 "qubit_spectroscopy", "distance_measures",
                 "ops.lanes_dnorm", "ops.apply_superoperator",
                 "ops.compose_superoperators", "ops.channel_approximation",
                 "ops.validate_operator", "ops.validate_superoperator",
                 "circuits", "paulis", "compilation", "observable_estimation",
                 "sim", "sim.density", "sim.executor", "sim.qvm",
                 "clifford", "direct_fidelity_estimation",
                 "robust_phase_estimation", "readout", "_graph",
                 "entangled_states", "classical_logic",
                 "classical_logic.primitives",
                 "classical_logic.ripple_carry_adder", "parallel",
                 "parallel.sharding", "plotting", "plotting.hinton",
                 "plotting.state_process", "_vf2", "entry", "bench",
                 "bench_all", "tools", "tools.parity_sweep"):
        assert f"forest_benchmarking_tpu_torch.{name}" in info["names"]
    assert info["jax"] == []
    assert info["jax_package"] == []
    assert info["tests"] == []
    assert not info["triton"]
    assert info["optional"] == []
    assert not info["cpp_extension"]
    assert info["loaded"] == 0
    assert info["build_unchanged"]


_NOTEBOOK_AND_ENTRY = """
import contextlib, io, json, sys
import numpy, torch
sys.modules["matplotlib"] = None   # as on the card's machine
sys.path.insert(0, "examples_torch/notebooks")
import _runner
with contextlib.redirect_stdout(io.StringIO()):
    _runner.run_notebook("observable_estimation", device="cpu")
from forest_benchmarking_tpu_torch import entry
step, args = entry.entry(device="cpu")
print(json.dumps([m for m in sys.modules if m == "jax"
                  or m.startswith(("jax.", "forest_benchmarking_tpu."))
                  or m == "forest_benchmarking_tpu"]))
"""


def test_notebook_runner_and_entry_import_no_jax():
    """Running a notebook through the runner (without matplotlib, as on
    the card's machine) and importing ``entry`` load no ``jax`` and no
    module of the JAX package."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", _NOTEBOOK_AND_ENTRY],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", src, re.M)
    assert imports and all(
        m.split(".")[0] not in ("jax", "forest_benchmarking_tpu")
        for m in imports), imports


def test_schedule_constants_equal_jax():
    assert lanes_apg.PARITY_PHASES == jax_lanes.PARITY_PHASES
    assert lanes_apg.PARITY_TUNED_2Q == jax_lanes.PARITY_TUNED_2Q
    assert lanes_apg.HEADLINE_TUNED_2Q == jax_lanes.HEADLINE_TUNED_2Q
    assert lanes_apg._round_robin_pairs(16) == jax_lanes._round_robin_pairs(16)


def test_cpu_wrapper_runs_plain_version_without_launching():
    a = torch.tensor(process_tomo_A_matrix(1))
    n, _ = synth_process_datasets(torch.Generator().manual_seed(3), a, 2, 2,
                                  500, dtype=torch.float64)
    before = lanes_apg.apg_fused.launches
    est = lanes_apg.apg_fused(a, n, 2, phases=((2, 1, 1),), init_iters=1,
                              final_iters=1)
    assert lanes_apg.apg_fused.launches == before == 0
    assert est.shape == (2, 4, 4) and est.device.type == "cpu"
    assert np.all(np.isfinite(est.numpy()))


JAX_OPS_MODULES = ("apply_superoperator", "calculational",
                   "channel_approximation", "compose_superoperators",
                   "project_state_matrix", "project_superoperators",
                   "random_operators", "superoperator_transformations",
                   "validate_operator", "validate_superoperator")


def test_ops_package_reexports_the_jax_packages_ten_modules():
    """``forest_benchmarking_tpu_torch.ops`` re-exports every ``__all__``
    name of the ten modules the JAX package's ``ops/__init__.py``
    star-imports (as ``from ...ops import kraus2choi`` expects)."""
    import importlib
    import forest_benchmarking_tpu.ops as jax_ops
    from forest_benchmarking_tpu_torch import ops
    for name in JAX_OPS_MODULES:
        mod = importlib.import_module(f"forest_benchmarking_tpu_torch.ops.{name}")
        assert mod.__all__
        for attr in mod.__all__:
            assert getattr(ops, attr) is getattr(mod, attr), (name, attr)
    assert set(dir(jax_ops)) - set(dir(ops)) <= {"jax", "jnp"}


def test_sim_package_reexports_the_jax_names():
    import forest_benchmarking_tpu.sim as jax_sim
    from forest_benchmarking_tpu_torch import sim
    public = {n for n in dir(jax_sim) if not n.startswith("_")
              and n not in ("density", "statevector", "qvm", "executor",
                            "noise")}
    assert public and all(hasattr(sim, n) for n in public)


PROTOCOL_MODULES = ("clifford", "randomized_benchmarking", "qubit_spectroscopy",
                    "direct_fidelity_estimation", "robust_phase_estimation",
                    "readout", "entangled_states", "classical_logic.primitives",
                    "classical_logic.ripple_carry_adder", "quantum_volume")


def test_protocol_modules_carry_the_jax_packages_public_names():
    """The protocol modules (the six of the Clifford-engine slice, the
    entangled states, the adder and quantum volume) have the JAX modules'
    whole ``__all__``, in order, and every name is defined."""
    import importlib
    for name in PROTOCOL_MODULES:
        ours = importlib.import_module(f"forest_benchmarking_tpu_torch.{name}")
        theirs = importlib.import_module(f"forest_benchmarking_tpu.{name}")
        assert ours.__all__ == theirs.__all__, name
        assert all(hasattr(ours, attr) for attr in ours.__all__), name


def test_packages_reexport_the_jax_names():
    """``classical_logic`` star-imports its two modules, ``parallel`` the
    JAX package's five sharding names (and the port's ``fold_in`` and
    ``Mesh``), and the sharded entry points stand in their modules."""
    import forest_benchmarking_tpu.classical_logic as jax_cl
    import forest_benchmarking_tpu.parallel as jax_par
    import forest_benchmarking_tpu.ops.lanes_dnorm as jax_dnorm
    from forest_benchmarking_tpu_torch import classical_logic, parallel
    from forest_benchmarking_tpu_torch.ops import lanes_dnorm
    for ours, theirs in ((classical_logic, jax_cl), (parallel, jax_par)):
        public = {n for n in dir(theirs) if not n.startswith("_")
                  and n not in ("primitives", "ripple_carry_adder",
                                "sharding")}
        assert public and all(hasattr(ours, n) for n in public)
    assert set(jax_dnorm.__all__) <= set(lanes_dnorm.__all__)
    assert set(jax_lanes.__all__) <= set(lanes_apg.__all__)


def test_fitting_and_plotting_carry_the_jax_packages_public_names():
    """``analysis.fitting.__all__`` holds the JAX module's, and
    ``plotting.__all__`` every public name of the JAX package's
    ``plotting`` (its submodules aside); every name is defined."""
    import forest_benchmarking_tpu.analysis.fitting as jax_fitting
    import forest_benchmarking_tpu.plotting as jax_plotting
    from forest_benchmarking_tpu_torch import plotting
    from forest_benchmarking_tpu_torch.analysis import fitting
    assert set(jax_fitting.__all__) <= set(fitting.__all__)
    public = {n for n in dir(jax_plotting) if not n.startswith("_")
              and n not in ("hinton", "state_process")} | {"hinton"}
    assert public <= set(plotting.__all__)
    for mod in (fitting, plotting):
        assert all(hasattr(mod, name) for name in mod.__all__)
