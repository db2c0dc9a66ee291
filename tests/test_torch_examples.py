"""The scripts of ``examples_torch/`` (the port's counterparts of the JAX
package's ``examples/``) run on the CPU through ``main(device="cpu")``, and
the figures they print are held to the bars stated here. ``chip_smoke.py``
phase 20 holds the same figures to the same bars on the card
(``EXAMPLE_BARS``; ``test_chip_smoke_bars_are_these`` keeps them equal).
The RB, spectroscopy and chip-scan scripts are in
test_torch_examples_protocols.py, so that ``--dist loadfile`` spreads
them."""
import ast
import contextlib
import importlib.util
import io
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples_torch"
RO = 1e-12   # f64 round-off, for the figures with a closed form

# (low, high) of each figure, by script. Sources: the analytic values the
# scripts print beside their figures; PERF.md section 2 ("Fidelity of the
# estimate to the truth": state within [0.95, 1.05], process >= 0.85;
# "Recovery of the injected truth": DFE within 0.02 (noiseless within 0.01,
# MC process within 0.05, tests/test_direct_fidelity_estimation.py:42-91),
# RPE within 0.05 rad, confusion within 5 binomial sigma); QV as
# tests/test_quantum_volume.py:73 and :84 hold it (per-circuit in (0.7,
# 0.95), batched in (0.75, 0.95) with QV 2^4); GHZ share > 0.99
# (tests/test_readout_and_logic.py:85). Where the JAX suite has no bar for
# a statistical figure, the bar is 5 binomial sigma of its shots, or the
# port's spread over 20 seeds (scripts/example_spread.py) widened.
BARS = {
    "state_and_process_tomography": {
        "state_fidelity": (0.95, 1.05), "process_fidelity": (0.85, 1.05)},
    "quantum_volume": {
        "ideal_qv": (16, 16), **{f"ideal_prob_d{d}": (0.75, 0.95)
                                 for d in (2, 3, 4)},
        "per_circuit_prob_d2": (0.7, 0.95), "per_circuit_prob_d3": (0.7, 0.95),
        "line_prob_d3": (0.7, 0.95),
        # 8% depolarizing: 0.711-0.745 over 20 seeds, at the 2/3 line
        "noisy_prob_d2": (0.6, 0.8), "noisy_qv": (2, 4)},
    "distance_measures": {
        "fidelity_error": (0, RO), "trace_distance_error": (0, RO),
        "purity_error": (0, RO), "bures_angle_error": (0, RO),
        "process_fidelity_error": (0, RO),
        "entanglement_fidelity_error": (0, RO),
        "diamond_norm_error": (0, 1e-4), "watrous_error": (0, RO)},
    "superoperator_tools": {
        "cptp": (1, 1), "unital": (0, 0), "chi00_error": (0, RO),
        "ptm_error": (0, RO), "apply_agreement": (0, RO),
        "corrupted_cptp": (0, 0), "repaired_cptp": (1, 1),
        "unitarity": (0, RO), "ginibre_purity": (0.5, 1),
        "bures_purity": (0.5, 1), "bcsz_cptp": (1, 1)},
    "observable_estimation": {
        "runs_ungrouped": (4, 4), "runs_grouped": (3, 3),
        # XX, YY, ZZ of a Bell state; Z0 at 4000 shots: 3 sigma
        "ideal_correlator_error": (0, 0.05), "ideal_z0": (-0.05, 0.05),
        # 0.015-0.055 over 20 seeds (JAX's example: 0.020)
        "calibrated_correlator_error": (0, 0.08)},
    "direct_fidelity_estimation": {
        "ghz_error": (0, 0.01), "depolarized_error": (0, 0.02),
        "cnot_error": (0, 0.05)},
    "robust_phase_estimation": {"rz_error": (0, 0.05), "rx_error": (0, 0.05)},
    "readout_characterization": {
        "confusion_sigmas": (0, 5), "joint_sigmas": (0, 5),
        "marginal_sigmas": (0, 5)},
    "entangled_states": {
        "ghz_bell_share": (0.99, 1),
        # each <ZZZ> within 5 binomial sigma of -sin(theta), 2000 shots
        "zzz_sigmas": (0, 5)},
    "ripple_carry_adder": {
        "success_Z": (1, 1), "success_X": (1, 1), "hamming_weight_0": (1, 1),
        "noisy_success_sigmas": (0, 5)},
    "plotting": {"ptm_diagonal_error": (0, RO),
                 "smallest_png_bytes": (1, math.inf)},
}


def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_example(name, tmp_path, bars):
    """Run ``main(device="cpu")`` of examples_torch/<name>.py and hold its
    figures to ``bars[name]``; returns what it returned and printed."""
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = module.main(device="cpu", out_dir=str(tmp_path))
    assert buf.getvalue().strip(), f"{name} printed nothing"
    figures = smoke().example_figures(name, out)
    assert set(figures) == set(bars[name])
    for fig, value in figures.items():
        lo, hi = bars[name][fig]
        assert lo <= value <= hi, (name, fig, value, (lo, hi))
    return out, buf.getvalue()


@pytest.mark.parametrize("name", sorted(set(BARS) - {"plotting"}))
def test_example_meets_its_bars(name, tmp_path):
    run_example(name, tmp_path, BARS)


def test_plotting_example_writes_three_pngs_and_jax_ptm(tmp_path):
    """Three non-empty PNGs in ``out_dir``; the PTM diagonal equals the JAX
    package's, [1, 0.7, 0.7, 0.7], to 1e-12."""
    import matplotlib
    matplotlib.use("Agg")
    import jax.numpy as jnp
    from forest_benchmarking_tpu.ops import choi2pauli_liouville, kraus2choi
    from forest_benchmarking_tpu.sim.noise import depolarizing_kraus_map
    out, printed = run_example("plotting", tmp_path, BARS)
    pngs = sorted(tmp_path.glob("*.png"))
    assert [p.name for p in pngs] == ["hinton_bell.png", "pauli_rep_plus.png",
                                      "ptm_depolarizing.png"]
    assert all(p.stat().st_size > 0 for p in pngs)
    jax_ptm = np.real(np.asarray(choi2pauli_liouville(kraus2choi(
        jnp.asarray(np.stack(depolarizing_kraus_map(0.3)))))))
    np.testing.assert_allclose(out["ptm_diagonal"], np.diag(jax_ptm),
                               atol=1e-12, rtol=0)
    np.testing.assert_allclose(np.diag(jax_ptm), [1, .7, .7, .7], atol=1e-12)


def test_chip_smoke_bars_are_these():
    """Phase 20 holds each figure to the bar stated in these two files."""
    spec = importlib.util.spec_from_file_location(
        "test_torch_examples_protocols",
        ROOT / "tests" / "test_torch_examples_protocols.py")
    protocols = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(protocols)
    module = smoke()
    assert set(module.EXAMPLES) == set(BARS) | set(protocols.BARS)
    assert module.EXAMPLE_BARS == {**BARS, **protocols.BARS}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_examples_torch_mirror_examples_and_import_no_jax():
    """examples_torch/ has the file names of examples/*.py, and no script
    imports jax, networkx or the JAX package."""
    ours = sorted(p.name for p in EXAMPLES.glob("*.py"))
    assert ours == sorted(p.name for p in (ROOT / "examples").glob("*.py"))
    for path in EXAMPLES.glob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "networkx", "forest_benchmarking_tpu"), (
                path.name, name)


@pytest.mark.parametrize("name", sorted(p.stem for p in EXAMPLES.glob("*.py")))
def test_example_without_a_card_raises(name):
    """``main()`` runs on the card: without one it raises, and nothing falls
    back to the CPU."""
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with contextlib.redirect_stdout(io.StringIO()):
            module.main()


def test_example_runs_as_a_script():
    """``python examples_torch/<name>.py --device cpu`` imports the port
    from the checkout and prints the script's lines."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in env.get("PYTHONPATH", "").split(os.pathsep)
        if p and pathlib.Path(p).resolve() != ROOT)
    out = subprocess.run(
        [sys.executable, str(EXAMPLES / "distance_measures.py"), "--device",
         "cpu"], cwd=str(ROOT / "tests"), env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "diamond norm: 0.3000 (analytic 0.3000)" in out.stdout
