"""The long scripts of ``examples_torch/``: chip_scan, randomized
benchmarking and qubit spectroscopy (they run the Clifford engine's RB and
the spectroscopy fits), through ``main(device="cpu")``, each figure held to
the bar stated here (and in ``chip_smoke.EXAMPLE_BARS``, which
test_torch_examples.py keeps equal to these)."""
import pytest
import torch

from test_torch_examples import run_example

torch.set_num_threads(1)

# (low, high) of each figure. RB: the decay within 3 sigma (its fit's
# standard error) of the injected 0.9; the JAX suite holds its fixed CPU
# draws to 2.5 sigma (tests/test_randomized_benchmarking.py:31), but the
# card draws from other streams: there this script reads 2.55 sigma, its
# 19 other seed offsets 0.12-2.1 (median 0.84), the CPU's 40 a mean of
# +0.09 and a deviation of 0.89 (scripts/example_spread.py), so 2.5 sigma
# would fail one card draw in a hundred and 3 sigma fails one in 370. The
# noiseless X gate's fidelity 1 inside the IRB bounds, unitarity within
# 0.02 of 1;
# spectroscopy: T1 within 1 us (tests/test_qubit_spectroscopy.py:26),
# Rabi within 0.02 (:67), the CZ phase within 0.05 rad (:80). The T2 echo
# of this script is no consistent estimate of T2 = 11 us: beside T1 = 18 us
# (the suite's test has 100 us) amplitude damping moves the baseline the
# decaying-cosine model holds fixed. Over 100 seeds the port reads 6.5 to
# 27.2 us (scripts/example_spread.py), the JAX package's script 7.7 us;
# the bar is (T2 / 2, 3 T2).
# Chip scan, 200 shots at 6 delays on 6 qubits: the largest T1 error
# 0.73-2.72 us over 20 seeds; the CZ process fidelities 1.0063-1.0065 (as
# in the JAX package's script, 1.006); no readout noise (p(0|0) = 1) and
# noiseless RB (error 0).
BARS = {
    "randomized_benchmarking": {
        "decay_sigmas": (0, 3.0), "irb_lower": (0, 1), "irb_upper": (1, 2),
        "unitarity_error": (0, 0.02)},
    "qubit_spectroscopy": {
        "t1_error_us": (0, 1.0), "t2_echo_us": (5.5, 33.0),
        "rabi_error": (0, 0.02), "cz_phase_error": (0, 0.05)},
    "chip_scan": {
        "worst_p00": (1, 1), "min_state_fidelity": (0.95, 1.05),
        "t1_error_us": (0, 4.0), "max_rb_error": (0, 1e-3),
        "cz_fidelity_error": (0, 0.01)},
}


@pytest.mark.parametrize("name", sorted(BARS))
def test_example_meets_its_bars(name, tmp_path):
    run_example(name, tmp_path, BARS)
