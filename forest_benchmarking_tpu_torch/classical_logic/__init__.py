"""Reversible classical logic: the CDKM ripple-carry adder and its
primitives. Port of ``forest_benchmarking_tpu/classical_logic``."""
from forest_benchmarking_tpu_torch.classical_logic.primitives import *  # noqa: F401,F403
from forest_benchmarking_tpu_torch.classical_logic.ripple_carry_adder import *  # noqa: F401,F403
