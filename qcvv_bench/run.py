"""Run one cell of the benchmark; see :mod:`qcvv_bench.harness`.

From the root of a checkout: ``python qcvv_bench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``.
"""
import time

T0 = time.perf_counter()   # set-up is timed from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# import the benchmark and the program from the checkout's root, not from
# this folder (whose module names could shadow others)
sys.path[0] = str(ROOT)
if sys.flags.dont_write_bytecode:
    # The environment turns Python's bytecode cache off, so each run would
    # compile torch's sources anew (seconds of set-up that swing with the
    # host's load): keep the cache at a fixed place inside the checkout.
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(ROOT / "build" / "pycache")

from qcvv_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t0=T0))
