"""On-card tests of the benchmark: each cell's run, short, from the root.

Marked ``cuda``; without a card they skip (inside the fixture). On the
card: ``python -m pytest --noconftest -p no:cacheprovider -q
qcvv_bench/tests/test_qcvv_bench_cuda.py``.
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

import qcvv_bench_helpers as helpers

CELLS = list(helpers.SMALL)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_of_each_cell_is_correct(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "qcvv_bench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 101), "--seconds", "2", "--trace", str(trace)],
        cwd=helpers.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, out.stderr[-3000:]
    assert result["device"]["kind"] == card and result["failed"] == 0
    if trace:
        assert result["device"]["busy_s"] > 0
        assert all(v["value"] <= 105 for k, v in result["metrics"].items()
                   if k.endswith("roofline_pct"))
