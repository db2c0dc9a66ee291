"""The reduction of the program's spans (``qcvv_bench/program_spans.py``):
device operations tied to spans by correlation id, idle gaps by their
middle, every operation counted once, and the stretch, its events and its
gaps taken as the harness's trace summary takes them. The last test runs
each cell on the card (marked ``cuda``)."""
from __future__ import annotations

import collections
import json
import random
import subprocess
import sys
from typing import Dict, List

import pytest
import torch

from forest_benchmarking_tpu_torch import quantum_volume
from forest_benchmarking_tpu_torch import tracing as program_tracing

from qcvv_bench import program_spans, tracing
from qcvv_bench.program_spans import OUTSIDE, Event

import qcvv_bench_helpers as helpers


def host(name, start, end, id=0):
    return Event(name, start, end, False, 1, id)


def device(name, start, end, id=0):
    return Event(name, start, end, True, 0, id)


# one call: the pinv's SVD is launched inside fbt.apg_fused.pinv but runs
# while the host is in fbt.apg_fused.kernel; an aten operation there carries
# the same number as the SVD's launch (the framework counts its ids apart)
EVENTS = [
    host("qcvv.call", 0, 100), host("qcvv.entry", 0, 60),
    host("fbt.apg_fused", 5, 60),
    host("fbt.apg_fused.pinv", 10, 30), host("cudaLaunchKernel", 12, 14, 101),
    host("cudaStreamSynchronize", 20, 29),
    host("fbt.apg_fused.kernel", 35, 55), host("aten::mm", 38, 50, 101),
    host("cudaLaunchKernel", 41, 43, 102),
    host("qcvv.fetch", 60, 100), host("cudaMemcpyAsync", 62, 64, 103),
    host("cudaStreamSynchronize", 64, 95),
    device("svd", 40, 70, 101), device("apg_kernel", 70, 90, 102),
    device("Memcpy DtoH", 91, 95, 103), device("stray", 96, 97, 999),
]


def test_operations_go_to_the_span_of_their_launch_gaps_by_their_middle():
    s = program_spans.summarize(EVENTS)
    spans = s.spans
    assert set(spans) == {OUTSIDE, "fbt.apg_fused", "fbt.apg_fused.pinv",
                          "fbt.apg_fused.kernel"}
    pinv = spans["fbt.apg_fused.pinv"]
    assert (pinv.count, pinv.launches, pinv.syncs) == (1, 1, 1)
    assert pinv.host_s == pytest.approx(20e-6)
    assert pinv.device_s == pytest.approx(30e-6)        # by id, not by time
    assert pinv.idle_s == pytest.approx(40e-6)          # gap 0-40, middle 20
    kernel = spans["fbt.apg_fused.kernel"]
    assert (kernel.launches, kernel.device_s, kernel.idle_s) == (
        1, pytest.approx(20e-6), 0.0)
    top = spans["fbt.apg_fused"]
    assert (top.count, top.launches, top.idle_s) == (1, 0, 0.0)
    assert top.host_s == pytest.approx(55e-6)
    outside = spans[OUTSIDE]
    assert (outside.count, outside.launches, outside.syncs) == (0, 2, 1)
    assert outside.device_s == pytest.approx(5e-6)      # the copy, the stray
    assert outside.idle_s == pytest.approx(5e-6)        # 90-91, 95-96, 97-100
    assert s.unlinked == 1 and s.call_s == pytest.approx(100e-6)


def _random_events(seed: int) -> List[Event]:
    """Calls of nested host events (program spans, harness spans, aten
    operations, runtime calls, synchronizations) and device operations,
    each launched by a runtime call or by none, some ids shared by a
    framework operation."""
    rng = random.Random(seed)
    out: List[Event] = []
    next_id = [1000]

    def nest(t0, t1, depth, names):
        t = t0
        while t < t1 - 4 and rng.random() < 0.95:
            a = rng.uniform(t, min(t1 - 3, t + 10))
            b = rng.uniform(a + 1, min(t1, a + (t1 - t0) / 3 + 1))
            kind = rng.choice(names)
            if kind == "launch":
                next_id[0] += 1
                i = next_id[0]
                out.append(host("cudaLaunchKernel", a, b, i))
                d0 = b + rng.uniform(0, 30)
                out.append(device(f"k{rng.randrange(5)}", d0,
                                  d0 + rng.uniform(0.1, 8), i))
                if rng.random() < 0.2:          # a framework id that collides
                    out.append(host("aten::view", a, a, i))
            elif kind == "sync":
                out.append(host("cudaDeviceSynchronize", a, b))
            else:
                out.append(host(kind, a, b, rng.randrange(1, 999)))
                if depth < 4:
                    nest(a, b, depth + 1, names)
            t = b

    t = 0.0
    for _ in range(rng.randrange(1, 6)):
        length = rng.uniform(50, 300)
        out.append(host(tracing.CALL_SPAN, t, t + length))
        nest(t, t + length, 0, ["fbt.qv.sample_heavy", "fbt.qv.draws",
                                "fbt.qv.shots", "qcvv.entry", "aten::mm",
                                "launch", "launch", "sync"])
        t += length + rng.uniform(0, 20)
    for _ in range(rng.randrange(3)):         # launched by nothing traced
        d0 = rng.uniform(0, t)
        out.append(device("orphan", d0, d0 + 1, rng.randrange(1, 99)))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_every_device_operation_is_counted_once(seed):
    s = program_spans.summarize(_random_events(seed))
    spans, t = s.spans.values(), s.trace
    assert sum(v.launches for v in spans) == t.launches
    assert sum(v.device_s for v in spans) == pytest.approx(
        sum(t.device_s.values()), abs=1e-12)
    assert sum(v.idle_s for v in spans) == pytest.approx(
        t.window_s - t.busy_s, abs=1e-12)
    assert sum(v.syncs for v in spans) == t.syncs
    assert s.unlinked <= s.spans[OUTSIDE].launches


@pytest.mark.parametrize("seed", range(8))
def test_gaps_and_the_stretch_are_taken_as_the_harness_takes_them(seed):
    events = _random_events(seed)
    hosts = [tracing.Event(*e[:5]) for e in events if not e.device]
    rng = random.Random(seed)
    gaps = sorted((a, a + rng.uniform(0.1, 9)) for a in
                  (rng.uniform(0, 500) for _ in range(40)))
    running = program_spans._innermost(hosts, [(a + b) / 2 for a, b in gaps])
    named: Dict[str, float] = collections.defaultdict(float)
    for (a, b), e in zip(gaps, running):
        named[e.name if e else "host idle"] += (b - a) / 1e6
    assert dict(named) == tracing._name_gaps(hosts, gaps)
    # the summary's gaps are the harness's: named alike, the same seconds
    s = program_spans.summarize(events)
    calls, host, _, stretch_gaps = program_spans._stretch(events)
    assert len(calls) == s.trace.calls
    assert tracing._name_gaps([tracing.Event(*e[:5]) for e in host],
                              stretch_gaps) == s.trace.gaps_s
    # the correlation ids move no field of the harness's summary
    assert s.trace == tracing.summarize(
        [tracing.Event(*e[:5]) for e in events])
    without = program_spans.summarize([e._replace(id=0) for e in events])
    assert without.trace == s.trace
    assert without.unlinked == without.trace.launches


def test_a_profile_of_the_programs_cpu_route_holds_its_spans():
    """On the CPU: the program's spans reach the summary through
    ``events_from_profile``, which keeps the events that the harness's
    keeps, once a call each; nothing ran on a device."""
    from torch.profiler import ProfilerActivity, profile, record_function
    g = torch.Generator().manual_seed(9)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with record_function(tracing.CALL_SPAN):
                quantum_volume.sample_heavy_outputs_batched(
                    g, 4, 3, 20, device="cpu")
    events = program_spans.events_from_profile(prof)
    assert [tracing.Event(*e[:5]) for e in events] == \
        tracing.events_from_profile(prof)
    assert all(e.id for e in events if e.name.startswith("fbt."))
    s = program_spans.summarize(events)
    assert s.trace.calls == 3 and s.trace.launches == 0
    want = {program_tracing.QV_SAMPLE_HEAVY, program_tracing.QV_DRAWS,
            program_tracing.QV_IDEAL, program_tracing.QV_HEAVY_SETS,
            program_tracing.QV_SHOTS}
    assert {k for k in s.spans if k != OUTSIDE} == want
    assert all(s.spans[k].count == 3 for k in want)


# launches a call before the program had spans (the benchmark's first
# traced runs): the program's spans add none
PARENT_LAUNCHES = {"ptomo2q.fused_b16384": (994, 994),
                   "ptomo2q.fused_b41": (990.5, 992),
                   "qv8.traj_c1600": (170, 170),
                   "qv8.ideal_c1600": (99, 99)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(PARENT_LAUNCHES))
def test_on_the_card_every_operation_has_its_launch(card, cell):
    out = subprocess.run(
        [sys.executable, "qcvv_bench/spans.py", "--workload", cell,
         "--seed", str(2 ** 31 + 211)],
        cwd=helpers.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["card"] == card and r["unlinked"] == 0
    lo, hi = PARENT_LAUNCHES[cell]
    assert lo <= r["launches_per_call"] <= hi
    spans = r["spans"]
    assert sum(v["launches"] for v in spans.values()) == pytest.approx(
        r["launches_per_call"])
    root = (program_tracing.APG_FUSED if cell.startswith("ptomo2q")
            else program_tracing.QV_SAMPLE_HEAVY)
    assert spans[root]["count"] == r["calls"]
    # the fetch's copy to the host is launched outside the program (one
    # run of the small batch read 0.99 a call: the profiler now and then
    # loses a device record there, as its 990.5-992 launches show)
    assert spans[OUTSIDE]["launches"] >= 0.9
