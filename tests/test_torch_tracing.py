"""The port's spans (``forest_benchmarking_tpu_torch/tracing.py``): free when
no profiler records, each step of the two hot entry points spanned once a
call and nested as documented when one does, and found under these names
by the benchmark's reduction of the spans."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from forest_benchmarking_tpu_torch import quantum_volume, tomography, tracing
from forest_benchmarking_tpu_torch.benchmarks import process_tomo_A_matrix
from forest_benchmarking_tpu_torch.ops import lanes_apg
from qcvv_bench import program_spans
from qcvv_bench import tracing as bench_tracing

CALL = "test.call"
CALLS = 2

APG_STEPS = [tracing.APG_RASTER, tracing.APG_PINV, tracing.APG_WARM_START,
             tracing.APG_KERNEL, tracing.APG_ASSEMBLE]
QV_STEPS = {
    "ideal": [tracing.QV_DRAWS, tracing.QV_IDEAL, tracing.QV_HEAVY_SETS,
              tracing.QV_SHOTS],
    "trajectory": [tracing.QV_DRAWS, tracing.QV_IDEAL, tracing.QV_HEAVY_SETS,
                   tracing.QV_TRAJECTORIES, tracing.QV_SHOTS],
    "density": [tracing.QV_DRAWS, tracing.QV_IDEAL, tracing.QV_HEAVY_SETS,
                tracing.QV_SHOTS],
}


@pytest.fixture(scope="module")
def tomo_inputs():
    a = torch.tensor(process_tomo_A_matrix(2), dtype=torch.complex64)
    n = torch.rand(3, a.shape[0], generator=torch.Generator().manual_seed(4))
    return a, n / n.sum(1, keepdim=True)


def _apg(a, n, route):
    if route == "entry":
        return tomography.pgdb_process_estimate_batched(
            a, n, dim=4, method="apg", cp_method="pallas",
            fused_schedule="headline")
    kw = dict(lanes_apg.HEADLINE_TUNED_2Q)
    if route == "a_pinv":
        kw["a_pinv"] = torch.linalg.pinv(a)
    return lanes_apg.apg_fused(a, n, 4, **kw)


def _qv(method, generator):
    kw = {}
    if method != "ideal":
        kw = dict(kraus=np.eye(4, dtype=np.complex64)[None],
                  noisy_method=method)
    return quantum_volume.sample_heavy_outputs_batched(
        generator, 4, 3, 20, device="cpu", **kw)


def _spans(fn):
    """[(name, parent name)] of the spans of ``CALLS`` calls of ``fn``, in
    time order, each call inside a span ``CALL``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(CALLS):
            with record_function(CALL):
                fn()
    events = sorted((e for e in prof.events()
                     if e.name.startswith(tracing.PREFIX) or e.name == CALL),
                    key=lambda e: e.time_range.start)
    return [(e.name, e.cpu_parent.name if e.cpu_parent else None)
            for e in events]


def _expected(root, steps):
    one = [(CALL, None), (root, CALL)] + [(s, root) for s in steps]
    return one * CALLS


def test_without_a_profiler_span_is_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError("record_function called with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert tracing.span(tracing.APG_FUSED) is tracing.span(tracing.QV_SHOTS)
    with tracing.span(tracing.APG_PINV) as entered:
        assert entered is None


def test_without_a_profiler_the_entry_points_open_no_span(monkeypatch,
                                                          tomo_inputs):
    def refuse(name):
        raise AssertionError("record_function called with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, n = tomo_inputs
    assert _apg(a, n, "entry").shape == (3, 16, 16)
    counts = _qv("trajectory", torch.Generator().manual_seed(1))
    assert counts.shape == (3,)


@pytest.mark.parametrize("route", ["direct", "a_pinv", "entry"])
def test_apg_fused_spans_each_step_once_a_call(tomo_inputs, route):
    a, n = tomo_inputs
    assert _spans(lambda: _apg(a, n, route)) == _expected(tracing.APG_FUSED,
                                                          APG_STEPS)


@pytest.mark.parametrize("method", sorted(QV_STEPS))
def test_sample_heavy_spans_each_step_once_a_call(method):
    g = torch.Generator().manual_seed(2)
    assert _spans(lambda: _qv(method, g)) == _expected(
        tracing.QV_SAMPLE_HEAVY, QV_STEPS[method])


def test_spans_leave_the_results_as_they_were(tomo_inputs):
    a, n = tomo_inputs
    plain = _apg(a, n, "direct")
    counts = _qv("ideal", torch.Generator().manual_seed(3))
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _apg(a, n, "direct")
        traced_counts = _qv("ideal", torch.Generator().manual_seed(3))
    assert torch.equal(plain, traced) and torch.equal(counts, traced_counts)


def test_span_names_are_the_modules_constants():
    names = {v for k, v in vars(tracing).items()
             if k.isupper() and k != "PREFIX" and isinstance(v, str)}
    spanned = {tracing.APG_FUSED, tracing.QV_SAMPLE_HEAVY, *APG_STEPS,
               *QV_STEPS["trajectory"]}
    assert names == spanned
    assert all(n.startswith(tracing.PREFIX) for n in names)
    assert all(s.startswith(tracing.APG_FUSED + ".") for s in APG_STEPS)


@pytest.mark.parametrize("route", ["apg_fused", "ideal", "trajectory",
                                   "density"])
def test_the_benchmarks_span_reduction_reads_these_names(tomo_inputs, route):
    """``qcvv_bench/program_spans.py`` finds each span of a profiled call
    under the module's constant, once a call."""
    a, n = tomo_inputs
    g = torch.Generator().manual_seed(5)
    if route == "apg_fused":
        fn, root, steps = lambda: _apg(a, n, "direct"), tracing.APG_FUSED, \
            APG_STEPS
    else:
        fn, root, steps = lambda: _qv(route, g), tracing.QV_SAMPLE_HEAVY, \
            QV_STEPS[route]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(CALLS):
            with record_function(bench_tracing.CALL_SPAN):
                fn()
    s = program_spans.summarize(program_spans.events_from_profile(prof))
    assert s.trace.calls == CALLS
    assert {k: v.count for k, v in s.spans.items()
            if k != program_spans.OUTSIDE} == {k: CALLS for k in [root, *steps]}
    assert program_spans.PROGRAM_PREFIX == tracing.PREFIX


def _inside(event, name):
    """Whether ``event`` runs inside a span ``name`` (at any depth)."""
    parent = event.cpu_parent
    while parent is not None:
        if parent.name == name:
            return True
        parent = parent.cpu_parent
    return False


@pytest.mark.parametrize("lookup", ["hit", "miss"])
def test_the_pinv_span_opens_on_a_cache_hit_and_runs_no_svd(tomo_inputs,
                                                            lookup):
    """A call whose A is cached still opens ``fbt.apg_fused.pinv`` once, and
    no SVD runs inside it; a new A-matrix tensor runs its SVD there."""
    a, n = tomo_inputs
    _apg(a, n, "direct")
    if lookup == "miss":
        a = a.clone()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _apg(a, n, "direct")
    events = list(prof.events())
    assert [e.name for e in events].count(tracing.APG_PINV) == 1
    svd = [e for e in events if "svd" in e.name
           and _inside(e, tracing.APG_PINV)]
    assert bool(svd) == (lookup == "miss")
