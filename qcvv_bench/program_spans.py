"""The program's spans in a ``torch.profiler`` trace of a stretch of calls.

The program (``forest_benchmarking_tpu_torch/tracing.py``) opens named
ranges, ``fbt.*``, inside its hot entry points. This module reduces a trace
that holds them to one :class:`SpanStats` a span name, over the stretch
that the harness's call spans cover, as :mod:`qcvv_bench.tracing` takes it:

- each device operation goes to the innermost program span around the
  runtime call that launched it: the profiler gives the operation and that
  call one correlation id (``FunctionEvent.id``);
- each idle gap of the device goes to the innermost program span running
  at its middle, as ``tracing`` names gaps;
- each host synchronization goes to the innermost program span around it;
- what no program span holds goes under ``OUTSIDE``: the fetch's copy, the
  harness's and the profiler's steps, operations with no launching host
  event (``SpanSummary.unlinked``).

So the spans' launches, device seconds, idle seconds and synchronizations,
``OUTSIDE`` included, sum to the trace summary's own.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

from qcvv_bench import tracing

PROGRAM_PREFIX = "fbt."   # the program's spans
OUTSIDE = "outside"       # what no program span holds
RUNTIME_PREFIX = "cu"     # CUDA API calls (cudaLaunchKernel, cudaMemcpyAsync,
                          # cuLaunchKernel, ...)


class Event(NamedTuple):
    """A :class:`qcvv_bench.tracing.Event` with the profiler's correlation
    id: a device operation shares it with the runtime call that launched
    it (operations of the framework may carry the same numbers)."""
    name: str
    start: float
    end: float
    device: bool
    thread: int = 0
    id: int = 0


@dataclass
class SpanStats:
    """What one program span name holds over the stretch: its count and host
    seconds (start to end, children included), and the device operations,
    idle seconds and synchronizations of which it is the innermost program
    span."""
    count: int = 0
    host_s: float = 0.0
    device_s: float = 0.0
    launches: int = 0
    idle_s: float = 0.0
    syncs: int = 0


@dataclass
class SpanSummary:
    trace: tracing.Summary           # the harness's summary of the events
    call_s: float = 0.0              # the call spans' host seconds, summed
    unlinked: int = 0                # device operations with no launching
                                     # host event (under OUTSIDE)
    spans: Dict[str, SpanStats] = field(default_factory=dict)


def events_from_profile(prof) -> List[Event]:
    """The events of a finished ``torch.profiler.profile``, those that
    :func:`qcvv_bench.tracing.events_from_profile` keeps, with their ids."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.events():
        device = e.device_type != DeviceType.CPU
        if device and (getattr(e, "is_user_annotation", False)
                       or e.name.startswith(tracing.SPAN_PREFIX)):
            continue
        out.append(Event(e.name, float(e.time_range.start),
                         float(e.time_range.end), device, int(e.thread),
                         int(e.id)))
    return out


def _stretch(events: List[Event]):
    """(calls, host events, device operations, idle gaps) of the stretch,
    taken as :func:`qcvv_bench.tracing.summarize` takes them."""
    calls = [e for e in events if not e.device
             and e.name == tracing.CALL_SPAN]
    if not calls:
        return [], [], [], []
    w0, w1 = min(e.start for e in calls), max(e.end for e in calls)
    threads = {e.thread for e in calls}
    host = [e for e in events if not e.device and e.thread in threads
            and e.end > w0 and e.start < w1]
    dev = [e for e in events if e.device and w0 <= e.start < w1]
    gaps, t = [], w0
    for s, e in tracing._union((e.start, min(e.end, w1)) for e in dev):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    return calls, host, dev, gaps


def _innermost(host: List[Event],
               points: List[float]) -> List[Optional[Event]]:
    """The innermost host event running at each point (None where none is),
    the points in ascending order. Host events of one thread nest, so a
    stack swept in time order holds the running ones."""
    host = sorted(host, key=lambda e: (e.start, -e.end))
    out: List[Optional[Event]] = []
    stack: List[Event] = []
    k = 0
    for p in points:
        while k < len(host) and host[k].start <= p:
            while stack and stack[-1].end <= host[k].start:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1].end < p:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def _span_names(spans: List[Event],
                at: List[Optional[Event]]) -> List[str]:
    """The name of the innermost program span around each event's start on
    its own thread, ``OUTSIDE`` where none is (or the event is None)."""
    names = [OUTSIDE] * len(at)
    for thread in {s.thread for s in spans}:
        idx = sorted((i for i, e in enumerate(at) if e and e.thread == thread),
                     key=lambda i: at[i].start)
        running = _innermost([s for s in spans if s.thread == thread],
                             [at[i].start for i in idx])
        for i, s in zip(idx, running):
            if s is not None:
                names[i] = s.name
    return names


def _span_stats(events: List[Event], host: List[Event], dev: List[Event],
                gaps: List[Tuple[float, float]]):
    """(the spans' stats, the device operations with no launching host
    event). A device operation's launching host event is the runtime call
    of its correlation id (an operation of the framework may carry the same
    number: its ids are counted apart)."""
    spans = [e for e in host if e.name.startswith(PROGRAM_PREFIX)]
    stats: Dict[str, SpanStats] = {OUTSIDE: SpanStats()}
    for s in spans:
        st = stats.setdefault(s.name, SpanStats())
        st.count += 1
        st.host_s += (s.end - s.start) / 1e6
    runtime = {e.id: e for e in events if not e.device and e.id
               and e.name.startswith(RUNTIME_PREFIX)}
    launchers = [runtime.get(d.id) for d in dev]
    for d, name in zip(dev, _span_names(spans, launchers)):
        stats[name].device_s += (d.end - d.start) / 1e6
        stats[name].launches += 1
    running = _innermost(spans, [(g0 + g1) / 2 for g0, g1 in gaps])
    for (g0, g1), s in zip(gaps, running):
        stats[s.name if s else OUTSIDE].idle_s += (g1 - g0) / 1e6
    syncs = [e for e in host if "Synchronize" in e.name]
    for name in _span_names(spans, syncs):
        stats[name].syncs += 1
    return stats, launchers.count(None)


def summarize(events: List[Event]) -> SpanSummary:
    """The harness's summary of the stretch and its program spans."""
    trace = tracing.summarize([tracing.Event(*e[:5]) for e in events])
    calls, host, dev, gaps = _stretch(events)
    if not calls:
        return SpanSummary(trace)
    spans, unlinked = _span_stats(events, host, dev, gaps)
    return SpanSummary(trace,
                       call_s=sum(e.end - e.start for e in calls) / 1e6,
                       unlinked=unlinked, spans=spans)
