"""Summary of a ``torch.profiler`` trace over a stretch of a run's calls.

The device side is every operation the profiler put on a card's timeline
(kernels, copies, sets), without the device mirrors of the harness's own
``record_function`` spans. The summary counts them as launches (as
``chip_smoke.profiled`` counts them: every device operation; a frozen copy
of its reduction, held equal to it by
``qcvv_bench/tests/test_qcvv_bench_frozen.py``), sums their time by name,
takes the union of their intervals inside the
traced window as the device's busy time, and names each idle gap of that
window by the innermost host event that was running at its middle (a
harness span, an ``aten`` operation or a CUDA runtime call).
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, NamedTuple, Tuple

SPAN_PREFIX = "qcvv."
CALL_SPAN = "qcvv.call"
NAME_CHARS = 120          # breakdown names are cut to this length


class Event(NamedTuple):
    """One event of a trace, times in microseconds from the trace's start."""
    name: str
    start: float
    end: float
    device: bool
    thread: int = 0


@dataclass
class Summary:
    calls: int                       # harness call spans in the stretch
    window_s: float                  # first call's start to last call's end
    busy_s: float                    # union of device operations in it
    launches: int                    # device operations in it
    syncs: int                       # host synchronization calls in it
    device_s: Dict[str, float] = field(default_factory=dict)
    device_n: Dict[str, int] = field(default_factory=dict)
    gaps_s: Dict[str, float] = field(default_factory=dict)

    def device_time(self, fragment: str) -> Tuple[float, int]:
        """(seconds, launches) of the device operations whose name holds
        ``fragment``."""
        names = [n for n in self.device_s if fragment in n]
        return (sum(self.device_s[n] for n in names),
                sum(self.device_n[n] for n in names))

    def idle_pct(self) -> float:
        """Share of the window, in %, in which no operation ran on the
        device."""
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def launches_per_call(self) -> float:
        """Device operations over the calls of the stretch."""
        return self.launches / self.calls

    def breakdown(self, top: int = 10) -> dict:
        def largest(d):
            ranked = sorted(d.items(), key=lambda kv: kv[1], reverse=True)
            return [[n[:NAME_CHARS], s] for n, s in ranked[:top]]
        return {"device_ops": largest(self.device_s),
                "idle_gaps": largest(self.gaps_s)}


def events_from_profile(prof) -> List[Event]:
    """The events of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.events():
        device = e.device_type != DeviceType.CPU
        if device and (getattr(e, "is_user_annotation", False)
                       or e.name.startswith(SPAN_PREFIX)):
            continue
        out.append(Event(e.name, float(e.time_range.start),
                         float(e.time_range.end), device, int(e.thread)))
    return out


def _union(intervals: Iterable[Tuple[float, float]]):
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _name_gaps(host: List[Event], gaps: List[Tuple[float, float]]):
    """{name: seconds}: each gap under the innermost host event running at
    its middle ('host idle' where none is). Host events of one thread nest,
    so a stack swept in time order holds the running ones."""
    host = sorted(host, key=lambda e: (e.start, -e.end))
    out: Dict[str, float] = collections.defaultdict(float)
    stack: List[Event] = []
    k = 0
    for g0, g1 in sorted(gaps):
        mid = (g0 + g1) / 2
        while k < len(host) and host[k].start <= mid:
            while stack and stack[-1].end <= host[k].start:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1].end < mid:
            stack.pop()
        out[stack[-1].name if stack else "host idle"] += (g1 - g0) / 1e6
    return dict(out)


def summarize(events: List[Event]) -> Summary:
    """The summary of the stretch that the harness's call spans cover."""
    calls = [e for e in events if not e.device and e.name == CALL_SPAN]
    if not calls:
        return Summary(0, 0.0, 0.0, 0, 0)
    w0, w1 = min(e.start for e in calls), max(e.end for e in calls)
    threads = {e.thread for e in calls}
    host = [e for e in events if not e.device and e.thread in threads
            and e.end > w0 and e.start < w1]
    dev = [e for e in events if e.device and w0 <= e.start < w1]
    device_s: Dict[str, float] = collections.defaultdict(float)
    device_n: Dict[str, int] = collections.defaultdict(int)
    for e in dev:
        device_s[e.name] += (e.end - e.start) / 1e6
        device_n[e.name] += 1
    busy = _union((e.start, min(e.end, w1)) for e in dev)
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    return Summary(
        calls=len(calls), window_s=(w1 - w0) / 1e6,
        busy_s=sum(e - s for s, e in busy) / 1e6, launches=len(dev),
        syncs=sum(1 for e in host if "Synchronize" in e.name),
        device_s=dict(device_s), device_n=dict(device_n),
        gaps_s=_name_gaps(host, gaps))
