"""Named spans inside the port's hot entry points, on the profiler's clock.

A span is a ``torch.profiler.record_function`` range, so it is a host event
of the same profiler that records the device operations: the two share one
clock, and each device operation can be tied to the span that launched it
through the profiler's correlation ids. There is no switch: the spans are
recorded exactly while a ``torch.profiler`` records, and cost one check of
the profiler's state otherwise::

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        tomography.pgdb_process_estimate_batched(a, n, dim=4, method="apg",
                                                 cp_method="pallas")
    prof.export_chrome_trace("trace.json")    # the fbt.* ranges

Spans nest on the caller's thread; the names below are ``fbt.<entry>`` for
the whole call and ``fbt.<entry>.<step>`` for its steps.
"""
from __future__ import annotations

import contextlib

import torch

PREFIX = "fbt."

# ops/lanes_apg.apg_fused (the fused route of
# tomography.pgdb_process_estimate_batched)
APG_FUSED = "fbt.apg_fused"
APG_RASTER = "fbt.apg_fused.raster"          # raster_a_matrix, real/imag planes
APG_PINV = "fbt.apg_fused.pinv"              # pinv(A): cached, computed or given
APG_WARM_START = "fbt.apg_fused.warm_start"  # linear_inversion_start
APG_KERNEL = "fbt.apg_fused.kernel"          # A^T and the solve
APG_ASSEMBLE = "fbt.apg_fused.assemble"      # the complex estimates

# quantum_volume.sample_heavy_outputs_batched
QV_SAMPLE_HEAVY = "fbt.qv.sample_heavy"
QV_DRAWS = "fbt.qv.draws"                    # permutations, Haar gates
QV_IDEAL = "fbt.qv.ideal"                    # ideal distributions
QV_HEAVY_SETS = "fbt.qv.heavy_sets"
QV_TRAJECTORIES = "fbt.qv.trajectories"      # uniforms, trajectory kernel
QV_SHOTS = "fbt.qv.shots"                    # multinomial, gather, sum

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a ``torch.profiler`` records,
    else one shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
