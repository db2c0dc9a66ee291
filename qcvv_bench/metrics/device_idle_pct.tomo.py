"""``device_idle_pct.tomo``: the share of the traced stretch of the tomography
cells, from the first call's start to the last call's end, in which no
operation (kernel, copy, set) ran on the card, from the profiler's device
timeline. One metric for each end-to-end metric that it moves
(``solves_per_s``)."""


def read(trace, sut):
    return trace.idle_pct()
