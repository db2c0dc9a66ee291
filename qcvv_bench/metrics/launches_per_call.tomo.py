"""``launches_per_call.tomo``: device operations (kernels, copies, sets)
that the profiler recorded in the traced stretch of the tomography
cells, over its calls: the host's dispatch work a call. One metric for
each end-to-end metric that it moves (``solves_per_s``)."""


def read(trace, sut):
    return trace.launches_per_call()
