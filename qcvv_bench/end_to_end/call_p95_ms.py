"""``call_p95_ms``: the 95th percentile (nearest rank) of every call of
the window, from the call into the entry point to its outputs on the host,
by the host's clock, in milliseconds: how long a waiting caller stalls."""
import math


def read(run, sut):
    s = sorted(run.window.seconds)
    return 1e3 * s[math.ceil(0.95 * len(s)) - 1]
