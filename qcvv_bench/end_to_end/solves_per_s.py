"""``solves_per_s``: tomography estimates delivered to the host over the
whole window, per second."""


def read(run, sut):
    return run.rate()
