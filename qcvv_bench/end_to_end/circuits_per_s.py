"""``circuits_per_s``: noisy quantum-volume model circuits simulated by
Kraus trajectories and tallied, their counts on the host, over the whole
window, per second."""


def read(run, sut):
    return run.rate()
