"""``ideal_circuits_per_s``: ideal quantum-volume model circuits simulated,
their heavy sets found and their shots tallied, the counts on the host,
over the whole window, per second. Apart from ``circuits_per_s`` because
this host-bound cell's runs spread some fifteen times wider than the
trajectory cell's, and one bound serves every cell of a metric."""


def read(run, sut):
    return run.rate()
