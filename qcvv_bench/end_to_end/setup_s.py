"""``setup_s``: seconds from the start of ``run.py`` to the first timed call
(imports, CUDA context, the kernels' build or load, inputs, warm-up)."""


def read(run, sut):
    return run.setup_s
