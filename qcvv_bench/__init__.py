"""The benchmark of ``forest_benchmarking_tpu_torch`` on NVIDIA GPUs.

One run of one cell: ``python qcvv_bench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout (see
:mod:`qcvv_bench.harness`). Everything that belongs to one configuration,
one traffic mix or one metric sits in a file of its own, found by name:
``configs/<config>.json`` and ``.py``, ``reference/<config>.py``,
``workloads/<cell>.json``, ``end_to_end/<metric>.py`` and
``metrics/<metric>.py``.
"""
