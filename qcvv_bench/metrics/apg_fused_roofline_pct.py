"""``apg_fused_roofline_pct``: the fused APG kernel's share of its roofline.

The least time the card could take for the kernel's launches in the traced
stretch, over the device time the trace gives the kernel by name
(``apg_fused_kernel``, the dim = 4 kernel of ``csrc/apg_fused.cu``). The
least time of a launch is the larger of the algorithm's operations over
67 TFLOP/s (float32 outside the tensor cores) and its bytes over
3.35 TB/s, NVIDIA's H100 SXM figures at 700 W:

- operations: a frozen copy of ``bench.fused_apg_flops_per_solve`` (the
  JAX package's count: two real R x n^2 mat-vecs a step), at the
  configuration's schedule, times the batch;
- bytes: A (two float32 planes), the counts, the two start planes and the
  two estimate planes, each once.
"""
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
KERNEL = "apg_fused_kernel"
SCHEDULES = {"headline": dict(phases=((5, 1, 1),), init_iters=2,
                              init_sweeps=3, final_iters=2, final_sweeps=1)}


def fused_apg_flops_per_solve(phases, init_iters=8, init_sweeps=3,
                              final_iters=20, final_sweeps=1, dim=4,
                              a_rows=1080) -> float:
    n = dim * dim
    per_sweep = 36.0 * n * n * (n - 1)

    def per_dyk(s):
        return 2 * n * n + 16.0 * n ** 3 + s * per_sweep + 8.0 * n ** 3 \
            + 4 * n * n

    per_outer = 2 * (2.0 * a_rows * n * n) + 2 * a_rows + 10 * n * n
    total = init_iters * per_dyk(init_sweeps) \
        + final_iters * per_dyk(final_sweeps)
    for phase in phases:
        outer, ld, s = phase[:3]
        srest = phase[3] if len(phase) == 4 else s
        total += outer * (per_outer + per_dyk(s) + (ld - 1) * per_dyk(srest))
    return total


def bytes_per_launch(batch: int, dim: int = 4, a_rows: int = 1080) -> float:
    n2 = dim ** 4
    return 4.0 * (2 * a_rows * n2 + batch * a_rows + 4 * batch * n2)


def bound_seconds(batch: int, schedule: str, dim: int = 4,
                  a_rows: int = 1080):
    """(least seconds of one launch, 'operations' or 'bytes')."""
    ops = fused_apg_flops_per_solve(**SCHEDULES[schedule], dim=dim,
                                    a_rows=a_rows) * batch / PEAK_FLOPS
    mem = bytes_per_launch(batch, dim, a_rows) / PEAK_BYTES
    return max(ops, mem), ("operations" if ops >= mem else "bytes")


def read(trace, sut):
    seconds, launches = trace.device_time(KERNEL)
    if not launches or seconds <= 0:
        return None
    cfg = sut.config
    least, _ = bound_seconds(sut.work_per_call, cfg["fused_schedule"],
                             cfg["dim"], cfg["a_rows"])
    return 100.0 * least * launches / seconds
