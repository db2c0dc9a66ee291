"""``traj_probs_roofline_pct``: the trajectory kernel's share of its
roofline.

The least time the card could take for the kernel's launches in the traced
stretch, over the device time the trace gives the kernel by name
(``traj_probs_kernel``, ``csrc/qv_traj.cu``). The least time of a launch is
the larger of the algorithm's operations over 67 TFLOP/s (float32 outside
the tensor cores) and its bytes over 3.35 TB/s, NVIDIA's H100 SXM figures
at 700 W:

- operations: a frozen copy of ``ops.pallas_traj.traj_flops_per_circuit``
  (the Kraus-unravelled trajectories; the heavy set's noiseless evolution
  runs in the ideal kernel, not in this one), times the circuits;
- bytes: the boundary index maps, the gates, the Kraus stack and the
  uniforms it reads, and the (C, 2^d, T) probabilities it writes, each
  once.
"""
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
KERNEL = "traj_probs_kernel"


def traj_flops_per_circuit(depth: int, n_kraus: int = 16,
                           num_trajectories: int = 1024,
                           noiseless: bool = False) -> float:
    d = float(2 ** depth)
    slots = depth // 2
    if noiseless:
        per_slot, renorm = 32 * d, 0.0
    else:
        per_slot = 16 * d + 2 * n_kraus * 16 + 3 * n_kraus + 32 * d
        renorm = 7 * d
    return num_trajectories * (depth * (slots * per_slot + renorm) + 4 * d)


def bytes_per_launch(circuits: int, depth: int, n_kraus: int,
                     trajectories: int) -> float:
    dim, slots = 2 ** depth, depth // 2
    return (4.0 * circuits * (depth + 1) * dim          # index maps, int32
            + 8.0 * 16 * circuits * depth * slots        # complex64 gates
            + 8.0 * 16 * n_kraus                         # Kraus stack
            + 4.0 * circuits * depth * slots * trajectories   # uniforms
            + 4.0 * circuits * dim * trajectories)       # probabilities


def bound_seconds(circuits: int, depth: int, n_kraus: int,
                  trajectories: int):
    """(least seconds of one launch, 'operations' or 'bytes')."""
    ops = traj_flops_per_circuit(depth, n_kraus, trajectories) * circuits \
        / PEAK_FLOPS
    mem = bytes_per_launch(circuits, depth, n_kraus, trajectories) / PEAK_BYTES
    return max(ops, mem), ("operations" if ops >= mem else "bytes")


def read(trace, sut):
    seconds, launches = trace.device_time(KERNEL)
    if not launches or seconds <= 0:
        return None
    least, _ = bound_seconds(sut.circuits, sut.depth,
                             sut.config["kraus_operators"], sut.trajectories)
    return 100.0 * least * launches / seconds
