"""forest_benchmarking_tpu_torch: the PyTorch / CUDA port of forest_benchmarking_tpu.

The JAX package ``forest_benchmarking_tpu`` is the reference; this package
grows beside it slice by slice and keeps its public names, shapes and
conventions (column-stacking vec, first qubit = left-most tensor factor,
Choi matrices on H_in (x) H_out).

Slice 1 covers the batched two-qubit process-tomography MLE path:
``benchmarks.process_tomo_A_matrix`` -> ``benchmarks.synth_process_datasets``
-> ``tomography.pgdb_process_estimate_batched(method="apg",
cp_method="pallas")``, whose fused APG solve runs as a hand-written CUDA
kernel (``csrc/apg_fused.cu``) on NVIDIA Hopper and as its plain PyTorch
version on CPU tensors.

Slice 2 covers the batched quantum-volume path:
``quantum_volume.sample_heavy_outputs_batched`` and
``quantum_volume.measure_quantum_volume_batched``, whose ideal-probability
and Kraus-trajectory evolutions run as hand-written CUDA kernels
(``csrc/qv_traj.cu``) on the card and as their plain PyTorch versions on CPU
tensors; the exact density-matrix method is plain PyTorch.

Slice 3 covers the rest of batched process tomography at the array level:
every route of ``tomography.pgdb_process_estimate_batched`` (the
per-problem PGDB and APG solvers over ``ops.project_superoperators``, and
the fused solver at dim=2 as well as dim=4 on the card), and the
standalone Jacobi CP projection ``ops.pallas_eigh.cp_project_pallas``, a
hand-written CUDA kernel on the card.

Slice 9 covers BASELINE configs 1 and 3, plain PyTorch (the JAX package
runs both under XLA, with no Pallas kernel): batched state tomography,
``tomography.iterative_mle_state_estimate_batched`` (the one-qubit Bloch
update and the general diluted-MLE loop, with
``ops.project_state_matrix.project_state_matrix_to_physical`` for the warm
start), the batched Levenberg-Marquardt fitter ``analysis.fitting``, and
the numeric halves of ``randomized_benchmarking`` (survival statistics,
RB / unitarity / IRB analysis, the PTM-composition simulator) and
``qubit_spectroscopy`` (the T1, T2, Rabi and CZ-Ramsey fits). Functions
that take tensors run where their tensors lie; the entry points that take
numpy arrays or lists run on the card unless called with
``device="cpu"``.

Slice 10 covers BASELINE config 4, plain PyTorch (the JAX package runs it
under XLA, with no Pallas kernel): ``distance_measures`` (the state and
process measures, ``watrous_bounds`` and ``diamond_norm_distance`` with
its dense autograd route and, for dim <= 4 on the card, the fused route
``ops.lanes_dnorm``), the superoperator conversions of
``ops.superoperator_transformations``, the rest of ``ops.calculational``
and ``ops.random_operators``, ``proj_choi_to_unitary``, and
``ops.apply_superoperator``, ``ops.compose_superoperators``,
``ops.channel_approximation``, ``ops.validate_operator`` and
``ops.validate_superoperator``.

The package imports neither JAX nor the JAX package: it keeps its own
copies of the host helpers it needs. The quantum-volume entry points run on
the card unless the caller passes ``device="cpu"``; the process-tomography
entry point runs where its input tensors lie.

Importing the package builds nothing and imports no kernel toolchain: the
CUDA library is compiled on first use by :mod:`.kernels`.
"""
__version__ = "0.1.0"
