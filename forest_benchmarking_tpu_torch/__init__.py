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

Importing the package builds nothing and imports no kernel toolchain: the
CUDA library is compiled on first use by :mod:`.kernels`.
"""
__version__ = "0.1.0"
