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

Slice 11 covers the tomography protocol end to end, plain PyTorch: the
experiment data model (``circuits``, ``paulis``, ``compilation``,
``observable_estimation`` and the rest of ``utils``), the simulator
``sim`` (statevector and density-matrix evolution with Kraus noise, T1/T2
at DELAY and readout confusion; the structure-keyed executor; the ``QVM``
with exhaustive and orthogonal-array readout symmetrization, all flip
patterns in one batched call) and ``tomography.do_tomography`` with the
results-level estimators. ``QVM()`` runs on the card; pass
``QVM(device="cpu")`` without one. ``do_tomography(qc, ...)`` and
``estimate_observables(qc, ...)`` run where ``qc`` runs; the results-level
estimators take ``device`` (the card by default). The optional packages
``networkx`` (clique-removal grouping), ``pandas`` (``metadata_save``) and
``tqdm`` (progress bars) are imported only where they are used; the
default greedy grouping needs none of them.

Slice 12 covers the protocols that run on the Clifford engine, plain
PyTorch: ``clifford`` (tableaus, the enumerated one- and two-qubit groups,
RB sequences, synthesis for three qubits and more), the circuit halves of
``randomized_benchmarking`` (RB, interleaved RB and unitarity experiments,
``do_rb``, ``sequences_to_ptm_stack``) and ``qubit_spectroscopy`` (the
T1, T2, Rabi and CZ-Ramsey generators, ``do_t1_or_t2``), and
``direct_fidelity_estimation`` (``do_dfe``), ``robust_phase_estimation``
(``do_rpe``) and ``readout``. Sequences and Monte Carlo settings come from
numpy ``RandomState`` draws, as in the JAX package; the protocols run
where ``qc`` runs, and their fits on ``qc.device``.

Slice 13 covers the rest of the protocols and the sharded entry points:
``entangled_states`` (GHZ trees, graph states) and ``classical_logic``
(the ripple-carry adder and its primitives), which take edge lists or any
graph object with ``nodes`` and ``edges`` through the port's own graph
type ``_graph._Graph`` (in ``networkx``'s orders; the package does not
import ``networkx``); the per-circuit half of ``quantum_volume``
(``measure_quantum_volume`` on the QVM, numpy ``RandomState`` circuits as
in the JAX package, the SWAP router); and ``parallel`` with
``ops.lanes_apg.apg_fused_sharded``, ``ops.lanes_dnorm.dnorm_fused_sharded``
and ``quantum_volume.sample_heavy_outputs_sharded``: one process splits the
batch over a mesh of devices (``parallel.make_mesh``, every card by
default; a list such as ``[cpu] * 8`` otherwise), runs each shard on its
device, and concatenates the results on the first one, bitwise those of the
unsharded call where the solve is elementwise in the batch.

Slice 14 covers the presentation layer: ``plotting`` (Hinton diagrams and
the Pauli-basis plots) and ``analysis.fitting.plot_figure_for_fit``, which
import matplotlib only when they draw (a drawing call without it raises
ImportError), and ``ops.lanes_apg.apg_fused_lanes``, the JAX package's
lanes-layout entry point. The scripts of ``examples_torch/`` run the
JAX package's examples on the port.

The package imports neither JAX nor the JAX package: it keeps its own
copies of the host helpers it needs. The quantum-volume entry points run on
the card unless the caller passes ``device="cpu"``; the process-tomography
entry point runs where its input tensors lie.

Importing the package builds nothing and imports no kernel toolchain: the
CUDA library is compiled on first use by :mod:`.kernels`.
"""
__version__ = "0.1.0"
