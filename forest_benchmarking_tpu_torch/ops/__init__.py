"""Batched operator tools on torch tensors: every module of the JAX
package's ``ops/``, with its ``*_sharded`` entry points.

The package re-exports the same ten modules as the JAX package's
``ops/__init__.py``; importing it builds no kernel and imports no kernel
toolchain.
"""
from forest_benchmarking_tpu_torch.ops.apply_superoperator import *  # noqa: F401,F403
from forest_benchmarking_tpu_torch.ops.calculational import *  # noqa: F401,F403
from forest_benchmarking_tpu_torch.ops.channel_approximation import *  # noqa: F401,F403
from forest_benchmarking_tpu_torch.ops.compose_superoperators import *  # noqa: F401,F403
from forest_benchmarking_tpu_torch.ops.project_state_matrix import *  # noqa: F401,F403
from forest_benchmarking_tpu_torch.ops.project_superoperators import *  # noqa: F401,F403
from forest_benchmarking_tpu_torch.ops.random_operators import *  # noqa: F401,F403
from forest_benchmarking_tpu_torch.ops.superoperator_transformations import *  # noqa: F401,F403
from forest_benchmarking_tpu_torch.ops.validate_operator import *  # noqa: F401,F403
from forest_benchmarking_tpu_torch.ops.validate_superoperator import *  # noqa: F401,F403
