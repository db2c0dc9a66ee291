"""On-card tests of the port's CUDA kernels against their plain PyTorch
versions. They need an NVIDIA GPU and skip without one.

This file imports no JAX, so on a machine without JAX it runs without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from forest_benchmarking_tpu_torch.benchmarks import (
    inputs_from_numpy, process_tomo_A_matrix, synth_process_datasets)
from forest_benchmarking_tpu_torch.ops import lanes_apg

pytestmark = pytest.mark.cuda

SCHEDULES = {"headline": lanes_apg.HEADLINE_TUNED_2Q,
             "parity": lanes_apg.PARITY_TUNED_2Q}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def case(cuda):
    a = process_tomo_A_matrix(2)
    in32 = inputs_from_numpy(a, np.zeros((1, 1080)), device=cuda)
    in64 = inputs_from_numpy(a, np.zeros((1, 1080)), device=cuda,
                             dtype=torch.float64)
    gen = torch.Generator(device=cuda).manual_seed(7)
    n, _ = synth_process_datasets(gen, in32.a, 4, 64, 2000)
    return in32, in64, n


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_kernel_against_plain_version(case, schedule):
    """The kernel's max deviation from the plain f64 solve is at most twice
    the plain f32 solve's + 1e-5 (f32 round-off, reordered sums and the
    discontinuous restart rule make bitwise equality the wrong bar)."""
    in32, in64, n = case
    cfg = SCHEDULES[schedule]
    kern = lanes_apg.apg_fused(in32.a, n, 4, a_pinv=in32.a_pinv, **cfg)
    rho0 = lanes_apg.linear_inversion_start(in32.a_pinv, n, 4)
    plain32 = torch.complex(*lanes_apg.apg_fused_reference(
        in32.ar, in32.ai, n, *rho0, dim=4, **cfg))
    rho0 = lanes_apg.linear_inversion_start(in64.a_pinv, n.double(), 4)
    plain64 = torch.complex(*lanes_apg.apg_fused_reference(
        in64.ar, in64.ai, n.double(), *rho0, dim=4, **cfg))
    torch.cuda.synchronize()
    dev_k = (kern.to(plain64.dtype) - plain64).abs().max().item()
    dev_p = (plain32.to(plain64.dtype) - plain64).abs().max().item()
    assert dev_k <= 2 * dev_p + 1e-5
    pt = torch.diagonal(kern.reshape(-1, 4, 4, 4, 4), dim1=2, dim2=4).sum(-1)
    assert (pt - torch.eye(4, device=kern.device)).abs().max() < 1e-5


def test_launch_counter_counts_kernel_launches(case):
    in32, _, n = case
    before = lanes_apg.apg_fused.launches
    lanes_apg.apg_fused(in32.a, n, 4, a_pinv=in32.a_pinv,
                        **lanes_apg.HEADLINE_TUNED_2Q)
    torch.cuda.synchronize()
    assert lanes_apg.apg_fused.launches == before + 1


def test_wrapper_rejects_what_the_kernel_does_not_take(case, cuda):
    in32, in64, n = case
    a1 = torch.tensor(process_tomo_A_matrix(1), dtype=torch.complex64,
                      device=cuda)
    with pytest.raises(NotImplementedError, match="dim=4"):
        lanes_apg.apg_fused(a1, torch.full((2, 36), 1 / 18, device=cuda), 2)
    with pytest.raises(TypeError, match="float32"):
        lanes_apg.apg_fused(in64.a, n.double(), 4, a_pinv=in64.a_pinv,
                            **lanes_apg.HEADLINE_TUNED_2Q)
    with pytest.raises(ValueError, match="at most"):
        lanes_apg.apg_fused(in32.a, n, 4, phases=((1, 1, 1),) * 9)
