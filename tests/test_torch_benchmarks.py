"""Port benchmark builders: the A-matrix, the raster order, the carry-across
from numpy, and the synthetic count data."""
import numpy as np
import pytest
import torch

from forest_benchmarking_tpu import benchmarks as jax_benchmarks
from forest_benchmarking_tpu_torch.benchmarks import (
    inputs_from_numpy, join_complex, process_tomo_A_matrix, split_complex,
    synth_process_datasets)
from forest_benchmarking_tpu_torch.ops.lanes_apg import raster_a_matrix
from forest_benchmarking_tpu_torch.ops.superoperator_transformations import vec

torch.set_num_threads(1)


@pytest.mark.parametrize("n_qubits", [1, 2])
def test_a_matrix_equals_jax(n_qubits):
    got = process_tomo_A_matrix(n_qubits)
    want = jax_benchmarks.process_tomo_A_matrix(n_qubits)
    assert got.shape == want.shape == {1: (36, 16), 2: (1080, 256)}[n_qubits]
    np.testing.assert_array_equal(got, want)


def test_raster_a_matrix_reorders_vec():
    a = torch.tensor(process_tomo_A_matrix(1))
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4)))
    want = a @ vec(x)[:, 0]
    got = raster_a_matrix(a, 4) @ x.reshape(-1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_inputs_from_numpy_round_trip(dtype):
    a = process_tomo_A_matrix(2)
    n = np.random.default_rng(1).random((3, a.shape[0]))
    inp = inputs_from_numpy(a, n, device="cpu", dtype=dtype)
    atol = 1e-6 if dtype == torch.float32 else 0.0
    assert inp.n.dtype == dtype and inp.ar.dtype == dtype
    np.testing.assert_allclose(inp.n.numpy(), n, atol=atol)
    np.testing.assert_allclose(inp.a.numpy(), a, atol=atol)
    # the raster planes undo to the vec-order A
    planes = torch.complex(inp.ar, inp.ai).reshape(-1, 16, 16).transpose(1, 2)
    np.testing.assert_allclose(planes.reshape(a.shape).numpy(), a, atol=atol)
    # pinv from the host in f64
    np.testing.assert_allclose(inp.a_pinv.numpy(), np.linalg.pinv(a),
                               atol=10 * atol)
    eye = (inp.a_pinv.to(torch.complex128) @ torch.tensor(a)).numpy()
    np.testing.assert_allclose(eye, np.eye(256), atol=1e-12 + 10 * atol)


def test_split_join_complex_round_trip():
    x = torch.randn(3, 4, dtype=torch.complex128)
    s = split_complex(x)
    assert s.shape == (2, 3, 4) and s.dtype == torch.float64
    assert torch.equal(join_complex(s), x)


def test_synth_counts_normalized_and_binomial():
    a = torch.tensor(process_tomo_A_matrix(2))
    shots, batch = 2000, 16
    n, chois = synth_process_datasets(torch.Generator().manual_seed(11), a, 4,
                                      batch, shots, dtype=torch.float64)
    assert n.shape == (batch, 1080) and chois.shape == (batch, 16, 16)
    # each problem's normalized counts sum to one
    np.testing.assert_allclose(n.sum(1).numpy(), 1.0, atol=1e-12)
    # observed '+' frequencies k/shots against the Bernoulli probabilities of
    # the true channels: the mean of the B*540 residuals has standard
    # deviation sqrt(mean(q(1-q)) / (shots B 540)); hold it to 5 of those
    p = (vec(chois)[..., 0] @ a.T).real.clamp(0.0, 1.0)
    q = p[:, 0::2] / (p[:, 0::2] + p[:, 1::2])
    freq = n[:, 0::2] * (shots * 540) / shots
    sigma = np.sqrt((q * (1 - q)).mean().item() / (shots * q.numel()))
    assert abs((freq - q).mean().item()) < 5 * sigma
    # per-setting spread matches the binomial variance within 10%
    ratio = ((freq - q) ** 2).mean().item() / ((q * (1 - q)).mean().item() / shots)
    assert 0.9 < ratio < 1.1
