"""The port's Jacobi CP projection (plain version, CPU) against the JAX
package's ``ops/pallas_eigh.py`` and the exact eigh projection, mirroring
tests/test_pallas_eigh.py."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from forest_benchmarking_tpu.ops import pallas_eigh as jax_eigh
from forest_benchmarking_tpu_torch.ops import pallas_eigh
from forest_benchmarking_tpu_torch.ops.project_superoperators import (
    proj_choi_to_completely_positive)
from oracles import np_proj_cp

torch.set_num_threads(1)


def _herm_batch(seed, b, dtype=np.complex128):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, 16, 16) + 1j * rng.randn(b, 16, 16)
    return ((x + x.conj().transpose(0, 2, 1)) / 2).astype(dtype)


def test_round_robin_covers_all_pairs():
    rounds = pallas_eigh.round_robin_pairs(16)
    assert rounds == jax_eigh.round_robin_pairs(16)
    assert len(rounds) == 15
    seen = set()
    for pairs in rounds:
        assert len(pairs) == 8
        flat = [q for pr in pairs for q in pr]
        assert len(set(flat)) == 16
        seen.update(pairs)
    assert len(seen) == 16 * 15 // 2


def test_plain_version_matches_jax():
    """Same sweeps, rotations and reconstruction order as JAX's
    ``cp_project_pallas(use_pallas=False)``; 2 sweeps (the JAX CPU compile
    grows with the sweeps, which it unrolls), a non-Hermitian input too,
    since neither package hermitianizes."""
    h = _herm_batch(3, 4)
    h[3] += 0.1j * np.eye(16)[::-1]
    want = np.asarray(jax_eigh.cp_project_pallas(jnp.asarray(h), sweeps=2,
                                                 use_pallas=False))
    got = pallas_eigh.cp_project_pallas(torch.tensor(h), sweeps=2)
    assert got.dtype == torch.complex128 and got.shape == (4, 16, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12)


def test_use_pallas_keyword_changes_nothing_on_the_cpu():
    """``use_pallas`` is accepted; on a CPU tensor both settings run the
    plain version, bitwise alike, and launch nothing."""
    h = torch.tensor(_herm_batch(5, 3))
    before = pallas_eigh.cp_project_pallas.launches
    on = pallas_eigh.cp_project_pallas(h, sweeps=3, use_pallas=True)
    off = pallas_eigh.cp_project_pallas(h, sweeps=3, use_pallas=False)
    assert torch.equal(on, off)
    assert torch.equal(on, pallas_eigh.cp_project_reference(h, 3))
    assert pallas_eigh.cp_project_pallas.launches == before == 0


def test_jacobi_pos_part_matches_eigh():
    rng = np.random.RandomState(0)
    for _ in range(5):
        b = rng.randn(16, 16) + 1j * rng.randn(16, 16)
        h = (b + b.conj().T) / 2
        ours = pallas_eigh.jacobi_eigh_reference(h, sweeps=8)
        assert np.max(np.abs(ours - np_proj_cp(h))) < 1e-10


def test_cp_project_batched_matches_eigh():
    h = torch.tensor(_herm_batch(1, 8))
    ours = pallas_eigh.cp_project_pallas(h, sweeps=8)
    exact = proj_choi_to_completely_positive(h)
    assert (ours - exact).abs().max().item() < 1e-10


def test_cp_project_f32_quality():
    h = _herm_batch(2, 8, np.complex64)
    ours = pallas_eigh.cp_project_pallas(torch.tensor(h), sweeps=6)
    assert ours.dtype == torch.complex64
    exact = proj_choi_to_completely_positive(
        torch.tensor(h.astype(np.complex128)))
    assert (ours.to(torch.complex128) - exact).abs().max().item() < 1e-4


def test_cpu_wrapper_runs_plain_version_and_checks_shape():
    h = torch.tensor(_herm_batch(4, 2))
    before = pallas_eigh.cp_project_pallas.launches
    out = pallas_eigh.cp_project_pallas(h)
    assert pallas_eigh.cp_project_pallas.launches == before == 0
    torch.testing.assert_close(out, pallas_eigh.cp_project_reference(h, 6),
                               rtol=0, atol=0)
    for bad in (h[0], h[:, :8, :8]):
        with pytest.raises(ValueError, match="shape"):
            pallas_eigh.cp_project_pallas(bad)


def test_flop_count():
    """6 sweeps of 15 rounds of ~36 n^2 rotation work plus the 8 n^3
    reconstruction, n = 16."""
    assert pallas_eigh.cp_project_flops(6) == 6 * 15 * 36 * 256 + 8 * 4096


def test_jax_ordered_calls_give_the_keyword_result():
    """``block`` sits at the JAX package's position (``cp_project_pallas(h,
    sweeps, block, use_pallas)``) and changes nothing."""
    h = torch.tensor(_herm_batch(6, 3))
    want = pallas_eigh.cp_project_pallas(h, sweeps=2)
    assert torch.equal(pallas_eigh.cp_project_pallas(h, 2, 64, True), want)
    assert torch.equal(pallas_eigh.cp_project_pallas(
        h, sweeps=2, block=256, use_pallas=True), want)
