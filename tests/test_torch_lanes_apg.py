"""The port's fused APG solver (plain PyTorch version) against the JAX
package's ``ops/lanes_apg.py`` and the numpy oracles, in float64.

The headline-schedule comparison lives here and the parity-schedule one in
test_torch_slice.py, so that their JAX CPU compiles run on different
workers.
"""
import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from forest_benchmarking_tpu.benchmarks import synth_process_datasets
from forest_benchmarking_tpu.ops import lanes_apg as jax_lanes
from forest_benchmarking_tpu_torch import kernels
from forest_benchmarking_tpu_torch.benchmarks import (
    inputs_from_numpy, process_tomo_A_matrix)
from forest_benchmarking_tpu_torch.ops import lanes_apg
from oracles import np_proj_cp, np_proj_tp

torch.set_num_threads(1)

EPS64 = 1e-30


def _rand_herm_batch(rng, n, b):
    x = rng.standard_normal((b, n, n)) + 1j * rng.standard_normal((b, n, n))
    return (x + x.conj().transpose(0, 2, 1)) / 2


def _planes(x):
    return torch.tensor(np.real(x)), torch.tensor(np.imag(x))


def _join(xr, xi):
    return xr.numpy() + 1j * xi.numpy()


def _eye_planes(n, b):
    eye = torch.eye(n, dtype=torch.float64).expand(b, n, n)
    return eye, torch.zeros_like(eye)


@pytest.fixture(scope="module")
def headline_case():
    """B = 8 problems at 2000 shots, solved once by the JAX package."""
    a = process_tomo_A_matrix(2)
    n, _ = synth_process_datasets(jax.random.PRNGKey(21), jnp.asarray(a), 4, 8,
                                  2000, dtype=jnp.float64)
    want = np.asarray(jax_lanes.apg_fused(jnp.asarray(a), n, dim=4,
                                          use_pallas=False,
                                          **jax_lanes.HEADLINE_TUNED_2Q))
    return a, np.asarray(n), want


def test_proj_tp_matches_oracle():
    x = np.random.default_rng(0).standard_normal((3, 16, 16, 2)) @ [1, 1j]
    out = _join(*lanes_apg._proj_tp(*_planes(x), 4))
    want = np.stack([np_proj_tp(x[i]) for i in range(3)])
    np.testing.assert_allclose(out, want, atol=1e-12)


def test_warm_cp_cold_matches_eigh_positive_part():
    h = _rand_herm_batch(np.random.default_rng(1), 16, 3)
    pos_r, pos_i, _, _ = lanes_apg._warm_cp(*_planes(h), *_eye_planes(16, 3),
                                            10, EPS64)
    want = np.stack([np_proj_cp(h[i]) for i in range(3)])
    np.testing.assert_allclose(_join(pos_r, pos_i), want, atol=1e-10)


def test_warm_cp_warm_basis_single_sweep():
    """A 1-sweep projection from the previous eigenbasis matches the exact
    positive part on a nearby matrix (the in-Dykstra warm-V regime)."""
    rng = np.random.default_rng(2)
    h = _rand_herm_batch(rng, 16, 2)
    eye = _eye_planes(16, 2)
    _, _, vr, vi = lanes_apg._warm_cp(*_planes(h), *eye, 10, EPS64)
    h2 = h + 1e-3 * _rand_herm_batch(rng, 16, 2)
    want = np.stack([np_proj_cp(h2[i]) for i in range(2)])
    pos = lanes_apg._warm_cp(*_planes(h2), vr, vi, 1, EPS64)[:2]
    warm_err = np.max(np.abs(_join(*pos) - want))
    cold = lanes_apg._warm_cp(*_planes(h2), *eye, 1, EPS64)[:2]
    cold_err = np.max(np.abs(_join(*cold) - want))
    assert warm_err < 1e-4
    assert warm_err < cold_err / 100


def test_rotation_coeffs_match_jax():
    rng = np.random.default_rng(3)
    apq_r, apq_i, app, aqq = rng.standard_normal((4, 64))
    apq_r[:4] = apq_i[:4] = 0.0          # the small-|apq| branch
    app[4:8] = aqq[4:8]                  # the tau == 0 branch
    got = lanes_apg._rotation_coeffs(*map(torch.tensor, (apq_r, apq_i, app,
                                                         aqq)), EPS64)
    want = jax_lanes._rotation_coeffs(*map(jnp.asarray, (apq_r, apq_i, app,
                                                         aqq)),
                                      jnp.asarray(EPS64))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-15)


@pytest.mark.parametrize("sweeps", [1, 3])
def test_multi_sweep_matches_jax(sweeps):
    """Same round order, rotations and V-carry as the JAX pair-layout sweep."""
    rng = np.random.default_rng(4)
    h = _rand_herm_batch(rng, 16, 3)
    v = np.linalg.qr(rng.standard_normal((3, 16, 16))
                     + 1j * rng.standard_normal((3, 16, 16)))[0]
    got = lanes_apg._multi_sweep(*_planes(h), *_planes(v), EPS64, sweeps)
    lanes = lambda x: jnp.asarray(np.moveaxis(x, 0, -1))
    want = jax_lanes._multi_sweep(lanes(h.real), lanes(h.imag), lanes(v.real),
                                  lanes(v.imag), jnp.asarray(EPS64), 16, sweeps)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.moveaxis(np.asarray(w), -1, 0),
                                   atol=1e-13)


def test_apg_fused_headline_matches_jax(headline_case):
    """Plain port vs JAX ``apg_fused(use_pallas=False)`` in f64 on the same
    counts. Same op order; only BLAS summation order differs, so the bar is
    f64 round-off grown through the solve (<= 1e-9)."""
    a, n, want = headline_case
    inp = inputs_from_numpy(a, n, device="cpu", dtype=torch.float64)
    got = lanes_apg.apg_fused(inp.a, inp.n, 4, **lanes_apg.HEADLINE_TUNED_2Q)
    assert got.dtype == torch.complex128 and got.shape == (8, 16, 16)
    assert np.max(np.abs(got.numpy() - want)) <= 1e-9
    # the given pinv(A) (host f64) takes the same path
    got2 = lanes_apg.apg_fused(inp.a, inp.n, 4, a_pinv=inp.a_pinv,
                               **lanes_apg.HEADLINE_TUNED_2Q)
    assert np.max(np.abs(got2.numpy() - want)) <= 1e-9


def test_schedule_forms_not_carried_raise():
    a = torch.tensor(process_tomo_A_matrix(1))
    n = torch.full((1, 36), 1 / 36, dtype=torch.float64)
    with pytest.raises(ValueError, match="sweeps_rest"):
        lanes_apg.apg_fused(a, n, 2, phases=((2, 1, 1, 0),))
    with pytest.raises(ValueError, match="final_sweeps_rest"):
        lanes_apg.apg_fused(a, n, 2, final_sweeps_rest=0)
    z = torch.zeros(1, 4, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="sweeps_rest"):
        lanes_apg.apg_fused_reference(a.real, a.imag, n, z, z, dim=2,
                                      phases=((2, 1, 1, 0),))


def test_cuda_source_tables_match_python():
    """The kernel's round-robin pair table and schedule width equal the
    Python side's (the kernel runs only on the card; its source can be read
    anywhere)."""
    src = (kernels.CSRC / "apg_fused.cu").read_text()
    body = src.split("c_pairs[NROUNDS][NPAIRS][2] = {", 1)[1].split("};", 1)[0]
    pairs = [tuple(map(int, m)) for m in re.findall(r"\{(\d+), (\d+)\}", body)]
    want = [p for rnd in lanes_apg._round_robin_pairs(16) for p in rnd]
    assert pairs == want
    width = int(re.search(r"#define APG_MAX_PHASES (\d+)", src).group(1))
    assert width == kernels.MAX_PHASES
    fields = [f[0] for f in kernels.ApgSchedule._fields_]
    struct = src.split("struct ApgSchedule {", 1)[1].split("};", 1)[0]
    assert re.findall(r"(\w+)(?:\[APG_MAX_PHASES\])?[,;]", struct) == fields
