"""Batched state tomography: the port's diluted MLE (both routes), the
waterfilling projection and the Bloch helpers against the JAX package on the
same numpy inputs, in float64 on the CPU.

Bars: 1e-10 where the order of operations matches (the waterfilling, the
Bloch update, the Bloch helpers); 1e-9 for the general diluted-MLE loop,
whose per-problem iteration counts must equal the JAX loop's; the JAX
suite's own bars for the properties it checks (the Bloch route against the
general one 1e-12, against the numpy oracle 1e-7, warm against cold start
1e-3 / 1e-4, fidelities).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from forest_benchmarking_tpu import tomography as jax_tomo
from forest_benchmarking_tpu.ops.project_state_matrix import (
    project_state_matrix_to_physical as jax_project)
from forest_benchmarking_tpu_torch import tomography
from forest_benchmarking_tpu_torch.ops.project_state_matrix import (
    project_state_matrix_to_physical)
from forest_benchmarking_tpu_torch.utils import pauli_basis_matrices
from oracles import np_mle_state

torch.set_num_threads(1)

MATCHED = 1e-10   # the same order of operations
GENERAL = 1e-9    # the general loop, thousands of steps


def _shot_expectations(rng, batch, n_qubits, shots):
    """Haar pure states and their binomially sampled Pauli expectations:
    (observables, (B, S) expectations, (B,) shot totals, (B, d) states)."""
    obs = pauli_basis_matrices(n_qubits)[1:]
    d = 2 ** n_qubits
    psi = rng.randn(batch, d) + 1j * rng.randn(batch, d)
    psi /= np.linalg.norm(psi, axis=1, keepdims=True)
    rho = psi[:, :, None] * psi[:, None, :].conj()
    exact = np.real(np.einsum("sij,bji->bs", obs, rho))
    e = 2 * rng.binomial(shots, (1 + exact) / 2) / shots - 1
    return obs, e, np.full((batch,), len(obs) * float(shots)), psi


def _fidelity(psi, rho):
    return np.real(np.einsum("bi,bij,bj->b", psi.conj(), rho, psi))


def _port(obs, e, nm, **kw):
    return tomography.iterative_mle_state_estimate_batched(
        obs, e, nm, device="cpu", **kw).numpy()


def _jax(obs, e, nm, **kw):
    return np.asarray(jax_tomo.iterative_mle_state_estimate_batched(
        jnp.asarray(obs), jnp.asarray(e), jnp.asarray(nm), **kw))


def _general(obs, e, nm, epsilon=0.1, entropy_penalty=0.0, beta=0.0,
             tol=1e-9, maxiter=10_000, warm_start=False):
    """The port's general loop: ((B, d, d) estimates, (B,) iterations)."""
    rho, its = tomography._mle_general_batched(
        torch.tensor(obs), torch.tensor(e), torch.tensor(nm), epsilon,
        entropy_penalty, beta, tol, maxiter, warm_start)
    return rho.numpy(), its.numpy()


class _CountingLax:
    """``jax.lax`` whose ``while_loop`` also hands its final carry to
    ``out``: traced in place of the JAX module's ``lax``, it exposes the
    step counter of ``_mle_kernel``'s loop."""

    def __init__(self, out):
        self.out = out

    def __getattr__(self, name):
        return getattr(jax.lax, name)

    def while_loop(self, cond, body, init):
        carry = jax.lax.while_loop(cond, body, init)
        self.out.append(carry)
        return carry


def _jax_iterations(monkeypatch, obs, e, nm, epsilon=0.1,
                    entropy_penalty=0.0, beta=0.0, tol=1e-9,
                    maxiter=10_000, warm_start=False):
    """(B,) steps of the JAX package's per-problem loop on these inputs."""
    def count(ee, n):
        carries = []
        monkeypatch.setattr(jax_tomo, "lax", _CountingLax(carries))
        jax_tomo._mle_kernel(jnp.asarray(obs), ee, n, epsilon,
                             entropy_penalty, beta, tol, maxiter,
                             warm_start=warm_start)
        monkeypatch.setattr(jax_tomo, "lax", jax.lax)
        return carries[0][2]

    return np.asarray(jax.jit(jax.vmap(count))(jnp.asarray(e),
                                               jnp.asarray(nm)))


def _hold_general_against_jax(monkeypatch, obs, e, nm, **kw):
    """The port's general loop against the JAX package's per-problem loop:
    within 1e-9, and each problem stops after as many steps as in JAX."""
    ours, its = _general(obs, e, nm, **kw)
    full = _jax(obs, e, nm, method="general", **kw)
    assert np.max(np.abs(ours - full)) < GENERAL
    assert np.array_equal(its, _jax_iterations(monkeypatch, obs, e, nm, **kw))
    return ours, its


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 4, 8])
def test_waterfilling_equals_jax(d):
    rng = np.random.RandomState(d)
    x = rng.randn(32, d, d) + 1j * rng.randn(32, d, d)
    h = (x + x.conj().transpose(0, 2, 1)) / 2 + np.eye(d)
    want = np.asarray(jax_project(jnp.asarray(h)))
    got = project_state_matrix_to_physical(torch.tensor(h)).numpy()
    assert np.max(np.abs(got - want)) < MATCHED
    w = np.linalg.eigvalsh(got)
    assert w.min() > -1e-12
    assert np.allclose(np.trace(got, axis1=1, axis2=2), 1.0, atol=1e-12)


def test_mle_matches_numpy_oracle(monkeypatch):
    """A 2Q state (RY(0.4) on qubit 0, then CNOT), 2000 shots per Pauli:
    the general loop against the numpy oracle (1e-8) and JAX."""
    ry = np.array([[np.cos(0.2), -np.sin(0.2)], [np.sin(0.2), np.cos(0.2)]])
    cnot = np.eye(4)[[0, 1, 3, 2]]
    psi = cnot @ np.kron(ry, np.eye(2)) @ np.array([1.0, 0, 0, 0])
    obs = pauli_basis_matrices(2)[1:]
    exact = np.real(np.einsum("sij,j,i->s", obs, psi, psi.conj()))
    rng = np.random.RandomState(3)
    e = (2 * rng.binomial(2000, (1 + exact) / 2) / 2000 - 1)[None]
    ours, _ = _hold_general_against_jax(monkeypatch, obs, e,
                                        np.array([15 * 2000.0]))
    oracle = np_mle_state(obs, e[0], epsilon=0.1, tol=1e-9)
    assert np.max(np.abs(ours[0] - oracle)) < 1e-8


@pytest.mark.parametrize("variant", [
    dict(entropy_penalty=0.005),
    dict(beta=0.5, epsilon=0.0001, tol=1e-7)])
def test_mle_maxent_and_hedged_variants(variant, monkeypatch):
    """RY(1.1)|0>, 4000 shots per Pauli: the MaxEnt and hedged loops match
    JAX, keep trace 1 and stay close to the truth."""
    psi = np.array([[np.cos(0.55), np.sin(0.55)]])
    obs = pauli_basis_matrices(1)[1:]
    exact = np.real(np.einsum("sij,bj,bi->bs", obs, psi, psi.conj()))
    rng = np.random.RandomState(5)
    e = 2 * rng.binomial(4000, (1 + exact) / 2) / 4000 - 1
    rho, _ = _hold_general_against_jax(monkeypatch, obs, e,
                                       np.array([3 * 4000.0]), **variant)
    assert np.isclose(np.trace(rho[0]).real, 1.0, atol=1e-8)
    assert _fidelity(psi, rho)[0] > 0.9


def test_mle_batched_matches_single():
    rng = np.random.RandomState(6)
    obs, e, nm, _ = _shot_expectations(rng, 4, 1, 2000)
    batched = _port(obs, e, nm)
    singles = np.concatenate([_port(obs, e[i:i + 1], nm[i:i + 1])
                              for i in range(4)])
    assert np.max(np.abs(batched - singles)) < MATCHED
    assert np.max(np.abs(batched - _jax(obs, e, nm))) < MATCHED


@pytest.mark.parametrize("warm_start,tol,maxiter", [
    (False, 1e-9, 10_000), (True, 1e-9, 10_000), (True, 1e-7, 60)])
def test_mle_bloch_kernel_matches_general(warm_start, tol, maxiter,
                                          monkeypatch):
    """The Bloch route and the general loop are one algorithm (1e-12);
    each matches its JAX counterpart."""
    rng = np.random.RandomState(11)
    obs, e, nm, _ = _shot_expectations(rng, 64, 1, 2000)
    kw = dict(tol=tol, maxiter=maxiter, warm_start=warm_start)
    general, _ = _hold_general_against_jax(monkeypatch, obs, e, nm, **kw)
    bloch = _port(obs, e, nm, method="bloch", **kw)
    assert np.max(np.abs(general - bloch)) < 1e-12
    assert np.allclose(np.trace(bloch, axis1=1, axis2=2).real, 1.0,
                       atol=1e-12)
    assert np.max(np.abs(bloch - _jax(obs, e, nm, method="bloch", **kw))) \
        < MATCHED


def test_mle_bloch_matches_numpy_oracle():
    rng = np.random.RandomState(12)
    obs, e, nm, _ = _shot_expectations(rng, 8, 1, 2000)
    ours = _port(obs, e, nm, tol=1e-9, method="bloch")
    for i in range(e.shape[0]):
        oracle = np_mle_state(obs, e[i], epsilon=0.1, tol=1e-9)
        assert np.max(np.abs(ours[i] - oracle)) < 1e-7


def test_mle_bloch_routing(monkeypatch):
    """``method="auto"`` takes the Bloch route for an [X, Y, Z] stack and
    the general loop otherwise, as JAX does on the CPU; ``"bloch"`` raises
    where it does not apply; the port compares tensors wherever they lie."""
    xyz = pauli_basis_matrices(1)[1:]
    for obs_mats, want in ((xyz, True), (xyz[::-1], False),
                           (pauli_basis_matrices(2)[1:4], False),
                           (xyz.tolist(), False)):
        assert tomography._is_xyz_pauli_stack(obs_mats) is want
        assert jax_tomo._is_xyz_pauli_stack(obs_mats) is want
    assert tomography._is_xyz_pauli_stack(torch.tensor(xyz))
    assert tomography._is_xyz_pauli_stack(torch.tensor(xyz.conj()).conj())
    assert not tomography._is_xyz_pauli_stack(torch.tensor(xyz[::-1].copy()))
    rng = np.random.RandomState(13)
    obs, e, nm, _ = _shot_expectations(rng, 4, 1, 2000)
    for kw in (dict(beta=0.5, method="bloch"), dict(method="nope")):
        with pytest.raises(ValueError):
            _port(obs, e, nm, **kw)
    with pytest.raises(ValueError):
        _port(obs[::-1], e, nm, method="bloch")
    hedged, _ = _hold_general_against_jax(monkeypatch, obs, e, nm, beta=0.5,
                                          maxiter=500)
    assert np.array_equal(_port(obs, e, nm, beta=0.5, maxiter=500), hedged)
    assert np.allclose(np.trace(hedged, axis1=1, axis2=2).real, 1.0,
                       atol=1e-8)


def test_mle_bloch_representation():
    rng = np.random.RandomState(14)
    obs, e, nm, _ = _shot_expectations(rng, 16, 1, 2000)
    kw = dict(tol=1e-7, maxiter=60, warm_start=True)
    rho = _port(obs, e, nm, **kw)
    r = tomography.iterative_mle_state_estimate_batched(
        obs, e, nm, representation="bloch", device="cpu", **kw)
    assert r.shape == (16, 3) and r.dtype == torch.float64
    assert np.max(np.abs(tomography.bloch_to_density(r).numpy() - rho)) \
        < 1e-12
    assert np.max(np.abs(r.numpy() - _jax(obs, e, nm, representation="bloch",
                                          **kw))) < MATCHED
    assert np.max(np.abs(
        tomography.bloch_to_density(r.float()).numpy()
        - np.asarray(jax_tomo.bloch_to_density(jnp.asarray(r.numpy(),
                                                           jnp.float32)))
    )) == 0
    for bad in (dict(method="general", representation="bloch"),
                dict(representation="nope")):
        with pytest.raises(ValueError):
            _port(obs, e, nm, **{**kw, **bad})


def test_mle_bloch_flops_per_solve_equals_jax():
    for maxiter in (0, 1, 60, 10_000):
        assert tomography.mle_bloch_flops_per_solve(maxiter) == \
            jax_tomo.mle_bloch_flops_per_solve(maxiter)


def test_mle_bloch_steps_do_not_depend_on_the_chunk(monkeypatch):
    """Frozen problems and the step cap make the result independent of how
    often the loop reads its stop test."""
    rng = np.random.RandomState(15)
    _, e, _, _ = _shot_expectations(rng, 32, 1, 500)
    e = torch.tensor(e)
    want, steps = tomography._mle_bloch_kernel(e, 0.1, 1e-9, 157, False)
    for chunk in (1, 3, 1000):
        monkeypatch.setattr(tomography, "BLOCH_CHUNK", chunk)
        got, got_steps = tomography._mle_bloch_kernel(e, 0.1, 1e-9, 157,
                                                      False)
        assert torch.equal(got, want)
        assert got_steps <= 157


def test_mle_warm_start_same_fixed_point():
    """warm_start=True reaches the same 1Q fixed point as the I/d start."""
    rng = np.random.RandomState(3)
    obs, e, nm, _ = _shot_expectations(rng, 16, 1, 2000)
    kw = dict(tol=1e-10, maxiter=20000)
    cold = _port(obs, e, nm, **kw)
    warm = _port(obs, e, nm, warm_start=True, **kw)
    assert np.abs(warm - cold).max() < 1e-3
    assert np.allclose(np.trace(warm, axis1=1, axis2=2).real, 1.0,
                       atol=1e-10)
    assert np.abs(warm - _jax(obs, e, nm, warm_start=True, **kw)).max() \
        < MATCHED


def test_mle_warm_start_2q_same_fixed_point(monkeypatch):
    """The linear-inversion warm start is valid for the full 2Q Pauli basis:
    the port's warm estimate is the fixed point of the I/d start (1e-4).
    The cold loop needs all 50000 steps on most problems, so it runs in
    JAX; the port's cold loop is held to it over its first 2000 steps."""
    rng = np.random.RandomState(2)
    obs, e, nm, _ = _shot_expectations(rng, 8, 2, 3000)
    kw = dict(tol=1e-11, maxiter=50000)
    warm, _ = _hold_general_against_jax(monkeypatch, obs, e, nm,
                                        warm_start=True, **kw)
    cold = _jax(obs, e, nm, **kw)
    assert np.abs(warm - cold).max() < 1e-4
    _hold_general_against_jax(monkeypatch, obs, e, nm, tol=1e-11,
                              maxiter=2000)


def test_numpy_input_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    rng = np.random.RandomState(16)
    obs, e, nm, _ = _shot_expectations(rng, 2, 1, 100)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tomography.iterative_mle_state_estimate_batched(obs, e, nm)
    # tensors run where they lie, and a device that names another raises
    out = tomography.iterative_mle_state_estimate_batched(
        obs, torch.tensor(e), nm, maxiter=5)
    assert out.device.type == "cpu"
    with pytest.raises(ValueError, match="lie on"):
        tomography.iterative_mle_state_estimate_batched(
            obs, torch.tensor(e), nm, device="cuda")
