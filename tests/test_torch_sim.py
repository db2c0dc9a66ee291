"""The port's simulator (``sim/``) against the JAX package's on the CPU.

Mirrors tests/test_sim.py and tests/test_executor.py (their tests of the
JAX-only compile caches, ``QVM._jit_cache``, have no counterpart: the port
compiles nothing) and holds the port to JAX on the same circuits, built in
each package from the same numpy values: wavefunctions, density matrices,
probabilities and expectations within 1e-12 in complex128 on random 1-4
qubit circuits, with gate noise, readout confusion, DELAY decoherence and
marginalization onto reordered subsets. Samplers are held by distribution
(5 sigma binomial bars), since the random streams differ.
"""
import itertools

import numpy as np
import pytest
import torch

import forest_benchmarking_tpu.circuits as jc
import forest_benchmarking_tpu.paulis as jp
from forest_benchmarking_tpu.sim import density as jax_density
from forest_benchmarking_tpu.sim import noise as jax_noise
from forest_benchmarking_tpu.sim.qvm import QVM as JaxQVM
import forest_benchmarking_tpu_torch.circuits as tc
import forest_benchmarking_tpu_torch.paulis as tp
from forest_benchmarking_tpu_torch.sim import (
    QVM, run_density_matrix, run_statevector, statevector_probabilities,
    all_bitstrings, density_probabilities, apply_confusion)
from forest_benchmarking_tpu_torch.sim import density, executor, noise
from forest_benchmarking_tpu_torch.sim.qvm import _symmetrization_patterns

torch.set_num_threads(1)

ONE_Q = ["I", "X", "Y", "Z", "H", "S", "T", "RX", "RY", "RZ", "PHASE"]
TWO_Q = ["CZ", "CNOT", "SWAP", "ISWAP", "XY", "CPHASE"]
PARAMETRIC = {"RX", "RY", "RZ", "PHASE", "XY", "CPHASE"}


def qvm(**kw):
    return QVM(device="cpu", **kw)


def random_specs(rng, n_qubits, n_gates):
    """(name, params, qubits, dagger, matrix) tuples over qubits 0..n-1,
    the last one a custom matrix."""
    specs = []
    for _ in range(n_gates):
        pool = ONE_Q + (TWO_Q if n_qubits >= 2 else []) \
            + (["CCNOT"] if n_qubits >= 3 else [])
        name = pool[rng.integers(len(pool))]
        arity = 3 if name == "CCNOT" else 2 if name in TWO_Q else 1
        qubits = tuple(int(q) for q in rng.permutation(n_qubits)[:arity])
        params = (float(rng.uniform(-np.pi, np.pi)),) \
            if name in PARAMETRIC else ()
        specs.append((name, params, qubits, bool(rng.integers(2)), None))
    z = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
    u, _ = np.linalg.qr(z)
    specs.append(("CUSTOM", (), (int(rng.integers(n_qubits)),), False,
                  tuple(map(tuple, u))))
    return specs


def build(mod, specs, noise_entries=(), confusion=None):
    """The same circuit in the package ``mod`` (its circuits module)."""
    c = mod.Circuit([mod.Gate(name, params, qubits, matrix, dagger)
                     for name, params, qubits, dagger, matrix in specs])
    for name, qubits, kraus in noise_entries:
        c.define_noisy_gate(name, qubits, kraus)
    for q, (p00, p11) in (confusion or {}).items():
        c.define_noisy_readout(q, p00=p00, p11=p11)
    return c


def random_kraus(rng, k, n_ops=3):
    """A random CPTP set of ``n_ops`` 2^k x 2^k operators (numpy)."""
    d = 2 ** k
    z = rng.standard_normal((n_ops * d, d)) + 1j * rng.standard_normal(
        (n_ops * d, d))
    q, _ = np.linalg.qr(z)
    return [q[i * d:(i + 1) * d] for i in range(n_ops)]


def random_case(seed, n_qubits, noisy):
    rng = np.random.default_rng(seed)
    specs = random_specs(rng, n_qubits, 3 * n_qubits + 2)
    noise_entries, confusion = [], None
    if noisy:
        names = sorted({s[0] for s in specs if s[0] in ONE_Q})
        noise_entries.append((names[0], None, random_kraus(rng, 1)))
        two = [s for s in specs if s[0] in TWO_Q]
        if two:
            noise_entries.append((two[0][0], two[0][2], random_kraus(rng, 2)))
        confusion = {q: tuple(rng.uniform(0.8, 1.0, 2))
                     for q in range(n_qubits) if rng.random() < 0.7}
    return specs, noise_entries, confusion


# --- host modules held exactly ------------------------------------------

@pytest.mark.parametrize("dagger", [False, True])
def test_gate_matrices_equal_jax(dagger):
    rng = np.random.default_rng(1)
    for name in list(jc.GATES) + sorted(PARAMETRIC) + ["DELAY"]:
        params = (float(rng.uniform(-4, 4)),) \
            if name in PARAMETRIC or name == "DELAY" else ()
        want = jc.gate_matrix(name, params, dagger=dagger)
        got = tc.gate_matrix(name, params, dagger=dagger)
        assert np.array_equal(got, want), name
    assert list(tc.GATES) == list(jc.GATES)
    assert tc.__all__ == jc.__all__


def test_noise_maps_equal_jax():
    for name in ("damping_kraus_map", "dephasing_kraus_map",
                 "depolarizing_kraus_map", "bit_flip_kraus_map"):
        for p in (0.0, 0.1, 0.37):
            want = getattr(jax_noise, name)(p)
            got = getattr(noise, name)(p)
            assert all(np.array_equal(a, b) for a, b in zip(got, want))
    k = noise.depolarizing_kraus_map(0.2)
    u = tc.gate_matrix("H")
    assert all(np.array_equal(a, b) for a, b in zip(
        noise.append_kraus_to_gate(k, u), jax_noise.append_kraus_to_gate(k, u)))
    assert noise.__all__ == jax_noise.__all__


@pytest.mark.parametrize("t1,t2", [(20e-6, None), (None, 15e-6),
                                   (20e-6, 15e-6), (None, None)])
def test_decoherence_kraus_equals_jax(t1, t2):
    want = jax_density.decoherence_kraus(1e-6, t1, t2)
    got = density.decoherence_kraus(1e-6, t1, t2)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("axes,n", [([0], 1), ([1], 2), ([2, 0], 3),
                                    ([1, 3], 4), ([3, 0, 2], 4)])
def test_lift_and_density_updates_match_jax(axes, n):
    import jax.numpy as jnp
    rng = np.random.default_rng(len(axes) * 10 + n)
    k = len(axes)
    kraus = np.stack(random_kraus(rng, k))
    mat = kraus[0] / np.linalg.norm(kraus[0], 2)
    np.testing.assert_array_equal(
        density._lift(torch.tensor(mat), axes, n).numpy(),
        np.asarray(jax_density._lift(jnp.asarray(mat), axes, n)))
    d = 2 ** n
    z = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
    rho = z @ z.conj().T
    rho /= np.trace(rho)
    np.testing.assert_allclose(
        density.apply_gate_to_density(torch.tensor(rho), torch.tensor(mat),
                                      axes, n).numpy(),
        np.asarray(jax_density.apply_gate_to_density(
            jnp.asarray(rho), jnp.asarray(mat), axes, n)), atol=1e-12)
    np.testing.assert_allclose(
        density.apply_kraus_to_density(torch.tensor(rho), torch.tensor(kraus),
                                       axes, n).numpy(),
        np.asarray(jax_density.apply_kraus_to_density(
            jnp.asarray(rho), jnp.asarray(kraus), axes, n)), atol=1e-12)


def test_confusion_matrix_equals_jax():
    specs, _, _ = random_case(3, 3, False)
    conf = {0: (0.9, 0.8), 2: (0.97, 0.85)}
    want = np.asarray(jax_density.confusion_matrix_for(
        build(jc, specs, confusion=conf), [2, 0, 1]))
    got = density.confusion_matrix_for(build(tc, specs, confusion=conf),
                                       [2, 0, 1], device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert density.confusion_matrix_for(build(tc, specs), [0],
                                        device="cpu") is None


# --- the simulator against JAX's CPU route, 1e-12 ------------------------

CASES = [(seed, n, noisy) for n in (1, 2, 3, 4) for noisy in (False, True)
         for seed in (n * 7 + noisy,)]


@pytest.mark.parametrize("seed,n,noisy", CASES)
def test_simulator_matches_jax(seed, n, noisy):
    """wavefunction, density, probabilities (all qubits, and a reordered
    subset with an extra qubit marginalized out) and expectation."""
    specs, entries, conf = random_case(seed, n, noisy)
    jcirc, tcirc = build(jc, specs, entries, conf), build(tc, specs, entries,
                                                         conf)
    jq, tq = JaxQVM(seed=0), qvm(seed=0)
    qubits = list(range(n))[::-1]
    np.testing.assert_allclose(tq.wavefunction(tcirc, qubits).numpy(),
                               np.asarray(jq.wavefunction(jcirc, qubits)),
                               atol=1e-12)
    np.testing.assert_allclose(tq.density(tcirc, qubits).numpy(),
                               np.asarray(jq.density(jcirc, qubits)),
                               atol=1e-12)
    subsets = [qubits] + ([[n - 1, 0]] if n >= 3 else []) + [[n, 0]]
    for sub in subsets:
        got = tq.probabilities(tcirc, sub)
        assert got.dtype == torch.float64 and got.shape == (2 ** len(sub),)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jq.probabilities(jcirc, sub)), atol=1e-12)
    rng = np.random.default_rng(seed + 100)
    for _ in range(3):
        ops = {q: "IXYZ"[rng.integers(4)] for q in range(n)}
        want = jq.expectation(jcirc, [0], jp.PauliTerm(ops))
        got = tq.expectation(tcirc, [0], tp.PauliTerm(ops))
        assert isinstance(got, float)
        assert abs(got - want) < 1e-12


def test_noisy_qvm_and_decoherence_match_jax():
    """DELAY decoherence under t1s/t2s, and noisy=True on a clean circuit."""
    specs = [("RX", (np.pi / 3,), (0,), False, None),
             ("DELAY", (7e-6,), (0,), False, None),
             ("H", (), (1,), False, None), ("CZ", (), (0, 1), False, None),
             ("DELAY", (3e-6,), (1,), False, None)]
    t1s, t2s = {0: 20e-6, 1: 30e-6}, {0: 15e-6}
    jq, tq = JaxQVM(t1s=t1s, t2s=t2s), qvm(t1s=t1s, t2s=t2s)
    for sub in ([0, 1], [1, 0], [1]):
        np.testing.assert_allclose(
            tq.probabilities(build(tc, specs), sub).numpy(),
            np.asarray(jq.probabilities(build(jc, specs), sub)), atol=1e-12)
    obs = {0: "Z", 1: "X"}
    assert abs(tq.expectation(build(tc, specs), [0, 1], tp.PauliTerm(obs))
               - jq.expectation(build(jc, specs), [0, 1], jp.PauliTerm(obs))
               ) < 1e-12
    want = np.asarray(JaxQVM(noisy=True).probabilities(build(jc, specs[2:4]),
                                                       [1, 0]))
    got = qvm(noisy=True).probabilities(build(tc, specs[2:4]), [1, 0])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12)


def test_module_functions_match_jax():
    specs, entries, conf = random_case(5, 3, True)
    jcirc, tcirc = build(jc, specs, entries, conf), build(tc, specs, entries,
                                                         conf)
    q = [1, 2, 0]
    np.testing.assert_allclose(
        density_probabilities(tcirc, q, device="cpu").numpy(),
        np.asarray(jax_density.density_probabilities(jcirc, q)), atol=1e-12)
    clean = build(tc, specs)
    np.testing.assert_allclose(
        statevector_probabilities(clean, q, device="cpu").numpy(),
        np.abs(run_statevector(clean, q, device="cpu").numpy()) ** 2,
        atol=1e-15)
    p = torch.tensor([0.1, 0.2, 0.3, 0.4, 0, 0, 0, 0], dtype=torch.float64)
    np.testing.assert_allclose(
        apply_confusion(p, tcirc, q).numpy(),
        np.asarray(jax_density.apply_confusion(p.numpy(), jcirc, q)),
        atol=1e-15)
    assert np.array_equal(all_bitstrings(3),
                          np.array(list(itertools.product([0, 1], repeat=3))))


def test_complex64_runs_in_its_dtype():
    specs, entries, conf = random_case(9, 3, True)
    tcirc = build(tc, specs, entries, conf)
    p64 = qvm().probabilities(tcirc, [0, 1, 2])
    p32 = qvm(dtype=torch.complex64).probabilities(tcirc, [0, 1, 2])
    assert p32.dtype == torch.float32
    np.testing.assert_allclose(p32.numpy(), p64.numpy(), atol=1e-6)


# --- the executor (mirrors tests/test_executor.py) -----------------------

@pytest.fixture()
def fresh_cache():
    executor.clear_executor_cache()
    yield
    executor.clear_executor_cache()


def _plan_probs(circuit, qubits, **kw):
    plan = executor.build_plan(circuit, qubits, torch.complex128,
                               device="cpu", **kw)
    return plan.trace_probs(*plan.args()).numpy()


def test_plan_probs_match_jax_eager(fresh_cache):
    """Pure, marginalized, noisy and DELAY-decohered circuits: the plan's
    probabilities against the JAX QVM's eager route."""
    cases = [
        ([("H", (), (0,)), ("CNOT", (), (0, 1)), ("RZ", (0.3,), (1,)),
          ("RY", (-0.7,), (0,))], [0, 1], {}),
        ([("H", (), (0,)), ("CNOT", (), (0, 2)), ("RX", (0.4,), (1,))],
         [2, 0], {}),
        ([("RX", (np.pi,), (0,)), ("DELAY", (10e-6,), (0,))], [0],
         dict(t1s={0: 20e-6}, t2s={0: 15e-6})),
    ]
    for gates, qubits, kw in cases:
        specs = [(g[0], g[1], g[2], False, None) for g in gates]
        want = np.asarray(JaxQVM(seed=3, **kw)._probs_impl(build(jc, specs),
                                                          qubits))
        np.testing.assert_allclose(_plan_probs(build(tc, specs), qubits, **kw),
                                   want, atol=1e-12)
    specs = [("H", (), (0,), False, None), ("CZ", (), (0, 1), False, None)]
    kraus = [np.sqrt(0.9) * np.eye(2), np.sqrt(0.1) * np.array([[0, 1],
                                                                [1, 0]])]
    conf = {0: (0.95, 0.85)}
    want = np.asarray(JaxQVM(seed=3)._probs_impl(
        build(jc, specs, [("H", None, kraus)], conf), [0, 1]))
    np.testing.assert_allclose(
        _plan_probs(build(tc, specs, [("H", None, kraus)], conf), [0, 1]),
        want, atol=1e-12)


def test_cache_reuse_across_parameter_values(fresh_cache):
    gen = torch.Generator().manual_seed(0)
    for theta in (0.1, 0.2, 0.3, 0.4):
        c = tc.Circuit([tc.RX(np.pi / 2, 0), tc.RZ(theta, 0),
                        tc.RX(-np.pi / 2, 0)])
        plan = executor.build_plan(c, [0], torch.complex128, device="cpu")
        executor.sample_bits(plan, 11, gen)
    info = executor.executor_cache_info()
    assert info["misses"] == 1 and info["hits"] == 3 and info["entries"] == 1


def test_cache_distinguishes_structures(fresh_cache):
    gen = torch.Generator().manual_seed(1)
    c1 = tc.Circuit([tc.RX(0.1, 0)])
    c2 = tc.Circuit([tc.RX(0.1, 0), tc.RZ(0.2, 0)])
    for c in (c1, c2, c1, c2):
        plan = executor.build_plan(c, [0], torch.complex128, device="cpu")
        executor.sample_bits(plan, 7, gen)
    info = executor.executor_cache_info()
    assert info["misses"] == 2 and info["hits"] == 2


def test_sample_bits_distribution(fresh_cache):
    plan = executor.build_plan(tc.Circuit([tc.RX(np.pi, 0)]), [0, 1],
                               torch.complex128, device="cpu")
    bits = executor.sample_bits(plan, 64, torch.Generator().manual_seed(2))
    assert bits.shape == (64, 2) and bits.dtype == torch.int64
    assert (bits[:, 0] == 1).all() and (bits[:, 1] == 0).all()


def test_symmetrized_flip_layer_matches_explicit_x_gates(fresh_cache):
    """Each pattern's probabilities with the flip layer (one batched call)
    equal those of the circuit with explicit X gates appended, under
    readout confusion, and those of JAX's eager route."""
    specs = [("RY", (0.9,), (0,), False, None),
             ("CNOT", (), (0, 1), False, None)]
    conf = {0: (0.92, 0.84), 1: (0.97, 0.90)}
    qubits = [0, 1]
    plan = executor.build_plan(build(tc, specs, confusion=conf), qubits,
                               torch.complex128, device="cpu")
    patterns = _symmetrization_patterns(-1, 2)
    prog = plan.program()
    got = plan.trace_probs(*plan.args(),
                           prog.flip_pair[torch.tensor(patterns)])
    assert got.shape == (4, 4)
    for row, flips in zip(got, patterns):
        flipped = specs + [("X", (), (q,), False, None)
                           for q, f in zip(qubits, flips) if f]
        single = plan.trace_probs(*plan.args(), prog.flip_pair[
            torch.tensor(flips)])
        want = qvm().probabilities(build(tc, flipped, confusion=conf), qubits)
        np.testing.assert_allclose(row.numpy(), want.numpy(), atol=1e-12)
        np.testing.assert_allclose(single.numpy(), want.numpy(), atol=1e-12)
        np.testing.assert_allclose(
            row.numpy(), np.asarray(JaxQVM()._probs_impl(
                build(jc, flipped, confusion=conf), qubits)), atol=1e-12)


def test_symmetrized_sampler_shape_and_xor(fresh_cache):
    plan = executor.build_plan(tc.Circuit([tc.RX(np.pi, 0)]), [0],
                               torch.complex128, device="cpu")
    bits = executor.sample_bits_symmetrized(
        plan, _symmetrization_patterns(-1, 1), 33,
        torch.Generator().manual_seed(4))
    assert bits.shape == (2, 33, 1)
    assert (bits == 1).all()


# --- samplers, by distribution -------------------------------------------

def _five_sigma(counts, probs, shots):
    sigma = np.sqrt(shots * probs * (1 - probs))
    return np.all(np.abs(counts - shots * probs) <= 5 * sigma + 1e-9)


@pytest.mark.parametrize("noisy", [False, True])
def test_run_counts_within_binomial_bars(noisy):
    specs, entries, conf = random_case(31 + noisy, 3, noisy)
    tcirc = build(tc, specs, entries, conf)
    q = qvm(seed=5)
    shots = 20000
    qubits = [2, 0, 1]
    bits = q.run(tcirc, qubits, shots)
    assert bits.shape == (shots, 3) and bits.dtype == np.int64
    ints = bits @ [4, 2, 1]
    probs = q.probabilities(tcirc, qubits).numpy()
    assert _five_sigma(np.bincount(ints, minlength=8), probs, shots)


@pytest.mark.parametrize("symm_type", [-1, 0, 1, 2, 3])
def test_symmetrized_readout_distribution_and_shot_count(symm_type):
    """Every symmetrization type returns exactly ``num_shots`` rows; with
    symmetric flips the observed bits follow the exact distribution of the
    pattern mixture (5 sigma)."""
    specs, entries, conf = random_case(41, 3, True)
    tcirc = build(tc, specs, entries, conf)
    q = qvm(seed=6)
    qubits = [0, 1, 2]
    for shots in (1001, 12000):
        bits = q.run_symmetrized_readout(tcirc, shots, symm_type, qubits)
        assert bits.shape == (shots, 3)
    pats = (np.zeros((1, 3), dtype=np.int64) if symm_type == 0
            else _symmetrization_patterns(symm_type, 3))
    base, rem = divmod(shots, len(pats))
    mix = np.zeros(8)
    for i, pat in enumerate(pats):
        flipped = specs + [("X", (), (qq,), False, None)
                           for qq, f in zip(qubits, pat) if f]
        p = q.probabilities(build(tc, flipped, entries, conf), qubits).numpy()
        # the observed bits are XORed with the pattern
        idx = np.arange(8) ^ int(pat @ [4, 2, 1])
        mix[idx] += (base + (i < rem)) * p
    counts = np.bincount(bits @ [4, 2, 1], minlength=8)
    assert _five_sigma(counts, mix / shots, shots)


# --- mirrors of tests/test_sim.py ----------------------------------------

def test_plus_bell_ghz_and_msb_convention():
    psi = run_statevector(tc.Circuit([tc.H(0)]), [0], device="cpu").numpy()
    assert np.allclose(psi, [1 / np.sqrt(2), 1 / np.sqrt(2)])
    psi = run_statevector(tc.Circuit([tc.H(0), tc.CNOT(0, 1)]), [0, 1],
                          device="cpu").numpy()
    assert np.allclose(psi, [1 / np.sqrt(2), 0, 0, 1 / np.sqrt(2)])
    psi = run_statevector(tc.Circuit([tc.X(0), tc.CNOT(0, 1)]), [0, 1],
                          device="cpu").numpy()
    assert np.allclose(np.abs(psi) ** 2, [0, 0, 0, 1])
    psi = run_statevector(tc.Circuit([tc.X(1), tc.CNOT(0, 1)]), [0, 1],
                          device="cpu").numpy()
    assert np.allclose(np.abs(psi) ** 2, [0, 1, 0, 0])
    c = tc.Circuit([tc.H(0), tc.CNOT(0, 1), tc.CNOT(1, 2)])
    p = np.abs(run_statevector(c, [0, 1, 2], device="cpu").numpy()) ** 2
    assert np.allclose(p, [0.5, 0, 0, 0, 0, 0, 0, 0.5])


def test_density_matches_statevector_and_gate_noise_depolarizes():
    c = tc.Circuit([tc.H(0), tc.CNOT(0, 1), tc.RZ(0.3, 1)])
    psi = run_statevector(c, [0, 1], device="cpu").numpy()
    rho = run_density_matrix(c, [0, 1], device="cpu").numpy()
    assert np.allclose(rho, np.outer(psi, psi.conj()), atol=1e-12)
    p = 0.3
    c = tc.Circuit([tc.H(0)])
    c.define_noisy_gate("H", None, noise.depolarizing_kraus_map(p))
    rho = run_density_matrix(c, [0], device="cpu").numpy()
    plus = np.array([[0.5, 0.5], [0.5, 0.5]])
    assert np.allclose(rho, (1 - p) * plus + p * np.eye(2) / 2, atol=1e-12)


def test_qvm_run_deterministic_and_statistics():
    bits = qvm(seed=1).run(tc.Circuit([tc.X(0)]), [0], 100)
    assert bits.shape == (100, 1) and np.all(bits == 1)
    bits = qvm(seed=2).run(tc.Circuit([tc.H(0)]), [0], 20000)
    assert abs(bits.mean() - 0.5) < 0.02


def test_qvm_expectation_exact():
    q = qvm(seed=3)
    c = tc.Circuit([tc.H(0)])
    assert np.isclose(q.expectation(c, [0], tp.sX(0)), 1.0, atol=1e-12)
    assert np.isclose(q.expectation(c, [0], tp.sZ(0)), 0.0, atol=1e-12)
    bell = tc.Circuit([tc.H(0), tc.CNOT(0, 1)])
    for s, v in (("ZZ", 1.0), ("XX", 1.0), ("YY", -1.0)):
        assert np.isclose(q.expectation(bell, [0, 1],
                                        tp.str_to_pauli_term(s, [0, 1])), v)
    circ = tc.Circuit([tc.H(0), tc.CZ(0, 1)])
    assert abs(q.expectation(circ, [0], tp.PauliTerm([(0, "Z")]))) < 1e-12
    assert np.isfinite(q.expectation(circ, [0], tp.PauliTerm([(1, "X")])))


def test_readout_confusion_and_symmetrization_balance():
    c = tc.Circuit([tc.X(0)])
    c.define_noisy_readout(0, p00=1.0, p11=0.8)
    assert abs(qvm(seed=4).run(c, [0], 50000).mean() - 0.8) < 0.01
    q = qvm(seed=5)
    c = tc.Circuit([tc.H(0)])
    c.define_noisy_readout(0, p00=1.0, p11=0.7)
    assert abs(q.run(c, [0], 40000).mean() - 0.35) < 0.02
    for symm_type in (-1, 1):
        symm = q.run_symmetrized_readout(c, 40000, symm_type=symm_type,
                                         meas_qubits=[0]).mean()
        assert abs(symm - 0.5) < 0.02


def test_dagger_inverts_and_xy_is_iswap():
    c = tc.Circuit([tc.H(0), tc.T(0), tc.CNOT(0, 1), tc.RY(0.3, 1)])
    psi = run_statevector(c + c.dagger(), [0, 1], device="cpu").numpy()
    assert np.allclose(np.abs(psi), [1, 0, 0, 0], atol=1e-12)
    psi1 = run_statevector(tc.Circuit([tc.X(0), tc.XY(np.pi, 0, 1)]), [0, 1],
                           device="cpu").numpy()
    psi2 = run_statevector(tc.Circuit([tc.X(0), tc.ISWAP(0, 1)]), [0, 1],
                           device="cpu").numpy()
    assert np.allclose(psi1, psi2, atol=1e-12)


def test_symmetrization_patterns_equal_jax_and_are_orthogonal_arrays():
    from forest_benchmarking_tpu.sim.qvm import (
        _symmetrization_patterns as jax_patterns)
    for symm_type in (-1, 1, 2, 3):
        for k in range(1, 6):
            assert np.array_equal(_symmetrization_patterns(symm_type, k),
                                  jax_patterns(symm_type, k))
    for k in (2, 3, 5):
        pats = _symmetrization_patterns(2, k)
        for i, j in itertools.combinations(range(k), 2):
            counts = np.bincount(pats[:, i] * 2 + pats[:, j], minlength=4)
            assert len(set(counts)) == 1
    for k in (3, 4):
        pats = _symmetrization_patterns(3, k)
        for i, j, l in itertools.combinations(range(k), 3):
            counts = np.bincount(pats[:, i] * 4 + pats[:, j] * 2 + pats[:, l],
                                 minlength=8)
            assert len(set(counts)) == 1
    with pytest.raises(ValueError):
        _symmetrization_patterns(7, 2)


def test_symmetrized_readout_with_noisy_flip_gates():
    """A noise channel on X gates takes the per-pattern route with real X
    gates (the batched flip layer is ideal): the pattern-1 flip is noisy
    too, so about half the shots see two noisy flips."""
    p = 0.4
    kraus = [np.sqrt(1 - p) * np.eye(2), np.sqrt(p) * np.array([[0, 1],
                                                                [1, 0]])]
    c = tc.Circuit([tc.X(0)])
    c.define_noisy_gate("X", None, kraus)
    bits = qvm(seed=3).run_symmetrized_readout(c, 20000, symm_type=-1,
                                               meas_qubits=[0])
    # a noisy X flips with probability 1 - p. Pattern 0: P(1) = 1 - p.
    # Pattern 1 (a second noisy X, then XOR 1): the state is 1 after one
    # net flip of two, 2 p (1 - p), so P(1) = 1 - 2 p (1 - p). An ideal
    # flip layer would give 1 - p for both (0.6 against 0.56 here).
    want = ((1 - p) + 1 - 2 * p * (1 - p)) / 2
    assert abs(bits.mean() - want) < 0.015


def test_qvm_needs_the_card_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        QVM()
    with pytest.raises(RuntimeError):
        run_statevector(tc.Circuit([tc.H(0)]), [0])
    assert QVM(device="cpu").device.type == "cpu"
