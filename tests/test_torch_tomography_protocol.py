"""The port's results-level tomography and ``do_tomography`` on its QVM.

Mirrors the results-level tests of tests/test_state_tomography.py and
tests/test_process_tomography.py (``do_tomography`` included) on the CPU,
and holds the port's estimators to the JAX package's on identical results,
built in each package from the same numbers: linear inversion (state and
process) within 1e-10, ``iterative_mle_state_estimate`` and
``pgdb_process_estimate`` within 1e-9, ``estimate_variance`` with the same
``np.random.RandomState`` seed within 1e-10; ``state_to_density`` and
``_extract_from_results`` exactly.
"""
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import forest_benchmarking_tpu.observable_estimation as joe
import forest_benchmarking_tpu.tomography as jtomo
from forest_benchmarking_tpu import distance_measures as jdm
from forest_benchmarking_tpu_torch import distance_measures as dm
from forest_benchmarking_tpu_torch import tomography as tomo
from forest_benchmarking_tpu_torch.circuits import (
    Circuit, H, CNOT, RX, RY, RZ, X)
from forest_benchmarking_tpu_torch.observable_estimation import (
    ExperimentResult, ExperimentSetting, SIC0, SIC1, SIC2, SIC3, plusX,
    minusY, estimate_observables, group_settings, _max_weight_state,
    _one_q_state_prep)
from forest_benchmarking_tpu_torch.ops import (
    choi2pauli_liouville, choi_is_completely_positive,
    choi_is_trace_preserving, kraus2choi, project_state_matrix_to_physical)
from forest_benchmarking_tpu_torch.sim import QVM, run_statevector
from oracles import np_mle_state, np_pgdb

torch.set_num_threads(1)
CPU = dict(device="cpu")


def qvm(seed):
    return QVM(seed=seed, device="cpu")


def wfn_estimate_observables(q, expt, qubits):
    """Shot-free results: exact expectations, std_err 0 (the JAX suite's
    ``oracles.wfn_estimate_observables`` on the port)."""
    results = []
    for settings in expt:
        prep = Circuit()
        for oneq in _max_weight_state(s.in_state for s in settings).states:
            prep += _one_q_state_prep(oneq)
        circuit = prep + expt.program
        for setting in settings:
            results.append(ExperimentResult(
                setting=setting, std_err=0.0, total_counts=10000,
                expectation=q.expectation(circuit, qubits, setting.observable)))
    return results


def true_state(circuit, qubits):
    psi = run_statevector(circuit, qubits, **CPU).numpy()
    return np.outer(psi, psi.conj())


def true_choi(circuit, qubits):
    n = len(qubits)
    cols = []
    for i in range(2 ** n):
        prep = Circuit([X(qubits[j]) for j in range(n) if (i >> (n - 1 - j)) & 1])
        cols.append(run_statevector(prep + circuit, qubits, **CPU).numpy())
    return kraus2choi(torch.tensor(np.stack(cols, axis=1))[None])


def process_fidelity(truth, est):
    return float(dm.process_fidelity(choi2pauli_liouville(truth),
                                     choi2pauli_liouville(est)))


def sampled(expt, seed, shots):
    return list(estimate_observables(qvm(seed), group_settings(expt),
                                     num_shots=shots, use_basic_compile=False))


# --- identical results in both packages -----------------------------------

def jax_results(results):
    """The same results in the JAX package (settings through their string
    form, the numbers as they are)."""
    return [joe.ExperimentResult(
        setting=joe.ExperimentSetting.from_str(str(r.setting)),
        expectation=r.expectation, total_counts=r.total_counts,
        std_err=r.std_err) for r in results]


def noisy_results(expt, seed, spread=0.05):
    """Exact expectations plus seeded noise (some pushed past +-1, as
    calibration can), with unequal counts and a non-unit coefficient."""
    rng = np.random.default_rng(seed)
    exact = wfn_estimate_observables(qvm(0), expt, sorted(
        expt.program.get_qubits()))
    out = []
    for i, r in enumerate(exact):
        e = r.expectation + spread * rng.standard_normal()
        if i == 3:
            obs = r.setting.observable.copy(coefficient=-1.0)
            r = replace(r, setting=ExperimentSetting(r.setting.in_state, obs))
            e = -e
        out.append(replace(r, expectation=float(e),
                           total_counts=int(rng.integers(500, 1500))))
    return out


@pytest.fixture(scope="module")
def state_case():
    circuit = Circuit([RY(0.7, 0), CNOT(0, 1)])
    expt = tomo.generate_state_tomography_experiment(circuit, [0, 1])
    res = noisy_results(expt, 1)
    jres = jax_results(res)
    jlin = np.asarray(jtomo.linear_inv_state_estimate(jres, [0, 1]))
    jmle = np.asarray(jtomo.iterative_mle_state_estimate(jres, [0, 1]))
    jme = np.asarray(jtomo.iterative_mle_state_estimate(
        jres, [0, 1], entropy_penalty=0.01, maxiter=300))
    jhe = np.asarray(jtomo.iterative_mle_state_estimate(
        jres, [0, 1], beta=0.5, epsilon=1e-4, maxiter=300))
    jvar = jtomo.estimate_variance(jres, [0, 1], jtomo.linear_inv_state_estimate,
                                   jdm.purity, n_resamples=6,
                                   project_to_physical=True,
                                   rng=np.random.RandomState(4))
    jvar_f = jtomo.estimate_variance(
        jres, [0, 1], jtomo.linear_inv_state_estimate, jdm.fidelity,
        target_state=jnp.asarray(true_state(circuit, [0, 1])), n_resamples=6,
        project_to_physical=True, rng=np.random.RandomState(5))
    return dict(circuit=circuit, res=res, lin=jlin, mle=jmle, me=jme,
                he=jhe, var=jvar, var_f=jvar_f)


@pytest.fixture(scope="module")
def process_case():
    circuit = Circuit([RY(0.9, 0), RZ(0.4, 0)])
    out = {}
    for basis in ("pauli", "sic"):
        expt = tomo.generate_process_tomography_experiment(circuit, [0], basis)
        res = noisy_results(expt, 2, spread=0.03)
        jres = jax_results(res)
        out[basis] = dict(
            res=res, lin=np.asarray(jtomo.linear_inv_process_estimate(jres, [0])),
            extract=jtomo._extract_from_results(jres, [0]))
    jres = jax_results(out["pauli"]["res"])
    out["pgdb"] = np.asarray(jtomo.pgdb_process_estimate(jres, [0]))
    return out


def test_experiments_equal_jax():
    prog = Circuit([H(0)])
    for n in (1, 2):
        qs = list(range(n))[::-1]
        got = tomo.generate_state_tomography_experiment(prog, qs)
        want = jtomo.generate_state_tomography_experiment(prog, qs)
        assert [str(s) for g in got for s in g] == [str(s) for g in want
                                                    for s in g]
        for basis in ("pauli", "SIC"):
            got = tomo.generate_process_tomography_experiment(prog, qs, basis)
            want = jtomo.generate_process_tomography_experiment(prog, qs,
                                                                basis)
            assert [str(s) for g in got for s in g] == [str(s) for g in want
                                                        for s in g]
    with pytest.raises(ValueError):
        tomo.generate_process_tomography_experiment(prog, [0], "nope")
    assert (tomo.MAXITER, tomo.OPTIMAL, tomo.FRO) == (
        jtomo.MAXITER, jtomo.OPTIMAL, jtomo.FRO)


def test_state_to_density_equals_jax_with_unnamed_qubits():
    """``state_to_density(tps, qubits)`` (the JAX signature): named qubits
    take their prep's state, unnamed ones |0><0|, exactly as JAX."""
    states = [SIC1(2) * plusX(0), minusY(3), SIC3(0) * SIC2(1) * plusX(3)]
    for tps in states:
        jtps = joe.TensorProductState.from_str(str(tps))
        for qubits in ([0, 1, 2, 3], [3, 1, 0, 2], [2, 5]):
            assert np.array_equal(tomo.state_to_density(tps, qubits),
                                  jtomo.state_to_density(jtps, qubits))


def test_state_to_density_sic_states_form_tetrahedron():
    """Mirror of tests/test_state_tomography.py:157."""
    states = [tomo.state_to_density(S(0), [0]) for S in (SIC0, SIC1, SIC2,
                                                         SIC3)]
    for i in range(4):
        assert np.isclose(np.trace(states[i] @ states[i]).real, 1.0, atol=1e-12)
        for j in range(i + 1, 4):
            assert np.isclose(np.trace(states[i] @ states[j]).real, 1 / 3,
                              atol=1e-10)


def test_state_estimators_equal_jax(state_case):
    res = state_case["res"]
    lin = tomo.linear_inv_state_estimate(res, [0, 1], **CPU)
    assert lin.dtype == torch.complex128
    np.testing.assert_allclose(lin.numpy(), state_case["lin"], atol=1e-10)
    np.testing.assert_allclose(
        tomo.iterative_mle_state_estimate(res, [0, 1], **CPU).numpy(),
        state_case["mle"], atol=1e-9)
    np.testing.assert_allclose(tomo.iterative_mle_state_estimate(
        res, [0, 1], entropy_penalty=0.01, maxiter=300, **CPU).numpy(),
        state_case["me"], atol=1e-9)
    np.testing.assert_allclose(tomo.iterative_mle_state_estimate(
        res, [0, 1], beta=0.5, epsilon=1e-4, maxiter=300, **CPU).numpy(),
        state_case["he"], atol=1e-9)
    jres = jax_results(res)
    for state in (state_case["lin"], state_case["mle"]):
        assert tomo.state_log_likelihood(torch.tensor(state), res, [0, 1]) \
            == jtomo.state_log_likelihood(state, jres, [0, 1])


def test_estimate_variance_equals_jax(state_case):
    res = state_case["res"]

    def lin(r, q):
        return tomo.linear_inv_state_estimate(r, q, **CPU)

    got = tomo.estimate_variance(res, [0, 1], lin, dm.purity, n_resamples=6,
                                 project_to_physical=True,
                                 rng=np.random.RandomState(4))
    np.testing.assert_allclose(got, state_case["var"], atol=1e-10)
    got = tomo.estimate_variance(
        res, [0, 1], lin, dm.fidelity,
        target_state=true_state(state_case["circuit"], [0, 1]), n_resamples=6,
        project_to_physical=True, rng=np.random.RandomState(5))
    np.testing.assert_allclose(got, state_case["var_f"], atol=1e-10)
    with pytest.raises(ValueError):
        tomo.estimate_variance(res, [0, 1], lin, dm.fidelity)


def test_process_estimators_equal_jax(process_case):
    for basis in ("pauli", "sic"):
        case = process_case[basis]
        a, n = tomo._extract_from_results(case["res"], [0])
        assert np.array_equal(a, case["extract"][0])
        assert np.array_equal(n, case["extract"][1])
        np.testing.assert_allclose(
            tomo.linear_inv_process_estimate(case["res"], [0], **CPU).numpy(),
            case["lin"], atol=1e-10)
    est = tomo.pgdb_process_estimate(process_case["pauli"]["res"], [0], **CPU)
    assert est.dtype == torch.complex128 and est.shape == (4, 4)
    np.testing.assert_allclose(est.numpy(), process_case["pgdb"], atol=1e-9)


def test_extract_keeps_negative_counts_of_calibrated_expectations():
    """A calibrated expectation past +-1 gives a negative entry of n, as in
    the JAX package; nothing is clipped."""
    expt = tomo.generate_process_tomography_experiment(Circuit([H(0)]), [0])
    res = wfn_estimate_observables(qvm(0), expt, [0])
    res[0] = replace(res[0], expectation=1.04)
    _, n = tomo._extract_from_results(res, [0])
    _, jn = jtomo._extract_from_results(jax_results(res), [0])
    assert n[1] < 0 and np.array_equal(n, jn)


# --- mirrors of tests/test_state_tomography.py ------------------------------

@pytest.mark.parametrize("circuit,qubits", [
    (Circuit([H(0)]), [0]), (Circuit([RY(0.6, 0)]), [0]),
    (Circuit([H(0), CNOT(0, 1)]), [0, 1])])
def test_linear_inv_exact_expectations(circuit, qubits):
    expt = tomo.generate_state_tomography_experiment(circuit, qubits)
    res = wfn_estimate_observables(qvm(1), expt, qubits)
    rho = tomo.linear_inv_state_estimate(res, qubits, **CPU).numpy()
    assert np.max(np.abs(rho - true_state(circuit, qubits))) < 1e-10


def test_mle_exact_and_sampled_and_oracle():
    circuit, qubits = Circuit([H(0), CNOT(0, 1)]), [0, 1]
    expt = tomo.generate_state_tomography_experiment(circuit, qubits)
    truth = torch.tensor(true_state(circuit, qubits))
    rho = tomo.iterative_mle_state_estimate(
        wfn_estimate_observables(qvm(2), expt, qubits), qubits, **CPU)
    assert float(dm.fidelity(truth, rho)) > 0.999
    res = sampled(expt, 4, 10000)
    rho = tomo.iterative_mle_state_estimate(res, qubits, **CPU)
    assert float(dm.fidelity(truth, rho)) > 0.98
    obs_mats, expectations, _ = tomo._results_to_state_arrays(res, qubits)
    oracle = np_mle_state(obs_mats, expectations, epsilon=0.1, tol=1e-9)
    assert np.max(np.abs(rho.numpy() - oracle)) < 1e-8


def test_mle_maxent_and_hedged_variants():
    circuit, qubits = Circuit([RY(1.1, 0)]), [0]
    res = sampled(tomo.generate_state_tomography_experiment(circuit, qubits),
                  5, 4000)
    truth = torch.tensor(true_state(circuit, qubits))
    for kw in (dict(entropy_penalty=0.005),
               dict(beta=0.5, epsilon=0.0001, tol=1e-7)):
        rho = tomo.iterative_mle_state_estimate(res, qubits, **kw, **CPU)
        assert np.isclose(torch.trace(rho).real.item(), 1.0, atol=1e-8)
        assert float(dm.fidelity(truth, rho)) > 0.9
    with pytest.raises(ValueError):
        tomo.iterative_mle_state_estimate(res, qubits, entropy_penalty=0.1,
                                          beta=0.5, **CPU)


def test_state_log_likelihood_and_bootstrap():
    circuit, qubits = Circuit([H(0)]), [0]
    res = sampled(tomo.generate_state_tomography_experiment(circuit, qubits),
                  7, 4000)
    near = 0.98 * true_state(circuit, qubits) + 0.02 * np.eye(2) / 2
    bad = np.diag([0.9, 0.1]).astype(complex)
    assert tomo.state_log_likelihood(near, res, qubits) > \
        tomo.state_log_likelihood(bad, res, qubits)

    def lin(r, q):
        return tomo.linear_inv_state_estimate(r, q, **CPU)

    mean, var = tomo.estimate_variance(res, qubits, lin, dm.purity,
                                       n_resamples=20,
                                       project_to_physical=True,
                                       rng=np.random.RandomState(0))
    assert 0.9 < mean <= 1.01 and 0 <= var < 0.01


def test_do_tomography_state():
    circuit = Circuit([H(0)])
    rho, expt, results = tomo.do_tomography(qvm(9), circuit, [0], "state",
                                            num_shots=2000)
    assert rho.device.type == "cpu" and len(results) == 3
    truth = torch.tensor(true_state(circuit, [0]))
    assert float(dm.fidelity(truth, project_state_matrix_to_physical(rho))) \
        > 0.95
    with pytest.raises(ValueError):
        tomo.do_tomography(qvm(9), circuit, [0], "neither")


# --- mirrors of tests/test_process_tomography.py ----------------------------

@pytest.mark.parametrize("basis", ["pauli", "sic"])
def test_linear_inv_process_exact(basis):
    circuit = Circuit([RY(0.7, 0)])
    expt = tomo.generate_process_tomography_experiment(circuit, [0], basis)
    res = wfn_estimate_observables(qvm(1), expt, [0])
    est = tomo.linear_inv_process_estimate(res, [0], **CPU)
    assert float((est - true_choi(circuit, [0])).abs().max()) < 1e-8


def test_linear_inv_process_2q_exact():
    circuit = Circuit([CNOT(0, 1)])
    expt = tomo.generate_process_tomography_experiment(circuit, [0, 1])
    res = wfn_estimate_observables(qvm(2), expt, [0, 1])
    est = tomo.linear_inv_process_estimate(res, [0, 1], **CPU)
    assert float((est - true_choi(circuit, [0, 1])).abs().max()) < 1e-8


def test_pgdb_exact_and_oracle_1q():
    circuit = Circuit([RX(np.pi / 2, 0)])
    expt = tomo.generate_process_tomography_experiment(circuit, [0])
    est = tomo.pgdb_process_estimate(
        wfn_estimate_observables(qvm(3), expt, [0]), [0], **CPU)
    assert process_fidelity(true_choi(circuit, [0]), est) > 0.999
    assert choi_is_trace_preserving(est, atol=1e-4)
    circuit = Circuit([RY(0.9, 0)])
    res = sampled(tomo.generate_process_tomography_experiment(circuit, [0]),
                  4, 1500)
    a, n = tomo._extract_from_results(res, [0])
    ours = tomo.pgdb_process_estimate(res, [0], **CPU).numpy()
    assert np.max(np.abs(ours - np_pgdb(a, n, dim=2))) < 1e-6


def test_pgdb_sampled_2q_close_to_truth():
    circuit = Circuit([CNOT(0, 1)])
    res = sampled(tomo.generate_process_tomography_experiment(circuit, [0, 1]),
                  6, 2000)
    est = tomo.pgdb_process_estimate(res, [0, 1], **CPU)
    assert process_fidelity(true_choi(circuit, [0, 1]), est) > 0.97
    assert choi_is_completely_positive(est, atol=1e-2)


def test_pgdb_trace_non_increasing_apg_and_batched():
    circuit = Circuit([RZ(0.4, 0)])
    expt = tomo.generate_process_tomography_experiment(circuit, [0])
    res = wfn_estimate_observables(qvm(7), expt, [0])
    est = tomo.pgdb_process_estimate(res, [0], trace_preserving=False, **CPU)
    assert process_fidelity(true_choi(circuit, [0]), est) > 0.99
    circuit = Circuit([RY(0.5, 0)])
    expt = tomo.generate_process_tomography_experiment(circuit, [0])
    res = wfn_estimate_observables(qvm(10), expt, [0])
    pgdb = tomo.pgdb_process_estimate(res, [0], **CPU)
    apg = tomo.pgdb_process_estimate(res, [0], method="apg", maxiter=60, **CPU)
    assert float((pgdb - apg).abs().max()) < 1e-3
    all_results = [sampled(tomo.generate_process_tomography_experiment(
        Circuit([RY(t, 0)]), [0]), 8, 1000) for t in (0.3, 1.0, 2.2)]
    a, _ = tomo._extract_from_results(all_results[0], [0])
    ns = np.stack([tomo._extract_from_results(r, [0])[1] for r in all_results])
    batched = tomo.pgdb_process_estimate_batched(
        torch.tensor(a), torch.tensor(ns), dim=2)
    singles = torch.stack([tomo.pgdb_process_estimate(r, [0], **CPU)
                           for r in all_results])
    assert float((batched - singles).abs().max()) < 1e-10


def test_process_estimators_respect_observable_coefficients():
    circuit = Circuit([RY(0.7, 0)])
    expt = tomo.generate_process_tomography_experiment(circuit, [0])
    results = wfn_estimate_observables(qvm(1), expt, [0])
    flipped = [replace(r, setting=ExperimentSetting(
        r.setting.in_state, r.setting.observable.copy(
            coefficient=-r.setting.observable.coefficient)),
        expectation=-r.expectation) if i % 2 == 0 else r
        for i, r in enumerate(results)]
    for fn, atol in ((tomo.linear_inv_process_estimate, 1e-12),
                     (tomo.pgdb_process_estimate, 1e-8)):
        np.testing.assert_allclose(fn(flipped, [0], **CPU).numpy(),
                                   fn(results, [0], **CPU).numpy(), atol=atol)


def test_do_tomography_process():
    circuit = Circuit([X(0)])
    choi, expt, results = tomo.do_tomography(qvm(9), circuit, [0], "process",
                                             num_shots=1500)
    assert process_fidelity(true_choi(circuit, [0]), choi) > 0.95
    assert len(results) == len(expt) == 18


def test_results_level_needs_the_card_unless_given_the_cpu(monkeypatch):
    expt = tomo.generate_state_tomography_experiment(Circuit([H(0)]), [0])
    res = wfn_estimate_observables(qvm(0), expt, [0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (tomo.linear_inv_state_estimate,
               tomo.iterative_mle_state_estimate):
        with pytest.raises(RuntimeError):
            fn(res, [0])
