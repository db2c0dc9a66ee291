"""The port's experiment data model (``paulis``, ``compilation``,
``observable_estimation``, ``utils``) against the JAX package's.

Mirrors tests/test_observable_estimation.py on the port's QVM (on the CPU)
and holds the host modules to JAX exactly: ``PauliTerm`` products and
matrices, ``basic_compile`` gate by gate, the groups ``group_settings``
forms, ``generate_experiment_programs``, ``bitarray_to_moments`` on one
seeded bit array, the JSON round trip and the utils helpers.
"""
import json

import numpy as np
import pytest
import torch

import forest_benchmarking_tpu.circuits as jc
import forest_benchmarking_tpu.compilation as jcomp
import forest_benchmarking_tpu.observable_estimation as joe
import forest_benchmarking_tpu.paulis as jp
import forest_benchmarking_tpu.utils as ju
import forest_benchmarking_tpu_torch.circuits as tc
import forest_benchmarking_tpu_torch.compilation as tcomp
import forest_benchmarking_tpu_torch.observable_estimation as toe
import forest_benchmarking_tpu_torch.paulis as tp
import forest_benchmarking_tpu_torch.utils as tu
from forest_benchmarking_tpu_torch.circuits import Circuit, H, CNOT, X
from forest_benchmarking_tpu_torch.observable_estimation import (
    TensorProductState, ExperimentSetting, ObservablesExperiment,
    ExperimentResult, SIC0, SIC1, plusX, minusZ, plusZ, zeros_state,
    group_settings, _max_weight_operator, _max_weight_state,
    generate_experiment_programs, shots_to_obs_moments, estimate_observables,
    calibrate_observable_estimates, ratio_variance,
    merge_disjoint_experiments, get_results_by_qubit_groups, to_json,
    read_json)
from forest_benchmarking_tpu_torch.paulis import (
    PauliTerm, sX, sZ, str_to_pauli_term, all_traceless_pauli_terms)
from forest_benchmarking_tpu_torch.sim import QVM

torch.set_num_threads(1)


def qvm(seed):
    return QVM(seed=seed, device="cpu")


def gate_tuples(circuit):
    return [(g.name, g.params, g.qubits, g.matrix, g.dagger)
            for g in circuit.gates]


def to_jax_setting(s):
    """The same setting in the JAX package, through its string form."""
    return joe.ExperimentSetting.from_str(str(s))


# --- host modules held exactly --------------------------------------------

def test_public_names_equal_jax():
    for port, ref in ((tc, jc), (tp, jp), (tcomp, jcomp), (toe, joe)):
        assert port.__all__ == ref.__all__
    assert set(ju.__all__) <= set(tu.__all__)
    assert set(tu.__all__) - set(ju.__all__) == {"entry_device"}


def test_pauli_products_and_matrices_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(40):
        n = int(rng.integers(1, 4))
        qubits = [int(q) for q in rng.permutation(5)[:n]]
        ops_a = {q: "IXYZ"[rng.integers(4)] for q in qubits}
        ops_b = {q: "IXYZ"[rng.integers(4)] for q in qubits[::-1]}
        ca, cb = complex(*rng.standard_normal(2)), float(rng.standard_normal())
        ta = tp.PauliTerm(ops_a, ca) * tp.PauliTerm(ops_b, cb)
        ja = jp.PauliTerm(ops_a, ca) * jp.PauliTerm(ops_b, cb)
        assert ta.compact_str() == ja.compact_str()
        assert ta.coefficient == ja.coefficient
        order = sorted(qubits, reverse=True)
        assert np.array_equal(tp.pauli_term_to_matrix(ta, order),
                              jp.pauli_term_to_matrix(ja, order))
        assert tp.PauliTerm.from_compact_str(ta.compact_str()) == ta
    for n in (1, 2, 3):
        qs = list(range(n))[::-1]
        assert [t.compact_str() for t in tp.all_traceless_pauli_terms(qs)] == \
            [t.compact_str() for t in jp.all_traceless_pauli_terms(qs)]
        assert [t.compact_str() for t in tp.all_traceless_pauli_z_terms(qs)] \
            == [t.compact_str() for t in jp.all_traceless_pauli_z_terms(qs)]


def test_basic_compile_equals_jax_gate_by_gate():
    rng = np.random.default_rng(1)
    names = ["I", "X", "Y", "Z", "H", "S", "T", "RX", "RY", "RZ", "CZ",
             "CNOT", "SWAP", "XY", "CCNOT", "DELAY"]
    param = {"RX", "RY", "RZ", "XY", "DELAY"}
    gates = []
    for name in names * 2:
        arity = 3 if name == "CCNOT" else 2 if name in ("CZ", "CNOT", "SWAP",
                                                        "XY") else 1
        qubits = tuple(int(q) for q in rng.permutation(3)[:arity])
        params = ((float(rng.choice([np.pi / 2, np.pi, -np.pi / 2,
                                     rng.uniform(-3, 3)])),)
                  if name in param else ())
        gates.append((name, params, qubits, None, bool(rng.integers(2))
                      and name not in ("CCNOT", "SWAP", "CNOT")))
    kraus = [np.eye(2)]
    tcirc = tc.Circuit([tc.Gate(*g) for g in gates])
    jcirc = jc.Circuit([jc.Gate(*g) for g in gates])
    tcirc.define_noisy_gate("H", None, kraus)
    jcirc.define_noisy_gate("H", None, kraus)
    got, want = tcomp.basic_compile(tcirc), jcomp.basic_compile(jcirc)
    assert gate_tuples(got) == gate_tuples(want)
    assert len(got) > len(gates)
    assert got.out() == want.out()


@pytest.mark.parametrize("n", [1, 2, 3])
def test_group_settings_and_programs_equal_jax(n):
    qubits = list(range(n))
    settings_t, settings_j = [], []
    for in_state in ("zeros", "mixed"):
        for t in tp.all_traceless_pauli_terms(qubits):
            if in_state == "zeros":
                st = zeros_state(qubits)
            else:
                st = TensorProductState([toe._OneQState(
                    "XYZ"[q % 3], q % 2, q) for q in qubits])
            s = ExperimentSetting(st, t)
            settings_t.append(s)
            settings_j.append(to_jax_setting(s))
    prog_t = tc.Circuit([tc.H(0), tc.RY(0.3, n - 1)])
    prog_j = jc.Circuit([jc.H(0), jc.RY(0.3, n - 1)])
    gt = group_settings(ObservablesExperiment(settings_t, prog_t))
    gj = joe.group_settings(joe.ObservablesExperiment(settings_j, prog_j))
    assert [[str(s) for s in g] for g in gt] == [[str(s) for s in g]
                                                 for g in gj]
    pt, mt = generate_experiment_programs(gt)
    pj, mj = joe.generate_experiment_programs(gj)
    assert mt == mj
    assert [gate_tuples(c) for c in pt] == [gate_tuples(c) for c in pj]


def test_bitarray_to_moments_equal_jax():
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, (997, 4))
    qubits = [3, 0, 5, 1]
    obs_t = [tp.PauliTerm({q: "XYZ"[rng.integers(3)]
                           for q in qubits if rng.random() < 0.6},
                          float(rng.choice([1.0, -1.0, 0.5])))
             for _ in range(12)] + [tp.PauliTerm({}, 2.0)]
    obs_j = [jp.PauliTerm.from_compact_str(o.compact_str()) for o in obs_t]
    for beta in (False, True):
        got = toe.bitarray_to_moments(bits, qubits, obs_t, beta)
        want = joe.bitarray_to_moments(bits, qubits, obs_j, beta)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


def test_json_round_trip_equals_jax(tmp_path):
    settings = [ExperimentSetting(plusX(0) * minusZ(1) * SIC1(2),
                                  str_to_pauli_term("YZX", [0, 1, 2]))] + [
        ExperimentSetting(zeros_state([0, 1]), t)
        for t in all_traceless_pauli_terms([0, 1])]
    prog = tc.Circuit([tc.H(0), tc.CNOT(0, 1), tc.RZ(0.25, 1),
                       tc.RX(-np.pi / 2, 2).dag()])
    expt = group_settings(ObservablesExperiment(settings, prog))
    fn_t, fn_j = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    to_json(fn_t, expt)
    jexpt = joe.group_settings(joe.ObservablesExperiment(
        [to_jax_setting(s) for s in settings],
        jc.Circuit([jc.H(0), jc.CNOT(0, 1), jc.RZ(0.25, 1),
                    jc.RX(-np.pi / 2, 2).dag()])))
    joe.to_json(fn_j, jexpt)
    assert open(fn_t).read() == open(fn_j).read()
    back = read_json(fn_t)
    assert back == expt
    assert gate_tuples(back.program) == gate_tuples(joe.read_json(fn_j).program)
    res = ExperimentResult(settings[0], expectation=np.float64(0.25),
                           total_counts=np.int64(100), std_err=0.1)
    assert json.dumps(res, cls=toe.OperatorEncoder) == json.dumps(
        joe.ExperimentResult(to_jax_setting(settings[0]), 0.25, 100, 0.1),
        cls=joe.OperatorEncoder)


def test_utils_helpers_equal_jax():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (7, 5))
    ints = tu.bit_arrays_to_ints(bits)
    assert np.array_equal(ints, ju.bit_arrays_to_ints(bits))
    assert np.array_equal(tu.ints_to_bit_arrays(ints, 5), bits)
    for row, i in zip(bits, ints):
        assert tu.bit_array_to_int(row) == ju.bit_array_to_int(row) == i
        assert tu.int_to_bit_array(int(i), 5) == list(row)
    for theta, phi in rng.uniform(0.1, 3, (5, 2)):
        a, b = tu.bloch_vector_to_standard_basis(theta, phi)
        assert (a, b) == ju.bloch_vector_to_standard_basis(theta, phi)
        assert np.allclose(tu.standard_basis_to_bloch_vector((a, b)),
                           (theta, phi))
    assert np.array_equal(tu.COMPUTATIONAL_BASIS.ops, ju.COMPUTATIONAL_BASIS.ops)
    assert np.array_equal(tu.pauli_basis_matrices(2), ju.pauli_basis_matrices(2))
    assert np.array_equal(tu.pack_shot_data(bits), ju.pack_shot_data(bits))
    term = tp.PauliTerm({0: "X", 2: "Y", 1: "Z"})
    jterm = jp.PauliTerm({0: "X", 2: "Y", 1: "Z"})
    for fn in ("prepare_prod_pauli_eigenstate", "measure_prod_pauli_eigenstate"):
        assert sorted(gate_tuples(getattr(tu, fn)(term))) == sorted(
            gate_tuples(getattr(ju, fn)(jterm)))
    assert gate_tuples(tu.bitstring_prep([0, 1, 2], [1, 0, 1], in_x_basis=True)) \
        == gate_tuples(ju.bitstring_prep([0, 1, 2], [1, 0, 1], in_x_basis=True))
    assert [gate_tuples(c) for c in tu.prepare_all_prod_pauli_eigenstates(term)] \
        == [gate_tuples(c) for c in ju.prepare_all_prod_pauli_eigenstates(jterm)]
    assert list(tu.progress_iter(range(3))) == [0, 1, 2]


# --- mirrors of tests/test_observable_estimation.py ------------------------

def test_pauli_term_algebra_and_parse():
    assert (sX(0) * tp.sY(0)).compact_str() == f"{1j}*Z0"
    assert (tp.sY(0) * sX(0)).coefficient == -1j
    assert (sX(0) * sX(0)).compact_str().endswith("*I")
    xz = sX(0) * sZ(1)
    assert xz.get_qubits() == [0, 1]
    assert xz[0] == "X" and xz[1] == "Z" and xz[2] == "I"
    t = PauliTerm.from_compact_str("(1+0j)*X0Y3")
    assert t[0] == "X" and t[3] == "Y"
    assert PauliTerm.from_compact_str(t.compact_str()) == t
    assert str_to_pauli_term("XIZ", [5, 6, 7])[7] == "Z"
    terms = all_traceless_pauli_terms([0, 1])
    assert len(terms) == 15 and all(len(t) > 0 for t in terms)


def test_setting_str_round_trips():
    setting = ExperimentSetting(plusX(0) * minusZ(1),
                                str_to_pauli_term("YZ", [0, 1]))
    assert ExperimentSetting.from_str(str(setting)) == setting
    setting = ExperimentSetting(SIC0(0) * SIC1(1), sZ(0) * sZ(1))
    assert ExperimentSetting.from_str(str(setting)) == setting


def test_max_weight_operator_and_state():
    assert _max_weight_operator([sX(0), sZ(1)]) is not None
    assert _max_weight_operator([sX(0), sZ(0)]) is None
    merged = _max_weight_operator([sX(0) * sZ(1), sZ(1) * sX(2)])
    assert merged == sX(0) * sZ(1) * sX(2)
    assert _max_weight_state([plusX(0), minusZ(1)]) is not None
    assert _max_weight_state([plusX(0), plusZ(0)]) is None


def test_group_settings_2q_state_tomo():
    settings = [ExperimentSetting(zeros_state([0, 1]), t)
                for t in all_traceless_pauli_terms([0, 1])]
    grouped = group_settings(ObservablesExperiment(settings, Circuit()),
                             "greedy")
    assert len(grouped) == 9
    assert sum(len(g) for g in grouped) == 15


def test_generate_experiment_programs_meas_qubits():
    settings = [ExperimentSetting(zeros_state([0]), sX(0)),
                ExperimentSetting(zeros_state([0]), sZ(0))]
    programs, meas_qubits = generate_experiment_programs(
        ObservablesExperiment(settings, program=Circuit([H(0)])),
        use_basic_compile=False)
    assert len(programs) == 2 and meas_qubits[0] == [0]


def test_shots_to_obs_moments():
    bits = np.array([[0, 0], [0, 1], [1, 1], [0, 1]])
    mean, _ = shots_to_obs_moments(bits, [0, 1], str_to_pauli_term("ZZ", [0, 1]))
    assert np.isclose(mean, 0.0)
    mean1, _ = shots_to_obs_moments(bits, [0, 1], sZ(1))
    assert np.isclose(mean1, (1 - 1 - 1 - 1) / 4)
    mean_i, var_i = shots_to_obs_moments(bits, [0, 1], PauliTerm((), 2.0))
    assert mean_i == 2.0 and var_i == 0
    m, v = shots_to_obs_moments(np.ones((10, 1), dtype=int), [0], sZ(0),
                                use_beta_dist_unbiased_prior=True)
    assert -1 < m < -0.8 and v > 0


def test_estimate_observables_bell_and_basic_compile():
    settings = [ExperimentSetting(zeros_state([0, 1]),
                                  str_to_pauli_term(s, [0, 1]))
                for s in ["XX", "YY", "ZZ"]]
    expt = ObservablesExperiment(settings, program=Circuit([H(0), CNOT(0, 1)]))
    results = list(estimate_observables(qvm(7), expt, num_shots=4000,
                                        use_basic_compile=False))
    by_obs = {r.setting.observable.id: r for r in results}
    assert abs(by_obs["X0X1"].expectation - 1.0) < 0.05
    assert abs(by_obs["Y0Y1"].expectation + 1.0) < 0.05
    assert abs(by_obs["Z0Z1"].expectation - 1.0) < 0.05
    assert all(r.total_counts == 4000 for r in results)
    expt = ObservablesExperiment([ExperimentSetting(plusX(0), sX(0))],
                                 program=Circuit())
    res = list(estimate_observables(qvm(8), expt, num_shots=2000,
                                    use_basic_compile=True))[0]
    assert abs(res.expectation - 1.0) < 0.05


def test_calibration_corrects_readout_error():
    q = qvm(9)
    program = Circuit()
    program.define_noisy_readout(0, p00=0.95, p11=0.85)
    expt = ObservablesExperiment([ExperimentSetting(minusZ(0), sZ(0))],
                                 program=program)
    raw = list(estimate_observables(q, expt, num_shots=30000, symm_type=-1,
                                    use_basic_compile=False))
    assert raw[0].expectation > -0.95
    cal = list(calibrate_observable_estimates(q, raw, num_shots=30000,
                                              noisy_program=program))
    assert abs(cal[0].expectation + 1.0) < 0.03
    assert cal[0].raw_expectation == raw[0].expectation
    assert cal[0].calibration_expectation < 1.0


def test_calibration_runs_in_first_appearance_order():
    """The calibration programs run in the order their observables first
    appear, whatever the string hashes, so a seeded QVM reproduces its
    draws across processes."""
    program = Circuit()
    program.define_noisy_readout(0, p00=0.9, p11=0.8)
    obs = [sZ(0), sX(0), PauliTerm({0: "Y"}), sZ(0) * 2.0]
    raw = [ExperimentResult(ExperimentSetting(zeros_state([0]), o),
                            expectation=0.5, total_counts=100, std_err=0.1)
           for o in obs]
    runs = []
    for _ in range(2):
        seen = []
        q = qvm(11)
        real = q.run_symmetrized_readout

        def record(prog, *args, **kwargs):
            seen.append(prog.out())
            return real(prog, *args, **kwargs)

        q.run_symmetrized_readout = record
        cal = list(calibrate_observable_estimates(q, raw, num_shots=200,
                                                  noisy_program=program))
        runs.append((seen, [r.calibration_expectation for r in cal]))
    assert runs[0] == runs[1]
    assert runs[0][0] == [str(get) for get in (
        tc.Circuit(), tc.Circuit([tc.RY(np.pi / 2, 0), tc.RY(-np.pi / 2, 0)]),
        tc.Circuit([tc.RX(-np.pi / 2, 0), tc.RX(np.pi / 2, 0)]))]


def test_ratio_variance_merge_and_results_by_groups():
    assert np.isclose(ratio_variance(1.0, 0.1, 1.0, 0.0), 0.1)
    assert np.isclose(ratio_variance(0.0, 0.1, 2.0, 0.3), 0.1 / 4)
    expt1 = ObservablesExperiment([ExperimentSetting(zeros_state([0]), sZ(0))],
                                  program=Circuit([H(0)]))
    expt2 = ObservablesExperiment([ExperimentSetting(zeros_state([1]), sX(1))],
                                  program=Circuit([X(1)]))
    merged = merge_disjoint_experiments([expt1, expt2])
    assert sum(len(g) for g in merged) == 2
    overlapping = ObservablesExperiment(
        [ExperimentSetting(zeros_state([0]), sX(0))], program=Circuit([X(0)]))
    with pytest.raises(ValueError):
        merge_disjoint_experiments([expt1, overlapping])
    r01 = ExperimentResult(ExperimentSetting(zeros_state([0, 1]),
                                             str_to_pauli_term("XX", [0, 1])),
                           expectation=1.0, total_counts=100)
    r2 = ExperimentResult(ExperimentSetting(zeros_state([2]), sZ(2)),
                          expectation=0.5, total_counts=100)
    groups = get_results_by_qubit_groups([r01, r2], [(0, 1), (2,)])
    assert groups[(0, 1)] == [r01] and groups[(2,)] == [r2]


def test_identity_only_observable_group():
    expt = ObservablesExperiment(
        [[ExperimentSetting(zeros_state([0]), PauliTerm({}, 2.0))]], Circuit())
    res = list(estimate_observables(qvm(0), expt, num_shots=50))
    assert res[0].expectation == 2.0 and res[0].std_err == 0.0


def test_greedy_grouping_needs_no_optional_package(monkeypatch):
    """The default greedy grouping and acquisition import neither
    networkx nor pandas nor tqdm (the card's machine has none of them)."""
    import builtins
    real = builtins.__import__

    def guarded(name, *args, **kwargs):
        if name.split(".")[0] in ("networkx", "pandas", "tqdm"):
            raise ImportError(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", guarded)
    settings = [ExperimentSetting(zeros_state([0, 1]), t)
                for t in all_traceless_pauli_terms([0, 1])]
    expt = group_settings(ObservablesExperiment(settings, Circuit([H(0)])))
    res = list(estimate_observables(qvm(1), expt, num_shots=20,
                                    show_progress_bar=True))
    assert len(res) == 15
