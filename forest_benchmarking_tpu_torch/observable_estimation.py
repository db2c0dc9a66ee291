"""Observable estimation: the experiment data model, TPB grouping,
acquisition and calibration (host numpy).

Port of ``forest_benchmarking_tpu/observable_estimation.py``, with its
public names: the named one-qubit states and ``TensorProductState``,
``ExperimentSetting``, ``ObservablesExperiment`` and ``ExperimentResult``;
JSON in and out; grouping of settings that share a tensor product basis
(TPB); :func:`generate_experiment_programs`, which compiles each group into
one circuit; :func:`estimate_observables`, which runs those circuits on the
port's QVM (:mod:`forest_benchmarking_tpu_torch.sim`) with readout
symmetrization and takes every observable of a group from one bit array
(:func:`bitarray_to_moments`); and calibration, ``ratio_variance``,
``merge_disjoint_experiments`` and ``get_results_by_qubit_groups``.
``networkx`` (clique-removal grouping) is imported only where it is used;
the default greedy grouping needs nothing beyond numpy.
"""
from __future__ import annotations

import json
import re
import warnings
from dataclasses import dataclass
from json import JSONEncoder
from math import pi
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from forest_benchmarking_tpu_torch.circuits import Circuit, Gate, RX, RY, RZ
from forest_benchmarking_tpu_torch.paulis import PauliTerm
from forest_benchmarking_tpu_torch.utils import (progress_iter,
                                           transform_bit_moments_to_pauli)

__all__ = [
    "_OneQState", "TensorProductState", "SIC0", "SIC1", "SIC2", "SIC3",
    "plusX", "minusX", "plusY", "minusY", "plusZ", "minusZ", "zeros_state",
    "ExperimentSetting", "ObservablesExperiment", "OperatorEncoder",
    "to_json", "read_json", "ExperimentResult",
    "construct_tpb_graph", "group_settings_clique_removal",
    "group_settings_greedy", "group_settings",
    "generate_experiment_programs", "bitarray_to_moments", "shots_to_obs_moments",
    "estimate_observables", "get_calibration_program",
    "calibrate_observable_estimates", "ratio_variance",
    "merge_disjoint_experiments", "get_results_by_qubit_groups",
]


@dataclass(frozen=True)
class _OneQState:
    """A named one-qubit state: label in {SIC, X, Y, Z}, index, qubit."""
    label: str
    index: int
    qubit: int

    def __str__(self):
        if self.label in ["X", "Y", "Z"]:
            eigen_state = "+" if self.index == 0 else "-"
            return f"{self.label}{eigen_state}_{self.qubit}"
        return f"{self.label}{self.index}_{self.qubit}"

    @classmethod
    def from_str(cls, s: str) -> "_OneQState":
        ma = re.match(r"\s*(\w+)([\d+-])_(\d+)\s*", s)
        if ma is None:
            raise ValueError(f"Couldn't parse '{s}'")
        index = ma.group(2)
        index = {"+": 0, "-": 1}.get(index, None) if index in "+-" else int(index)
        return _OneQState(label=ma.group(1), index=index, qubit=int(ma.group(3)))


@dataclass(frozen=True)
class TensorProductState:
    """A tensor product of named one-qubit states."""
    states: Tuple[_OneQState, ...]

    def __init__(self, states=None):
        object.__setattr__(self, "states", tuple(states) if states else tuple())

    def __mul__(self, other: "TensorProductState") -> "TensorProductState":
        return TensorProductState(self.states + other.states)

    def __str__(self):
        return " * ".join(str(s) for s in self.states)

    def __repr__(self):
        return f"TensorProductState[{self}]"

    def __getitem__(self, qubit: int) -> _OneQState:
        for s in self.states:
            if s.qubit == qubit:
                return s
        raise IndexError()

    def __iter__(self):
        yield from self.states

    def __len__(self):
        return len(self.states)

    def states_as_set(self):
        return frozenset(self.states)

    def __eq__(self, other):
        if not isinstance(other, TensorProductState):
            return False
        return self.states_as_set() == other.states_as_set()

    def __hash__(self):
        return hash(self.states_as_set())

    @classmethod
    def from_str(cls, s: str) -> "TensorProductState":
        if s == "":
            return TensorProductState()
        return TensorProductState(tuple(_OneQState.from_str(x) for x in s.split("*")))


def SIC0(q):  # noqa: N802
    return TensorProductState((_OneQState("SIC", 0, q),))


def SIC1(q):  # noqa: N802
    return TensorProductState((_OneQState("SIC", 1, q),))


def SIC2(q):  # noqa: N802
    return TensorProductState((_OneQState("SIC", 2, q),))


def SIC3(q):  # noqa: N802
    return TensorProductState((_OneQState("SIC", 3, q),))


def plusX(q):  # noqa: N802
    return TensorProductState((_OneQState("X", 0, q),))


def minusX(q):  # noqa: N802
    return TensorProductState((_OneQState("X", 1, q),))


def plusY(q):  # noqa: N802
    return TensorProductState((_OneQState("Y", 0, q),))


def minusY(q):  # noqa: N802
    return TensorProductState((_OneQState("Y", 1, q),))


def plusZ(q):  # noqa: N802
    return TensorProductState((_OneQState("Z", 0, q),))


def minusZ(q):  # noqa: N802
    return TensorProductState((_OneQState("Z", 1, q),))


def zeros_state(qubits: Iterable[int]) -> TensorProductState:
    return TensorProductState(_OneQState("Z", 0, q) for q in qubits)


@dataclass(frozen=True, init=False)
class ExperimentSetting:
    """One (prepare in_state, measure observable) pair."""
    in_state: TensorProductState
    observable: PauliTerm

    def __init__(self, in_state: TensorProductState, observable: PauliTerm):
        object.__setattr__(self, "in_state", in_state)
        object.__setattr__(self, "observable", observable)

    def __str__(self):
        return f"{self.in_state}→{self.observable.compact_str()}"

    def __repr__(self):
        return f"ExperimentSetting[{self}]"

    def serializable(self):
        return str(self)

    @classmethod
    def from_str(cls, s: str) -> "ExperimentSetting":
        instr, outstr = s.split("→")
        return ExperimentSetting(in_state=TensorProductState.from_str(instr),
                                 observable=PauliTerm.from_compact_str(outstr))


class ObservablesExperiment:
    """Settings (grouped into simultaneously-estimable lists) + a core circuit."""

    def __init__(self,
                 settings: Union[List[ExperimentSetting], List[List[ExperimentSetting]]],
                 program: Circuit):
        if len(settings) > 0 and isinstance(settings[0], ExperimentSetting):
            settings = [[s] for s in settings]
        self._settings: List[List[ExperimentSetting]] = settings or []
        self.program = program

    def __len__(self):
        return len(self._settings)

    def __getitem__(self, item):
        return self._settings[item]

    def __setitem__(self, key, value):
        self._settings[key] = value

    def __delitem__(self, key):
        del self._settings[key]

    def __iter__(self):
        yield from self._settings

    def append(self, expts):
        if not isinstance(expts, list):
            expts = [expts]
        self._settings.append(expts)

    def extend(self, expts):
        self._settings.extend(expts)

    def setting_strings(self):
        yield from (f"{i}: " + ", ".join(str(s) for s in settings)
                    for i, settings in enumerate(self._settings))

    def settings_string(self, abbrev_after: Optional[int] = None):
        strs = list(self.setting_strings())
        if abbrev_after is not None and len(strs) > abbrev_after:
            first_n = abbrev_after // 2
            last_n = abbrev_after - first_n
            excluded = len(strs) - abbrev_after
            strs = strs[:first_n] + [f"... {excluded} not shown ..."] + strs[-last_n:]
        return "\n".join(strs)

    def __str__(self):
        return str(self.program) + "\n" + self.settings_string(abbrev_after=20)

    def __repr__(self):
        return f"ObservablesExperiment[{len(self)} groups]"

    def serializable(self):
        return {
            "type": "ObservablesExperiment",
            "settings": [[s.serializable() for s in group] for group in self._settings],
            "program": self.program.out(),
        }

    def __eq__(self, other):
        if not isinstance(other, ObservablesExperiment):
            return False
        return self.serializable() == other.serializable()


class OperatorEncoder(JSONEncoder):
    def default(self, o):
        if isinstance(o, (ExperimentSetting, ObservablesExperiment, ExperimentResult)):
            return o.serializable()
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        return o


def to_json(fn: str, obj) -> str:
    """Save experiments/results as JSON (reference observable_estimation.py:367)."""
    with open(fn, "w") as f:
        json.dump(obj, f, cls=OperatorEncoder, indent=2, ensure_ascii=False)
    return fn


def _parse_circuit(text: str) -> Circuit:
    """Parse the simple textual gate form produced by Circuit.out()."""
    gates = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        dagger = line.startswith("DAGGER ")
        if dagger:
            line = line[len("DAGGER "):]
        m = re.match(r"(\w+)(?:\(([^)]*)\))?((?:\s+\d+)+)$", line)
        if m is None:
            raise ValueError(f"Couldn't parse gate line '{line}'")
        name = m.group(1)
        params = tuple(float(x) for x in m.group(2).split(",")) if m.group(2) else ()
        qubits = tuple(int(x) for x in m.group(3).split())
        gates.append(Gate(name, params, qubits, dagger=dagger))
    return Circuit(gates)


def _operator_object_hook(obj):
    if obj.get("type") == "ObservablesExperiment":
        return ObservablesExperiment(
            [[ExperimentSetting.from_str(s) for s in settings]
             for settings in obj["settings"]],
            program=_parse_circuit(obj["program"]))
    return obj


def read_json(fn: str):
    with open(fn) as f:
        return json.load(f, object_hook=_operator_object_hook)


# ----------------------------- state preps ---------------------------------

def _one_q_sic_prep(index: int, qubit: int) -> Circuit:
    """Prepare the index-th SIC basis state (reference :392)."""
    if index == 0:
        return Circuit()
    theta = 2 * np.arccos(1 / np.sqrt(3))
    zx_plane_rotation = Circuit([RX(-pi / 2, qubit), RZ(theta - pi, qubit),
                                 RX(-pi / 2, qubit)])
    if index == 1:
        return zx_plane_rotation
    if index == 2:
        return zx_plane_rotation + RZ(-2 * pi / 3, qubit)
    if index == 3:
        return zx_plane_rotation + RZ(2 * pi / 3, qubit)
    raise ValueError(f"Bad SIC index: {index}")


def _one_q_pauli_prep(label: str, index: int, qubit: int) -> Circuit:
    """Prepare the index-th eigenstate of the Pauli given by label (:416)."""
    if index not in [0, 1]:
        raise ValueError(f"Bad Pauli index: {index}")
    if label == "X":
        return Circuit([RY(pi / 2 if index == 0 else -pi / 2, qubit)])
    if label == "Y":
        return Circuit([RX(-pi / 2 if index == 0 else pi / 2, qubit)])
    if label == "Z":
        return Circuit() if index == 0 else Circuit([RX(pi, qubit)])
    raise ValueError(f"Bad Pauli label: {label}")


def _one_q_state_prep(oneq_state: _OneQState) -> Circuit:
    label = oneq_state.label
    if label == "SIC":
        return _one_q_sic_prep(oneq_state.index, oneq_state.qubit)
    if label in ["X", "Y", "Z"]:
        return _one_q_pauli_prep(label, oneq_state.index, oneq_state.qubit)
    raise ValueError(f"Bad state label: {label}")


def _local_pauli_eig_meas(op: str, idx: int) -> Circuit:
    """Rotate the Pauli eigenbasis onto the Z measurement basis (:455)."""
    if op == "X":
        return Circuit([RY(-pi / 2, idx)])
    if op == "Y":
        return Circuit([RX(pi / 2, idx)])
    if op == "Z":
        return Circuit()
    raise ValueError(f"Unknown operation {op}")


# ------------------------------ TPB grouping --------------------------------
#
# Design: a setting is TPB-compatible with another iff, qubit by qubit, their
# one-qubit preparations and their one-qubit Pauli factors never disagree
# (absent counts as wildcard). We encode every setting as two small integer
# vectors over the union of qubits — prep-label ids and Pauli ids, 0 = absent —
# so compatibility becomes the elementwise predicate
# ``(a == 0) | (b == 0) | (a == b)``, evaluated for all pairs in one numpy
# broadcast instead of a Python double loop. Replaces the semantics of
# reference observable_estimation.py:470-691 with a vectorized formulation.

def _merge_disjointly(pairs) -> Optional[dict]:
    """Merge (key, value) pairs into one dict; None if any key is assigned two
    different values (i.e. the inputs do not share a tensor product basis)."""
    merged = {}
    for key, val in pairs:
        if merged.setdefault(key, val) != val:
            return None
    return merged


def _max_weight_operator(ops: Iterable[PauliTerm]) -> Optional[PauliTerm]:
    """The union Pauli term covering every input, or None if they conflict.

    E.g. XI and IZ merge to XZ; XI and ZI conflict. Semantics of reference
    observable_estimation.py:522-543.
    """
    merged = _merge_disjointly((q, p) for op in ops for q, p in op)
    return None if merged is None else PauliTerm(merged)


def _max_weight_state(states: Iterable[TensorProductState]) -> Optional[TensorProductState]:
    """The union tensor-product state, or None on a one-qubit conflict
    (reference observable_estimation.py:544-562)."""
    merged = _merge_disjointly((s.qubit, s) for state in states
                               for s in state.states)
    return None if merged is None else TensorProductState(list(merged.values()))


_OBS_CODE = {"X": 1, "Y": 2, "Z": 3}


def _setting_code_arrays(settings: Sequence[ExperimentSetting]):
    """Encode settings as (prep, obs) int arrays of shape (n_settings, n_qubits).

    Entry 0 means "this setting does not touch this qubit"; equal nonzero
    entries mean identical one-qubit prep / Pauli factor.
    """
    qubits = sorted({s.qubit for sett in settings for s in sett.in_state.states}
                    | {q for sett in settings for q in sett.observable.get_qubits()})
    col = {q: i for i, q in enumerate(qubits)}
    prep = np.zeros((len(settings), len(qubits)), dtype=np.int32)
    obs = np.zeros_like(prep)
    prep_ids: Dict[Tuple[str, int], int] = {}
    for i, sett in enumerate(settings):
        for s in sett.in_state.states:
            code = prep_ids.setdefault((s.label, s.index), len(prep_ids) + 1)
            prep[i, col[s.qubit]] = code
        for q, p in sett.observable:
            obs[i, col[q]] = _OBS_CODE[p]
    return prep, obs


def _codes_compatible(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise wildcard-aware agreement, reduced over the qubit axis."""
    return ((a == 0) | (b == 0) | (a == b)).all(axis=-1)


def construct_tpb_graph(obs_expt: ObservablesExperiment):
    """Graph with an edge when two settings are diagonal in a shared TPB.

    Edges come from one vectorized all-pairs compatibility evaluation on the
    code arrays (reference builds this graph pairwise, :470-496).
    """
    import networkx as nx
    uniq: List[ExperimentSetting] = []
    counts: Dict[ExperimentSetting, int] = {}
    for group in obs_expt:
        assert len(group) == 1, "already grouped?"
        sett = group[0]
        if sett not in counts:
            uniq.append(sett)
        counts[sett] = counts.get(sett, 0) + 1

    g = nx.Graph()
    for sett in uniq:
        g.add_node(sett, count=counts[sett])
    if len(uniq) > 1:
        prep, obs = _setting_code_arrays(uniq)
        compat = (_codes_compatible(prep[:, None, :], prep[None, :, :])
                  & _codes_compatible(obs[:, None, :], obs[None, :, :]))
        for i, j in zip(*np.nonzero(np.triu(compat, k=1))):
            g.add_edge(uniq[i], uniq[j])
    return g


def group_settings_clique_removal(experiment: ObservablesExperiment) -> ObservablesExperiment:
    """Group via max-clique removal on the TPB compatibility graph."""
    from networkx.algorithms.approximation.clique import clique_removal
    g = construct_tpb_graph(experiment)
    _, cliqs = clique_removal(g)
    new_cliqs = [[sett for sett in cliq for _ in range(g.nodes[sett]["count"])]
                 for cliq in cliqs]
    return ObservablesExperiment(new_cliqs, program=experiment.program)


class _TpbBucket:
    """A greedy group: running union codes + the member settings."""
    __slots__ = ("prep", "obs", "members")

    def __init__(self, prep: np.ndarray, obs: np.ndarray,
                 setting: ExperimentSetting):
        self.prep = prep.copy()
        self.obs = obs.copy()
        self.members = [setting]

    def try_absorb(self, prep: np.ndarray, obs: np.ndarray,
                   setting: ExperimentSetting) -> Optional[bool]:
        """Add the setting if compatible. Returns None on conflict, else
        whether the bucket's union basis grew (gained a new qubit factor)."""
        if not (_codes_compatible(self.prep, prep)
                and _codes_compatible(self.obs, obs)):
            return None
        filled_before = np.count_nonzero(self.prep) + np.count_nonzero(self.obs)
        np.maximum(self.prep, prep, out=self.prep)  # 0 is wildcard; equal elsewhere
        np.maximum(self.obs, obs, out=self.obs)
        self.members.append(setting)
        grew = (np.count_nonzero(self.prep) + np.count_nonzero(self.obs)
                > filled_before)
        return grew


def group_settings_greedy(obs_expt: ObservablesExperiment) -> ObservablesExperiment:
    """First-fit greedy grouping on the code arrays.

    Order semantics match reference _max_tpb_overlap (:564-613): settings scan
    existing groups in order and join the first compatible one; a group whose
    union basis grows is re-keyed, which (as a dict delete+insert there) moves
    it to the end of the scan order.
    """
    settings = []
    for group in obs_expt:
        assert len(group) == 1, "already grouped?"
        settings.append(group[0])
    preps, obses = _setting_code_arrays(settings)

    buckets: List[_TpbBucket] = []
    for sett, prep, obs in zip(settings, preps, obses):
        for pos, bucket in enumerate(buckets):
            grew = bucket.try_absorb(prep, obs, sett)
            if grew is not None:
                if grew:
                    buckets.append(buckets.pop(pos))
                break
        else:
            buckets.append(_TpbBucket(prep, obs, sett))
    return ObservablesExperiment([b.members for b in buckets],
                                 program=obs_expt.program)


def group_settings(obs_expt: ObservablesExperiment,
                   method: str = "greedy") -> ObservablesExperiment:
    """Group settings diagonal in a shared TPB (reference :629)."""
    allowed = ["greedy", "clique-removal"]
    assert method in allowed, f"'method' should be one of {allowed}."
    if method == "greedy":
        return group_settings_greedy(obs_expt)
    return group_settings_clique_removal(obs_expt)


# ------------------------------- results ------------------------------------

@dataclass(frozen=True)
class ExperimentResult:
    """Expectation +- std_err for one setting, with calibration fields."""
    setting: ExperimentSetting
    expectation: Union[float, complex]
    total_counts: int
    std_err: Union[float, complex] = None
    raw_expectation: Union[float, complex] = None
    raw_std_err: float = None
    calibration_expectation: Union[float, complex] = None
    calibration_std_err: Union[float, complex] = None
    calibration_counts: int = None

    def __str__(self):
        return f"{self.setting}: {self.expectation} +- {self.std_err}"

    def __repr__(self):
        return f"ExperimentResult[{self}]"

    def serializable(self):
        return {
            "type": "ExperimentResult",
            "setting": str(self.setting),
            "expectation": self.expectation,
            "std_err": self.std_err,
            "total_counts": self.total_counts,
            "raw_expectation": self.raw_expectation,
            "raw_std_err": self.raw_std_err,
            "calibration_expectation": self.calibration_expectation,
            "calibration_std_err": self.calibration_std_err,
            "calibration_counts": self.calibration_counts,
        }


# ------------------------------ acquisition ---------------------------------

def generate_experiment_programs(obs_expt: ObservablesExperiment,
                                 active_reset: bool = False,
                                 use_basic_compile: bool = True) \
        -> Tuple[List[Circuit], List[List[int]]]:
    """Build the circuit for each grouped setting (prep + core + meas rotation).

    ``active_reset`` is accepted for API parity; the in-process simulator always
    starts from |0..0> so it is a no-op.
    """
    from forest_benchmarking_tpu_torch.compilation import basic_compile
    programs = []
    meas_qubits = []
    for settings in obs_expt:
        total = Circuit()
        max_weight_in = _max_weight_state(s.in_state for s in settings)
        if max_weight_in is None:
            raise ValueError("Input states are not compatible. Re-group the "
                             "experiment settings so that groups of parallel "
                             "settings have compatible input states.")
        for oneq_state in max_weight_in.states:
            total += _one_q_state_prep(oneq_state)
        total += obs_expt.program
        max_weight_out = _max_weight_operator(s.observable for s in settings)
        if max_weight_out is None:
            raise ValueError("Observables not compatible. Re-group the "
                             "experiment settings so that groups of parallel "
                             "settings have compatible observables.")
        for qubit, op_str in max_weight_out:
            total += _local_pauli_eig_meas(op_str, qubit)
        programs.append(basic_compile(total) if use_basic_compile else total)
        meas_qubits.append(max_weight_out.get_qubits())
    return programs, meas_qubits


def bitarray_to_moments(bitarray: np.ndarray, qubits: Sequence[int],
                        observables: Sequence[PauliTerm],
                        use_beta_dist_unbiased_prior: bool = False) \
        -> Tuple[np.ndarray, np.ndarray]:
    """Means and variances of MANY observables from one shot bit array.

    One vectorized pass evaluates every observable simultaneously: the ±1
    value of a Pauli product on a bitstring is (-1)^parity of the bits under
    the observable's qubit mask, so a single {0,1} matmul
    ``bitarray @ masks`` yields all parities at once. This replaces the
    per-observable column-slice/product of reference
    observable_estimation.py:804-855 and is the fast path wide experiments
    (many settings per group) ride in ``estimate_observables``.

    :param bitarray: (num_shots, len(qubits)) array of 0/1 measurement results.
    :param qubits: qubit labels for the bitarray columns, in column order.
    :param observables: Pauli terms; factors must act on qubits in ``qubits``
        (identity terms allowed). Coefficients must be real.
    :param use_beta_dist_unbiased_prior: estimate Bernoulli moments from a
        Beta(n+ + 1, n- + 1) posterior (unbiased Bayes prior; precludes
        var = 0) instead of the empirical moments.
    :return: (means, variances), each of shape (len(observables),).
    """
    shots, ncols = bitarray.shape
    if len(qubits) == 0 and ncols > 0:
        # identity-only groups: the runner pads the measurement register to
        # at least one qubit (`meas_qs or [0]`); drop the dummy column(s) so
        # the identity branch below returns (coefficient, 0) as the
        # reference's early-return does (observable_estimation.py:826)
        bitarray = bitarray[:, :0]
        ncols = 0
    assert ncols == len(qubits), \
        "qubits should label each column of the bitarray"
    col = {q: i for i, q in enumerate(qubits)}

    coeffs = np.empty(len(observables))
    masks = np.zeros((ncols, len(observables)), dtype=np.int64)
    for j, obs in enumerate(observables):
        c = complex(obs.coefficient)
        if not np.isclose(c.imag, 0):
            raise ValueError(
                "The coefficient of an observable should not be complex.")
        coeffs[j] = c.real
        for q, _ in obs:
            masks[col[q], j] = 1

    parities = (bitarray.astype(np.int64) @ masks) & 1  # (shots, n_obs)
    vals = 1 - 2 * parities

    if use_beta_dist_unbiased_prior:
        n_plus = np.count_nonzero(vals == 1, axis=0)
        a, b = n_plus + 1.0, (shots - n_plus) + 1.0
        bern_mean = a / (a + b)  # Beta posterior moments in closed form
        bern_var = a * b / ((a + b) ** 2 * (a + b + 1))
        means, variances = transform_bit_moments_to_pauli(bern_mean, bern_var)
        means = coeffs * means
        variances = coeffs ** 2 * variances
    else:
        means = coeffs * vals.mean(axis=0)
        variances = coeffs ** 2 * vals.var(axis=0) / shots

    is_identity = masks.sum(axis=0) == 0
    means = np.where(is_identity, coeffs, means)
    variances = np.where(is_identity, 0.0, variances)
    return means, variances


def shots_to_obs_moments(bitarray: np.ndarray, qubits: List[int],
                         observable: PauliTerm,
                         use_beta_dist_unbiased_prior: bool = False) \
        -> Tuple[float, float]:
    """Mean and variance of one observable from a (shots, len(qubits)) bit
    array — the single-observable view of ``bitarray_to_moments``."""
    means, variances = bitarray_to_moments(
        bitarray, qubits, [observable], use_beta_dist_unbiased_prior)
    return float(means[0]), float(variances[0])


def estimate_observables(qc, obs_expt: ObservablesExperiment,
                         num_shots: int = 500, symm_type: int = 0,
                         active_reset: bool = False,
                         show_progress_bar: bool = False,
                         use_basic_compile: bool = True) \
        -> Iterable[ExperimentResult]:
    """Estimate expectation and std_err for every setting of the experiment.

    ``qc`` is a :class:`forest_benchmarking_tpu_torch.sim.QVM` (in-process;
    no RPC boundary): the circuits run on its device, and the moments of
    each group's shots are taken on the host.
    """
    programs, meas_qubits = generate_experiment_programs(
        obs_expt, active_reset, use_basic_compile=use_basic_compile)
    groups = list(zip(programs, meas_qubits, obs_expt))
    for prog, meas_qs, settings in progress_iter(groups, show_progress_bar,
                                                 desc="estimate_observables"):
        results = qc.run_symmetrized_readout(prog, num_shots, symm_type,
                                             meas_qs or [0])
        # one vectorized pass over the bitarray evaluates every observable
        # of the group simultaneously
        means, variances = bitarray_to_moments(
            results, meas_qs, [s.observable for s in settings])
        for setting, obs_mean, obs_var in zip(settings, means, variances):
            yield ExperimentResult(
                setting=setting,
                expectation=float(obs_mean),
                std_err=float(np.sqrt(obs_var)),
                total_counts=len(results),
            )


def get_calibration_program(observable: PauliTerm,
                            noisy_program: Optional[Circuit] = None,
                            active_reset: bool = False) -> Circuit:
    """Circuit preparing/measuring the +1 eigenstate of the observable (:927).

    Noise annotations (gate noise, readout confusion) are inherited from
    ``noisy_program`` — the analog of PRAGMA inheritance in the reference.
    """
    calibr = Circuit()
    if noisy_program is not None:
        calibr.gate_noise = list(noisy_program.gate_noise)
        calibr.readout_confusion = dict(noisy_program.readout_confusion)
    for q, op in observable.operations_as_set():
        calibr += _one_q_pauli_prep(label=op, index=0, qubit=q)
    for q, op in observable.operations_as_set():
        calibr += _local_pauli_eig_meas(op, q)
    return calibr


def calibrate_observable_estimates(qc, expt_results: List[ExperimentResult],
                                   num_shots: int = 500, symm_type: int = -1,
                                   noisy_program: Optional[Circuit] = None,
                                   active_reset: bool = False,
                                   show_progress_bar: bool = False) \
        -> Iterable[ExperimentResult]:
    """Scale expectations by measured +1-eigenstate calibration values (:964).

    The calibration programs run in the order of their observables' first
    appearance, so a seeded QVM gives the same draws in every process (the
    JAX package runs them in the order of a ``set``, which string-hash
    randomization changes from process to process).
    """
    observables = [res.setting.observable.copy(coefficient=1.0)
                   for res in expt_results]
    observables = list(dict.fromkeys(observables))

    calibrations = {}
    for obs in progress_iter(observables, show_progress_bar,
                             desc="calibrate_observable_estimates"):
        prog = get_calibration_program(obs, noisy_program, active_reset)
        meas_qs = obs.get_qubits()
        results = qc.run_symmetrized_readout(prog, num_shots, symm_type,
                                             meas_qs or [0])
        obs_mean, obs_var = shots_to_obs_moments(results, meas_qs, obs)
        calibrations[obs.operations_as_set()] = (obs_mean, obs_var, len(results))

    for expt_result in expt_results:
        obs = expt_result.setting.observable
        if -1 < symm_type < len(obs.get_qubits()):
            warnings.warn(f"Calibration of observable {obs} currently not "
                          f"supported since it acts on more qubits than the "
                          f"symm_type {symm_type}.")
        obs_mean, obs_var, counts = calibrations[obs.operations_as_set()]
        result_mean = expt_result.expectation
        result_var = expt_result.std_err ** 2
        corrected_mean = result_mean / obs_mean
        corrected_var = ratio_variance(result_mean, result_var, obs_mean, obs_var)
        yield ExperimentResult(
            setting=expt_result.setting,
            expectation=corrected_mean,
            std_err=float(np.sqrt(corrected_var)),
            total_counts=expt_result.total_counts,
            raw_expectation=result_mean,
            raw_std_err=expt_result.std_err,
            calibration_expectation=obs_mean,
            calibration_std_err=float(np.sqrt(obs_var)),
            calibration_counts=counts,
        )


def ratio_variance(a, var_a, b, var_b):
    r"""Var[A/B] ~ var_a / b^2 + a^2 var_b / b^4 (independent A, B; :1052)."""
    return var_a / b ** 2 + (a ** 2 * var_b) / b ** 4


def merge_disjoint_experiments(experiments: List[ObservablesExperiment],
                               group_merged_settings: bool = True) \
        -> ObservablesExperiment:
    """Merge experiments on disjoint qubit sets into one (reference :1093)."""
    used_qubits = set()
    for expt in experiments:
        if expt.program.get_qubits() & used_qubits:
            raise ValueError("Experiment programs act on some shared set of "
                             "qubits and cannot be merged unambiguously.")
        used_qubits |= expt.program.get_qubits()

    all_settings = [s for expt in experiments for group in expt for s in group]
    merged_program = Circuit()
    for expt in experiments:
        merged_program = merged_program + expt.program
    merged = ObservablesExperiment(all_settings, merged_program)
    if group_merged_settings:
        merged = group_settings(merged)
    return merged


def get_results_by_qubit_groups(results: Iterable[ExperimentResult],
                                qubit_groups: Sequence[Sequence[int]]) \
        -> Dict[Tuple[int, ...], List[ExperimentResult]]:
    """Bucket results by which qubit group their observable acts within (:1145)."""
    qubit_groups = [tuple(sorted(g)) for g in qubit_groups]
    out = {group: [] for group in qubit_groups}
    for res in results:
        res_qs = res.setting.observable.get_qubits()
        for group in qubit_groups:
            if set(res_qs).issubset(set(group)):
                out[group].append(res)
    return out
