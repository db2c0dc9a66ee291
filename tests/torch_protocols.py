"""Shared helpers of the port's protocol tests (RB, spectroscopy, DFE, RPE,
readout): moving circuits, experiments and results into the JAX package,
comparing gate lists, and holding the port's QVM probabilities to the JAX
package's float64 simulator on the programs a protocol runs."""
from dataclasses import fields

import numpy as np

import forest_benchmarking_tpu.circuits as jcirc
import forest_benchmarking_tpu.observable_estimation as joe
from forest_benchmarking_tpu.sim import QVM as JaxQVM
from forest_benchmarking_tpu_torch.observable_estimation import (
    generate_experiment_programs)
from forest_benchmarking_tpu_torch.sim import QVM

PROB_BAR = 1e-12   # port against JAX probabilities, both float64


def gate_list(circuits):
    """Every gate of a list of circuits as (name, params, qubits, dagger,
    matrix)."""
    return [(g.name, tuple(float(p) for p in g.params), tuple(g.qubits),
             bool(g.dagger), g.matrix) for c in circuits for g in c.gates]


def same_gates(ours, theirs, bar=1e-12):
    """Equal names, qubits, daggers and matrices; parameters within bar."""
    a, b = gate_list(ours), gate_list(theirs)
    return len(a) == len(b) and all(
        ga[0] == gb[0] and ga[2:] == gb[2:] and len(ga[1]) == len(gb[1])
        and all(abs(x - y) <= bar for x, y in zip(ga[1], gb[1]))
        for ga, gb in zip(a, b))


def to_jax_circuit(circuit):
    """The same circuit, gate noise and readout confusion included, in the
    JAX package."""
    return jcirc.Circuit(
        [jcirc.Gate(g.name, tuple(g.params), tuple(g.qubits),
                    dagger=g.dagger, matrix=g.matrix)
         for g in circuit.gates],
        gate_noise=[(n, q, np.asarray(k)) for n, q, k in circuit.gate_noise],
        readout_confusion={q: np.asarray(m) for q, m in
                           circuit.readout_confusion.items()})


def experiment_signature(expt):
    """An experiment's grouped settings (as strings) and its program's
    gates, comparable across the packages."""
    return ([[str(s) for s in group] for group in expt],
            gate_list([expt.program]))


def jax_results(results):
    """The same results in the JAX package: the settings through their
    string form, every number as it is."""
    out = []
    for r in results:
        kw = {f.name: getattr(r, f.name) for f in fields(r)}
        kw["setting"] = joe.ExperimentSetting.from_str(str(r.setting))
        out.append(joe.ExperimentResult(**kw))
    return out


def max_probability_gap(programs, meas_qubits, **qvm_kw):
    """The largest |port - JAX| probability over the programs, with the
    QVMs' ``t1s``/``t2s`` from ``qvm_kw``."""
    ours, theirs = QVM(device="cpu", **qvm_kw), JaxQVM(**qvm_kw)
    return max(float(np.max(np.abs(
        ours.probabilities(p, q).numpy()
        - np.asarray(theirs.probabilities(to_jax_circuit(p), q)))))
        for p, q in zip(programs, meas_qubits))


def experiment_probability_gap(expts, **qvm_kw):
    """:func:`max_probability_gap` over every program of the experiments."""
    programs, meas = [], []
    for expt in expts:
        p, m = generate_experiment_programs(expt)
        programs += p
        meas += m
    return max_probability_gap(programs, meas, **qvm_kw)
