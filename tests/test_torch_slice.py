"""Slice 1 end to end: the port's ``tomography.pgdb_process_estimate_batched``
fused route against the JAX package's on the same counts, in float64, with
the parity schedule (the headline one is in test_torch_lanes_apg.py)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from forest_benchmarking_tpu import tomography as jax_tomo
from forest_benchmarking_tpu.benchmarks import synth_process_datasets
from forest_benchmarking_tpu_torch import tomography
from forest_benchmarking_tpu_torch.benchmarks import (
    inputs_from_numpy, process_tomo_A_matrix)
from forest_benchmarking_tpu_torch.benchmarks import (
    synth_process_datasets as torch_synth)
from forest_benchmarking_tpu_torch.ops import lanes_apg

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def parity_case():
    """B = 8 problems at 2000 shots, solved once by the JAX package."""
    a = process_tomo_A_matrix(2)
    n, chois = synth_process_datasets(jax.random.PRNGKey(33), jnp.asarray(a),
                                      4, 8, 2000, dtype=jnp.float64)
    want = np.asarray(jax_tomo.pgdb_process_estimate_batched(
        jnp.asarray(a), n, dim=4, method="apg", cp_method="pallas"))
    return a, np.asarray(n), np.asarray(chois), want


# A restart decision is a tie when the candidate's cost is within this many
# units of round-off of the previous cost, relative to the cost.
TIE = 32 * np.finfo(np.float64).eps


def _parity_solve(inp, flip=None):
    """The port's parity-schedule solve through the public route.

    Records every restart decision's relative cost margin
    ``(new_cost - old_cost) / |old_cost|`` as a (steps, B) array; where
    ``flip`` maps a step to problems, the restart rule sees those problems'
    candidate costs moved to the other side of the previous cost there."""
    margins = []
    rule = lanes_apg._restart

    def restart(t_next, new_cost, old_cost):
        step = len(margins)
        margins.append(((new_cost - old_cost) / old_cost.abs()).numpy())
        seen = new_cost.clone()
        for b in (flip or {}).get(step, ()):
            seen[b] = (old_cost[b] if new_cost[b] > old_cost[b] else
                       torch.nextafter(old_cost[b], old_cost[b] + 1))
        return rule(t_next, seen, old_cost)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lanes_apg, "_restart", restart)
        got = tomography.pgdb_process_estimate_batched(
            inp.a, inp.n, dim=4, method="apg", cp_method="pallas",
            fused_schedule="parity").numpy()
    return got, np.array(margins)


def test_parity_schedule_matches_jax(parity_case):
    """Bar: max abs <= 1e-9 per problem, or one tied restart away from it.

    Both packages run the same operations in the same order; summation order
    and XLA's fused multiply-adds differ, so trajectories part at f64
    round-off (~3e-13). The parity schedule runs into convergence, where the
    restart rule ``new_cost > old_cost`` compares costs equal to a few ulps;
    round-off decides such a tie, and a tie decided the other way moves the
    estimate by up to ~1e-7. So every problem further than 1e-9 from the JAX
    result must come within 1e-9 of it when the port takes the other branch
    at one of its tied decisions (within ``TIE``) and at nothing else."""
    a, n, chois, want = parity_case
    inp = inputs_from_numpy(a, n, device="cpu", dtype=torch.float64)
    got, margins = _parity_solve(inp)

    def dev(x):
        return np.abs(x - want).max(axis=(1, 2))

    parted = set(np.nonzero(dev(got) > 1e-9)[0].tolist())
    assert len(parted) <= len(want) // 2, dev(got)
    # each parted problem's tied steps, closest tie first
    ties = {b: sorted(np.nonzero(np.abs(margins[:, b]) <= TIE)[0].tolist(),
                      key=lambda k: abs(margins[k, b])) for b in parted}
    rank = 0
    while any(rank < len(ties[b]) for b in parted):
        flip = {}
        for b in parted:
            if rank < len(ties[b]):
                flip.setdefault(ties[b][rank], []).append(b)
        flipped = dev(_parity_solve(inp, flip)[0])
        parted -= {b for steps in flip.values() for b in steps
                   if flipped[b] <= 1e-9}
        rank += 1
    assert not parted, (dev(got), margins[:, sorted(parted)])
    # exactly trace preserving, and at the shot-noise floor of the truth
    pt = np.trace(got.reshape(-1, 4, 4, 4, 4), axis1=2, axis2=4)
    np.testing.assert_allclose(pt, np.broadcast_to(np.eye(4), pt.shape),
                               atol=1e-12)
    err = (np.linalg.norm(got - chois, axis=(1, 2))
           / np.linalg.norm(chois, axis=(1, 2)))
    assert err.mean() < 0.15


def test_fused_route_value_errors_match_jax():
    a = torch.tensor(process_tomo_A_matrix(2))
    n = torch.full((2, 1080), 1 / 540, dtype=torch.float64)
    bad = [dict(method="pgdb"), dict(fused_schedule="nope"),
           dict(trace_preserving=False), dict(return_iters=True)]
    for kw in bad:
        args = dict(dim=4, method="apg", cp_method="pallas")
        args.update(kw)
        with pytest.raises(ValueError):
            tomography.pgdb_process_estimate_batched(a, n, **args)
        with pytest.raises(ValueError):
            jax_tomo.pgdb_process_estimate_batched(jnp.asarray(a.numpy()),
                                                   jnp.asarray(n.numpy()),
                                                   **args)


def test_headline_rejected_for_non_2q():
    a = torch.tensor(process_tomo_A_matrix(1))
    n = torch.full((2, 36), 1 / 18, dtype=torch.float64)
    with pytest.raises(ValueError, match="dim=4"):
        tomography.pgdb_process_estimate_batched(a, n, dim=2, method="apg",
                                                 cp_method="pallas",
                                                 fused_schedule="headline")


@pytest.mark.parametrize("method, cp_method", [("pgdb", "eigh"),
                                               ("apg", "eigh"), ("apg", "ns")])
def test_unported_routes_name_the_roadmap_item(method, cp_method):
    a = torch.tensor(process_tomo_A_matrix(1))
    n = torch.full((1, 36), 1 / 18, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 5"):
        tomography.pgdb_process_estimate_batched(a, n, dim=2, method=method,
                                                 cp_method=cp_method)


@pytest.mark.parametrize("knob", ["stop_tol", "maxiter", "dyk_tol",
                                  "dyk_iters", "ns_iters", "loop_dyk_iters",
                                  "warm_start"])
def test_per_problem_solver_knobs_are_not_accepted(knob):
    """The fused route's schedule is static: the JAX function's knobs of
    the per-problem solvers would be ignored there, so the port refuses
    them."""
    a = torch.tensor(process_tomo_A_matrix(1))
    n = torch.full((1, 36), 1 / 18, dtype=torch.float64)
    with pytest.raises(TypeError, match=knob):
        tomography.pgdb_process_estimate_batched(
            a, n, dim=2, method="apg", cp_method="pallas", **{knob: 1})


def test_port_slice_on_its_own_data():
    """The whole slice inside the port: torch-drawn channels and counts,
    the headline solve, finite TP estimates near the truth."""
    a = torch.tensor(process_tomo_A_matrix(2))
    n, chois = torch_synth(torch.Generator().manual_seed(5), a, 4, 4, 2000,
                           dtype=torch.float64)
    est = tomography.pgdb_process_estimate_batched(
        a, n, dim=4, method="apg", cp_method="pallas",
        fused_schedule="headline")
    assert est.shape == (4, 16, 16) and torch.isfinite(est).all()
    pt = torch.diagonal(est.reshape(-1, 4, 4, 4, 4), dim1=2, dim2=4).sum(-1)
    assert (pt - torch.eye(4)).abs().max() < 1e-12
    err = torch.linalg.norm(est - chois, dim=(1, 2)) / torch.linalg.norm(
        chois, dim=(1, 2))
    assert err.mean() < 0.15
