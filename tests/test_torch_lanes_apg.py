"""The port's fused APG solver (plain PyTorch version) against the JAX
package's ``ops/lanes_apg.py`` and the numpy oracles, in float64, at dim=4
(headline schedule) and dim=2 (default schedule); and the kernel sources'
tables and the loader's library names.

The dim=4 parity-schedule comparison lives in test_torch_slice.py, so that
the JAX CPU compiles run on different workers.
"""
import contextlib
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from forest_benchmarking_tpu.benchmarks import synth_process_datasets
from forest_benchmarking_tpu.ops import lanes_apg as jax_lanes
from forest_benchmarking_tpu_torch import kernels, tomography
from forest_benchmarking_tpu_torch.benchmarks import (
    inputs_from_numpy, process_tomo_A_matrix)
from forest_benchmarking_tpu_torch.ops import lanes_apg
from oracles import np_proj_cp, np_proj_tp

torch.set_num_threads(1)

EPS64 = 1e-30
ROOT = Path(__file__).resolve().parents[1]


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
    """The JAX package's schedule forms are carried: a phase is
    (outer, dykstra_iters, sweeps) or (outer, dykstra_iters, sweeps,
    sweeps_rest), and ``final_sweeps_rest`` is taken; a phase of another
    length raises, in the wrapper and in the plain version."""
    a = torch.tensor(process_tomo_A_matrix(1))
    n = torch.full((1, 36), 1 / 36, dtype=torch.float64)
    out = lanes_apg.apg_fused(a, n, 2, phases=((2, 1, 1, 0),),
                              final_sweeps_rest=0)
    assert out.shape == (1, 4, 4) and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="sweeps_rest"):
        lanes_apg.apg_fused(a, n, 2, phases=((2, 1),))
    z = torch.zeros(1, 4, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="sweeps_rest"):
        lanes_apg.apg_fused_reference(a.real, a.imag, n, z, z, dim=2,
                                      phases=((2, 1, 1, 0, 0),))


SPLIT_SCHEDULE = dict(phases=((3, 2, 1, 0), (2, 1, 1), (2, 3, 2, 1)),
                      init_iters=2, init_sweeps=3, final_iters=3,
                      final_sweeps=2, final_sweeps_rest=1)


def test_split_sweeps_match_jax():
    """A schedule that uses both forms: phases with and without a fourth
    entry (0 reuses the eigenbasis; 1 after 2), and ``final_sweeps_rest``.
    The plain port against JAX ``apg_fused(use_pallas=False)`` in f64 on
    the same counts, within 1e-9; the form changes the result (it is not
    ignored), and ``iters == 0`` stays a no-op in the split case."""
    a = process_tomo_A_matrix(1)
    n, _ = synth_process_datasets(jax.random.PRNGKey(29), jnp.asarray(a), 2, 6,
                                  2000, dtype=jnp.float64)
    want = np.asarray(jax_lanes.apg_fused(jnp.asarray(a), n, dim=2,
                                          use_pallas=False, **SPLIT_SCHEDULE))
    inp = inputs_from_numpy(a, np.asarray(n), device="cpu",
                            dtype=torch.float64)
    got = lanes_apg.apg_fused(inp.a, inp.n, 2, **SPLIT_SCHEDULE)
    assert np.max(np.abs(got.numpy() - want)) <= 1e-9
    uniform = dict(SPLIT_SCHEDULE, phases=tuple(p[:3] for p in
                                                SPLIT_SCHEDULE["phases"]),
                   final_sweeps_rest=None)
    other = lanes_apg.apg_fused(inp.a, inp.n, 2, **uniform)
    assert np.max(np.abs(other.numpy() - want)) > 1e-6
    no_op = dict(SPLIT_SCHEDULE, phases=((2, 0, 1, 0),), final_iters=0)
    assert torch.equal(lanes_apg.apg_fused(inp.a, inp.n, 2, **no_op),
                       lanes_apg.apg_fused(inp.a, inp.n, 2,
                                           **dict(no_op, phases=((2, 0, 1),),
                                                  final_sweeps_rest=None)))


def test_split_sweeps_flop_count():
    """The first Dykstra iteration of a projection is counted at its
    ``sweeps``, the others at ``sweeps_rest``; the shipped schedules' count
    is unchanged by the form."""
    n = 16
    sweep = 36.0 * n * n * (n - 1)
    base = dict(phases=((2, 3, 2),), init_iters=0, final_iters=0)
    split = dict(base, phases=((2, 3, 2, 0),))
    assert (lanes_apg.apg_fused_flops_per_solve(1080, **base)
            - lanes_apg.apg_fused_flops_per_solve(1080, **split)
            == pytest.approx(2 * 2 * 2 * sweep))
    fin = dict(phases=(), init_iters=0, final_iters=4, final_sweeps=3)
    assert (lanes_apg.apg_fused_flops_per_solve(1080, **fin)
            - lanes_apg.apg_fused_flops_per_solve(
                1080, **fin, final_sweeps_rest=1)
            == pytest.approx(3 * 2 * sweep))
    cfg = lanes_apg.HEADLINE_TUNED_2Q
    four = dict(cfg, phases=tuple(p + (p[2],) for p in cfg["phases"]),
                final_sweeps_rest=cfg["final_sweeps"])
    assert (lanes_apg.apg_fused_flops_per_solve(1080, **four)
            == pytest.approx(lanes_apg.apg_fused_flops_per_solve(1080, **cfg)))


@pytest.mark.parametrize("dim", [2, 4])
def test_use_pallas_keyword_changes_nothing_on_the_cpu(dim):
    """``use_pallas`` (the JAX package's switch) is accepted; on CPU
    tensors both settings run the plain version, bitwise alike, and launch
    nothing."""
    a = process_tomo_A_matrix(dim // 2)
    rng = np.random.default_rng(dim)
    counts = rng.random((3, a.shape[0]))
    inp = inputs_from_numpy(a, counts / counts.sum(1, keepdims=True),
                            device="cpu", dtype=torch.float64)
    cfg = dict(phases=((2, 1, 1),), init_iters=1, final_iters=1)
    before = lanes_apg.apg_fused.launches
    on = lanes_apg.apg_fused(inp.a, inp.n, dim, use_pallas=True, **cfg)
    off = lanes_apg.apg_fused(inp.a, inp.n, dim, use_pallas=False, **cfg)
    assert torch.equal(on, off)
    assert torch.equal(on, lanes_apg.apg_fused(inp.a, inp.n, dim, **cfg))
    assert lanes_apg.apg_fused.launches == before == 0


def test_cuda_source_tables_match_python():
    """The kernel's round-robin pair table (n = 16, the dim=4 kernel's; the
    dim=2 and CP kernels follow rules pinned below) and schedule width
    equal the Python side's (the kernel runs only on the card; its source
    can be read anywhere)."""
    src = (kernels.CSRC / "apg_fused.cu").read_text()
    body = src.split("c_pairs16[15][8][2] = {", 1)[1].split("};", 1)[0]
    pairs = [tuple(map(int, m))
             for m in re.findall(r"\{(\d+), (\d+)\}", body)]
    assert pairs == [p for rnd in lanes_apg._round_robin_pairs(16)
                     for p in rnd]
    width = int(re.search(r"#define APG_MAX_PHASES (\d+)", src).group(1))
    assert width == kernels.MAX_PHASES
    fields = [f[0] for f in kernels.ApgSchedule._fields_]
    parts = [src.split(f"struct {name} {{", 1)[1].split("};", 1)[0]
             for name in ("ApgPhases", "ApgSweepsRest")]
    assert src.split("struct ApgSchedule {", 1)[1].split("};", 1)[0].split() \
        == ["ApgPhases", "phases;", "ApgSweepsRest", "rest;"]
    assert [f for part in parts for f in re.findall(
        r"(\w+)(?:\[APG_MAX_PHASES\])?[,;]", part)] == fields


def test_library_name_follows_included_headers(tmp_path):
    """A library is named by the source and every file under ``csrc/`` it
    includes, so an edited header cannot leave a stale library loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "apg_fused.cu").write_bytes(
        (kernels.CSRC / "apg_fused.cu").read_bytes())
    assert (kernels._lib_paths(csrc, tmp_path)["apg_fused"].name
            == kernels._lib_paths()["apg_fused"].name)
    (csrc / "sweep.cuh").write_text("// shared sweep v1\n")
    (csrc / "inner.cuh").write_text("// inner v1\n")
    (csrc / "unused.cuh").write_text("// not included\n")
    (csrc / "k.cu").write_text('#include <cuda_runtime.h>\n'
                               '#include "sweep.cuh"\n')

    def name():
        return kernels._lib_paths(csrc, tmp_path)["k"].name

    first = name()
    (csrc / "unused.cuh").write_text("// edited, still not included\n")
    assert name() == first
    (csrc / "sweep.cuh").write_text("// shared sweep v2\n")
    second = name()
    assert second != first
    (csrc / "sweep.cuh").write_text('#include "inner.cuh"\n')
    third = name()
    (csrc / "inner.cuh").write_text("// inner v2\n")
    assert len({first, second, third, name()}) == 4


@pytest.fixture(scope="module")
def fused_1q_case():
    """B = 8 one-qubit problems at 2000 shots, solved once by the JAX
    package with the default (parity) schedule."""
    a = process_tomo_A_matrix(1)
    n, _ = synth_process_datasets(jax.random.PRNGKey(23), jnp.asarray(a), 2, 8,
                                  2000, dtype=jnp.float64)
    want = np.asarray(jax_lanes.apg_fused(jnp.asarray(a), n, dim=2,
                                          use_pallas=False))
    return a, np.asarray(n), want


def test_apg_fused_1q_matches_jax(fused_1q_case):
    """dim=2, default schedule (``PARITY_PHASES``, mu = 3/8): the plain port
    against JAX ``apg_fused(dim=2, use_pallas=False)`` in f64 within 1e-9;
    the ``cp_method="pallas"`` route at dim=2 is the same call."""
    a, n, want = fused_1q_case
    inp = inputs_from_numpy(a, n, device="cpu", dtype=torch.float64)
    got = lanes_apg.apg_fused(inp.a, inp.n, 2)
    assert got.dtype == torch.complex128 and got.shape == (8, 4, 4)
    assert np.max(np.abs(got.numpy() - want)) <= 1e-9
    via_route = tomography.pgdb_process_estimate_batched(
        inp.a, inp.n, dim=2, method="apg", cp_method="pallas")
    assert torch.equal(via_route, got)


# (schedule, dim, rows of A, passes over A): at dim = 4 1 + 2 a step (5
# and 44 steps), at dim = 2 1 + 3 a step (the default schedule's 50)
PASSES = [("HEADLINE_TUNED_2Q", 4, 1080, 11), ("PARITY_TUNED_2Q", 4, 1080, 89),
          ("PARITY_PHASES", 2, 36, 151)]


def _schedule(name):
    got = getattr(lanes_apg, name)
    return got if isinstance(got, dict) else dict(phases=got)


@pytest.mark.parametrize("schedule,dim,rows,passes", PASSES)
def test_flop_count_passes_over_a(schedule, dim, rows, passes):
    """The dim = 4 kernel reads A once for the first cost and twice per outer
    step (p at y is combined from the last two cost passes' products); the
    dim = 2 kernel three times per step. Each pass is 4 R n^2 operations."""
    cfg = _schedule(schedule)
    a_part = (lanes_apg.apg_fused_flops_per_solve(rows, dim, **cfg)
              - lanes_apg.apg_fused_flops_per_solve(0, dim, **cfg))
    assert a_part == passes * 4 * rows * dim ** 4


@pytest.mark.parametrize("problems_per_block", [1, 2, 4])
@pytest.mark.parametrize("schedule,dim,rows,passes", PASSES)
def test_l2_bytes_per_solve(schedule, dim, rows, passes, problems_per_block):
    """Each pass reads one copy of A's two f32 planes (2 x 1080 x 256 x 4 =
    2,211,840 bytes at dim = 4, 2 x 36 x 16 x 4 = 4,608 at dim = 2), once
    for all the problems of a block."""
    cfg = _schedule(schedule)
    got = lanes_apg.apg_fused_l2_bytes_per_solve(rows, dim,
                                                 problems_per_block, **cfg)
    assert got == passes * 2 * rows * dim ** 4 * 4 / problems_per_block


def _script(path):
    """The module of a script of the repository, imported from its file."""
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_smoke_check_counts_the_kernels_problems_per_block():
    """chip_smoke.py's bytes of A per solve use the four problems a block
    of the dim = 4 kernel holds."""
    src = (kernels.CSRC / "apg_fused.cu").read_text()
    held = int(re.search(r"constexpr int PROBLEMS_2Q = (\d+);", src).group(1))
    smoke = _script(ROOT / "chip_smoke.py")
    assert smoke.PROBLEMS_PER_BLOCK_2Q == held == 4


def test_smoke_and_card_tail_batches_leave_a_part_empty_last_unit():
    """The tail batches of chip_smoke.py and of the on-card tests leave the
    last block of the dim = 2 kernel and its last warp part empty (a problem
    is a quad of lanes, eight a warp), and the last block of the CP kernel
    part empty (a matrix is a warp); the per-block constants they use are
    the kernel source's."""
    src = (kernels.CSRC / "apg_fused.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    per_1q, per_cp = const("PROBLEMS_1Q"), const("CP_PER_BLOCK")
    assert const("THREADS") == 4 * per_1q == 32 * per_cp
    smoke = _script(ROOT / "chip_smoke.py")
    assert (smoke.PROBLEMS_PER_BLOCK_1Q, smoke.CP_PER_BLOCK) == (per_1q,
                                                                 per_cp)
    on_card = _script(ROOT / "tests" / "test_torch_cuda.py")
    for batch in [smoke.TAIL_BATCH_1Q, *on_card.TAIL_1Q]:
        assert batch % per_1q and batch % 8, batch
    for batch in [smoke.TAIL_BATCH_CP, *on_card.TAIL_CP]:
        assert batch % per_cp, batch


def test_warp_kernels_pair_rules_match_the_tables():
    """The dim = 2 kernel pairs index x with x ^ (3 - r) in round r (and
    rotates rows (0, 3 - r) and the other two in it), and the CP kernel
    moves pair k's two players from seats k and 15 - k one seat down a
    round (seat 0 stays, 1 wraps to 15): both give the pairs of
    _round_robin_pairs, round by round."""
    src = (kernels.CSRC / "apg_fused.cu").read_text()
    assert "const int mm = 3 - r;" in src and "const int jp = j ^ mm;" in src
    assert "const int pb = mm == 1 ? 2 : 1, qb = mm == 3 ? 2 : 3;" in src
    assert "return x == 0 ? 0 : (x == 1 ? 15 : x - 1);" in src
    assert "int x = k, y = 15 - k;" in src
    for r, pairs in enumerate(lanes_apg._round_robin_pairs(4)):
        mm = 3 - r
        assert sorted({(min(x, x ^ mm), max(x, x ^ mm))
                       for x in range(4)}) == sorted(pairs)
        assert sorted(pairs) == sorted([(0, mm), (2 if mm == 1 else 1,
                                                  2 if mm == 3 else 3)])

    def next_seat(x):
        return 0 if x == 0 else (15 if x == 1 else x - 1)

    for k in range(8):
        x, y = k, 15 - k
        for pairs in lanes_apg._round_robin_pairs(16):
            assert (min(x, y), max(x, y)) == pairs[k]
            x, y = next_seat(x), next_seat(y)


@pytest.mark.parametrize("dim", [2, 4])
def test_jax_ordered_calls_give_the_keyword_result(dim):
    """``block`` and ``sublanes`` sit at the JAX package's positions and
    change nothing: a call positioned as for JAX's ``apg_fused(a, n, dim,
    phases, init_iters, init_sweeps, final_iters, final_sweeps,
    final_sweeps_rest, block, use_pallas, mu, a_pinv, sublanes)`` and one
    with JAX's keywords give bitwise the port's keyword call."""
    a = process_tomo_A_matrix(dim // 2)
    rng = np.random.default_rng(10 + dim)
    counts = rng.random((3, a.shape[0]))
    inp = inputs_from_numpy(a, counts / counts.sum(1, keepdims=True),
                            device="cpu", dtype=torch.float64)
    phases, mu = ((2, 1, 1),), 0.1
    want = lanes_apg.apg_fused(inp.a, inp.n, dim, phases=phases,
                               init_iters=1, init_sweeps=2, final_iters=1,
                               final_sweeps=1, mu=mu, a_pinv=inp.a_pinv)
    positional = lanes_apg.apg_fused(inp.a, inp.n, dim, phases, 1, 2, 1, 1,
                                     None, 64, True, mu, inp.a_pinv, 8)
    keywords = lanes_apg.apg_fused(inp.a, inp.n, dim, phases=phases,
                                   init_iters=1, init_sweeps=2,
                                   final_iters=1, final_sweeps=1, block=256,
                                   use_pallas=True, mu=mu, a_pinv=inp.a_pinv,
                                   sublanes=16)
    assert torch.equal(positional, want)
    assert torch.equal(keywords, want)


@pytest.mark.parametrize("batch", [(8,), (2, 4)])
def test_apg_fused_lanes_matches_jax(batch):
    """The lanes-layout entry point (batch last, any batch rank) against
    JAX ``apg_fused_lanes`` in f64 on the same inputs, with ``PARITY_PHASES``
    shortened, within the file's f64 bar (1e-9)."""
    a = process_tomo_A_matrix(1)
    rng = np.random.default_rng(31)
    counts = rng.random((8, a.shape[0]))
    inp = inputs_from_numpy(a, counts / counts.sum(1, keepdims=True),
                            device="cpu", dtype=torch.float64)
    rho0 = lanes_apg.linear_inversion_start(inp.a_pinv, inp.n, 2)
    lanes = lambda x: np.moveaxis(x.numpy(), 0, -1).reshape(4, 4, *batch)
    n_mat = inp.n.numpy().T.reshape(-1, *batch)
    cfg = dict(dim=2, phases=((3, 1, 1), (2, 2, 1)), init_iters=2,
               final_iters=3)
    want = jax_lanes.apg_fused_lanes(
        jnp.asarray(inp.ar.numpy()), jnp.asarray(inp.ai.numpy()),
        jnp.asarray(n_mat), *(jnp.asarray(lanes(x)) for x in rho0), **cfg)
    got = lanes_apg.apg_fused_lanes(
        inp.ar, inp.ai, torch.tensor(n_mat),
        *(torch.tensor(lanes(x)) for x in rho0), **cfg)
    for g, w in zip(got, want):
        assert g.shape == (4, 4, *batch)
        assert np.max(np.abs(g.numpy() - np.asarray(w))) <= 1e-9


# ---- the cache of pinv(A) inside apg_fused ----

SHORT = dict(phases=((2, 1, 1),), init_iters=1, final_iters=1)


def _fresh_case(dim, seed=0, batch=3):
    """A new (R, d4) complex128 A-matrix tensor and (B, R) counts."""
    a = torch.tensor(process_tomo_A_matrix(dim // 2))
    counts = np.random.default_rng(seed).random((batch, a.shape[0]))
    return a, torch.tensor(counts / counts.sum(1, keepdims=True))


def _pinv_counters():
    return lanes_apg.apg_fused.pinv_computed, lanes_apg.apg_fused.pinv_reused


@pytest.mark.parametrize("dim", [2, 4])
def test_pinv_is_computed_once_per_a_matrix(dim):
    """N calls with one A compute pinv(A) once and reuse it N - 1 times, and
    give estimates bitwise those of calls given ``torch.linalg.pinv(a)``."""
    a, n = _fresh_case(dim)
    want = lanes_apg.apg_fused(a, n, dim, a_pinv=torch.linalg.pinv(a),
                               **SHORT)
    computed, reused = _pinv_counters()
    for _ in range(4):
        assert torch.equal(lanes_apg.apg_fused(a, n, dim, **SHORT), want)
    assert _pinv_counters() == (computed + 1, reused + 3)


@pytest.mark.parametrize("dim", [2, 4])
def test_an_in_place_edit_of_a_recomputes_pinv(dim):
    """``a[0, 0] += 1`` bumps A's version: the next call computes pinv(A)
    again and gives what a fresh tensor of the edited A gives."""
    a, n = _fresh_case(dim, seed=1)
    before = lanes_apg.apg_fused(a, n, dim, **SHORT)
    computed, reused = _pinv_counters()
    a[0, 0] += 1
    edited = lanes_apg.apg_fused(a, n, dim, **SHORT)
    assert _pinv_counters() == (computed + 1, reused)
    assert not torch.equal(edited, before)
    assert torch.equal(edited, lanes_apg.apg_fused(a.clone(), n, dim, **SHORT))
    assert torch.equal(edited, lanes_apg.apg_fused(
        a, n, dim, a_pinv=torch.linalg.pinv(a), **SHORT))
    assert _pinv_counters() == (computed + 2, reused)


@pytest.mark.parametrize("dim", [2, 4])
def test_a_new_tensor_with_equal_contents_misses(dim):
    a, n = _fresh_case(dim, seed=2)
    first = lanes_apg.apg_fused(a, n, dim, **SHORT)
    computed, reused = _pinv_counters()
    again = lanes_apg.apg_fused(a.clone(), n, dim, **SHORT)
    assert _pinv_counters() == (computed + 1, reused)
    assert torch.equal(first, again)


@pytest.mark.parametrize("dim", [2, 4])
def test_a_callers_a_pinv_bypasses_the_cache(dim):
    """A given ``a_pinv`` is used as it is: both counters stay, no entry is
    made, and a cached entry is not used."""
    a, n = _fresh_case(dim, seed=3)
    a_pinv = torch.linalg.pinv(a)
    computed, reused = _pinv_counters()
    lanes_apg.apg_fused(a, n, dim, a_pinv=a_pinv, **SHORT)
    assert _pinv_counters() == (computed, reused)
    assert id(a) not in lanes_apg._pinv_cache
    cached = lanes_apg.apg_fused(a, n, dim, **SHORT)
    computed, reused = _pinv_counters()
    given = lanes_apg.apg_fused(a, n, dim, a_pinv=a_pinv.roll(1, 0),
                                **SHORT)
    assert _pinv_counters() == (computed, reused)
    assert not torch.equal(given, cached)


@pytest.mark.parametrize("dim", [2, 4])
def test_the_cache_keeps_no_a_matrix_alive(dim):
    """After ``del a`` the A-matrix is gone and so is its entry."""
    import gc
    import weakref
    a, n = _fresh_case(dim, seed=4)
    lanes_apg.apg_fused(a, n, dim, **SHORT)
    key, ref = id(a), weakref.ref(a)
    assert lanes_apg._pinv_cache[key][0]() is a
    del a
    gc.collect()
    assert ref() is None
    assert key not in lanes_apg._pinv_cache


@pytest.mark.parametrize("dim", [2, 4])
def test_the_cache_keeps_the_least_recently_used_out(dim):
    """More A-matrices than entries: the cache holds ``PINV_CACHE_SIZE``, the
    most recently used; the oldest computes pinv again."""
    size = lanes_apg.PINV_CACHE_SIZE
    mats = [_fresh_case(dim, seed=5)[0].clone() for _ in range(size + 2)]
    _, n = _fresh_case(dim, seed=5, batch=1)
    computed, reused = _pinv_counters()
    for a in mats:
        lanes_apg.apg_fused(a, n, dim, **SHORT)
        assert len(lanes_apg._pinv_cache) <= size
    assert _pinv_counters() == (computed + size + 2, reused)
    for a in mats[2:]:
        lanes_apg.apg_fused(a, n, dim, **SHORT)
    assert _pinv_counters() == (computed + size + 2, reused + size)
    lanes_apg.apg_fused(mats[0], n, dim, **SHORT)
    assert _pinv_counters() == (computed + size + 3, reused + size)
    assert list(lanes_apg._pinv_cache)[-1] == id(mats[0])


@pytest.mark.parametrize("dim", [2, 4])
def test_tensors_without_a_version_to_check_always_compute(dim):
    """An inference tensor has no version counter, and an A that requires
    grad would share one graph between calls: each call computes pinv(A),
    and the results equal the cached route's."""
    a, n = _fresh_case(dim, seed=6)
    want = lanes_apg.apg_fused(a, n, dim, **SHORT)
    with torch.inference_mode():
        a_inf = a.clone()
    a_grad = a.clone().requires_grad_()
    for x in (a_inf, a_grad):
        computed, reused = _pinv_counters()
        for _ in range(2):
            with torch.no_grad() if x is a_inf else contextlib.nullcontext():
                got = lanes_apg.apg_fused(x, n, dim, **SHORT)
            assert torch.equal(got.detach(), want)
        assert _pinv_counters() == (computed + 2, reused)
        assert id(x) not in lanes_apg._pinv_cache


def test_the_cache_serves_callers_on_several_threads(dim=2):
    """Eight threads, with the interpreter switching threads as often as it
    can, calling with two A-matrices in turn: every estimate is its A's,
    and every call is counted once, as computed or reused (a lost update
    would miss one)."""
    import sys
    from concurrent.futures import ThreadPoolExecutor
    mats = [_fresh_case(dim, seed=7)[0] for _ in range(2)]
    _, n = _fresh_case(dim, seed=7)
    mats[1][0, 0] += 1
    want = [lanes_apg.apg_fused(a, n, dim, a_pinv=torch.linalg.pinv(a),
                                **SHORT) for a in mats]
    computed, reused = _pinv_counters()
    calls = 48
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(8) as pool:
            outs = list(pool.map(
                lambda i: lanes_apg.apg_fused(mats[i % 2], n, dim, **SHORT),
                range(calls), timeout=300))
    finally:
        sys.setswitchinterval(interval)
    assert all(torch.equal(o, want[i % 2]) for i, o in enumerate(outs))
    done, hit = _pinv_counters()
    assert done - computed >= 2 and (done - computed) + (hit - reused) == calls
