"""On-card tests of the port's CUDA kernels against their plain PyTorch
versions. They need an NVIDIA GPU and skip without one.

This file imports no JAX, so on a machine without JAX it runs without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from forest_benchmarking_tpu_torch import kernels, quantum_volume
from forest_benchmarking_tpu_torch.benchmarks import (
    inputs_from_numpy, process_tomo_A_matrix, synth_process_datasets)
from forest_benchmarking_tpu_torch.ops import (
    lanes_apg, pallas_eigh, pallas_traj)
from forest_benchmarking_tpu_torch.ops.project_superoperators import (
    proj_choi_to_completely_positive)
from forest_benchmarking_tpu_torch.ops.random_operators import (
    haar_rand_unitary)
from forest_benchmarking_tpu_torch.sim.noise import depolarizing_kraus_map

pytestmark = pytest.mark.cuda

SCHEDULES = {"headline": lanes_apg.HEADLINE_TUNED_2Q,
             "parity": lanes_apg.PARITY_TUNED_2Q}


def source_constant(name: str) -> int:
    """An integer constant of ``csrc/apg_fused.cu`` (the problems or
    matrices a block of a kernel holds)."""
    src = (kernels.CSRC / "apg_fused.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


# batches that leave the last block part empty and, at dim = 2, the last
# warp too (a problem is a quad of lanes, eight a warp; a CP matrix is a
# warp)
TAIL_1Q = [source_constant("PROBLEMS_1Q") + 1,
           3 * source_constant("PROBLEMS_1Q") + 5]
TAIL_CP = [source_constant("CP_PER_BLOCK") + 1,
           2 * source_constant("CP_PER_BLOCK") + 3]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def case(cuda):
    a = process_tomo_A_matrix(2)
    in32 = inputs_from_numpy(a, np.zeros((1, 1080)), device=cuda)
    in64 = inputs_from_numpy(a, np.zeros((1, 1080)), device=cuda,
                             dtype=torch.float64)
    gen = torch.Generator(device=cuda).manual_seed(7)
    n, _ = synth_process_datasets(gen, in32.a, 4, 64, 2000)
    return in32, in64, n


def _hold_against_plain(in32, in64, n, cfg):
    kern = lanes_apg.apg_fused(in32.a, n, 4, a_pinv=in32.a_pinv, **cfg)
    rho0 = lanes_apg.linear_inversion_start(in32.a_pinv, n, 4)
    plain32 = torch.complex(*lanes_apg.apg_fused_reference(
        in32.ar, in32.ai, n, *rho0, dim=4, **cfg))
    rho0 = lanes_apg.linear_inversion_start(in64.a_pinv, n.double(), 4)
    plain64 = torch.complex(*lanes_apg.apg_fused_reference(
        in64.ar, in64.ai, n.double(), *rho0, dim=4, **cfg))
    torch.cuda.synchronize()
    dev_k = (kern.to(plain64.dtype) - plain64).abs().max().item()
    dev_p = (plain32.to(plain64.dtype) - plain64).abs().max().item()
    assert dev_k <= 2 * dev_p + 1e-5
    pt = torch.diagonal(kern.reshape(-1, 4, 4, 4, 4), dim1=2, dim2=4).sum(-1)
    assert (pt - torch.eye(4, device=kern.device)).abs().max() < 1e-5


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_kernel_against_plain_version(case, schedule):
    """The kernel's max deviation from the plain f64 solve is at most twice
    the plain f32 solve's + 1e-5 (f32 round-off, reordered sums and the
    discontinuous restart rule make bitwise equality the wrong bar)."""
    in32, in64, n = case
    _hold_against_plain(in32, in64, n, SCHEDULES[schedule])


@pytest.mark.parametrize("batch", [63, 65])
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_kernel_against_plain_version_at_a_tail_batch(cuda, schedule, batch):
    """A batch that is not a multiple of the problems per block: the last
    block runs its empty slots on zero counts and writes only its live
    problems. Same bar as at B = 64."""
    a = process_tomo_A_matrix(2)
    in32 = inputs_from_numpy(a, np.zeros((1, 1080)), device=cuda)
    in64 = inputs_from_numpy(a, np.zeros((1, 1080)), device=cuda,
                             dtype=torch.float64)
    assert batch % 4   # four problems per block
    gen = torch.Generator(device=cuda).manual_seed(batch)
    n, _ = synth_process_datasets(gen, in32.a, 4, batch, 2000)
    _hold_against_plain(in32, in64, n, SCHEDULES[schedule])


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_estimate_does_not_depend_on_block_mates(case, schedule):
    """A problem's estimate is bitwise the same whichever problems share its
    block: with the batch permuted, and solved alone (B = 1)."""
    in32, _, n = case
    cfg = SCHEDULES[schedule]
    n = n[:9].contiguous()
    rho0 = lanes_apg.linear_inversion_start(in32.a_pinv, n, 4)

    def solve(idx):
        return torch.complex(*lanes_apg.apg_fused_kernel(
            in32.ar, in32.ai, n[idx].contiguous(),
            *(x[idx].contiguous() for x in rho0), dim=4, **cfg))

    everything = solve(torch.arange(9, device=n.device))
    perm = torch.randperm(9, generator=torch.Generator().manual_seed(3)).to(
        n.device)
    assert torch.equal(solve(perm), everything[perm])
    for i in (0, 5, 8):
        assert torch.equal(solve(torch.tensor([i], device=n.device)),
                           everything[i:i + 1])


def test_launch_counter_counts_kernel_launches(case):
    in32, _, n = case
    before = lanes_apg.apg_fused.launches
    lanes_apg.apg_fused(in32.a, n, 4, a_pinv=in32.a_pinv,
                        **lanes_apg.HEADLINE_TUNED_2Q)
    torch.cuda.synchronize()
    assert lanes_apg.apg_fused.launches == before + 1


def test_wrapper_rejects_what_the_kernel_does_not_take(case, cuda):
    in32, in64, n = case
    z = torch.zeros((2, 9, 9), device=cuda)
    with pytest.raises(NotImplementedError, match="dim=2 .* and dim=4"):
        lanes_apg.apg_fused_kernel(torch.zeros((4, 81), device=cuda),
                                   torch.zeros((4, 81), device=cuda),
                                   torch.zeros((2, 4), device=cuda), z, z,
                                   dim=3)
    with pytest.raises(TypeError, match="float32"):
        lanes_apg.apg_fused(in64.a, n.double(), 4, a_pinv=in64.a_pinv,
                            **lanes_apg.HEADLINE_TUNED_2Q)
    with pytest.raises(ValueError, match="at most"):
        lanes_apg.apg_fused(in32.a, n, 4, phases=((1, 1, 1),) * 9)
    rho0 = lanes_apg.linear_inversion_start(in32.a_pinv, n, 4)
    with pytest.raises(ValueError, match="contiguous"):
        lanes_apg.apg_fused_kernel(in32.ar, in32.ai, n.T.contiguous().T,
                                   *rho0, dim=4)
    with pytest.raises(ValueError, match="shape"):
        lanes_apg.apg_fused_kernel(in32.ar, in32.ai, n[:-1], *rho0, dim=4)
    with pytest.raises(ValueError, match="must be on"):
        lanes_apg.apg_fused_kernel(in32.ar, in32.ai, n.cpu(), *rho0, dim=4)
    # more rows than a block's shared memory holds: the launch is refused
    rows = 20000
    big = torch.zeros((rows, 256), device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        lanes_apg.apg_fused_kernel(big, big, torch.zeros((2, rows),
                                                         device=cuda),
                                   *(x[:2] for x in rho0), dim=4)
    # the refused launch leaves no error behind for the next one
    lanes_apg.apg_fused(in32.a, n, 4, a_pinv=in32.a_pinv,
                        **lanes_apg.HEADLINE_TUNED_2Q)
    torch.cuda.synchronize()


@pytest.mark.parametrize("batch", [(64,), (8, 8)])
def test_lanes_entry_point_is_the_kernel_on_transposed_inputs(case, batch):
    """``apg_fused_lanes`` (batch last, batch rank 1 and 2) launches the
    kernel once and returns bitwise ``apg_fused_kernel``'s result on the
    batch-first inputs, transposed."""
    in32, _, n = case
    cfg = lanes_apg.HEADLINE_TUNED_2Q
    rho0 = lanes_apg.linear_inversion_start(in32.a_pinv, n, 4)
    want = lanes_apg.apg_fused_kernel(in32.ar, in32.ai, n, *rho0, dim=4,
                                      **cfg)
    lanes = lambda x: x.permute(1, 2, 0).reshape(16, 16, *batch)
    before = lanes_apg.apg_fused.launches
    got = lanes_apg.apg_fused_lanes(
        in32.ar, in32.ai, n.T.reshape(-1, *batch),
        *(lanes(x) for x in rho0), dim=4, **cfg)
    torch.cuda.synchronize()
    assert lanes_apg.apg_fused.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, lanes(w))


@pytest.mark.parametrize("batch", [64, 100])
def test_1q_kernel_against_plain_version(cuda, batch):
    """dim=2 (sixteen problems per block; B = 100 leaves the last block a
    quarter full), one launch.

    One outer step: every problem within 1e-5 of the plain f32 solve.
    Default schedule: at the median and 90th percentile over problems, the
    kernel's max deviation from the plain f64 solve is at most twice the
    plain f32 solve's + 1e-5; the TP violation is under 1e-3 everywhere
    and over 1e-5 on at most 2 x + 2 as many problems as the plain f32
    solve's. (The schedule amplifies f32 round-off on a few problems in a
    thousand and leaves a few in ten thousand far from the physical set,
    so maxima are no bar: chip_smoke.py phase 9.)"""
    a = process_tomo_A_matrix(1)
    in32 = inputs_from_numpy(a, np.zeros((1, 36)), device=cuda)
    in64 = inputs_from_numpy(a, np.zeros((1, 36)), device=cuda,
                             dtype=torch.float64)
    gen = torch.Generator(device=cuda).manual_seed(batch)
    n, _ = synth_process_datasets(gen, in32.a, 2, batch, 2000)
    before = lanes_apg.apg_fused.launches
    kern = lanes_apg.apg_fused(in32.a, n, 2, a_pinv=in32.a_pinv)
    torch.cuda.synchronize()
    assert lanes_apg.apg_fused.launches == before + 1
    rho0 = lanes_apg.linear_inversion_start(in32.a_pinv, n, 2)
    # one outer step, and one with the split sweep counts
    for one in (dict(phases=((1, 1, 1),)),
                dict(phases=((1, 3, 2, 0),), final_iters=3,
                     final_sweeps_rest=0)):
        step_k = lanes_apg.apg_fused_kernel(in32.ar, in32.ai, n, *rho0,
                                            dim=2, **one)
        step_p = lanes_apg.apg_fused_reference(in32.ar, in32.ai, n, *rho0,
                                               dim=2, **one)
        assert (torch.complex(*step_k)
                - torch.complex(*step_p)).abs().max() < 1e-5
    plain32 = torch.complex(*lanes_apg.apg_fused_reference(
        in32.ar, in32.ai, n, *rho0, dim=2))
    rho0 = lanes_apg.linear_inversion_start(in64.a_pinv, n.double(), 2)
    plain64 = torch.complex(*lanes_apg.apg_fused_reference(
        in64.ar, in64.ai, n.double(), *rho0, dim=2))
    q = torch.tensor([0.5, 0.9], dtype=torch.float64, device=cuda)

    def dev(x):
        return torch.quantile((x.to(plain64.dtype) - plain64).abs().amax(
            dim=(1, 2)), q)

    assert (dev(kern) <= 2 * dev(plain32) + 1e-5).all()

    def tp(x):
        pt = torch.diagonal(x.reshape(-1, 2, 2, 2, 2), dim1=2, dim2=4).sum(-1)
        return (pt - torch.eye(2, device=cuda)).abs().amax(dim=(1, 2))

    assert tp(kern).max().item() < 1e-3
    assert (tp(kern) > 1e-5).sum() <= 2 * (tp(plain32) > 1e-5).sum() + 2


@pytest.mark.parametrize("batch", [1, 64])
def test_cp_project_kernel_against_eigh(cuda, batch):
    """Six sweeps from V = I: within 1e-4 of the exact eigh projection in
    f64 (the JAX package's f32 bar) and of the plain f32 version; one
    launch. complex128 is refused."""
    gen = torch.Generator(device=cuda).manual_seed(batch)
    x = torch.randn((batch, 16, 16), generator=gen, device=cuda,
                    dtype=torch.complex64)
    h = (x + x.transpose(1, 2).conj()) / 2
    before = pallas_eigh.cp_project_pallas.launches
    kern = pallas_eigh.cp_project_pallas(h, sweeps=6)
    torch.cuda.synchronize()
    assert pallas_eigh.cp_project_pallas.launches == before + 1
    exact = proj_choi_to_completely_positive(h.to(torch.complex128))
    plain = pallas_eigh.cp_project_reference(h, 6)
    assert (kern.to(torch.complex128) - exact).abs().max().item() < 1e-4
    assert (kern - plain).abs().max().item() < 1e-4
    with pytest.raises(TypeError, match="complex64"):
        pallas_eigh.cp_project_pallas(h.to(torch.complex128))


def one_q_case(cuda, batch, seed):
    """dim = 2 float32 inputs on the card: A, counts of ``batch`` datasets
    of 2000 shots and their linear-inversion start."""
    a = process_tomo_A_matrix(1)
    in32 = inputs_from_numpy(a, np.zeros((1, 36)), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    n, _ = synth_process_datasets(gen, in32.a, 2, batch, 2000)
    return in32, n, lanes_apg.linear_inversion_start(in32.a_pinv, n, 2)


@pytest.mark.parametrize("batch", TAIL_1Q)
def test_1q_kernel_at_a_tail_batch(cuda, batch):
    """A batch that leaves the last block and its last warp part empty:
    every problem within 1e-5 of the plain f32 solve after
    one outer step (the bar of test_1q_kernel_against_plain_version), and
    finite on the default schedule."""
    assert batch % 8 and batch % source_constant("PROBLEMS_1Q")
    in32, n, rho0 = one_q_case(cuda, batch, batch)
    one = dict(phases=((1, 1, 1),))
    step_k = lanes_apg.apg_fused_kernel(in32.ar, in32.ai, n, *rho0, dim=2,
                                        **one)
    step_p = lanes_apg.apg_fused_reference(in32.ar, in32.ai, n, *rho0, dim=2,
                                           **one)
    assert (torch.complex(*step_k) - torch.complex(*step_p)).abs().max() < 1e-5
    full = torch.complex(*lanes_apg.apg_fused_kernel(in32.ar, in32.ai, n,
                                                     *rho0, dim=2))
    assert full.shape == (batch, 4, 4) and bool(torch.isfinite(full).all())


def test_1q_estimate_does_not_depend_on_block_mates(cuda):
    """A problem's dim = 2 estimate is bitwise the same whichever problems
    share its warp and block: the first 1, 17 and 65 of 80 problems solved
    alone equal the run on all 80, two blocks (default schedule)."""
    in32, n, rho0 = one_q_case(cuda, 80, 5)

    def solve(k):
        return torch.complex(*lanes_apg.apg_fused_kernel(
            in32.ar, in32.ai, n[:k].contiguous(),
            *(x[:k].contiguous() for x in rho0), dim=2))

    everything = solve(80)
    for k in (1, 17, 65):
        assert torch.equal(solve(k), everything[:k])


def test_1q_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    """dim = 2: float64, a wrong shape of the counts and counts on another
    device raise; nothing falls back to the plain version."""
    in32, n, rho0 = one_q_case(cuda, 4, 3)
    with pytest.raises(TypeError, match="float32"):
        lanes_apg.apg_fused_kernel(in32.ar, in32.ai, n.double(), *rho0, dim=2)
    with pytest.raises(ValueError, match="shape"):
        lanes_apg.apg_fused_kernel(in32.ar, in32.ai, n[:, :-1], *rho0, dim=2)
    with pytest.raises(ValueError, match="must be on"):
        lanes_apg.apg_fused_kernel(in32.ar, in32.ai, n.cpu(), *rho0, dim=2)


def gaussian_hermitian(cuda, batch, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((batch, 16, 16), generator=gen, device=cuda,
                    dtype=torch.complex64)
    return (x + x.transpose(1, 2).conj()) / 2


@pytest.mark.parametrize("batch", TAIL_CP)
def test_cp_project_kernel_at_a_tail_batch(cuda, batch):
    """A batch that leaves the last block part empty: within 1e-4 of the
    plain f32 version after 1, 2 and 6 sweeps (one sweep is far from
    converged, so this holds the rotations to the plain version's round
    order) and of eigh in f64 after 6."""
    assert batch % source_constant("CP_PER_BLOCK")
    h = gaussian_hermitian(cuda, batch, batch)
    for sweeps in (1, 2, 6):
        kern = pallas_eigh.cp_project_pallas(h, sweeps=sweeps)
        plain = pallas_eigh.cp_project_reference(h, sweeps)
        assert (kern - plain).abs().max().item() < 1e-4, sweeps
    exact = proj_choi_to_completely_positive(h.to(torch.complex128))
    assert (kern.to(torch.complex128) - exact).abs().max().item() < 1e-4


def test_cp_project_does_not_depend_on_block_mates(cuda):
    """A matrix's positive part is bitwise the same whichever matrices share
    its block: the first 1 and 9 of 20 projected alone equal the run on
    all 20."""
    h = gaussian_hermitian(cuda, 20, 9)
    everything = pallas_eigh.cp_project_pallas(h)
    for k in (1, 9):
        assert torch.equal(pallas_eigh.cp_project_pallas(h[:k].contiguous()),
                           everything[:k])


def test_cp_project_rejects_what_the_kernel_does_not_take(cuda):
    """Wrong dtype, shape or device raise; nothing falls back to the plain
    version."""
    h = gaussian_hermitian(cuda, 2, 1)
    with pytest.raises(TypeError, match="complex64"):
        pallas_eigh.cp_project_pallas(h.real.contiguous())
    with pytest.raises(ValueError, match="shape"):
        pallas_eigh.cp_project_pallas(h[:, :8, :8])
    with pytest.raises(ValueError, match="unsupported device"):
        pallas_eigh.cp_project_pallas(torch.empty(
            (2, 16, 16), dtype=torch.complex64, device="meta"))


def random_kraus(gen, n_kraus):
    """A random CPTP stack of ``n_kraus`` 4x4 operators: the blocks of the
    first four columns of a Haar unitary of side 4K (sum_k K_k^dag K_k =
    I)."""
    u = haar_rand_unitary(gen, 4 * n_kraus, dtype=torch.float32)
    return u[:, :4].reshape(n_kraus, 4, 4).contiguous()


def qv_case(cuda, depth, circuits=16, n_traj=256, n_kraus=None):
    """Circuits, a Kraus stack and uniforms on the card, drawn from a
    seeded generator: 2% two-qubit depolarizing noise (K = 16), or a random
    CPTP stack of ``n_kraus`` operators."""
    gen = torch.Generator(device=cuda).manual_seed(depth)
    perms = quantum_volume._sample_perms(gen, circuits, depth)
    gates = haar_rand_unitary(gen, 4, batch=(circuits, depth, depth // 2),
                              dtype=torch.float32)
    if n_kraus is None:
        ks = depolarizing_kraus_map(0.02)
        kraus = torch.tensor(np.stack([np.kron(a, b) for a in ks for b in ks]),
                             dtype=torch.complex64, device=cuda)
    else:
        kraus = random_kraus(gen, n_kraus)
    uniforms = torch.rand((circuits, depth, depth // 2, n_traj),
                          generator=gen, device=cuda)
    return perms, gates, kraus, uniforms


def ideal_tail_circuits(depth):
    """A circuit count that leaves the ideal kernel's last block part empty
    and, where a warp holds several circuits, its last warp's lane groups
    too: one block, one warp and half a warp more."""
    per_warp = pallas_traj.ideal_circuits_per_warp(depth)
    return pallas_traj.IDEAL_WARPS * per_warp + per_warp + max(per_warp // 2, 1)


def hold_ideal_against_plain(perms, gates, depth):
    """The ideal kernel's result, after holding it within 2e-6 of the plain
    f32 version (the JAX package's bar for its Pallas kernel) and 1e-5 of
    the plain f64 version; one launch."""
    before = pallas_traj.ideal_probs.launches
    kern = pallas_traj.ideal_probs(perms, gates, depth)
    torch.cuda.synchronize()
    assert pallas_traj.ideal_probs.launches == before + 1
    plain32 = pallas_traj.ideal_probs_reference(perms, gates, depth)
    plain64 = pallas_traj.ideal_probs_reference(perms, gates.to(
        torch.complex128), depth)
    assert (kern - plain32).abs().max().item() <= 2e-6
    assert (kern.double() - plain64).abs().max().item() <= 1e-5
    return kern


@pytest.mark.parametrize("depth", range(2, 11))
def test_ideal_kernel_against_plain_version(cuda, depth):
    """Every depth instantiation, the packed layouts (a circuit a group of
    2^(d-2) lanes below depth 7) and the odd depths included, at C = 16."""
    perms, gates, _, _ = qv_case(cuda, depth)
    hold_ideal_against_plain(perms, gates, depth)


@pytest.mark.parametrize("depth", [2, 4, 6, 8, 10])
def test_ideal_kernel_at_a_tail_count(cuda, depth):
    """The same bars at a circuit count that leaves the last block, and at
    packed depths the last warp's lane groups, part empty."""
    perms, gates, _, _ = qv_case(cuda, depth,
                                 circuits=ideal_tail_circuits(depth))
    hold_ideal_against_plain(perms, gates, depth)


@pytest.mark.parametrize("depth", [4, 8])
def test_ideal_rows_do_not_depend_on_block_mates(cuda, depth):
    """A circuit's row is bitwise the same whichever circuits share its warp
    and block: the first rows of a tail count rerun alone."""
    c = ideal_tail_circuits(depth)
    perms, gates, _, _ = qv_case(cuda, depth, circuits=c)
    full = pallas_traj.ideal_probs(perms, gates, depth)
    for k in (1, 3, c - 2):
        assert torch.equal(pallas_traj.ideal_probs(perms[:k], gates[:k], depth),
                           full[:k])


def test_ideal_kernel_makes_one_device_launch(cuda):
    """The wrapper passes the permutations and gates as they are: the call
    is one device launch, the ideal kernel's."""
    from torch.profiler import ProfilerActivity, profile
    perms, gates, _, _ = qv_case(cuda, 8)
    pallas_traj.ideal_probs_kernel(perms, gates, 8)      # build, warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pallas_traj.ideal_probs_kernel(perms, gates, 8)
        torch.cuda.synchronize()
    launched = [(e.key, e.count) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(launched) == 1 and launched[0][1] == 1, launched
    assert "ideal_probs_kernel" in launched[0][0]


def test_ideal_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    """int32 permutations, permutations off the card and gates that are not
    16-byte aligned raise (no fallback to the plain version)."""
    perms, gates, _, _ = qv_case(cuda, 4, circuits=2)
    with pytest.raises(TypeError, match="int64"):
        pallas_traj.ideal_probs(perms.int(), gates, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pallas_traj.ideal_probs(perms.cpu(), gates, 4)
    shifted = torch.empty(gates.numel() + 1, dtype=gates.dtype,
                          device=cuda)[1:].view(gates.shape)
    shifted.copy_(gates)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pallas_traj.ideal_probs(perms, shifted, 4)


def test_kernels_read_a_conjugate_view(cuda):
    """A conjugate view's data pointer holds the unconjugated values: the
    ideal, trajectory and CP wrappers carry the conjugation out first and
    give what the conjugated tensor gives."""
    perms, gates, kraus, uniforms = qv_case(cuda, 4, circuits=4, n_traj=32)
    conj = gates.conj()
    assert conj.is_conj()
    assert torch.equal(pallas_traj.ideal_probs(perms, conj, 4),
                       pallas_traj.ideal_probs(perms, conj.resolve_conj(), 4))
    assert torch.equal(
        pallas_traj.traj_probs(perms, conj, kraus.conj(), uniforms, 4),
        pallas_traj.traj_probs(perms, conj.resolve_conj(),
                               kraus.conj().resolve_conj(), uniforms, 4))
    x = torch.randn((9, 16, 16), dtype=torch.complex64, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(5))
    h = (x + x.transpose(1, 2).conj()) / 2
    assert torch.equal(pallas_eigh.cp_project_pallas(h.conj()),
                       pallas_eigh.cp_project_pallas(h.conj().resolve_conj()))


@pytest.mark.parametrize("depth,n_traj,n_kraus", [
    (2, 256, None), (3, 256, None), (5, 256, None), (7, 256, None),
    (8, 256, None), (8, 500, None), (9, 128, None), (10, 64, None),
    (8, 256, 1), (8, 256, 32), (10, 64, 32)])
def test_traj_kernel_against_plain_version(cuda, depth, n_traj, n_kraus):
    """On the same uniforms, more than 97% of trajectories within 1e-4 of
    the plain f32 version (the rest flip a branch where u is within f32
    round-off of a cumulative sum), every column normalized to 1e-5; one
    launch. Every depth layout (odd ones too), K = 1, 16 and 32; T = 500
    leaves the last block of 16 trajectories part full."""
    perms, gates, kraus, uniforms = qv_case(cuda, depth, n_traj=n_traj,
                                            n_kraus=n_kraus)
    before = pallas_traj.traj_probs.launches
    kern = pallas_traj.traj_probs(perms, gates, kraus, uniforms, depth)
    torch.cuda.synchronize()
    assert pallas_traj.traj_probs.launches == before + 1
    plain = pallas_traj.traj_probs_reference(perms, gates, kraus, uniforms,
                                             depth)
    col_diff = (kern - plain).abs().amax(dim=1)
    assert (col_diff < 1e-4).float().mean().item() > 0.97
    assert (kern.sum(1) - 1).abs().max().item() < 1e-5


def test_qv_entry_point_rejects_a_generator_elsewhere(cuda):
    with pytest.raises(ValueError, match="generator"):
        quantum_volume.sample_heavy_outputs_batched(
            torch.Generator(), 4, 2, 10, device=cuda)


@pytest.mark.parametrize("depth", [5, 8, 10])
def test_traj_columns_do_not_depend_on_block_mates(cuda, depth):
    """A trajectory's column is bitwise the same whichever trajectories
    share its block: the run on the first 256 uniforms, and on the first
    7, gives bitwise the first columns of the run on T = 500."""
    perms, gates, kraus, uniforms = qv_case(cuda, depth, circuits=4,
                                            n_traj=500)
    full = pallas_traj.traj_probs(perms, gates, kraus, uniforms, depth)
    for t in (256, 7):
        part = pallas_traj.traj_probs(perms, gates, kraus,
                                      uniforms[..., :t].contiguous(), depth)
        assert torch.equal(part, full[..., :t])


def test_traj_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    """Direct calls with inputs the kernel does not take raise (no fallback
    to the plain version): complex128, more than 32 operators, depth 11."""
    perms, gates, kraus, uniforms = qv_case(cuda, 4, circuits=2, n_traj=8)
    with pytest.raises(TypeError, match="complex64"):
        pallas_traj.traj_probs(perms, gates.to(torch.complex128),
                               kraus.to(torch.complex128), uniforms.double(), 4)
    many = torch.zeros((33, 4, 4), dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match="1 to 32 Kraus"):
        pallas_traj.traj_probs(perms, gates, many, uniforms, 4)
    with pytest.raises(ValueError, match="depths 2 to 10"):
        pallas_traj.ideal_probs(perms, gates, 11)


@pytest.mark.parametrize("depth,kernels_run", [(8, True), (11, False)])
def test_qv_float64_on_the_card(cuda, depth, kernels_run):
    """dtype float64 on the card: at depth 8 the kernels run on float32
    casts (their counters move) and the counts come back in range; at depth
    11, above what the kernels take, the plain versions run (counters stay
    at 0)."""
    ks = depolarizing_kraus_map(0.02)
    kraus = np.stack([np.kron(a, b) for a in ks for b in ks])
    pallas_traj.ideal_probs.launches = pallas_traj.traj_probs.launches = 0
    counts = quantum_volume.sample_heavy_outputs_batched(
        torch.Generator(device=cuda).manual_seed(depth), depth, 4, 20,
        dtype=torch.float64, kraus=kraus, noisy_method="trajectory",
        num_trajectories=10, device=cuda)
    torch.cuda.synchronize()
    moved = (pallas_traj.ideal_probs.launches,
             pallas_traj.traj_probs.launches)
    assert moved == ((1, 1) if kernels_run else (0, 0))
    assert counts.shape == (4,) and bool(((counts >= 0) & (counts <= 20)).all())


def depolarizing_pair():
    """(16, 4, 4) complex128: 2% depolarizing noise on each qubit of a pair."""
    ks = depolarizing_kraus_map(0.02)
    return np.stack([np.kron(a, b) for a in ks for b in ks])


def multinomial_route(gen, depth, circuits, n_traj, dtype, kraus):
    """The card's trajectory route as it was before the shot kernel, from
    the entry point's draws in its order: the kernels' probabilities, the
    (C * T, 2^d) transposed copy, ``torch.multinomial`` of one sample a
    trajectory, ``gather`` and ``sum``."""
    cdtype = torch.complex64 if dtype == torch.float32 else torch.complex128
    perms = quantum_volume._sample_perms(gen, circuits, depth)
    gates = haar_rand_unitary(gen, 4, batch=(circuits, depth, depth // 2),
                              dtype=dtype).to(torch.complex64)
    heavy = quantum_volume._heavy_outputs(
        pallas_traj.ideal_probs(perms, gates, depth).to(dtype))
    kraus = torch.as_tensor(kraus).to(device=gen.device, dtype=cdtype)
    uniforms = torch.rand((circuits, depth, depth // 2, n_traj),
                          generator=gen, device=gen.device)
    traj = pallas_traj.traj_probs(perms, gates, kraus.to(torch.complex64),
                                  uniforms, depth).to(dtype)
    rows = traj.transpose(1, 2).reshape(circuits * n_traj, -1)
    samples = torch.multinomial(rows, 1, replacement=True, generator=gen)
    return torch.gather(heavy, 1, samples.reshape(circuits, n_traj)).sum(1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_traj", [1, 37, 1000])
@pytest.mark.parametrize("depth", range(2, 11))
def test_one_shot_a_trajectory_is_the_multinomial_routes_bitwise(
        cuda, depth, n_traj, dtype):
    """On the same generator state, the entry point's one-pass route (the
    exponential draw and one launch of the shot kernel) gives bitwise the
    tallies of the transposed copy and ``torch.multinomial``, and leaves the
    generator where they leave it: every depth, T below, at and past a
    block of 128 trajectories, float32 and float64 variates."""
    kraus = depolarizing_pair()
    g_new = torch.Generator(device=cuda).manual_seed(40 + depth)
    g_old = torch.Generator(device=cuda).manual_seed(40 + depth)
    before = pallas_traj.heavy_tallies.launches
    got = quantum_volume.sample_heavy_outputs_batched(
        g_new, depth, 6, n_traj, dtype=dtype, kraus=kraus,
        noisy_method="trajectory", device=cuda)
    torch.cuda.synchronize()
    assert pallas_traj.heavy_tallies.launches == before + 1
    want = multinomial_route(g_old, depth, 6, n_traj, dtype, kraus)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    assert torch.equal(g_new.get_state(), g_old.get_state())


def crafted_shots(cuda, depth, n_traj, dtype):
    """(traj, heavy, q) on the card with exact ties for the largest
    quotient (p = 2^k and q = 2^k at three outputs of a row, every other
    quotient below 1) and, in the first five rows, a NaN quotient (0 / 0
    at two outputs, ATen's argmax takes the first)."""
    g = torch.Generator(device=cuda).manual_seed(depth)
    c, n = 3, 2 ** depth
    rows = torch.rand((c * n_traj, n), generator=g, device=cuda) * 0.5
    q = torch.ones((c * n_traj, n), device=cuda)
    ties = torch.rand((c * n_traj, n), generator=g,
                      device=cuda).argsort(1)[:, :3]
    scale = torch.tensor([0.5, 1.0, 2.0], device=cuda).expand_as(ties)
    rows.scatter_(1, ties, scale)
    q.scatter_(1, ties, scale)
    rows[:5, 1:3] = 0.0
    q[:5, 1:3] = 0.0
    traj = rows.reshape(c, n_traj, n).transpose(1, 2).contiguous()
    heavy = torch.rand((c, n), generator=g, device=cuda) > 0.5
    return traj, heavy, q.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("depth,n_traj", [(2, 130), (4, 37), (8, 200),
                                          (10, 129)])
def test_shot_kernel_against_plain_version_on_crafted_variates(
        cuda, depth, n_traj, dtype):
    traj, heavy, q = crafted_shots(cuda, depth, n_traj, dtype)
    got = pallas_traj.heavy_tallies_kernel(traj, heavy, q)
    want = pallas_traj.heavy_tallies_reference(traj, heavy, q)
    assert torch.equal(got, want)


SPOILED_SHOTS = """
import sys
import torch
from forest_benchmarking_tpu_torch.ops import pallas_traj
how, dev = sys.argv[1], torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(2)
traj = torch.rand((2, 8, 9), generator=g, device=dev)
heavy = torch.rand((2, 8), generator=g, device=dev) > 0.5
if how == "nan":
    traj[1, 2, 5] = float("nan")
elif how == "inf":
    traj[0, 0, 3] = float("inf")
elif how == "negative":
    traj[1, 3, 0] = -1e-30
else:
    traj[0, :, 7] = 0.0
rows = traj.transpose(1, 2).reshape(18, 8).cpu()
try:
    torch.multinomial(rows, 1, replacement=True)
except RuntimeError as e:
    print("cpu multinomial:", e, flush=True)
q = torch.empty((18, 8), device=dev).exponential_(generator=g)
pallas_traj.heavy_tallies(traj, heavy, q)
print("returned", flush=True)
torch.cuda.synchronize()
print("synchronized", flush=True)
"""


@pytest.mark.parametrize("how", ["nan", "inf", "negative", "zero_sum"])
def test_shot_kernel_raises_what_multinomial_raises(cuda, how):
    """Rows that ``torch.multinomial`` refuses (on the CPU, with its
    message) fail the shot kernel's device-side assert, as they fail
    ``torch.multinomial``'s ``_assert_async`` on the card: the call returns
    without waiting for the card, and the next synchronization raises and
    ends the CUDA context, so each case runs in a process of its own."""
    run = subprocess.run([sys.executable, "-c", SPOILED_SHOTS, how],
                         cwd=kernels.CSRC.parents[1], capture_output=True,
                         text=True, timeout=300)
    want = (pallas_traj.ZERO_SUM if how == "zero_sum"
            else pallas_traj.NOT_A_DISTRIBUTION)
    assert f"cpu multinomial: {want}\nreturned\n" in run.stdout, run.stderr
    assert "synchronized" not in run.stdout
    assert run.returncode != 0 and "device-side assert" in run.stderr


def test_shot_kernel_wrapper_makes_the_host_wait_for_nothing(cuda):
    """No synchronizing call in the wrapper, so shards on several cards
    are all queued before any is waited for."""
    traj, heavy, q = crafted_shots(cuda, 8, 200, torch.float32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = pallas_traj.heavy_tallies(traj, heavy, q)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, pallas_traj.heavy_tallies_reference(traj, heavy,
                                                                q))


def test_shot_kernel_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    traj = torch.rand((2, 8, 4), device=cuda)
    heavy = torch.zeros((2, 8), dtype=torch.bool, device=cuda)
    q = torch.ones((8, 8), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        pallas_traj.heavy_tallies(traj.double(), heavy, q)
    with pytest.raises(TypeError, match="float32 or float64"):
        pallas_traj.heavy_tallies(traj, heavy, q.half())
    with pytest.raises(ValueError, match="shape"):
        pallas_traj.heavy_tallies(traj, heavy, q[:4])
    with pytest.raises(ValueError, match="2\\^depth"):
        pallas_traj.heavy_tallies(traj[:, :6], heavy, q)


@pytest.mark.parametrize("route", ["kernel", "ideal", "density",
                                   "two_shots_a_trajectory", "cpu"])
def test_shot_kernel_launches_only_on_its_route(cuda, route):
    """One launch a call where the kernels run and T = num_shots (one shot
    a trajectory); none on the ideal route, the density method, two shots a
    trajectory (``torch.multinomial`` with replacement) or the CPU."""
    dev = torch.device("cpu") if route == "cpu" else cuda
    kw = dict(kraus=depolarizing_pair(), noisy_method="trajectory")
    if route == "ideal":
        kw = {}
    elif route == "density":
        kw["noisy_method"] = "density"
    elif route == "two_shots_a_trajectory":
        kw["num_trajectories"] = 10
    before = pallas_traj.heavy_tallies.launches
    counts = quantum_volume.sample_heavy_outputs_batched(
        torch.Generator(device=dev).manual_seed(1), 4, 3, 20, device=dev,
        **kw)
    torch.cuda.synchronize()
    assert counts.shape == (3,)
    assert pallas_traj.heavy_tallies.launches == before + (route == "kernel")


def test_apg_float64_plain_route_on_the_card(case):
    """``use_pallas=False``: the plain version runs on the card in float64
    (the kernel takes only float32) and agrees with the CPU plain f64 solve
    to f64 round-off; no launch."""
    _, in64, n = case
    cfg = lanes_apg.HEADLINE_TUNED_2Q
    n = n[:4].double()
    before = lanes_apg.apg_fused.launches
    on_card = lanes_apg.apg_fused(in64.a, n, 4, a_pinv=in64.a_pinv,
                                  use_pallas=False, **cfg)
    on_cpu = lanes_apg.apg_fused(in64.a.cpu(), n.cpu(), 4,
                                 a_pinv=in64.a_pinv.cpu(), **cfg)
    assert lanes_apg.apg_fused.launches == before
    assert on_card.dtype == torch.complex128
    assert (on_card.cpu() - on_cpu).abs().max().item() <= 1e-9


def test_cp_project_float64_plain_route_on_the_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((8, 16, 16), generator=gen, device=cuda,
                    dtype=torch.complex128)
    h = (x + x.transpose(1, 2).conj()) / 2
    before = pallas_eigh.cp_project_pallas.launches
    out = pallas_eigh.cp_project_pallas(h, sweeps=6, use_pallas=False)
    assert pallas_eigh.cp_project_pallas.launches == before
    want = pallas_eigh.cp_project_reference(h.cpu(), 6)
    assert (out.cpu() - want).abs().max().item() <= 1e-12


SPLIT_2Q = dict(phases=((4, 2, 1, 0), (3, 1, 1), (3, 3, 2, 1)), init_iters=2,
                init_sweeps=3, final_iters=3, final_sweeps=2,
                final_sweeps_rest=1, mu=1.5 / 32)


def test_kernel_split_sweeps_against_plain_version(cuda):
    """A schedule with the 4-tuple phase form and ``final_sweeps_rest``, at
    B = 256: the kernel's max deviation from the plain f64 solve is at most
    twice the plain f32 solve's + 1e-5, as for the shipped schedules."""
    a = process_tomo_A_matrix(2)
    in32 = inputs_from_numpy(a, np.zeros((1, 1080)), device=cuda)
    in64 = inputs_from_numpy(a, np.zeros((1, 1080)), device=cuda,
                             dtype=torch.float64)
    gen = torch.Generator(device=cuda).manual_seed(256)
    n, _ = synth_process_datasets(gen, in32.a, 4, 256, 2000)
    _hold_against_plain(in32, in64, n, SPLIT_2Q)


# ---------------------------------------------------------------------------
# State tomography, the fitter and the RB simulator on the card: plain
# torch, held against their float64 runs on the CPU.

def _bloch_data(seed, batch, n_qubits=1, shots=2000):
    """Haar pure states' sampled Pauli expectations (numpy, float64)."""
    from forest_benchmarking_tpu_torch.utils import pauli_basis_matrices
    rng = np.random.RandomState(seed)
    obs = pauli_basis_matrices(n_qubits)[1:]
    d = 2 ** n_qubits
    psi = rng.randn(batch, d) + 1j * rng.randn(batch, d)
    psi /= np.linalg.norm(psi, axis=1, keepdims=True)
    exact = np.real(np.einsum("sij,bj,bi->bs", obs, psi, psi.conj()))
    e = 2 * rng.binomial(shots, (1 + exact) / 2) / shots - 1
    return obs, e, np.full((batch,), len(obs) * float(shots))


def test_bloch_mle_on_the_card(cuda):
    """Numpy inputs run on the card by default: float64 within 1e-9 of the
    CPU run, float32 within 1e-4."""
    from forest_benchmarking_tpu_torch import tomography
    obs, e, nm = _bloch_data(1, 4096)
    kw = dict(tol=1e-7, maxiter=60, warm_start=True, representation="bloch")
    cpu = tomography.iterative_mle_state_estimate_batched(
        obs, e, nm, device="cpu", **kw)
    card = tomography.iterative_mle_state_estimate_batched(obs, e, nm, **kw)
    assert card.device.type == "cuda" and card.dtype == torch.float64
    assert (card.cpu() - cpu).abs().max().item() < 1e-9
    card32 = tomography.iterative_mle_state_estimate_batched(
        obs, torch.tensor(e, dtype=torch.float32, device=cuda),
        torch.tensor(nm, device=cuda), **kw)
    assert card32.dtype == torch.float32
    assert (card32.cpu().double() - cpu).abs().max().item() < 1e-4


def test_general_mle_on_the_card(cuda):
    """The 2Q general loop (warm start) on the card, float64, within 1e-8
    of the CPU run (a problem may stop one step apart, by less than tol)."""
    from forest_benchmarking_tpu_torch import tomography
    obs, e, nm = _bloch_data(2, 16, n_qubits=2, shots=3000)
    kw = dict(tol=1e-9, maxiter=2000, warm_start=True)
    cpu = tomography.iterative_mle_state_estimate_batched(
        obs, e, nm, device="cpu", **kw)
    card = tomography.iterative_mle_state_estimate_batched(
        obs, e, nm, device=cuda, **kw)
    assert card.device.type == "cuda"
    assert (card.cpu() - cpu).abs().max().item() < 1e-8


def test_waterfilling_on_the_card(cuda):
    from forest_benchmarking_tpu_torch.ops.project_state_matrix import (
        project_state_matrix_to_physical)
    rng = np.random.RandomState(3)
    x = rng.randn(64, 4, 4) + 1j * rng.randn(64, 4, 4)
    h = torch.tensor((x + x.conj().transpose(0, 2, 1)) / 2 + np.eye(4))
    cpu = project_state_matrix_to_physical(h)
    card = project_state_matrix_to_physical(h.to(cuda))
    assert (card.cpu() - cpu).abs().max().item() < 1e-10
    card64 = project_state_matrix_to_physical(h.to(cuda, torch.complex64))
    assert (card64.cpu().to(cpu.dtype) - cpu).abs().max().item() < 1e-5


def test_lm_fit_on_the_card(cuda):
    """The float64 fit on the card within 1e-6 of the CPU's on the
    parameters and 1e-10 relative on the cost, on curves the fitter
    converges on (the JAX suite's batched case: 24 depths, decays in
    [0.85, 0.98]); the card's pow and fused multiply-adds move the step
    decisions that tie near a minimum, so a flat valley is left at a
    slightly different point. At config 3's 50 steps some curves are still
    sliding along such a valley, and round-off moves where they stop (2.4e-5
    seen on the card), so there the bar is float32 against float64: within
    1e-4 in mean |decay error|."""
    from forest_benchmarking_tpu_torch.analysis import fitting
    rng = np.random.RandomState(5)
    x = np.arange(1, 25).astype(float)
    decays = rng.uniform(0.85, 0.98, 256)
    y = 0.5 + 0.5 * decays[:, None] ** x + rng.normal(0, 0.005, (256, 24))
    p0 = [1.0, 0.9, 0.0]
    cpu, chi_cpu, _ = fitting.fit_model_batched(
        fitting._base_param_decay_p, x, y, None, p0, device="cpu")
    card, chi_card, _ = fitting.fit_model_batched(
        fitting._base_param_decay_p, x, y, None, p0)
    assert card.device.type == "cuda" and card.dtype == torch.float64
    assert (card.cpu() - cpu).abs().max().item() < 1e-6
    assert ((chi_card.cpu() - chi_cpu).abs() <= 1e-10 * chi_cpu).all()
    x = np.arange(2, 34, 4).astype(float)
    decays = rng.uniform(0.9, 0.995, 256)
    y = rng.binomial(500, 0.5 + 0.5 * decays[:, None] ** x) / 500
    p0 = [0.5, 0.95, 0.5]
    p64 = fitting.fit_model_batched(fitting._base_param_decay_p, x, y, None,
                                    p0, num_iters=50)[0]
    p32 = fitting.fit_model_batched(
        fitting._base_param_decay_p, torch.tensor(x, device=cuda),
        torch.tensor(y, dtype=torch.float32, device=cuda), None, p0,
        num_iters=50)[0]
    assert p32.dtype == torch.float32 and torch.isfinite(p32).all()
    truth = torch.tensor(decays, device=cuda)
    err32 = (p32[:, 1].double() - truth).abs().mean()
    err64 = (p64[:, 1] - truth).abs().mean()
    assert abs(err32 - err64).item() < 1e-4


def test_rb_simulator_on_the_card(cuda):
    from forest_benchmarking_tpu_torch import randomized_benchmarking as rb
    rng = np.random.RandomState(5)
    ptms = np.stack([np.stack([rb.unitary_to_ptm_np(np.linalg.qr(
        rng.randn(2, 2) + 1j * rng.randn(2, 2))[0]) for _ in range(6)])
        for _ in range(8)])
    noise = np.diag([1.0, 0.95, 0.95, 0.95])
    lengths = [6, 5, 4, 6, 3, 2, 6, 1]
    cpu = rb.simulate_rb_survival_batched(ptms, noise, lengths=lengths,
                                          device="cpu")
    card = rb.simulate_rb_survival_batched(ptms, noise, lengths=lengths)
    assert card.device.type == "cuda"
    assert (card.cpu() - cpu).abs().max().item() < 1e-10
    sampled = rb.simulate_rb_survival_batched(
        ptms, noise, torch.Generator(device=cuda).manual_seed(0),
        num_shots=1000, lengths=lengths)
    assert sampled.device.type == "cuda"
    assert torch.allclose(sampled * 1000, (sampled * 1000).round())
    with pytest.raises(ValueError, match="generator"):
        rb.simulate_rb_survival_batched(ptms, noise, torch.Generator(),
                                        num_shots=10)


def test_fits_run_on_the_card_by_default(cuda):
    from forest_benchmarking_tpu_torch import qubit_spectroscopy as qs
    from forest_benchmarking_tpu_torch import randomized_benchmarking as rb
    x = np.linspace(1, 40, 15)
    z = 1 - 2 * np.exp(-x / 12)
    cpu = qs.fit_t1_results(x, z, device="cpu")
    card = qs.fit_t1_results(x, z)
    assert abs(card.params["decay_time"].value
               - cpu.params["decay_time"].value) < 1e-6
    fit = rb.fit_rb_results([2, 4, 8, 16], [[0.9], [0.8], [0.65], [0.45]],
                            [[0.01]] * 4)
    assert np.isfinite(fit.params["decay"].value)


def _bcsz_pairs(batch: int, seed: int):
    """(c0, c1): float64 2Q BCSZ Choi matrices (Kraus rank 16) on the CPU."""
    from forest_benchmarking_tpu_torch.ops.random_operators import (
        rand_map_with_BCSZ_dist)
    g = torch.Generator().manual_seed(seed)
    return (rand_map_with_BCSZ_dist(g, 4, 16, batch=(batch,)),
            rand_map_with_BCSZ_dist(g, 4, 16, batch=(batch,)))


def _count_fused(monkeypatch):
    """A list that grows by one on each call of the fused planes solver."""
    from forest_benchmarking_tpu_torch.ops import lanes_dnorm
    calls, real = [], lanes_dnorm.dnorm_planes

    def counting(*args, **kwargs):
        calls.append(args[0].device)
        return real(*args, **kwargs)

    monkeypatch.setattr(lanes_dnorm, "dnorm_planes", counting)
    return calls


def test_dnorm_auto_takes_the_fused_route_on_the_card(cuda, monkeypatch):
    from forest_benchmarking_tpu_torch import distance_measures as dm
    c0, c1 = (c.to(cuda, torch.complex64) for c in _bcsz_pairs(8, 1))
    calls = _count_fused(monkeypatch)
    out = dm.diamond_norm_distance(c0, c1)
    assert len(calls) == 1 and calls[0].type == "cuda"
    assert out.shape == (8,) and out.device.type == "cuda"
    # an explicit dense knob takes the dense route, as in JAX
    dense = dm.diamond_norm_distance(c0, c1, num_iters=60)
    assert len(calls) == 1 and dense.device.type == "cuda"
    assert (dense - out).abs().max().item() < 1e-3


def test_dnorm_fused_f32_on_the_card_against_cpu_f64_gold(cuda):
    """8 2Q pairs: the card's f32 fused solve within 1e-5 of the CPU's f64
    dense gold (800 steps, fixed schedule, two restarts)."""
    from forest_benchmarking_tpu_torch import distance_measures as dm
    c0, c1 = _bcsz_pairs(8, 2)
    gold = dm.diamond_norm_distance(c0, c1, method="dense", num_iters=800,
                                    num_restarts=2, stop_tol=0.0)
    got = dm.diamond_norm_distance(c0.to(cuda, torch.complex64),
                                   c1.to(cuda, torch.complex64))
    assert got.dtype == torch.float32
    assert (got.cpu().double() - gold).abs().max().item() < 1e-5


def test_distance_step_f32_on_the_card_against_cpu_f64(cuda):
    """64 2Q pairs: Pauli-Liouville matrices, process fidelity and trace
    distance in f32 on the card within 1e-5 of f64 on the CPU."""
    from forest_benchmarking_tpu_torch import distance_measures as dm
    from forest_benchmarking_tpu_torch.ops.superoperator_transformations import (
        choi2pauli_liouville)
    c0, c1 = _bcsz_pairs(64, 3)
    k0, k1 = (c.to(cuda, torch.complex64) for c in (c0, c1))
    p0, p1 = choi2pauli_liouville(c0), choi2pauli_liouville(c1)
    q0 = choi2pauli_liouville(k0)
    assert q0.dtype == torch.complex64 and q0.device.type == "cuda"
    assert (q0.cpu().to(p0.dtype) - p0).abs().max().item() < 1e-5
    pf = dm.process_fidelity(q0, choi2pauli_liouville(k1))
    assert (pf.cpu().double() - dm.process_fidelity(p0, p1)).abs().max() < 1e-5
    td = dm.trace_distance(k0 / 4, k1 / 4)
    assert (td.cpu().double() - dm.trace_distance(c0 / 4, c1 / 4)).abs().max() \
        < 1e-5


def _noisy_circuit():
    from forest_benchmarking_tpu_torch.circuits import Circuit, CZ, H, RY, DELAY
    from forest_benchmarking_tpu_torch.sim.noise import pauli_kraus_map
    c = Circuit([H(0), RY(0.3, 2), CZ(0, 1), DELAY(5e-6, 2), CZ(1, 2)])
    c.define_noisy_gate("CZ", None, pauli_kraus_map(
        [0.97] + [0.002] * 15))
    c.define_noisy_readout(0, p00=0.98, p11=0.95)
    c.define_noisy_readout(2, p00=0.97, p11=0.9)
    return c


@pytest.mark.parametrize("dtype,bar", [(torch.complex128, 1e-12),
                                       (torch.complex64, 1e-6)])
def test_qvm_probabilities_on_the_card_equal_the_cpu(cuda, dtype, bar):
    """The QVM runs on the card by default; its probabilities (pure and
    density routes, marginalized, DELAY decoherence) equal the CPU's."""
    from forest_benchmarking_tpu_torch.circuits import Circuit, H, CNOT
    from forest_benchmarking_tpu_torch.sim import QVM
    kw = dict(dtype=dtype, t1s={2: 20e-6}, t2s={2: 15e-6})
    card, cpu = QVM(**kw), QVM(device="cpu", **kw)
    assert card.device.type == "cuda"
    for circ in (_noisy_circuit(), Circuit([H(0), CNOT(0, 1), CNOT(1, 3)])):
        for qubits in ([0, 1, 2], [2, 0], [3, 1]):
            p = card.probabilities(circ, qubits)
            assert p.is_cuda
            assert (p.cpu() - cpu.probabilities(circ, qubits)).abs().max() \
                <= bar
    bits = card.run_symmetrized_readout(_noisy_circuit(), 1001, -1, [0, 1, 2])
    assert bits.shape == (1001, 3)


def test_do_tomography_on_the_card(cuda):
    """A small ``do_tomography`` end to end on the card: the estimate lies
    there and is close to the CPU run's truth."""
    from forest_benchmarking_tpu_torch import distance_measures as dm
    from forest_benchmarking_tpu_torch.circuits import Circuit, CNOT, H, X
    from forest_benchmarking_tpu_torch.ops import (
        choi2pauli_liouville, kraus2choi)
    from forest_benchmarking_tpu_torch.sim import QVM
    from forest_benchmarking_tpu_torch.tomography import do_tomography
    rho, _, _ = do_tomography(QVM(seed=1), Circuit([H(0), CNOT(0, 1)]),
                              [0, 1], "state", num_shots=2000)
    assert rho.is_cuda
    bell = torch.zeros(4, dtype=rho.dtype, device=cuda)
    bell[0] = bell[3] = 2 ** -0.5
    assert dm.fidelity(torch.outer(bell, bell.conj()), rho).item() > 0.95
    choi, _, _ = do_tomography(QVM(seed=2), Circuit([X(0)]), [0], "process")
    assert choi.is_cuda
    x = torch.tensor([[0, 1], [1, 0]], dtype=choi.dtype, device=cuda)
    truth = kraus2choi(x[None])
    assert dm.process_fidelity(choi2pauli_liouville(truth),
                               choi2pauli_liouville(choi)).item() > 0.95


def test_do_rb_on_the_card_equals_the_cpu(cuda):
    """``do_rb`` (1Q) runs its circuits and its fit on the card; the
    probabilities of its programs equal the CPU's (complex128)."""
    from forest_benchmarking_tpu_torch.observable_estimation import (
        generate_experiment_programs)
    from forest_benchmarking_tpu_torch.randomized_benchmarking import do_rb
    from forest_benchmarking_tpu_torch.sim import QVM
    depths = [d for d in [2, 6, 10] for _ in range(3)]
    card = QVM(seed=5)
    assert card.device.type == "cuda"
    decays, expts, results = do_rb(card, [(0,)], depths, num_shots=100,
                                   random_seed=7)
    assert 0.9 <= decays[(0,)] <= 1.1
    cpu = QVM(device="cpu")
    for expt in expts:
        for p, q in zip(*generate_experiment_programs(expt)):
            assert (card.probabilities(p, q).cpu()
                    - cpu.probabilities(p, q)).abs().max() <= 1e-12


def test_do_dfe_on_the_card_equals_the_cpu(cuda):
    """``do_dfe`` of a 2Q Clifford from the enumerated group, process and
    state, on the card: fidelity near one, and the probabilities of its
    programs (calibration programs included) equal the CPU's."""
    import numpy as np
    from forest_benchmarking_tpu_torch.clifford import (
        random_clifford_circuits)
    from forest_benchmarking_tpu_torch.direct_fidelity_estimation import (
        do_dfe)
    from forest_benchmarking_tpu_torch.observable_estimation import (
        generate_experiment_programs, get_calibration_program)
    from forest_benchmarking_tpu_torch.sim import QVM
    (program,), _ = random_clifford_circuits([0, 1], 1,
                                             np.random.RandomState(12))
    card, cpu = QVM(seed=3), QVM(device="cpu")
    for kind in ("process", "state"):
        (fid, _), expt, results = do_dfe(card, program, [0, 1], kind,
                                         num_shots=500)
        assert fid > 0.95
        programs, meas = generate_experiment_programs(expt)
        obs = list(dict.fromkeys(r.setting.observable.copy(coefficient=1.0)
                                 for r in results))
        programs += [get_calibration_program(o, program) for o in obs]
        meas += [o.get_qubits() for o in obs]
        for p, q in zip(programs, meas):
            assert (card.probabilities(p, q).cpu()
                    - cpu.probabilities(p, q)).abs().max() <= 1e-12


@pytest.mark.parametrize("shards", [2, 4])
def test_apg_fused_sharded_equals_unsharded_on_the_card(cuda, shards):
    """The kernel is elementwise in the batch, and the warm start's product
    runs in fixed blocks: the sharded solve is bitwise the unsharded one,
    one launch a shard (B = 8192 was summed otherwise than 16384 before)."""
    from forest_benchmarking_tpu_torch.parallel import make_mesh
    a = torch.tensor(process_tomo_A_matrix(2), dtype=torch.complex64,
                     device=cuda)
    a_pinv = torch.linalg.pinv(a)
    gen = torch.Generator(device=cuda).manual_seed(7)
    n, _ = synth_process_datasets(gen, a, 4, 8192, 2000)
    cfg = lanes_apg.HEADLINE_TUNED_2Q
    want = lanes_apg.apg_fused(a, n, 4, a_pinv=a_pinv, **cfg)
    before = lanes_apg.apg_fused.launches
    got = lanes_apg.apg_fused_sharded(a, n, make_mesh([cuda] * shards),
                                      dim=4, a_pinv=a_pinv, **cfg)
    torch.cuda.synchronize()
    assert lanes_apg.apg_fused.launches == before + shards
    assert got.device == cuda and torch.equal(got, want)


def test_sample_heavy_outputs_sharded_on_the_card(cuda):
    """Sharded QV on a mesh that repeats the card: bitwise the per-shard
    runs with ``fold_in``, one launch of each kernel a shard."""
    from forest_benchmarking_tpu_torch.parallel import fold_in, make_mesh
    ks = depolarizing_kraus_map(0.02)
    kraus = np.stack([np.kron(x, y) for x in ks for y in ks])
    parent = torch.Generator(device=cuda).manual_seed(11)
    for kw, traj_launches in (({}, 0), (dict(
            kraus=kraus, noisy_method="trajectory", num_trajectories=100),
            2)):
        ideal0 = pallas_traj.ideal_probs.launches
        traj0 = pallas_traj.traj_probs.launches
        got = quantum_volume.sample_heavy_outputs_sharded(
            parent, make_mesh([cuda, cuda]), depth=8, num_circuits=64,
            num_shots=200, **kw)
        torch.cuda.synchronize()
        assert pallas_traj.ideal_probs.launches == ideal0 + 2
        assert pallas_traj.traj_probs.launches == traj0 + traj_launches
        want = torch.cat([quantum_volume.sample_heavy_outputs_batched(
            fold_in(parent, i, cuda), 8, 32, 200, device=cuda, **kw)
            for i in range(2)])
        assert torch.equal(got, want)


def test_dryrun_multichip_on_the_card(cuda):
    """``entry.dryrun_multichip(2)`` on the card (its mesh repeats the card
    where the machine has one): all five legs pass their bars, the sharded
    APG solve and ideal QV bitwise, and the APG, trajectory and ideal
    kernels launch."""
    from forest_benchmarking_tpu_torch import entry
    before = {f: f.launches for f in (lanes_apg.apg_fused,
                                      pallas_traj.traj_probs,
                                      pallas_traj.ideal_probs)}
    out = entry.dryrun_multichip(2)
    torch.cuda.synchronize()
    assert out["fused_shard_gap"] == 0.0
    assert 0.08 < out["fused_mean_rel"] < 0.20
    assert out["dnorm_shard_gap"] < 1e-5
    for f, n in before.items():
        assert f.launches > n, f.__name__


def test_qv_takes_a_card_generator_made_without_an_index(cuda):
    """``torch.Generator(device="cuda")`` (as the notebooks make it) draws
    on the current card: the batched QV entry points take it with
    ``device="cuda"`` and give what a generator on ``cuda:0`` gives."""
    runs = [quantum_volume.measure_quantum_volume_batched(
        torch.Generator(device=d).manual_seed(3), max_depth=3,
        num_circuits=16, num_shots=50, device=d)
        for d in ("cuda", cuda)]
    assert runs[0] == runs[1]


def test_bench_throughput_on_the_card(cuda):
    """The config-2 harness at B = 1024 on the card: both fused figures
    measured, no stage failed, and the quality bars of ``chip_smoke.py``
    phase 23 (mean relative Frobenius error < 0.12 for both schedules)."""
    from forest_benchmarking_tpu_torch import bench
    errors = {}
    before = lanes_apg.apg_fused.launches
    perf = bench.throughput(errors, comparisons=False, batch=1024)
    assert errors == {}
    assert lanes_apg.apg_fused.launches > before
    assert perf["batch"] == 1024
    for key in ("solves_per_sec", "sustained_solves_per_sec",
                "parity_solves_per_sec", "parity_achieved_gflops"):
        assert perf[key] > 0, key
    assert perf["mean_rel_frob_err"] < 0.12
    assert perf["mean_rel_frob_err_parity"] < 0.12
    assert 0 < perf["parity_fraction_f32_peak"] < 1


def test_fused_entry_reuses_pinv_of_one_a_matrix_on_the_card(cuda):
    """Two calls of the fused entry with one A-matrix at B = 41: the first
    computes pinv(A), the second takes it from the cache (one reuse, no
    second pinv) and gives bitwise the first call's estimates."""
    from forest_benchmarking_tpu_torch import tomography
    a = torch.tensor(process_tomo_A_matrix(2), dtype=torch.complex64,
                     device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(41)
    n, _ = synth_process_datasets(gen, a, 4, 41, 2000)
    kw = dict(dim=4, method="apg", cp_method="pallas",
              fused_schedule="headline")
    fn = lanes_apg.apg_fused
    computed, reused = fn.pinv_computed, fn.pinv_reused
    first = tomography.pgdb_process_estimate_batched(a, n, **kw)
    assert (fn.pinv_computed, fn.pinv_reused) == (computed + 1, reused)
    second = tomography.pgdb_process_estimate_batched(a, n, **kw)
    torch.cuda.synchronize()
    assert (fn.pinv_computed, fn.pinv_reused) == (computed + 1, reused + 1)
    assert torch.equal(second, first)
