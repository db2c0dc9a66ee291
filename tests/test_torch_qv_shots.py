"""The trajectory route's shots: ``ops/pallas_traj.heavy_tallies`` and the
kernel of ``csrc/qv_shots.cu``.

The plain version is held bitwise against ``torch.multinomial(rows, 1,
replacement=True)`` on the same generator (the tallies and the generator's
state after), and to its errors; the kernel's own source, built for the host
with g++ against ``tests/cuda_host/cuda_runtime.h``, is held bitwise
against the plain version (ties, tails of a block of trajectories, both
dtypes of the variates, the rows' checks); and the batched QV entry point's
one-pass route, run on the CPU with the plain versions in the kernels'
place, gives bitwise what its ``torch.multinomial`` route gives. On the
card: ``tests/test_torch_cuda.py``."""
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from forest_benchmarking_tpu_torch import kernels, quantum_volume
from forest_benchmarking_tpu_torch.ops import pallas_traj
from forest_benchmarking_tpu_torch.sim.noise import depolarizing_kraus_map

torch.set_num_threads(1)

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def shots_case(seed, circuits, depth, n_traj):
    """(C, 2^d, T) float32 trajectory probabilities (each column sums to
    one) and (C, 2^d) heavy sets, from a seeded generator."""
    g = torch.Generator().manual_seed(seed)
    traj = torch.rand((circuits, 2 ** depth, n_traj), generator=g)
    traj = traj / traj.sum(1, keepdim=True)
    heavy = torch.rand((circuits, 2 ** depth), generator=g) > 0.5
    return traj, heavy


def multinomial_tallies(traj, heavy, dtype, generator):
    """The route's tallies before the shot kernel: the transposed copy,
    ``torch.multinomial`` of one sample, ``gather`` and ``sum``."""
    c, n, t = traj.shape
    rows = traj.to(dtype).transpose(1, 2).reshape(c * t, n)
    samples = torch.multinomial(rows, 1, replacement=True, generator=generator)
    return torch.gather(heavy, 1, samples.reshape(c, t)).sum(1)


def exponential(traj, dtype, generator):
    c, n, t = traj.shape
    return torch.empty((c * t, n), dtype=dtype).exponential_(
        generator=generator)


def tied_case(seed, circuits, depth, n_traj):
    """Rows with three exact ties for the largest quotient: p = m 2^k and
    q = 2^k at three random outputs, every other quotient below m. Returns
    (traj, heavy, q, first), ``first`` the (C, T) lowest tied output."""
    traj, heavy = shots_case(seed, circuits, depth, n_traj)
    g = torch.Generator().manual_seed(seed + 1)
    n = 2 ** depth
    rows = traj.transpose(1, 2).reshape(-1, n).clone()
    q = torch.ones_like(rows)
    ties = torch.stack([torch.randperm(n, generator=g)[:3]
                        for _ in range(rows.shape[0])])
    scale = torch.tensor([0.5, 1.0, 2.0])
    m = 2.0
    rows.scatter_(1, ties, m * scale.expand_as(ties))
    q.scatter_(1, ties, scale.expand_as(ties))
    traj = rows.reshape(circuits, n_traj, n).transpose(1, 2).contiguous()
    return traj, heavy, q, ties.min(1).values.reshape(circuits, n_traj)


@pytest.mark.parametrize("seed", [1, 2, 2 ** 31 + 11])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("depth", [2, 5, 8, 10])
def test_plain_version_is_torch_multinomial(depth, dtype, seed):
    """On one generator state: the multinomial route's tallies bitwise, and
    the generator's state after the draw equal to the multinomial's."""
    traj, heavy = shots_case(seed, 3, depth, 37)
    g_old = torch.Generator().manual_seed(seed)
    g_new = torch.Generator().manual_seed(seed)
    want = multinomial_tallies(traj, heavy, DTYPES[dtype], g_old)
    got = pallas_traj.heavy_tallies_reference(
        traj, heavy, exponential(traj, DTYPES[dtype], g_new))
    assert got.dtype == torch.int64 and torch.equal(got, want)
    assert torch.equal(g_new.get_state(), g_old.get_state())


def _spoil(traj, how):
    traj = traj.clone()
    if how == "nan":
        traj[1, 2, 5] = float("nan")
    elif how == "inf":
        traj[0, 0, 3] = float("inf")
    elif how == "negative":
        traj[1, 3, 0] = -1e-30
    elif how == "zero_sum":
        traj[0, :, 7] = 0.0
    return traj


@pytest.mark.parametrize("how", ["nan", "inf", "negative", "zero_sum"])
def test_plain_version_raises_what_multinomial_raises(how):
    traj, heavy = shots_case(4, 2, 3, 9)
    traj = _spoil(traj, how)
    with pytest.raises(RuntimeError) as want:
        multinomial_tallies(traj, heavy, torch.float32, torch.Generator())
    with pytest.raises(RuntimeError) as got:
        pallas_traj.heavy_tallies_reference(
            traj, heavy, exponential(traj, torch.float32, torch.Generator()))
    assert str(got.value) == str(want.value)
    assert str(got.value) in (pallas_traj.NOT_A_DISTRIBUTION,
                              pallas_traj.ZERO_SUM)


def test_a_negative_zero_is_a_probability():
    """-0.0 passes multinomial's check (it is not < 0), so it passes here."""
    traj, heavy = shots_case(5, 2, 3, 4)
    traj[0, 1, 2] = -0.0
    q = exponential(traj, torch.float32, torch.Generator().manual_seed(1))
    want = multinomial_tallies(traj, heavy, torch.float32,
                               torch.Generator().manual_seed(1))
    assert torch.equal(pallas_traj.heavy_tallies_reference(traj, heavy, q),
                       want)


@pytest.mark.parametrize("depth", [2, 8])
def test_plain_version_breaks_ties_to_the_lowest_output(depth):
    traj, heavy, q, first = tied_case(6, 2, depth, 20)
    got = pallas_traj.heavy_tallies_reference(traj, heavy, q)
    assert torch.equal(got, torch.gather(heavy, 1, first).sum(1))


def test_dispatch_runs_the_plain_version_on_the_cpu():
    traj, heavy = shots_case(7, 2, 4, 5)
    q = exponential(traj, torch.float32, torch.Generator())
    before = pallas_traj.heavy_tallies.launches
    assert torch.equal(pallas_traj.heavy_tallies(traj, heavy, q),
                       pallas_traj.heavy_tallies_reference(traj, heavy, q))
    assert pallas_traj.heavy_tallies.launches == before


def test_cuda_source_depths_match_python():
    src = (kernels.CSRC / "qv_shots.cu").read_text()

    def define(name):
        return int(re.search(rf"#define {name} (\d+)", src).group(1))

    assert define("QV_SHOTS_MIN_DEPTH") == pallas_traj.MIN_DEPTH
    assert define("QV_SHOTS_MAX_DEPTH") == pallas_traj.MAX_DEPTH
    names = set(re.findall(
        r"__global__ void(?: __launch_bounds__\(\w+\))?\s+(\w+)\(", src))
    assert names == {"heavy_tally_kernel"}
    # the benchmark finds the QV kernels' device time by these substrings
    assert not any(k in src for k in ("traj_probs_kernel",
                                      "ideal_probs_kernel"))


# --- the kernel's own source, built for the host ---------------------------

# reads (argv) q's bytes a value, depth, C, T, an input file holding traj
# (float32), q and heavy (uint8) raw one after another, and writes the C + 4
# int64 outputs raw to the output file
HOST_MAIN = r"""
#include <cstdio>
int main(int argc, char** argv) {
  const int q_bytes = atoi(argv[1]), depth = atoi(argv[2]), c = atoi(argv[3]),
            t = atoi(argv[4]);
  const size_t n = size_t(1) << depth, cells = size_t(c) * n * t;
  std::vector<float> traj(cells);
  std::vector<double> q((cells * q_bytes + 7) / 8);   // 16-byte aligned
  std::vector<unsigned char> heavy(size_t(c) * n);
  FILE* f = fopen(argv[5], "rb");
  if (fread(traj.data(), 4, cells, f) != cells ||
      fread(q.data(), q_bytes, cells, f) != cells ||
      fread(heavy.data(), 1, heavy.size(), f) != heavy.size()) return 2;
  fclose(f);
  std::vector<unsigned long long> out(c + 4, 0);
  const int err = heavy_tallies_launch(traj.data(), q.data(), heavy.data(),
                                       out.data(), c, depth, t, q_bytes,
                                       nullptr);
  f = fopen(argv[6], "wb");
  fwrite(out.data(), 8, out.size(), f);
  fclose(f);
  return err;
}
"""


@pytest.fixture(scope="module")
def host_shots(tmp_path_factory):
    """The host build of the shot kernel: ``run(traj, heavy, q)`` -> the
    (C,) tallies, the two checks' counts (rows with a NaN, an infinity or a
    negative element; rows all zero) and the flag the last block sets (1
    where both are 0). Holds the blocks' tickets to the number of blocks."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ (C++20) to build the kernel source for the host")
    out = tmp_path_factory.mktemp("qv_shots_host")
    src = (kernels.CSRC / "qv_shots.cu").read_text()
    line = "extern __shared__ __align__(16) unsigned char shots_smem[];"
    assert src.count(line) == 1
    src = src.replace(line, "unsigned char* shots_smem = emu::blk->smem.data();")
    # kernel<Q, W><<<grid, block, smem, stream>>>(args) -> emu::launch(...)
    src, launches = re.subn(r"(\w+<[^<>]*>)<<<(.*?)>>>\(",
                            r"emu::launch(\1, \2, ", src, flags=re.S)
    assert launches == 1
    (out / "shots.cpp").write_text(src + HOST_MAIN)
    subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-w",
                    f"-I{kernels.CSRC.parents[1] / 'tests' / 'cuda_host'}",
                    "-o", str(out / "shots"), str(out / "shots.cpp")],
                   check=True, capture_output=True)

    def run(traj, heavy, q):
        c, n, t = traj.shape
        (out / "in.bin").write_bytes(
            traj.numpy().astype(np.float32).tobytes() + q.numpy().tobytes()
            + heavy.numpy().astype(np.uint8).tobytes())
        subprocess.run([str(out / "shots"), str(q.element_size()),
                        str(n.bit_length() - 1), str(c), str(t),
                        str(out / "in.bin"), str(out / "out.bin")], check=True)
        got = torch.from_numpy(np.fromfile(out / "out.bin", dtype=np.int64))
        assert int(got[c + 2]) == c * -(-t // 128)
        return got[:c], int(got[c]), int(got[c + 1]), int(got[c + 3])
    return run


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("depth,n_traj", [
    (2, 37), (3, 130), (4, 1), (5, 128), (8, 130), (10, 37)])
def test_host_built_kernel_is_the_plain_version(host_shots, depth, n_traj,
                                                 dtype):
    """Every step width (4, 8, 16 and 32 outputs), T below, at and above a
    block of 128 trajectories, float32 and float64 variates: the tallies
    bitwise, no row counted by the checks."""
    traj, heavy = shots_case(10 + depth, 3, depth, n_traj)
    q = exponential(traj, DTYPES[dtype], torch.Generator().manual_seed(depth))
    tallies, bad, zero, ok = host_shots(traj, heavy, q)
    assert torch.equal(tallies,
                       pallas_traj.heavy_tallies_reference(traj, heavy, q))
    assert (bad, zero, ok) == (0, 0, 1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("depth", [3, 8])
def test_host_built_kernel_breaks_ties_to_the_lowest_output(host_shots, depth,
                                                            dtype):
    traj, heavy, q, first = tied_case(20 + depth, 2, depth, 150)
    tallies, _, _, _ = host_shots(traj, heavy, q.to(DTYPES[dtype]))
    assert torch.equal(tallies, torch.gather(heavy, 1, first).sum(1))


def test_host_built_kernel_takes_a_nan_quotient_as_the_largest(host_shots):
    """Crafted q: 0 / 0 is NaN, which ATen's argmax takes over any number
    (the first NaN of a row)."""
    traj, heavy = shots_case(30, 2, 5, 40)
    q = exponential(traj, torch.float32, torch.Generator().manual_seed(3))
    traj[0, 7, :10] = 0.0
    traj[0, 9, :10] = 0.0
    q[:10, 7] = 0.0
    q[:10, 9] = 0.0
    want = pallas_traj.heavy_tallies_reference(traj, heavy, q)
    assert torch.equal(host_shots(traj, heavy, q)[0], want)


@pytest.mark.parametrize("how", ["nan", "inf", "negative", "zero_sum"])
def test_host_built_kernel_counts_the_rows_multinomial_refuses(host_shots,
                                                               how):
    traj, heavy = shots_case(40, 2, 3, 9)
    traj = _spoil(traj, how)
    _, bad, zero, ok = host_shots(traj, heavy, exponential(
        traj, torch.float32, torch.Generator()))
    assert (bad, zero, ok) == ((0, 1, 0) if how == "zero_sum" else (1, 0, 0))


# --- the batched QV entry point's route ------------------------------------

@pytest.mark.parametrize("depth,n_traj", [(3, 1), (5, 37), (8, 20)])
def test_one_pass_route_gives_the_multinomial_routes_tallies(
        monkeypatch, depth, n_traj):
    """``sample_heavy_outputs_batched`` on the CPU, once as it runs there
    (``torch.multinomial``) and once routed as on the card, with the plain
    versions in the kernels' place (the one-pass route: the exponential
    draw and ``heavy_tallies``): bitwise the same tallies and generator
    state, float32. No kernel launch is counted on the CPU."""
    ks = depolarizing_kraus_map(0.05)
    kraus = np.stack([np.kron(a, b) for a in ks for b in ks])

    def run():
        g = torch.Generator().manual_seed(100 + depth)
        counts = quantum_volume.sample_heavy_outputs_batched(
            g, depth, 3, n_traj, kraus=kraus, noisy_method="trajectory",
            device="cpu")
        return counts, g.get_state()

    plain = run()
    before = pallas_traj.heavy_tallies.launches
    calls = []
    real = pallas_traj.heavy_tallies
    monkeypatch.setattr(quantum_volume, "_use_kernels", lambda d, dev: True)
    monkeypatch.setattr(pallas_traj, "heavy_tallies",
                        lambda *a: calls.append(1) or real(*a))
    one_pass = run()
    assert calls == [1]
    assert torch.equal(one_pass[0], plain[0])
    assert torch.equal(one_pass[1], plain[1])
    assert real.launches == before
