"""The port's quantum-volume kernel modules against the JAX package: index
maps, the plain versions of the ideal and trajectory kernels (against the
JAX simulators in f64 and the Pallas kernels in interpret mode, f32), the
ideal kernel's own source built for the host, the CPU dispatch, the
wrappers' input checks and the FLOP count.

Inputs are made with numpy from a seed and fed to both packages through
``qv_inputs_from_numpy``."""
import importlib.util
import re
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forest_benchmarking_tpu import quantum_volume as jax_qv
from forest_benchmarking_tpu.ops import pallas_traj as jax_traj
from forest_benchmarking_tpu_torch import kernels, quantum_volume
from forest_benchmarking_tpu_torch.benchmarks import qv_inputs_from_numpy
from forest_benchmarking_tpu_torch.ops import pallas_traj
from forest_benchmarking_tpu_torch.sim.noise import depolarizing_kraus_map

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _script(path):
    """The module of a script of the repository, imported from its file."""
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def qv_stack(seed, circuits, depth, n_traj=None):
    """(perms, gates, uniforms) of ``circuits`` model circuits, in numpy."""
    rng = np.random.default_rng(seed)
    perms = np.stack([[rng.permutation(depth) for _ in range(depth)]
                      for _ in range(circuits)])
    z = rng.standard_normal((circuits, depth, depth // 2, 4, 4, 2)) @ [1, 1j]
    q, r = np.linalg.qr(z)
    diag = np.diagonal(r, axis1=-2, axis2=-1)
    gates = q * (diag / np.abs(diag))[..., None, :]
    uniforms = (None if n_traj is None
                else rng.random((circuits, depth, depth // 2, n_traj)))
    return perms, gates, uniforms


def depolarizing_2q(p):
    ks = depolarizing_kraus_map(p)
    return np.stack([np.kron(a, b) for a in ks for b in ks])


def jax_traj_reference(perms, gates, kraus, uniforms, depth):
    """JAX ``_simulate_qv_circuit_traj`` over a circuit batch."""
    kraus = jnp.asarray(kraus)
    m_ops = jnp.einsum("kba,kbc->kac", jnp.conj(kraus), kraus)
    return np.asarray(jax.vmap(
        lambda p, g, u: jax_qv._simulate_qv_circuit_traj(
            p, g, kraus, m_ops, u, depth))(
        jnp.asarray(perms), jnp.asarray(gates), jnp.asarray(uniforms)))


def planes(x):
    return jnp.asarray(np.stack([x.real, x.imag]).astype(np.float32))


# --- index maps ----------------------------------------------------------

@pytest.mark.parametrize("depth", range(2, 9))
def test_index_maps_equal_jax(depth):
    perms, _, _ = qv_stack(depth, 3, depth)
    got = pallas_traj._boundary_maps(torch.tensor(perms), depth).numpy()
    for c in range(3):
        want = np.asarray(jax_traj._boundary_maps(jnp.asarray(perms[c]), depth))
        np.testing.assert_array_equal(got[c], want)
        for layer in range(depth):
            np.testing.assert_array_equal(
                quantum_volume._bit_permute_indices(
                    torch.tensor(perms[c, layer]), depth).numpy(),
                np.asarray(jax_qv._bit_permute_indices(
                    jnp.asarray(perms[c, layer]), depth)))


@pytest.mark.parametrize("depth", range(2, 11))
def test_boundary_source_bits_equal_jax(depth):
    """The source bit positions the ideal kernel forms from the
    permutations, expanded to full maps (h_l[x] = sum_k bit_k(x) << P[l, k]),
    are the JAX package's boundary maps, at every depth the kernels take."""
    perms, _, _ = qv_stack(30 + depth, 3, depth)
    bits = pallas_traj._boundary_source_bits(torch.tensor(perms), depth)
    assert bits.shape == (3, depth + 1, depth)
    x = np.arange(2 ** depth)
    got = sum(((x >> k) & 1) << bits[..., k, None].numpy()
              for k in range(depth))
    for c in range(3):
        want = np.asarray(jax_traj._boundary_maps(jnp.asarray(perms[c]), depth))
        np.testing.assert_array_equal(got[c], want)


# --- ideal probabilities -------------------------------------------------

@pytest.mark.parametrize("depth", range(2, 9))
def test_ideal_reference_matches_jax_simulator(depth):
    """f64, same operations up to summation order: 1e-12."""
    perms, gates, _ = qv_stack(10 + depth, 2, depth)
    inp = qv_inputs_from_numpy(perms, gates, device="cpu", dtype=torch.float64)
    got = pallas_traj.ideal_probs_reference(inp.perms, inp.gates, depth)
    want = np.asarray(jax.vmap(
        lambda p, g: jax_qv._simulate_qv_circuit(p, g, depth))(
        jnp.asarray(perms), jnp.asarray(gates)))
    assert got.shape == (2, 2 ** depth) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12)


@pytest.fixture(scope="module")
def ideal_depth7():
    """The JAX Pallas ideal kernel in interpret mode, computed once."""
    perms, gates, _ = qv_stack(7, 2, 7)
    gates = gates.astype(np.complex64)
    pal = np.asarray(jax_traj.ideal_probs_pallas(
        jnp.asarray(perms), planes(gates), 7, interpret=True))
    return perms, gates, pal


def test_ideal_reference_matches_pallas_interpret(ideal_depth7):
    """f32 at depth 7 (an odd depth): the JAX package's own bar, 2e-6."""
    perms, gates, pal = ideal_depth7
    inp = qv_inputs_from_numpy(perms, gates, device="cpu")
    got = pallas_traj.ideal_probs_reference(inp.perms, inp.gates, 7)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), pal, atol=2e-6)
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-5)


# The QV kernels' CUDA source, built with g++ against
# tests/cuda_host/cuda_runtime.h: each thread of a block runs as a host
# thread, each shuffle and __syncwarp on a barrier of the warp's lanes. The
# CPU suite so runs the kernels' own code (for the ideal kernel the lane
# groups of the packed depths, the boundary words formed from the
# permutations, the register and lane bit swaps, the tails); only the card
# can show that nvcc takes it and time it (tests/test_torch_cuda.py,
# chip_smoke.py). The program reads its inputs from argv[3], one raw array
# after another, and writes the output to argv[4].
HOST_MAIN = r"""
#include <cstdio>
template <class T> std::vector<T> take(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (fread(v.data(), sizeof(T), n, f) != n) exit(2);
  return v;
}
int main(int argc, char** argv) {
  const bool ideal = argv[1][0] == 'i';
  const int depth = atoi(argv[2]), c = atoi(argv[5]), k = atoi(argv[6]),
            t = atoi(argv[7]);
  const size_t n = size_t(1) << depth, g = size_t(c) * depth * (depth / 2);
  FILE* f = fopen(argv[3], "rb");
  std::vector<float> out(c * n * (ideal ? 1 : t));
  int err;
  if (ideal) {
    auto perms = take<long long>(f, size_t(c) * depth * depth);
    auto gates = take<float>(f, g * 32);
    err = ideal_probs_launch(perms.data(), gates.data(), out.data(), c, depth,
                             nullptr);
  } else {
    auto hmaps = take<int>(f, size_t(c) * (depth + 1) * n);
    auto gates = take<float>(f, g * 32);
    auto kraus = take<float>(f, size_t(k) * 32);
    auto uniforms = take<float>(f, g * t);
    err = traj_probs_launch(hmaps.data(), gates.data(), kraus.data(),
                            uniforms.data(), out.data(), c, depth, k, t,
                            nullptr);
  }
  fclose(f);
  f = fopen(argv[4], "wb");
  fwrite(out.data(), 4, out.size(), f);
  fclose(f);
  return err;
}
"""


@pytest.fixture(scope="module")
def host_qv(tmp_path_factory):
    """Run the host build of the QV kernels: ``run(kernel, depth, out_shape,
    *arrays, c=, k=, t=)`` writes the arrays raw, in order, as the kernel's
    inputs and returns its float32 output."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ (C++20) to build the kernel source for the host")
    out = tmp_path_factory.mktemp("qv_host")
    src = (kernels.CSRC / "qv_traj.cu").read_text()
    for kind, name in (("float", "smem"), ("unsigned char", "ideal_smem")):
        line = f"extern __shared__ __align__(16) {kind} {name}[];"
        assert src.count(line) == 1, line
        src = src.replace(line, f"{kind}* {name} = reinterpret_cast<{kind}*>"
                                f"(emu::blk->smem.data());")
    # kernel<D><<<grid, block, smem, stream>>>(args) -> emu::launch(...)
    src = re.sub(r"(\w+<\w+>)<<<(.*?)>>>\(", r"emu::launch(\1, \2, ", src,
                 flags=re.S)
    (out / "qv_host.cpp").write_text(src + HOST_MAIN)
    subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-w",
                    f"-I{ROOT / 'tests' / 'cuda_host'}", "-o",
                    str(out / "qv_host"), str(out / "qv_host.cpp")],
                   check=True, capture_output=True)

    def run(kernel, depth, shape, *arrays, k=0, t=0):
        (out / "in.bin").write_bytes(b"".join(a.tobytes() for a in arrays))
        subprocess.run([str(out / "qv_host"), kernel, str(depth),
                        str(out / "in.bin"), str(out / "out.bin"),
                        str(shape[0]), str(k), str(t)], check=True)
        return np.fromfile(out / "out.bin", dtype=np.float32).reshape(shape)
    return run


@pytest.fixture(scope="module")
def host_ideal(host_qv):
    """The host build's ideal kernel: (perms, gates, depth) numpy arrays ->
    (C, 2^depth) float32."""
    def ideal(perms, gates, depth):
        return host_qv("ideal", depth, (len(perms), 2 ** depth),
                       perms.astype(np.int64), gates.astype(np.complex64))
    return ideal


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("depth", range(2, 11))
def test_host_built_ideal_kernel_matches_jax(host_ideal, depth, tail):
    """At every depth the kernel takes, at C = 16 and at chip_smoke.py's
    tail count (the last block part empty, and the last warp's lane groups
    below depth 7): within 1e-5 of the JAX simulator in f64 and 2e-6 of the
    plain version in f32, the card's bars."""
    smoke = _script(ROOT / "chip_smoke.py")
    c = smoke.ideal_tail_circuits(depth) if tail else 16
    perms, gates, _ = qv_stack(50 + depth, c, depth)
    gates = gates.astype(np.complex64)
    got = host_ideal(perms, gates, depth)
    want = np.asarray(jax.vmap(
        lambda p, g: jax_qv._simulate_qv_circuit(p, g, depth))(
        jnp.asarray(perms), jnp.asarray(gates.astype(np.complex128))))
    inp = qv_inputs_from_numpy(perms, gates, device="cpu")
    plain = pallas_traj.ideal_probs_reference(inp.perms, inp.gates, depth)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, plain.numpy(), atol=2e-6, rtol=0)


@pytest.mark.parametrize("depth", [2, 4, 8])
def test_host_built_ideal_rows_do_not_depend_on_block_mates(host_ideal, depth):
    """A circuit's row is bitwise the same whichever circuits share its
    lane groups' warp and its block: the first rows rerun alone."""
    c = _script(ROOT / "chip_smoke.py").ideal_tail_circuits(depth)
    perms, gates, _ = qv_stack(60 + depth, c, depth)
    full = host_ideal(perms, gates, depth)
    for k in (1, 3, c - 2):
        np.testing.assert_array_equal(host_ideal(perms[:k], gates[:k], depth),
                                      full[:k])


@pytest.mark.parametrize("depth", [3, 6, 8])
def test_host_built_traj_kernel_against_plain_version(host_qv, depth):
    """The trajectory kernel's own code on the CPU, every layout kind (four
    amplitudes on part of the warp, on all of it, eight a lane), T = 20 (a
    part-full last block of 16): the card's bars, more than 97% of
    trajectories within 1e-4 of the plain f32 version, columns normalized
    to 1e-5. It shares the slot plan and the bit swaps with the ideal
    kernel."""
    perms, gates, u = qv_stack(70 + depth, 2, depth, n_traj=20)
    gates, u = gates.astype(np.complex64), u.astype(np.float32)
    kraus = depolarizing_2q(0.05).astype(np.complex64)
    hmaps = pallas_traj._boundary_maps(torch.tensor(perms), depth).numpy()
    got = host_qv("traj", depth, (2, 2 ** depth, 20), hmaps.astype(np.int32),
                  gates, kraus, u, k=len(kraus), t=20)
    inp = qv_inputs_from_numpy(perms, gates, kraus, u, device="cpu")
    plain = pallas_traj.traj_probs_reference(*inp, depth).numpy()
    assert (np.abs(got - plain).max(axis=1) < 1e-4).mean() > 0.97
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)


# --- trajectory probabilities -------------------------------------------

@pytest.mark.parametrize("depth", [4, 5])
def test_traj_reference_matches_jax_simulator(depth):
    """f64 on identical uniforms. The kernel's math weighs branches from the
    pre-gate state through M' and renormalizes once per layer, the JAX
    simulator from the post-gate state through K^dag K every slot: the same
    branch distribution, so columns agree to round-off except where u lies
    within round-off of a cumulative sum (a branch flip, all but absent in
    f64). Bar: 99% of trajectories within 1e-10."""
    perms, gates, u = qv_stack(20 + depth, 2, depth, n_traj=256)
    kraus = depolarizing_2q(0.1)
    inp = qv_inputs_from_numpy(perms, gates, kraus, u, device="cpu",
                               dtype=torch.float64)
    got = pallas_traj.traj_probs_reference(*inp, depth).numpy()
    want = jax_traj_reference(perms, gates, kraus, u, depth)
    assert got.shape == want.shape == (2, 2 ** depth, 256)
    col_diff = np.abs(got - want).max(axis=1)
    assert (col_diff < 1e-10).mean() >= 0.99
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-12)


@pytest.fixture(scope="module")
def traj_depth7():
    """The JAX Pallas trajectory kernel in interpret mode, computed once."""
    perms, gates, u = qv_stack(77, 2, 7, n_traj=128)
    gates = gates.astype(np.complex64)
    u = u.astype(np.float32)
    kraus = depolarizing_2q(0.06).astype(np.complex64)
    pal = np.asarray(jax_traj.traj_probs_pallas(
        jnp.asarray(perms), planes(gates), planes(kraus), jnp.asarray(u), 7,
        interpret=True))
    return perms, gates, kraus, u, pal


def test_traj_reference_matches_pallas_interpret(traj_depth7):
    """f32 at depth 7 on identical uniforms, with the JAX package's own bar
    (tests/test_quantum_volume.py): more than 97% of trajectories within
    1e-4 (branch flips where u is within f32 round-off of a cumulative
    sum), every column normalized to 1e-5."""
    perms, gates, kraus, u, pal = traj_depth7
    inp = qv_inputs_from_numpy(perms, gates, kraus, u, device="cpu")
    got = pallas_traj.traj_probs_reference(*inp, 7).numpy()
    assert got.shape == pal.shape == (2, 128, 128)
    col_diff = np.abs(got - pal).max(axis=1)
    assert (col_diff < 1e-4).mean() > 0.97
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)


def test_branch_index_clamps_to_last_operator():
    """u = 1 leaves every cumulative sum at or below u, so the rule would
    index K; the plain version clamps to K - 1 (JAX's gather clamps
    silently) and so applies the last Kraus operator at every slot."""
    depth = 4
    perms, gates, _ = qv_stack(5, 2, depth)
    kraus = depolarizing_2q(0.2)
    inp = qv_inputs_from_numpy(perms, gates, kraus,
                               np.ones((2, depth, depth // 2, 3)),
                               device="cpu", dtype=torch.float64)
    got = pallas_traj.traj_probs_reference(*inp, depth)
    last = inp.kraus[-1] @ inp.gates            # W_{K-1} at every slot
    want = pallas_traj.ideal_probs_reference(inp.perms, last, depth)
    np.testing.assert_allclose(got.numpy(),
                               want[..., None].expand(-1, -1, 3).numpy(),
                               atol=1e-12)


# --- dispatch, wrapper checks, operation count ---------------------------

def test_cpu_dispatch_runs_plain_versions_without_launching():
    depth = 4
    perms, gates, u = qv_stack(3, 2, depth, n_traj=8)
    inp = qv_inputs_from_numpy(perms, gates, depolarizing_2q(0.1), u,
                               device="cpu")
    before = (pallas_traj.ideal_probs.launches,
              pallas_traj.traj_probs.launches)
    ideal = pallas_traj.ideal_probs(inp.perms, inp.gates, depth)
    traj = pallas_traj.traj_probs(*inp, depth)
    assert (pallas_traj.ideal_probs.launches,
            pallas_traj.traj_probs.launches) == before == (0, 0)
    assert ideal.shape == (2, 16) and traj.shape == (2, 16, 8)
    assert torch.equal(ideal, pallas_traj.ideal_probs_reference(
        inp.perms, inp.gates, depth))
    assert kernels.load.cache_info().currsize == 0


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    perms, gates, u = qv_stack(4, 2, 4, n_traj=8)
    inp = qv_inputs_from_numpy(perms, gates, depolarizing_2q(0.1), u,
                               device="cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        pallas_traj.ideal_probs_kernel(inp.perms, inp.gates, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pallas_traj.traj_probs_kernel(*inp, 4)
    with pytest.raises(ValueError, match="depths 2 to 10"):
        pallas_traj.ideal_probs_kernel(inp.perms, inp.gates, 11)
    many = torch.zeros((33, 4, 4), dtype=torch.complex64)
    with pytest.raises(ValueError, match="1 to 32 Kraus"):
        pallas_traj.traj_probs_kernel(inp.perms, inp.gates, many,
                                      inp.uniforms, 4)
    assert kernels.load.cache_info().currsize == 0


@pytest.mark.parametrize("depth,noiseless", [(7, False), (8, False),
                                             (8, True)])
def test_flop_count_drops_permutation_matmuls(depth, noiseless):
    """The port's count is the JAX package's without the one-hot
    permutation matmuls (4 * 4^d per boundary, d + 1 boundaries) and, when
    noisy, without the (K, 16) materialization of the sampled operator
    (4K * 16 per slot) and with the branch weights on the hermitian half
    (2K * 16 per slot in place of 4K * 16)."""
    t, k = 1000, 16
    jax_count = jax_traj.traj_flops_per_circuit(depth, k, t, noiseless)
    dropped = t * (depth + 1) * 4 * 4 ** depth
    if not noiseless:
        dropped += t * depth * (depth // 2) * (4 + 2) * k * 16
    assert pallas_traj.traj_flops_per_circuit(depth, k, t, noiseless) == \
        pytest.approx(jax_count - dropped, rel=1e-12)


def test_cuda_source_constants_match_python():
    """The depths and the Kraus count the wrappers check are those the
    kernel source is built for (its launcher switches over the depths)."""
    src = (kernels.CSRC / "qv_traj.cu").read_text()

    def define(name):
        return int(re.search(rf"#define {name} (\d+)", src).group(1))

    assert define("QV_MIN_DEPTH") == pallas_traj.MIN_DEPTH
    assert define("QV_MAX_DEPTH") == pallas_traj.MAX_DEPTH
    assert define("QV_MAX_KRAUS") == pallas_traj.MAX_KRAUS
    depths = list(range(pallas_traj.MIN_DEPTH, pallas_traj.MAX_DEPTH + 1))
    for kernel in ("TRAJ", "IDEAL"):
        cases = [int(d) for d in re.findall(rf"QV_{kernel}_CASE\((\d+)\)",
                                            src)]
        assert cases == depths, kernel
    warps = re.search(r"constexpr int IDEAL_WARPS = (\d+);", src).group(1)
    assert int(warps) == pallas_traj.IDEAL_WARPS
    table = re.search(r"IDEAL_CIRCUITS_PER_WARP\[QV_MAX_DEPTH \+ 1\] = "
                      r"\{([\d,\s]+)\}", src).group(1)
    per_warp = [int(v) for v in table.split(",")]
    assert per_warp[pallas_traj.MIN_DEPTH:] == [
        pallas_traj.ideal_circuits_per_warp(d) for d in depths]
    # a circuit is a group of 2^(d-2) lanes below depth 7, a warp from there
    for d in depths:
        assert per_warp[d] * 2 ** min(d - 2, 5) == 32


def test_ideal_tail_circuits_leave_a_part_empty_last_warp_and_block():
    """The tail circuit counts of chip_smoke.py and of the on-card tests
    leave the ideal kernel's last block part empty and, where a warp holds
    several circuits, its last warp's lane groups too."""
    smoke = _script(ROOT / "chip_smoke.py")
    on_card = _script(ROOT / "tests" / "test_torch_cuda.py")
    assert smoke.IDEAL_WARPS == pallas_traj.IDEAL_WARPS
    for depth in range(pallas_traj.MIN_DEPTH, pallas_traj.MAX_DEPTH + 1):
        per_warp = pallas_traj.ideal_circuits_per_warp(depth)
        per_block = pallas_traj.IDEAL_WARPS * per_warp
        for c in (smoke.ideal_tail_circuits(depth),
                  on_card.ideal_tail_circuits(depth)):
            assert c > per_block and c % per_block, (depth, c)
            assert per_warp == 1 or c % per_warp, (depth, c)


@pytest.mark.parametrize("device,depth,want", [
    ("cpu", 8, False), ("cuda", 1, False), ("cuda", 2, True),
    ("cuda", 8, True), ("cuda", 10, True), ("cuda", 11, False),
    ("cuda", 12, False)])
def test_qv_kernel_routing_rule(device, depth, want):
    """The batched sampler takes the kernels on the card at the depths they
    take, 2 to 10, whatever dtype, and the plain versions elsewhere."""
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    assert quantum_volume._use_kernels(depth, dev) is want
