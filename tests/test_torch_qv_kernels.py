"""The port's quantum-volume kernel modules against the JAX package: index
maps, the plain versions of the ideal and trajectory kernels (against the
JAX simulators in f64 and the Pallas kernels in interpret mode, f32), the
CPU dispatch, the wrappers' input checks and the FLOP count.

Inputs are made with numpy from a seed and fed to both packages through
``qv_inputs_from_numpy``."""
import re

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
    cases = [int(d) for d in re.findall(r"QV_TRAJ_CASE\((\d+)\)", src)]
    assert cases == list(range(pallas_traj.MIN_DEPTH,
                               pallas_traj.MAX_DEPTH + 1))


@pytest.mark.parametrize("device,depth,want", [
    ("cpu", 8, False), ("cuda", 1, False), ("cuda", 2, True),
    ("cuda", 8, True), ("cuda", 10, True), ("cuda", 11, False),
    ("cuda", 12, False)])
def test_qv_kernel_routing_rule(device, depth, want):
    """The batched sampler takes the kernels on the card at the depths they
    take, 2 to 10, whatever dtype, and the plain versions elsewhere."""
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    assert quantum_volume._use_kernels(depth, dev) is want
