"""The port's superoperator conversions, projections onto unitary channels,
channel application and composition, the Pauli twirl and the validators
against the JAX package on the same numpy inputs, in float64."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from forest_benchmarking_tpu.ops import apply_superoperator as japply
from forest_benchmarking_tpu.ops import channel_approximation as jtwirl
from forest_benchmarking_tpu.ops import compose_superoperators as jcomp
from forest_benchmarking_tpu.ops import project_superoperators as jproj
from forest_benchmarking_tpu.ops import superoperator_transformations as jsup
from forest_benchmarking_tpu.ops import validate_operator as jvop
from forest_benchmarking_tpu.ops import validate_superoperator as jvsup
from forest_benchmarking_tpu.ops.random_operators import (
    haar_rand_unitary as jax_haar)
from forest_benchmarking_tpu.utils import H_MAT, I_MAT, X_MAT, Y_MAT
from forest_benchmarking_tpu_torch.ops import apply_superoperator as tapply
from forest_benchmarking_tpu_torch.ops import channel_approximation as ttwirl
from forest_benchmarking_tpu_torch.ops import compose_superoperators as tcomp
from forest_benchmarking_tpu_torch.ops import project_superoperators as tproj
from forest_benchmarking_tpu_torch.ops import superoperator_transformations as tsup
from forest_benchmarking_tpu_torch.ops import validate_operator as tvop
from forest_benchmarking_tpu_torch.ops import validate_superoperator as tvsup
from forest_benchmarking_tpu_torch.ops.random_operators import (
    ginibre_state_matrix, rand_map_with_BCSZ_dist)

torch.set_num_threads(1)

BAR = 1e-12
DIMS = (2, 4)
BATCH = (3,)

# the conversions that return one tensor and take a batch, by input kind
BATCHED = {
    "kraus": ["kraus2chi", "kraus2superop", "kraus2pauli_liouville",
              "kraus2choi"],
    "chi": ["chi2pauli_liouville", "chi2superop", "chi2choi"],
    "superop": ["superop2pauli_liouville", "superop2choi"],
    "pl": ["pauli_liouville2superop", "pauli_liouville2choi"],
    "choi": ["choi2chi", "choi2superop", "choi2pauli_liouville"],
}
# the conversions through the host-side, unbatched choi2kraus
UNBATCHED = {
    "chi": ["chi2kraus"], "superop": ["superop2kraus", "superop2chi"],
    "pl": ["pauli_liouville2kraus", "pauli_liouville2chi"],
    "choi": ["choi2kraus"],
}
CASES = [(name, kind, dim, batched)
         for kind, names in BATCHED.items() for name in names
         for dim in DIMS for batched in (False, True)]
CASES += [(name, kind, dim, False)
          for kind, names in UNBATCHED.items() for name in names
          for dim in DIMS]


def _crandn(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _inputs(dim, batched):
    """Numpy inputs of each kind: random Kraus sets, and a BCSZ-like CPTP
    channel in each representation (choi2kraus needs a Hermitian Choi
    matrix with distinct eigenvalues)."""
    rng = np.random.default_rng(dim + 10 * batched)
    shape = BATCH if batched else ()
    x = _crandn(rng, *shape, dim * dim, dim * dim)
    choi = x @ np.conj(np.swapaxes(x, -1, -2))
    choi = dim * choi / np.trace(choi, axis1=-2, axis2=-1)[..., None, None]
    chi = np.asarray(jsup.choi2chi(jnp.asarray(choi)))
    return {"kraus": _crandn(rng, *shape, 3, dim, dim), "choi": choi,
            "chi": chi,
            "superop": np.asarray(jsup.choi2superop(jnp.asarray(choi))),
            "pl": np.asarray(jsup.choi2pauli_liouville(jnp.asarray(choi)))}


def _as_np(out):
    if isinstance(out, (list, tuple)):
        return np.stack([np.asarray(k) for k in out])
    return np.asarray(out)


@pytest.fixture(scope="module")
def jax_conversions():
    """JAX's result of every case, computed once."""
    inputs = {(dim, b): _inputs(dim, b) for dim in DIMS for b in (False, True)}
    want = {}
    for name, kind, dim, batched in CASES:
        x = inputs[dim, batched][kind]
        want[name, dim, batched] = _as_np(getattr(jsup, name)(jnp.asarray(x)))
    return inputs, want


@pytest.mark.parametrize("name, kind, dim, batched", CASES)
def test_conversion_matches_jax(jax_conversions, name, kind, dim, batched):
    inputs, want = jax_conversions
    got = getattr(tsup, name)(torch.tensor(inputs[dim, batched][kind]))
    if name.endswith("kraus"):
        assert isinstance(got, list) and all(
            isinstance(k, torch.Tensor) for k in got)
    got = _as_np([k.numpy() for k in got] if isinstance(got, list)
                 else got.numpy())
    assert got.shape == want[name, dim, batched].shape
    np.testing.assert_allclose(got, want[name, dim, batched], atol=BAR)


@pytest.mark.parametrize("dim", DIMS)
def test_basis_matrices_match_jax(dim):
    for name in ("pauli2computational_basis_matrix",
                 "computational2pauli_basis_matrix"):
        got = getattr(tsup, name)(dim, device="cpu")
        assert got.dtype == torch.complex128 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(getattr(jsup, name)(dim)),
                                   atol=BAR)


def test_kraus_list_and_single_operator_are_stacked():
    rng = np.random.default_rng(1)
    ks = [_crandn(rng, 2, 2) for _ in range(3)]
    want = np.asarray(jsup.kraus2superop([jnp.asarray(k) for k in ks]))
    for arg in (ks, [torch.tensor(k) for k in ks]):
        np.testing.assert_allclose(tsup.kraus2superop(arg).numpy(), want,
                                   atol=BAR)
    np.testing.assert_allclose(
        tsup.kraus2choi(torch.tensor(ks[0])).numpy(),
        np.asarray(jsup.kraus2choi(jnp.asarray(ks[0]))), atol=BAR)
    # non-square Kraus operators: (K, r, c) -> (r^2, c^2)
    k = _crandn(rng, 2, 1, 2)
    np.testing.assert_allclose(
        tsup.kraus2superop(torch.tensor(k)).numpy(),
        np.asarray(jsup.kraus2superop(jnp.asarray(k))), atol=BAR)


# ------------------------------------------------ round trips (test_properties)

def _bcsz(seed, dim, rank):
    return rand_map_with_BCSZ_dist(torch.Generator().manual_seed(seed), dim,
                                   rank)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_representation_roundtrips_close(seed):
    d = DIMS[seed % 2]
    choi = _bcsz(seed, d, d)
    for there, back in [(tsup.choi2superop, tsup.superop2choi),
                        (tsup.choi2pauli_liouville, tsup.pauli_liouville2choi),
                        (tsup.choi2chi, tsup.chi2choi),
                        (tsup.choi2kraus, tsup.kraus2choi)]:
        np.testing.assert_allclose(back(there(choi)).numpy(), choi.numpy(),
                                   atol=1e-10)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_channel_application_paths_agree(seed):
    d = DIMS[seed % 2]
    choi = _bcsz(seed, d, d)
    rho = ginibre_state_matrix(torch.Generator().manual_seed(50 + seed), d, d)
    out_k = tapply.apply_kraus_ops_2_state(tsup.choi2kraus(choi), rho)
    out_c = tapply.apply_choi_matrix_2_state(choi, rho)
    out_s = tsup.unvec(tsup.choi2superop(choi) @ tsup.vec(rho))
    np.testing.assert_allclose(out_k.numpy(), out_c.numpy(), atol=1e-9)
    np.testing.assert_allclose(out_k.numpy(), out_s.numpy(), atol=1e-9)
    assert abs(torch.trace(out_k) - torch.trace(rho)).item() < 1e-9


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_kraus_composition_matches_superop_product(seed):
    d = DIMS[seed % 2]
    ca, cb = _bcsz(seed, d, d), _bcsz(100 + seed, d, 2)
    comp = tcomp.compose_channel_kraus(tsup.choi2kraus(cb),
                                       tsup.choi2kraus(ca))
    np.testing.assert_allclose(
        tsup.kraus2superop(comp).numpy(),
        (tsup.choi2superop(cb) @ tsup.choi2superop(ca)).numpy(), atol=1e-8)


# ------------------------------------------------------------------ choi2kraus

@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_choi2kraus_tolerance_keeps_one_operator_of_a_unitary(dtype):
    """A unitary channel's Choi matrix has rank one; eigh noise (~1e-6 in
    float32) must not add operators under the dtype-aware default tol."""
    u = np.asarray(jax_haar(jax.random.PRNGKey(5), 4)).astype(dtype)
    choi = np.asarray(jsup.kraus2choi(jnp.asarray(u)[None])).astype(dtype)
    want = jsup.choi2kraus(choi)
    for arg in (choi, torch.tensor(choi)):
        got = tsup.choi2kraus(arg)
        assert len(got) == len(want) == 1
        np.testing.assert_allclose(got[0].numpy(), want[0], atol=BAR)
        k = got[0].numpy()
        k = k / np.exp(1j * np.angle(k[0, 0] / u[0, 0]))
        np.testing.assert_allclose(k, u, atol=1e-5)
    assert tvsup.choi_is_unitary(choi) and tvsup.choi_is_unitary(
        torch.tensor(choi))
    # the fixed reference cut keeps the spurious f32 operators, as in JAX
    assert (len(tsup.choi2kraus(choi, tol=1e-9))
            == len(jsup.choi2kraus(choi, tol=1e-9)))


def test_choi2kraus_rejects_a_batch():
    with pytest.raises(ValueError):
        tsup.choi2kraus(torch.eye(4, dtype=torch.complex128).expand(2, 4, 4))


# ------------------------------------------------------------- unitary channel

@pytest.mark.parametrize("dim", DIMS)
def test_proj_choi_to_unitary_matches_jax(dim):
    x = _inputs(dim, True)["choi"]
    want = np.asarray(jproj.proj_choi_to_unitary(jnp.asarray(x)))
    got = tproj.proj_choi_to_unitary(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), want, atol=BAR)
    assert all(tvsup.choi_is_unitary(c) for c in got)


# --------------------------------------------------------- apply and compose

def _amp_damp(p):
    return [np.array([[1, 0], [0, np.sqrt(1 - p)]], dtype=complex),
            np.array([[0, np.sqrt(p)], [0, 0]], dtype=complex)]


def test_apply_matches_jax():
    rng = np.random.default_rng(3)
    for dim in DIMS:
        ks = _crandn(rng, 2, 3, dim, dim)
        rho = _crandn(rng, 2, dim, dim)
        choi = _inputs(dim, True)["choi"][:2]
        np.testing.assert_allclose(
            tapply.apply_kraus_ops_2_state(torch.tensor(ks),
                                           torch.tensor(rho)).numpy(),
            np.asarray(japply.apply_kraus_ops_2_state(jnp.asarray(ks),
                                                      jnp.asarray(rho))),
            atol=BAR)
        np.testing.assert_allclose(
            tapply.apply_choi_matrix_2_state(torch.tensor(choi),
                                             torch.tensor(rho)).numpy(),
            np.asarray(japply.apply_choi_matrix_2_state(jnp.asarray(choi),
                                                        jnp.asarray(rho))),
            atol=BAR)
    # a non-square Kraus operator: the projective outcome <0|
    out = tapply.apply_kraus_ops_2_state(
        [np.array([[1.0, 0.0]], dtype=complex)],
        torch.tensor([[0.3, 0.2], [0.2, 0.7]], dtype=torch.complex128))
    assert out.shape == (1, 1) and abs(out.item() - 0.3) < BAR
    with pytest.raises(ValueError):
        tapply.apply_kraus_ops_2_state(torch.eye(2)[None], torch.eye(3))


def test_compose_and_tensor_match_jax():
    rng = np.random.default_rng(4)
    k2, k1 = _crandn(rng, 2, 2, 3, 2, 2), _crandn(rng, 2, 4, 2, 2)
    for name in ("tensor_channel_kraus", "compose_channel_kraus"):
        np.testing.assert_allclose(
            getattr(tcomp, name)(torch.tensor(k2), torch.tensor(k1)).numpy(),
            np.asarray(getattr(jcomp, name)(jnp.asarray(k2),
                                            jnp.asarray(k1))), atol=BAR)
    ks = tcomp.tensor_channel_kraus([torch.tensor(H_MAT)],
                                    [torch.tensor(X_MAT)])
    np.testing.assert_allclose(ks[0].numpy(), np.kron(H_MAT, X_MAT))
    ks1, ks2 = _amp_damp(0.2), _amp_damp(0.3)
    so = tsup.kraus2superop(tcomp.compose_channel_kraus(ks2, ks1))
    np.testing.assert_allclose(
        so.numpy(), (tsup.kraus2superop(ks2) @ tsup.kraus2superop(ks1))
        .numpy(), atol=BAR)


def test_pauli_twirl_matches_jax():
    chi = _inputs(4, True)["chi"]
    np.testing.assert_allclose(
        ttwirl.pauli_twirl_chi_matrix(torch.tensor(chi)).numpy(),
        np.asarray(jtwirl.pauli_twirl_chi_matrix(jnp.asarray(chi))),
        atol=BAR)
    chi1 = tsup.kraus2chi(_amp_damp(0.3))
    np.testing.assert_allclose(ttwirl.pauli_twirl_chi_matrix(chi1).numpy(),
                               np.diag(np.diag(chi1.numpy())))


# ------------------------------------------------------------------ validators

OPERATOR_CASES = [
    ("is_square_matrix", np.eye(3)), ("is_square_matrix", np.ones((2, 3))),
    ("is_symmetric_matrix", np.array([[1, 2], [2, 1]])),
    ("is_symmetric_matrix", np.array([[1, 2], [3, 1]])),
    ("is_identity_matrix", np.eye(4)),
    ("is_idempotent_matrix", np.array([[1, 0], [0, 0]])),
    ("is_normal_matrix", X_MAT), ("is_hermitian_matrix", Y_MAT),
    ("is_hermitian_matrix", np.array([[0, 1], [0, 0]], dtype=complex)),
    ("is_unitary_matrix", H_MAT),
    ("is_positive_definite_matrix", np.diag([1.0, 2.0])),
    ("is_positive_definite_matrix", np.diag([1.0, -2.0])),
    ("is_positive_semidefinite_matrix", np.diag([1.0, 0.0])),
    ("is_positive_semidefinite_matrix", np.diag([1.0, -1e-7])),
]


@pytest.mark.parametrize("name, matrix", OPERATOR_CASES)
def test_operator_predicates_match_jax(name, matrix):
    want = getattr(jvop, name)(matrix)
    assert getattr(tvop, name)(matrix) is want
    assert getattr(tvop, name)(torch.tensor(matrix)) is want


def test_operator_predicates_raise_as_jax():
    for name in ("is_symmetric_matrix", "is_identity_matrix"):
        with pytest.raises(ValueError):
            getattr(tvop, name)(np.ones((2, 3)))
    with pytest.raises(ValueError):
        tvop.is_square_matrix(np.ones(3))
    with pytest.raises(ValueError):
        tvop.is_positive_definite_matrix(np.array([[0, 1], [0, 0]]))


SUPEROPERATOR_CASES = ["choi_is_hermitian_preserving",
                       "choi_is_trace_preserving",
                       "choi_is_completely_positive", "choi_is_cptp",
                       "choi_is_unital", "choi_is_unitary"]


@pytest.mark.parametrize("name", SUPEROPERATOR_CASES)
def test_choi_predicates_match_jax(name):
    chois = [np.asarray(jsup.kraus2choi(jnp.asarray(H_MAT))),
             np.asarray(jsup.kraus2choi([jnp.asarray(k)
                                         for k in _amp_damp(0.3)])),
             _inputs(2, False)["choi"], -np.eye(4, dtype=complex)]
    for choi in chois:
        want = getattr(jvsup, name)(choi)
        assert getattr(tvsup, name)(choi) is want
        assert getattr(tvsup, name)(torch.tensor(choi)) is want


def test_kraus_validity_matches_jax():
    for ks in (_amp_damp(0.1), [0.5 * I_MAT], [H_MAT]):
        want = jvsup.kraus_operators_are_valid(ks)
        assert tvsup.kraus_operators_are_valid(ks) is want
        assert tvsup.kraus_operators_are_valid(
            [torch.tensor(k) for k in ks]) is want
        assert tvsup.kraus_operators_are_valid(
            torch.tensor(np.stack(ks))) is want
    assert tvsup.kraus_operators_are_valid(_amp_damp(0.1))
    assert not tvsup.kraus_operators_are_valid([0.5 * I_MAT])
