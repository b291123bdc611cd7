"""The plain versions of the small-SVD kernels (hessgpu_tpu_torch/ops/
linalg.py: null_vector_plain, svd3_plain; the kernels of csrc/linalg.cu
equal them bit for bit on the card, tests/test_torch_cuda_kernels.py) on
the CPU, against the JAX package's call (jnp.linalg.svd, LAPACK on the
CPU) and against numpy in float64, on seeded inputs at the shapes of the
RANSAC cores: the 512 eight-point systems (512, 8, 9), the weighted refit
(N, 9) at N = 428 (the SfM sequence's first pair) and 2048, the 256 6-point
DLT systems (256, 12, 12), and a batch of (16, 12) systems; the 3 x 3 SVDs
at (512, 3, 3) and (1, 3, 3).

Tolerances:
  * null vectors: |<v, v_ref>| >= 1 - 1e-5 wherever the gap sigma_{n-1} /
    sigma_1 (sigma_M / sigma_1 for M < n rows) is >= 1e-3, v_ref the last
    row of the reference's full Vh; a float32 SVD's own error there is
    ~eps / gap = 6e-5 rad, 1 - cos ~2e-9. Everywhere: unit norm to 1e-6,
    no NaN, and ||A v|| at most ||A v_ref|| + 1e-6 ||A||_F (v is rounded to
    float32);
  * 3 x 3: U S Vh rebuilds A to 1e-6 of ||A||_F, U and Vh orthogonal to
    1e-6, S descending and equal to numpy's float64 values to 1e-6 of the
    largest.
Cases past the random ones: an exact minimal 8-point system (its null
vector is the true F in normalised coordinates), a collision sample (two
equal rows: a 2-D null space), the zero matrix, rank-2 and rank-1 3 x 3s.
The convergence stop (ops/linalg.py): the sweeps run stay within the cap
everywhere and below it for every determined system at the cores' shapes
(the gap above); a batch whose matrices stop
after different sweeps gives each what it gives alone, bit for bit; a cap
of 1 stops every matrix after 1 sweep.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hessgpu_tpu_torch.ops import linalg
from hessgpu_tpu_torch.ops.cuda import linalg as cuda_linalg
from hessgpu_tpu_torch.sfm import twoview as ttv
from test_torch_sfm_twoview import K, _project, _scene

t = torch.from_numpy


def _hartley_design(p1, p2):
    """The normalised eight-point rows of (..., M, 2) float32 points, as the
    fundamental RANSAC forms them."""
    n1, _ = ttv._normalize_points(t(p1))
    n2, _ = ttv._normalize_points(t(p2))
    return ttv._design(n1, n2).numpy()


def _dlt_design(X, uv):
    """The 6-point DLT systems (H, 12, 12) of ransac_pnp's hypotheses."""
    Xh = np.concatenate([X, np.ones(X.shape[:-1] + (1,), np.float32)], -1)
    xn = (uv - K[:2, 2]) / K[0, 0]
    u_, v_ = xn[..., 0, None], xn[..., 1, None]
    z = np.zeros_like(Xh)
    A = np.concatenate([np.concatenate([z, -Xh, v_ * Xh], -1),
                        np.concatenate([Xh, z, -u_ * Xh], -1)], -2)
    return A.astype(np.float32)


def _null_inputs():
    s = _scene()
    rng = np.random.RandomState(11)
    idx = rng.randint(0, len(s["p1"]), (512, 8))
    # the refit's rows: inlier-weighted, normalised by the weighted means
    wts = s["inl"].astype(np.float32)

    def refit(n):
        sel = rng.randint(0, len(s["p1"]), n)
        p1, p2, w = s["p1"][sel], s["p2"][sel], wts[sel]
        A = ttv._design(*(t(x) for x in _weighted_normalised(p1, p2, w)))
        return (A * torch.from_numpy(w)[:, None]).numpy()

    pidx = rng.randint(0, len(s["pnp_X"]), (256, 6))
    return {
        "eight_point_512x8x9": _hartley_design(s["p1"][idx], s["p2"][idx]),
        "refit_428x9": refit(428),
        "refit_2048x9": refit(2048),
        "dlt_256x12x12": _dlt_design(s["pnp_X"][pidx], s["uv"][pidx]),
        "batch_64x16x12": rng.randn(64, 16, 12).astype(np.float32),
    }


def _weighted_normalised(p1, p2, w):
    """The weighted refit's normalised points (ttv._weighted_eight_point)."""
    out = []
    for p in (p1, p2):
        ws = w.sum() + 1e-12
        m = (w[:, None] * p).sum(0) / ws
        c = p - m
        sc = np.sqrt(2.0) / ((w * np.linalg.norm(c, axis=1)).sum() / ws
                             + 1e-12)
        out.append((c * sc).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def null_inputs():
    return _null_inputs()


def _gap(A64):
    s = np.linalg.svd(A64, compute_uv=False)
    M, n = A64.shape[-2:]
    return (s[..., -2] if M >= n else s[..., -1]) / s[..., 0]


def _check_null(v, A, v_ref):
    """The module docstring's null-vector tolerances for v (..., n) against
    v_ref, both of A (..., M, n)."""
    v64, A64, r64 = (np.asarray(x, np.float64) for x in (v, A, v_ref))
    assert not np.isnan(v64).any()
    np.testing.assert_allclose(np.linalg.norm(v64, axis=-1), 1.0, atol=1e-6)
    cos = np.abs((v64 * r64).sum(-1))
    gap_ok = _gap(A64) >= 1e-3
    assert (cos[gap_ok] >= 1 - 1e-5).all(), cos[gap_ok].min()
    res = np.linalg.norm((A64 @ v64[..., None])[..., 0], axis=-1)
    res_ref = np.linalg.norm((A64 @ r64[..., None])[..., 0], axis=-1)
    bound = res_ref + 1e-6 * np.linalg.norm(A64, axis=(-2, -1))
    assert (res <= bound).all(), (res - bound).max()
    return int(gap_ok.sum())


@pytest.mark.parametrize("case", ["eight_point_512x8x9", "refit_428x9",
                                  "refit_2048x9", "dlt_256x12x12",
                                  "batch_64x16x12"])
@pytest.mark.parametrize("ref", ["jax", "numpy_f64"])
def test_null_vector_matches_the_svd(null_inputs, case, ref):
    A = null_inputs[case]
    v = linalg.null_vector_plain(t(A)).numpy()
    assert v.shape == A.shape[:-2] + A.shape[-1:] and v.dtype == np.float32
    if ref == "jax":
        v_ref = np.asarray(jnp.linalg.svd(jnp.asarray(A),
                                          full_matrices=True)[2])[..., -1, :]
    else:
        v_ref = np.linalg.svd(A.astype(np.float64))[2][..., -1, :]
    checked = _check_null(v, A, v_ref)
    # most systems have their gap: the check is not vacuous
    assert checked >= 0.6 * max(1, A[..., 0, 0].size)


def test_null_vector_of_an_exact_minimal_system():
    """Eight exact correspondences: the null vector is the true F in the
    normalised coordinates."""
    s = _scene()
    sel = np.arange(8) * 7
    X = s["X"][sel].astype(np.float64)
    p1 = _project(X, np.eye(3), np.zeros(3)).astype(np.float32)
    p2 = _project(X, s["R2"], s["t2"]).astype(np.float32)
    n1, T1 = ttv._normalize_points(t(p1))
    n2, T2 = ttv._normalize_points(t(p2))
    A = ttv._design(n1, n2).numpy()
    v = linalg.null_vector_plain(t(A)).numpy().astype(np.float64)
    F = T2.numpy().T.astype(np.float64) @ v.reshape(3, 3) \
        @ T1.numpy().astype(np.float64)
    F_true = s["F_true"] / np.linalg.norm(s["F_true"])
    F = F / np.linalg.norm(F)
    assert min(np.abs(F - F_true).max(), np.abs(F + F_true).max()) < 1e-3
    _check_null(v, A, np.linalg.svd(A.astype(np.float64))[2][-1])


def test_null_vector_of_a_collision_sample():
    """Two equal draws: rank 7, a 2-D null space. Any unit vector of it
    will do: unit norm, no NaN, ||A v|| at LAPACK's level."""
    s = _scene()
    idx = np.array([3, 17, 17, 40, 41, 90, 120, 200])
    A = _hartley_design(s["p1"][idx], s["p2"][idx])
    assert _gap(A.astype(np.float64)) < 1e-6
    v = linalg.null_vector_plain(t(A)).numpy()
    v_ref = np.asarray(jnp.linalg.svd(jnp.asarray(A),
                                      full_matrices=True)[2])[-1]
    _check_null(v, A, v_ref)


def test_null_vector_of_the_zero_matrix():
    v = linalg.null_vector_plain(torch.zeros(3, 8, 9)).numpy()
    assert not np.isnan(v).any()
    np.testing.assert_array_equal(v, np.tile(np.eye(9, dtype=np.float32)[0],
                                             (3, 1)))


def test_null_vector_sign_rule_and_batch_layout(null_inputs):
    """The first nonzero entry is positive; a batch's leading axes are kept
    and each matrix is solved alone."""
    A = null_inputs["dlt_256x12x12"]
    v = linalg.null_vector_plain(t(A)).numpy()
    first = v[np.arange(len(v)), (v != 0).argmax(-1)]
    assert (first > 0).all()
    one = linalg.null_vector_plain(t(A[5:6])).numpy()
    np.testing.assert_array_equal(one, v[5:6])
    v2 = linalg.null_vector_plain(t(A.reshape(16, 16, 12, 12))).numpy()
    np.testing.assert_array_equal(v2.reshape(256, 12), v)


CORE_SHAPES = ["eight_point_512x8x9", "refit_428x9", "refit_2048x9",
               "dlt_256x12x12"]


@pytest.mark.parametrize("case", CORE_SHAPES + ["batch_64x16x12"])
def test_null_vector_stops_below_its_cap(null_inputs, case):
    """Every system whose null vector is determined (the gap >= 1e-3) is
    done below the cap (a rank-deficient draw may run to it); a system done
    below the cap gives the same bits under a higher one, and applied no
    rotation in its last sweep."""
    A = t(null_inputs[case])
    v, (sweeps, rotations) = linalg.null_vector_plain(A, return_counts=True)
    assert sweeps.shape == A.shape[:-2] and sweeps.dtype == torch.int32
    assert rotations.shape == A.shape[:-2] and rotations.dtype == torch.int32
    assert torch.equal(v, linalg.null_vector_plain(A))
    determined = torch.from_numpy(np.atleast_1d(
        _gap(null_inputs[case].astype(np.float64)) >= 1e-3))
    assert bool(determined.any()) and 1 <= int(sweeps.min())
    assert int(sweeps.reshape(-1)[determined].max()) < \
        linalg.NULL_VECTOR_SWEEPS
    more = linalg.null_vector_plain(
        A, max_sweeps=linalg.NULL_VECTOR_SWEEPS + 1, return_counts=True)
    below = (sweeps < linalg.NULL_VECTOR_SWEEPS).reshape(-1)
    assert torch.equal(more[0].reshape(-1, v.shape[-1])[below],
                       v.reshape(-1, v.shape[-1])[below])
    for got, want in zip(more[1], (sweeps, rotations)):
        assert torch.equal(got.reshape(-1)[below], want.reshape(-1)[below])
    n = A.shape[-1]
    pairs = n * (n - 1) // 2
    assert bool((rotations >= 1).all())
    assert bool((rotations.reshape(-1)[below]
                 <= (sweeps.reshape(-1)[below] - 1) * pairs).all())


def test_null_vector_freezes_what_converged(null_inputs):
    """Matrices that stop after different sweeps, in one batch: each gives
    bit for bit what it gives alone, and so do its sweeps."""
    s = _scene()
    collision = _hartley_design(
        s["p1"][np.array([3, 17, 17, 40, 41, 90, 120, 200])],
        s["p2"][np.array([3, 17, 17, 40, 41, 90, 120, 200])])
    A = t(np.concatenate([np.zeros((1, 8, 9), np.float32), collision[None],
                          null_inputs["eight_point_512x8x9"][:6]]))
    v, counts = linalg.null_vector_plain(A, return_counts=True)
    sweeps = counts.sweeps
    assert len(set(sweeps.tolist())) >= 3 and int(sweeps[0]) == 1
    assert int(counts.rotations[0]) == 0
    for i in range(len(A)):
        one, one_counts = linalg.null_vector_plain(A[i:i + 1],
                                                   return_counts=True)
        assert torch.equal(one, v[i:i + 1])
        for got, want in zip(one_counts, counts):
            assert torch.equal(got, want[i:i + 1])


@pytest.mark.parametrize("fn", ["null_vector", "svd3"])
def test_a_cap_of_one_stops_after_one_sweep(null_inputs, fn):
    if fn == "null_vector":
        A = t(null_inputs["dlt_256x12x12"])
        out = linalg.null_vector_plain(A, max_sweeps=1, return_counts=True)
        np.testing.assert_allclose(out[0].norm(dim=-1).numpy(), 1.0,
                                   atol=1e-6)
    else:
        A = t(_svd3_inputs()["random_512"])
        out = linalg.svd3_plain(A, max_sweeps=1, return_counts=True)
    assert bool((out[-1].sweeps == 1).all())
    assert not any(bool(x.isnan().any()) for x in out[:-1])


def test_the_sweeps_arguments_are_checked():
    with pytest.raises(ValueError):
        linalg.null_vector_plain(torch.zeros(2, 8, 9), max_sweeps=-1)
    with pytest.raises(ValueError):
        linalg.svd3_plain(torch.zeros(2, 3, 3), max_sweeps=-1)


def _svd3_inputs():
    rng = np.random.RandomState(5)
    rank2 = np.array([[1, 2, 3], [4, 5, 9], [7, 8, 15]], np.float32)
    rank1 = np.array([[1, 2, 3], [2, 4, 6], [3, 6, 9]], np.float32)
    return {"random_512": rng.randn(512, 3, 3).astype(np.float32),
            "one": rng.randn(1, 3, 3).astype(np.float32),
            "rank2": rank2[None], "rank1": rank1[None],
            "zero": np.zeros((1, 3, 3), np.float32),
            "fundamental": np.stack([ttv.eight_point(
                t(_scene()["p1"][i:i + 8]), t(_scene()["p2"][i:i + 8])
            ).numpy() for i in range(0, 64, 8)])}


@pytest.mark.parametrize("case", ["random_512", "one", "rank2", "rank1",
                                  "zero", "fundamental"])
def test_svd3_matches_the_svd(case):
    A = _svd3_inputs()[case]
    *usv, (sweeps, rotations) = linalg.svd3_plain(t(A), return_counts=True)
    assert 1 <= int(sweeps.min()) and \
        int(sweeps.max()) < linalg.SVD3_SWEEPS
    assert bool((rotations <= (sweeps - 1) * 3).all())
    U, S, Vh = (x.numpy().astype(np.float64) for x in usv)
    for x in (U, S, Vh):
        assert not np.isnan(x).any()
    A64 = A.astype(np.float64)
    scale = np.maximum(np.linalg.norm(A64, axis=(1, 2)), 1e-30)
    rebuilt = (U * S[:, None, :]) @ Vh
    assert (np.abs(rebuilt - A64).max(axis=(1, 2)) <= 1e-6 * scale).all()
    eye = np.eye(3)
    assert np.abs(U.transpose(0, 2, 1) @ U - eye).max() <= 1e-6
    assert np.abs(Vh @ Vh.transpose(0, 2, 1) - eye).max() <= 1e-6
    assert (S[:, :-1] >= S[:, 1:]).all() and (S >= 0).all()
    for S_ref in (np.linalg.svd(A64, compute_uv=False),
                  np.asarray(jnp.linalg.svd(jnp.asarray(A),
                                            compute_uv=False))):
        err = np.abs(S - S_ref).max(1)
        assert (err <= 1e-6 * np.maximum(S_ref[:, 0], 1e-30)).all()
    # the sign rule: each row of Vh has its first nonzero entry positive
    first = Vh[np.arange(len(Vh))[:, None], np.arange(3)[None],
               (Vh != 0).argmax(-1)]
    assert (first > 0).all()


@pytest.mark.parametrize("fn,shape", [(cuda_linalg.null_vector, (4, 8, 9)),
                                      (cuda_linalg.svd3, (4, 3, 3))],
                         ids=["null_vector", "svd3"])
def test_the_kernel_wrappers_refuse_cpu_tensors(fn, shape):
    """A wrapper launches its kernel or raises: a CPU tensor goes to the
    plain version by the caller's choice (sfm/twoview.py), never here."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn(torch.zeros(shape))


@pytest.mark.parametrize("shape,err", [((4, 8, 13), ValueError),
                                       ((4, 0, 9), ValueError),
                                       ((4, 3, 4), ValueError)])
def test_the_inputs_the_kernels_refuse(shape, err):
    x = torch.zeros(shape)
    check = (linalg.check_svd3_input if shape[-1] == 4
             else linalg.check_null_vector_input)
    with pytest.raises(err):
        check(x)
    with pytest.raises(TypeError):
        linalg.check_null_vector_input(torch.zeros(4, 8, 9,
                                                   dtype=torch.float64))
