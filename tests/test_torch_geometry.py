"""Closed-form linear algebra, epipolar geometry, RANSAC and the pose
estimator against the JAX reference.

Float results agree within stated tolerances, not bit for bit: XLA:CPU and
torch sum in different orders (and the reference pins some sums as
balanced trees), so results differ in the last bits. Sampled RANSAC
indices come from bit-exact threefry draws and agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import t, to_np

from mvslam_tpu.frontend import pose_estimator as jpose
from mvslam_tpu.geometry import epipolar as jepi
from mvslam_tpu.geometry import linalg as jlin
from mvslam_tpu.geometry import projection as jproj
from mvslam_tpu.ops import ransac as jransac
from mvslam_tpu_torch.core import prng
from mvslam_tpu_torch.frontend import pose_estimator as tpose
from mvslam_tpu_torch.geometry import epipolar as tepi
from mvslam_tpu_torch.geometry import linalg as tlin
from mvslam_tpu_torch.geometry import projection as tproj
from mvslam_tpu_torch.ops import ransac as transac

K = np.array([[200.0, 0.0, 96.0], [0.0, 200.0, 64.0], [0.0, 0.0, 1.0]], np.float32)

# The reference, jitted: eager JAX compiles every primitive on its own.
j_eight_point = jax.jit(jepi.eight_point_essential)
j_dlt = jax.jit(jepi.dlt_homography)
j_gauss_jordan = jax.jit(jlin._gauss_jordan_inverse_with_pivots)
j_smallest = jax.jit(jlin.smallest_eigvec_psd, static_argnames=("rescue",))
j_hartley = jax.jit(jproj.hartley_normalization)
j_decompose_e = jax.jit(jepi.decompose_essential)
j_decompose_h = jax.jit(jepi.decompose_homography)
j_eigh, j_svd = jax.jit(jlin.eigh3x3), jax.jit(jlin.svd3x3)


def _rotation(rx, ry, rz):
    cx, sx, cy, sy, cz, sz = np.cos(rx), np.sin(rx), np.cos(ry), np.sin(ry), np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def two_view_scene(n=128, seed=0, planar=False, outliers=0.15, noise_px=0.3):
    """Pixel correspondences of a random scene seen from two cameras."""
    rng = np.random.default_rng(seed)
    if planar:
        X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), np.full(n, 6.0)], -1)
    else:
        X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 9, n)], -1)
    R = _rotation(0.02, -0.04, 0.01)
    tvec = np.array([0.4, 0.05, 0.1])
    X2 = X @ R.T + tvec

    def proj(P):
        uv = P[:, :2] / P[:, 2:3]
        return np.stack([K[0, 0] * uv[:, 0] + K[0, 2], K[1, 1] * uv[:, 1] + K[1, 2]], -1)

    p1 = proj(X) + rng.normal(0, noise_px, (n, 2))
    p2 = proj(X2) + rng.normal(0, noise_px, (n, 2))
    bad = rng.random(n) < outliers
    p2[bad] += rng.uniform(-40, 40, (bad.sum(), 2))
    mask = rng.random(n) > 0.05
    return p1.astype(np.float32), p2.astype(np.float32), mask, R.astype(np.float32), (tvec / np.linalg.norm(tvec)).astype(np.float32)


def _spd(n, batch, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(batch, n + 4, n)).astype(np.float32)
    return np.einsum("bki,bkj->bij", A, A)


def test_inv_det_3x3_equal_reference():
    M = np.random.default_rng(0).normal(size=(64, 3, 3)).astype(np.float32)
    assert np.allclose(to_np(tlin.inv3x3(t(M))), np.asarray(jlin.inv3x3(jnp.asarray(M))), rtol=1e-5, atol=1e-5)
    assert np.allclose(to_np(tlin.det3x3(t(M))), np.asarray(jlin.det3x3(jnp.asarray(M))), rtol=1e-6, atol=1e-6)


def test_eigh_svd_3x3_equal_reference():
    S = _spd(3, 64, 1)
    vals, vecs = tlin.eigh3x3(t(S))
    jvals, jvecs = j_eigh(jnp.asarray(S))
    assert np.allclose(to_np(vals), np.asarray(jvals), rtol=1e-4, atol=1e-3)
    # Eigenvectors up to sign.
    dots = np.abs(np.einsum("bij,bij->bj", to_np(vecs), np.asarray(jvecs)))
    assert np.allclose(dots, 1.0, atol=1e-3)
    M = np.random.default_rng(2).normal(size=(64, 3, 3)).astype(np.float32)
    U, Sv, Vt = tlin.svd3x3(t(M))
    jU, jS, jVt = j_svd(jnp.asarray(M))
    # Compare σ²: σ = √λ amplifies the eigenvalue's f32 error by 1/(2σ).
    assert np.allclose(to_np(Sv) ** 2, np.asarray(jS) ** 2, rtol=1e-4, atol=1e-4)
    # eigh of MᵀM squares the condition number: a 1-ulp change of MᵀM moves
    # σ₃ by ~eps·σ₁²/σ₃ (up to ~1e-4 on these matrices), in either port.
    assert np.allclose(to_np(U @ torch.diag_embed(Sv) @ Vt), M, atol=1e-3)


def test_gauss_jordan_and_smallest_eigvec_equal_reference():
    S = _spd(9, 32, 3)
    inv, piv = tlin._gauss_jordan_inverse_with_pivots(t(S))
    jinv, jpiv = j_gauss_jordan(jnp.asarray(S))
    assert np.allclose(to_np(inv), np.asarray(jinv), rtol=1e-3, atol=1e-5)
    assert np.allclose(to_np(piv), np.asarray(jpiv), rtol=1e-5)
    for rescue in (False, True):
        v = to_np(tlin.smallest_eigvec_psd(t(S), rescue=rescue))
        jv = np.asarray(j_smallest(jnp.asarray(S), rescue=rescue))
        assert np.allclose(np.abs((v * jv).sum(-1)), 1.0, atol=1e-4)


def test_normalize_pixels_and_hartley_equal_reference():
    p1, _, mask, _, _ = two_view_scene(seed=4)
    assert np.allclose(
        to_np(tproj.normalize_pixels(t(p1), t(K))), np.asarray(jproj.normalize_pixels(jnp.asarray(p1), jnp.asarray(K))), atol=1e-6
    )
    w = mask.astype(np.float32)
    for weights in (None, w):
        n, T = tproj.hartley_normalization(t(p1), None if weights is None else t(weights))
        jn, jT = j_hartley(jnp.asarray(p1), None if weights is None else jnp.asarray(weights))
        assert np.allclose(to_np(n), np.asarray(jn), atol=1e-5)
        assert np.allclose(to_np(T), np.asarray(jT), rtol=1e-5, atol=1e-6)


def _normalized_scene(seed=5, planar=False):
    p1, p2, mask, R, tvec = two_view_scene(seed=seed, planar=planar)
    Kinv = np.linalg.inv(K)
    n1 = (np.c_[p1, np.ones(len(p1))] @ Kinv.T)[:, :2].astype(np.float32)
    n2 = (np.c_[p2, np.ones(len(p2))] @ Kinv.T)[:, :2].astype(np.float32)
    return n1, n2, mask, R, tvec


def test_rows_and_errors_equal_reference():
    n1, n2, mask, _, _ = _normalized_scene()
    w = mask.astype(np.float32)
    assert np.allclose(to_np(tepi.essential_rows(t(n1), t(n2), t(w))), np.asarray(jepi.essential_rows(jnp.asarray(n1), jnp.asarray(n2), jnp.asarray(w))), atol=1e-6)
    rows, T1, T2 = tepi.homography_rows(t(n1), t(n2), t(w))
    jrows, jT1, jT2 = jepi.homography_rows(jnp.asarray(n1), jnp.asarray(n2), jnp.asarray(w))
    assert np.allclose(to_np(rows), np.asarray(jrows), atol=1e-5)
    E = np.asarray(j_eight_point(jnp.asarray(n1), jnp.asarray(n2), jnp.asarray(w)))
    H = np.asarray(j_dlt(jnp.asarray(n1), jnp.asarray(n2), jnp.asarray(w)))
    assert np.allclose(to_np(tepi.sampson_error(t(E), t(n1), t(n2))), np.asarray(jepi.sampson_error(jnp.asarray(E), jnp.asarray(n1), jnp.asarray(n2))), rtol=1e-3, atol=1e-9)
    assert np.allclose(to_np(tepi.symmetric_transfer_error(t(H), t(n1), t(n2))), np.asarray(jepi.symmetric_transfer_error(jnp.asarray(H), jnp.asarray(n1), jnp.asarray(n2))), rtol=1e-3, atol=1e-8)


@pytest.mark.parametrize("exact_rank2", [False, True])
def test_essential_and_homography_from_vec_equal_reference(exact_rank2):
    rng = np.random.default_rng(6)
    e = rng.normal(size=(16, 9)).astype(np.float32)
    got = to_np(tepi.essential_from_vec(t(e), exact_rank2=exact_rank2))
    ref = np.asarray(jepi.essential_from_vec(jnp.asarray(e), exact_rank2=exact_rank2))
    assert np.allclose(got, ref, rtol=1e-3, atol=1e-4)
    n1, n2, _, _, _ = _normalized_scene()
    _, T1, T2 = jepi.homography_rows(jnp.asarray(n1), jnp.asarray(n2))
    h = rng.normal(size=(9,)).astype(np.float32)
    got = to_np(tepi.homography_from_vec(t(h), t(T1), t(T2)))
    assert np.allclose(got, np.asarray(jepi.homography_from_vec(jnp.asarray(h), T1, T2)), rtol=1e-4, atol=1e-5)


def test_decompositions_and_triangulation_equal_reference():
    n1, n2, mask, R_true, t_true = _normalized_scene(seed=7)
    inl = mask.astype(np.float32)
    E = np.asarray(j_eight_point(jnp.asarray(n1), jnp.asarray(n2), jnp.asarray(inl)))
    R, tv, cnt = tepi.decompose_essential(t(E), t(n1), t(n2), weights=t(inl))
    jR, jt, jcnt = j_decompose_e(jnp.asarray(E), jnp.asarray(n1), jnp.asarray(n2), weights=jnp.asarray(inl))
    assert np.abs(to_np(R) - np.asarray(jR)).max() < 1e-4
    assert np.abs(to_np(tv) - np.asarray(jt)).max() < 1e-3
    assert abs(float(cnt) - float(jcnt)) <= 2
    # Same (R, t) into both triangulations, held against float64. The 2x2
    # normal equations have det ∝ sin²(parallax), so near-parallel rays
    # (outliers) lose digits in any f32 summation order: the port must be
    # as accurate as the reference, point by point in the median and in
    # the worst case.
    X = to_np(tepi.triangulate_normalized(t(jR), t(jt), t(n1), t(n2)))
    jX = np.asarray(jepi.triangulate_normalized(jR, jt, jnp.asarray(n1), jnp.asarray(n2)))
    X64 = to_np(tepi.triangulate_normalized(*(t(np.asarray(a), torch.float64) for a in (jR, jt, n1, n2))))
    rel = np.abs(X - X64).max(-1) / np.abs(X64).max(-1)
    jrel = np.abs(jX - X64).max(-1) / np.abs(X64).max(-1)
    assert np.median(rel) <= 2.0 * np.median(jrel) + 1e-6
    assert rel.max() <= 2.0 * jrel.max() + 1e-6

    p1, p2, _, _, _ = _normalized_scene(seed=8, planar=True)
    H = np.asarray(j_dlt(jnp.asarray(p1), jnp.asarray(p2)))
    R, tv, cnt = tepi.decompose_homography(t(H), t(p1), t(p2))
    jR, jt, jcnt = j_decompose_h(jnp.asarray(H), jnp.asarray(p1), jnp.asarray(p2))
    assert np.abs(to_np(R) - np.asarray(jR)).max() < 1e-3
    assert np.abs(to_np(tv) - np.asarray(jt)).max() < 1e-2
    assert abs(int(cnt) - int(jcnt)) <= 2


def test_nanmedian_averages_the_middle_pair():
    x = np.array(
        [[1.0, 2.0, 3.0, 4.0, np.nan], [5.0, np.nan, 1.0, np.nan, 2.0], [np.nan] * 5, [7.0, 7.0, 1.0, 2.0, 3.0]],
        np.float32,
    )
    ref = np.asarray(jax.vmap(jnp.nanmedian)(jnp.asarray(x)))
    got = to_np(transac.nanmedian(t(x)))
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.array_equal(got[~np.isnan(got)], ref[~np.isnan(ref)])
    assert got[0] == 2.5  # torch.nanmedian would give 2.0


def test_adaptive_threshold_equals_reference():
    p1, p2, mask, _, _ = two_view_scene(seed=9)
    got = float(transac.adaptive_ransac_threshold(1.5, t(p1), t(p2), t(mask)))
    ref = float(jransac.adaptive_ransac_threshold(1.5, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask)))
    assert got == pytest.approx(ref, rel=1e-6)


def test_sample_indices_equal_reference():
    """Gumbel-top-k over bit-exact threefry draws: identical samples."""
    mask = np.random.default_rng(10).random(96) > 0.3
    key = jax.random.fold_in(jax.random.key(0), 5)
    ref = np.asarray(jransac._sample_indices(key, jnp.asarray(mask), 64, 8))
    got = to_np(transac._sample_indices(prng.fold_in(prng.key(0), 5), t(mask), 64, 8))
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("planar", [False, True])
def test_ransac_dual_model_equals_reference(planar):
    n1, n2, mask, _, _ = _normalized_scene(seed=11, planar=planar)
    ce = jransac.RansacConfig(num_hypotheses=64, threshold=2e-3)
    ch = jransac.RansacConfig(num_hypotheses=32, threshold=3e-3)
    ke, kh = jax.random.split(jax.random.key(1))
    dual = jax.jit(jransac.ransac_dual_model, static_argnames=("config_e", "config_h"))
    ref = dual(ke, kh, jnp.asarray(n1), jnp.asarray(n2), jnp.asarray(mask), config_e=ce, config_h=ch)
    tke, tkh = prng.split(prng.key(1))
    got = transac.ransac_dual_model(
        tke, tkh, t(n1), t(n2), t(mask),
        transac.RansacConfig(num_hypotheses=64, threshold=2e-3),
        transac.RansacConfig(num_hypotheses=32, threshold=3e-3),
    )
    for r, g in ((ref.essential, got.essential), (ref.homography, got.homography)):
        assert bool(g.success) == bool(r.success)
        assert abs(int(g.num_inliers) - int(r.num_inliers)) <= 2
        assert (to_np(g.inliers) != np.asarray(r.inliers)).sum() <= 2
        m, jm = to_np(g.model), np.asarray(r.model)
        m, jm = m / np.linalg.norm(m), jm / np.linalg.norm(jm)
        assert min(np.abs(m - jm).max(), np.abs(m + jm).max()) < 1e-3


@pytest.mark.parametrize("planar", [False, True])
def test_estimate_pose_device_equals_reference(planar):
    p1, p2, mask, _, _ = two_view_scene(seed=12, planar=planar)
    ref = jpose.estimate_pose_device(
        jax.random.key(3), jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask), jnp.asarray(K),
        jpose.RobustPoseEstimatorConfig(num_hypotheses=64),
    )
    got = tpose.estimate_pose_device(
        prng.key(3), t(p1), t(p2), t(mask), t(K), tpose.RobustPoseEstimatorConfig(num_hypotheses=64)
    )
    assert bool(got.use_essential) == bool(ref.use_essential)
    assert np.linalg.norm(to_np(got.rotation) - np.asarray(ref.rotation)) < 1e-3
    assert np.abs(to_np(got.translation) - np.asarray(ref.translation)).max() < 1e-2
    assert abs(int(got.num_inliers) - int(ref.num_inliers)) <= 2
    assert float(got.median_displacement_px) == pytest.approx(float(ref.median_displacement_px), rel=1e-6)


def test_estimate_pose_device_batched_equals_per_pair():
    scenes = [two_view_scene(seed=s) for s in (13, 14)]
    keys = prng.fold_in(prng.key(0), torch.arange(2))
    cfg = tpose.RobustPoseEstimatorConfig(num_hypotheses=32)
    batched = tpose.estimate_pose_device(
        keys, torch.stack([t(s[0]) for s in scenes]), torch.stack([t(s[1]) for s in scenes]),
        torch.stack([t(s[2]) for s in scenes]), t(K), cfg,
    )
    for i, s in enumerate(scenes):
        single = tpose.estimate_pose_device(keys[i], t(s[0]), t(s[1]), t(s[2]), t(K), cfg)
        assert torch.equal(batched.inliers[i], single.inliers)
        assert torch.allclose(batched.rotation[i], single.rotation, atol=1e-5)


def test_stability_gates_match_reference():
    cfg = tpose.RobustPoseEstimatorConfig()
    jcfg = jpose.RobustPoseEstimatorConfig()
    good = {"num_matches": 100, "median_displacement_px": 5.0, "score": 1.0, "num_inliers": 80,
            "inlier_ratio": 0.8, "median_parallax_deg": 1.0, "cheirality_ratio": 0.9}
    tpose.apply_stability_gates(cfg, dict(good))
    for field, bad in [("num_matches", 3), ("median_displacement_px", 0.1), ("score", 0.0), ("num_inliers", 9),
                       ("inlier_ratio", 0.1), ("median_parallax_deg", 0.01), ("cheirality_ratio", 0.2)]:
        metrics = dict(good, **{field: bad})
        with pytest.raises(jpose.PoseEstimationFailure) as jerr:
            jpose.apply_stability_gates(jcfg, dict(metrics))
        with pytest.raises(tpose.PoseEstimationFailure) as terr:
            tpose.apply_stability_gates(cfg, dict(metrics))
        assert terr.value.reason == jerr.value.reason
