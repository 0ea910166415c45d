"""The reference's RANSAC reduction rule in the port: the order-pinned
forms at N ≤ 1,024 correspondences (``ops.ransac._auto_pinned``), the
matmul and sum forms above, and the pinned Sampson distance in the pose
estimator's E support vote.

The port is held to the JAX package run op by op (``jax.disable_jit``).
Jitted, XLA:CPU fuses the pinned forms' elementwise products and sums into
one loop and contracts each ``a·b + c`` into a fused multiply-add: the
first level of a hypothesis gram's tree sum comes out as
``fma(a_lo, b_lo, a_hi·b_hi)``, bit for bit, on 27% of its entries, which
moves near-tied hypotheses' votes. No PyTorch program on the CPU rounds
that way. Op by op, the reference rounds every product and sum as its
source writes them, and so does the port: sampled indices, votes and
inlier masks are equal. What is left is the reference's 3×3 matrix
products (``essential_from_vec``, ``homography_from_vec``,
``_invsqrt3x3_psd``), which it computes with ``@`` at every N where the
port writes them out in the pinned order: a few ulps of entries of order
one, hence models within 1e-5 of the largest entry.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from torch_parity import t, to_np

from mvslam_tpu.frontend import pose_estimator as jpose
from mvslam_tpu.geometry import epipolar as jepi
from mvslam_tpu.geometry import projection as jproj
from mvslam_tpu.ops import ransac as jransac
from mvslam_tpu_torch.core import prng
from mvslam_tpu_torch.frontend import pose_estimator as tpose
from mvslam_tpu_torch.geometry import epipolar as tepi
from mvslam_tpu_torch.geometry import projection as tproj
from mvslam_tpu_torch.ops import ransac as transac

E_HYPOTHESES, H_HYPOTHESES = 512, 256  # the bench's counts
E_THRESHOLD, H_THRESHOLD = 2e-3, 3e-3  # normalised: ~1.4 and ~2.1 px at f = 700
MODEL_RTOL = 1e-5  # of the largest entry: see the module docstring

PINNED_DEFAULTS = [
    (tepi._matvec3, jepi._matvec3),
    (tepi._smallest_singular_vector, jepi._smallest_singular_vector),
    (tepi.eight_point_essential, jepi.eight_point_essential),
    (tepi.sampson_error, jepi.sampson_error),
    (tepi.homography_rows, jepi.homography_rows),
    (tepi.dlt_homography, jepi.dlt_homography),
    (tepi.symmetric_transfer_error, jepi.symmetric_transfer_error),
    (tproj.hartley_normalization, jproj.hartley_normalization),
]


def two_view_pair(n, seed, planar):
    """Normalised correspondences of a random 3-D or planar scene seen by
    two cameras: 0.3 px of noise at f = 700, 30% gross outliers, 10% of
    the entries masked out."""
    rng = np.random.default_rng(seed)
    z = np.full(n, 6.0) if planar else rng.uniform(4.0, 9.0, n)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), z], -1)
    ax, ay, az = rng.normal(0.0, 0.03, 3)
    Rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)], [0, np.sin(ax), np.cos(ax)]])
    Ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0], [-np.sin(ay), 0, np.cos(ay)]])
    Rz = np.array([[np.cos(az), -np.sin(az), 0], [np.sin(az), np.cos(az), 0], [0, 0, 1]])
    X2 = X @ (Rz @ Ry @ Rx).T + (np.array([0.4, 0.05, 0.1]) + rng.normal(0.0, 0.05, 3))
    p1 = X[:, :2] / X[:, 2:] + rng.normal(0.0, 4e-4, (n, 2))
    p2 = X2[:, :2] / X2[:, 2:] + rng.normal(0.0, 4e-4, (n, 2))
    bad = rng.random(n) < 0.3
    p2[bad] += rng.uniform(-0.2, 0.2, (int(bad.sum()), 2))
    mask = rng.random(n) > 0.1
    return p1.astype(np.float32), p2.astype(np.float32), mask


def op_by_op(fn, *args, **kwargs):
    """The reference's function with every primitive run on its own."""
    with jax.disable_jit():
        return jax.tree_util.tree_map(np.asarray, fn(*args, **kwargs))


def assert_same_result(got, ref):
    """Inlier masks and counts equal; models within MODEL_RTOL."""
    np.testing.assert_array_equal(to_np(got.inliers), ref.inliers)
    assert int(got.num_inliers) == int(ref.num_inliers)
    assert bool(got.success) == bool(ref.success)
    model = to_np(got.model)
    np.testing.assert_allclose(model, ref.model, rtol=0, atol=MODEL_RTOL * np.abs(ref.model).max())


# (N, planar, seed). Seed 6 at N = 512: the E vote of the matmul and sum
# forms picks another hypothesis (212 inliers against the reference's 188).
DUAL_CASES = [(512, False, 6), (512, True, 1), (256, False, 2), (256, True, 3)]


@pytest.mark.parametrize("n,planar,seed", DUAL_CASES)
def test_dual_model_equals_reference_op_by_op(n, planar, seed):
    p1, p2, mask = two_view_pair(n, seed, planar)
    ke, kh = jax.random.split(jax.random.fold_in(jax.random.key(7), seed))
    ref = op_by_op(
        jransac.ransac_dual_model, ke, kh, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask),
        jransac.RansacConfig(num_hypotheses=E_HYPOTHESES, threshold=E_THRESHOLD),
        jransac.RansacConfig(num_hypotheses=H_HYPOTHESES, threshold=H_THRESHOLD),
    )
    tke, tkh = prng.split(prng.fold_in(prng.key(7), seed))
    got = transac.ransac_dual_model(
        tke, tkh, t(p1), t(p2), t(mask),
        transac.RansacConfig(num_hypotheses=E_HYPOTHESES, threshold=E_THRESHOLD),
        transac.RansacConfig(num_hypotheses=H_HYPOTHESES, threshold=H_THRESHOLD),
    )
    assert_same_result(got.essential, ref.essential)
    assert_same_result(got.homography, ref.homography)


@pytest.mark.parametrize("model", ["essential", "homography"])
@pytest.mark.parametrize("n", [512, 256])
def test_single_model_equals_reference_op_by_op(model, n):
    p1, p2, mask = two_view_pair(n, seed=4, planar=model == "homography")
    hyp, thr = (E_HYPOTHESES, E_THRESHOLD) if model == "essential" else (H_HYPOTHESES, H_THRESHOLD)
    jfn, tfn = getattr(jransac, f"ransac_{model}"), getattr(transac, f"ransac_{model}")
    ref = op_by_op(jfn, jax.random.key(11), jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask),
                   jransac.RansacConfig(num_hypotheses=hyp, threshold=thr))
    got = tfn(prng.key(11), t(p1), t(p2), t(mask), transac.RansacConfig(num_hypotheses=hyp, threshold=thr))
    assert_same_result(got, ref)


def test_pose_estimate_equals_reference_op_by_op():
    """The whole dual-model estimate at 512 matches: the pinned E support
    vote and the plain H transfer votes give the reference's support share
    and model choice."""
    p1, p2, mask = two_view_pair(512, seed=5, planar=False)
    K = np.array([[700.0, 0.0, 600.0], [0.0, 700.0, 180.0], [0.0, 0.0, 1.0]], np.float32)
    px1, px2 = (p @ K[:2, :2].T + K[:2, 2] for p in (p1, p2))
    ref = op_by_op(jpose.estimate_pose_device, jax.random.key(3), jnp.asarray(px1), jnp.asarray(px2),
                   jnp.asarray(mask), jnp.asarray(K), jpose.RobustPoseEstimatorConfig())
    got = tpose.estimate_pose_device(prng.key(3), t(px1), t(px2), t(mask), t(K), tpose.RobustPoseEstimatorConfig())
    np.testing.assert_array_equal(to_np(got.inliers), ref.inliers)
    for name in ("use_essential", "num_inliers", "num_valid_matches"):
        assert to_np(getattr(got, name)) == getattr(ref, name), name
    assert float(got.homography_share) == float(ref.homography_share)
    np.testing.assert_allclose(to_np(got.rotation), ref.rotation, rtol=0, atol=1e-5)


def test_straight_scene_pair_1_equals_reference_op_by_op():
    """Pair 1 of the accuracy benchmark's straight scene under the key
    ``SLAMSystem`` folds for it (seed 3, frame 1), on the port's matches
    (its features equal the reference's): the port takes the reference's
    choice, inliers and support share as the reference computes them op
    by op. (Jitted on XLA:CPU, the reference's FMA-contracted hypothesis
    votes pick another winner there and it takes E.)"""
    from mvslam_tpu.core.determinism import DeterminismRegistry as JRegistry
    from mvslam_tpu_torch.core.determinism import DeterminismRegistry
    from mvslam_tpu_torch.data.synthetic import render_scene
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
    from mvslam_tpu_torch.slam import tracking

    frames, _, (fx, fy, cx, cy), _ = render_scene()
    K = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], np.float32)
    fc = FeaturePipelineConfig(num_features=512, max_matches=256)
    cfg = dict(num_hypotheses=256, adaptive_threshold=False, essential_threshold_px=2.0)
    key = prng.fold_in(DeterminismRegistry(seed=3).key_for("tracking"), 1)
    f0, f1 = (tracking.bootstrap_frame(torch.from_numpy(f), fc) for f in frames[:2])
    track = tracking.match_and_estimate(key, f0, f1, t(K), fc, tpose.RobustPoseEstimatorConfig(**cfg))
    p1, p2, mask = (to_np(x) for x in (track.matched_p1, track.matched_p2, track.match_mask))
    ref = op_by_op(jpose.estimate_pose_device, jax.random.fold_in(JRegistry(seed=3).key_for("tracking"), 1),
                   jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask), jnp.asarray(K),
                   jpose.RobustPoseEstimatorConfig(**cfg))
    got = track.pose
    assert not bool(ref.use_essential) and int(ref.num_inliers) == 161
    np.testing.assert_array_equal(to_np(got.inliers), ref.inliers)
    for name in ("use_essential", "num_inliers"):
        assert to_np(getattr(got, name)) == getattr(ref, name), name
    assert float(got.homography_share) == float(ref.homography_share)


def test_jitted_reference_gram_is_fma_contracted():
    """The evidence behind the op-by-op comparisons: jitted on XLA:CPU, the
    reference's pinned gram (``_gram_tree`` of 8-row hypothesis systems) is
    bit for bit ``fma(a_lo, b_lo, a_hi·b_hi)`` at the tree's first level,
    the other levels plain adds; op by op it rounds each product and sum
    as written, as the port does on every entry."""
    A = np.random.default_rng(0).normal(size=(512, 8, 9)).astype(np.float32)
    jitted = np.asarray(jax.jit(jepi._gram_tree)(jnp.asarray(A)))
    exact = A[:, :, :, None].astype(np.float64) * A[:, :, None, :]  # f32 products are exact in f64
    plain = exact.astype(np.float32)
    level1 = (exact[:, :4] + plain[:, 4:].astype(np.float64)).astype(np.float32)  # one rounding: an FMA
    level2 = level1[:, :2] + level1[:, 2:]
    fma_tree = level2[:, 0] + level2[:, 1]
    np.testing.assert_array_equal(jitted, fma_tree)
    port = to_np(tepi._gram_tree(t(A)))
    np.testing.assert_array_equal(op_by_op(jepi._gram_tree, jnp.asarray(A)), port)
    assert 0.2 < (jitted != port).mean() < 0.35


def _dot_contraction_sizes(jaxpr):
    """Sizes of the contracted axes of every dot_general in a jaxpr."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lhs_axes, _), _ = eqn.params["dimension_numbers"]
            yield from (eqn.invars[0].aval.shape[a] for a in lhs_axes)
        for value in eqn.params.values():
            for sub in value if isinstance(value, (tuple, list)) else (value,):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _dot_contraction_sizes(inner)


@pytest.mark.parametrize("n,pinned", [(512, True), (2048, False)])
def test_both_packages_take_one_form_by_size(n, pinned, monkeypatch):
    """At N = 2,048 both packages take the matmul and sum forms (the refit
    gram is one contraction over the 2N rows), at N = 512 the pinned ones
    (the port's grams go through the tree, the reference contracts nothing
    longer than a 3×3 product)."""
    p1, p2, mask = two_view_pair(n, seed=9, planar=False)
    ce = jransac.RansacConfig(num_hypotheses=E_HYPOTHESES, threshold=E_THRESHOLD)
    ch = jransac.RansacConfig(num_hypotheses=H_HYPOTHESES, threshold=H_THRESHOLD)
    jaxpr = jax.make_jaxpr(lambda a, b, c: jransac.ransac_dual_model(
        jax.random.key(0), jax.random.key(1), a, b, c, ce, ch))(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask))
    longest = max(_dot_contraction_sizes(jaxpr.jaxpr))
    assert longest == (3 if pinned else 2 * n)

    grams = []
    gram_tree = tepi._gram_tree
    monkeypatch.setattr(tepi, "_gram_tree", lambda A: grams.append(A.shape) or gram_tree(A))
    got = transac.ransac_dual_model(
        prng.key(0), prng.key(1), t(p1), t(p2), t(mask),
        transac.RansacConfig(num_hypotheses=E_HYPOTHESES, threshold=E_THRESHOLD),
        transac.RansacConfig(num_hypotheses=H_HYPOTHESES, threshold=H_THRESHOLD),
    )
    assert bool(grams) == pinned
    assert transac._auto_pinned(n) == jransac._auto_pinned(n) == pinned
    assert bool(got.essential.success) and int(got.essential.num_inliers) > 0.5 * mask.sum()


@pytest.mark.parametrize("n", [1024, 1025])
@pytest.mark.parametrize("mesh_invariant", [False, True])
def test_auto_pinned_truth_table(n, mesh_invariant):
    """Pinned at N ≤ 1,024 or under ``mesh_invariant`` (any one config),
    as the reference decides."""
    cfgs = (transac.RansacConfig(), transac.RansacConfig(mesh_invariant=mesh_invariant))
    jcfgs = (jransac.RansacConfig(), jransac.RansacConfig(mesh_invariant=mesh_invariant))
    want = n <= 1024 or mesh_invariant
    assert transac._auto_pinned(n, *cfgs) is want
    assert jransac._auto_pinned(n, *jcfgs) is want
    assert transac._PINNED_N_CUTOFF == jransac._PINNED_N_CUTOFF == 1024


@pytest.mark.parametrize("port_fn,ref_fn", PINNED_DEFAULTS, ids=[f.__name__ for f, _ in PINNED_DEFAULTS])
def test_geometry_defaults_equal_reference(port_fn, ref_fn):
    """Every pinned-capable geometry function defaults to the reference's
    form, so a caller that passes no ``pinned`` gets its arithmetic."""
    port = inspect.signature(port_fn).parameters
    ref = inspect.signature(ref_fn).parameters
    assert port["pinned"].default is ref["pinned"].default is True
    assert {k: p.default for k, p in port.items()} == {k: p.default for k, p in ref.items()}
