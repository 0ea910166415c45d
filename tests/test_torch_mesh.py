"""The port's device mesh (``mvslam_tpu_torch.parallel``) against the JAX
package's, on the CPU.

Port meshes are tuples of CPU slots (``Mesh(["cpu"] * n)``), the
counterpart of the reference's eight virtual CPU devices (``conftest.py``).
The small meshed JAX calls (RANSAC, bundle adjustment, pose graphs, the
index, batched pairs) run in process on that eight-device mesh; the meshed
superwindow is held against the JAX package's unsharded
``track_superwindow`` with ``mesh_invariant=True``, which the reference's
own contract equates with its meshed run on every integer stage.

Tolerances: ``tree_sum`` is adds only and bit-equal to JAX's. The other
pinned forms are jitted on the JAX side, where XLA:CPU contracts
multiply-adds into FMAs, so they are held to JAX within a stated tolerance,
and bit-equal between a batch and its slices within the port. RANSAC is
compared across packages on the reference's well-posed 3-D problem;
tracking across packages on integer stages, and poses against the port's
own unsharded run.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from torch_parity import desc_u32, t, to_np

import mvslam_tpu.core as jcore
import mvslam_tpu.geometry as jgeometry
import mvslam_tpu.ops as jops
import mvslam_tpu.parallel as jparallel
import mvslam_tpu.slam as jslam
from mvslam_tpu.backend import bundle_adjustment as jba
from mvslam_tpu.backend import pose_graph as jpg
from mvslam_tpu.backend import solvers as js
from mvslam_tpu.frontend.feature_pipeline import FeaturePipelineConfig as JFC
from mvslam_tpu.frontend.pose_estimator import RobustPoseEstimatorConfig as JPC
from mvslam_tpu.geometry import epipolar as jep
from mvslam_tpu.geometry import linalg as jla
from mvslam_tpu.geometry import projection as jproj
from mvslam_tpu.loopclosure.device_index import DeviceBoWIndex as JIndex
from mvslam_tpu.ops import ransac as jr
from mvslam_tpu.parallel import mesh as jmesh
from mvslam_tpu.slam import tracking as jtrack

import mvslam_tpu_torch.core as tcore
import mvslam_tpu_torch.geometry as tgeometry
import mvslam_tpu_torch.ops as tops
import mvslam_tpu_torch.parallel as tparallel
import mvslam_tpu_torch.slam as tslam
from mvslam_tpu_torch.backend import bundle_adjustment as tba
from mvslam_tpu_torch.backend import pose_graph as tpg
from mvslam_tpu_torch.backend import solvers as ts
from mvslam_tpu_torch.core import prng
from mvslam_tpu_torch.core.sharding import Mesh, NamedSharding
from mvslam_tpu_torch.data.synthetic import render_scene
from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig as TFC
from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig as TPC
from mvslam_tpu_torch.geometry import epipolar as tep
from mvslam_tpu_torch.geometry import linalg as tla
from mvslam_tpu_torch.geometry import projection as tproj
from mvslam_tpu_torch.loopclosure.device_index import DeviceBoWIndex as TIndex
from mvslam_tpu_torch.ops import ransac as tr
from mvslam_tpu_torch.parallel import mesh as tmesh
from mvslam_tpu_torch.slam import tracking as ttrack

from test_bundle_adjustment import synthetic_ba_problem


def cpu_mesh(n):
    return Mesh([torch.device("cpu")] * n, ("data",))


def test_virtual_mesh_available():
    assert len(jax.devices()) == 8


# ---------------------------------------------------------------------------
# Public names
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "ours,ref",
    [(tparallel, jparallel), (tcore, jcore), (tgeometry, jgeometry), (tops, jops), (tslam, jslam)],
    ids=["parallel", "core", "geometry", "ops", "slam"],
)
def test_subpackage_names_equal_reference(ours, ref):
    assert ours.__all__ == ref.__all__
    assert all(callable(getattr(ours, name)) for name in ours.__all__)


def test_mesh_module_signatures_and_mesh_type():
    import inspect

    for name in jparallel.__all__:
        assert list(inspect.signature(getattr(tmesh, name)).parameters) == list(
            inspect.signature(getattr(jmesh, name)).parameters
        ), name
    assert tmesh.Mesh is Mesh
    mesh = cpu_mesh(4)
    assert (mesh.size, mesh.axis_names, mesh.devices) == (4, ("data",), (torch.device("cpu"),) * 4)
    assert NamedSharding(mesh, "data").axis == "data"
    with pytest.raises(ValueError):
        NamedSharding(mesh, "model")
    with pytest.raises(RuntimeError):
        Mesh(["cuda:0"])  # a slot whose device is missing raises
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tparallel.make_mesh(1)


def test_image_and_orientation_functions_equal_reference():
    from mvslam_tpu.ops import brief as jbrief
    from mvslam_tpu.ops import image as jimage
    from mvslam_tpu_torch.ops import image as timage

    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, size=(2, 70, 90)).astype(np.float32)
    for a, b in zip(jimage.build_pyramid(jnp.asarray(img), 3), timage.build_pyramid(t(img), 3)):
        np.testing.assert_array_equal(np.asarray(a), to_np(b))
    assert [timage.scale_for_level(k) for k in range(4)] == [jimage.scale_for_level(k) for k in range(4)]
    (pj, hw_j), (pt, hw_t) = jimage.pad_to_multiple(jnp.asarray(img), 32), timage.pad_to_multiple(t(img), 32)
    np.testing.assert_array_equal(np.asarray(pj), to_np(pt))
    assert hw_j == hw_t == (70, 90) and pt.shape == (2, 96, 96)
    assert timage.pad_to_multiple(t(img[:, :64, :64]), 32)[0].shape == (2, 64, 64)
    # Orientations of real tiles (interior keypoints) on one 8-bit image: its
    # moments are exact integer sums in both packages.
    img = np.round(img)
    xy = np.stack([rng.uniform(20, 70, 40), rng.uniform(20, 50, 40)], 1).astype(np.float32)
    valid = np.arange(40) % 5 != 0
    ref = np.asarray(jbrief.compute_orientations(jnp.asarray(img[0]), jnp.asarray(xy), jnp.asarray(valid)))
    got = to_np(tops.compute_orientations(t(img[0]), t(xy), t(valid)))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert (got[~valid] == 0).all()


# ---------------------------------------------------------------------------
# Order-pinned forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 100, 257])
def test_tree_sum_bit_equal_to_jax(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((3, n, 4)) * 10.0 ** rng.integers(-3, 4, size=(3, n, 4))).astype(np.float32)
    for axis in (1, -1, 0):
        ref = np.asarray(jla.tree_sum(jnp.asarray(x), axis=axis))
        got = to_np(tla.tree_sum(t(x), axis))
        np.testing.assert_array_equal(got, ref)


def _samples(k=48, n=8, seed=0, outliers=False):
    """k minimal samples of the reference's two-view scene, normalised."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, (k, n)), rng.uniform(-1, 1, (k, n)), rng.uniform(4, 10, (k, n))], -1)
    R = np.asarray(jgeometry.so3_exp(jnp.asarray([0.03, -0.02, 0.01], jnp.float32)), np.float64)
    cam2 = pts @ R.T + np.array([0.5, 0.1, 0.05])
    p1 = pts[..., :2] / pts[..., 2:]
    p2 = cam2[..., :2] / cam2[..., 2:]
    if outliers:
        p2[:, : n // 4] += 0.1
    return p1.astype(np.float32), p2.astype(np.float32)


def _forms():
    """name → (port function of numpy inputs, JAX function, inputs, tol)."""
    p1, p2 = _samples()
    q1, q2 = _samples(k=4, n=96, seed=1, outliers=True)
    w = (np.random.default_rng(2).uniform(size=q1.shape[:2]) > 0.3).astype(np.float32)
    E = np.asarray(jep.eight_point_essential(jnp.asarray(p1), jnp.asarray(p2)))
    H = np.asarray(jep.dlt_homography(jnp.asarray(p1[:, :4]), jnp.asarray(p2[:, :4])))
    h1 = np.concatenate([p1, np.ones_like(p1[..., :1])], -1)
    A = np.asarray(jep.essential_rows(jnp.asarray(q1), jnp.asarray(q2), jnp.asarray(w)))
    return {
        "gram_tree": (lambda a: tep._gram_tree(t(a)), jep._gram_tree, (A,), 1e-5),
        "matvec3": (lambda m, x: tep._matvec3(t(m), t(x), True), jep._matvec3, (E, h1), 1e-6),
        "sampson_error": (lambda e, a, b: tep.sampson_error(t(e), t(a), t(b), True), jep.sampson_error,
                          (E, p1, p2), 1e-9),
        "eight_point_hypotheses": (lambda a, b: tep.eight_point_essential(t(a), t(b), pinned=True),
                                   jep.eight_point_essential, (p1, p2), 1e-4),
        "eight_point_refit": (lambda a, b, c: tep.eight_point_essential(t(a), t(b), t(c), pinned=True),
                              jep.eight_point_essential, (q1, q2, w), 1e-4),
        "dlt_hypotheses": (lambda a, b: tep.dlt_homography(t(a), t(b), pinned=True), jep.dlt_homography,
                           (p1[:, :4], p2[:, :4]), 1e-3),
        "dlt_refit": (lambda a, b, c: tep.dlt_homography(t(a), t(b), t(c), pinned=True), jep.dlt_homography,
                      (q1, q2, w), 1e-3),
        "transfer_error": (lambda m, a, b: tep.symmetric_transfer_error(t(m), t(a), t(b), True),
                           jep.symmetric_transfer_error, (H, p1, p2), 1e-6),
        "hartley_weighted": (lambda a, c: tproj.hartley_normalization(t(a), t(c), pinned=True)[1],
                             lambda a, c: jproj.hartley_normalization(a, c, pinned=True)[1], (q1, w), 1e-5),
        "hartley": (lambda a: tproj.hartley_normalization(t(a), pinned=True)[1],
                    lambda a: jproj.hartley_normalization(a, pinned=True)[1], (p1[:, :4],), 1e-5),
    }


def _aligned(x, ref):
    """Essentials are defined up to sign: flip each of x to agree with ref."""
    s = np.sign((x * ref).reshape(x.shape[0], -1).sum(1))
    return x * s.reshape((-1,) + (1,) * (x.ndim - 1))


@pytest.mark.parametrize("name", list(_forms()))
def test_pinned_form_close_to_jax(name):
    """Within ``tol`` (absolute, on the scale of the values) and 1e-5
    relative. A minimal sample's null vector is conditioned by its eight
    (or four) points alone, and f32 roundoff moves some of them far: the
    JAX package's own pinned and plain forms disagree by more than 1e-3 on
    several of these hypotheses. There the port may be no farther from
    JAX's pinned form than JAX's plain form is: a median per hypothesis at
    most twice that one's, and at most 1/8 of the batch more hypotheses
    off by over 1e-3."""
    port, ref, args, tol = _forms()[name]
    jargs = [jnp.asarray(a) for a in args]
    got = to_np(port(*args))
    want = np.asarray(jax.jit(ref)(*jargs))
    if name.startswith("eight_point"):
        got = _aligned(got, want)
    if name.endswith("_hypotheses"):
        plain = np.asarray(jax.jit(lambda *a: ref(*a, pinned=False))(*jargs))
        if name.startswith("eight_point"):
            plain = _aligned(plain, want)
        per_hyp = np.abs(got - want).reshape(len(got), -1).max(axis=1)
        own = np.abs(plain - want).reshape(len(got), -1).max(axis=1)
        assert np.median(per_hyp) <= 2 * np.median(own), (np.median(per_hyp), np.median(own))
        assert (per_hyp > 1e-3).sum() <= (own > 1e-3).sum() + len(got) // 8, (per_hyp, own)
        return
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=1e-5)


@pytest.mark.parametrize("name", list(_forms()))
def test_pinned_form_batch_equals_slices(name):
    port, _, args, _ = _forms()[name]
    whole = to_np(port(*args))
    n = args[0].shape[0]
    cuts = [0, 1, n // 3, n - 1, n] if n > 3 else [0, 1, 2, n]
    pieces = [to_np(port(*[a[lo:hi] for a in args])) for lo, hi in zip(cuts[:-1], cuts[1:]) if hi > lo]
    np.testing.assert_array_equal(np.concatenate(pieces), whole)


def test_pinned_eigvec_and_default_path_unchanged():
    """The pinned inverse iteration is bit-stable across slices; the default
    (unpinned) solvers are what they were (the plain-sum forms)."""
    p1, p2 = _samples(k=32)
    rows = tep.essential_rows(t(p1), t(p2))
    gram = rows.transpose(-1, -2) @ rows
    whole = tla.smallest_eigvec_psd(gram, pinned=True)
    np.testing.assert_array_equal(
        to_np(torch.cat([tla.smallest_eigvec_psd(gram[:5], pinned=True), tla.smallest_eigvec_psd(gram[5:], pinned=True)])),
        to_np(whole),
    )
    default = tep.eight_point_essential(t(p1), t(p2))
    plain = tep.essential_from_vec(tla.smallest_eigvec_psd(gram, rescue=False), exact_rank2=False)
    np.testing.assert_array_equal(to_np(default), to_np(plain))


# ---------------------------------------------------------------------------
# Hypothesis-sharded RANSAC
# ---------------------------------------------------------------------------


def _ransac_problem(n=256, seed=0):
    """The reference's well-posed 3-D problem (parallel_checks.py): 25%
    outliers, normalised coordinates."""
    rng = np.random.default_rng(seed)
    pts3d = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1, 1, n), rng.uniform(4, 10, n)], 1)
    R = np.asarray(jgeometry.so3_exp(jnp.asarray([0.03, -0.02, 0.01], dtype=jnp.float32)))
    tv = np.array([0.5, 0.1, 0.05])
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    cam2 = pts3d @ R.T + tv
    uv1 = (pts3d[:, :2] / pts3d[:, 2:]) * [500, 500] + [320, 240]
    uv2 = (cam2[:, :2] / cam2[:, 2:]) * [500, 500] + [320, 240]
    out = rng.choice(n, n // 4, replace=False)
    uv2[out] += 50.0
    Kj = jnp.asarray(K, jnp.float32)
    n1 = np.asarray(jproj.normalize_pixels(jnp.asarray(uv1, jnp.float32), Kj))
    n2 = np.asarray(jproj.normalize_pixels(jnp.asarray(uv2, jnp.float32), Kj))
    return n1, n2


def test_sharded_ransac_bit_equal_across_mesh_sizes_and_to_jax():
    n1, n2 = _ransac_problem()
    mask = np.ones(n1.shape[0], bool)
    cfg_t = tr.RansacConfig(num_hypotheses=256, threshold=2.0 / 500.0, mesh_invariant=True)
    single = tr.ransac_essential(prng.key(0), t(n1), t(n2), t(mask), cfg_t)
    assert bool(single.success) and int(single.num_inliers) > 150
    for size in (1, 2, 8):
        res = tparallel.sharded_ransac_essential(cpu_mesh(size), prng.key(0), t(n1), t(n2), t(mask), cfg_t)
        assert torch.equal(res.model, single.model), size
        assert torch.equal(res.inliers, single.inliers), size
        assert int(res.num_inliers) == int(single.num_inliers)
    cfg_j = jr.RansacConfig(num_hypotheses=256, threshold=2.0 / 500.0, mesh_invariant=True)
    ref = jparallel.sharded_ransac_essential(
        jparallel.make_mesh(8), jax.random.key(0), jnp.asarray(n1), jnp.asarray(n2), jnp.asarray(mask), cfg_j
    )
    np.testing.assert_array_equal(to_np(single.inliers), np.asarray(ref.inliers))
    np.testing.assert_allclose(_aligned(to_np(single.model)[None], np.asarray(ref.model)[None])[0],
                               np.asarray(ref.model), atol=1e-4)


def test_sharded_homography_and_batched_frames_bit_equal():
    """hypothesis_sharding also on the homography model and with a leading
    frame axis: bit-equal to the unsharded pinned call."""
    n1, n2 = _ransac_problem(n=128, seed=3)
    p1 = np.stack([n1, n1 * 0.9])
    p2 = np.stack([n2, n2 * 0.9])
    mask = np.ones(p1.shape[:2], bool)
    mask[1, ::7] = False
    keys = prng.fold_in(prng.key(5), torch.arange(2))
    cfg = tr.RansacConfig(num_hypotheses=64, threshold=3.0 / 500.0, mesh_invariant=True)
    for fn in (tr.ransac_homography, tr.ransac_essential):
        ref = fn(keys, t(p1), t(p2), t(mask), cfg)
        for size in (2, 4):
            got = fn(keys, t(p1), t(p2), t(mask), cfg, hypothesis_sharding=NamedSharding(cpu_mesh(size), "data"))
            assert torch.equal(got.model, ref.model) and torch.equal(got.inliers, ref.inliers)


def test_ransac_errors():
    n1, n2 = _ransac_problem(n=32)
    with pytest.raises(ValueError, match="num_hypotheses \\(100\\) must divide by mesh size 8"):
        tparallel.sharded_ransac_essential(
            cpu_mesh(8), prng.key(0), t(n1), t(n2), torch.ones(32, dtype=torch.bool), tr.RansacConfig(num_hypotheses=100)
        )


# ---------------------------------------------------------------------------
# Data-parallel tracking
# ---------------------------------------------------------------------------


def textured(seed, h=96, w=128):
    """The reference's textured frame (parallel_checks.py)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 30, size=(h, w)).astype(np.float32)
    for _ in range(50):
        y, x, s = rng.integers(22, h - 28), rng.integers(22, w - 28), rng.integers(3, 7)
        img[y : y + s, x : x + s] = rng.uniform(140, 255)
    return img


def test_batched_track_pairs_against_jax():
    B = 8
    prev = np.stack([textured(s) for s in range(B)])
    nxt = np.stack([np.roll(f, 4, axis=1) for f in prev])
    K = np.asarray([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]], np.float32)
    jf, jt = jparallel.batched_track_pairs(
        jparallel.make_mesh(8), jnp.asarray(prev), jnp.asarray(nxt), jnp.asarray(K),
        JFC(num_features=128, max_matches=64), JPC(num_hypotheses=64),
    )
    runs = {}
    for size in (1, 2, 8):
        runs[size] = tparallel.batched_track_pairs(
            cpu_mesh(size), t(prev), t(nxt), t(K), TFC(num_features=128, max_matches=64), TPC(num_hypotheses=64)
        )
    feats, track = runs[8]
    assert feats.xy.shape == (B, 128, 2) and track.pose.rotation.shape == (B, 3, 3)
    # Integer stages exactly as the JAX package's meshed run.
    np.testing.assert_array_equal(to_np(feats.xy), np.asarray(jf.xy))
    np.testing.assert_array_equal(desc_u32(feats.descriptors), np.asarray(jf.descriptors))
    np.testing.assert_array_equal(to_np(track.match_mask), np.asarray(jt.match_mask))
    np.testing.assert_array_equal(to_np(track.num_matches), np.asarray(jt.num_matches))
    np.testing.assert_array_equal(to_np(track.num_features), np.asarray(jt.num_features))
    assert int((track.num_matches > 5).sum()) >= 6  # most pairs track
    for size in (1, 2):
        f, tr_ = runs[size]
        for a, b in zip(f, feats):
            assert torch.equal(a, b)
        for name in ("match_mask", "num_matches", "num_features", "matched_p1", "matched_p2"):
            assert torch.equal(getattr(tr_, name), getattr(track, name)), name
        assert torch.equal(tr_.pose.use_essential, track.pose.use_essential)
        assert (tr_.scalars_packed[..., :12] - track.scalars_packed[..., :12]).abs().max() < 1e-3


@pytest.fixture(scope="module")
def superwindow_scene():
    frames, _, (fx, fy, cx, cy), _ = render_scene(num_frames=17, h=160, w=224, seed=2)
    K = np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    return np.asarray(frames, np.float32), K


SW_FC = dict(num_features=256, max_matches=128)
SW_PC = dict(num_hypotheses=128, adaptive_threshold=False, essential_threshold_px=2.0, mesh_invariant=True)


def test_meshed_superwindow_matches_unsharded(superwindow_scene):
    """Frames-DP superwindow: integer stages bit-equal to the JAX package's
    unsharded run with mesh_invariant=True; use_essential bit-equal and
    poses within 1e-3 of the port's own unsharded run."""
    frames, K = superwindow_scene
    jfc, jpc = JFC(**SW_FC), JPC(**SW_PC)
    jprev = jtrack.bootstrap_frame(jnp.asarray(frames[0]), jfc)
    jlast, jref = jtrack.track_superwindow(
        jax.random.key(7), jprev, jnp.asarray(frames[1:]), jnp.asarray(K), jfc, jpc, window=8,
        start_index=jnp.asarray(1, jnp.int32),
    )
    jpacked = np.asarray(jref.scalars_packed)

    tfc, tpc = TFC(**SW_FC), TPC(**SW_PC)
    prev = ttrack.bootstrap_frame(t(frames[0]), tfc)
    key = prng.key(7)
    last_ref, ref = ttrack.track_superwindow(key, prev, t(frames[1:]), t(K), tfc, tpc, window=8, start_index=1)
    ref_packed = to_np(ref.scalars_packed)
    np.testing.assert_array_equal(ref_packed[..., 23:25], jpacked[..., 23:25])
    np.testing.assert_array_equal(to_np(ref.match_mask), np.asarray(jref.match_mask))
    np.testing.assert_array_equal(desc_u32(last_ref.descriptors), np.asarray(jlast.descriptors))
    np.testing.assert_array_equal(to_np(ref.features_packed), np.asarray(jref.features_packed))
    assert (ref_packed[..., 23] > 20).all()

    for size in (2, 8):
        last, track = tparallel.track_superwindow_meshed(
            cpu_mesh(size), key, prev, t(frames[1:]), t(K), tfc, tpc, window=8, start_index=1
        )
        got = to_np(track.scalars_packed)
        assert got.shape == ref_packed.shape == (2, 8, 25)
        np.testing.assert_array_equal(got[..., 23:25], jpacked[..., 23:25])  # num_matches, num_features
        np.testing.assert_array_equal(to_np(track.match_mask), np.asarray(jref.match_mask))
        np.testing.assert_array_equal(to_np(track.features_packed), np.asarray(jref.features_packed))
        np.testing.assert_array_equal(desc_u32(last.descriptors), np.asarray(jlast.descriptors))
        np.testing.assert_array_equal(got[..., 12], ref_packed[..., 12])  # use_essential
        assert np.abs(got[..., :12] - ref_packed[..., :12]).max() < 1e-3


def test_meshed_superwindow_run_to_run_and_errors(superwindow_scene):
    frames, K = superwindow_scene
    fc, pc = TFC(num_features=128, max_matches=64), TPC(num_hypotheses=64)
    prev = ttrack.bootstrap_frame(t(frames[0]), fc)
    runs = [
        to_np(tparallel.track_superwindow_meshed(cpu_mesh(8), prng.key(3), prev, t(frames[1:9]), t(K), fc, pc,
                                                 window=8)[1].scalars_packed)
        for _ in range(2)
    ]
    np.testing.assert_array_equal(runs[0], runs[1])
    with pytest.raises(ValueError, match="window \\(12\\) must divide by mesh size 8"):
        tparallel.track_superwindow_meshed(cpu_mesh(8), prng.key(0), prev, t(frames[1:13]), t(K), fc, pc, window=12)
    with pytest.raises(ValueError, match="window \\(6\\) must divide by mesh size 4"):
        ttrack.track_window(prng.key(0), prev, t(frames[1:7]), t(K), fc, pc,
                            window_sharding=NamedSharding(cpu_mesh(4), "data"))


# ---------------------------------------------------------------------------
# Back end
# ---------------------------------------------------------------------------


def _port_obs(obs):
    return [tba.Observation(o.pose_index, o.point_index, o.uv) for o in obs]


def _ba_close(res, ref, points_atol=1e-3):
    np.testing.assert_allclose(res.poses, ref.poses, atol=1e-4)
    np.testing.assert_allclose(res.points, ref.points, atol=points_atol)
    assert abs(res.diagnostics.final_cost - ref.diagnostics.final_cost) < 1e-2 * max(1.0, ref.diagnostics.final_cost)


def test_sharded_ba_matches_unsharded_and_jax():
    """The reference's tolerances against the port's unsharded solve and
    JAX's meshed one, but for the points against JAX: 2e-3 there, the
    bound that the unsharded packages meet (test_torch_ba.py), points lying
    at depths up to 14."""
    _, poses_init, _, pts_init, obs, K = synthetic_ba_problem(W=4, P=48)
    jcfg, tcfg = jba.BundleAdjustmentConfig(max_iterations=8), tba.BundleAdjustmentConfig(max_iterations=8)
    jref = jparallel.run_bundle_adjustment_sharded(jparallel.make_mesh(8), poses_init, pts_init, obs, K, jcfg)
    ref = tba.run_bundle_adjustment(poses_init, pts_init, _port_obs(obs), K, tcfg, device="cpu")
    assert not ref.diagnostics.conditioning_tripped
    for size in (1, 8):
        res = tparallel.run_bundle_adjustment_sharded(cpu_mesh(size), poses_init, pts_init, _port_obs(obs), K, tcfg)
        assert not res.diagnostics.conditioning_tripped
        _ba_close(res, ref)
        _ba_close(res, jref, points_atol=2e-3)


def test_sharded_ba_run_to_run_and_budget_rounding(caplog):
    _, poses_init, _, pts_init, obs, K = synthetic_ba_problem(W=3, P=32, seed=5)
    cfg = tba.BundleAdjustmentConfig(max_iterations=6)
    a = tparallel.run_bundle_adjustment_sharded(cpu_mesh(8), poses_init, pts_init, _port_obs(obs), K, cfg)
    b = tparallel.run_bundle_adjustment_sharded(cpu_mesh(8), poses_init, pts_init, _port_obs(obs), K, cfg)
    np.testing.assert_array_equal(a.poses, b.poses)
    np.testing.assert_array_equal(a.points, b.points)
    # 90 observations, budget request 100 → rounds to 104 (the reference's case).
    _, poses_init, _, pts_init, obs, K = synthetic_ba_problem(W=3, P=32)
    obs = obs[:90]
    ref = tba.run_bundle_adjustment(poses_init, pts_init, _port_obs(obs), K, cfg, max_observations=104, device="cpu")
    jres = jparallel.run_bundle_adjustment_sharded(
        jparallel.make_mesh(8), poses_init, pts_init, obs, K, jba.BundleAdjustmentConfig(max_iterations=6),
        max_observations=100,
    )
    with caplog.at_level(logging.INFO, logger="mvslam_tpu_torch.parallel.mesh"):
        res = tparallel.run_bundle_adjustment_sharded(
            cpu_mesh(8), poses_init, pts_init, _port_obs(obs), K, cfg, max_observations=100
        )
    assert any("rounding BA observation budget" in r.message for r in caplog.records)
    np.testing.assert_allclose(res.poses, ref.poses, atol=1e-4)
    np.testing.assert_allclose(res.points, ref.points, atol=1e-3)
    np.testing.assert_allclose(res.poses, jres.poses, atol=1e-4)
    with pytest.raises(ValueError, match="observation budget \\(100\\) must divide by mesh size 8"):
        tba.run_bundle_adjustment(poses_init, pts_init, _port_obs(obs), K, cfg, max_observations=100,
                                  observation_sharding=NamedSharding(cpu_mesh(8), "data"))


def _chain(pkg, n_nodes, seed=3, loop=False):
    """The reference's noisy SE(3) odometry chain (+ one loop edge)."""
    rng = np.random.default_rng(seed)
    graph = pkg.PoseGraph3D()
    for _ in range(n_nodes - 1):
        graph.add_pose(np.array([1.0 + rng.normal(0, 0.05), rng.normal(0, 0.02), 0.0,
                                 rng.normal(0, 0.01), rng.normal(0, 0.01), rng.normal(0, 0.02)]))
    if loop:
        graph.add_loop(0, n_nodes - 1, np.array([float(n_nodes - 1), 0, 0, 0, 0, 0]))
    return graph


def _problems(n_nodes, seed=3, loop=False):
    jp = _chain(jpg, n_nodes, seed, loop)._build_graph().build_problem()
    tp = _chain(tpg, n_nodes, seed, loop)._build_graph().build_problem(device="cpu")
    return jp, tp


@pytest.mark.parametrize(
    "n_nodes,seed,loop,method",
    [(33, 3, False, "cholesky"), (8, 3, False, "cholesky"), (13, 11, True, "cholesky"), (33, 3, False, "cg")],
    ids=["chain32", "uneven7", "chain_plus_loop", "chain32_cg"],
)
def test_sharded_solve_matches_unsharded_and_jax(n_nodes, seed, loop, method, caplog):
    jp, tp = _problems(n_nodes, seed, loop)
    jcfg, tcfg = js.SolverConfig(max_iterations=10, method=method), ts.SolverConfig(max_iterations=10, method=method)
    ref = ts.solve_problem(tp, tcfg)
    jref = jparallel.solve_problem_sharded(jparallel.make_mesh(8), jp, jcfg)
    for size in (1, 8):
        with caplog.at_level(logging.INFO, logger="mvslam_tpu_torch.parallel.mesh"):
            res = tparallel.solve_problem_sharded(cpu_mesh(size), tp, tcfg)
        for other in (ref, jref):
            np.testing.assert_allclose(res.x, other.x, atol=1e-4)
            assert abs(res.final_cost - other.final_cost) < 1e-3 * max(1.0, other.final_cost)
    padded = tp.num_factors % 8 != 0
    assert any("padded pose-graph factors" in r.message for r in caplog.records) == padded
    assert tp.num_factors == n_nodes - 1 + int(loop)  # the caller's problem is left as it was


def test_sharded_solve_run_to_run():
    _, tp = _problems(17)
    cfg = ts.SolverConfig(max_iterations=6)
    a = tparallel.solve_problem_sharded(cpu_mesh(8), tp, cfg)
    b = tparallel.solve_problem_sharded(cpu_mesh(8), tp, cfg)
    np.testing.assert_array_equal(a.x, b.x)
    assert a.final_cost == b.final_cost


# ---------------------------------------------------------------------------
# Place index
# ---------------------------------------------------------------------------


def _hists(n, v, seed):
    rng = np.random.default_rng(seed)
    h = rng.uniform(0, 1, size=(n, v)).astype(np.float32)
    return h / np.linalg.norm(h, axis=1, keepdims=True)


def test_sharded_index_topk_matches_unsharded_and_jax():
    hists = _hists(24, 32, 0)
    hists[17] = hists[2]  # an exact tie across blocks
    q = hists[5] * 0.9 + 0.1 * hists[11]
    q /= np.linalg.norm(q)
    ref = TIndex.from_histograms(range(24), hists, capacity=32, device="cpu")
    for query in (q, hists[2]):
        ref_top = ref.topk(query, k=5)
        for size in (2, 8):
            jtop = JIndex.from_histograms(range(24), hists, capacity=32, mesh=jparallel.make_mesh(size)).topk(query, 5)
            sharded = TIndex.from_histograms(range(24), hists, capacity=30, mesh=cpu_mesh(size))
            assert sharded.capacity == 30 + (-30) % size
            got = sharded.topk(query, k=5)
            assert [f for f, _ in got] == [f for f, _ in ref_top] == [f for f, _ in jtop]
            np.testing.assert_allclose([s for _, s in got], [s for _, s in jtop], atol=1e-6)
    assert [f for f, _ in ref.topk(hists[2], k=2)] == [2, 17]


def test_sharded_index_add_grow_and_owning_block():
    hists = _hists(20, 16, 7)
    index = TIndex(16, capacity=8, mesh=cpu_mesh(8))
    before = [b.clone() for b in index._blocks]
    index.add(0, hists[0])
    index.add(1, hists[1])
    changed = [not torch.equal(a, b) for a, b in zip(before, index._blocks)]
    assert changed == [True, True] + [False] * 6  # one row per block at capacity 8: rows 0 and 1
    for fid in range(2, 20):
        index.add(fid, hists[fid])  # grows past 8 mid-way
    assert index.capacity >= 20 and index.capacity % 8 == 0
    assert all(b.shape == (index.capacity // 8, 16) for b in index._blocks)
    q = hists[13]
    np.testing.assert_allclose(index.scores(q), hists @ q, atol=1e-5)
    assert index.topk(q, k=1)[0][0] == 13
    bulk = TIndex.from_histograms(range(20), hists, capacity=index.capacity, device="cpu")
    np.testing.assert_array_equal(to_np(index._buf), to_np(bulk._buf))
    grown = TIndex(16, capacity=4, mesh=cpu_mesh(4))
    grown.grow(10)
    assert grown.capacity == 12
