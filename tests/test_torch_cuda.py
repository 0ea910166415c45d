"""CUDA kernels K1 and K2 against their plain PyTorch versions, on the card,
alone and inside LK and ``SLAMSystem``; the back end's BA and Gauss-Newton
cores on the card against the same calls on the CPU, and bit-equal between
two card runs; the bag-of-words stages and the device index on the card.

Every test here needs an NVIDIA GPU and nvcc (marker ``cuda``); without a
card they skip. This file imports no JAX, so it also runs on a machine
without it, where the JAX-importing ``conftest.py`` must be left out::

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from mvslam_tpu_torch.ops import cuda_fast, cuda_patches

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda", 0)


def _textured(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 40, size=(b, h, w)).astype(np.float32)
    for _ in range(b * h * w // 400):
        i, y, x = rng.integers(0, b), rng.integers(0, max(1, h - 8)), rng.integers(0, max(1, w - 8))
        s = rng.integers(3, 8)
        img[i, y : y + s, x : x + s] = rng.uniform(120, 255)
    return img


@pytest.mark.parametrize("dtype", ["uint8", "float32", "float32_frac"])
@pytest.mark.parametrize(
    "shape",
    [
        (2, 45, 77), (3, 96, 160), (1, 370, 1226),
        # widths no multiple of 4, 8, 16 or the tile, heights no multiple of
        # the tile, images smaller than one tile; B = 1 and 16 (the kernel
        # picks its tile height by the tile count)
        (16, 370, 1226), (1, 185, 613), (16, 92, 306), (1, 33, 77), (16, 45, 45), (1, 7, 9), (2, 3, 5),
    ],
)
def test_fast_detect_kernel_matches_plain(cuda, dtype, shape):
    img = _textured(*shape)
    if dtype == "uint8":
        x = torch.from_numpy(img.astype(np.uint8))
    elif dtype == "float32":
        x = torch.from_numpy(np.round(img))
    else:
        x = torch.from_numpy(img)  # non-integral values: the f32 path
    x = x.to(cuda)
    before = cuda_fast.fast_detect.launches
    det_k, raw_k = cuda_fast.fast_detect(x, 20.0, margin=19)
    det_p, raw_p = cuda_fast.fast_detect_plain(x, 20.0, margin=19)
    torch.cuda.synchronize()
    assert cuda_fast.fast_detect.launches == before + 1
    assert torch.equal(det_k, det_p)
    assert torch.equal(raw_k, raw_p)  # same zero taps everywhere


@pytest.mark.parametrize("threshold", [0.0, 20.0, 254.0, 20.5, -3.0])
@pytest.mark.parametrize("margin", [4, 19])
def test_fast_detect_kernel_on_plateaus_and_saturation(cuda, threshold, margin):
    """Constant plateaus (the >= tie rule of the NMS), saturated 0/255
    pixels, thresholds at both ends, and a non-integral or negative
    threshold on uint8 (which the wrapper sends down the float32 route)."""
    rng = np.random.default_rng(3)
    img = (rng.integers(0, 2, size=(2, 61, 131)) * 255).astype(np.uint8)
    img[:, 10:40, 20:90] = 200  # a plateau: equal scores along its rim
    img[:, 18:22, 30:34] = 90
    img[:, 45:, :] = 0  # a black band meets the saturated noise
    for x in (torch.from_numpy(img).to(cuda), torch.from_numpy(img.astype(np.float32)).to(cuda)):
        before = cuda_fast.fast_detect.launches
        det_k, raw_k = cuda_fast.fast_detect(x, threshold, margin=margin)
        det_p, raw_p = cuda_fast.fast_detect_plain(x, threshold, margin=margin)
        torch.cuda.synchronize()
        assert cuda_fast.fast_detect.launches == before + 1
        assert torch.equal(raw_k, raw_p) and torch.equal(det_k, det_p)
        assert threshold != 20.0 or (det_p > 0).sum() > 0


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 37, 2048])
def test_extract_patches_kernel_matches_plain(cuda, out_dtype, n):
    b, h, w = 3, 70, 101
    image = torch.from_numpy(_textured(b, h, w)).to(cuda)
    rng = np.random.default_rng(n)
    xy = rng.uniform(-20, [w + 20, h + 20], size=(b, n, 2)).astype(np.float32)
    xy[:, : n // 2] = np.round(xy[:, : n // 2]) + 0.5  # round half to even
    xy = torch.from_numpy(xy).to(cuda)
    before = cuda_patches.extract_patches.launches
    got = cuda_patches.extract_patches(image, xy, out_dtype=out_dtype)
    ref = cuda_patches.extract_patches_plain(image, xy, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert cuda_patches.extract_patches.launches == before + 1
    bits = torch.int16 if out_dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), ref.view(bits))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    with pytest.raises(ValueError):
        cuda_fast.fast_detect(torch.zeros((40, 40), device=cuda), 20.0, margin=19)
    with pytest.raises(ValueError):
        cuda_fast.fast_detect(torch.zeros((1, 40, 40), device=cuda), 20.0, margin=2)
    image = torch.zeros((1, 40, 40), device=cuda)
    with pytest.raises(ValueError):
        cuda_patches.extract_patches(image.double(), torch.zeros((1, 4, 2), device=cuda))
    with pytest.raises(ValueError):
        cuda_patches.extract_patches(image, torch.zeros((1, 4, 2)))  # xy on the CPU
    with pytest.raises(ValueError):
        cuda_patches.extract_patches(image, torch.zeros((1, 4, 2), device=cuda), out_dtype=torch.float16)


@pytest.mark.parametrize("shape", [(128, 160), (130, 170)])
def test_lk_track_with_kernel_matches_plain(cuda, shape):
    """LK on the card: every window from K2 (30 launches for 3 levels of 8
    iterations), bit-equal to LK with K2's plain version."""
    from unittest import mock

    from mvslam_tpu_torch.ops import lk

    h, w = shape
    prev = torch.from_numpy(_textured(1, h, w)[0]).to(cuda)
    nxt = torch.roll(prev, shifts=(2, -3), dims=(0, 1))
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform(-10, [w + 10, h + 10], size=(300, 2)).astype(np.float32)).to(cuda)
    mask = torch.ones(300, dtype=torch.bool, device=cuda)
    before = cuda_patches.extract_patches.launches
    got = lk.lk_track(prev, nxt, pts, mask)
    assert cuda_patches.extract_patches.launches == before + 3 * (8 + 2)
    with mock.patch.object(cuda_patches, "extract_patches", cuda_patches.extract_patches_plain):
        ref = lk.lk_track(prev, nxt, pts, mask)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert got[2].sum() > 50


def test_slam_system_on_the_card_launches_both_kernels(cuda, tmp_path):
    from mvslam_tpu_torch.data.synthetic import render_scene
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
    from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
    from mvslam_tpu_torch.slam.api import SLAMSystem, SLAMSystemConfig

    frames, _, (fx, fy, cx, cy), _ = render_scene(num_frames=6, h=240, w=320, seed=1)
    cfg = SLAMSystemConfig(
        output_root=tmp_path, fx=fx, fy=fy, cx=cx, cy=cy, pose_source="flow_first",
        feature=FeaturePipelineConfig(num_features=256, max_matches=128),
        pose=RobustPoseEstimatorConfig(num_hypotheses=128),
        enable_local_ba=False, enable_relocalization=False, persist_map_snapshot=False,
    )
    k1, k2 = cuda_fast.fast_detect.launches, cuda_patches.extract_patches.launches
    diags = SLAMSystem(cfg, device=cuda).run_sequence(frames, window=1)
    assert sum(d.pose_success for d in diags) >= 5
    assert cuda_fast.fast_detect.launches - k1 == 6
    assert cuda_patches.extract_patches.launches - k2 >= 6 + 5 * 30


def _ba_problem(W=5, P=120, seed=0, visible=1.0, pose_noise=0.02):
    """A window of W poses 0.5 apart observing P points (0.5 px noise), the
    later poses and the points perturbed: the padded arrays ``_ba_core``
    takes, on the host."""
    from mvslam_tpu_torch.backend import bundle_adjustment as ba
    from mvslam_tpu_torch.geometry import lie_np

    rng = np.random.default_rng(seed)
    K = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]])
    pts = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P), rng.uniform(6, 14, P)], axis=1)
    poses = np.stack([lie_np.se3_matrix(lie_np.so3_exp(np.asarray([0.0, 0.02 * w, 0.0])), np.asarray([0.5 * w, 0, 0]))
                      for w in range(W)])
    obs = []
    for w in range(W):
        T_cw = np.linalg.inv(poses[w])
        cam = pts @ T_cw[:3, :3].T + T_cw[:3, 3]
        uv = cam[:, :2] / cam[:, 2:] * 400.0 + [160, 120] + rng.normal(scale=0.5, size=(P, 2))
        obs += [ba.Observation(w, p, uv[p]) for p in range(P) if rng.random() < visible]
    poses[2:, :3, 3] += rng.normal(scale=pose_noise, size=(W - 2, 3))
    return poses, pts + rng.normal(scale=0.05, size=pts.shape), obs, K


def test_ba_core_on_the_card_matches_the_cpu_and_repeats_bit_for_bit(cuda):
    """``run_bundle_adjustment`` on CUDA tensors against the same call on
    CPU tensors (poses 1e-4, points 2e-3, costs 1e-4 relative: the CPU
    parity tests' tolerances; on this problem the CPU's float32 poses are
    3.5e-6 from a float64 run, where a window of 300 partly seen points
    leaves float32 LM 2e-2 from float64 after 10 iterations and no
    tolerance would mean much), and bit-equal between two card runs (the
    assemblies are segment sums over fixed tables, no atomics)."""
    from mvslam_tpu_torch.backend import bundle_adjustment as ba

    poses, pts, obs, K = _ba_problem()
    cpu = ba.run_bundle_adjustment(poses, pts, obs, K, device="cpu")
    gpu = [ba.run_bundle_adjustment(poses, pts, obs, K, device=cuda) for _ in range(2)]
    assert not gpu[0].diagnostics.conditioning_tripped and not cpu.diagnostics.conditioning_tripped
    np.testing.assert_allclose(gpu[0].poses, cpu.poses, atol=1e-4)
    np.testing.assert_allclose(gpu[0].points, cpu.points, atol=2e-3)
    assert gpu[0].diagnostics.final_cost == pytest.approx(cpu.diagnostics.final_cost, rel=1e-4)
    assert np.array_equal(gpu[0].poses, gpu[1].poses) and np.array_equal(gpu[0].points, gpu[1].points)
    assert gpu[0].diagnostics == gpu[1].diagnostics


def _pose_graph(model, n=60, seed=0):
    from mvslam_tpu_torch.backend import pose_graph as pg

    rng = np.random.default_rng(seed)
    cls, step = {"se2": (pg.PoseGraph, [1.0, 0.0, 0.2]), "se3": (pg.PoseGraph3D, [1.0, 0, 0, 0, 0, 0.1]),
                 "sim3": (pg.PoseGraphSim3D, [1.0, 0, 0, 0, 0, 0.1, 0.01])}[model]
    graph = cls(device="cpu")
    for _ in range(n):
        graph.add_pose(np.asarray(step) + rng.normal(scale=0.02, size=len(step)))
    rel = np.zeros(len(step))
    for _ in range(10):  # the noise-free motion over 10 steps
        rel = pg._HOST_COMPOSE[model](rel, np.asarray(step, float))
    for i in range(0, n - 10, 10):
        graph.add_loop(i, i + 10, rel, weight=2.0)
    return graph._build_graph()


@pytest.mark.parametrize("method", ["cholesky", "cg"])
@pytest.mark.parametrize("model", ["se2", "se3", "sim3"])
def test_gauss_newton_core_on_the_card_matches_the_cpu_and_repeats_bit_for_bit(cuda, model, method):
    """The packed GN core on the card against the same call on the CPU,
    within twice the CPU's float32 distance from a float64 run plus 1e-5
    (a 60-pose chain's dense Cholesky in float32 lands up to 2e-3 from
    float64), and bit-equal between two card runs."""
    from mvslam_tpu_torch.backend.solvers import SolverConfig, gauss_newton_core_packed

    fg = _pose_graph(model)
    config = SolverConfig(max_iterations=15, damping=1e-4, method=method)

    def run(device, dtype=torch.float32):
        p = fg.build_problem(dtype=dtype, device=device)
        return gauss_newton_core_packed(p.x0, p.edges, p.measurements, p.weights, p.anchor_mask, p.model_name,
                                        config).cpu().numpy()

    cpu, cpu64, gpu1, gpu2 = run("cpu"), run("cpu", torch.float64), run(cuda), run(cuda)
    n, d = fg.build_problem(device="cpu").x0.shape
    x = slice(1, 1 + n * d)
    assert np.isfinite(gpu1).all()
    np.testing.assert_allclose(gpu1[x], cpu[x], atol=1e-5 + 2 * np.abs(cpu[x] - cpu64[x]).max())
    assert gpu1[0] == pytest.approx(cpu[0], rel=1e-4, abs=1e-7)
    assert np.array_equal(gpu1, gpu2)


def test_slam_system_with_local_ba_on_the_card(cuda, tmp_path):
    """``SLAMSystem`` at its default BA setting on the card: local BA runs
    on every keyframe window and at least one refinement is accepted."""
    from mvslam_tpu_torch.data.synthetic import render_scene
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
    from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
    from mvslam_tpu_torch.slam.api import SLAMSystem, SLAMSystemConfig

    frames, _, (fx, fy, cx, cy), _ = render_scene(num_frames=8, h=240, w=320, seed=1)
    cfg = SLAMSystemConfig(
        output_root=tmp_path, fx=fx, fy=fy, cx=cx, cy=cy,
        feature=FeaturePipelineConfig(num_features=256, max_matches=128),
        pose=RobustPoseEstimatorConfig(num_hypotheses=128),
        enable_relocalization=False, persist_map_snapshot=False,
    )
    system = SLAMSystem(cfg, device=cuda)
    diags = system.run_sequence(frames, window=4, windows_per_dispatch=2)
    assert sum(d.pose_success for d in diags) >= 7
    events = [e for e in system.telemetry.events() if e.name == "local_ba"]
    assert len(events) == sum(d.is_keyframe for d in diags) - 1 >= 5
    assert system._local_ba.last_diagnostics is not None


def test_argmin_and_stable_topk_tie_order_on_the_card(cuda):
    """``argmin`` takes the first minimum and the stable top-k the lower
    index among equal values, on the card as on the CPU (what JAX does):
    planted ties in a distance matrix and in a score vector."""
    from mvslam_tpu_torch.ops.fast import topk_stable

    rng = np.random.default_rng(0)
    d = rng.integers(0, 50, size=(4096, 64)).astype(np.float32)  # many exact ties per row
    d[:, 40] = d.min(axis=1)
    d[:, 7] = d.min(axis=1)
    dt = torch.from_numpy(d)
    assert torch.equal(torch.argmin(dt.to(cuda), dim=1).cpu(), torch.argmin(dt, dim=1))
    assert np.array_equal(torch.argmin(dt.to(cuda), dim=1).cpu().numpy(), d.argmin(axis=1))
    s = rng.integers(0, 200, size=50_000).astype(np.float32)
    values, idx = topk_stable(torch.from_numpy(s).to(cuda), 64)
    order = np.lexsort((np.arange(len(s)), -s))[:64]
    assert np.array_equal(idx.cpu().numpy(), order) and np.array_equal(values.cpu().numpy(), s[order])


def _descriptors(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(n, 8), dtype=np.uint64).astype(np.uint32)


def test_bow_on_the_card_matches_the_cpu_and_repeats_bit_for_bit(cuda):
    """``_lloyd`` and ``assign_histogram`` on the card: two runs bit-equal
    (one-hot products, no atomics), and equal to the CPU's but for
    descriptors whose two best distances nearly tie (histograms within
    cosine 0.999)."""
    from mvslam_tpu_torch.core import prng
    from mvslam_tpu_torch.loopclosure import bow

    desc = _descriptors(4000)
    v1 = bow.train_vocabulary(desc, prng.key(5), vocab_size=64, iterations=15, device=cuda)
    v2 = bow.train_vocabulary(desc, prng.key(5), vocab_size=64, iterations=15, device=cuda)
    assert np.array_equal(v1, v2) and np.isfinite(v1).all()
    cpu = bow.train_vocabulary(desc, prng.key(5), vocab_size=64, iterations=15, device="cpu")
    valid = np.ones(500, bool)
    for start in range(0, 4000, 500):
        h1 = bow.compute_bow_histogram(desc[start : start + 500], valid, v1, device=cuda)
        h2 = bow.compute_bow_histogram(desc[start : start + 500], valid, v1, device=cuda)
        assert np.array_equal(h1, h2) and abs(np.linalg.norm(h1) - 1.0) < 1e-6
        assert float(h1 @ bow.compute_bow_histogram(desc[start : start + 500], valid, cpu, device="cpu")) >= 0.999
    dots = bow._bf16_dots(torch.rand(64, 256, device=cuda), torch.rand(32, 256, device=cuda))
    assert dots.dtype == torch.float32


def test_device_index_on_the_card_equals_the_host_ranking(cuda):
    """The index phase's checks at a small size: top-k ids equal the host's
    (-score, frame id) order with planted exact ties, a grown index equals
    a bulk load, out-of-order ids raise."""
    from mvslam_tpu_torch.loopclosure.device_index import DeviceBoWIndex

    rng = np.random.default_rng(1)
    hist = rng.gamma(0.15, size=(3000, 64)).astype(np.float32)
    hist[2000] = hist[5]
    hist[17] = hist[16]
    hist /= np.linalg.norm(hist, axis=1, keepdims=True)
    ids = list(range(0, 6000, 2))
    bulk = DeviceBoWIndex.from_histograms(ids, hist, device=cuda)
    grown = DeviceBoWIndex(64, 8, device=cuda)
    for i, row in zip(ids, hist):
        grown.add(i, row)
    assert grown.capacity == 4096 and bulk._buf.device.type == "cuda"
    for q in (hist[5], hist[16], hist[77], (lambda v: v / np.linalg.norm(v))(rng.gamma(0.15, size=64).astype(np.float32))):
        scores = hist.astype(np.float64) @ q.astype(np.float64)
        order = np.lexsort((np.arange(3000), -scores))
        got = [i // 2 for i, _ in bulk.topk(q, k=16)]
        clear = np.abs(np.diff(scores[order[:17]])) > 1e-6
        for pos in range(16):
            if got[pos] != order[pos]:
                assert not clear[max(pos - 1, 0)] or not clear[pos], (pos, got, order[:16])
                assert scores[got[pos]] != scores[order[pos]]
        assert [i for i, _ in grown.topk(q, k=16)] == [i for i, _ in bulk.topk(q, k=16)]
        np.testing.assert_allclose(bulk.scores(q), scores, atol=1e-5)
    assert [i // 2 for i, _ in bulk.topk(hist[5], k=2)] == [5, 2000]
    assert [i // 2 for i, _ in bulk.topk(hist[16], k=2)] == [16, 17]
    with pytest.raises(ValueError, match="strictly increasing"):
        grown.add(10, hist[0])


def test_default_configuration_relocalizes_on_the_card(cuda, tmp_path):
    """``SLAMSystem`` with nothing switched off, on the card: an injected
    loss relocalizes against the snapshot built on demand, and the
    snapshot is persisted and reloads."""
    from mvslam_tpu_torch.backend.keyframes import KeyframeConfig
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
    from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
    from mvslam_tpu_torch.loopclosure.persistent_map import load_map_snapshot
    from mvslam_tpu_torch.slam.api import SLAMSystem, SLAMSystemConfig

    rng = np.random.default_rng(21)
    base = rng.uniform(0, 30, size=(128, 192 + 5 * 8)).astype(np.float32)
    for _ in range(120):
        y, x, s = rng.integers(25, 98), rng.integers(25, base.shape[1] - 30), rng.integers(3, 8)
        base[y : y + s, x : x + s] = rng.uniform(140, 255)
    frames = [base[:, i * 5 : i * 5 + 192].copy() for i in range(8)]
    cfg = SLAMSystemConfig(
        output_root=tmp_path, seed=7, fx=120.0, fy=120.0, cx=96.0, cy=64.0,
        feature=FeaturePipelineConfig(num_features=256, max_matches=128),
        pose=RobustPoseEstimatorConfig(num_hypotheses=128),
        keyframe=KeyframeConfig(min_translation=0.01), relocalization_min_inliers=15,
    )
    system = SLAMSystem(cfg, device=cuda)
    system.inject_tracking_loss(6)
    diags = system.run_sequence(frames, window=1)
    assert diags[6].injected_loss and diags[6].relocalized
    result = system.finalize_run()
    assert result.num_relocalizations >= 1 and result.map_snapshot_paths is not None
    snapshot = load_map_snapshot(result.map_snapshot_paths["arrays"], result.map_snapshot_paths["metadata"])
    assert len(snapshot.keyframes) == 6


def test_loop_geometry_on_the_card_matches_the_cpu(cuda):
    """The offline pipeline's loop stage at full width, on the same
    keyframes on the card and on the CPU: a loop pair two steps short of an
    exact revisit (a real baseline), the exact revisit (zero baseline, which
    leaves the translation undetermined) and the chain neighbour. Match
    counts and slots are equal; inliers within the vote tolerance of
    near-tied hypotheses; R within 0.1 degrees, and unit t within 1e-3 on
    the pair with a baseline when both count the same inliers; the verdict
    of ``_verify_loop`` is the same and so is its edge's rotation."""
    from pathlib import Path
    from types import SimpleNamespace

    from mvslam_tpu_torch.backend.keyframes import Keyframe
    from mvslam_tpu_torch.core.determinism import DeterminismRegistry
    from mvslam_tpu_torch.data.synthetic import render_scene
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
    from mvslam_tpu_torch.slam import offline
    from mvslam_tpu_torch.slam.tracking import bootstrap_frame

    places = {4: 1.0, 5: 1.25, 22: 1.5, 24: 1.0}  # frame id -> x of an out-and-back drive, 0.25 per frame
    ids = sorted(places)
    frames, _, (fx, fy, cx, cy), poses = render_scene(
        num_frames=len(ids), h=370, w=1226, seed=2, n_pts=400, noise=6.0,
        traj_fn=lambda i: (np.eye(3), np.array([places[ids[i]], 0.0, 0.0])),
    )
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    kfs = {}
    for frame, pose, i in zip(frames, poses, ids):
        fs = bootstrap_frame(torch.from_numpy(frame).to(cuda), FeaturePipelineConfig())
        kfs[i] = Keyframe(frame_id=i, timestamp=0.1 * i, pose=pose.copy(), keypoints=fs.xy.cpu().numpy(),
                          descriptors=fs.descriptors.cpu().numpy().view(np.uint32), valid=fs.valid.cpu().numpy())
    systems = {
        name: SimpleNamespace(K=K, registry=DeterminismRegistry(seed=3), device=torch.device(dev), telemetry=None)
        for name, dev in (("card", cuda), ("cpu", "cpu"))
    }
    config = offline.SLAMRunConfig(input_path=Path("."), seed=3, loop_min_inliers=25)

    def angle(Ra, Rb):
        return float(np.degrees(np.arccos(np.clip((np.trace(Ra.T @ Rb) - 1) / 2, -1, 1))))

    for query in (22, 24):
        salts = [query, 4 * 2 + 1]
        rows = {name: offline._loop_geometry(s, kfs[4], [kfs[query], kfs[5]], salts) for name, s in systems.items()}
        assert np.array_equal(offline._loop_geometry(systems["card"], kfs[4], [kfs[query], kfs[5]], salts), rows["card"])
        for row, ref_row in zip(rows["card"], rows["cpu"]):
            a, b = offline._unpack_loop_row(row), offline._unpack_loop_row(ref_row)
            assert a["num_valid"] == b["num_valid"] >= 100 and np.array_equal(a["idx_a"], b["idx_a"])
            assert abs(a["num_inliers"] - b["num_inliers"]) <= max(3, 0.1 * b["num_inliers"])
        a, b = offline._unpack_loop_row(rows["card"][0]), offline._unpack_loop_row(rows["cpu"][0])
        assert angle(a["R"], b["R"]) < 0.1
        if query == 22 and a["num_inliers"] == b["num_inliers"]:
            assert np.abs(a["t"] - b["t"]).max() < 1e-3
        verdicts = {name: offline._verify_loop(s, kfs[4], kfs[query], config, kf_a_next=kfs[5]) for name, s in systems.items()}
        assert (verdicts["card"] is None) == (verdicts["cpu"] is None)
        if verdicts["card"] is not None:
            assert angle(verdicts["card"][0][:3, :3], verdicts["cpu"][0][:3, :3]) < 0.1
            assert angle(verdicts["card"][0][:3, :3], np.eye(3)) < 0.5  # the drive does not turn


def test_feature_pipeline_batch_on_the_card_equals_the_cpu(cuda):
    """``FeaturePipeline.detect_and_describe_batch`` at (4, 370, 1226) uint8:
    one launch of each kernel, keypoints, scores, validity and descriptor
    words bit-equal to the same call on the CPU (plain versions), and each
    frame of the batch bit-equal to that frame extracted alone."""
    from mvslam_tpu_torch.data.bench_frames import make_frames
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipeline, FeaturePipelineConfig

    frames = np.stack([f.astype(np.uint8) for f in make_frames(4)])
    cfg = FeaturePipelineConfig()
    card = FeaturePipeline(cfg, device=cuda)
    k1, k2 = cuda_fast.fast_detect.launches, cuda_patches.extract_patches.launches
    got = card.detect_and_describe_batch(frames)
    torch.cuda.synchronize()
    assert (cuda_fast.fast_detect.launches - k1, cuda_patches.extract_patches.launches - k2) == (1, 1)
    ref = FeaturePipeline(cfg, device="cpu").detect_and_describe_batch(frames)
    for name in ("xy", "scores", "valid", "descriptors"):
        assert torch.equal(getattr(got, name).cpu(), getattr(ref, name)), name
    torch.testing.assert_close(got.angles.cpu(), ref.angles, rtol=0, atol=1e-5)
    assert int(got.valid.sum()) > 4 * 1500
    alone = card.detect_and_describe(frames[2])
    for a, b in zip(alone, got):
        assert torch.equal(a, b[2])


def test_pose_estimator_on_the_card_matches_the_cpu(cuda):
    """``RobustPoseEstimator.estimate_pose`` at the bench configuration
    (512 hypotheses) on numpy points of consecutive rendered 1226x370
    frames: the default estimator runs on the card, repeats bit for bit,
    and agrees with the same call on the CPU in success, model type,
    inliers within the vote tolerance of near-tied hypotheses and R within
    0.1 degrees; ``adaptive_ransac_threshold`` within 1e-6 relative."""
    from mvslam_tpu_torch.core import prng
    from mvslam_tpu_torch.data.synthetic import render_scene
    from mvslam_tpu_torch.frontend.feature_pipeline import (
        FeaturePipeline,
        FeaturePipelineConfig,
        adaptive_ransac_threshold,
        matches_to_points,
    )
    from mvslam_tpu_torch.frontend.pose_estimator import PoseEstimationFailure, RobustPoseEstimator

    frames, _, (fx, fy, cx, cy), _ = render_scene(num_frames=4, h=370, w=1226, seed=0)
    K = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], np.float32)
    pipeline = FeaturePipeline(FeaturePipelineConfig(num_features=2048, max_matches=512), device=cuda)
    feats = pipeline.detect_and_describe_batch(np.stack(frames))
    card, cpu = RobustPoseEstimator(), RobustPoseEstimator(device="cpu")
    assert card.device.type == "cuda"

    def estimate(est, *args):
        try:
            return est.estimate_pose(*args)
        except PoseEstimationFailure as failure:
            return failure.reason

    def angle(Ra, Rb):
        return float(np.degrees(np.arccos(np.clip((np.trace(Ra.T @ Rb) - 1) / 2, -1, 1))))

    poses = 0
    for i in range(len(frames) - 1):
        a, b = (type(feats)(*(x[j] for x in feats)) for j in (i, i + 1))
        p1, p2, mask = (x.cpu().numpy() for x in matches_to_points(a, b, pipeline.match(a, b)))
        args = (p1, p2, mask, K, prng.key(i))
        got, again, ref = estimate(card, *args), estimate(card, *args), estimate(cpu, *args)
        assert type(got) is type(ref), (got, ref)
        if isinstance(got, str):
            assert got == again == ref
            continue
        poses += 1
        assert np.array_equal(got.rotation, again.rotation) and np.array_equal(got.inlier_mask, again.inlier_mask)
        assert got.model_type == ref.model_type
        assert abs(got.num_inliers - ref.num_inliers) <= max(3, 0.1 * ref.num_inliers)
        assert angle(got.rotation, ref.rotation) < 0.1
        assert adaptive_ransac_threshold(1.5, p1, p2, mask) == pytest.approx(
            adaptive_ransac_threshold(1.5, p1, p2, mask, device="cpu"), rel=1e-6
        )
    assert poses >= 2


def test_run_stream_async_on_the_card_equals_process_frame(cuda, tmp_path):
    """``SLAMSystem.run_stream_async`` at the default configurations over
    1 + 12 bench frames: the trajectory and diagnostics bit-equal to the
    same frames through ``process_frame``, nothing dropped, both kernels
    launched at batch 4 on the assembler thread."""
    from mvslam_tpu_torch.data.bench_frames import make_frames
    from mvslam_tpu_torch.runtime.frame_stream import packets_from_arrays
    from mvslam_tpu_torch.slam.api import SLAMSystem, SLAMSystemConfig

    frames = [f.astype(np.uint8) for f in make_frames(13)]
    live = SLAMSystem(SLAMSystemConfig(run_id="async", output_root=tmp_path), device=cuda)
    shapes_before = cuda_fast.fast_detect.launch_shapes[("torch.uint8", 4, 370, 1226)]
    diags = live.run_stream_async(packets_from_arrays(frames))
    assert cuda_fast.fast_detect.launch_shapes[("torch.uint8", 4, 370, 1226)] - shapes_before >= 4
    single = SLAMSystem(SLAMSystemConfig(run_id="single", output_root=tmp_path), device=cuda)
    single_diags = [single.process_frame(f, float(i)) for i, f in enumerate(frames)]
    assert np.array_equal(np.stack(live.trajectory.poses), np.stack(single.trajectory.poses))
    strip = lambda d: {k: v for k, v in d.to_dict().items() if k != "correlation_id"}  # noqa: E731
    assert [strip(d) for d in diags] == [strip(d) for d in single_diags]
    assert sum(d.pose_success for d in diags[1:]) >= 11
    report = live.store.load_report("control_plane_report")
    assert report["snapshots"]["feature"]["failed"] == 0 and report["snapshots"]["tracking"]["dropped"] == 0
    assert not report["events"]


def test_runner_native_ingestion_on_the_card_equals_stream(cuda, tmp_path):
    """The runner's ``native`` mode on the card: the port's C++ library
    builds on the card's host, its frame loader delivers the frames of a
    small KITTI layout in order, and the trajectory and diagnostics equal
    the ``stream`` mode's with the numpy decoder bit for bit."""
    import json

    from mvslam_tpu_torch import native
    from mvslam_tpu_torch.data.bench_frames import make_frames
    from mvslam_tpu_torch.data.synthetic import write_kitti_sequence
    from mvslam_tpu_torch.slam.runner import run_kitti_sequence

    assert native.native_available(), "the native host library did not build"
    frames = [f.astype(np.uint8) for f in make_frames(10)]
    root, _ = write_kitti_sequence(tmp_path / "kitti", frames, np.zeros((10, 3)), (718.856, 718.856, 607.19, 185.22))
    runs = {}
    for mode in ("stream", "native"):
        with pytest.MonkeyPatch.context() as m:
            if mode == "stream":
                m.setenv("MVSLAM_NATIVE_DECODE", "0")  # the numpy decoder: independent of the C++ one
            runs[mode] = run_kitti_sequence(root, run_id=mode, output_root=tmp_path / mode, ingestion=mode, device=cuda)
    traj = {m: np.load(r.trajectory_path)["poses"] for m, r in runs.items()}
    assert traj["native"].shape == (10, 4, 4) and np.array_equal(traj["native"], traj["stream"])
    diags = {m: json.loads((r.run_dir / "diagnostics" / "frame_diagnostics.json").read_text()) for m, r in runs.items()}
    strip = lambda rows: [{k: v for k, v in d.items() if k != "correlation_id"} for d in rows]  # noqa: E731
    assert strip(diags["native"]) == strip(diags["stream"])
    report = json.loads((runs["native"].run_dir / "reports" / "ingestion_report.json").read_text())
    assert report["backend"] == "native" and report["decoded"] == 10 and report["failed"] == 0


def _two_view_samples(k, n, seed=0, outliers=False):
    """k samples of n normalised correspondences of one rigid two-view scene."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, (k, n)), rng.uniform(-1, 1, (k, n)), rng.uniform(4, 10, (k, n))], -1)
    c, s = np.cos(0.03), np.sin(0.03)
    R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    cam2 = pts @ R.T + np.array([0.5, 0.1, 0.05])
    p1, p2 = pts[..., :2] / pts[..., 2:], cam2[..., :2] / cam2[..., 2:]
    if outliers:
        p2[:, : n // 4] += 0.1
    return p1.astype(np.float32), p2.astype(np.float32)


def _pinned_forms():
    from mvslam_tpu_torch.geometry import epipolar as ep
    from mvslam_tpu_torch.geometry import linalg as la
    from mvslam_tpu_torch.geometry import projection as proj

    p1, p2 = _two_view_samples(512, 8)
    q1, q2 = _two_view_samples(6, 1024, seed=1, outliers=True)
    w = (np.random.default_rng(2).uniform(size=q1.shape[:2]) > 0.3).astype(np.float32)
    x1 = np.concatenate([q1, np.ones_like(q1[..., :1])], -1)
    E = ep.eight_point_essential(torch.from_numpy(p1), torch.from_numpy(p2)).numpy()
    gram = ep.essential_rows(torch.from_numpy(p1), torch.from_numpy(p2))
    gram = (gram.transpose(-1, -2) @ gram).numpy()
    return {
        "gram_tree": (lambda a: ep._gram_tree(a), (ep.essential_rows(*map(torch.from_numpy, (q1, q2, w))).numpy(),)),
        "matvec3": (lambda m, x: ep._matvec3(m, x, True), (E[:6], x1)),
        "smallest_eigvec": (lambda g: la.smallest_eigvec_psd(g, pinned=True), (gram,)),
        "eight_point_hypotheses": (lambda a, b: ep.eight_point_essential(a, b, pinned=True), (p1, p2)),
        "eight_point_refit": (lambda a, b, c: ep.eight_point_essential(a, b, c, pinned=True), (q1, q2, w)),
        "dlt_hypotheses": (lambda a, b: ep.dlt_homography(a, b, pinned=True), (p1[:, :4], p2[:, :4])),
        "dlt_refit": (lambda a, b, c: ep.dlt_homography(a, b, c, pinned=True), (q1, q2, w)),
        "sampson_error": (lambda e, a, b: ep.sampson_error(e, a, b, True), (E[:6], q1, q2)),
        "transfer_error": (lambda h, a, b: ep.symmetric_transfer_error(h, a, b, True),
                           (np.broadcast_to(np.eye(3, dtype=np.float32), (6, 3, 3)).copy(), q1, q2)),
        "hartley_weighted": (lambda a, c: proj.hartley_normalization(a, c, pinned=True)[1], (q1, w)),
    }


@pytest.mark.parametrize("name", list(_pinned_forms()))
def test_pinned_forms_on_the_card_equal_their_slices(cuda, name):
    """Each order-pinned form gives a row the same bits in the whole batch
    as in a slice of it, on the card (where ``sum`` and ``matmul`` pick
    their accumulation order by shape and alignment)."""
    fn, args = _pinned_forms()[name]
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in args]
    whole = fn(*args)
    n = args[0].shape[0]
    cuts = sorted({0, 1, n // 3, n - 1, n})
    pieces = torch.cat([fn(*[a[lo:hi] for a in args]) for lo, hi in zip(cuts[:-1], cuts[1:])])
    assert torch.equal(pieces.view(torch.int32), whole.view(torch.int32))


def test_sharded_ransac_on_the_card_bit_equal_across_logical_sizes(cuda):
    """Hypothesis-sharded RANSAC over logical meshes of 1, 2, 4 and 8 slots
    on ``cuda:0``: model and inliers bit-equal to the unsharded call with
    ``mesh_invariant=True``, essential and homography."""
    from mvslam_tpu_torch.core import prng
    from mvslam_tpu_torch.core.sharding import Mesh, NamedSharding
    from mvslam_tpu_torch.ops.ransac import RansacConfig, ransac_essential, ransac_homography
    from mvslam_tpu_torch.parallel import sharded_ransac_essential

    p1, p2 = _two_view_samples(1, 2048, seed=4, outliers=True)
    n1, n2 = torch.from_numpy(p1[0]).to(cuda), torch.from_numpy(p2[0]).to(cuda)
    mask = torch.ones(2048, dtype=torch.bool, device=cuda)
    key = prng.key(0, cuda)
    cfg = RansacConfig(num_hypotheses=512, threshold=2e-3, mesh_invariant=True)
    single = ransac_essential(key, n1, n2, mask, cfg)
    single_h = ransac_homography(key, n1, n2, mask, cfg)
    assert bool(single.success) and int(single.num_inliers) > 1000
    for size in (1, 2, 4, 8):
        mesh = Mesh([cuda] * size, ("data",))
        res = sharded_ransac_essential(mesh, key, n1, n2, mask, cfg)
        assert torch.equal(res.model, single.model) and torch.equal(res.inliers, single.inliers), size
        res_h = ransac_homography(key, n1, n2, mask, cfg, hypothesis_sharding=NamedSharding(mesh, "data"))
        assert torch.equal(res_h.model, single_h.model) and torch.equal(res_h.inliers, single_h.inliers), size


def test_meshed_superwindow_on_the_card_equals_unsharded(cuda):
    """``track_superwindow_meshed`` over 1 + 16 bench frames at (370, 1226)
    on logical meshes of 2 and 4 slots: features, matches, counts and
    ``use_essential`` bit-equal to the unsharded pinned run, poses within
    1e-3; both kernels launched at 8 and 4 frames."""
    from mvslam_tpu_torch.core import prng
    from mvslam_tpu_torch.core.sharding import Mesh
    from mvslam_tpu_torch.data.bench_frames import make_frames
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
    from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
    from mvslam_tpu_torch.parallel import track_superwindow_meshed
    from mvslam_tpu_torch.slam import tracking

    frames = torch.from_numpy(np.stack([f.astype(np.uint8) for f in make_frames(17)])).to(cuda)
    fc = FeaturePipelineConfig(num_features=2048, max_matches=512)
    pc = RobustPoseEstimatorConfig(num_hypotheses=512, mesh_invariant=True)
    K = torch.tensor([[718.856, 0.0, 607.19], [0.0, 718.856, 185.22], [0.0, 0.0, 1.0]], device=cuda)
    key = prng.key(0, cuda)
    prev = tracking.bootstrap_frame(frames[0], fc)
    last_ref, ref = tracking.track_superwindow(key, prev, frames[1:], K, fc, pc, window=16, start_index=1)
    for size in (2, 4):
        k1 = cuda_fast.fast_detect.launches
        last, got = track_superwindow_meshed(Mesh([cuda] * size, ("data",)), key, prev, frames[1:], K, fc, pc,
                                             window=16, start_index=1)
        assert cuda_fast.fast_detect.launches - k1 == size
        for a, b in zip(last, last_ref):
            assert torch.equal(a, b)
        assert torch.equal(got.features_packed.view(torch.int32), ref.features_packed.view(torch.int32))
        assert torch.equal(got.match_mask, ref.match_mask)
        assert torch.equal(got.scalars_packed[..., 12:13], ref.scalars_packed[..., 12:13])
        assert torch.equal(got.scalars_packed[..., 23:25], ref.scalars_packed[..., 23:25])
        assert float((got.scalars_packed[..., :12] - ref.scalars_packed[..., :12]).abs().max()) < 1e-3
