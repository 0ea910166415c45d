"""CUDA kernels K1 and K2 against their plain PyTorch versions, on the card,
alone and inside LK and ``SLAMSystem``; the back end's BA and Gauss-Newton
cores on the card against the same calls on the CPU, and bit-equal between
two card runs.

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
