"""The port's one check on the card. CUDA kernels K1 and K2 against their
plain PyTorch versions at every shape the benchmark's cells and the paths
here launch them at, alone and inside LK and ``SLAMSystem``; the back end's
BA and Gauss-Newton cores on the card against the same calls on the CPU,
and bit-equal between two card runs; window BA's captured graphs against
its eager solve, and a live stream that replays them from its first BA; the bag-of-words stages, the device
index and the native matcher on the card; the live path, the runner's
ingestion modes, flow-first tracking, the offline CLI from PNG files and
the accuracy gate's scenes through the port on the card. Timing is the
benchmark's (``python3 -m portbench.run``), not this file's.

Every test here needs an NVIDIA GPU and nvcc (marker ``cuda``); without a
card they skip. This file imports no JAX, so it also runs on a machine
without it, where the JAX-importing ``conftest.py`` must be left out::

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mvslam_tpu_torch.ops import cuda_fast, cuda_patches

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parents[1]

def _cell_shapes():
    """K1's (B, H, W) and K2's (B, H, W, points) of every cell that
    ``BENCHMARK.json`` declares, read from its configuration and traffic
    files: the camera's size and feature count, at the frames one launch
    takes (the offline traffic's window, the offline CLI's window, the live
    feature plane's batch) and at one frame (the bootstrap)."""
    from mvslam_tpu_torch.runtime.feature_plane import FeatureControlConfig

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    files = {c["name"]: REPO / c["file"] for c in bench["configs"]}
    k1, k2 = set(), set()
    for cell in bench["workloads"]:
        config = json.loads(files[cell["config"]].read_text())
        traffic = json.loads((REPO / "portbench" / "traffic" / f"{cell['traffic']}.json").read_text())
        batch = {  # an entry without a rule here fails collection: give it one
            "offline": lambda: traffic["window"],
            "loops": lambda: config["pipeline"]["run"]["window"],
            "live": lambda: FeatureControlConfig(**traffic.get("feature_control", {})).batch_size,
        }[traffic["entry"]]()
        h, w = config["camera"]["height"], config["camera"]["width"]
        for b in (int(batch), 1):
            k1.add((b, h, w))
            k2.add((b, h, w, config["pipeline"]["feature"]["num_features"]))
    return k1, k2


# The shapes the kernels launch at, K1's (B, H, W) and K2's (B, H, W,
# points): every cell's, and those of the paths in this file: 370x1226 at a
# logical mesh slot's 16, 8, 4, 2 and 1 frames with 2,048 points; the
# accuracy scenes' 240x320 at their window of 8 and one frame, with 2,048
# and 512 points; LK's two lower pyramid levels of 370x1226. The kernel
# tests compare every one with the plain versions, and
# ``_assert_launched_shapes_compared`` holds each path to them.
_CELL_K1, _CELL_K2 = _cell_shapes()
K1_PATH_SHAPES = sorted(_CELL_K1 | {(b, 370, 1226) for b in (16, 8, 4, 2, 1)} | {(8, 240, 320), (1, 240, 320)})
K2_PATH_SHAPES = sorted(
    _CELL_K2 | {(b, 370, 1226, 2048) for b in (16, 8, 4, 2, 1)}
    | {(b, 240, 320, n) for b in (8, 1) for n in (2048, 512)} | {(1, 185, 613, 2048), (1, 92, 306, 2048)}
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda", 0)


def _launch_counts():
    """The kernels' launches so far, by shape."""
    return cuda_fast.fast_detect.launch_shapes.copy(), cuda_patches.extract_patches.launch_shapes.copy()


def _assert_launched_shapes_compared(before):
    """Both kernels launched since ``before`` (``_launch_counts()``), and
    only at shapes the kernel tests compare with the plain versions."""
    k1, k2 = (now - then for now, then in zip(_launch_counts(), before))
    assert k1 and k2, (k1, k2)
    assert {key[1:] for key in k1} <= set(K1_PATH_SHAPES), k1
    assert {key[1:] for key in k2} <= set(K2_PATH_SHAPES), k2


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
        (2, 45, 77), (3, 96, 160),
        # widths no multiple of 4, 8, 16 or the tile, heights no multiple of
        # the tile, images smaller than one tile; B = 1 and 16 (the kernel
        # picks its tile height by the tile count)
        (1, 185, 613), (16, 92, 306), (1, 33, 77), (16, 45, 45), (1, 7, 9), (2, 3, 5),
        *K1_PATH_SHAPES,
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


def _k2_against_plain(image, xy, out_dtype):
    """One K2 launch (none when there is nothing to extract) bit-equal to
    the plain version."""
    b, n = xy.shape[:2]
    before = cuda_patches.extract_patches.launches
    got = cuda_patches.extract_patches(image, xy, out_dtype=out_dtype)
    ref = cuda_patches.extract_patches_plain(image, xy, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert cuda_patches.extract_patches.launches == before + (1 if b * n else 0)
    assert got.shape == ref.shape == (b, n, 1024) and got.dtype == ref.dtype
    bits = torch.int16 if out_dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), ref.view(bits))
    return got


# Three frames of up to 37 keypoints take the kernel's 4-keypoint blocks;
# of 2,048 or 8,453 its 8-keypoint blocks, of which 132 SMs hold at most 8
# each (2,048 threads): 8,453 is past one full wave of its grid.
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 70, 101, n) for n in (0, 1, 7, 9, 37, 2048, 132 * 8 * 8 + 5)] + K2_PATH_SHAPES)
def test_extract_patches_kernel_matches_plain(cuda, out_dtype, shape):
    """Counts that are no multiple of the block's keypoints, none at all,
    and more than the card holds at once, and the paths' shapes; half the
    points on exact .5, the rest spilling 20 px past every border."""
    b, h, w, n = shape
    image = torch.from_numpy(_textured(b, h, w)).to(cuda)
    rng = np.random.default_rng(n)
    xy = rng.uniform(-20, [w + 20, h + 20], size=(b, n, 2)).astype(np.float32)
    xy[:, : n // 2] = np.round(xy[:, : n // 2]) + 0.5  # round half to even
    _k2_against_plain(image, torch.from_numpy(xy).to(cuda), out_dtype)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_extract_patches_kernel_on_the_smallest_image(cuda, out_dtype):
    """W = H = 32: every start clamps to (0, 0), every tile is the image."""
    image = torch.from_numpy(_textured(3, 32, 32, seed=4)).to(cuda)
    xy = torch.from_numpy(np.random.default_rng(4).uniform(-40, 72, size=(3, 9, 2)).astype(np.float32)).to(cuda)
    got = _k2_against_plain(image, xy, out_dtype)
    assert torch.equal(got.float(), image.reshape(3, 1, 1024).expand(3, 9, 1024).to(out_dtype).float())


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_extract_patches_kernel_clamps_at_every_border_on_half_pixels(cuda, out_dtype):
    """Starts clamped at all four borders and the corners, and coordinates
    exactly on .5 around each clamp point (round half to even decides
    whether the tile moves)."""
    b, h, w = 2, 70, 101
    image = torch.from_numpy(_textured(b, h, w, seed=5)).to(cuda)
    xs = [-50.0, -0.5, 0.0, 0.5, 14.5, 15.5, 16.5, 50.5, w - 17.5, w - 16.5, w - 15.5, w - 0.5, w + 20.0]
    ys = [-30.0, -0.5, 0.5, 14.5, 15.5, 16.5, 35.5, h - 17.5, h - 16.5, h - 15.5, h - 0.5, h + 9.0]
    grid = np.array([(x, y) for x in xs for y in ys], dtype=np.float32)
    xy = torch.from_numpy(np.stack([grid, grid[::-1]])).to(cuda)
    _k2_against_plain(image, xy, out_dtype)


def test_extract_patches_kernel_rounds_bf16_ties_to_even(cuda):
    """float32 pixels exactly halfway between two bf16 values (low 16 bits
    0x8000) narrow to the even one, as the plain version's cast does."""
    rng = np.random.default_rng(6)
    high = rng.integers(0x3C00, 0x4380, size=(1, 40, 48), dtype=np.uint32)  # positive normal values
    high[..., ::2] |= 1  # odd upper halves round up, even ones down
    image = torch.from_numpy(((high << 16) | 0x8000).view(np.float32)).to(cuda)
    xy = torch.from_numpy(rng.uniform(0, [48, 40], size=(1, 64, 2)).astype(np.float32)).to(cuda)
    got = _k2_against_plain(image, xy, torch.bfloat16)
    tiles = cuda_patches.extract_patches_plain(image, xy).view(torch.int32).cpu().numpy().view(np.uint32)
    upper = tiles >> 16
    even = (upper + (upper & 1)).astype(np.uint16)
    assert np.array_equal(got.view(torch.int16).cpu().numpy().view(np.uint16), even)


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


def test_flow_first_on_the_card_over_a_full_width_drive(cuda, tmp_path):
    """``pose_source="flow_first"`` frame by frame over 1 + 32 rendered
    1226x370 frames (400 quads, the camera sliding 0.1 along x and 0.02
    along z a frame) at 2,048 features, 512 matches and 512 hypotheses: at
    least 30 frames posed by flow, LK's 30 K2 launches a frame at its three
    pyramid levels, and every launch at a shape the kernel tests compare."""
    from mvslam_tpu_torch.data.synthetic import render_scene
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
    from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
    from mvslam_tpu_torch.slam.api import SLAMSystem, SLAMSystemConfig

    frames, _, (fx, fy, cx, cy), _ = render_scene(num_frames=33, h=370, w=1226, seed=0, n_pts=400,
                                                  traj_fn=lambda i: (np.eye(3), np.array([0.1, 0.0, 0.02]) * i))
    cfg = SLAMSystemConfig(
        output_root=tmp_path, fx=fx, fy=fy, cx=cx, cy=cy, pose_source="flow_first",
        feature=FeaturePipelineConfig(num_features=2048, max_matches=512),
        pose=RobustPoseEstimatorConfig(num_hypotheses=512),
        enable_local_ba=False, enable_relocalization=False, persist_map_snapshot=False,
    )
    k2, before = cuda_patches.extract_patches.launches, _launch_counts()
    diags = SLAMSystem(cfg, device=cuda).run_sequence(frames, window=1)
    tracked = diags[1:]
    assert sum(d.pose_success and (d.model_type or "").startswith("flow_") for d in tracked) >= 30, [
        d.model_type for d in tracked
    ]
    assert cuda_patches.extract_patches.launches - k2 >= len(frames) + 30 * len(tracked)
    _assert_launched_shapes_compared(before)


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


def _lap_graph(num_poses=1000, laps=10, seed=0):
    """An SE3 graph of ``num_poses`` poses driven ``laps`` times around a
    20-unit circle (a slight climb per lap): the chain composed from noisy
    odometry, and a loop edge (weight 5) from the first pose to each later
    lap's start and to the last pose. Returns the graph (on the CPU) and the
    true poses."""
    from mvslam_tpu_torch.backend.pose_graph import PoseGraph3D
    from mvslam_tpu_torch.geometry import lie_np

    rng = np.random.default_rng(seed)
    per_lap = num_poses // laps
    truth = []
    for i in range(num_poses):
        a = 2 * np.pi * i / per_lap
        truth.append(lie_np.se3_matrix(lie_np.so3_exp(np.asarray([0.0, 0.0, a + np.pi / 2])),
                                       np.asarray([20.0 * np.cos(a), 20.0 * np.sin(a), 0.05 * i / per_lap])))
    chain = [truth[0]]
    for a, b in zip(truth[:-1], truth[1:]):
        delta = lie_np.se3_matrix_to_params(np.linalg.inv(a) @ b)
        delta = delta + np.concatenate([rng.normal(scale=0.02, size=3), rng.normal(scale=0.002, size=3)])
        chain.append(chain[-1] @ lie_np.se3_params_to_matrix(delta))
    graph = PoseGraph3D.from_pose_matrices(np.stack(chain), device="cpu")
    for j in [k * per_lap for k in range(1, laps)] + [num_poses - 1]:
        graph.add_loop_matrix(0, j, np.linalg.inv(truth[0]) @ truth[j], weight=5.0)
    return graph, np.stack(truth)


@pytest.mark.parametrize("method", ["cholesky", "cg"])
@pytest.mark.parametrize("model", ["se2", "se3", "sim3", "se3_1000"])
def test_gauss_newton_core_on_the_card_matches_the_cpu_and_repeats_bit_for_bit(cuda, model, method):
    """The packed GN core on the card against the same call on the CPU,
    within twice the CPU's float32 distance from a float64 run plus 1e-5
    (a 60-pose chain's dense Cholesky in float32 lands up to 2e-3 from
    float64), and bit-equal between two card runs: 60-pose chains of each
    model, and ``_lap_graph``'s 1,000 SE3 poses (a dense 6,000 x 6,000
    system, the size of the loop cell's whole-map solves). The final cost
    within 1e-4 relative; at 1,000 poses, where the CPU's float32 cost by
    Cholesky lies 7.6e-4 relative from float64's, within that distance
    twice over as well."""
    from mvslam_tpu_torch.backend.solvers import SolverConfig, gauss_newton_core_packed

    fg = _lap_graph()[0]._build_graph() if model == "se3_1000" else _pose_graph(model)
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
    cost_tol = 2 * abs(float(cpu[0]) - float(cpu64[0])) if model == "se3_1000" else 0.0
    assert gpu1[0] == pytest.approx(cpu[0], rel=1e-4, abs=1e-7 + cost_tol)
    assert np.array_equal(gpu1, gpu2)


def test_slam_system_with_local_ba_on_the_card(cuda, tmp_path):
    """``SLAMSystem`` at its default BA setting on the card: local BA runs
    on every keyframe window, at least one refinement is accepted (the
    trajectory is not the one a run with BA off gives), and a second run
    gives the same trajectory bit for bit."""
    from mvslam_tpu_torch.data.synthetic import render_scene
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
    from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
    from mvslam_tpu_torch.slam.api import SLAMSystem, SLAMSystemConfig

    frames, _, (fx, fy, cx, cy), _ = render_scene(num_frames=8, h=240, w=320, seed=1)

    def run(run_id, local_ba=True):
        cfg = SLAMSystemConfig(
            run_id=run_id, output_root=tmp_path, fx=fx, fy=fy, cx=cx, cy=cy,
            feature=FeaturePipelineConfig(num_features=256, max_matches=128),
            pose=RobustPoseEstimatorConfig(num_hypotheses=128),
            enable_local_ba=local_ba, enable_relocalization=False, persist_map_snapshot=False,
        )
        system = SLAMSystem(cfg, device=cuda)
        diags = system.run_sequence(frames, window=4, windows_per_dispatch=2)
        return system, diags, np.stack(system.trajectory.poses)

    system, diags, poses = run("ba")
    assert sum(d.pose_success for d in diags) >= 7
    events = [e for e in system.telemetry.events() if e.name == "local_ba"]
    assert len(events) == sum(d.is_keyframe for d in diags) - 1 >= 5
    assert system._local_ba.last_diagnostics is not None
    assert np.array_equal(run("ba_again")[2], poses)
    assert not np.array_equal(run("no_ba", local_ba=False)[2], poses)


@pytest.fixture(scope="module")
def bench_keyframes(tmp_path_factory):
    """The keyframes of ``SLAMSystem`` on the card over 1 + 8 bench frames
    at the default configuration with window BA off (every posed frame is
    a keyframe), and a window adjuster with the system's intrinsics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    from mvslam_tpu_torch.backend.bundle_adjustment import WindowBundleAdjuster
    from mvslam_tpu_torch.data.bench_frames import make_frames
    from mvslam_tpu_torch.slam.api import SLAMSystem, SLAMSystemConfig

    cfg = SLAMSystemConfig(run_id="keyframes", output_root=tmp_path_factory.mktemp("keyframes"),
                           enable_local_ba=False, enable_relocalization=False, persist_map_snapshot=False)
    system = SLAMSystem(cfg, device="cuda")
    for i, frame in enumerate(make_frames(9)):
        system.process_frame(frame.astype(np.uint8), float(i))
    assert len(system.keyframes) >= 7
    return system.keyframes.keyframes, WindowBundleAdjuster(system.K, device="cuda")


@pytest.mark.parametrize("num_poses", [2, 3, 4, 5])
def test_ba_graph_replay_equals_the_eager_solve(cuda, bench_keyframes, monkeypatch, num_poses):
    """Window BA over the first and the last window of ``num_poses`` bench
    keyframes, each pair gated and chained by the adjuster on the card: a
    fresh graph cache captures once, at the window's fixed shapes
    (``window_shapes``), and every call replays, bit-equal to the eager
    solve at the same shapes, which a cache with captures closed and no
    entry falls back to: the packed solve (costs, conditioning, refined
    poses and points, finite) before the gates, and the result after them.
    Spans: one ``ba_graph_capture`` with the fixed shapes, a
    ``ba_graph_replay`` per replayed call, none for the eager solves."""
    from mvslam_tpu_torch.backend import bundle_adjustment as ba
    from mvslam_tpu_torch.core import prng
    from mvslam_tpu_torch.core.telemetry import RunTelemetryRecorder

    keyframes, adjuster = bench_keyframes
    key = prng.key(0, cuda)
    graphs, closed = ba.BAGraphs(), ba.BAGraphs()
    recorder = RunTelemetryRecorder()
    packs = []
    with_conditioning = ba._with_conditioning
    monkeypatch.setattr(ba, "_with_conditioning", lambda *a: packs.append(with_conditioning(*a).cpu()) or packs[-1])
    for start in (0, len(keyframes) - num_poses):
        window = keyframes[start : start + num_poses]
        poses = np.stack([kf.pose for kf in window])
        gated = [adjuster._gate_pair(key, a, b) for a, b in zip(window[:-1], window[1:])]
        points, obs = adjuster._observations(window, poses, gated)
        monkeypatch.setattr(ba, "BA_GRAPHS", graphs)
        replayed = [ba.run_bundle_adjustment(poses, np.stack(points), obs, adjuster.K, device=cuda, recorder=recorder)
                    for _ in range(2)]
        monkeypatch.setattr(ba, "BA_GRAPHS", closed)
        with closed.captures_closed():
            eager = ba.run_bundle_adjustment(poses, np.stack(points), obs, adjuster.K, device=cuda, recorder=recorder)
        *graph_packs, eager_pack = packs[-3:]
        assert torch.isfinite(eager_pack).all(), start
        for got, pack in zip(replayed, graph_packs):
            assert torch.equal(pack.view(torch.int32), eager_pack.view(torch.int32)), start
            assert np.array_equal(got.poses, eager.poses) and np.array_equal(got.points, eager.points), start
            assert got.diagnostics == eager.diagnostics, start
    assert len(packs) == 6
    assert len(graphs.entries(cuda)) == 1 and not closed.entries(cuda)
    events = recorder.events()
    captures = [e for e in events if e.name == "ba_graph_capture"]
    assert len(captures) == 1
    budget, pbudget, widths = ba.window_shapes(num_poses, [], [], 0)
    assert captures[0].metadata["inputs"][1] == [[pbudget, 3], "float32"]
    assert captures[0].metadata["inputs"][2] == [[budget], "int64"]
    assert captures[0].metadata["inputs"][7] == [[num_poses, widths[0]], "int64"]
    assert [e.name for e in events].count("ba_graph_replay") == 4


def test_run_stream_async_first_in_its_process_replays_every_ba(cuda, tmp_path):
    """``run_stream_async`` at the default configurations over 1 + 12 bench
    frames as the first work of a fresh process (nothing captured, no
    solver library loaded): its warm-up captures window BA's graph of each
    window length, so every window BA in the stream replays one (as many
    ``ba_graph_replay`` as ``ba_solve`` spans, no capture in the stream)
    and no frame expires or drops waiting for the first solve."""
    import subprocess
    import sys
    import textwrap

    script = textwrap.dedent(
        """
        import json, sys
        import numpy as np
        from mvslam_tpu_torch.data.bench_frames import make_frames
        from mvslam_tpu_torch.runtime.frame_stream import packets_from_arrays
        from mvslam_tpu_torch.slam.api import SLAMSystem, SLAMSystemConfig

        frames = [f.astype(np.uint8) for f in make_frames(13)]
        live = SLAMSystem(SLAMSystemConfig(run_id="first", output_root=sys.argv[1]), device="cuda")
        diags = live.run_stream_async(packets_from_arrays(frames))
        names = [e.name for e in live.telemetry.events()]
        report = live.store.load_report("control_plane_report")
        print(json.dumps({
            "posed": sum(d.pose_success for d in diags[1:]),
            "frames": len(diags),
            "spans": {n: names.count(n) for n in ("ba_solve", "ba_graph_replay", "ba_graph_capture")},
            "failed": report["snapshots"]["feature"]["failed"],
            "dropped": report["snapshots"]["tracking"]["dropped"],
            "events": report["events"],
        }))
        """
    )
    run = subprocess.run([sys.executable, "-c", script, str(tmp_path)], cwd=REPO, capture_output=True, text=True,
                         timeout=900)
    assert run.returncode == 0, run.stderr[-4000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert got["frames"] == 13 and got["posed"] >= 11, got
    spans = got["spans"]
    assert spans["ba_solve"] >= 8 and spans["ba_graph_replay"] == spans["ba_solve"], got
    assert spans["ba_graph_capture"] == 0, got
    assert got["failed"] == 0 and got["dropped"] == 0 and not got["events"], got


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


def _index_scene(rows, vocab, num_queries, seed=1):
    """``rows`` seeded sparse, L2-normalised histograms over ``vocab`` words
    (a few words carry the mass, as in word histograms) with planted exact
    ties (copies of a row), frame ids 0, 2, 4, ...; the queries are the
    tied rows, row 77 and fresh histograms, ``num_queries`` in all."""
    rng = np.random.default_rng(seed)
    hist = rng.gamma(0.15, size=(rows, vocab)).astype(np.float32)
    planted = [(5, 2000), (16, 17), (rows // 2, rows - 1)]
    for src, dst in planted:
        hist[dst] = hist[src]
    hist /= np.linalg.norm(hist, axis=1, keepdims=True)
    fresh = rng.gamma(0.15, size=(num_queries - len(planted) - 1, vocab))
    queries = [hist[src] for src, _ in planted] + [hist[77]] + list(
        (fresh / np.linalg.norm(fresh, axis=1, keepdims=True)).astype(np.float32))
    return hist, list(range(0, 2 * rows, 2)), planted, queries


def _assert_index_is_the_host_ranking(index, hist, planted, queries, k=16):
    """Each query's top-k against a float64 host ranking by (-score, row):
    every returned score is its row's score within 1e-5, and a row differs
    from the host's at a position only where the host's scores there lie
    within 1e-6 of a neighbour's and are not equal; each planted tie comes
    back lower row first."""
    hist64 = hist.astype(np.float64)
    for q in queries:
        scores = hist64 @ q.astype(np.float64)
        order = np.lexsort((np.arange(len(hist)), -scores))
        top = index.topk(q, k=k)
        got = [i // 2 for i, _ in top]
        assert max(abs(s - scores[r]) for (_, s), r in zip(top, got)) <= 1e-5
        clear = np.abs(np.diff(scores[order[: k + 1]])) > 1e-6
        for pos in range(k):
            if got[pos] != order[pos]:
                assert not clear[max(pos - 1, 0)] or not clear[pos], (pos, got, order[:k])
                assert scores[got[pos]] != scores[order[pos]]
    for (src, dst), q in zip(planted, queries):
        assert [i // 2 for i, _ in index.topk(q, k=2)] == [src, dst]


@pytest.mark.parametrize("rows,vocab", [(3000, 64), (50_000, 256)])
def test_device_index_on_the_card_equals_the_host_ranking(cuda, rows, vocab):
    """Top-k ids equal the host's (-score, frame id) order with planted
    exact ties, scores equal the host's within 1e-5, a grown index answers
    as a bulk load does, out-of-order ids raise: at 3,000 x 64 and at map
    scale, 50,000 histograms of 256 words (51 MB, more than the card's
    L2)."""
    from mvslam_tpu_torch.loopclosure.device_index import DeviceBoWIndex

    hist, ids, planted, queries = _index_scene(rows, vocab, num_queries=100)
    bulk = DeviceBoWIndex.from_histograms(ids, hist, device=cuda)
    grown = DeviceBoWIndex(vocab, 8, device=cuda)
    for i, row in zip(ids, hist):
        grown.add(i, row)
    assert grown.capacity == 1 << (rows - 1).bit_length() and bulk._buf.device.type == "cuda"
    _assert_index_is_the_host_ranking(bulk, hist, planted, queries)
    for q in queries:
        a, b = grown.topk(q, k=16), bulk.topk(q, k=16)
        assert [i for i, _ in a] == [i for i, _ in b] and max(abs(x[1] - y[1]) for x, y in zip(a, b)) <= 1e-6
        np.testing.assert_allclose(bulk.scores(q), hist.astype(np.float64) @ q.astype(np.float64), atol=1e-5)
    with pytest.raises(ValueError, match="strictly increasing"):
        grown.add(10, hist[0])


def test_default_configuration_relocalizes_on_the_card(cuda, tmp_path):
    """``SLAMSystem`` with nothing switched off, on the card: an injected
    loss relocalizes against the snapshot built on demand, the snapshot is
    persisted and reloads, and a second system relocalizes against it."""
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
    # A second system armed with the persisted snapshot relocalizes the
    # same frame against it and builds none of its own.
    second = SLAMSystem(dataclasses.replace(cfg, run_id="reloaded"), device=cuda)
    second.load_map_snapshot(result.map_snapshot_paths["arrays"], result.map_snapshot_paths["metadata"])
    second.inject_tracking_loss(6)
    again = second.run_sequence(frames, window=1)
    assert again[6].relocalized and second.finalize_run().num_relocalizations >= 1
    assert "map_snapshot_build" not in [e.name for e in second.telemetry.events()]


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
    launched at batch 4 on the assembler thread and only at compared
    shapes."""
    from mvslam_tpu_torch.data.bench_frames import make_frames
    from mvslam_tpu_torch.runtime.frame_stream import packets_from_arrays
    from mvslam_tpu_torch.slam.api import SLAMSystem, SLAMSystemConfig

    frames = [f.astype(np.uint8) for f in make_frames(13)]
    # The process_frame run goes first: a process's first window BA takes
    # seconds (the solver's libraries load), which would expire the live
    # run's frames against their 5 s TTL.
    single = SLAMSystem(SLAMSystemConfig(run_id="single", output_root=tmp_path), device=cuda)
    single_diags = [single.process_frame(f, float(i)) for i, f in enumerate(frames)]
    live = SLAMSystem(SLAMSystemConfig(run_id="async", output_root=tmp_path), device=cuda)
    before = _launch_counts()
    diags = live.run_stream_async(packets_from_arrays(frames))
    batch4 = ("torch.uint8", 4, 370, 1226)
    assert cuda_fast.fast_detect.launch_shapes[batch4] - before[0][batch4] >= 4
    _assert_launched_shapes_compared(before)
    assert np.array_equal(np.stack(live.trajectory.poses), np.stack(single.trajectory.poses))
    strip = lambda d: {k: v for k, v in d.to_dict().items() if k != "correlation_id"}  # noqa: E731
    assert [strip(d) for d in diags] == [strip(d) for d in single_diags]
    assert sum(d.pose_success for d in diags[1:]) >= 11
    report = live.store.load_report("control_plane_report")
    assert report["snapshots"]["feature"]["failed"] == 0 and report["snapshots"]["tracking"]["dropped"] == 0
    assert not report["events"]


@pytest.mark.parametrize("mode", ["native", "async"])
def test_runner_ingestion_on_the_card_equals_stream(cuda, tmp_path, mode):
    """The runner's ``native`` mode (the port's C++ library built on the
    card's host, its frame loader) and its ``async`` mode (the decode
    pipeline) on the card over a small KITTI layout of PNG files: the
    trajectory and diagnostics equal the ``stream`` mode's with the numpy
    decoder bit for bit, the ingestion report counts every frame decoded,
    and the kernels launch only at compared shapes."""
    from mvslam_tpu_torch import native
    from mvslam_tpu_torch.data.bench_frames import make_frames
    from mvslam_tpu_torch.data.synthetic import write_kitti_sequence
    from mvslam_tpu_torch.slam.runner import run_kitti_sequence

    if mode == "native":
        assert native.native_available(), "the native host library did not build"
    frames = [f.astype(np.uint8) for f in make_frames(10)]
    root, _ = write_kitti_sequence(tmp_path / "kitti", frames, np.zeros((10, 3)), (718.856, 718.856, 607.19, 185.22))
    runs = {}
    for m in ("stream", mode):
        with pytest.MonkeyPatch.context() as patch:
            if m == "stream":
                patch.setenv("MVSLAM_NATIVE_DECODE", "0")  # the numpy decoder: independent of the C++ one
            before = _launch_counts()
            runs[m] = run_kitti_sequence(root, run_id=m, output_root=tmp_path / m, ingestion=m, device=cuda)
            _assert_launched_shapes_compared(before)
    traj = {m: np.load(r.trajectory_path)["poses"] for m, r in runs.items()}
    assert traj[mode].shape == (10, 4, 4) and np.array_equal(traj[mode], traj["stream"])
    diags = {m: json.loads((r.run_dir / "diagnostics" / "frame_diagnostics.json").read_text()) for m, r in runs.items()}
    strip = lambda rows: [{k: v for k, v in d.items() if k != "correlation_id"} for d in rows]  # noqa: E731
    assert strip(diags[mode]) == strip(diags["stream"])
    report = json.loads((runs[mode].run_dir / "reports" / "ingestion_report.json").read_text())
    assert report["decoded"] == 10 and report["failed"] == 0
    if mode == "native":
        assert set(report) == {"backend", "decoded", "failed", "consumer_wait_s", "worker_wait_s"}
        assert report["backend"] == "native"


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


def _noisy_pairs(n, seeds):
    """Normalised correspondences of one 3-D or planar two-view scene per
    seed (planar on odd seeds): 0.3 px of noise at f = 700, 30% gross
    outliers, 10% of the entries masked out."""
    p1s, p2s, masks = [], [], []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        z = np.full(n, 6.0) if seed % 2 else rng.uniform(4.0, 9.0, n)
        X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), z], -1)
        c, s = np.cos(0.03), np.sin(0.03)
        X2 = X @ np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]).T + np.array([0.4, 0.05, 0.1])
        p1 = X[:, :2] / X[:, 2:] + rng.normal(0.0, 4e-4, (n, 2))
        p2 = X2[:, :2] / X2[:, 2:] + rng.normal(0.0, 4e-4, (n, 2))
        bad = rng.random(n) < 0.3
        p2[bad] += rng.uniform(-0.2, 0.2, (int(bad.sum()), 2))
        p1s.append(p1)
        p2s.append(p2)
        masks.append(rng.random(n) > 0.1)
    return np.stack(p1s).astype(np.float32), np.stack(p2s).astype(np.float32), np.stack(masks)


def test_default_dual_ransac_and_pose_choice_on_the_card_equal_the_cpu(cuda):
    """The default dual-model RANSAC at N = 512 (the bench's 512 E + 256 H
    hypotheses) on four seeded pairs takes the order-pinned forms, which
    are elementwise only: on the card it gives the CPU's inlier masks,
    counts and models bit for bit. The pose estimate's model choice on the
    same pairs is the CPU's too (its H transfer votes are a matmul and a
    sum on both devices, of a few ulps' difference that no vote here
    straddles)."""
    from mvslam_tpu_torch.core import prng
    from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig, estimate_pose_device
    from mvslam_tpu_torch.ops.ransac import RansacConfig, _auto_pinned, ransac_dual_model

    p1, p2, mask = (torch.from_numpy(x) for x in _noisy_pairs(512, range(4)))
    keys = prng.split(prng.fold_in(prng.key(7), torch.arange(4)))  # (4, 2, 2)
    ce, ch = RansacConfig(num_hypotheses=512, threshold=2e-3), RansacConfig(num_hypotheses=256, threshold=3e-3)
    assert _auto_pinned(512, ce, ch)
    cpu = ransac_dual_model(keys[:, 0], keys[:, 1], p1, p2, mask, ce, ch)
    card = ransac_dual_model(*(x.to(cuda) for x in (keys[:, 0], keys[:, 1], p1, p2, mask)), ce, ch)
    for got, ref in ((card.essential, cpu.essential), (card.homography, cpu.homography)):
        assert torch.equal(got.inliers.cpu(), ref.inliers) and torch.equal(got.num_inliers.cpu(), ref.num_inliers)
        assert torch.equal(got.model.cpu(), ref.model)
    K = torch.tensor([[700.0, 0.0, 600.0], [0.0, 700.0, 180.0], [0.0, 0.0, 1.0]])
    px1, px2 = (p @ K[:2, :2].T + K[:2, 2] for p in (p1, p2))
    pc = RobustPoseEstimatorConfig()
    ref = estimate_pose_device(keys[:, 0], px1, px2, mask, K, pc)
    got = estimate_pose_device(*(x.to(cuda) for x in (keys[:, 0], px1, px2, mask, K)), pc)
    assert torch.equal(got.use_essential.cpu(), ref.use_essential)
    assert torch.equal(got.inliers.cpu(), ref.inliers)


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
    on logical meshes of 1, 2, 4 and 8 slots: features, matches, counts and
    ``use_essential`` bit-equal to the unsharded pinned run, poses within
    1e-3, K1 launched once a slot (16, 8, 4 and 2 frames); two runs at 4
    slots bit-equal. The default configuration's unsharded superwindow
    (pinned RANSAC at its 512 matches, the H transfer votes a matvec and a
    sum where the meshed run takes pinned products) equals the meshed run
    at 1 slot in features, matches, model choice, inliers, scores, support
    share and rotation on every frame."""
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
    runs = {}
    for size in (1, 2, 4, 8):
        k1 = cuda_fast.fast_detect.launches
        runs[size] = last, got = track_superwindow_meshed(Mesh([cuda] * size, ("data",)), key, prev, frames[1:], K,
                                                          fc, pc, window=16, start_index=1)
        assert cuda_fast.fast_detect.launches - k1 == size
        for a, b in zip(last, last_ref):
            assert torch.equal(a, b)
        assert torch.equal(got.features_packed.view(torch.int32), ref.features_packed.view(torch.int32))
        assert torch.equal(got.match_mask, ref.match_mask)
        assert torch.equal(got.scalars_packed[..., 12:13], ref.scalars_packed[..., 12:13])
        assert torch.equal(got.scalars_packed[..., 23:25], ref.scalars_packed[..., 23:25])
        assert float((got.scalars_packed[..., :12] - ref.scalars_packed[..., :12]).abs().max()) < 1e-3
    last, again = track_superwindow_meshed(Mesh([cuda] * 4, ("data",)), key, prev, frames[1:], K, fc, pc,
                                           window=16, start_index=1)
    _assert_tracks_equal(again, runs[4][1])
    for a, b in zip(last, runs[4][0]):
        assert torch.equal(a, b)
    _, default = tracking.track_superwindow(key, prev, frames[1:], K, fc, RobustPoseEstimatorConfig(num_hypotheses=512),
                                            window=16, start_index=1)
    meshed = runs[1][1]
    assert torch.equal(default.features_packed.view(torch.int32), meshed.features_packed.view(torch.int32))
    assert torch.equal(default.match_mask, meshed.match_mask)
    for field in ("use_essential", "num_inliers", "inliers", "essential_score", "homography_score",
                  "homography_share", "rotation"):
        assert torch.equal(getattr(default.pose, field), getattr(meshed.pose, field)), field


def test_batched_track_pairs_on_the_card_equal_across_logical_sizes(cuda):
    """``batched_track_pairs`` on 8 consecutive bench-frame pairs at (370,
    1226), 2,048 features, 512 matches and 512 hypotheses, over logical
    meshes of 1, 2, 4 and 8 slots: features, match masks, counts and
    matched points bit-equal to the run at 1 slot, poses within 1e-3, every
    pair matched, and every launch at a compared shape."""
    from mvslam_tpu_torch.core.sharding import Mesh
    from mvslam_tpu_torch.data.bench_frames import make_frames
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
    from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
    from mvslam_tpu_torch.parallel import batched_track_pairs

    frames = torch.from_numpy(np.stack([f.astype(np.uint8) for f in make_frames(9)])).to(cuda)
    fc = FeaturePipelineConfig(num_features=2048, max_matches=512)
    pc = RobustPoseEstimatorConfig(num_hypotheses=512)
    K = torch.tensor([[718.856, 0.0, 607.19], [0.0, 718.856, 185.22], [0.0, 0.0, 1.0]], device=cuda)
    before = _launch_counts()
    runs = {size: batched_track_pairs(Mesh([cuda] * size, ("data",)), frames[:8], frames[1:], K, fc, pc)
            for size in (1, 2, 4, 8)}
    _assert_launched_shapes_compared(before)
    base_feats, base = runs[1]
    for size, (feats, track) in runs.items():
        for a, b in zip(feats, base_feats):
            assert torch.equal(a, b), size
        for name in ("match_mask", "num_matches", "num_features", "matched_p1", "matched_p2"):
            assert torch.equal(getattr(track, name), getattr(base, name)), (size, name)
        assert float((track.scalars_packed[..., :12] - base.scalars_packed[..., :12]).abs().max()) <= 1e-3, size
        assert int((track.num_matches > 0).sum()) == 8, size


def test_sharded_ba_on_the_card_equals_unsharded(cuda):
    """``run_bundle_adjustment_sharded`` on a window of 5 poses and 1,024
    points seen by every pose, over logical meshes of 1, 2 and 4 slots,
    against the unsharded card run: poses within 1e-4, points within 1e-3,
    the final cost within 1e-2 of max(1, cost), the conditioning gate not
    tripped; two runs at 4 slots bit-equal."""
    from mvslam_tpu_torch.backend.bundle_adjustment import BundleAdjustmentConfig, run_bundle_adjustment
    from mvslam_tpu_torch.core.sharding import Mesh
    from mvslam_tpu_torch.parallel import run_bundle_adjustment_sharded

    poses, pts, obs, K = _ba_problem(P=1024)
    config = BundleAdjustmentConfig(max_iterations=10)
    ref = run_bundle_adjustment(poses, pts, obs, K, config, device=cuda)
    assert not ref.diagnostics.conditioning_tripped
    assert ref.diagnostics.final_cost < ref.diagnostics.initial_cost
    for size in (1, 2, 4):
        res = run_bundle_adjustment_sharded(Mesh([cuda] * size, ("data",)), poses, pts, obs, K, config)
        assert not res.diagnostics.conditioning_tripped, size
        np.testing.assert_allclose(res.poses, ref.poses, rtol=0, atol=1e-4)
        np.testing.assert_allclose(res.points, ref.points, rtol=0, atol=1e-3)
        assert res.diagnostics.final_cost == pytest.approx(ref.diagnostics.final_cost, rel=1e-2, abs=1e-2)
    again = run_bundle_adjustment_sharded(Mesh([cuda] * 4, ("data",)), poses, pts, obs, K, config)
    assert np.array_equal(again.poses, res.poses) and np.array_equal(again.points, res.points)


def test_sharded_pose_graph_on_the_card_equals_unsharded(cuda):
    """``_lap_graph``'s 1,000 SE3 poses (a dense 6,000 x 6,000 system), 15
    iterations: the unsharded card solve by Cholesky and by CG is finite
    and lowers the cost and the last pose's position error; by Cholesky,
    ``solve_problem_sharded`` over logical meshes of 1, 2 and 4 slots gives
    x within 1e-3 of it (positions on a 20-unit circle) and the final cost
    within 1e-3 of max(1, cost), and two runs at each size bit-equal."""
    from mvslam_tpu_torch.backend.solvers import SolverConfig, solve_problem
    from mvslam_tpu_torch.core.sharding import Mesh
    from mvslam_tpu_torch.geometry import lie_np
    from mvslam_tpu_torch.parallel import solve_problem_sharded

    graph, truth = _lap_graph()
    problem = graph._build_graph().build_problem(device=cuda)
    before = np.linalg.norm(graph.poses()[-1][:3, 3] - truth[-1][:3, 3])
    for method in ("cg", "cholesky"):
        config = SolverConfig(max_iterations=15, damping=1e-4, method=method)
        ref = solve_problem(problem, config)
        after = np.linalg.norm(lie_np.se3_params_to_matrix(ref.x[-1])[:3, 3] - truth[-1][:3, 3])
        assert np.isfinite(ref.x).all() and ref.final_cost < ref.initial_cost and after < before, method
    for size in (1, 2, 4):
        res, again = (solve_problem_sharded(Mesh([cuda] * size, ("data",)), problem, config) for _ in range(2))
        assert np.isfinite(res.x).all() and np.abs(res.x - ref.x).max() <= 1e-3, size
        assert res.final_cost == pytest.approx(ref.final_cost, rel=1e-3, abs=1e-3), size
        assert np.array_equal(again.x, res.x), size


def test_meshed_index_on_the_card_equals_the_host_ranking(cuda):
    """``DeviceBoWIndex`` over a logical mesh of 4 slots on 50,000
    histograms of 256 words: its top-16 held to the float64 host ranking
    as the unsharded index is; grown by ``add`` from 1,024 rows to 4,096,
    its rows bit-equal to a bulk load's and its answers the bulk load's."""
    from mvslam_tpu_torch.core.sharding import Mesh
    from mvslam_tpu_torch.loopclosure.device_index import DeviceBoWIndex

    hist, ids, planted, queries = _index_scene(50_000, 256, num_queries=100)
    mesh = Mesh([cuda] * 4, ("data",))
    _assert_index_is_the_host_ranking(DeviceBoWIndex.from_histograms(ids, hist, mesh=mesh), hist, planted, queries)
    grown = DeviceBoWIndex(256, 1024, mesh=mesh)
    for i, row in zip(ids[:4096], hist[:4096]):
        grown.add(i, row)
    bulk = DeviceBoWIndex.from_histograms(ids[:4096], hist[:4096], mesh=mesh)
    assert grown.capacity == 4096 and torch.equal(grown._buf, bulk._buf)
    for q in queries:
        a, b = grown.topk(q, k=16), bulk.topk(q, k=16)
        assert [i for i, _ in a] == [i for i, _ in b] and max(abs(x[1] - y[1]) for x, y in zip(a, b)) <= 1e-6


def _pair_inputs(cuda, batch, num_features):
    """``batch`` consecutive bench-frame pairs at (370, 1226): per-pair keys,
    source and target feature sets (views of one detection, as a window's
    are), K, and the feature config with ``num_features`` and 512 matches."""
    from mvslam_tpu_torch.core import prng
    from mvslam_tpu_torch.data.bench_frames import make_frames
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig, FeatureSet
    from mvslam_tpu_torch.slam import tracking

    fc = FeaturePipelineConfig(num_features=num_features, max_matches=512)
    frames = torch.from_numpy(np.stack([f.astype(np.uint8) for f in make_frames(batch + 1)])).to(cuda)
    feats = tracking._detect_describe(frames, fc)
    f1 = FeatureSet(*(a[:-1] for a in feats))
    f2 = FeatureSet(*(a[1:] for a in feats))
    keys = prng.fold_in(prng.key(7, cuda), torch.arange(1, batch + 1, device=cuda))
    K = torch.tensor([[718.856, 0.0, 607.19], [0.0, 718.856, 185.22], [0.0, 0.0, 1.0]], device=cuda)
    return keys, f1, f2, K, fc


def _kitti_pose_config():
    from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig

    path = REPO / "configs" / "pipeline" / "kitti_default.json"
    return RobustPoseEstimatorConfig(**json.loads(path.read_text())["pose"])


def _assert_tracks_equal(got, want):
    from mvslam_tpu_torch.core.graphs import _flatten

    for name, a, b in zip(_leaf_names(want), _flatten(got), _flatten(want)):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(_bits(a), _bits(b)), name


def _bits(x):
    """A tensor's bits, comparable with ``torch.equal`` (``features_packed``
    carries descriptor words in float32 lanes, some of them NaN patterns)."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _leaf_names(track):
    return [f"pose.{f}" for f in track.pose._fields] + list(track._fields[1:])


@pytest.mark.parametrize("cell,batch,num_features", [("kitti.track", 16, 2048), ("tum.live", 1, 1000)])
def test_pair_graph_replay_equals_the_eager_stages(cuda, cell, batch, num_features):
    """At each cell's signature (``kitti.track``: 16 pairs of 2,048
    features, 512 matches, the ``kitti_default`` pose config; ``tum.live``:
    one pair of 1,000): a fresh cache captures, and its replays equal the
    eager stages in every ``TrackResult`` leaf, bit for bit; an earlier
    result stays as it was after later replays with other inputs; a second
    signature captures a second entry; the spans are one
    ``pair_graph_capture`` per capture, with its signature, and one
    ``pair_graph_replay`` per call, each around a ``match.device`` and a
    ``pose.device`` span."""
    from mvslam_tpu_torch.core.telemetry import RunTelemetryRecorder
    from mvslam_tpu_torch.frontend.feature_pipeline import FeatureSet
    from mvslam_tpu_torch.slam import tracking
    from mvslam_tpu_torch.core.graphs import _flatten
    from mvslam_tpu_torch.slam.pair_graphs import PairGraphs

    keys, f1, f2, K, fc = _pair_inputs(cuda, batch, num_features)
    pc = _kitti_pose_config()
    match_args = (tracking._configs(fc)[2], fc.max_matches)
    eager = tracking._pose_stage(keys, f2, K, tracking._match_stage(f1, f2, *match_args), pc)
    graphs = PairGraphs(tracking._match_stage, tracking._pose_stage)
    recorder = RunTelemetryRecorder()
    first = graphs.track(keys, f1, f2, K, match_args, pc, recorder)
    torch.cuda.synchronize()
    _assert_tracks_equal(first, eager)
    kept = [leaf.clone() for leaf in _flatten(first)]

    # Other inputs at the same signature: the pairs in reverse order.
    flip = torch.arange(batch - 1, -1, -1, device=cuda)
    g1, g2 = (FeatureSet(*(a[flip] for a in f)) for f in (f1, f2))
    eager_flipped = tracking._pose_stage(keys[flip], g2, K, tracking._match_stage(g1, g2, *match_args), pc)
    again = graphs.track(keys[flip], g1, g2, K, match_args, pc, recorder)
    torch.cuda.synchronize()
    _assert_tracks_equal(again, eager_flipped)
    for a, b in zip(_flatten(first), kept):
        assert torch.equal(_bits(a), _bits(b))
    assert len(graphs.entries(cuda)) == 1

    # A second signature (other feature count) captures a second entry.
    half = num_features // 2
    h1, h2 = (FeatureSet(*(a[:, :half] if a.ndim > 1 else a for a in f)) for f in (f1, f2))
    eager_half = tracking._pose_stage(keys, h2, K, tracking._match_stage(h1, h2, *match_args), pc)
    _assert_tracks_equal(graphs.track(keys, h1, h2, K, match_args, pc, recorder), eager_half)
    assert len(graphs.entries(cuda)) == 2

    events = recorder.events()
    captures = [e for e in events if e.name == "pair_graph_capture"]
    replays = [e for e in events if e.name == "pair_graph_replay"]
    assert len(captures) == 2 and len(replays) == 3
    assert captures[0].metadata["inputs"][0] == [[batch, 2], "int64"]
    assert captures[0].metadata["inputs"][1] == [[batch, num_features, 2], "float32"]
    assert captures[1].metadata["inputs"][1] == [[batch, half, 2], "float32"]
    for replay in replays:
        inside = sorted(e.name for e in events if e.parent_id == replay.span_id)
        assert inside == ["match.device", "pose.device"]


def test_superwindow_and_run_sequence_replay_as_eager(cuda, tmp_path, monkeypatch):
    """A six-window ``track_superwindow`` (1 + 96 bench frames, 2,048
    features, 512 matches) and two consecutive 96-frame dispatches of
    ``run_sequence`` give with the graphs what the eager stages give, in
    every leaf and every diagnostic; every window replays (one capture).
    The superwindow matches every frame, with rotations orthonormal,
    translations of unit length and the median match displacement the
    frames' own 6 px shift."""
    from mvslam_tpu_torch.core import prng
    from mvslam_tpu_torch.data.bench_frames import make_frames
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
    from mvslam_tpu_torch.slam import tracking
    from mvslam_tpu_torch.slam.api import SLAMSystem, SLAMSystemConfig

    host = [f.astype(np.uint8) for f in make_frames(193)]
    frames = torch.from_numpy(np.stack(host[:97])).to(cuda)
    fc = FeaturePipelineConfig(num_features=2048, max_matches=512)
    pc = _kitti_pose_config()
    K = torch.tensor([[718.856, 0.0, 607.19], [0.0, 718.856, 185.22], [0.0, 0.0, 1.0]], device=cuda)
    key = prng.key(3, cuda)
    prev = tracking.bootstrap_frame(frames[0], fc)

    def runs():
        last, track = tracking.track_superwindow(key, prev, frames[1:], K, fc, pc, window=16, start_index=1)
        torch.cuda.synchronize()
        cfg = SLAMSystemConfig(
            output_root=tmp_path, feature=fc, pose=pc,
            enable_local_ba=False, enable_relocalization=False, persist_map_snapshot=False,
        )
        system = SLAMSystem(cfg, device=cuda)
        diags = system.run_sequence(host[:97], window=16, windows_per_dispatch=6)
        diags += system.run_sequence(host[97:], [97.0 + i for i in range(96)], window=16, windows_per_dispatch=6)
        strip = lambda d: {k: v for k, v in d.to_dict().items() if k != "correlation_id"}  # noqa: E731
        return last, track, np.stack(system.trajectory.poses), [strip(d) for d in diags], system.telemetry.events()

    last, graphed, poses, diags, events = runs()
    scalars = tracking.pull_scalars(graphed)
    assert (scalars["num_matches"] > 0).all()
    rot, trans = scalars["rotation"].reshape(-1, 3, 3), scalars["translation"].reshape(-1, 3)
    assert np.abs(rot @ np.swapaxes(rot, -1, -2) - np.eye(3)).max() < 1e-3
    assert np.abs(np.linalg.norm(trans, axis=-1) - 1.0).max() < 1e-3
    assert np.abs(scalars["median_displacement_px"] - 6.0).max() < 0.5  # make_frames slides its texture 6 px a frame
    names = [e.name for e in events]
    assert names.count("pair_graph_replay") == names.count("pose.device") == 2 * 6
    with monkeypatch.context() as m:
        m.setattr(tracking.PAIR_GRAPHS, "track", lambda *args: None)  # the eager stages
        last_e, eager, poses_e, diags_e, events_e = runs()
    assert "pair_graph_replay" not in [e.name for e in events_e]
    for a, b in zip(last, last_e):
        assert torch.equal(a, b)
    _assert_tracks_equal(graphed, eager)
    assert np.array_equal(poses, poses_e)
    assert diags == diags_e
    assert sum(d["pose_success"] for d in diags) >= 180


def test_native_matcher_equals_the_cards_matcher(cuda):
    """The C++ host matcher on two bench frames' 2,048 descriptors from the
    card's detector: each row's best column, best and second distances,
    each column's best row and the cross-checked set bit-equal to the
    card's ``match_descriptors``."""
    from mvslam_tpu_torch import native
    from mvslam_tpu_torch.data.bench_frames import make_frames
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
    from mvslam_tpu_torch.ops.hamming import (
        MatchConfig,
        hamming_distance_matrix,
        match_descriptors,
        match_descriptors_host,
    )
    from mvslam_tpu_torch.slam.tracking import bootstrap_frame

    assert native.native_available(), "the native host library did not build"
    cfg = FeaturePipelineConfig(num_features=2048, max_matches=512)
    a, b = (bootstrap_frame(torch.from_numpy(f.astype(np.uint8)).to(cuda), cfg) for f in make_frames(2))
    words = [np.ascontiguousarray(x.cpu().numpy()) for x in (a.descriptors, a.valid, b.descriptors, b.valid)]
    host_in = (words[0].view(np.uint32), words[1], words[2].view(np.uint32), words[3])
    best_idx, best, second, col_best = native.hamming_match(*host_in)
    match_cfg = MatchConfig(cross_check=True)
    card = match_descriptors(a.descriptors, a.valid, b.descriptors, b.valid, match_cfg)
    d = hamming_distance_matrix(a.descriptors, b.descriptors)
    d = torch.where(b.valid[None, :], d, torch.tensor(1e9, device=cuda))
    d = torch.where(a.valid[:, None], d, torch.tensor(1e9, device=cuda))
    assert int(card.valid.sum()) > 500
    assert np.array_equal(best_idx, card.indices.cpu().numpy())
    assert np.array_equal(best, card.distances.cpu().numpy())
    assert np.array_equal(second, card.second_distances.cpu().numpy())
    assert np.array_equal(col_best, torch.argmin(d, dim=0).cpu().numpy())
    assert np.array_equal(match_descriptors_host(*host_in, match_cfg).valid.numpy(), card.valid.cpu().numpy())


def _out_and_back(num_frames):
    """Out along x 0.25 a frame to the middle frame, then back over the
    same places: frame q revisits frame (num_frames - 1) - q."""
    half = (num_frames - 1) // 2
    return lambda i: (np.eye(3), np.array([0.25 * (i if i <= half else 2 * half - i), 0.0, 0.0]))


def _offline_config(root, gt_path, output_root, run_id, loops):
    """The offline benchmark's ``run_visual_slam`` settings: seed 3, loop
    gap 12, similarity 0.7, 25 inliers, ground truth given, all else
    default (window BA, relocalization and snapshots on)."""
    from mvslam_tpu_torch.slam.offline import SLAMRunConfig

    return SLAMRunConfig(
        input_path=root, input_kind="kitti", sequence="00", output_root=output_root, run_id=run_id, seed=3,
        ground_truth_path=gt_path, loop_min_frame_gap=12, loop_similarity_threshold=0.7, loop_min_inliers=25,
        enable_loop_closure=loops,
    )


def test_run_visual_slam_from_png_files_on_the_card(cuda, tmp_path):
    """The offline CLI's ``run_visual_slam`` on the card, reading PNG files:
    the offline benchmark's out-and-back revisit (1 + 28 frames, 400 quads,
    noise 6, seed 2) at 1226x370 as a KITTI layout, twice with loop closure
    and once without. At most 3 frames unposed in each run, a loop
    accepted, ATE with loops at most twice ATE without and both under 0.05
    (the JAX package's own CPU run of this scene reads 0.0345 and 0.0225);
    the two equal runs' summaries and trajectories bit-equal; the persisted
    snapshot reloads with its digest; the kernels launch only at compared
    shapes."""
    from mvslam_tpu_torch.data.synthetic import render_scene, write_kitti_sequence
    from mvslam_tpu_torch.loopclosure.persistent_map import load_map_snapshot
    from mvslam_tpu_torch.slam.offline import run_visual_slam

    frames, gt, intrinsics, _ = render_scene(num_frames=29, h=370, w=1226, seed=2, n_pts=400, noise=6.0,
                                             traj_fn=_out_and_back(29))
    root, gt_path = write_kitti_sequence(tmp_path / "kitti", frames, gt, intrinsics)
    before = _launch_counts()
    runs = []
    for name, loops in (("loops", True), ("loops_again", True), ("no_loops", False)):
        summary = run_visual_slam(_offline_config(root, gt_path, tmp_path / name, "offline", loops), device=cuda)
        run_dir = Path(summary["run_dir"])
        diags = json.loads((run_dir / "diagnostics" / "frame_diagnostics.json").read_text())
        assert len(diags) == 29 and sum(bool(d["pose_success"]) for d in diags[1:]) >= 28 - 3, name
        runs.append((summary, run_dir))
    _assert_launched_shapes_compared(before)
    (first, a), (_, b), (plain, _) = runs
    assert len(first["loops_accepted"]) >= 1
    ate, ate_plain = first["metrics"]["ATE_RMSE"], plain["metrics"]["ATE_RMSE"]
    assert ate <= 2.0 * ate_plain and max(ate, ate_plain) < 0.05, (ate, ate_plain)
    assert (a / "offline_summary.json").read_bytes() == (b / "offline_summary.json").read_bytes()
    ta, tb = (np.load(r / "trajectories" / "estimated.npz") for r in (a, b))
    assert sorted(ta.files) == sorted(tb.files) and all(np.array_equal(ta[k], tb[k]) for k in ta.files)
    maps = a / "maps"
    snapshot = load_map_snapshot(maps / "map_snapshot_arrays.npz", maps / "map_snapshot_metadata.json")
    assert snapshot.digest() == json.loads((maps / "map_snapshot_metadata.json").read_text())["digest"]
    assert len(snapshot.keyframes) == first["keyframes"]


def _yaw(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _accuracy_tracking(name, root, cuda):
    """``benchmarks/benchmark_accuracy_scenes.py``'s tracking scene ``name``
    through ``SLAMSystem`` with that script's settings (seed 3, 512
    features, 256 matches, 256 hypotheses, a fixed 2 px threshold,
    ``min_translation=0.05`` where it sets it): (ATE, RPE)."""
    from mvslam_tpu_torch.backend.keyframes import KeyframeConfig
    from mvslam_tpu_torch.data.synthetic import render_scene
    from mvslam_tpu_torch.eval.trajectory import compute_additional_metrics
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
    from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
    from mvslam_tpu_torch.slam.api import SLAMSystem, SLAMSystemConfig

    scenes = {  # render_scene's defaults: 10 frames, 240x320
        "straight": (dict(), 0.05),
        "yaw_arc": (dict(traj_fn=lambda i: (_yaw(0.03 * i), np.array([0.25 * i, 0.0, 0.05 * i]))), None),
        "noisy_arc": (dict(num_frames=14, traj_fn=lambda i: (_yaw(0.02 * i), np.array([0.25 * i, 0.0, 0.05 * i])),
                           noise=5.0, seed=11), 0.05),
    }
    kwargs, min_translation = scenes[name]
    frames, gt, (fx, fy, cx, cy), _ = render_scene(**kwargs)
    keyframe = {} if min_translation is None else {"keyframe": KeyframeConfig(min_translation=min_translation)}
    system = SLAMSystem(
        SLAMSystemConfig(
            run_id=f"accuracy_{name}", output_root=root, seed=3, fx=fx, fy=fy, cx=cx, cy=cy,
            feature=FeaturePipelineConfig(num_features=512, max_matches=256),
            pose=RobustPoseEstimatorConfig(num_hypotheses=256, adaptive_threshold=False, essential_threshold_px=2.0),
            **keyframe,
        ),
        device=cuda,
    )
    system.run_sequence(frames)
    metrics = compute_additional_metrics(np.stack(system.trajectory.poses)[:, :3, 3], gt)
    return float(metrics["ATE_RMSE"]), float(metrics["RPE_RMSE"])


def test_accuracy_scenes_on_the_card_pass_the_gate(cuda, tmp_path):
    """The four scenes of ``benchmarks/benchmark_accuracy_scenes.py`` (it
    imports the JAX package, so its scenes and settings are restated here)
    through the port on the card: the straight, yawing and noisy arcs
    through ``SLAMSystem``, and the 1 + 28-frame out-and-back revisit at
    240x320 (noise 6, seed 2) through ``run_visual_slam`` with loops off and
    on. Its ten metrics, under the script's names, pass ``compare_metrics``
    against ``baselines/accuracy_scenes.json`` under
    ``configs/evaluation/accuracy_gate.json``, both read as they are; the
    kernels launch only at compared shapes."""
    from mvslam_tpu_torch.data.synthetic import render_scene, write_kitti_sequence
    from mvslam_tpu_torch.eval.baselines import BaselineStore, compare_metrics
    from mvslam_tpu_torch.slam.offline import run_visual_slam

    before = _launch_counts()
    metrics = {}
    for name in ("straight", "yaw_arc", "noisy_arc"):
        metrics[f"accuracy_{name}_ate_rmse"], metrics[f"accuracy_{name}_rpe_rmse"] = _accuracy_tracking(
            name, tmp_path, cuda)
    frames, gt, intrinsics, _ = render_scene(num_frames=29, traj_fn=_out_and_back(29), noise=6.0, seed=2)
    root, gt_path = write_kitti_sequence(tmp_path / "kitti_oab", frames, gt, intrinsics)
    for tag, loops in (("off", False), ("on", True)):
        run = run_visual_slam(_offline_config(root, gt_path, tmp_path / "runs_oab", f"loop_{tag}", loops), device=cuda)
        metrics[f"accuracy_oab_loop_{tag}_ate_rmse"] = float(run["metrics"]["ATE_RMSE"])
    _assert_launched_shapes_compared(before)
    metrics["accuracy_oab_loop_ate_ratio"] = metrics["accuracy_oab_loop_on_ate_rmse"] / max(
        metrics["accuracy_oab_loop_off_ate_rmse"], 1e-12)
    ates = [metrics[f"accuracy_{name}_ate_rmse"] for name in ("straight", "yaw_arc", "noisy_arc", "oab_loop_on")]
    metrics["accuracy_mean_ate_rmse"] = sum(ates) / len(ates)
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    gate = json.loads((REPO / "configs" / "evaluation" / "accuracy_gate.json").read_text())
    thresholds = next(b for b in gate["benchmarks"] if b["name"] == "accuracy_scenes")["metric_thresholds"]
    baseline = BaselineStore(REPO / "baselines" / "accuracy_scenes.json").load_baseline("accuracy_scenes")
    report = compare_metrics(metrics, baseline, thresholds)
    assert report.status == "pass", (metrics, report.to_dict())
