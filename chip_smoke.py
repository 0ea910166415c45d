#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mvslam_tpu_torch``) on one GPU.

Usage, from the repository root on a machine with an NVIDIA H100::

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises, exits non-zero
and prints no ok line):

1. device  — ``nvidia-smi`` name and power limit, torch's device name.
2. build   — nvcc builds both CUDA kernels from ``mvslam_tpu_torch/csrc``.
3. K1      — ``fast_detect`` against its plain version on 16 bench frames
             (16, 370, 1226) uint8, and on 16 frames of the slam phase's
             rendered scene (float32, the kernel's f32 path): detections
             bit-equal, raw bit-equal on the interior; kernel and plain
             times (CUDA events, median).
4. K2      — ``extract_patches`` against its plain version, (16, 370, 1226)
             f32 image and (16, 2048, 2) keypoints including border-clamped
             and exact .5 coordinates; bf16 output bit-equal; both times.
5. k2_lk   — ``extract_patches`` with float32 output at the LK pyramid's
             shapes (1, 370, 1226), (1, 185, 613), (1, 92, 306), 2048
             points including the clamped border band: bit-equal to the
             plain version; kernel and plain times per level.
6. main    — ``bootstrap_frame`` + ``track_superwindow`` over the bench's
             193 frames with the bench configuration (2048 features, 512
             matches, 512 E + 256 H hypotheses, window 16, 6 windows per
             call, key 0): all 192 frames tracked, both kernels launched,
             the first window's features equal a run of the plain
             versions; tracked frames/s, time to first result, peak memory.
7. slam    — ``SLAMSystem.run_sequence`` (window 16, 6 windows per call,
             the bench configuration, BA/relocalization/snapshots off)
             over 1 + 96 frames of a 370x1226 scene rendered by the port's
             ``data.synthetic.render_scene``: the reference's artifact set,
             >= 93 of 96 poses, direction of travel, both kernels
             launched; tracked frames/s, ATE, peak memory.
8. flow    — ``pose_source="flow_first"``, ``window=1`` over the scene's
             first 33 frames: flow poses used, >= 30 poses, >= 30 K2
             launches inside ``lk_track`` per flow frame, ``lk_track``
             bit-equal with K2 and with its plain version; frames/s and
             LK ms per frame.

Kernel launches are counted per path: the counts are set to 0 just
before each of main, slam and flow and read just after. The
second-to-last line is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``. Needs one CUDA device; imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent
THRESHOLD = 20.0
MARGIN = 19
NUM_FRAMES = 193
WINDOW = 16
WINDOWS_PER_CALL = 6
NUM_FEATURES = 2048
BENCH_K = [[718.856, 0.0, 607.19], [0.0, 718.856, 185.22], [0.0, 0.0, 1.0]]
FRAME_SHIFT_PX = 6.0  # bench.make_frames slides its texture 6 px per frame
LK_SHAPES = [(1, 370, 1226), (1, 185, 613), (1, 92, 306)]  # LK's three pyramid levels
# The rendered scene of the slam and flow phases: 1 + 96 frames at the
# bench's 1226x370, 400 textured quads, the camera sliding 0.1 units along
# x and 0.02 along z per frame (the direction of render_scene's default
# trajectory, at half its speed, so the scene stays in view for 96 frames).
SCENE_FRAMES = 1 + 96
SCENE_POINTS = 400
SCENE_STEP = (0.1, 0.0, 0.02)
FLOW_FRAMES = 33
ARTIFACTS = [
    "diagnostics/frame_diagnostics.json", "metrics/run_metrics.json", "reports/telemetry_summary.json",
    "run_metadata.json", "telemetry/events.json", "trajectories/estimated.npz",
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median wall time of ``fn`` on the device, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke test needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({
        "phase": "device", "nvidia_smi": smi, "torch_device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "torch": torch.__version__, "cuda": torch.version.cuda,
    })


def phase_build() -> float:
    from mvslam_tpu_torch.core import cuda_build

    t0 = time.perf_counter()
    cuda_build.load()
    seconds = time.perf_counter() - t0
    emit({"phase": "build", "seconds": seconds, "library": str(cuda_build.build().relative_to(REPO))})
    return seconds


def phase_k1(frames_u8, frames_f32):
    """K1 on the main path's uint8 window and on the slam path's float32
    window (rendered frames: the kernel's f32 path)."""
    import torch

    from mvslam_tpu_torch.ops.cuda_fast import fast_detect, fast_detect_plain

    inner = (slice(None), slice(4, -4), slice(4, -4))
    results = {}
    for dtype, x in (("uint8", frames_u8[:16]), ("float32", frames_f32[:16])):
        det_k, raw_k = fast_detect(x, THRESHOLD, MARGIN)
        det_p, raw_p = fast_detect_plain(x, THRESHOLD, MARGIN)
        torch.cuda.synchronize()
        err = max(
            (det_k - det_p).abs().max().item(), (raw_k[inner] - raw_p[inner]).abs().max().item()
        )
        if not (torch.equal(det_k, det_p) and torch.equal(raw_k[inner], raw_p[inner])):
            raise AssertionError(f"K1 fast_detect ({dtype}) disagrees with its plain version (max abs err {err})")
        results[dtype] = {
            "shape": list(x.shape), "dtype": dtype, "detections": int((det_k > 0).sum()), "bit_equal": True,
            "max_abs_err": err, "ms": median_ms(lambda: fast_detect(x, THRESHOLD, MARGIN)),
            "plain_ms": median_ms(lambda: fast_detect_plain(x, THRESHOLD, MARGIN)),
        }
    main = results["uint8"]
    record = {
        "name": "fast_detect", "route": "cuda", "source": "mvslam_tpu_torch/csrc/fast_detect.cu",
        "replaces": "mvslam_tpu/ops/pallas_fast.py:125", "max_abs_err": max(r["max_abs_err"] for r in results.values()),
        "ms": main["ms"], "plain_ms": main["plain_ms"], "f32": results["float32"],
    }
    emit({"phase": "k1", **main, "f32": results["float32"]})
    return record


def phase_k2(frames_u8):
    import torch

    from mvslam_tpu_torch.ops.cuda_patches import extract_patches, extract_patches_plain
    from mvslam_tpu_torch.ops.image import gaussian_blur

    image = gaussian_blur(frames_u8[:16].to(torch.float32), sigma=2.0, radius=4)
    b, h, w = image.shape
    gen = torch.Generator(device="cpu").manual_seed(0)
    xy = torch.rand((b, NUM_FEATURES, 2), generator=gen) * torch.tensor([w + 40.0, h + 40.0]) - 20.0
    xy[:, :256] = torch.round(xy[:, :256]) + 0.5  # exact .5: round half to even
    xy[:, 256:260] = torch.tensor([[-7.0, -3.0], [w + 5.0, h + 9.0], [w - 1.0, 0.0], [0.0, h - 1.0]])
    xy = xy.to(image.device)
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        got = extract_patches(image, xy, out_dtype=dtype)
        ref = extract_patches_plain(image, xy, out_dtype=dtype)
        torch.cuda.synchronize()
        err = max(err, (got.float() - ref.float()).abs().max().item())
        as_bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        if not torch.equal(got.view(as_bits), ref.view(as_bits)):
            raise AssertionError(f"K2 extract_patches ({dtype}) disagrees with its plain version (max abs err {err})")
    ms = median_ms(lambda: extract_patches(image, xy, out_dtype=torch.bfloat16))
    plain_ms = median_ms(lambda: extract_patches_plain(image, xy, out_dtype=torch.bfloat16))
    record = {
        "name": "extract_patches", "route": "cuda", "source": "mvslam_tpu_torch/csrc/extract_patches.cu",
        "replaces": "mvslam_tpu/ops/pallas_patches.py:85", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
    }
    emit({"phase": "k2", "image": list(image.shape), "xy": list(xy.shape), "out": "bfloat16 (and float32)",
          "bit_equal": True, **{k: record[k] for k in ("max_abs_err", "ms", "plain_ms")}})
    return record


def phase_k2_lk(frames_u8):
    """K2 with float32 output at the LK pyramid's shapes, bit-equal to the
    plain version; the image is LK's blurred pyramid of one bench frame."""
    import torch

    from mvslam_tpu_torch.ops.cuda_patches import extract_patches, extract_patches_plain
    from mvslam_tpu_torch.ops.image import downsample2, gaussian_blur

    image = gaussian_blur(frames_u8[:1].to(torch.float32), sigma=1.5, radius=2)
    gen = torch.Generator(device="cpu").manual_seed(1)
    levels, err = [], 0.0
    for shape in LK_SHAPES:
        while tuple(image.shape) != shape:
            image = downsample2(image)
        b, h, w = shape
        # LK asks for tiles at integer corners floor(p) + shift; a third of
        # the points lie in the band where the tile clamps to the border.
        xy = torch.floor(torch.rand((b, NUM_FEATURES, 2), generator=gen) * torch.tensor([w + 0.0, h + 0.0]))
        band = NUM_FEATURES // 3
        xy[:, :band] = torch.floor(
            torch.rand((b, band, 2), generator=gen) * torch.tensor([w + 60.0, h + 60.0]) - 30.0
        )
        xy = xy.to(image.device)
        got = extract_patches(image, xy, out_dtype=torch.float32)
        ref = extract_patches_plain(image, xy, out_dtype=torch.float32)
        torch.cuda.synchronize()
        lvl_err = (got - ref).abs().max().item()
        err = max(err, lvl_err)
        if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"K2 extract_patches (float32, {shape}) disagrees with its plain version (max abs err {lvl_err})")
        levels.append({
            "shape": list(shape), "points": NUM_FEATURES, "border_band": band, "bit_equal": True,
            "ms": median_ms(lambda: extract_patches(image, xy, out_dtype=torch.float32)),
            "plain_ms": median_ms(lambda: extract_patches_plain(image, xy, out_dtype=torch.float32)),
        })
    emit({"phase": "k2_lk", "out": "float32", "levels": levels, "max_abs_err": err})
    return levels


def render_scene_frames():
    """The slam and flow phases' scene, rendered by the port's copy of the
    renderer: (frames, gt positions, intrinsics)."""
    import numpy as np

    from mvslam_tpu_torch.data.synthetic import render_scene

    step = np.asarray(SCENE_STEP)
    frames, gt, intrinsics, _ = render_scene(
        num_frames=SCENE_FRAMES, h=370, w=1226, seed=0, n_pts=SCENE_POINTS,
        traj_fn=lambda i: (np.eye(3), step * i),
    )
    return frames, gt, intrinsics


def slam_config(intrinsics, run_id: str, **kw):
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
    from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
    from mvslam_tpu_torch.slam.api import SLAMSystemConfig

    fx, fy, cx, cy = intrinsics
    root = REPO / "runs" / "chip_smoke"  # SLAMSystemConfig's default root; git-ignored
    return SLAMSystemConfig(
        run_id=run_id, output_root=root, seed=0, fx=fx, fy=fy, cx=cx, cy=cy,
        feature=FeaturePipelineConfig(num_features=NUM_FEATURES, max_matches=512),
        pose=RobustPoseEstimatorConfig(num_hypotheses=512),
        enable_local_ba=False, enable_relocalization=False, persist_map_snapshot=False, **kw,
    )


def reset_launches():
    from mvslam_tpu_torch.ops import cuda_fast, cuda_patches

    cuda_fast.fast_detect.launches = 0
    cuda_patches.extract_patches.launches = 0


def read_launches():
    from mvslam_tpu_torch.ops import cuda_fast, cuda_patches

    launches = {
        "fast_detect": cuda_fast.fast_detect.launches,
        "extract_patches": cuda_patches.extract_patches.launches,
    }
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on this path")
    return launches


def phase_slam(scene, dev):
    """SLAMSystem over the rendered scene, windowed like the main path."""
    import numpy as np
    import torch

    from mvslam_tpu_torch.eval.trajectory import compute_additional_metrics
    from mvslam_tpu_torch.slam.api import SLAMSystem

    frames, gt, intrinsics = scene
    system = SLAMSystem(slam_config(intrinsics, "smoke_slam"), device=dev)
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    diags = system.run_sequence(frames, window=WINDOW, windows_per_dispatch=WINDOWS_PER_CALL)
    elapsed = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    result = system.finalize_run()

    tracked = diags[1:]
    poses = sum(d.pose_success for d in tracked)
    if len(diags) != SCENE_FRAMES or poses < len(tracked) - 3:
        raise AssertionError(f"SLAMSystem posed {poses} of {len(tracked)} frames: "
                             f"{[(d.frame_id, d.failure_reason) for d in tracked if not d.pose_success]}")
    written = sorted(str(p.relative_to(result.run_dir)) for p in result.run_dir.rglob("*") if p.is_file())
    if written != ARTIFACTS:
        raise AssertionError(f"finalize_run wrote {written}, expected {ARTIFACTS}")
    est = np.stack(system.trajectory.poses)[:, :3, 3]
    if not np.isfinite(est).all():
        raise AssertionError("non-finite positions in the trajectory")
    metrics = compute_additional_metrics(est, gt)
    extent = float(np.linalg.norm(gt[-1] - gt[0]))
    steps = np.diff(est, axis=0)
    good_dirs = float((steps @ np.asarray(SCENE_STEP) > 0).mean())
    if good_dirs <= 0.7:
        raise AssertionError(f"direction of travel consistent on only {good_dirs:.2f} of the steps")
    emit({
        "phase": "slam", "frames": len(diags), "shape": [370, 1226], "n_pts": SCENE_POINTS,
        "trajectory": f"R = I, t_i = {list(SCENE_STEP)} * i", "num_features": NUM_FEATURES,
        "max_matches": 512, "hypotheses": {"essential": 512, "homography": 256}, "window": WINDOW,
        "windows_per_call": WINDOWS_PER_CALL, "poses": poses, "keyframes": result.num_keyframes,
        "models": {m: sum(d.model_type == m for d in tracked) for m in ("essential", "homography")},
        "tracked_fps": len(tracked) / elapsed, "elapsed_s": elapsed, "peak_mem_bytes": int(peak),
        "ATE_RMSE": float(metrics["ATE_RMSE"]), "extent": extent, "ATE_over_extent": float(metrics["ATE_RMSE"]) / extent,
        "good_direction_share": good_dirs, "artifacts": written, "launches": launches,
    })
    return launches


def phase_flow(scene, dev):
    """Flow-first SLAMSystem, one frame at a time, plus ``lk_track`` with
    K2 against ``lk_track`` with K2's plain version."""
    import torch

    from mvslam_tpu_torch.ops import cuda_patches, lk
    from mvslam_tpu_torch.slam import tracking
    from mvslam_tpu_torch.slam.api import SLAMSystem

    frames, _, intrinsics = scene
    lk_calls = {"calls": 0, "k2": 0}

    def counted_lk_track(*args, **kwargs):
        before = cuda_patches.extract_patches.launches
        out = lk.lk_track(*args, **kwargs)
        lk_calls["calls"] += 1
        lk_calls["k2"] += cuda_patches.extract_patches.launches - before
        return out

    system = SLAMSystem(slam_config(intrinsics, "smoke_flow", pose_source="flow_first"), device=dev)
    with mock.patch.object(tracking, "lk_track", counted_lk_track):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        diags = system.run_sequence(frames[:FLOW_FRAMES], window=1)
        elapsed = time.perf_counter() - t0
        launches = read_launches()
    tracked = diags[1:]
    poses = sum(d.pose_success for d in tracked)
    flow_poses = sum(d.model_type.startswith("flow_") for d in tracked)
    if flow_poses < 1 or poses < 30:
        raise AssertionError(f"flow-first: {poses} poses, {flow_poses} from flow: {[d.model_type for d in diags]}")
    if lk_calls["calls"] != len(tracked) or lk_calls["k2"] < 30 * lk_calls["calls"]:
        raise AssertionError(f"lk_track ran {lk_calls['calls']} times with {lk_calls['k2']} K2 launches")

    # One lk_track call on the card, with K2 and with its plain version.
    prev = tracking.bootstrap_frame(torch.from_numpy(frames[0]).to(dev), system.config.feature)
    g0 = tracking.frame_to_gray(torch.from_numpy(frames[0]).to(dev))
    g1 = tracking.frame_to_gray(torch.from_numpy(frames[1]).to(dev))
    got = lk.lk_track(g0, g1, prev.xy, prev.valid)
    with mock.patch.object(cuda_patches, "extract_patches", cuda_patches.extract_patches_plain):
        ref = lk.lk_track(g0, g1, prev.xy, prev.valid)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        if not torch.equal(a, b):
            raise AssertionError("lk_track with K2 differs from lk_track with K2's plain version")
    lk_ms = median_ms(lambda: lk.lk_track(g0, g1, prev.xy, prev.valid), warmup=2, iters=10)
    emit({
        "phase": "flow", "frames": len(diags), "poses": poses, "flow_poses": flow_poses,
        "fallback_poses": poses - flow_poses, "fps": len(tracked) / elapsed, "elapsed_s": elapsed,
        "lk_calls": lk_calls["calls"], "lk_k2_launches": lk_calls["k2"],
        "lk_k2_launches_per_frame": lk_calls["k2"] / lk_calls["calls"], "lk_ms_per_frame": lk_ms,
        "lk_points": int(prev.xy.shape[0]), "lk_plain_equal": True, "launches": launches,
    })
    return launches


def phase_main(host_frames, build_s: float):
    import numpy as np
    import torch

    from mvslam_tpu_torch.core import prng
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
    from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
    from mvslam_tpu_torch.ops import cuda_fast, cuda_patches
    from mvslam_tpu_torch.slam import tracking

    dev = torch.device("cuda", 0)
    fc = FeaturePipelineConfig(num_features=NUM_FEATURES, max_matches=512)
    pc = RobustPoseEstimatorConfig(num_hypotheses=512)
    K = torch.tensor(BENCH_K, dtype=torch.float32, device=dev)
    key = prng.key(0, device=dev)
    super_size = WINDOW * WINDOWS_PER_CALL
    num_super = (len(host_frames) - 1) // super_size

    # Time to first result: the first window, tracked in a process whose
    # kernels are built and checked but which has not run the pipeline.
    t0 = time.perf_counter()
    first = torch.from_numpy(host_frames[0]).to(dev)
    window1 = torch.from_numpy(np.stack(host_frames[1 : 1 + WINDOW])).to(dev)
    prev = tracking.bootstrap_frame(first, fc)
    _, track1 = tracking.track_window(key, prev, window1, K, fc, pc, start_index=1)
    tracking.pull_scalars(track1)
    first_window_s = time.perf_counter() - t0

    # The timed main path, as bench.py drives it: stage all frames on the
    # device (charged), bootstrap, then one call per 96 frames.
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    first = torch.from_numpy(host_frames[0]).to(dev)
    chunks = [
        torch.from_numpy(np.stack(host_frames[1 + i * super_size : 1 + (i + 1) * super_size])).to(dev)
        for i in range(num_super)
    ]
    prev = tracking.bootstrap_frame(first, fc)
    scalars, tracks = [], []
    for i, chunk in enumerate(chunks):
        prev, track = tracking.track_superwindow(
            key, prev, chunk, K, fc, pc, window=WINDOW, start_index=1 + i * super_size
        )
        scalars.append(tracking.pull_scalars(track))
        tracks.append(track)
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launches = read_launches()

    frames_done = num_super * super_size
    num_matches = np.concatenate([s["num_matches"].ravel() for s in scalars])
    tracked = int((num_matches > 0).sum())
    if tracked != frames_done:
        raise AssertionError(f"tracking broke: {tracked}/{frames_done} frames with matches")
    rot = np.concatenate([s["rotation"].reshape(-1, 3, 3) for s in scalars])
    trans = np.concatenate([s["translation"].reshape(-1, 3) for s in scalars])
    disp = np.concatenate([s["median_displacement_px"].ravel() for s in scalars])
    if not (np.isfinite(rot).all() and np.isfinite(trans).all()):
        raise AssertionError("non-finite pose in the main path's output")
    orth_err = float(np.abs(rot @ np.swapaxes(rot, -1, -2) - np.eye(3)).max())
    if orth_err > 1e-3 or np.abs(np.linalg.norm(trans, axis=-1) - 1.0).max() > 1e-3:
        raise AssertionError(f"rotations not orthonormal or translations not unit (orth err {orth_err})")
    disp_err = float(np.abs(disp - FRAME_SHIFT_PX).max())
    if disp_err > 0.5:
        raise AssertionError(f"median match displacement off the frames' {FRAME_SHIFT_PX} px shift by {disp_err}")

    # The first window's features against a run of the plain versions of
    # both kernels on the same frames, on the card.
    with mock.patch.object(cuda_fast, "fast_detect", cuda_fast.fast_detect_plain), mock.patch.object(
        cuda_patches, "extract_patches", cuda_patches.extract_patches_plain
    ):
        plain = tracking._detect_describe(chunks[0][:WINDOW], fc)
    plain_packed = tracking._pack_features(plain)
    kernel_packed = tracks[0].features_packed[0]
    if not torch.equal(plain_packed.view(torch.int32), kernel_packed.view(torch.int32)):
        diff = (plain_packed.view(torch.int32) != kernel_packed.view(torch.int32)).any(-1).sum().item()
        raise AssertionError(f"first window: {diff} keypoints differ between kernels and plain versions")

    emit({
        "phase": "main_path", "frames": frames_done, "frames_tracked": tracked,
        "shape": [int(v) for v in chunks[0].shape[1:]], "num_features": NUM_FEATURES, "max_matches": 512,
        "hypotheses": {"essential": 512, "homography": 256}, "window": WINDOW,
        "windows_per_call": WINDOWS_PER_CALL, "tracked_fps": frames_done / elapsed, "elapsed_s": elapsed,
        "first_window_s": first_window_s, "time_to_first_result_s": build_s + first_window_s,
        "peak_mem_bytes": int(peak), "launches": launches,
        "mean_valid_features": float(np.concatenate([s["num_features"].ravel() for s in scalars]).mean()),
        "mean_matches": float(num_matches.mean()), "max_displacement_err_px": disp_err,
        "first_window_plain_equal": True,
    })
    return launches


def main() -> int:
    if not (REPO / "mvslam_tpu_torch" / "csrc").is_dir() or not (REPO / "bench.py").is_file():
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    import mvslam_tpu_torch  # noqa: F401  (sets the f32 matmul precision)
    from bench import make_frames

    phase_device()
    build_s = phase_build()
    host_frames = [f.astype("uint8") for f in make_frames(NUM_FRAMES)]
    frames_u8 = torch.from_numpy(np.stack(host_frames[:16])).cuda()
    scene = render_scene_frames()
    k1 = phase_k1(frames_u8, torch.from_numpy(np.stack(scene[0][1:17])).cuda())
    k2 = phase_k2(frames_u8)
    k2["lk_levels"] = phase_k2_lk(frames_u8)
    by_path = {"main_path": phase_main(host_frames, build_s)}
    by_path["slam"] = phase_slam(scene, torch.device("cuda", 0))
    by_path["flow"] = phase_flow(scene, torch.device("cuda", 0))
    if any(name.split(".")[0] in ("jax", "mvslam_tpu") for name in sys.modules):
        raise AssertionError("the port imported jax or the JAX package")
    for record in (k1, k2):
        name = record["name"]
        record["launches"] = by_path["main_path"][name]
        record["launches_by_path"] = {path: counts[name] for path, counts in by_path.items()}
    emit({"kernels": [k1, k2]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
