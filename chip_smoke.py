#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mvslam_tpu_torch``) on one GPU.

Usage, from the repository root on a machine with an NVIDIA H100::

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises, exits non-zero
and prints no ok line):

1. device  — ``nvidia-smi`` name and power limit, torch's device name.
2. build   — nvcc builds both CUDA kernels from ``mvslam_tpu_torch/csrc``.
3. K1      — ``fast_detect`` against its plain version on four inputs:
             16 bench frames (16, 370, 1226) uint8 and one (the main
             path's window and bootstrap), 16 frames of the slam phase's
             rendered scene (float32, the kernel's f32 route) and one
             rendered frame (the flow path's call): detections and raw
             scores bit-equal over the whole map; kernel and plain times
             (CUDA events, median), device time (``torch.profiler``, mean
             of 20 launches) against the bound from the shapes.
3b. k1_ab  — only with ``--ab OLD.cu``, right after K1: builds OLD.cu (an
             earlier ``fast_detect.cu``) and the current one side by side
             with ``-Xptxas -v`` (registers, shared memory, spills), checks
             both bit-equal to the plain version, and times them in turns
             (old, new, new, old; device time) on both routes at B = 16
             and B = 1.
4. K2      — ``extract_patches`` against its plain version, (16, 370, 1226)
             f32 image and (16, 2048, 2) keypoints including border-clamped
             and exact .5 coordinates; bf16 output bit-equal; kernel, plain
             and device times, the bound, and one PyTorch gather on
             precomputed starts as the yardstick (``library_ms``).
5. k2_lk   — ``extract_patches`` with float32 output at the LK pyramid's
             shapes (1, 370, 1226), (1, 185, 613), (1, 92, 306), 2048
             points including the clamped border band: bit-equal to the
             plain version; the same times, bound and yardstick per level.
6. main    — ``bootstrap_frame`` + ``track_superwindow`` over the bench's
             193 frames (``data.bench_frames``, the benchmark's frames)
             with the bench configuration (2048 features, 512
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
9. slam_ba — the slam phase's run with windowed bundle adjustment on (the
             default ``KeyframeConfig``, window of 5; relocalization and
             snapshots off), twice: >= 93 of 96 poses, direction of
             travel, at least one BA solve accepted, both kernels launched,
             the two runs' trajectories bit-equal; ``local_ba`` ms per
             keyframe from the telemetry (median, p90) split into pair gate
             and solve, accepted/tripped counts, frames/s and ATE beside
             the slam phase's, peak memory, and the host syncs of one
             window's solve (``torch.cuda.set_sync_debug_mode``).
10. pose_graph — ``PoseGraph3D`` of 1,000 SE3 poses (a noisy odometry
             chain around a path driven ten times, 10 loop edges), solved
             with ``SolverConfig(max_iterations=15, damping=1e-4)`` by
             Cholesky and by CG, each twice: finite, final cost below the
             initial, endpoint error reduced, the two runs bit-equal; ms
             per solve, peak memory, host syncs of one solve.

Kernel launches are counted per path: the counts are set to 0 just
before each of main, slam, flow and slam_ba and read just after (the
pose-graph solver runs no hand kernel). The
second-to-last line is the per-kernel JSON record (per route: event,
plain, device and yardstick times, the bound and the share of it reached);
the last line is ``{"ok": true, "device": {...}}``. Needs one CUDA device;
imports no JAX and nothing of the reference package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent
# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 bandwidth and
# float32 outside the tensor cores. A bound is the larger of bytes (each
# input read once, each output written once) over the first and operations
# over the second.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
K1_OPS_PER_PX = 180  # the reference kernel's own cost estimate (pallas_fast.py:160)
THRESHOLD = 20.0
MARGIN = 19
NUM_FRAMES = 193
WINDOW = 16
WINDOWS_PER_CALL = 6
NUM_FEATURES = 2048
BENCH_K = [[718.856, 0.0, 607.19], [0.0, 718.856, 185.22], [0.0, 0.0, 1.0]]
FRAME_SHIFT_PX = 6.0  # make_frames slides its texture 6 px per frame
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


def device_ms(fn, kernel: str | None = None, iters: int = 20):
    """Device time (ms) per call of ``fn``, mean over ``iters`` calls, from
    ``torch.profiler``: the duration of the CUDA kernels whose name contains
    ``kernel`` (exactly one per call), or of every device activity when
    ``kernel`` is None. The profiler now and then drops a record (seen on
    the H100: 19 of 20 launches), so each kernel's time is the mean over the
    launches it recorded, times its launches per call. None when the
    profiler sees no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per_call_us, seen = 0.0, 0
    for event in prof.key_averages():
        if event.device_type == DeviceType.CUDA and event.count and (kernel is None or kernel in event.key):
            per_call_us += event.device_time_total / event.count * max(1, round(event.count / iters))
            seen += event.count
    if per_call_us == 0.0:
        return None
    if kernel is not None and not iters // 2 <= seen <= iters:
        raise AssertionError(f"profiler saw {seen} launches of {kernel} for {iters} calls")
    return per_call_us / 1e3


def bound(nbytes: float, ops: float = 0.0) -> dict:
    """The least time (ms) the card could take: bytes over HBM bandwidth or
    operations over the float32 peak, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "ops": int(ops)}


def with_share(record: dict) -> dict:
    dev = record.get("device_ms")
    record["bound_share"] = record["bound_ms"] / dev if dev else None
    return record


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


def k1_label(x) -> str:
    return f"{str(x.dtype).replace('torch.', '')} {tuple(x.shape)}"


def k1_bound(x) -> dict:
    """K1 reads each pixel once and writes det and raw (f32) once; the
    operations are the reference kernel's own estimate per pixel."""
    return bound(x.numel() * (x.element_size() + 8), x.numel() * K1_OPS_PER_PX)


def k1_route(x) -> dict:
    """K1 on one input: bit-equal to its plain version over the whole map,
    with event, plain and device times against the bound."""
    import torch

    from mvslam_tpu_torch.ops.cuda_fast import fast_detect, fast_detect_plain

    det_k, raw_k = fast_detect(x, THRESHOLD, MARGIN)
    det_p, raw_p = fast_detect_plain(x, THRESHOLD, MARGIN)
    torch.cuda.synchronize()
    err = max((det_k - det_p).abs().max().item(), (raw_k - raw_p).abs().max().item())
    label = k1_label(x)
    if not (torch.equal(det_k, det_p) and torch.equal(raw_k, raw_p)):
        raise AssertionError(f"K1 fast_detect ({label}) disagrees with its plain version (max abs err {err})")
    return with_share({
        "route": label, "detections": int((det_k > 0).sum()), "bit_equal": True, "max_abs_err": err,
        "ms": median_ms(lambda: fast_detect(x, THRESHOLD, MARGIN)),
        "plain_ms": median_ms(lambda: fast_detect_plain(x, THRESHOLD, MARGIN)),
        "device_ms": device_ms(lambda: fast_detect(x, THRESHOLD, MARGIN), "fast_detect_kernel"),
        **k1_bound(x),
    })


def phase_k1(frames_u8, frames_f32):
    """K1 on the main path's uint8 window and bootstrap frame, on the slam
    path's float32 window (rendered frames: the kernel's f32 route) and on
    one rendered frame (the flow path's call)."""
    routes = [k1_route(x) for x in (frames_u8[:16], frames_f32[:16], frames_u8[:1], frames_f32[:1])]
    main = routes[0]
    record = {
        "name": "fast_detect", "route": "cuda", "source": "mvslam_tpu_torch/csrc/fast_detect.cu",
        "replaces": "mvslam_tpu/ops/pallas_fast.py:125", "max_abs_err": max(r["max_abs_err"] for r in routes),
        **{k: main[k] for k in ("ms", "plain_ms", "device_ms", "bound_ms", "bound_by", "bound_share")},
        "library_ms": None, "library": "none: no single PyTorch call computes FAST-9 + 3x3 NMS + border mask",
        "routes": routes,
    }
    emit({"phase": "k1", "routes": routes})
    return record


def build_k1_variant(src: Path, tag: str):
    """``src`` (a ``fast_detect.cu``) alone into its own library, with
    ``-Xptxas -v``; returns (ctypes library, ptxas report lines)."""
    from mvslam_tpu_torch.core import cuda_build

    out = REPO / "mvslam_tpu_torch" / "_build" / "ab" / f"libfast_detect_{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [cuda_build.nvcc_path(), *cuda_build._NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr[-4000:]}")
    lib = ctypes.CDLL(str(out))
    for name in ("fast_detect_u8", "fast_detect_f32"):
        getattr(lib, name).argtypes = cuda_build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    report = [line.split(":", 1)[-1].strip() for line in proc.stderr.splitlines()
              if line.startswith("ptxas info") or "spill" in line]
    return lib, report


def phase_k1_ab(old_src: Path, frames_u8, frames_f32):
    """The earlier K1 (``old_src``) against the current one in one process:
    both bit-equal to the plain version, device times in turns (old, new,
    new, old) on the uint8 and float32 routes at B = 16 and B = 1."""
    import torch

    from mvslam_tpu_torch.ops.cuda_fast import fast_detect_plain

    libs, ptxas = {}, {}
    for tag, src in (("old", old_src), ("new", REPO / "mvslam_tpu_torch" / "csrc" / "fast_detect.cu")):
        libs[tag], ptxas[tag] = build_k1_variant(src, tag)
    emit({"phase": "k1_ab_build", "ptxas": ptxas})

    def run(tag, x):
        det = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        raw = torch.empty_like(det)
        b, h, w = x.shape
        stream = torch.cuda.current_stream().cuda_stream
        if x.dtype == torch.uint8:
            err = libs[tag].fast_detect_u8(x.data_ptr(), det.data_ptr(), raw.data_ptr(), b, h, w,
                                           int(THRESHOLD), MARGIN, stream)
        else:
            err = libs[tag].fast_detect_f32(x.data_ptr(), det.data_ptr(), raw.data_ptr(), b, h, w,
                                            THRESHOLD, MARGIN, stream)
        if err != 0:
            raise RuntimeError(f"K1 ({tag}) launch failed with cudaError_t {err}")
        return det, raw

    routes = []
    for x in (frames_u8[:16], frames_f32[:16], frames_u8[:1], frames_f32[:1]):
        label = k1_label(x)
        ref = fast_detect_plain(x, THRESHOLD, MARGIN)
        for tag in libs:
            got = run(tag, x)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
                raise AssertionError(f"K1 ({tag}, {label}) disagrees with its plain version")
        times = {"old": [], "new": []}
        for tag in ("old", "new", "new", "old"):
            times[tag].append(device_ms(lambda: run(tag, x), "fast_detect_kernel"))
        b = k1_bound(x)
        old_ms, new_ms = statistics.mean(times["old"]), statistics.mean(times["new"])
        routes.append({
            "route": label, "bit_equal": True, "old_device_ms": times["old"], "new_device_ms": times["new"],
            "old_over_new": old_ms / new_ms, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "old_bound_share": b["bound_ms"] / old_ms, "new_bound_share": b["bound_ms"] / new_ms,
        })
    emit({"phase": "k1_ab", "old": str(old_src), "routes": routes})


def k2_library(image, xy):
    """The yardstick for K2: ONE advanced-index gather of the float32
    image's 32x32 windows at precomputed starts (the port never calls it).
    It writes float32 tiles whatever K2 writes: narrowing to bf16 would be
    a second call. Returns (fn, its output flattened like K2's)."""
    import torch

    from mvslam_tpu_torch.ops.cuda_patches import PATCH_PIXELS, PATCH_DIM, _patch_starts

    b, h, w = image.shape
    xi, yi = _patch_starts(xy, h, w)
    windows = image.unfold(1, PATCH_DIM, 1).unfold(2, PATCH_DIM, 1)
    bi = torch.arange(b, device=image.device)[:, None].expand_as(xi)

    def gather():
        return windows[bi, yi, xi]

    return gather, gather().reshape(b, xy.shape[1], PATCH_PIXELS)


def k2_bound(image, xy, out_dtype) -> dict:
    """Bytes K2 must move: the image pixels its tiles cover (this run's
    points), the points, and the tiles out."""
    import torch

    from mvslam_tpu_torch.ops.cuda_patches import PATCH_DIM, PATCH_PIXELS, _patch_starts

    b, h, w = image.shape
    xi, yi = _patch_starts(xy, h, w)
    offs = torch.arange(PATCH_DIM, device=image.device)
    lin = ((yi[..., None, None] + offs[:, None]) * w + xi[..., None, None] + offs[None, :]).reshape(b, -1)
    covered = torch.zeros((b, h * w), dtype=torch.bool, device=image.device).scatter_(1, lin, True)
    out_bytes = xy.shape[0] * xy.shape[1] * PATCH_PIXELS * torch.empty((), dtype=out_dtype).element_size()
    return bound(int(covered.sum()) * image.element_size() + xy.numel() * xy.element_size() + out_bytes)


def k2_route(image, xy, out_dtype, label: str) -> dict:
    """K2 on one input: bit-equal to its plain version and to the gather
    yardstick, with event, plain, device and yardstick times and the bound."""
    import torch

    from mvslam_tpu_torch.ops.cuda_patches import extract_patches, extract_patches_plain

    got = extract_patches(image, xy, out_dtype=out_dtype)
    ref = extract_patches_plain(image, xy, out_dtype=out_dtype)
    gather, lib_out = k2_library(image, xy)
    lib_out = lib_out.to(out_dtype)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    bits = torch.int16 if out_dtype == torch.bfloat16 else torch.int32
    if not (torch.equal(got.view(bits), ref.view(bits)) and torch.equal(got.view(bits), lib_out.view(bits))):
        raise AssertionError(f"K2 extract_patches ({label}) disagrees with its plain version or the gather (max abs err {err})")
    return with_share({
        "route": label, "image": list(image.shape), "points": int(xy.shape[1]), "bit_equal": True, "max_abs_err": err,
        "ms": median_ms(lambda: extract_patches(image, xy, out_dtype=out_dtype)),
        "plain_ms": median_ms(lambda: extract_patches_plain(image, xy, out_dtype=out_dtype)),
        "device_ms": device_ms(lambda: extract_patches(image, xy, out_dtype=out_dtype), "extract_patches_kernel"),
        "library_ms": median_ms(gather), "library_device_ms": device_ms(gather),
        **k2_bound(image, xy, out_dtype),
    })


def phase_k2(frames_u8):
    """K2's BRIEF route: the blurred (16, 370, 1226) window, 2048 points,
    bf16 tiles (float32 tiles checked too)."""
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
    got = extract_patches(image, xy, out_dtype=torch.float32)
    ref = extract_patches_plain(image, xy, out_dtype=torch.float32)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError("K2 extract_patches (float32 tiles) disagrees with its plain version")
    brief = k2_route(image, xy, torch.bfloat16, "bf16 tiles, BRIEF")
    record = {
        "name": "extract_patches", "route": "cuda", "source": "mvslam_tpu_torch/csrc/extract_patches.cu",
        "replaces": "mvslam_tpu/ops/pallas_patches.py:85",
        **{k: brief[k] for k in ("max_abs_err", "ms", "plain_ms", "device_ms", "bound_ms", "bound_by",
                                 "bound_share", "library_ms", "library_device_ms")},
        "library": "one advanced-index gather of the f32 image's unfold windows at precomputed starts (f32 tiles)",
        "routes": [brief],
    }
    emit({"phase": "k2", **brief})
    return record


def phase_k2_lk(frames_u8):
    """K2 with float32 output at the LK pyramid's shapes, bit-equal to the
    plain version; the image is LK's blurred pyramid of one bench frame."""
    import torch

    from mvslam_tpu_torch.ops.image import downsample2, gaussian_blur

    image = gaussian_blur(frames_u8[:1].to(torch.float32), sigma=1.5, radius=2)
    gen = torch.Generator(device="cpu").manual_seed(1)
    levels = []
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
        levels.append({**k2_route(image, xy.to(image.device), torch.float32, f"f32 tiles, LK {shape}"),
                       "border_band": band})
    emit({"phase": "k2_lk", "levels": levels})
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


def slam_config(intrinsics, run_id: str, local_ba: bool = False, **kw):
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
    from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
    from mvslam_tpu_torch.slam.api import SLAMSystemConfig

    fx, fy, cx, cy = intrinsics
    root = REPO / "runs" / "chip_smoke"  # SLAMSystemConfig's default root; git-ignored
    return SLAMSystemConfig(
        run_id=run_id, output_root=root, seed=0, fx=fx, fy=fy, cx=cx, cy=cy,
        feature=FeaturePipelineConfig(num_features=NUM_FEATURES, max_matches=512),
        pose=RobustPoseEstimatorConfig(num_hypotheses=512),
        enable_local_ba=local_ba, enable_relocalization=False, persist_map_snapshot=False, **kw,
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
    return launches, {"tracked_fps": len(tracked) / elapsed, "ATE_RMSE": float(metrics["ATE_RMSE"])}


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


def device_profile(fn, iters: int = 2) -> dict:
    """Wall ms, device ms (all CUDA activity, ``torch.profiler``) and
    kernel launches per call of ``fn``, and the device's busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.count]
    dev = sum(e.device_time_total for e in events) / 1e3 / iters
    return {"wall_ms": wall, "device_ms": dev, "busy_share": dev / wall,
            "kernels_per_call": sum(e.count for e in events) / iters}


def host_syncs(fn):
    """Run ``fn`` once with CUDA sync debugging on: {"file:line": count} of
    the calls that synchronised the host with the device."""
    import collections
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)
    )
    return dict(sorted(where.items()))


def phase_slam_ba(scene, dev, slam_summary):
    """SLAMSystem with window BA over the slam phase's scene, twice; the
    pair gate and the solve timed per keyframe through wrappers."""
    import numpy as np
    import torch

    from mvslam_tpu_torch.backend import bundle_adjustment as ba
    from mvslam_tpu_torch.eval.trajectory import compute_additional_metrics
    from mvslam_tpu_torch.slam.api import SLAMSystem

    frames, gt, intrinsics = scene
    stats = {"gate_s": [], "solve_s": [], "outcomes": [], "last_solve": None, "last_gate": None}
    gate_pair, refine_window, run_ba = ba.WindowBundleAdjuster._gate_pair, ba.WindowBundleAdjuster.refine_window, ba.run_bundle_adjustment

    def timed_gate(self, *args):
        t0 = time.perf_counter()
        out = gate_pair(self, *args)  # ends in a device->host copy
        stats["gate_s"].append(time.perf_counter() - t0)
        stats["last_gate"] = (self, args)
        return out

    def timed_solve(*args, **kwargs):
        t0 = time.perf_counter()
        out = run_ba(*args, **kwargs)  # ends in a device->host copy
        stats["solve_s"].append(time.perf_counter() - t0)
        stats["last_solve"] = (args, kwargs)
        return out

    def counted_refine(self, window, key=None):
        out = refine_window(self, window, key=key)
        stats["outcomes"].append("none" if out is None else "tripped" if out.diagnostics.conditioning_tripped else "accepted")
        return out

    runs = []
    for run in range(2):
        for key in ("gate_s", "solve_s", "outcomes"):
            stats[key] = []
        system = SLAMSystem(slam_config(intrinsics, f"smoke_slam_ba_{run}", local_ba=True), device=dev)
        with mock.patch.object(ba.WindowBundleAdjuster, "_gate_pair", timed_gate), mock.patch.object(
            ba.WindowBundleAdjuster, "refine_window", counted_refine
        ), mock.patch.object(ba, "run_bundle_adjustment", timed_solve):
            reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            diags = system.run_sequence(frames, window=WINDOW, windows_per_dispatch=WINDOWS_PER_CALL)
            elapsed = time.perf_counter() - t0
            launches = read_launches()
        peak = torch.cuda.max_memory_allocated(dev)
        runs.append({
            "diags": diags, "poses": np.stack(system.trajectory.poses), "elapsed": elapsed, "launches": launches,
            "peak": peak, "ba_ms": [1e3 * e.duration_s for e in system.telemetry.events() if e.name == "local_ba"],
            "gate_ms": [1e3 * v for v in stats["gate_s"]], "solve_ms": [1e3 * v for v in stats["solve_s"]],
            "outcomes": list(stats["outcomes"]),
        })
    first, second = runs
    if not np.array_equal(first["poses"], second["poses"]):
        diff = float(np.abs(first["poses"] - second["poses"]).max())
        raise AssertionError(f"slam_ba: two runs' trajectories differ (max abs {diff})")
    tracked = first["diags"][1:]
    poses = sum(d.pose_success for d in tracked)
    if len(first["diags"]) != SCENE_FRAMES or poses < len(tracked) - 3:
        raise AssertionError(f"slam_ba posed {poses} of {len(tracked)} frames")
    est = first["poses"][:, :3, 3]
    if not np.isfinite(est).all():
        raise AssertionError("slam_ba: non-finite positions in the trajectory")
    good_dirs = float((np.diff(est, axis=0) @ np.asarray(SCENE_STEP) > 0).mean())
    if good_dirs <= 0.7:
        raise AssertionError(f"slam_ba: direction of travel consistent on only {good_dirs:.2f} of the steps")
    outcomes = {k: first["outcomes"].count(k) for k in ("accepted", "tripped", "none")}
    if outcomes["accepted"] < 1:
        raise AssertionError(f"slam_ba: no BA solve accepted: {outcomes}")
    args, kwargs = stats["last_solve"]
    syncs = host_syncs(lambda: run_ba(*args, **kwargs))
    solve_profile = device_profile(lambda: run_ba(*args, **kwargs))
    adjuster, gate_args = stats["last_gate"]
    gate_profile = device_profile(lambda: gate_pair(adjuster, *gate_args))
    metrics = compute_additional_metrics(est, gt)

    def pct(values, q):
        return float(np.percentile(values, q)) if values else None

    emit({
        "phase": "slam_ba", "frames": len(first["diags"]), "poses": poses, "keyframe_window": 5,
        "local_ba_calls": len(first["ba_ms"]), "outcomes": outcomes,
        "local_ba_ms": {"median": pct(first["ba_ms"], 50), "p90": pct(first["ba_ms"], 90)},
        "pair_gate_ms": {"calls": len(first["gate_ms"]), "median": pct(first["gate_ms"], 50), "p90": pct(first["gate_ms"], 90)},
        "solve_ms": {"calls": len(first["solve_ms"]), "median": pct(first["solve_ms"], 50), "p90": pct(first["solve_ms"], 90)},
        "last_solve_observations": len(args[2]), "last_solve_points": int(args[1].shape[0]),
        "tracked_fps": len(tracked) / first["elapsed"], "second_run_fps": len(tracked) / second["elapsed"],
        "slam_phase_fps": slam_summary["tracked_fps"], "ATE_RMSE": float(metrics["ATE_RMSE"]),
        "slam_phase_ATE_RMSE": slam_summary["ATE_RMSE"], "good_direction_share": good_dirs,
        "peak_mem_bytes": int(first["peak"]), "bit_equal_runs": True, "host_syncs_one_solve": syncs,
        "profile_one_solve": solve_profile, "profile_one_pair_gate": gate_profile,
        "launches": first["launches"],
    })
    return first["launches"]


def pose_graph_scene(num_poses=1000, laps=10, seed=0):
    """Ground-truth poses of a path driven ``laps`` times around a circle
    (a slight climb per lap), the chain composed from noisy odometry, and
    ``laps`` loop edges: each later lap's start, and the last pose, seen
    again from the first pose (the place where the path began)."""
    import numpy as np

    from mvslam_tpu_torch.geometry import lie_np

    rng = np.random.default_rng(seed)
    per_lap = num_poses // laps
    truth = []
    for i in range(num_poses):
        a = 2 * np.pi * i / per_lap
        T = np.eye(4)
        T[:3, :3] = lie_np.so3_exp(np.asarray([0.0, 0.0, a + np.pi / 2]))
        T[:3, 3] = [20.0 * np.cos(a), 20.0 * np.sin(a), 0.05 * i / per_lap]
        truth.append(T)
    chain = [truth[0]]
    for a, b in zip(truth[:-1], truth[1:]):
        delta = lie_np.se3_matrix_to_params(np.linalg.inv(a) @ b)
        delta = delta + np.concatenate([rng.normal(scale=0.02, size=3), rng.normal(scale=0.002, size=3)])
        chain.append(chain[-1] @ lie_np.se3_params_to_matrix(delta))
    ends = [k * per_lap for k in range(1, laps)] + [num_poses - 1]
    loop_edges = [(0, j, np.linalg.inv(truth[0]) @ truth[j]) for j in ends]
    return np.stack(truth), np.stack(chain), loop_edges


def phase_pose_graph(dev):
    """The 1,000-pose SE3 graph by Cholesky and by CG, each twice."""
    import numpy as np
    import torch

    from mvslam_tpu_torch.backend.pose_graph import PoseGraph3D
    from mvslam_tpu_torch.backend.solvers import SolverConfig, solve_problem

    truth, chain, loop_edges = pose_graph_scene()

    def build():
        graph = PoseGraph3D.from_pose_matrices(chain, device=dev)
        for i, j, T in loop_edges:
            graph.add_loop_matrix(i, j, T, weight=5.0)
        return graph

    def endpoint_error(graph):
        return float(np.linalg.norm(graph.poses()[-1][:3, 3] - truth[-1][:3, 3]))

    before = endpoint_error(build())
    methods = {}
    for method in ("cholesky", "cg"):
        config = SolverConfig(max_iterations=15, damping=1e-4, method=method)
        results, times, peaks = [], [], []
        for _ in range(2):
            graph = build()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            result = graph.optimize(config)  # ends in a device->host copy
            times.append(1e3 * (time.perf_counter() - t0))
            peaks.append(torch.cuda.max_memory_allocated(dev))
            results.append((result, endpoint_error(graph)))
        (r1, after), (r2, _) = results
        if not np.array_equal(r1.x, r2.x):
            raise AssertionError(f"pose_graph {method}: two runs differ (max abs {float(np.abs(r1.x - r2.x).max())})")
        if not (np.isfinite(r1.x).all() and r1.final_cost < r1.initial_cost and after < before):
            raise AssertionError(f"pose_graph {method}: cost {r1.initial_cost} -> {r1.final_cost}, "
                                 f"endpoint error {before} -> {after}")
        problem = build()._build_graph().build_problem(device=dev)
        methods[method] = {
            "ms_per_solve": times, "iterations": r1.iterations, "converged": r1.converged,
            "initial_cost": r1.initial_cost, "final_cost": r1.final_cost, "endpoint_error_after": after,
            "peak_mem_bytes": int(max(peaks)), "bit_equal_runs": True,
            "host_syncs_one_solve": host_syncs(lambda: solve_problem(problem, config)),
            "profile_one_solve": device_profile(lambda: solve_problem(problem, config), iters=1),
        }
    emit({"phase": "pose_graph", "poses": len(truth), "edges": len(chain) - 1 + len(loop_edges),
          "loops": len(loop_edges), "endpoint_error_before": before, "methods": methods})


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
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ab", type=Path, metavar="OLD.cu",
                        help="also time this earlier fast_detect.cu against the current one")
    args = parser.parse_args()
    if not (REPO / "mvslam_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    import mvslam_tpu_torch  # noqa: F401  (sets the f32 matmul precision)
    from mvslam_tpu_torch.data.bench_frames import make_frames

    phase_device()
    build_s = phase_build()
    host_frames = [f.astype("uint8") for f in make_frames(NUM_FRAMES)]
    frames_u8 = torch.from_numpy(np.stack(host_frames[:16])).cuda()
    scene = render_scene_frames()
    frames_f32 = torch.from_numpy(np.stack(scene[0][1:17])).cuda()
    k1 = phase_k1(frames_u8, frames_f32)
    if args.ab is not None:
        phase_k1_ab(args.ab.resolve(), frames_u8, frames_f32)
    del frames_f32  # the main path's peak memory counts only its own tensors
    k2 = phase_k2(frames_u8)
    k2["lk_levels"] = phase_k2_lk(frames_u8)
    by_path = {"main_path": phase_main(host_frames, build_s)}
    by_path["slam"], slam_summary = phase_slam(scene, torch.device("cuda", 0))
    by_path["flow"] = phase_flow(scene, torch.device("cuda", 0))
    by_path["slam_ba"] = phase_slam_ba(scene, torch.device("cuda", 0), slam_summary)
    phase_pose_graph(torch.device("cuda", 0))
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
