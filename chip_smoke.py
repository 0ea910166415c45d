#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mvslam_tpu_torch``) on one GPU.

Usage, from the repository root on a machine with an NVIDIA H100::

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises, exits non-zero
and prints no ok line):

1. device  — ``nvidia-smi`` name and power limit, torch's device name.
2. build   — nvcc builds both CUDA kernels from ``mvslam_tpu_torch/csrc``
             while g++ builds the native host library from
             ``mvslam_tpu_torch/native/src`` (forced, timed).
3. K1      — ``fast_detect`` against its plain version on seven inputs:
             16 bench frames (16, 370, 1226) uint8 and one (the main
             path's window and bootstrap), 16 frames of the slam phase's
             rendered scene (float32, the kernel's f32 route), one
             rendered frame (the flow path's call), 8 bench frames (the
             offline pipeline's window), 4 (the feature plane's batch
             in run_stream_async) and 2 (a mesh slot's block): detections and raw
             scores bit-equal over the whole map; kernel and plain times
             (CUDA events, median), device time (``torch.profiler``, mean
             of 20 launches) against the bound from the shapes; at one
             frame also the host µs per call (``time.perf_counter_ns``
             over 1,000 calls, no synchronisation in between).
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
             precomputed starts as the yardstick (``library_ms``); the same
             at (8, 370, 1226) (the offline pipeline's window), at
             (4, 370, 1226) (the feature plane's batch), at (2, 370, 1226)
             (a mesh slot's block) and at (1, 370, 1226) (a bootstrap
             frame, a window-1 run), with the host µs per call at one frame.
5. k2_lk   — ``extract_patches`` with float32 output at the LK pyramid's
             shapes (1, 370, 1226), (1, 185, 613), (1, 92, 306), 2048
             points including the clamped border band: bit-equal to the
             plain version; the same times, bound, yardstick and host µs
             per call per level.
5b. k2_ab  — only with ``--ab-k2 OLD.cu``, right after k2_lk: builds OLD.cu
             (an earlier ``extract_patches.cu``), the current one, the five
             designs of ``csrc/ab/extract_patches_designs.cu`` that lost to
             it and a floor kernel (K2's grid with one load and one store
             per tile, ``csrc/ab/extract_patches_floor.cu``), each alone
             with ``-Xptxas -v``; checks every K2 bit-equal to the plain
             version at every K2 row (BRIEF at 16, 8, 4, 2, 1 frames of
             370x1226 and 8, 1 of 240x320 with 2048 and 512 points; LK's
             three levels) and times them in turns (old, new, the designs,
             then back, twice; the median device time) with the floor
             beside them; host µs
             per call of the earlier launch path (replayed step for step)
             against the wrappers' for K2 at one frame and K1 at
             (1, 370, 1226) on both routes, in turns.
6. main    — ``bootstrap_frame`` + ``track_superwindow`` over the bench's
             193 frames (``data.bench_frames``, the benchmark's frames)
             with the bench configuration (2048 features, 512
             matches, 512 E + 256 H hypotheses, window 16, 6 windows per
             call, key 0): all 192 frames tracked, both kernels launched,
             the first window's features equal a run of the plain
             versions; tracked frames/s, time to first result, peak memory,
             and the reduction form of the pose stage's RANSAC
             (``ops.ransac._auto_pinned``: pinned at its 512 matches).
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

11. offline — the offline pipeline from image files on disk: the offline
             benchmark's out-and-back revisit scene (noise 6, seed 2,
             1 + 28 frames, x = 0.25·i out to frame 14 and back) at
             1226x370 with 400 quads, rendered by the port, written as a
             KITTI layout with the port's PNG writer under
             ``runs/chip_smoke/`` and read back by the port's decoder;
             ``run_visual_slam`` with that benchmark's settings (seed 3,
             loop gap 12, similarity 0.7, 25 inliers, ground truth given,
             all else default: BA, relocalization and snapshots on), twice,
             then once without loop closure: all but at most 3 frames posed,
             >= 1 loop accepted, ATE with loops at most twice ATE without
             and both below 0.05 (a gate the JAX package's own run of this
             scene meets), the two equal runs' ``offline_summary.json`` and
             trajectories
             bit-equal, the snapshot files reload with a matching digest,
             both kernels launched; frames/s per run, loops, keyframes, both
             ATEs, median ms per keyframe of BoW, of the loop geometry and
             of the pose-graph solve per accepted loop, peak memory. With
             ``--long-offline`` also the same scene driven 1 + 60 frames,
             with and without loop closure: the same numbers, its ATE
             reported and not gated (accepted loop edges between places
             that are not revisits raise it, in both packages), beside the
             JAX package's ATE from CPU runs.
12. reloc   — ``SLAMSystem`` at its default configuration (nothing switched
             off) over the slam scene's first 33 frames, one frame at a
             time, with a tracking loss injected at frame 20: that frame
             reports the loss and a relocalization, the pose chain goes on
             (direction of travel after the loss); then a second system
             loads the first run's persisted snapshot and relocalizes the
             same frame against it; ``map_snapshot_build`` and
             ``relocalization_search`` ms.
13. async_stream — ``SLAMSystem.run_stream_async`` at the default system
             configuration (BA, relocalization, snapshots on) and the
             default plane configurations (batch 4, adaptive flush, 16
             pending frames, drop-oldest) over the slam scene's 1 + 96
             frames rounded to uint8: 97 diagnostics, >= 93 of 96 poses, no
             dropped or failed frame, no ``feature_error`` or
             ``submit_rejected`` event, no breaker trip, the
             ``control_plane_report`` holds ``feature`` and ``tracking``,
             both kernels launched at batch 4 and 1 only, and the
             trajectory and diagnostics bit-equal to a second system driven
             through ``process_frame``; frames/s, median ``track_step`` ms,
             batches and mean batch fill, the device's busy share over 16
             frames (``torch.profiler``), peak memory.
14. async_ingest — the offline phase's 29 PNG files through
             ``run_kitti_sequence`` with ``ingestion="stream"`` and
             ``"async"``: trajectories and ``frame_diagnostics.json``
             bit-equal, ``ingestion_report`` 29 decoded and 0 failed; then
             ``AsyncIngestionPipeline`` with threads and with the process
             pool: packets in order and equal to the decoder's frames; ms
             per decoded frame.
15. native  — the native host library: its key and ``-march`` build, the
             host's toolchain (g++, whether libpng's and zlib's headers
             compile and link, ``-march=native``'s target); ``decode_gray``
             bit-equal to the numpy decoder on the offline phase's 29 PNG
             files, the same frames re-encoded with each filter type 1 to 4,
             an RGB frame and a PGM; both decoders on the committed PNG
             files with gamma chunks (``tests/data/png_gamma``) against the
             SHA-256 of libpng's output for each (this host has no libpng),
             ms per file; ms per frame of the numpy decoder and
             ``decode_gray`` per filter type and of ``NativeFrameLoader``
             with 1, 2 and 4 workers (in order, equal frames); the host
             matcher bit-equal to the card's ``match_descriptors`` on two
             bench frames' 2048 descriptors each (indices, best and second
             distances, column-best, the cross-checked set); host ms beside
             the card's CUDA-event and wall ms.
16. native_ingest — the 29 PNG files through ``run_kitti_sequence`` with
             ``ingestion="native"`` and ``"stream"`` (window 8):
             trajectories and ``frame_diagnostics.json`` bit-equal, the
             native ``ingestion_report`` with 29 decoded and 0 failed;
             frames/s of both.
17. eval    — the port's ``run_evaluation`` over both runs against the
             scene's ground truth (ATE/RPE equal), ``execute_gate`` of the
             native run against a baseline written from the stream run
             (pass), ``score_run``, determinism validation of the two run
             directories (equal but for the native ingestion report),
             governance running the native run's evaluation as a budgeted
             subprocess against the stream run's numbers, and the readiness
             report with its digest.
18. animate — ``run_visual_slam`` with ``enable_animation=True`` at the
             offline phase's settings without loop closure: trajectory and
             ``offline_summary.json`` bit-equal to the offline phase's run
             without loops, the recorder holding the system's x/z once per
             frame; whether matplotlib was there to draw.
19. bow_index — ``DeviceBoWIndex`` with 50,000 seeded, L2-normalised
             histograms of a 256-word vocabulary (51 MB on the card), bulk
             loaded: 100 queries whose top-16 ids equal a float64 host
             ranking by (-score, frame id) wherever the host's scores
             differ by more than 1e-6, planted exact ties included; an index
             grown from capacity 1,024 by 4,096 ``add`` calls answers as a
             bulk load of the same rows; ms per query (CUDA events and
             wall), ms per ``add``, the matvec's own time (CUDA events over
             200 launches) beside its bound from its bytes, and a host numpy
             matvec's time.
20. accuracy — the four scenes of ``benchmarks/benchmark_accuracy_scenes.py``
             (copied here: that script imports the JAX package) with its
             settings: straight, yawing arc and noisy arc through
             ``SLAMSystem`` (seed 3, 512 features, 256 matches, 256
             hypotheses, fixed 2 px threshold, ``min_translation=0.05``
             where the script sets it), and the 29-frame out-and-back
             revisit written as a KITTI layout through ``run_visual_slam``
             with loops off and on; the ten metrics under the script's
             names, each beside its baseline and limit, judged by the
             port's ``compare_metrics`` against
             ``baselines/accuracy_scenes.json`` under
             ``configs/evaluation/accuracy_gate.json`` (both read as they
             are; ``regressed`` fails the script); then K1 and K2 held
             against their plain versions at every shape the phase
             launched them at that no earlier phase compared (240x320),
             with the same times and bounds as phases 3 and 4.
21. mesh    — ``mvslam_tpu_torch.parallel`` on logical meshes over
             ``cuda:0`` (one card: no multi-card scaling figure), each
             against its unsharded run: ``track_superwindow_meshed`` on the
             bench's 1 + 96 frames (window 16, the main path's
             configuration with ``mesh_invariant=True``) at 1, 2, 4 and 8
             slots — detections, descriptors, matches, counts and
             ``use_essential`` bit-equal to the unsharded pinned run, poses
             within 1e-3, all 96 frames tracked, two runs at 4 bit-equal;
             the default configuration's unsharded superwindow (pinned
             RANSAC at 512 matches by ``_auto_pinned``, plain H transfer
             votes) against the meshed run at 1 slot: choice, inlier
             counts and masks, scores, support share and poses equal on
             all 96 frames;
             ``batched_track_pairs`` over 8 bench pairs (features and
             matches bit-equal across sizes, poses within 1e-3);
             ``sharded_ransac_essential`` with 512 hypotheses on 2,048
             correspondences (bit-equal at every size and to the unsharded
             pinned call); ``run_bundle_adjustment_sharded`` on 5 poses x
             1,024 points at 1, 2, 4 (the reference's tolerances, two runs
             bit-equal); ``solve_problem_sharded`` on the pose_graph phase's
             graph at 1, 2, 4 (x within 1e-3, cost within 1e-3 relative,
             two runs bit-equal); ``DeviceBoWIndex`` over 4 slots on the
             bow_index phase's map (the host ranking's rule; grown equals
             bulk). frames/s, ms and peak memory per size; with more than
             one card, also one mesh over the distinct cards (reported).

Kernel launches are counted per path: the counts are set to 0 just
before each of main, slam, flow, slam_ba, offline, reloc, async_stream,
async_ingest (its async run), native_ingest (its native run), animate,
accuracy and mesh (its meshed superwindow and batched pairs) and read just
after (the
pose-graph solver, the index, and the mesh's RANSAC, BA and pose graph
run no hand kernel). The
wrappers also count their launches by shape, and the script fails if a path
launched a kernel at a shape at which phases 3 to 5 did not hold it against
its plain version. The wrappers count under a lock: in async_stream the
feature plane's assembler thread launches both kernels. The second-to-last line is the per-kernel JSON record (per route: event,
plain, device and yardstick times, the bound and the share of it reached);
the last line is ``{"ok": true, "device": {...}}``. Needs one CUDA device;
imports no JAX and nothing of the reference package.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import statistics
import struct
import subprocess
import sys
import threading
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
LK_BORDER_BAND = NUM_FEATURES // 3  # K2's LK points in the band where tiles clamp to the border
# The rendered scene of the slam and flow phases: 1 + 96 frames at the
# bench's 1226x370, 400 textured quads, the camera sliding 0.1 units along
# x and 0.02 along z per frame (the direction of render_scene's default
# trajectory, at half its speed, so the scene stays in view for 96 frames).
SCENE_FRAMES = 1 + 96
SCENE_POINTS = 400
SCENE_STEP = (0.1, 0.0, 0.02)
FLOW_FRAMES = 33
# The offline phase's scenes: out along x to the turn, then back over the
# same places, 0.25 per frame. 1 + 28 frames is the offline benchmark's own
# scene (benchmarks/benchmark_offline_pipeline.py, 29 frames), here at the
# port's full width; 1 + 60 frames is the longer one.
OFFLINE_FRAMES = 1 + 28
OFFLINE_LONG_FRAMES = 1 + 60
OFFLINE_STEP = 0.25
RELOC_LOSS_AT = 20
NATIVE_LOADER_WORKERS = (1, 2, 4)
# The async_stream phase: the slam scene's frames rounded to uint8, through
# run_stream_async; the busy share is profiled over a shorter stretch.
ASYNC_FRAMES = SCENE_FRAMES
PROFILED_FRAMES = 16
# The offline gate on the 29-frame scene, one that the JAX package's own
# full-width run meets (CPU: 0.0345 with loops, 0.0225 without): ATE with
# loops at most twice ATE without, and both below 0.05 (1.4% of the
# drive's 3.5-unit extent).
OFFLINE_ATE_RATIO = 2.0
OFFLINE_ATE_BOUND = 0.05
# The JAX package's ATE on the offline scenes, from CPU runs of its offline
# CLI (python -m mvslam_tpu.slam.offline, XLA:CPU, JAX_PLATFORMS=cpu, with
# this script's offline settings; ROADMAP Queue 3 has the recipe), printed
# beside the card's numbers with --long-offline.
REFERENCE_CPU_ATE = {
    "29": {"loops": 0.03445162067688552, "no_loops": 0.022546833005557838},
    "61": {"loops": 0.030660294272137185, "no_loops": 0.047713419973743086},
}
INDEX_ROWS = 50_000
INDEX_VOCAB = 256
INDEX_QUERIES = 100
INDEX_TOPK = 16
INDEX_GROWN_ROWS = 4096
ARTIFACTS = [
    "diagnostics/frame_diagnostics.json", "metrics/run_metrics.json", "reports/telemetry_summary.json",
    "run_metadata.json", "telemetry/events.json", "trajectories/estimated.npz",
]


_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; phase lines also carry the seconds since the start."""
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - _START, 1)}
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


EVENT_TIMED = []  # kernels whose device time came from CUDA events, not the profiler


def device_ms(fn, kernel: str | None = None, iters: int = 20) -> float:
    """Device time (ms) per call of ``fn``, mean over ``iters`` calls, from
    ``torch.profiler``: the duration of the CUDA kernels whose name contains
    ``kernel`` (exactly one per call), or of every device activity when
    ``kernel`` is None. The profiler now and then drops a record (seen on
    the H100: 19 of 20 launches), so each kernel's time is the mean over the
    launches it recorded, times its launches per call. A profile that shows
    no device time, or fewer than half of a kernel's launches, is taken
    again, three times in all. If all three are starved the time is taken
    with CUDA events around 200 back-to-back calls (an upper bound: it holds
    the host's launch time where the card finishes first) and the kernel is
    listed in ``EVENT_TIMED``. Raises if that yields nothing either."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        per_call_us, seen = 0.0, 0
        for event in prof.key_averages():
            if event.device_type == DeviceType.CUDA and event.count and (kernel is None or kernel in event.key):
                per_call_us += event.device_time_total / event.count * max(1, round(event.count / iters))
                seen += event.count
        if kernel is not None and seen > iters:
            raise AssertionError(f"profiler saw {seen} launches of {kernel} for {iters} calls")
        if per_call_us > 0.0 and (kernel is None or seen >= iters // 2):
            return per_call_us / 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(200):
        fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / 200
    if not ms > 0.0:
        raise AssertionError(f"no device time for {kernel or 'the call'}: the profiler saw "
                             f"{seen} of {iters} launches three times and the events read {ms}")
    EVENT_TIMED.append(kernel or "all device activity")
    return ms


def host_us_per_call(fn, calls: int = 1000) -> float:
    """Host microseconds per call of ``fn``: ``time.perf_counter_ns``
    around ``calls`` calls with no synchronisation in between (the card is
    synchronised before and after; a call that does less device work than
    host work never waits for it)."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / calls / 1e3


def bound(nbytes: float, ops: float = 0.0) -> dict:
    """The least time (ms) the card could take: bytes over HBM bandwidth or
    operations over the float32 peak, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "ops": int(ops)}


def with_share(record: dict) -> dict:
    record["bound_share"] = record["bound_ms"] / record["device_ms"]
    return record


# Shapes at which each kernel was held against its plain version, and the
# shapes each path launched it at: every launched shape must be a compared one.
COMPARED = {"fast_detect": set(), "extract_patches": set()}
LAUNCH_SHAPES = {}


def shape_label(shape) -> str:
    return f"{shape[0].replace('torch.', '')} {tuple(shape[1:])}"


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


NATIVE_BUILD = {}  # the native library's build, done beside nvcc, reported by phase_native


def phase_build() -> float:
    """nvcc builds the CUDA kernels while g++ builds the native host
    library (forced, so its time is a real compile), both from the sources
    in the checkout."""
    from mvslam_tpu_torch.core import cuda_build
    from mvslam_tpu_torch.native import build as native_build

    def build_native():
        t0 = time.perf_counter()
        NATIVE_BUILD["path"] = native_build.build(force=True)
        NATIVE_BUILD["seconds"] = time.perf_counter() - t0

    thread = threading.Thread(target=build_native, name="native-build")
    t0 = time.perf_counter()
    thread.start()
    cuda_build.load()
    seconds = time.perf_counter() - t0
    thread.join()
    if NATIVE_BUILD.get("path") is None:
        raise AssertionError("the native host library did not build (the compiler's stderr is logged above)")
    emit({"phase": "build", "seconds": seconds, "library": str(cuda_build.build().relative_to(REPO)),
          "native_library": str(NATIVE_BUILD["path"].relative_to(REPO)), "native_seconds": NATIVE_BUILD["seconds"]})
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
    COMPARED["fast_detect"].add((str(x.dtype), *x.shape))
    record = with_share({
        "route": label, "detections": int((det_k > 0).sum()), "bit_equal": True, "max_abs_err": err,
        "ms": median_ms(lambda: fast_detect(x, THRESHOLD, MARGIN)),
        "plain_ms": median_ms(lambda: fast_detect_plain(x, THRESHOLD, MARGIN)),
        "device_ms": device_ms(lambda: fast_detect(x, THRESHOLD, MARGIN), "fast_detect_kernel"),
        **k1_bound(x),
    })
    if x.shape[0] == 1:  # one frame: the launch path's host time is most of a call
        record["host_us_per_call"] = host_us_per_call(lambda: fast_detect(x, THRESHOLD, MARGIN))
    return record


def phase_k1(frames_u8, frames_f32):
    """K1 on the main path's uint8 window and bootstrap frame, on the slam
    path's float32 window (rendered frames: the kernel's f32 route), on one
    rendered frame (the flow path's call), on the offline pipeline's
    window of 8 uint8 frames, on the feature plane's batch of 4 uint8
    frames (run_stream_async) and on 2 (a superwindow's block on a mesh of
    8 slots, batched pairs on 4)."""
    routes = [k1_route(x) for x in (frames_u8[:16], frames_f32[:16], frames_u8[:1], frames_f32[:1], frames_u8[:8],
                                    frames_u8[:4], frames_u8[:2])]
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


AB_DIR = REPO / "mvslam_tpu_torch" / "_build" / "ab"


def build_variants(variants) -> dict:
    """Each ``(tag, source, {entry point: argtypes}, extra nvcc flags)`` of
    ``variants`` alone into its own library with ``-Xptxas -v``, one nvcc
    per source, all started together; returns {tag: (ctypes library, ptxas
    report lines)}."""
    from mvslam_tpu_torch.core import cuda_build

    AB_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, src, _, flags in variants:
        out = AB_DIR / f"lib{src.stem}_{tag}.so"
        cmd = [cuda_build.nvcc_path(), *cuda_build._NVCC_FLAGS, "-shared", *flags, "-Xptxas", "-v",
               "-o", str(out), str(src)]
        procs[tag] = (out, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True))
    built = {}
    try:
        stderrs = {tag: proc.communicate(timeout=600)[1] for tag, (_, proc) in procs.items()}
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for tag, src, entries, _ in variants:
        out, proc = procs[tag]
        stderr = stderrs[tag]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{stderr[-4000:]}")
        lib = ctypes.CDLL(str(out))
        for name, argtypes in entries.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        report = [line.split(":", 1)[-1].strip() for line in stderr.splitlines()
                  if line.startswith("ptxas info") or "spill" in line]
        built[tag] = (lib, report)
    return built


def phase_k1_ab(old_src: Path, frames_u8, frames_f32):
    """The earlier K1 (``old_src``) against the current one in one process:
    both bit-equal to the plain version, device times in turns (old, new,
    new, old) on the uint8 and float32 routes at B = 16 and B = 1."""
    import torch

    from mvslam_tpu_torch.ops.cuda_fast import fast_detect_plain

    from mvslam_tpu_torch.core import cuda_build

    entries = {name: cuda_build._SIGNATURES[name] for name in ("fast_detect_u8", "fast_detect_f32")}
    built = build_variants([(tag, src, entries, ()) for tag, src in
                            (("old", old_src), ("new", REPO / "mvslam_tpu_torch" / "csrc" / "fast_detect.cu"))])
    libs = {tag: lib for tag, (lib, _) in built.items()}
    emit({"phase": "k1_ab_build", "ptxas": {tag: report for tag, (_, report) in built.items()}})

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
    COMPARED["extract_patches"].add((str(out_dtype), *image.shape, xy.shape[1]))
    record = with_share({
        "route": label, "image": list(image.shape), "points": int(xy.shape[1]), "bit_equal": True, "max_abs_err": err,
        "ms": median_ms(lambda: extract_patches(image, xy, out_dtype=out_dtype)),
        "plain_ms": median_ms(lambda: extract_patches_plain(image, xy, out_dtype=out_dtype)),
        "device_ms": device_ms(lambda: extract_patches(image, xy, out_dtype=out_dtype), "extract_patches_kernel"),
        "library_ms": median_ms(gather), "library_device_ms": device_ms(gather),
        **k2_bound(image, xy, out_dtype),
    })
    if image.shape[0] == 1:  # one frame: the launch path's host time is most of a call
        record["host_us_per_call"] = host_us_per_call(lambda: extract_patches(image, xy, out_dtype=out_dtype))
    return record


def k2_inputs(frames, n: int, gen) -> tuple:
    """K2's BRIEF inputs from (B, H, W) ``frames`` on the card: their blur,
    and ``n`` seeded points per frame spilling 20 px past every border
    (clamped tiles), an eighth of them on exact .5 coordinates (round half
    to even) and four at the corners."""
    import torch

    from mvslam_tpu_torch.ops.image import gaussian_blur

    image = gaussian_blur(frames.to(torch.float32), sigma=2.0, radius=4)
    b, h, w = image.shape
    xy = torch.rand((b, n, 2), generator=gen) * torch.tensor([w + 40.0, h + 40.0]) - 20.0
    xy[:, : n // 8] = torch.round(xy[:, : n // 8]) + 0.5
    xy[:, n // 8 : n // 8 + 4] = torch.tensor([[-7.0, -3.0], [w + 5.0, h + 9.0], [w - 1.0, 0.0], [0.0, h - 1.0]])
    return image, xy.to(frames.device)


def k2_lk_inputs(frames_u8) -> list:
    """K2's LK inputs: [(shape, image, points)] at LK's three pyramid levels
    of one blurred bench frame, integer corners with a third of them in the
    band where the tile clamps to the border."""
    import torch

    from mvslam_tpu_torch.ops.image import downsample2, gaussian_blur

    image = gaussian_blur(frames_u8[:1].to(torch.float32), sigma=1.5, radius=2)
    gen = torch.Generator(device="cpu").manual_seed(1)
    levels = []
    for shape in LK_SHAPES:
        while tuple(image.shape) != shape:
            image = downsample2(image)
        b, h, w = shape
        # LK asks for tiles at integer corners floor(p) + shift.
        xy = torch.floor(torch.rand((b, NUM_FEATURES, 2), generator=gen) * torch.tensor([w + 0.0, h + 0.0]))
        xy[:, :LK_BORDER_BAND] = torch.floor(
            torch.rand((b, LK_BORDER_BAND, 2), generator=gen) * torch.tensor([w + 60.0, h + 60.0]) - 30.0
        )
        levels.append((shape, image, xy.to(image.device)))
    return levels


def phase_k2(frames_u8):
    """K2's BRIEF route: the blurred (16, 370, 1226) window, 2048 points,
    bf16 tiles (float32 tiles checked too); then the same at 8 frames, at
    4, at 2 and at one."""
    import torch

    from mvslam_tpu_torch.ops.cuda_patches import extract_patches, extract_patches_plain

    gen = torch.Generator(device="cpu").manual_seed(0)
    image, xy = k2_inputs(frames_u8[:16], NUM_FEATURES, gen)
    b = image.shape[0]
    got = extract_patches(image, xy, out_dtype=torch.float32)
    ref = extract_patches_plain(image, xy, out_dtype=torch.float32)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError("K2 extract_patches (float32 tiles) disagrees with its plain version")
    brief = k2_route(image, xy, torch.bfloat16, "bf16 tiles, BRIEF (16, 370, 1226)")
    # The offline pipeline's window of 8 frames, the feature plane's batch
    # of 4, a meshed block of 2, and the single frame of a bootstrap or a
    # window-1 run.
    routes = [brief] + [k2_route(image[:b], xy[:b], torch.bfloat16, f"bf16 tiles, BRIEF ({b}, 370, 1226)")
                        for b in (8, 4, 2, 1)]
    record = {
        "name": "extract_patches", "route": "cuda", "source": "mvslam_tpu_torch/csrc/extract_patches.cu",
        "replaces": "mvslam_tpu/ops/pallas_patches.py:85",
        **{k: brief[k] for k in ("max_abs_err", "ms", "plain_ms", "device_ms", "bound_ms", "bound_by",
                                 "bound_share", "library_ms", "library_device_ms")},
        "library": "one advanced-index gather of the f32 image's unfold windows at precomputed starts (f32 tiles)",
        "routes": routes,
    }
    emit({"phase": "k2", "routes": routes})
    return record


def phase_k2_lk(frames_u8):
    """K2 with float32 output at the LK pyramid's shapes, bit-equal to the
    plain version; the image is LK's blurred pyramid of one bench frame."""
    import torch

    levels = [{**k2_route(image, xy, torch.float32, f"f32 tiles, LK {shape}"), "border_band": LK_BORDER_BAND}
              for shape, image, xy in k2_lk_inputs(frames_u8)]
    emit({"phase": "k2_lk", "levels": levels})
    return levels


# K2's designs that lost to the library's kernel, each built with its
# -DDESIGN (csrc/ab/extract_patches_designs.cu), and the floor kernel.
K2_AB_SOURCES = REPO / "mvslam_tpu_torch" / "csrc" / "ab"
K2_DESIGNS = {"staged_vector": 1, "staged_bulk": 2, "rows_in_registers": 3, "shared_window": 4,
              "streaming_stores": 5}
# Counters of the earlier launch path, which the host-time A/B replays.
EARLIER_COUNTS = collections.Counter()
EARLIER_LOCK = threading.Lock()


def earlier_k2_path(lib, image, xy, out_dtype=None):
    """K2's wrapper as it was before the shared launch path
    (``cuda_build.launch``), step for step, launching ``lib``'s kernel: six
    checks, two ``.contiguous()``, ``torch.empty``, a ``torch.cuda.device``
    switch, ``current_stream()``, the ctypes call, a lock and a Counter
    keyed with ``str(out_dtype)``. The host-time A/B's earlier side."""
    import torch

    from mvslam_tpu_torch.core import cuda_build

    if image.device.type == "cpu":
        raise ValueError("the earlier launch path is timed on the card only")
    if not image.is_cuda or xy.device != image.device:
        raise ValueError(f"extract_patches: image on {image.device}, xy on {xy.device}")
    if image.ndim != 3 or xy.ndim != 3 or xy.shape[0] != image.shape[0] or xy.shape[2] != 2:
        raise ValueError(f"extract_patches: {tuple(image.shape)} and {tuple(xy.shape)}")
    if image.dtype != torch.float32 or xy.dtype != torch.float32:
        raise ValueError(f"extract_patches: needs float32 image and xy, got {image.dtype}, {xy.dtype}")
    out_dtype = out_dtype or torch.float32
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"extract_patches: out_dtype must be float32 or bfloat16, got {out_dtype}")
    b, h, w = image.shape
    n = xy.shape[1]
    if h < 32 or w < 32:
        raise ValueError(f"extract_patches: image {h}x{w} is smaller than a 32px tile")
    image = image.contiguous()
    xy = xy.contiguous()
    out = torch.empty((b, n, 1024), dtype=out_dtype, device=image.device)
    if b * n == 0:
        return out
    name = "extract_patches_f32" if out_dtype == torch.float32 else "extract_patches_bf16"
    cuda_build.load()  # it looked the library up on every call
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(image.data_ptr(), xy.data_ptr(), out.data_ptr(), b, h, w, n, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
    with EARLIER_LOCK:
        EARLIER_COUNTS["extract_patches"] += 1
        EARLIER_COUNTS[(str(out_dtype), b, h, w, n)] += 1
    return out


def earlier_k1_path(image, threshold, margin):
    """K1's wrapper as it was before the shared launch path, step for step
    (the kernel is the current one): the host-time A/B's earlier side."""
    import torch

    from mvslam_tpu_torch.core import cuda_build

    if image.device.type == "cpu":
        raise ValueError("the earlier launch path is timed on the card only")
    if not image.is_cuda:
        raise ValueError(f"fast_detect: unsupported device {image.device}")
    if image.ndim != 3:
        raise ValueError(f"fast_detect: expected (B, H, W), got {tuple(image.shape)}")
    if margin < 4:
        raise ValueError("fast_detect: margin must be >= 4 (zero taps vs wrap-around)")
    if image.dtype == torch.uint8 and float(threshold).is_integer() and threshold >= 0:
        name, thr = "fast_detect_u8", int(threshold)
    else:
        name, thr = "fast_detect_f32", float(threshold)
        image = image.to(torch.float32)
    image = image.contiguous()
    b, h, w = image.shape
    det = torch.empty((b, h, w), dtype=torch.float32, device=image.device)
    raw = torch.empty_like(det)
    if b * h * w == 0:
        return det, raw
    lib = cuda_build.load()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(image.data_ptr(), det.data_ptr(), raw.data_ptr(), b, h, w, thr, int(margin), stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
    with EARLIER_LOCK:
        EARLIER_COUNTS["fast_detect"] += 1
        EARLIER_COUNTS[(str(image.dtype), b, h, w)] += 1
    return det, raw


def k2_ab_rows(frames_u8) -> list:
    """Every K2 row of the bring-up table as [(label, image, points, output
    dtype)]: BRIEF bf16 at 16, 8, 4, 2 and 1 frames of 370x1226 (the K2
    phase's inputs), at 8 and 1 frames of 240x320 with 2048 and 512 points
    (the accuracy phase's shapes, on its straight scene's renders), LK f32
    at its three pyramid levels (the k2_lk phase's inputs)."""
    import torch

    from mvslam_tpu_torch.data.synthetic import render_scene

    gen = torch.Generator(device="cpu").manual_seed(0)
    image, xy = k2_inputs(frames_u8[:16], NUM_FEATURES, gen)
    rows = [(f"bf16 tiles, BRIEF ({b}, 370, 1226)", image[:b], xy[:b], torch.bfloat16) for b in (16, 8, 4, 2, 1)]
    small = render_scene()[0]
    gen = torch.Generator(device="cpu").manual_seed(2)
    for n in (NUM_FEATURES, 512):
        for b in (8, 1):
            image, xy = k2_inputs(stacked(small, b, frames_u8.device), n, gen)
            rows.append((f"bf16 tiles, BRIEF ({b}, 240, 320), {n} points", image, xy, torch.bfloat16))
    rows += [(f"f32 tiles, LK {shape}", image, xy, torch.float32) for shape, image, xy in k2_lk_inputs(frames_u8)]
    return rows


def k2_ab_row(libs, image, xy, out_dtype, order) -> dict:
    """One K2 row of the A/B: each library of ``order`` bit-equal to the
    plain version, then device ms in turns (``order``; each library's time
    is the median of its turns, since a profile now and then reads ~10%
    low), the floor kernel's device ms, the bound; at one frame also the
    host µs per call of the earlier launch path on ``libs["old"]`` against
    the wrapper's, in turns."""
    import torch

    from mvslam_tpu_torch.ops.cuda_patches import PATCH_PIXELS, extract_patches, extract_patches_plain

    b, h, w = image.shape
    n = xy.shape[1]
    name = "extract_patches_bf16" if out_dtype == torch.bfloat16 else "extract_patches_f32"
    bits = torch.int16 if out_dtype == torch.bfloat16 else torch.int32
    out = torch.empty((b, n, PATCH_PIXELS), dtype=out_dtype, device=image.device)
    floor_out = torch.empty((b, n, PATCH_PIXELS), dtype=torch.float32, device=image.device)

    def run(tag):
        err = getattr(libs[tag], name)(image.data_ptr(), xy.data_ptr(), out.data_ptr(), b, h, w, n,
                                       torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"K2 ({tag}) launch failed with cudaError_t {err}")

    def floor():
        err = libs["floor"].k2_floor(xy.data_ptr(), floor_out.data_ptr(), b, n, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"K2's floor kernel launch failed with cudaError_t {err}")

    ref = extract_patches_plain(image, xy, out_dtype=out_dtype).view(bits)
    tags = list(dict.fromkeys(order))
    for tag in tags:
        out.fill_(float("nan"))  # a tile the kernel leaves unwritten cannot pass for a right one
        run(tag)
        torch.cuda.synchronize()
        if not torch.equal(out.view(bits), ref):
            raise AssertionError(f"K2 ({tag}, {tuple(image.shape)}, {n} points) disagrees with its plain version")
    times = {tag: [] for tag in tags}
    for tag in order:
        times[tag].append(device_ms(lambda: run(tag), "extract_patches_kernel"))
    bnd = k2_bound(image, xy, out_dtype)
    median = {tag: statistics.median(v) for tag, v in times.items()}
    record = {
        "bit_equal": True, "image": [b, h, w], "points": n, "device_ms": times, "median_device_ms": median,
        "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
        "bound_share": {tag: bnd["bound_ms"] / ms for tag, ms in median.items()},
        "floor_device_ms": device_ms(floor, "k2_floor_kernel"),
        "old_over_new": median["old"] / median["new"],
    }
    if b == 1:
        host = {"earlier_path": [], "wrapper": []}
        for which in ("earlier_path", "wrapper", "wrapper", "earlier_path"):
            fn = ((lambda: earlier_k2_path(libs["old"], image, xy, out_dtype)) if which == "earlier_path"
                  else (lambda: extract_patches(image, xy, out_dtype=out_dtype)))
            host[which].append(host_us_per_call(fn))
        record["host_us_per_call"] = host
    return record


def phase_k2_ab(old_src: Path, frames_u8):
    """The earlier K2 (``old_src``) against the current one and the designs
    that lost to it (``K2_DESIGNS``) in one process: each built alone with
    ``-Xptxas -v`` beside the floor kernel, each bit-equal to the plain
    version at every K2 row, device times in turns (old, new, the designs,
    then back) with the floor beside them; host µs per call of the earlier
    launch path against the wrappers' for K2 at one frame and for K1 at
    (1, 370, 1226) on both routes."""
    import torch

    from mvslam_tpu_torch.core import cuda_build
    from mvslam_tpu_torch.ops.cuda_fast import fast_detect

    entries = {name: cuda_build._SIGNATURES[name] for name in ("extract_patches_f32", "extract_patches_bf16")}
    designs = K2_AB_SOURCES / "extract_patches_designs.cu"
    built = build_variants([
        ("old", old_src, entries, ()),
        ("new", REPO / "mvslam_tpu_torch" / "csrc" / "extract_patches.cu", entries, ()),
        *((tag, designs, entries, (f"-DDESIGN={number}",)) for tag, number in K2_DESIGNS.items()),
        ("floor", K2_AB_SOURCES / "extract_patches_floor.cu",
         {"k2_floor": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}, ()),
    ])
    libs = {tag: lib for tag, (lib, _) in built.items()}
    emit({"phase": "k2_ab_build", "ptxas": {tag: report for tag, (_, report) in built.items()}})
    tags = ["old", "new", *K2_DESIGNS]
    order = (*tags, *reversed(tags)) * 2
    rows = [{"route": label, **k2_ab_row(libs, image, xy, dt, order)} for label, image, xy, dt in k2_ab_rows(frames_u8)]
    k1_host = []
    for x in (frames_u8[:1], frames_u8[:1].to(torch.float32)):
        times = {"earlier_path": [], "wrapper": []}
        for which in ("earlier_path", "wrapper", "wrapper", "earlier_path"):
            fn = earlier_k1_path if which == "earlier_path" else fast_detect
            times[which].append(host_us_per_call(lambda: fn(x, THRESHOLD, MARGIN)))
        k1_host.append({"route": k1_label(x), "host_us_per_call": times})
    emit({"phase": "k2_ab", "old": str(old_src), "rows": rows, "k1_host": k1_host})


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
    cuda_fast.fast_detect.launch_shapes.clear()
    cuda_patches.extract_patches.launch_shapes.clear()


def read_launches(path: str):
    """The kernels' launch counts since ``reset_launches``; the shapes they
    were launched at are kept under ``path`` for the kernels line."""
    from mvslam_tpu_torch.ops import cuda_fast, cuda_patches

    LAUNCH_SHAPES[path] = {
        "fast_detect": dict(cuda_fast.fast_detect.launch_shapes),
        "extract_patches": dict(cuda_patches.extract_patches.launch_shapes),
    }
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
    launches = read_launches("slam")
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
        launches = read_launches("flow")
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
            launches = read_launches("slam_ba")
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


def offline_scene(tag: str, num_frames: int):
    """An out-and-back revisit scene as a KITTI layout on disk: (dataset
    root, ground-truth file, seconds to render, seconds to write)."""
    import numpy as np

    from mvslam_tpu_torch.data.synthetic import render_scene, write_kitti_sequence

    half = (num_frames - 1) // 2

    def out_and_back(i):
        x = OFFLINE_STEP * i if i <= half else OFFLINE_STEP * (2 * half - i)
        return np.eye(3), np.array([x, 0.0, 0.0])

    t0 = time.perf_counter()
    frames, gt, intrinsics, _ = render_scene(
        num_frames=num_frames, h=370, w=1226, seed=2, n_pts=SCENE_POINTS, noise=6.0, traj_fn=out_and_back,
    )
    t1 = time.perf_counter()
    root, gt_path = write_kitti_sequence(REPO / "runs" / "chip_smoke" / f"offline_kitti_{tag}", frames, gt, intrinsics)
    return root, gt_path, t1 - t0, time.perf_counter() - t1


def span_ms(run_dir: Path, name: str) -> dict:
    """Count and median duration (ms) of the telemetry events called
    ``name`` in a run."""
    events = json.loads((run_dir / "telemetry" / "events.json").read_text())
    ms = [1e3 * e["duration_s"] for e in events if e["name"] == name]
    return {"calls": len(ms), "median": statistics.median(ms) if ms else None}


def edge_stats(edges) -> dict:
    """Count, and median and largest length (in steps of the keyframe
    chain), error of that length against the scene's, and rotation of a set
    of accepted loop edges."""
    if not edges:
        return {"count": 0}
    lengths = [e["length_in_chain_steps"] for e in edges]
    angles = [e["rotation_deg"] for e in edges]
    errors = [abs(e["length_in_chain_steps"] - e["true_length_in_chain_steps"]) for e in edges]
    return {"count": len(edges), "length_in_chain_steps": {"median": statistics.median(lengths), "max": max(lengths)},
            "length_error_in_chain_steps": {"median": statistics.median(errors), "max": max(errors)},
            "rotation_deg": {"median": statistics.median(angles), "max": max(angles)}}


def offline_config(root, gt_path, run_id: str, **kw):
    """The offline phase's ``SLAMRunConfig``: the offline benchmark's
    settings (seed 3, loop gap 12, similarity 0.7, 25 inliers, ground
    truth), all else default."""
    from mvslam_tpu_torch.slam.offline import SLAMRunConfig

    return SLAMRunConfig(
        input_path=root, input_kind="kitti", sequence="00", output_root=REPO / "runs" / "chip_smoke", seed=3,
        ground_truth_path=gt_path, loop_min_frame_gap=12, loop_similarity_threshold=0.7, loop_min_inliers=25,
        run_id=run_id, **kw,
    )


def offline_runs(tag: str, num_frames: int, variants, dev):
    """``run_visual_slam`` over one scene, once per (name, loop closure)
    variant; kernel launches and peak memory are those of the first run."""
    import numpy as np
    import torch

    from mvslam_tpu_torch.slam import offline
    from mvslam_tpu_torch.slam.offline import run_visual_slam

    root, gt_path, render_s, write_s = offline_scene(tag, num_frames)
    # Every accepted loop edge of the first run beside what the scene says
    # of it: the camera never turns and moves one step per frame along a
    # line, out and back, so an edge's true length is the difference of its
    # two frames' places, 0 where frame q revisits frame (num_frames - 1) - q.
    edges, verify_loop = [], offline._verify_loop

    def recording_verify(system, kf_a, kf_b, config, kf_a_next=None, record=None):
        out = verify_loop(system, kf_a, kf_b, config, kf_a_next=kf_a_next, record=record)
        if out is not None:
            steps = [np.linalg.norm(b.pose[:3, 3] - a.pose[:3, 3])
                     for a, b in zip(system.keyframes.keyframes[:-1], system.keyframes.keyframes[1:])]
            half = (num_frames - 1) // 2
            true_steps = abs(min(int(kf_a.frame_id), 2 * half - int(kf_a.frame_id))
                             - min(int(kf_b.frame_id), 2 * half - int(kf_b.frame_id)))
            edges.append({
                "exact_revisit": true_steps == 0,
                "length_in_chain_steps": float(np.linalg.norm(out[0][:3, 3]) / np.median(steps)),
                "true_length_in_chain_steps": true_steps,
                "rotation_deg": float(np.degrees(np.arccos(np.clip((np.trace(out[0][:3, :3]) - 1) / 2, -1, 1)))),
            })
        return out
    runs, tracked = {}, num_frames - 1
    for name, loops in variants:
        first = not runs
        if first:
            reset_launches()
            torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mock.patch.object(offline, "_verify_loop", recording_verify if first else verify_loop):
            summary = run_visual_slam(
                offline_config(root, gt_path, f"smoke_offline_{tag}_{name}", enable_loop_closure=loops), device=dev
            )
        elapsed = time.perf_counter() - t0
        run_dir = Path(summary["run_dir"])
        diags = json.loads((run_dir / "diagnostics" / "frame_diagnostics.json").read_text())
        poses = sum(bool(d["pose_success"]) for d in diags[1:])
        if len(diags) != num_frames or poses < tracked - 3:
            raise AssertionError(f"offline ({tag}, {name}) posed {poses} of {tracked} frames")
        runs[name] = {"summary": summary, "run_dir": run_dir, "elapsed": elapsed, "poses": poses}
        if first:
            runs[name].update(launches=read_launches("offline" if tag == "bench" else f"offline_{tag}"), peak=torch.cuda.max_memory_allocated(dev))
    with_loops = next(run for (name, loops), run in zip(variants, runs.values()) if loops)
    if len(with_loops["summary"]["loops_accepted"]) < 1:
        raise AssertionError(f"offline ({tag}): no loop accepted ({len(with_loops['summary']['loops_detected'])} detected)")
    report = {
        "frames": num_frames, "trajectory": f"x = {OFFLINE_STEP} * i out to frame {tracked // 2} and back",
        "render_s": render_s, "write_png_s": write_s,
        "seconds": {name: run["elapsed"] for name, run in runs.items()},
        "fps": {name: tracked / run["elapsed"] for name, run in runs.items()},
        "poses": {name: run["poses"] for name, run in runs.items()},
        "ATE_RMSE": {name: run["summary"]["metrics"]["ATE_RMSE"] for name, run in runs.items()},
        "keyframes": with_loops["summary"]["keyframes"],
        "loops_detected": len(with_loops["summary"]["loops_detected"]),
        "loops_accepted": len(with_loops["summary"]["loops_accepted"]),
        "bow_ms_per_keyframe": span_ms(with_loops["run_dir"], "bow_keyframe"),
        "loop_geometry_ms": span_ms(with_loops["run_dir"], "loop_geometry"),
        "pose_graph_ms_per_accepted_loop": span_ms(with_loops["run_dir"], "loop_pose_graph"),
        "local_ba_ms": span_ms(with_loops["run_dir"], "local_ba"),
        "exact_revisit_edges": edge_stats([e for e in edges if e["exact_revisit"]]),
        "other_edges": edge_stats([e for e in edges if not e["exact_revisit"]]),
    }
    return runs, report


def phase_offline(dev, long_scene: bool):
    """``run_visual_slam`` from image files: the offline benchmark's scene
    with loops twice and without; with ``long_scene`` also a 1 + 60-frame
    drive of it with and without loops."""
    import numpy as np

    from mvslam_tpu_torch.loopclosure.persistent_map import load_map_snapshot

    phase_t0 = time.perf_counter()
    runs, report = offline_runs("bench", OFFLINE_FRAMES, (("loops", True), ("loops_again", True), ("no_loops", False)), dev)
    first, again = runs["loops"], runs["loops_again"]
    ate, ate_plain = report["ATE_RMSE"]["loops"], report["ATE_RMSE"]["no_loops"]
    if not (ate <= OFFLINE_ATE_RATIO * ate_plain and max(ate, ate_plain) < OFFLINE_ATE_BOUND):
        raise AssertionError(f"offline: ATE with loops {ate}, without {ate_plain}: not within "
                             f"{OFFLINE_ATE_RATIO}x of each other below {OFFLINE_ATE_BOUND}")
    if (first["run_dir"] / "offline_summary.json").read_bytes() != (again["run_dir"] / "offline_summary.json").read_bytes():
        raise AssertionError("offline: the two equal runs' offline_summary.json differ")
    ta, tb = (np.load(r["run_dir"] / "trajectories" / "estimated.npz") for r in (first, again))
    if sorted(ta.files) != sorted(tb.files) or not all(np.array_equal(ta[k], tb[k]) for k in ta.files):
        raise AssertionError("offline: the two equal runs' trajectories differ")
    maps = first["run_dir"] / "maps"
    snapshot = load_map_snapshot(maps / "map_snapshot_arrays.npz", maps / "map_snapshot_metadata.json")  # verifies the digest
    stored = json.loads((maps / "map_snapshot_metadata.json").read_text())["digest"]
    if snapshot.digest() != stored or len(snapshot.keyframes) != first["summary"]["keyframes"]:
        raise AssertionError("offline: the persisted map snapshot does not reload as written")

    # The longer scene is measured and reported, not gated: accepted loop
    # edges between places that are not revisits can raise ATE, in both
    # packages (ROADMAP Queue 3).
    long_report = None
    if long_scene:
        _, long_report = offline_runs("long", OFFLINE_LONG_FRAMES, (("loops", True), ("no_loops", False)), dev)
        long_report["reference_cpu_ATE_RMSE"] = REFERENCE_CPU_ATE[str(OFFLINE_LONG_FRAMES)]
    emit({
        "phase": "offline", "shape": [370, 1226], "n_pts": SCENE_POINTS, "noise": 6.0, "window": 8,
        **report, "ATE_gate": f"loops <= {OFFLINE_ATE_RATIO} x no_loops, both < {OFFLINE_ATE_BOUND}",
        "reference_cpu_ATE_RMSE": REFERENCE_CPU_ATE[str(OFFLINE_FRAMES)],
        "bit_equal_runs": True, "snapshot_keyframes": len(snapshot.keyframes),
        "snapshot_digest_verified": True, "peak_mem_bytes": int(first["peak"]), "launches": first["launches"],
        "long_scene": long_report and {**long_report, "ATE_gate": "reported, not gated"},
        "phase_seconds": time.perf_counter() - phase_t0,
    })
    return first["launches"], runs["no_loops"]["run_dir"]


def phase_reloc(scene, dev):
    """The default configuration with an injected tracking loss: a live
    relocalization, then one against the reloaded snapshot."""
    import numpy as np
    import torch

    from mvslam_tpu_torch.slam.api import SLAMSystem, SLAMSystemConfig

    phase_t0 = time.perf_counter()
    frames, _, (fx, fy, cx, cy) = scene
    frames = frames[:FLOW_FRAMES]

    def run(run_id, snapshot_paths=None):
        cfg = SLAMSystemConfig(run_id=run_id, output_root=REPO / "runs" / "chip_smoke", fx=fx, fy=fy, cx=cx, cy=cy)
        if not (cfg.enable_local_ba and cfg.enable_relocalization and cfg.persist_map_snapshot):
            raise AssertionError("the default configuration switches a stage off")
        system = SLAMSystem(cfg, device=dev)
        if snapshot_paths is not None:
            system.load_map_snapshot(snapshot_paths["arrays"], snapshot_paths["metadata"])
        system.inject_tracking_loss(RELOC_LOSS_AT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        diags = system.run_sequence(frames, window=1)
        elapsed = time.perf_counter() - t0
        return system, diags, system.finalize_run(), elapsed

    reset_launches()
    system, diags, result, elapsed = run("smoke_reloc")
    launches = read_launches("reloc")
    lost = diags[RELOC_LOSS_AT]
    if not (lost.injected_loss and lost.relocalized and not lost.pose_success) or result.num_relocalizations < 1:
        raise AssertionError(f"reloc: frame {RELOC_LOSS_AT} gave {lost.to_dict()}")
    est = np.stack(system.trajectory.poses)[:, :3, 3]
    steps = np.diff(est[RELOC_LOSS_AT:], axis=0)
    good_dirs = float((steps @ np.asarray(SCENE_STEP) > 0).mean())
    if not np.isfinite(est).all() or good_dirs <= 0.7:
        raise AssertionError(f"reloc: direction of travel after the loss consistent on only {good_dirs:.2f} of the steps")
    if result.map_snapshot_paths is None or not all(p.exists() for p in result.map_snapshot_paths.values()):
        raise AssertionError("reloc: finalize_run persisted no map snapshot")

    second, diags2, result2, _ = run("smoke_reloc_reloaded", result.map_snapshot_paths)
    if not diags2[RELOC_LOSS_AT].relocalized or result2.num_relocalizations < 1:
        raise AssertionError(f"reloc: no relocalization against the reloaded snapshot: {diags2[RELOC_LOSS_AT].to_dict()}")
    if any(e.name == "map_snapshot_build" for e in second.telemetry.events()):
        raise AssertionError("reloc: the second system built a snapshot instead of using the loaded one")

    def spans(sys_, name):
        return [1e3 * e.duration_s for e in sys_.telemetry.events() if e.name == name]

    search = [e for e in system.telemetry.events() if e.name == "relocalization_search"]
    emit({
        "phase": "reloc", "frames": len(diags), "loss_at": RELOC_LOSS_AT, "window": 1,
        "poses": sum(d.pose_success for d in diags[1:]), "keyframes": result.num_keyframes,
        "relocalizations": result.num_relocalizations, "matched": search[0].metadata if search else None,
        "good_direction_share_after_loss": good_dirs, "fps": (len(diags) - 1) / elapsed, "elapsed_s": elapsed,
        "map_snapshot_build_ms": spans(system, "map_snapshot_build"),
        "relocalization_search_ms": spans(system, "relocalization_search"),
        "reloaded_snapshot_keyframes": len(second._map_snapshot.keyframes),
        "reloaded_relocalization_search_ms": spans(second, "relocalization_search"),
        "snapshot": sorted(p.name for p in result.map_snapshot_paths.values()), "launches": launches,
        "phase_seconds": time.perf_counter() - phase_t0,
    })
    return launches


def stripped_diagnostics(diags) -> list:
    """Frame diagnostics without their correlation ids (which hash the run id)."""
    return [{k: v for k, v in d.items() if k != "correlation_id"} for d in diags]


def phase_async_stream(scene, dev):
    """``SLAMSystem.run_stream_async`` at the default system and plane
    configurations over the slam scene rounded to uint8, against a second
    system driven through ``process_frame`` over the same frames; then a
    shorter profiled run for the device's busy share."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
    from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
    from mvslam_tpu_torch.runtime.feature_plane import FeatureControlConfig
    from mvslam_tpu_torch.runtime.frame_stream import packets_from_arrays
    from mvslam_tpu_torch.runtime.tracking_plane import TrackingControlConfig
    from mvslam_tpu_torch.slam.api import SLAMSystem, SLAMSystemConfig

    phase_t0 = time.perf_counter()
    frames, _, (fx, fy, cx, cy) = scene
    frames = [np.clip(np.round(f), 0, 255).astype(np.uint8) for f in frames[:ASYNC_FRAMES]]

    def system(run_id):
        cfg = SLAMSystemConfig(
            run_id=run_id, output_root=REPO / "runs" / "chip_smoke", seed=0, fx=fx, fy=fy, cx=cx, cy=cy,
            feature=FeaturePipelineConfig(num_features=NUM_FEATURES, max_matches=512),
            pose=RobustPoseEstimatorConfig(num_hypotheses=512),
        )
        if not (cfg.enable_local_ba and cfg.enable_relocalization and cfg.persist_map_snapshot):
            raise AssertionError("async_stream: the default configuration switches a stage off")
        return SLAMSystem(cfg, device=dev)

    if FeatureControlConfig() != FeatureControlConfig(batch_size=4, flush_timeout_s=None) or TrackingControlConfig().max_pending != 16:
        raise AssertionError("async_stream: the plane defaults are not batch 4, adaptive flush, 16 pending")
    live = system("smoke_async_stream")
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    diags = live.run_stream_async(packets_from_arrays(frames))
    elapsed = time.perf_counter() - t0
    launches = read_launches("async_stream")
    peak = torch.cuda.max_memory_allocated(dev)
    report = live.store.load_report("control_plane_report")
    snaps = report["snapshots"]

    if set(snaps) != {"feature", "tracking"}:
        raise AssertionError(f"async_stream: control_plane_report holds {sorted(snaps)}")
    bad_events = [e for e in report["events"] if e["type"] in ("feature_error", "submit_rejected", "frame_dropped")]
    dropped = [(d.frame_id, d.failure_reason) for d in diags
               if d.failure_reason in ("feature_error", "deadline_expired", "buffer_overflow", "circuit_breaker_open")]
    feature, tracking = snaps["feature"], snaps["tracking"]
    if (bad_events or dropped or feature["failed"] or feature["rejected"] or feature["breaker_trips"]
            or tracking["dropped"] or tracking["breaker_trips"]):
        raise AssertionError(f"async_stream: frames lost: {dropped}, events {bad_events[:5]}, "
                             f"feature {feature}, tracking {tracking}")
    poses = sum(d.pose_success for d in diags[1:])
    if len(diags) != ASYNC_FRAMES or poses < ASYNC_FRAMES - 1 - 3:
        raise AssertionError(f"async_stream: {len(diags)} diagnostics, {poses} poses: "
                             f"{[(d.frame_id, d.failure_reason) for d in diags if not d.pose_success]}")
    for name, shapes in LAUNCH_SHAPES["async_stream"].items():
        batches = sorted({shape[1] for shape in shapes})
        if batches != [1, 4]:
            raise AssertionError(f"async_stream: {name} launched at batch sizes {batches}, not 1 and 4")

    single = system("smoke_async_single")
    t0 = time.perf_counter()
    single_diags = [single.process_frame(f, float(i)) for i, f in enumerate(frames)]
    single_s = time.perf_counter() - t0
    a, b = np.stack(live.trajectory.poses), np.stack(single.trajectory.poses)
    if a.shape != b.shape or not np.array_equal(a, b):
        raise AssertionError(f"async_stream: the trajectory differs from the process_frame run "
                             f"(max abs {float(np.abs(a - b).max()) if a.shape == b.shape else a.shape})")
    if stripped_diagnostics(d.to_dict() for d in diags) != stripped_diagnostics(d.to_dict() for d in single_diags):
        raise AssertionError("async_stream: the diagnostics differ from the process_frame run")
    track_ms = [1e3 * e.duration_s for e in live.telemetry.events() if e.name == "track_step"]
    ba_ms = [1e3 * e.duration_s for e in live.telemetry.events() if e.name == "local_ba"]

    # The device's busy share over a stretch of frames: a fresh system over
    # the first 1 + PROFILED_FRAMES frames under the profiler (kernels of
    # both threads; the build is already done).
    profiled = system("smoke_async_profiled")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        profiled.run_stream_async(packets_from_arrays(frames[: 1 + PROFILED_FRAMES]))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.count]
    device_ms_total = sum(e.device_time_total for e in events) / 1e3
    if not device_ms_total > 0.0:
        raise AssertionError("async_stream: the profiler saw no device time")
    emit({
        "phase": "async_stream", "frames": len(diags), "shape": [370, 1226], "dtype": "uint8",
        "num_features": NUM_FEATURES, "max_matches": 512, "hypotheses": {"essential": 512, "homography": 256},
        "feature_control": {"batch_size": 4, "flush_timeout_s": "adaptive", "max_inflight": 8},
        "tracking_control": {"max_pending": 16, "frame_ttl_s": 5.0, "drop_policy": "drop_oldest"},
        "poses": poses, "keyframes": len(live.keyframes), "fps": (len(diags) - 1) / elapsed, "elapsed_s": elapsed,
        "process_frame_fps": (len(frames) - 1) / single_s,
        "track_step_ms": {"calls": len(track_ms), "median": statistics.median(track_ms)},
        "local_ba_ms": {"calls": len(ba_ms), "median": statistics.median(ba_ms) if ba_ms else None},
        "batches": feature["batches"], "mean_batch_fill": feature["mean_batch_fill"],
        "batch_fill_histogram": feature["batch_fill_histogram"],
        "flush_timeout_s_effective": feature["flush_timeout_s_effective"],
        "feature_latency": feature["latency"], "tracking_wait": tracking["wait"],
        "busy_share": {"frames": PROFILED_FRAMES, "wall_ms": wall_ms, "device_ms": device_ms_total,
                       "share": device_ms_total / wall_ms},
        "peak_mem_bytes": int(peak), "bit_equal_to_process_frame": True, "event_digest": report["event_digest"],
        "launches": launches, "phase_seconds": time.perf_counter() - phase_t0,
    })
    return launches


def phase_async_ingest(dev):
    """The offline phase's 29-frame PNG KITTI layout through the runner in
    ``stream`` and ``async`` mode (bit-equal), then the ingestion pipeline
    alone with threads and with the process pool."""
    import numpy as np
    import torch

    from mvslam_tpu_torch.runtime import frame_stream
    from mvslam_tpu_torch.runtime.frame_stream import _default_read_fn
    from mvslam_tpu_torch.runtime.ingestion import AsyncIngestionPipeline, IngestionPipelineConfig
    from mvslam_tpu_torch.slam.runner import run_kitti_sequence

    phase_t0 = time.perf_counter()
    root = REPO / "runs" / "chip_smoke" / "offline_kitti_bench"  # written by the offline phase
    runs = {}
    for mode in ("stream", "async"):
        if mode == "async":
            reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = run_kitti_sequence(root, run_id=f"smoke_ingest_{mode}", output_root=REPO / "runs" / "chip_smoke",
                                    ingestion=mode, device=dev)
        runs[mode] = {"result": result, "elapsed": time.perf_counter() - t0}
    launches = read_launches("async_ingest")
    a, b = (np.load(runs[m]["result"].trajectory_path) for m in ("stream", "async"))
    if sorted(a.files) != sorted(b.files) or not all(np.array_equal(a[k], b[k]) for k in a.files):
        raise AssertionError("async_ingest: the async run's trajectory differs from the stream run's")
    diags = {m: json.loads(runs[m]["result"].diagnostics_path.read_text()) for m in runs}
    if stripped_diagnostics(diags["stream"]) != stripped_diagnostics(diags["async"]):
        raise AssertionError("async_ingest: frame_diagnostics.json differs between stream and async")
    report = json.loads((runs["async"]["result"].run_dir / "reports" / "ingestion_report.json").read_text())
    if report.get("decoded") != OFFLINE_FRAMES or report.get("failed") != 0:
        raise AssertionError(f"async_ingest: ingestion_report {report}")

    paths = sorted((root / "sequences" / "00" / "image_0").glob("*.png"))
    t0 = time.perf_counter()
    decoded = [_default_read_fn(p) for p in paths]
    serial_ms = 1e3 * (time.perf_counter() - t0) / len(paths)
    per_frame = {}
    for name, processes in (("threads", False), ("processes", True)):
        t0 = time.perf_counter()
        packets = list(AsyncIngestionPipeline(paths, config=IngestionPipelineConfig(use_process_pool=processes)))
        per_frame[name] = 1e3 * (time.perf_counter() - t0) / len(paths)
        if [p.index for p in packets] != list(range(len(paths))) or not all(
            np.array_equal(p.frame, decoded[p.index]) for p in packets
        ):
            raise AssertionError(f"async_ingest: the {name} pipeline's packets are out of order or differ from the decoder")
    emit({
        "phase": "async_ingest", "frames": OFFLINE_FRAMES, "dataset": str(root.relative_to(REPO)),
        "seconds": {m: runs[m]["elapsed"] for m in runs},
        "fps": {m: (OFFLINE_FRAMES - 1) / runs[m]["elapsed"] for m in runs},
        "ingestion_report": report, "bit_equal_to_stream": True,
        "decode_ms_per_frame": {"serial_decoder": serial_ms, **per_frame},
        "default_decoder": "numpy" if frame_stream._native_decoder() is None else "native",
        "launches": launches, "phase_seconds": time.perf_counter() - phase_t0,
    })
    return launches


def encode_png(img, filter_type: int) -> bytes:
    """An 8-bit grey (H, W) or RGB (H, W, 3) PNG with one filter type on
    every scanline, encoded in numpy (the filters read raw bytes only)."""
    import zlib

    import numpy as np

    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    x = img.reshape(h, w * c).astype(np.int32)
    up = np.vstack([np.zeros((1, w * c), np.int32), x[:-1]])
    left = np.hstack([np.zeros((h, c), np.int32), x[:, :-c]])
    upleft = np.hstack([np.zeros((h, c), np.int32), up[:, :-c]])
    if filter_type == 4:  # Paeth
        pa, pb, pc = np.abs(up - upleft), np.abs(left - upleft), np.abs(left + up - 2 * upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    else:
        pred = [np.zeros_like(x), left, up, (left + up) >> 1][filter_type]
    raw = np.hstack([np.full((h, 1), filter_type), (x - pred) % 256]).astype(np.uint8)

    def chunk(ctype, body):
        return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))

    header = struct.pack(">IIBBBBB", w, h, 8, 0 if c == 1 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + chunk(b"IEND", b""))


def toolchain() -> dict:
    """The host's C++ toolchain: the compiler, whether libpng's and zlib's
    headers compile and their libraries link, and ``-march=native``'s
    target (the native library needs zlib only)."""
    def run(cmd, stdin=None):
        return subprocess.run(cmd, input=stdin, capture_output=True, text=True, timeout=120)

    work = REPO / "runs" / "chip_smoke" / "toolchain"
    work.mkdir(parents=True, exist_ok=True)
    (work / "png.cc").write_text(
        "#include <png.h>\n#include <zlib.h>\n"
        "int main() { return png_access_version_number() > 0 && zlibVersion()[0] ? 0 : 1; }\n")
    (work / "zlib.cc").write_text("#include <zlib.h>\nint main() { return zlibVersion()[0] ? 0 : 1; }\n")
    target = run(["g++", "-march=native", "-Q", "--help=target"]).stdout.splitlines()
    flags = {f[0]: f[-1] for f in (line.split() for line in target) if len(f) >= 2}
    return {
        "g++": run(["g++", "--version"]).stdout.splitlines()[0],
        "png_h": run(["g++", "-x", "c++", "-E", "-"], "#include <png.h>\n").returncode == 0,
        "zlib_h": run(["g++", "-x", "c++", "-E", "-"], "#include <zlib.h>\n").returncode == 0,
        "links_lpng_lz": run(["g++", str(work / "png.cc"), "-o", str(work / "png"), "-lpng", "-lz"]).returncode == 0,
        "links_lz": run(["g++", str(work / "zlib.cc"), "-o", str(work / "zlib"), "-lz"]).returncode == 0,
        "march_native": flags.get("-march="),
        "avx512vpopcntdq": flags.get("-mavx512vpopcntdq"),
    }


GAMMA_FIXTURES = "tests/data/png_gamma"


def gamma_fixtures() -> dict:
    """Both port decoders on the committed PNG files with gamma chunks,
    against the SHA-256 of libpng's grey output for each (``digests.json``
    beside them, written where libpng is installed; this host has none):
    per file, ms per decode of each decoder that reads it (best of 5)."""
    import hashlib

    import numpy as np

    from mvslam_tpu_torch import native
    from mvslam_tpu_torch.runtime import frame_stream

    folder = REPO / GAMMA_FIXTURES
    digests = json.loads((folder / "digests.json").read_text())
    if not digests:
        raise AssertionError(f"no gamma fixtures in {GAMMA_FIXTURES}")
    out = {}
    for name, want in sorted(digests.items()):
        path = folder / name
        decoders = {"decode_gray": lambda: native.decode_gray(path)}
        if want["numpy"]:
            decoders["numpy"] = lambda: frame_stream.decode_png(path.read_bytes())
        out[name] = {}
        for decoder, fn in decoders.items():
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                img = fn()
                times.append(1e3 * (time.perf_counter() - t0))
            digest = None if img is None else hashlib.sha256(np.ascontiguousarray(img, np.uint8).tobytes()).hexdigest()
            if digest != want["sha256"] or list(img.shape) != want["shape"]:
                raise AssertionError(f"native: {decoder} on {name} differs from libpng's digest")
            out[name][decoder] = min(times)
    return out


def phase_native(dev):
    """The native host library: its build, its decoder against the numpy
    decoder on every file of a corpus (the offline scene's 29 PNGs, the same
    frames with filter types 1 to 4, an RGB frame, a PGM), both decoders
    against libpng's digests of the committed gamma fixtures, its frame loader
    with 1, 2 and 4 workers, and its matcher against the card's on two
    bench frames' descriptors."""
    import numpy as np
    import torch

    from mvslam_tpu_torch import native
    from mvslam_tpu_torch.data.bench_frames import make_frames
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
    from mvslam_tpu_torch.native import build as native_build
    from mvslam_tpu_torch.ops.hamming import (
        MatchConfig, hamming_distance_matrix, match_descriptors, match_descriptors_host,
    )
    from mvslam_tpu_torch.runtime import frame_stream
    from mvslam_tpu_torch.slam.tracking import bootstrap_frame

    phase_t0 = time.perf_counter()
    if not native.native_available():
        raise AssertionError("native: the library was built but does not load")
    path = NATIVE_BUILD["path"]
    march = "native" if path == native_build.library_path(native_build.NATIVE_ARCH) else "generic"

    src = sorted((REPO / "runs" / "chip_smoke" / "offline_kitti_bench" / "sequences" / "00" / "image_0").glob("*.png"))
    corpus = REPO / "runs" / "chip_smoke" / "native_corpus"
    corpus.mkdir(parents=True, exist_ok=True)
    pixels = [frame_stream.decode_png(p.read_bytes()) for p in src]
    files = {0: src}
    for ft in (1, 2, 3, 4):
        files[ft] = [corpus / f"filter{ft}_{p.name}" for p in src]
        for out, img in zip(files[ft], pixels):
            out.write_bytes(encode_png(img, ft))
    h, w = pixels[0].shape
    rgb = np.stack([pixels[0], np.roll(pixels[0], 7, axis=1), 255 - pixels[0]], -1)
    (corpus / "rgb.png").write_bytes(encode_png(rgb, 1))
    (corpus / "frame.pgm").write_bytes(b"P5\n%d %d\n255\n" % (w, h) + pixels[1].tobytes())

    def per_frame_ms(fn, items):
        t0 = time.perf_counter()
        out = [fn(x) for x in items]
        return out, 1e3 * (time.perf_counter() - t0) / len(items)

    numpy_ms, native_ms = {}, {}
    for ft, paths in files.items():
        ours, native_ms[ft] = per_frame_ms(native.decode_gray, paths)
        ref, numpy_ms[ft] = per_frame_ms(lambda q: frame_stream.decode_png(q.read_bytes()), paths)
        for q, a, b, img in zip(paths, ours, ref, pixels):
            if a is None or not (np.array_equal(a, b) and np.array_equal(a, img)):
                raise AssertionError(f"native: decode_gray differs from the numpy decoder on {q.name}")
    for q, ref in ((corpus / "rgb.png", frame_stream.decode_png((corpus / "rgb.png").read_bytes())),
                   (corpus / "frame.pgm", frame_stream.decode_pnm((corpus / "frame.pgm").read_bytes()))):
        got = native.decode_gray(q)
        if got is None or not np.array_equal(got, ref):
            raise AssertionError(f"native: decode_gray differs from the numpy decoder on {q.name}")
    gamma_ms = gamma_fixtures()
    loader_ms = {}
    for workers in NATIVE_LOADER_WORKERS:
        t0 = time.perf_counter()
        with native.NativeFrameLoader(src, workers=workers, capacity=8) as loader:
            items = list(loader)
            stats = loader.stats()
        loader_ms[workers] = 1e3 * (time.perf_counter() - t0) / len(src)
        if [it.index for it in items] != list(range(len(src))) or stats.failed or not all(
            np.array_equal(it.frame, img) for it, img in zip(items, pixels)
        ):
            raise AssertionError(f"native: the loader with {workers} workers delivered other frames")

    # The matcher: two bench frames' descriptors from the card's detector.
    cfg = FeaturePipelineConfig(num_features=NUM_FEATURES, max_matches=512)
    a, b = (bootstrap_frame(torch.from_numpy(f.astype(np.uint8)).to(dev), cfg) for f in make_frames(2))
    words = [np.ascontiguousarray(t.cpu().numpy()) for t in (a.descriptors, a.valid, b.descriptors, b.valid)]
    host_in = (words[0].view(np.uint32), words[1], words[2].view(np.uint32), words[3])
    best_idx, best, second, col_best = native.hamming_match(*host_in)
    match_cfg = MatchConfig(cross_check=True)
    res = match_descriptors(a.descriptors, a.valid, b.descriptors, b.valid, match_cfg)
    d = hamming_distance_matrix(a.descriptors, b.descriptors)
    d = torch.where(b.valid[None, :], d, torch.tensor(1e9, device=dev))
    d = torch.where(a.valid[:, None], d, torch.tensor(1e9, device=dev))
    dev_col_best = torch.argmin(d, dim=0)
    host = match_descriptors_host(*host_in, match_cfg)
    checks = {
        "best_idx": np.array_equal(best_idx, res.indices.cpu().numpy()),
        "best": np.array_equal(best, res.distances.cpu().numpy()),
        "second": np.array_equal(second, res.second_distances.cpu().numpy()),
        "col_best": np.array_equal(col_best, dev_col_best.cpu().numpy()),
        "cross_checked": np.array_equal(host.valid.numpy(), res.valid.cpu().numpy()),
    }
    if not all(checks.values()):
        raise AssertionError(f"native: the host matcher differs from the card's: {checks}")
    # The torch matcher on the host CPU, the one the C++ matcher replaces
    # there (``ops.hamming.matcher_for``).
    cpu_in = [torch.from_numpy(w) for w in words]
    cpu = match_descriptors(cpu_in[0], cpu_in[1], cpu_in[2], cpu_in[3], match_cfg)
    checks["cpu_torch"] = all(np.array_equal(x.numpy(), y.numpy()) for x, y in zip(cpu, host))
    if not checks["cpu_torch"]:
        raise AssertionError("native: the host matcher differs from the torch matcher on the CPU")
    host_times, wall_times, cpu_times = [], [], []
    for _ in range(10):
        t0 = time.perf_counter()
        native.hamming_match(*host_in)
        host_times.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        match_descriptors(cpu_in[0], cpu_in[1], cpu_in[2], cpu_in[3], match_cfg)
        cpu_times.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        match_descriptors(a.descriptors, a.valid, b.descriptors, b.valid, match_cfg)
        torch.cuda.synchronize()
        wall_times.append(1e3 * (time.perf_counter() - t0))
    emit({
        "phase": "native", "library": str(path.relative_to(REPO)), "key": path.stem.split("_")[-1],
        "march": march, "build_seconds": NATIVE_BUILD["seconds"], "toolchain": toolchain(),
        "corpus": {"pngs_per_filter": len(src), "filters": sorted(files), "rgb": 1, "pgm": 1, "shape": [h, w]},
        "decode_bit_equal_to_numpy": True, "gamma_fixtures_equal_libpng_digests": True,
        "gamma_fixture_decode_ms_host": gamma_ms,
        "decode_ms_per_frame_host": {
            "numpy": {f"filter{ft}": ms for ft, ms in numpy_ms.items()},
            "decode_gray": {f"filter{ft}": ms for ft, ms in native_ms.items()},
            "loader_filter0": {f"workers_{k}": ms for k, ms in loader_ms.items()},
        },
        "matcher": {
            "rows": [int(a.valid.shape[0]), int(b.valid.shape[0])],
            "valid": [int(a.valid.sum()), int(b.valid.sum())], "matches": int(res.valid.sum()),
            "bit_equal_to_device": checks, "host_ms": statistics.median(host_times),
            "cpu_torch_ms": statistics.median(cpu_times), "cpu_torch_threads": torch.get_num_threads(),
            "device_event_ms": median_ms(lambda: match_descriptors(a.descriptors, a.valid, b.descriptors, b.valid, match_cfg)),
            "device_wall_ms": statistics.median(wall_times),
        },
        "phase_seconds": time.perf_counter() - phase_t0,
    })


def phase_native_ingest(dev):
    """The offline phase's 29-frame PNG KITTI layout through the runner in
    ``native`` and ``stream`` mode at the defaults (window 8): trajectories
    and diagnostics bit-equal, the native ingestion report complete."""
    import numpy as np
    import torch

    from mvslam_tpu_torch.slam.runner import run_kitti_sequence

    phase_t0 = time.perf_counter()
    root = REPO / "runs" / "chip_smoke" / "offline_kitti_bench"
    runs, launches = {}, None
    for mode in ("native", "stream"):
        if mode == "native":
            reset_launches()
        # The stream run decodes with the numpy decoder, so the gate holds
        # the C++ decoder and loader against an independent decoder.
        os.environ["MVSLAM_NATIVE_DECODE"] = "0" if mode == "stream" else "1"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # One run id, two output roots: the runs' artifacts can be compared file by file.
        result = run_kitti_sequence(root, run_id="smoke_native_ingest", ingestion=mode, device=dev,
                                    output_root=REPO / "runs" / "chip_smoke" / f"native_ingest_{mode}")
        runs[mode] = {"result": result, "elapsed": time.perf_counter() - t0}
        del os.environ["MVSLAM_NATIVE_DECODE"]
        if mode == "native":
            launches = read_launches("native_ingest")
    a, b = (np.load(runs[m]["result"].trajectory_path) for m in ("native", "stream"))
    if sorted(a.files) != sorted(b.files) or not all(np.array_equal(a[k], b[k]) for k in a.files):
        raise AssertionError("native_ingest: the native run's trajectory differs from the stream run's")
    diags = {m: json.loads(runs[m]["result"].diagnostics_path.read_text()) for m in runs}
    if stripped_diagnostics(diags["native"]) != stripped_diagnostics(diags["stream"]):
        raise AssertionError("native_ingest: frame_diagnostics.json differs between native and stream")
    report = json.loads((runs["native"]["result"].run_dir / "reports" / "ingestion_report.json").read_text())
    fields = {"backend", "decoded", "failed", "consumer_wait_s", "worker_wait_s"}
    if set(report) != fields or report["backend"] != "native" or report["decoded"] != OFFLINE_FRAMES or report["failed"]:
        raise AssertionError(f"native_ingest: ingestion_report {report}")
    emit({
        "phase": "native_ingest", "frames": OFFLINE_FRAMES, "window": 8,
        "seconds": {m: runs[m]["elapsed"] for m in runs},
        "fps": {m: (OFFLINE_FRAMES - 1) / runs[m]["elapsed"] for m in runs},
        "ingestion_report": report, "bit_equal_to_stream": True, "stream_decoder": "numpy",
        "launches": launches, "phase_seconds": time.perf_counter() - phase_t0,
    })
    return launches, {m: runs[m]["result"].run_dir for m in runs}


def phase_eval(run_dirs):
    """The port's evaluation layer over the native_ingest phase's two run
    directories against the scene's ground truth."""
    import asyncio

    from mvslam_tpu_torch.eval.baselines import MetricThreshold, upsert_baseline
    from mvslam_tpu_torch.eval.ci_runner import SeverityWeights, score_run
    from mvslam_tpu_torch.eval.determinism_validation import build_determinism_report
    from mvslam_tpu_torch.eval.governance import BenchmarkSpec, run_governance
    from mvslam_tpu_torch.eval.harness import load_config, run_evaluation
    from mvslam_tpu_torch.eval.readiness import generate_readiness_report
    from mvslam_tpu_torch.eval.regression_gate import execute_gate

    phase_t0 = time.perf_counter()
    work = REPO / "runs" / "chip_smoke" / "eval"
    work.mkdir(parents=True, exist_ok=True)
    gt = REPO / "runs" / "chip_smoke" / "offline_kitti_bench" / "gt.txt"
    thresholds = {"ATE_RMSE": {"direction": "lower", "tolerance": 0.0}, "RPE_RMSE": {"direction": "lower", "tolerance": 0.0}}
    store = work / "baselines.json"
    store.unlink(missing_ok=True)

    def config(mode, **baseline):
        cfg = {"run": {"run_id": f"smoke_eval_{mode}", "output_root": str(work / "runs")},
               "evaluation": {"trajectories": [{"name": "offline_bench", "gt": str(gt), "est_run_dir": str(run_dirs[mode])}]}}
        if baseline:
            cfg["baseline"] = {"store": str(store), "key": "offline_bench", "metric_thresholds": thresholds, **baseline}
        path = work / f"{mode}{'_baseline' if baseline else ''}.json"
        path.write_text(json.dumps(cfg))
        return path

    summaries = {m: run_evaluation(load_config(config(m))) for m in ("stream", "native")}
    if summaries["native"]["aggregate"] != summaries["stream"]["aggregate"]:
        raise AssertionError("eval: ATE/RPE of the native run differ from the stream run's")
    run_evaluation(load_config(config("stream", write=True)))  # the baseline, from the stream run
    gate = asyncio.run(execute_gate([config("native", write=False)], max_concurrency=1))
    if gate["status"] != "pass":
        raise AssertionError(f"eval: the native run fails the gate against the stream baseline: {gate}")
    severity = score_run(json.loads((Path(gate["runs"][0]["run_dir"]) / "summary.json").read_text()), SeverityWeights())
    det = build_determinism_report(run_dirs["stream"], run_dirs["native"])
    if det.mismatched or det.missing_in_b or det.missing_in_a != ["reports/ingestion_report.json"]:
        raise AssertionError(f"eval: the two run directories differ: {det.to_dict()}")
    # Governance: the native run's evaluation as a budgeted subprocess,
    # against the stream run's numbers as its baseline.
    perf_store = work / "governance_baselines.json"
    perf_store.unlink(missing_ok=True)
    upsert_baseline(perf_store, "native_run_ate", summaries["stream"]["aggregate"])
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "from mvslam_tpu_torch.eval.harness import load_config, run_evaluation; "
            "print(json.dumps(run_evaluation(load_config(sys.argv[2]))['aggregate']))")
    spec = BenchmarkSpec(name="native_run_ate", command=[sys.executable, "-c", code, str(REPO), str(config("native"))],
                         runtime_budget_s=300, metric_thresholds={k: MetricThreshold.from_config(v) for k, v in thresholds.items()})
    governance = run_governance({"specs": [spec], "baseline_store": str(perf_store)})
    if governance["status"] != "pass" or governance["benchmarks"][0]["baseline_comparison"]["status"] != "pass":
        raise AssertionError(f"eval: governance {governance}")
    telemetry = json.loads((run_dirs["native"] / "reports" / "telemetry_summary.json").read_text())
    readiness = generate_readiness_report(None, summaries["native"], telemetry)
    if readiness["sections"]["evaluation"]["status"] != "pass" or readiness["status"] == "fail":
        raise AssertionError(f"eval: readiness {readiness}")
    emit({
        "phase": "eval", "aggregate": summaries["native"]["aggregate"], "equal_to_stream": True,
        "gate": gate["status"], "severity": severity,
        "determinism": {"matched": len(det.matched), "only_in_native": det.missing_in_a},
        "governance": {"status": governance["status"], "elapsed_s": governance["benchmarks"][0]["elapsed_s"]},
        "readiness": {"status": readiness["status"], "digest": readiness["digest"],
                      "sections": {k: v["status"] for k, v in readiness["sections"].items()}},
        "phase_seconds": time.perf_counter() - phase_t0,
    })


def phase_animate(dev, no_loops_run_dir: Path):
    """``run_visual_slam`` with ``enable_animation=True`` on the offline
    scene at the offline phase's settings without loop closure: bit-equal
    to the offline phase's run without loops, one recorded position per
    frame."""
    import importlib.util

    import numpy as np
    import torch

    from mvslam_tpu_torch.slam.offline import run_visual_slam
    from mvslam_tpu_torch.viz import path_animator

    phase_t0 = time.perf_counter()
    root = REPO / "runs" / "chip_smoke" / "offline_kitti_bench"
    made = []

    class Recorded(path_animator.VehiclePathLiveAnimator):
        """The animator, keeping each pose it was handed (the system's live
        pose at each frame)."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.handed = []
            made.append(self)

        def update(self, pose):
            self.handed.append(np.array(pose))
            super().update(pose)

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(path_animator, "VehiclePathLiveAnimator", Recorded):
        summary = run_visual_slam(offline_config(root, root / "gt.txt", "smoke_animate", enable_loop_closure=False,
                                                 enable_animation=True), device=dev)
    elapsed = time.perf_counter() - t0
    launches = read_launches("animate")
    run_dir = Path(summary["run_dir"])
    a, b = (np.load(d / "trajectories" / "estimated.npz") for d in (run_dir, no_loops_run_dir))
    if sorted(a.files) != sorted(b.files) or not all(np.array_equal(a[k], b[k]) for k in a.files):
        raise AssertionError("animate: the trajectory differs from the offline phase's run without loops")
    if (run_dir / "offline_summary.json").read_bytes() != (no_loops_run_dir / "offline_summary.json").read_bytes():
        raise AssertionError("animate: offline_summary.json differs from the offline phase's run without loops")
    (animator,) = made
    poses = a["poses"]
    live = [(float(p[0, 3]), float(p[2, 3])) for p in animator.handed]
    if animator.positions != live or len(live) != OFFLINE_FRAMES or live[0] != (float(poses[0, 0, 3]), float(poses[0, 2, 3])):
        raise AssertionError("animate: the recorder does not hold the system's x/z once per frame")
    # Window BA refines past keyframe poses after the recorder saw them: the
    # live path and the final trajectory differ by that refinement.
    refined = max(np.hypot(x - p[0, 3], z - p[2, 3]) for (x, z), p in zip(live, poses))
    emit({
        "phase": "animate", "frames": OFFLINE_FRAMES, "matplotlib": importlib.util.find_spec("matplotlib") is not None,
        "recorded_positions": len(animator.positions), "max_live_vs_final_xz": float(refined),
        "bit_equal_to_offline_no_loops": True,
        "seconds": elapsed, "fps": (OFFLINE_FRAMES - 1) / elapsed, "launches": launches,
        "phase_seconds": time.perf_counter() - phase_t0,
    })
    return launches


def index_scene():
    """The bow_index phase's map: 50,000 seeded sparse, L2-normalised
    histograms with four planted exact ties, frame ids 0, 3, 6, ..., and 100
    queries (the planted rows first)."""
    import numpy as np

    rng = np.random.default_rng(0)
    # Sparse non-negative rows, like word histograms: a few dozen of the
    # 256 words carry the mass.
    hist = rng.gamma(0.15, size=(INDEX_ROWS, INDEX_VOCAB)).astype(np.float32)
    planted = [(7, 20_000), (7, 40_000), (123, 124), (30_000, 49_999)]  # exact ties: copies of a row
    for src, dst in planted:
        hist[dst] = hist[src]
    hist /= np.linalg.norm(hist, axis=1, keepdims=True)
    ids = list(range(0, 3 * INDEX_ROWS, 3))
    queries = [hist[src] for src, _ in planted] + [
        (q / np.linalg.norm(q)).astype(np.float32)
        for q in rng.gamma(0.15, size=(INDEX_QUERIES - len(planted), INDEX_VOCAB))
    ]
    return hist, ids, planted, queries


def index_against_host(index, queries, hist64, planted, phase: str) -> int:
    """Each query's top-16 rows against a float64 host ranking by
    (-score, row): the scores are their rows' scores, the set is the host's
    wherever its 16th and 17th scores differ by more than 1e-6, and a row
    may differ from the host's at a position only where their host scores
    differ, by at most 1e-6 (those positions are counted and returned);
    each planted tie comes back lower row first."""
    import numpy as np

    excused = 0
    rows = len(hist64)
    for q in queries:
        scores = hist64 @ q.astype(np.float64)
        order = np.lexsort((np.arange(rows), -scores))[: INDEX_TOPK + 1]
        host = order[:INDEX_TOPK]
        got = index.topk(q, k=INDEX_TOPK)
        got_rows = [i // 3 for i, _ in got]
        if len(got) != INDEX_TOPK or max(abs(s - scores[r]) for (_, s), r in zip(got, got_rows)) > 1e-5:
            raise AssertionError(f"{phase}: a returned score is not its row's score")
        if scores[order[INDEX_TOPK - 1]] - scores[order[INDEX_TOPK]] > 1e-6 and set(got_rows) != set(host.tolist()):
            raise AssertionError(f"{phase}: top-{INDEX_TOPK} set {got_rows} != host {host.tolist()}")
        for pos, (row, ref) in enumerate(zip(got_rows, host.tolist())):
            if row == ref:
                continue
            if abs(scores[row] - scores[ref]) > 1e-6 or scores[row] == scores[ref]:
                # a different row although the host's scores are clearly apart, or exactly tied
                raise AssertionError(f"{phase}: position {pos}: row {row} != host's {ref}")
            excused += 1
    for (src, dst), q in zip(planted, queries):
        top2 = [i // 3 for i, _ in index.topk(q, k=2)]
        if top2[0] != min(src, dst):
            raise AssertionError(f"{phase}: planted tie ({src}, {dst}) came back as {top2}")
    return excused


def phase_bow_index(dev):
    """The device BoW index at map scale against a float64 host ranking."""
    import numpy as np
    import torch

    from mvslam_tpu_torch.loopclosure.device_index import DeviceBoWIndex

    phase_t0 = time.perf_counter()
    hist, ids, planted, queries = index_scene()

    t0 = time.perf_counter()
    index = DeviceBoWIndex.from_histograms(ids, hist, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    excused = index_against_host(index, queries, hist.astype(np.float64), planted, "bow_index")

    q_dev = queries[-1]
    event_ms = median_ms(lambda: index.topk(q_dev, k=INDEX_TOPK), warmup=3, iters=50)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for q in queries:
        index.topk(q, k=INDEX_TOPK)
    wall_ms = 1e3 * (time.perf_counter() - t0) / len(queries)
    # The matvec alone: 200 launches between two CUDA events (its 51 MB
    # do not fit the 50 MB L2, so every launch reads HBM).
    row = index._row(q_dev)
    for _ in range(10):
        index._buf @ row
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(200):
        index._buf @ row
    end.record()
    end.synchronize()
    matvec_ms = start.elapsed_time(end) / 200
    host_times = []
    for _ in range(10):
        t0 = time.perf_counter()
        hist @ q_dev
        host_times.append(1e3 * (time.perf_counter() - t0))

    # Grown by add() from a small capacity against a bulk load of the same rows.
    grown = DeviceBoWIndex(INDEX_VOCAB, 1024, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(INDEX_GROWN_ROWS):
        grown.add(ids[i], hist[i])
    torch.cuda.synchronize()
    add_ms = 1e3 * (time.perf_counter() - t0) / INDEX_GROWN_ROWS
    bulk = DeviceBoWIndex.from_histograms(ids[:INDEX_GROWN_ROWS], hist[:INDEX_GROWN_ROWS], device=dev)
    if grown.capacity != 4096 or len(grown) != INDEX_GROWN_ROWS:
        raise AssertionError(f"bow_index: grown index has capacity {grown.capacity}, {len(grown)} rows")
    for q in queries[:20]:
        a, b = grown.topk(q, k=INDEX_TOPK), bulk.topk(q, k=INDEX_TOPK)
        if [i for i, _ in a] != [i for i, _ in b] or max(abs(x[1] - y[1]) for x, y in zip(a, b)) > 1e-6:
            raise AssertionError("bow_index: the grown index answers differently from the bulk load")
    nbytes = hist.nbytes + 4 * INDEX_VOCAB + 4 * INDEX_ROWS
    emit({
        "phase": "bow_index", "rows": INDEX_ROWS, "vocab": INDEX_VOCAB, "bytes_on_device": int(hist.nbytes),
        "queries": len(queries), "topk": INDEX_TOPK, "planted_ties": len(planted), "near_tie_positions_excused": excused,
        "equal_to_host_ranking": True, "bulk_load_s": load_s,
        "query_ms_event": event_ms, "query_ms_wall": wall_ms, "matvec_ms": matvec_ms,
        "matvec_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "matvec_bound_by": "bytes",
        "host_numpy_matvec_ms": statistics.median(host_times),
        "grown_from": 1024, "grown_rows": INDEX_GROWN_ROWS, "grown_capacity": grown.capacity, "add_ms": add_ms,
        "grown_equals_bulk": True, "phase_seconds": time.perf_counter() - phase_t0,
    })


# The accuracy phase: the four scenes of benchmarks/benchmark_accuracy_scenes.py
# with that script's settings, copied here (the script and its helpers
# import the JAX package), judged with the port's compare_metrics against
# the committed baselines under the committed gate's thresholds.
ACCURACY_BASELINES = "baselines/accuracy_scenes.json"
ACCURACY_GATE = "configs/evaluation/accuracy_gate.json"
ACCURACY_KEY = "accuracy_scenes"


def yaw_matrix(yaw: float):
    import numpy as np

    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def accuracy_scene(name: str):
    """One tracking scene of the accuracy benchmark, rendered by the port:
    (frames, gt positions, intrinsics, keyframe min_translation or None)."""
    import numpy as np

    from mvslam_tpu_torch.data.synthetic import render_scene

    if name == "straight":  # render_scene's defaults: 10 frames, 240x320
        frames, gt, intr, _ = render_scene()
        return frames, gt, intr, 0.05
    if name == "yaw_arc":
        frames, gt, intr, _ = render_scene(
            traj_fn=lambda i: (yaw_matrix(0.03 * i), np.array([0.25 * i, 0.0, 0.05 * i])))
        return frames, gt, intr, None
    if name == "noisy_arc":
        frames, gt, intr, _ = render_scene(
            num_frames=14, traj_fn=lambda i: (yaw_matrix(0.02 * i), np.array([0.25 * i, 0.0, 0.05 * i])),
            noise=5.0, seed=11)
        return frames, gt, intr, 0.05
    raise ValueError(name)


def accuracy_tracking(name: str, root: Path, dev) -> dict:
    """The benchmark's ``_tracking_ate``: SLAMSystem (seed 3, 512 features,
    256 matches, 256 hypotheses, fixed 2 px threshold, all else default)
    over one scene; its ATE/RPE against ground truth, poses and models."""
    import numpy as np

    from mvslam_tpu_torch.backend.keyframes import KeyframeConfig
    from mvslam_tpu_torch.eval.trajectory import compute_additional_metrics
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
    from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
    from mvslam_tpu_torch.slam.api import SLAMSystem, SLAMSystemConfig

    frames, gt, (fx, fy, cx, cy), min_translation = accuracy_scene(name)
    kwargs = {} if min_translation is None else {"keyframe": KeyframeConfig(min_translation=min_translation)}
    system = SLAMSystem(
        SLAMSystemConfig(
            run_id=f"accuracy_{name}", output_root=root, seed=3, fx=fx, fy=fy, cx=cx, cy=cy,
            feature=FeaturePipelineConfig(num_features=512, max_matches=256),
            pose=RobustPoseEstimatorConfig(num_hypotheses=256, adaptive_threshold=False, essential_threshold_px=2.0),
            **kwargs,
        ),
        device=dev,
    )
    t0 = time.perf_counter()
    diags = system.run_sequence(frames)
    seconds = time.perf_counter() - t0
    est = np.stack(system.trajectory.poses)[:, :3, 3]
    metrics = compute_additional_metrics(est, gt)
    models = [d.model_type for d in diags[1:] if d.pose_success]
    return {"frames": len(frames), "shape": list(frames[0].shape), "posed": len(models),
            "models": {m: models.count(m) for m in sorted(set(models))}, "seconds": seconds,
            "per_frame": [[d.model_type or "-", d.num_inliers] for d in diags[1:]],
            "ATE_RMSE": float(metrics["ATE_RMSE"]), "RPE_RMSE": float(metrics["RPE_RMSE"]),
            "input_dtype": str(np.asarray(frames[0]).dtype)}


def accuracy_loop_scene(root: Path, dev) -> dict:
    """The benchmark's ``_offline_loop_scene``: the out-and-back revisit
    (1 + 28 frames at 240x320, noise 6, seed 2) written as a KITTI layout,
    through ``run_visual_slam`` with loops off and then on (seed 3, gap 12,
    similarity 0.7, 25 inliers, ground truth)."""
    import numpy as np

    from mvslam_tpu_torch.data.synthetic import render_scene, write_kitti_sequence
    from mvslam_tpu_torch.slam.offline import SLAMRunConfig, run_visual_slam

    half = 14

    def out_and_back(i):
        x = 0.25 * i if i <= half else 0.25 * (2 * half - i)
        return np.eye(3), np.array([x, 0.0, 0.0])

    frames, gt, intr, _ = render_scene(num_frames=2 * half + 1, traj_fn=out_and_back, noise=6.0, seed=2)
    data_root, gt_path = write_kitti_sequence(root / "kitti_oab", frames, gt, intr)
    common = dict(input_path=data_root, input_kind="kitti", sequence="00", output_root=root / "runs_oab", seed=3,
                  ground_truth_path=gt_path, loop_min_frame_gap=12, loop_similarity_threshold=0.7,
                  loop_min_inliers=25)
    out = {"frames": len(frames), "shape": list(frames[0].shape)}
    for tag, loops in (("off", False), ("on", True)):
        t0 = time.perf_counter()
        run = run_visual_slam(SLAMRunConfig(run_id=f"loop_{tag}", enable_loop_closure=loops, **common), device=dev)
        out[tag] = {"ATE_RMSE": float(run["metrics"]["ATE_RMSE"]), "loops_accepted": len(run["loops_accepted"]),
                    "seconds": time.perf_counter() - t0}
    return out


def accuracy_metrics(root: Path, dev) -> tuple:
    """The ten metrics of the accuracy benchmark, under its names, and the
    runs behind them."""
    scenes = {name: accuracy_tracking(name, root, dev) for name in ("straight", "yaw_arc", "noisy_arc")}
    loop = accuracy_loop_scene(root, dev)
    metrics = {}
    for name, run in scenes.items():
        metrics[f"accuracy_{name}_ate_rmse"] = run["ATE_RMSE"]
        metrics[f"accuracy_{name}_rpe_rmse"] = run["RPE_RMSE"]
    metrics["accuracy_oab_loop_on_ate_rmse"] = loop["on"]["ATE_RMSE"]
    metrics["accuracy_oab_loop_off_ate_rmse"] = loop["off"]["ATE_RMSE"]
    metrics["accuracy_oab_loop_ate_ratio"] = loop["on"]["ATE_RMSE"] / max(loop["off"]["ATE_RMSE"], 1e-12)
    ates = [run["ATE_RMSE"] for run in scenes.values()] + [loop["on"]["ATE_RMSE"]]
    metrics["accuracy_mean_ate_rmse"] = sum(ates) / len(ates)
    return metrics, {**scenes, "oab_loop": loop}


def accuracy_gate(metrics: dict) -> tuple:
    """``compare_metrics`` of the port against the committed baseline store
    under the committed gate, both read as they are: (report, per-metric
    rows with baseline and limit)."""
    from mvslam_tpu_torch.eval.baselines import BaselineStore, compare_metrics

    gate = json.loads((REPO / ACCURACY_GATE).read_text())
    thresholds = next(b for b in gate["benchmarks"] if b["name"] == ACCURACY_KEY)["metric_thresholds"]
    baseline = BaselineStore(REPO / ACCURACY_BASELINES).load_baseline(ACCURACY_KEY)
    if baseline is None:
        raise AssertionError(f"no {ACCURACY_KEY!r} baseline in {ACCURACY_BASELINES}")
    report = compare_metrics(metrics, baseline, thresholds)
    rows = {}
    for name, value in metrics.items():
        row = {"value": value, "baseline": baseline.get(name)}
        if name in thresholds:
            t = thresholds[name]
            row["limit"] = baseline[name] * (1.0 + t["tolerance"]) if t.get("direction") == "lower" else None
            row["status"] = next(c.status for c in report.comparisons if c.metric == name)
        rows[name] = row
    return report, rows


def stacked(frames, b: int, dev):
    """``b`` of ``frames``, repeated as needed, on the card."""
    import numpy as np
    import torch

    return torch.from_numpy(np.stack([frames[i % len(frames)] for i in range(b)])).to(dev)


def new_shape_routes(path: str, f32_frames, u8_frames, dev) -> tuple:
    """Hold K1 and K2 against their plain versions at every shape ``path``
    launched them at and no earlier phase compared, on that path's frames
    (all of the path's size): K1 on its float32 or uint8 frames, K2 on
    their blur with points that include clamped border tiles and exact .5
    coordinates."""
    import torch

    k1_routes, k2_routes = [], []
    for key in sorted(LAUNCH_SHAPES[path]["fast_detect"]):
        if key not in COMPARED["fast_detect"]:
            dtype, b = key[:2]
            x = stacked(f32_frames if dtype == "torch.float32" else u8_frames, b, dev)
            k1_routes.append({**k1_route(x), "path": path})
    gen = torch.Generator(device="cpu").manual_seed(2)
    for key in sorted(LAUNCH_SHAPES[path]["extract_patches"]):
        if key not in COMPARED["extract_patches"]:
            out_dtype, b, h, w, n = key
            image, xy = k2_inputs(stacked(f32_frames, b, dev), n, gen)
            dt = getattr(torch, out_dtype.replace("torch.", ""))
            tag = "bf16 tiles, BRIEF" if dt == torch.bfloat16 else "f32 tiles"
            k2_routes.append({**k2_route(image, xy, dt, f"{tag} ({b}, {h}, {w}), {n} points"), "path": path})
    return k1_routes, k2_routes


def phase_accuracy(dev, k1: dict, k2: dict):
    """The accuracy benchmark's four scenes through the port on the card,
    judged against the committed baselines and gate; then K1 and K2 held
    against their plain versions at the phase's new shapes (their rows join
    the kernels line's routes)."""
    import numpy as np
    import torch

    from mvslam_tpu_torch.data.synthetic import render_scene
    from mvslam_tpu_torch.runtime.frame_stream import _default_read_fn

    phase_t0 = time.perf_counter()
    root = REPO / "runs" / "chip_smoke" / "accuracy"
    reset_launches()
    metrics, runs = accuracy_metrics(root, dev)
    launches = read_launches("accuracy")
    run_s = time.perf_counter() - phase_t0
    report, rows = accuracy_gate(metrics)
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite accuracy metric: {metrics}")
    f32_frames = render_scene()[0]  # the straight scene: float32 renders
    png_dir = root / "kitti_oab" / "sequences" / "00" / "image_0"
    u8_frames = [_default_read_fn(p) for p in sorted(png_dir.glob("*.png"))]
    k1_new, k2_new = new_shape_routes("accuracy", f32_frames, u8_frames, dev)
    k1["routes"] += k1_new
    k2["routes"] += k2_new
    emit({"phase": "accuracy", "status": report.status, "metrics": rows, "runs": runs,
          "launches": launches, "run_seconds": run_s, "seconds": time.perf_counter() - phase_t0,
          "gate": ACCURACY_GATE, "baselines": ACCURACY_BASELINES,
          "k1_new_shapes": k1_new, "k2_new_shapes": k2_new})
    if report.status == "regressed":
        failed = {c.metric: c.reasons for c in report.comparisons if c.status == "regressed"}
        raise AssertionError(f"the accuracy gate regressed: {failed}")
    if report.status != "pass":
        raise AssertionError(f"the accuracy gate is incomplete: {report.to_dict()}")
    return launches


def ba_scene(W=5, P=1024, seed=0):
    """The reference tests' synthetic BA window (``synthetic_ba_problem``):
    W poses 0.5 apart along x, yawing 0.02 rad each, P points at depths 6 to
    14 seen by every pose with 0.5 px noise, the poses after the first two
    and every point perturbed. Returns (poses_init, points_init, observations
    of the port, K)."""
    import numpy as np

    from mvslam_tpu_torch.backend.bundle_adjustment import Observation
    from mvslam_tpu_torch.geometry import lie_np

    rng = np.random.default_rng(seed)
    K = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]])
    points = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P), rng.uniform(6, 14, P)], axis=1)
    poses = np.stack([lie_np.se3_params_to_matrix(np.array([0.5 * w, 0, 0, 0, 0.02 * w, 0])) for w in range(W)])
    observations = []
    for w in range(W):
        T_cw = np.linalg.inv(poses[w])
        cam = points @ T_cw[:3, :3].T + T_cw[:3, 3]
        uv = (cam[:, :2] / cam[:, 2:]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
        uv += rng.normal(scale=0.5, size=uv.shape)
        observations += [Observation(w, p, uv[p]) for p in range(P)]
    poses_init = poses.copy()
    for w in range(2, W):  # the first two poses fix the gauge
        poses_init[w][:3, 3] += rng.normal(scale=0.02, size=3)
    return poses_init, points + rng.normal(scale=0.05, size=points.shape), observations, K


def ransac_scene(n=2048, seed=0):
    """The reference's sharded-RANSAC problem (parallel_checks.py) at the
    main path's 2,048 correspondences: points at depths 4 to 10, a 0.5
    baseline, 25% of the matches moved 50 px; normalised coordinates."""
    import numpy as np

    from mvslam_tpu_torch.geometry import lie_np

    rng = np.random.default_rng(seed)
    pts3d = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1, 1, n), rng.uniform(4, 10, n)], 1)
    R = lie_np.so3_exp(np.asarray([0.03, -0.02, 0.01]))
    cam2 = pts3d @ R.T + np.array([0.5, 0.1, 0.05])
    uv1 = (pts3d[:, :2] / pts3d[:, 2:]) * 500.0 + [320, 240]
    uv2 = (cam2[:, :2] / cam2[:, 2:]) * 500.0 + [320, 240]
    uv2[rng.choice(n, n // 4, replace=False)] += 50.0
    return ((uv1 - [320, 240]) / 500.0).astype(np.float32), ((uv2 - [320, 240]) / 500.0).astype(np.float32)


def logical_mesh(size, devices=None):
    """``size`` slots over ``cuda:0`` (a logical mesh on one card), or over
    the given devices."""
    from mvslam_tpu_torch.core.sharding import Mesh

    return Mesh(devices or ["cuda:0"] * size, ("data",))


def tree_equal(a, b) -> bool:
    """Every tensor leaf of two (nested) NamedTuples bit-equal."""
    import torch

    if isinstance(a, tuple):
        return all(tree_equal(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def default_against_meshed(default, meshed) -> dict:
    """Per-frame agreement of the default configuration's superwindow with
    the meshed (``mesh_invariant``) one: the same features and matches, the
    same pinned RANSAC at 512 matches; the support vote of H differs in
    form (a matvec and a sum against the pinned products)."""
    import torch

    a, b = default.pose, meshed.pose
    frames = int(a.use_essential.numel())

    def frames_equal(x, y):
        x, y = x.reshape(frames, -1), y.reshape(frames, -1)
        return int((x == y).all(dim=-1).sum())

    return {
        "frames": frames,
        "features_and_matches_bit_equal": bool(torch.equal(default.features_packed.view(torch.int32),
                                                           meshed.features_packed.view(torch.int32))
                                               and torch.equal(default.match_mask, meshed.match_mask)),
        "use_essential_equal_frames": frames_equal(a.use_essential, b.use_essential),
        "num_inliers_equal_frames": frames_equal(a.num_inliers, b.num_inliers),
        "inlier_masks_equal_frames": frames_equal(a.inliers, b.inliers),
        "essential_score_equal_frames": frames_equal(a.essential_score, b.essential_score),
        "homography_score_equal_frames": frames_equal(a.homography_score, b.homography_score),
        "homography_share_equal_frames": frames_equal(a.homography_share, b.homography_share),
        "homography_share_max_abs_diff": float((a.homography_share - b.homography_share).abs().max()),
        "rotation_max_abs_diff": float((a.rotation - b.rotation).abs().max()),
    }


def phase_mesh(host_frames, dev):
    """``mvslam_tpu_torch.parallel`` on logical meshes over ``cuda:0``: the
    meshed superwindow, batched pairs, sharded RANSAC, BA, pose graph and
    index against their unsharded runs; launches of the two meshed
    tracking paths, whose kernels run at window/size and 8/size frames."""
    import numpy as np
    import torch

    from mvslam_tpu_torch.backend.bundle_adjustment import BundleAdjustmentConfig, run_bundle_adjustment
    from mvslam_tpu_torch.backend.pose_graph import PoseGraph3D
    from mvslam_tpu_torch.backend.solvers import SolverConfig, solve_problem
    from mvslam_tpu_torch.core import prng
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
    from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
    from mvslam_tpu_torch.loopclosure.device_index import DeviceBoWIndex
    from mvslam_tpu_torch.ops.ransac import RansacConfig, ransac_essential
    from mvslam_tpu_torch.parallel import mesh as pm
    from mvslam_tpu_torch.slam import tracking

    phase_t0 = time.perf_counter()
    fc = FeaturePipelineConfig(num_features=NUM_FEATURES, max_matches=512)
    pc = RobustPoseEstimatorConfig(num_hypotheses=512, mesh_invariant=True)
    K = torch.tensor(BENCH_K, dtype=torch.float32, device=dev)
    key = prng.key(0, device=dev)
    n_sw = WINDOW * WINDOWS_PER_CALL
    first = torch.from_numpy(host_frames[0]).to(dev)
    frames = torch.from_numpy(np.stack(host_frames[1 : 1 + n_sw])).to(dev)
    prev = tracking.bootstrap_frame(first, fc)
    out = {"card": "logical meshes over cuda:0, one H100: not a multi-card scaling figure"}

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0, int(torch.cuda.max_memory_allocated(dev))

    # 1. The meshed superwindow against the unsharded one (both pinned),
    # after one untimed window of the pinned path.
    tracking.pull_scalars(tracking.track_window(key, prev, frames[:WINDOW], K, fc, pc, start_index=1)[1])
    (ref_last, ref), ref_s, ref_peak = timed(
        lambda: tracking.track_superwindow(key, prev, frames, K, fc, pc, window=WINDOW, start_index=1))
    ref_scal = ref.scalars_packed.cpu().numpy()
    if int((ref_scal[..., 23] > 0).sum()) != n_sw:
        raise AssertionError("mesh: the unsharded superwindow did not track every frame")
    # The default configuration's unsharded run: at 512 matches its RANSAC
    # takes the pinned forms as the meshed run does; only the selection's H
    # transfer votes (a matvec and a sum here, pinned under mesh_invariant)
    # differ. Compared with the meshed run at 1 slot below.
    _, default = tracking.track_superwindow(key, prev, frames, K, fc, RobustPoseEstimatorConfig(num_hypotheses=512),
                                            window=WINDOW, start_index=1)
    reset_launches()
    sw = {"unsharded": {"fps": n_sw / ref_s, "peak_mem_bytes": ref_peak}}
    runs = {}
    for size in (1, 2, 4, 8):
        (last, track), secs, peak = timed(lambda: pm.track_superwindow_meshed(
            logical_mesh(size), key, prev, frames, K, fc, pc, window=WINDOW, start_index=1))
        runs[size] = (last, track)
        scal = track.scalars_packed.cpu().numpy()
        integer_equal = (
            tree_equal(last, ref_last) and tree_equal(track.features_packed, ref.features_packed)
            and torch.equal(track.match_mask, ref.match_mask) and np.array_equal(scal[..., 23:25], ref_scal[..., 23:25])
            and np.array_equal(scal[..., 12], ref_scal[..., 12])
        )
        pose_err = float(np.abs(scal[..., :12] - ref_scal[..., :12]).max())
        if not integer_equal or pose_err > 1e-3 or int((scal[..., 23] > 0).sum()) != n_sw:
            raise AssertionError(f"mesh: superwindow at size {size}: integer stages equal {integer_equal}, "
                                 f"pose err {pose_err}, tracked {int((scal[..., 23] > 0).sum())}/{n_sw}")
        sw[str(size)] = {"fps": n_sw / secs, "peak_mem_bytes": peak, "integer_stages_bit_equal": True,
                         "use_essential_bit_equal": True, "pose_max_abs_err": pose_err,
                         "bit_equal_to_unsharded": bool(tree_equal(track, ref))}
    again = pm.track_superwindow_meshed(logical_mesh(4), key, prev, frames, K, fc, pc, window=WINDOW, start_index=1)
    if not (tree_equal(again[1], runs[4][1]) and tree_equal(again[0], runs[4][0])):
        raise AssertionError("mesh: two superwindow runs at size 4 differ")
    sw["run_to_run_bit_equal_size_4"] = True
    against = default_against_meshed(default, runs[1][1])
    # Gated because the H100 showed every one of them equal on all 96
    # frames: at 512 matches both runs take the same pinned RANSAC, and on
    # the bench frames no H transfer vote lies within the ulps by which
    # its two forms differ. A vote that did would move the H support share
    # first (then the choice, inliers and pose): the message names it.
    unequal = [k for k, v in against.items() if k.endswith("_frames") and v != n_sw]
    if unequal or not against["features_and_matches_bit_equal"] or against["rotation_max_abs_diff"] != 0.0:
        raise AssertionError(f"mesh: the default superwindow differs from the meshed one at 1 slot in {unequal}: "
                             f"{against} (the H transfer votes take a matvec and a sum there, pinned products here)")
    out["superwindow"] = {"frames": n_sw, "window": WINDOW, "sizes": sw, "default_vs_meshed_1_slot": against}

    # 2. Batched pairs (i, i+1) of 8 bench frames.
    pairs_prev, pairs_next = frames[:8], frames[1:9]
    pairs = {}
    for size in (1, 2, 4, 8):
        pairs[size] = timed(lambda: pm.batched_track_pairs(logical_mesh(size), pairs_prev, pairs_next, K, fc, pc))
    launches = read_launches("mesh")
    base_feats, base_track = pairs[1][0]
    pair_report = {}
    for size, ((feats, track), secs, peak) in pairs.items():
        same = tree_equal(feats, base_feats) and all(
            torch.equal(getattr(track, f), getattr(base_track, f))
            for f in ("match_mask", "num_matches", "num_features", "matched_p1", "matched_p2"))
        err = float((track.scalars_packed[..., :12] - base_track.scalars_packed[..., :12]).abs().max())
        if not same or err > 1e-3 or int((track.num_matches > 0).sum()) != 8:
            raise AssertionError(f"mesh: batched pairs at size {size}: features/matches equal {same}, pose err {err}")
        pair_report[str(size)] = {"ms": 1e3 * secs, "peak_mem_bytes": peak, "pose_max_abs_err": err}
    out["batched_pairs"] = {"pairs": 8, "features_and_matches_bit_equal": True, "sizes": pair_report}

    # 3. Hypothesis-sharded RANSAC, 512 hypotheses on 2,048 correspondences.
    n1, n2 = (torch.from_numpy(x).to(dev) for x in ransac_scene())
    mask = torch.ones(n1.shape[0], dtype=torch.bool, device=dev)
    cfg = RansacConfig(num_hypotheses=512, threshold=2.0 / 500.0, mesh_invariant=True)
    single = ransac_essential(key, n1, n2, mask, cfg)
    if not (bool(single.success) and int(single.num_inliers) > 1400):
        raise AssertionError(f"mesh: unsharded RANSAC found {int(single.num_inliers)} inliers")
    ransac = {"unsharded_pinned_ms": median_ms(lambda: ransac_essential(key, n1, n2, mask, cfg)),
              "unsharded_default_ms": median_ms(
                  lambda: ransac_essential(key, n1, n2, mask, RansacConfig(num_hypotheses=512, threshold=2.0 / 500.0)))}
    for size in (1, 2, 4, 8):
        mesh = logical_mesh(size)
        res = pm.sharded_ransac_essential(mesh, key, n1, n2, mask, cfg)
        if not (torch.equal(res.model, single.model) and torch.equal(res.inliers, single.inliers)):
            raise AssertionError(f"mesh: sharded RANSAC at size {size} differs from the unsharded pinned run")
        ransac[str(size)] = {"ms": median_ms(lambda: pm.sharded_ransac_essential(mesh, key, n1, n2, mask, cfg))}
    out["ransac"] = {"hypotheses": 512, "correspondences": int(n1.shape[0]), "inliers": int(single.num_inliers),
                     "bit_equal_all_sizes_and_unsharded": True, **ransac}

    # 4. Observation-sharded BA: 5 poses x 1,024 points.
    poses0, points0, obs, Kba = ba_scene()
    ba_cfg = BundleAdjustmentConfig(max_iterations=10)
    run_bundle_adjustment(poses0, points0, obs, Kba, ba_cfg, device=dev)  # untimed warm-up
    (ba_ref, ba_s, _) = timed(lambda: run_bundle_adjustment(poses0, points0, obs, Kba, ba_cfg, device=dev))
    if ba_ref.diagnostics.conditioning_tripped:
        raise AssertionError("mesh: the unsharded BA tripped its conditioning gate")
    ba = {"unsharded_ms": 1e3 * ba_s}
    for size in (1, 2, 4):
        res, secs, peak = timed(lambda: pm.run_bundle_adjustment_sharded(logical_mesh(size), poses0, points0, obs, Kba,
                                                                          ba_cfg))
        d_pose = float(np.abs(res.poses - ba_ref.poses).max())
        d_pts = float(np.abs(res.points - ba_ref.points).max())
        d_cost = abs(res.diagnostics.final_cost - ba_ref.diagnostics.final_cost) / max(1.0, ba_ref.diagnostics.final_cost)
        if res.diagnostics.conditioning_tripped or d_pose > 1e-4 or d_pts > 1e-3 or d_cost > 1e-2:
            raise AssertionError(f"mesh: sharded BA at size {size}: poses {d_pose}, points {d_pts}, cost {d_cost}")
        ba[str(size)] = {"ms": 1e3 * secs, "peak_mem_bytes": peak, "pose_max_abs_err": d_pose,
                         "point_max_abs_err": d_pts, "cost_rel_err": d_cost}
    again = pm.run_bundle_adjustment_sharded(logical_mesh(4), poses0, points0, obs, Kba, ba_cfg)
    if not (np.array_equal(again.poses, res.poses) and np.array_equal(again.points, res.points)):
        raise AssertionError("mesh: two sharded BA runs at size 4 differ")
    out["ba"] = {"poses": 5, "points": 1024, "observations": len(obs), "initial_cost": ba_ref.diagnostics.initial_cost,
                 "final_cost": ba_ref.diagnostics.final_cost, "run_to_run_bit_equal_size_4": True, **ba}

    # 5. Factor-sharded pose graph: the pose_graph phase's 1,000 poses.
    _, chain, loop_edges = pose_graph_scene()
    graph = PoseGraph3D.from_pose_matrices(chain, device=dev)
    for i, j, T in loop_edges:
        graph.add_loop_matrix(i, j, T, weight=5.0)
    problem = graph._build_graph().build_problem(device=dev)
    pg_cfg = SolverConfig(max_iterations=15, damping=1e-4, method="cholesky")
    solve_problem(problem, pg_cfg)  # untimed warm-up
    pg_ref, pg_s, _ = timed(lambda: solve_problem(problem, pg_cfg))
    pg = {"unsharded_ms": 1e3 * pg_s}
    for size in (1, 2, 4):
        res, secs, peak = timed(lambda: pm.solve_problem_sharded(logical_mesh(size), problem, pg_cfg))
        d_x = float(np.abs(res.x - pg_ref.x).max())
        d_cost = abs(res.final_cost - pg_ref.final_cost) / max(1.0, pg_ref.final_cost)
        # Stated here: x within 1e-3 (positions on a 20-unit circle) and the
        # final cost within 1e-3 relative.
        if not np.isfinite(res.x).all() or d_x > 1e-3 or d_cost > 1e-3:
            raise AssertionError(f"mesh: sharded pose graph at size {size}: x {d_x}, cost {d_cost}")
        again = pm.solve_problem_sharded(logical_mesh(size), problem, pg_cfg)
        if not np.array_equal(again.x, res.x):
            raise AssertionError(f"mesh: two sharded pose-graph solves at size {size} differ")
        pg[str(size)] = {"ms": 1e3 * secs, "peak_mem_bytes": peak, "x_max_abs_err": d_x, "cost_rel_err": d_cost,
                         "run_to_run_bit_equal": True}
    out["pose_graph"] = {"poses": len(chain), "factors": problem.num_factors, "method": "cholesky",
                         "iterations": 15, "tolerance": {"x_abs": 1e-3, "cost_rel": 1e-3},
                         "final_cost": pg_ref.final_cost, **pg}

    # 6. The index over 4 slots on the bow_index phase's 50,000 histograms.
    hist, ids, planted, queries = index_scene()
    mesh4 = logical_mesh(4)
    plain = DeviceBoWIndex.from_histograms(ids, hist, device=dev)
    index = DeviceBoWIndex.from_histograms(ids, hist, mesh=mesh4)
    excused = index_against_host(index, queries, hist.astype(np.float64), planted, "mesh index")
    same_as_unsharded = sum(
        [i for i, _ in index.topk(q, k=INDEX_TOPK)] == [i for i, _ in plain.topk(q, k=INDEX_TOPK)] for q in queries)
    grown = DeviceBoWIndex(INDEX_VOCAB, 1024, mesh=mesh4)
    for i in range(INDEX_GROWN_ROWS):
        grown.add(ids[i], hist[i])
    bulk = DeviceBoWIndex.from_histograms(ids[:INDEX_GROWN_ROWS], hist[:INDEX_GROWN_ROWS], mesh=mesh4)
    if grown.capacity != INDEX_GROWN_ROWS or not torch.equal(grown._buf, bulk._buf):
        raise AssertionError("mesh index: the grown index's rows differ from a bulk load's")
    for q in queries[:20]:
        a, b = grown.topk(q, k=INDEX_TOPK), bulk.topk(q, k=INDEX_TOPK)
        if [i for i, _ in a] != [i for i, _ in b] or max(abs(x[1] - y[1]) for x, y in zip(a, b)) > 1e-6:
            raise AssertionError("mesh index: the grown index answers differently from the bulk load")
    out["index"] = {
        "rows": INDEX_ROWS, "slots": 4, "near_tie_positions_excused": excused, "equal_to_host_ranking": True,
        "queries_identical_to_unsharded": same_as_unsharded, "queries": len(queries), "grown_equals_bulk": True,
        "query_ms": median_ms(lambda: index.topk(queries[-1], k=INDEX_TOPK), warmup=3, iters=50),
        "unsharded_query_ms": median_ms(lambda: plain.topk(queries[-1], k=INDEX_TOPK), warmup=3, iters=50),
    }
    if torch.cuda.device_count() > 1:  # reported, not gated
        cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        mesh = logical_mesh(len(cards), cards)
        if WINDOW % mesh.size == 0:
            _, secs, _ = timed(lambda: pm.track_superwindow_meshed(mesh, key, prev, frames, K, fc, pc, window=WINDOW,
                                                                    start_index=1))
            out["distinct_cards"] = {"devices": cards, "superwindow_fps": n_sw / secs}
    emit({"phase": "mesh", **out, "launches": launches, "phase_seconds": time.perf_counter() - phase_t0})
    return launches


def phase_main(host_frames, build_s: float):
    import numpy as np
    import torch

    from mvslam_tpu_torch.core import prng
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
    from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
    from mvslam_tpu_torch.ops import cuda_fast, cuda_patches
    from mvslam_tpu_torch.ops.ransac import RansacConfig, _auto_pinned
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
    launches = read_launches("main_path")

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

    # The reduction form the pose stage's dual RANSAC took: the rule of
    # ops.ransac._auto_pinned on the correspondence count it was given.
    n_corr = int(tracks[0].matched_p1.shape[-2])
    ransac_form = {"correspondences": n_corr, "mesh_invariant": pc.mesh_invariant,
                   "pinned": _auto_pinned(n_corr, RansacConfig(mesh_invariant=pc.mesh_invariant))}

    emit({
        "phase": "main_path", "frames": frames_done, "frames_tracked": tracked, "ransac": ransac_form,
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
    parser.add_argument("--ab-k2", type=Path, metavar="OLD.cu",
                        help="also time this earlier extract_patches.cu against the current one")
    parser.add_argument("--long-offline", action="store_true",
                        help="also drive the offline phase's 1 + 60-frame scene (reported, not gated)")
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
    if args.ab_k2 is not None:
        phase_k2_ab(args.ab_k2.resolve(), frames_u8)
    by_path = {"main_path": phase_main(host_frames, build_s)}
    by_path["slam"], slam_summary = phase_slam(scene, torch.device("cuda", 0))
    by_path["flow"] = phase_flow(scene, torch.device("cuda", 0))
    by_path["slam_ba"] = phase_slam_ba(scene, torch.device("cuda", 0), slam_summary)
    phase_pose_graph(torch.device("cuda", 0))
    by_path["offline"], offline_no_loops = phase_offline(torch.device("cuda", 0), args.long_offline)
    by_path["reloc"] = phase_reloc(scene, torch.device("cuda", 0))
    by_path["async_stream"] = phase_async_stream(scene, torch.device("cuda", 0))
    by_path["async_ingest"] = phase_async_ingest(torch.device("cuda", 0))
    phase_native(torch.device("cuda", 0))
    by_path["native_ingest"], ingest_runs = phase_native_ingest(torch.device("cuda", 0))
    phase_eval(ingest_runs)
    by_path["animate"] = phase_animate(torch.device("cuda", 0), offline_no_loops)
    phase_bow_index(torch.device("cuda", 0))
    by_path["accuracy"] = phase_accuracy(torch.device("cuda", 0), k1, k2)
    by_path["mesh"] = phase_mesh(host_frames, torch.device("cuda", 0))
    if any(name.split(".")[0] in ("jax", "mvslam_tpu") for name in sys.modules):
        raise AssertionError("the port imported jax or the JAX package")
    for record in (k1, k2):
        name = record["name"]
        record["launches"] = by_path["main_path"][name]
        record["launches_by_path"] = {path: counts[name] for path, counts in by_path.items()}
        record["launch_shapes_by_path"] = {
            path: {shape_label(shape): n for shape, n in sorted(shapes[name].items())}
            for path, shapes in LAUNCH_SHAPES.items()
        }
        launched = {shape for shapes in LAUNCH_SHAPES.values() for shape in shapes[name]}
        if not launched <= COMPARED[name]:
            raise AssertionError(f"{name} ran at shapes it was never compared with its plain version at: "
                                 f"{sorted(shape_label(x) for x in launched - COMPARED[name])}")
        record["device_ms_from_events"] = [k for k in EVENT_TIMED if k and name in k]
    emit({"kernels": [k1, k2]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
