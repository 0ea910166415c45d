#!/usr/bin/env python3
"""Time the tracking path of two checkouts of the port on one card, in turns.

Usage, from the repository root on a machine with an NVIDIA GPU::

    git archive <commit> | tar -x -C _ab/parent      # an earlier checkout
    python3 tools/pose_stage_ab.py --roots _ab/parent . --order 0110

Each entry of ``--order`` indexes ``--roots`` and runs in a process of its
own, with that checkout's own ``chip_smoke.py`` and package (its kernels
built from its own sources): ``chip_smoke.phase_main`` (the bench's 193
frames: tracked frames/s), then one 16-frame window of the same frames
under ``torch.profiler`` (``chip_smoke.device_profile``: wall ms, device
ms, kernels and busy share) and its pose stage alone
(``estimate_pose_device`` on the window's 16 matched pairs), then
``chip_smoke.phase_slam_ba`` (``local_ba`` and pair-gate ms per keyframe).
The first run of each checkout also runs ``chip_smoke.phase_accuracy``
(the accuracy benchmark's ten metrics). Prints one JSON line per run and
a last line with all runs; ``--out`` also writes that line to a file.
``--count-ops --order 01`` counts instead, on the CPU, the tensor
operations of the pose stage and of the pair gate's RANSAC in each
checkout (``count_ops``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

PROFILE_ITERS = 5


def measure(root: Path, accuracy: bool) -> dict:
    """One checkout's numbers, in this process."""
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    import numpy as np
    import torch

    import mvslam_tpu_torch  # noqa: F401  (sets the f32 matmul precision)
    from mvslam_tpu_torch.core import prng
    from mvslam_tpu_torch.data.bench_frames import make_frames
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
    from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig, estimate_pose_device
    from mvslam_tpu_torch.slam import tracking

    records = []
    cs.emit = records.append  # keep the phases' records instead of printing them
    cs.phase_device()
    build_s = cs.phase_build()
    out = {"root": str(root), "device": records[0]}
    host_frames = [f.astype("uint8") for f in make_frames(cs.NUM_FRAMES)]
    cs.phase_main(host_frames, build_s)
    main = records[-1]
    out["main"] = {k: main.get(k) for k in ("tracked_fps", "elapsed_s", "frames_tracked", "launches", "ransac")}

    dev = torch.device("cuda", 0)
    fc = FeaturePipelineConfig(num_features=cs.NUM_FEATURES, max_matches=512)
    pc = RobustPoseEstimatorConfig(num_hypotheses=512)
    K = torch.tensor(cs.BENCH_K, dtype=torch.float32, device=dev)
    key = prng.key(0, device=dev)
    frames = torch.from_numpy(np.stack(host_frames[: 1 + cs.WINDOW])).to(dev)
    prev = tracking.bootstrap_frame(frames[0], fc)
    window = frames[1:]

    def one_window():
        return tracking.pull_scalars(tracking.track_window(key, prev, window, K, fc, pc, start_index=1)[1])

    _, track = tracking.track_window(key, prev, window, K, fc, pc, start_index=1)
    keys = prng.fold_in(key, 1 + torch.arange(cs.WINDOW, device=dev))  # track_window's keys

    def pose_stage():
        pose = estimate_pose_device(keys, track.matched_p1, track.matched_p2, track.match_mask, K, pc)
        return pose.use_essential.cpu()

    out["window"] = cs.device_profile(one_window, iters=PROFILE_ITERS)
    out["pose_stage"] = cs.device_profile(pose_stage, iters=PROFILE_ITERS)

    cs.phase_slam_ba(cs.render_scene_frames(), dev, {"tracked_fps": None, "ATE_RMSE": None})
    ba = records[-1]
    out["slam_ba"] = {k: ba.get(k) for k in ("local_ba_calls", "local_ba_ms", "pair_gate_ms", "solve_ms",
                                              "profile_one_pair_gate", "tracked_fps", "ATE_RMSE")}
    if accuracy:
        t0 = time.perf_counter()
        try:
            cs.phase_accuracy(dev, {"routes": []}, {"routes": []})
            out["accuracy_error"] = None
        except AssertionError as exc:  # the record came first; report the verdict beside it
            out["accuracy_error"] = str(exc)
        acc = next(r for r in reversed(records) if r.get("phase") == "accuracy")
        out["accuracy"] = {"status": acc["status"], "seconds": time.perf_counter() - t0,
                           "metrics": {k: v["value"] for k, v in acc["metrics"].items()},
                           "per_frame": {k: v.get("per_frame") for k, v in acc["runs"].items() if "per_frame" in v}}
    return out


def count_ops(root: Path) -> dict:
    """Tensor operations dispatched (views left out: they launch nothing)
    by the pose stage of one 16-pair window at 512 matches and by the
    window-BA pair gate's RANSAC (192 matches, 128 hypotheses), on the CPU.
    On the card each is about one kernel launch."""
    sys.path.insert(0, str(root))
    import collections

    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from mvslam_tpu_torch.core import prng
    from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig, estimate_pose_device
    from mvslam_tpu_torch.ops.ransac import RansacConfig, ransac_essential

    views = {"view", "_unsafe_view", "as_strided", "select", "slice", "expand", "unsqueeze", "squeeze", "t",
             "transpose", "permute", "alias", "detach", "unbind", "split", "split_with_sizes", "narrow",
             "reshape", "_reshape_alias", "lift_fresh", "diagonal", "unfold"}

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ not in views:
                self.ops[func.overloadpacket.__name__] += 1
            return func(*args, **(kwargs or {}))

    def counted(fn):
        fn()
        with Count() as c:
            fn()
        return {"ops": sum(c.ops.values()), "most": dict(c.ops.most_common(6))}

    rng = np.random.default_rng(0)
    p1 = torch.from_numpy(rng.uniform(0, 1000, (16, 512, 2)).astype(np.float32))
    p2 = p1 + torch.from_numpy(rng.normal(5, 2, (16, 512, 2)).astype(np.float32))
    K = torch.tensor([[718.856, 0.0, 607.19], [0.0, 718.856, 185.22], [0.0, 0.0, 1.0]])
    keys = prng.fold_in(prng.key(0), 1 + torch.arange(16))
    mask = torch.ones(16, 512, dtype=torch.bool)
    n1 = torch.from_numpy(rng.normal(0, 0.3, (192, 2)).astype(np.float32))
    return {
        "root": str(root),
        "pose_stage_16_pairs": counted(lambda: estimate_pose_device(
            keys, p1, p2, mask, K, RobustPoseEstimatorConfig(num_hypotheses=512))),
        "pair_gate_ransac": counted(lambda: ransac_essential(
            prng.key(0), n1, n1 + 0.01, torch.ones(192, dtype=torch.bool),
            RansacConfig(num_hypotheses=128, min_inliers=8), threshold=0.003)),
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--roots", nargs="+", type=Path, help="checkouts of the repository")
    parser.add_argument("--order", default="0110", help="indices into --roots, one run each, in turn")
    parser.add_argument("--out", type=Path, help="also write the last line here")
    parser.add_argument("--count-ops", action="store_true",
                        help="count each checkout's tensor operations on the CPU instead (no card needed)")
    parser.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    parser.add_argument("--accuracy", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.measure is not None:
        result = count_ops(args.measure.resolve()) if args.count_ops else measure(args.measure.resolve(), args.accuracy)
        print("RESULT " + json.dumps(result), flush=True)
        return 0
    runs, seen = [], set()
    for i in (int(c) for c in args.order):
        root = args.roots[i].resolve()
        cmd = [sys.executable, str(Path(__file__).resolve()), "--measure", str(root)]
        if args.count_ops:
            cmd.append("--count-ops")
        elif i not in seen:
            cmd.append("--accuracy")
        seen.add(i)
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=root)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise SystemExit(f"the run of {root} failed with exit code {proc.returncode}")
        runs.append({"index": i, **json.loads(lines[-1][len("RESULT "):])})
        print(json.dumps(runs[-1]), flush=True)
    summary = json.dumps({"runs": runs})
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(summary + "\n")
    print(summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
