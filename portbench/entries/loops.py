"""The ``loops`` entry: ``run_visual_slam``, the offline CLI's entry point,
with loop closure on, over the configuration's route written as a KITTI
directory of PNG files.

Set-up writes the rendered route under the run's own directory as
``sequences/<name>/image_0/NNNNNN.png`` (8-bit grey, every row filtered
with PNG's Sub filter, zlib), ``calib.txt`` with P0 and ``times.txt`` at
the camera's rate, then warms up with a pass over the route's first
``warmup["frames"]`` frames, read by the same loader and decoder: past the
BoW gap every keyframe is a candidate, so the loop geometry's launches and
the gates run as in the window. The route revisits its start only after a
whole lap (frames 1,076-1,100 re-drive 0-24), and no earlier candidate
passes verification, so neither the warm-up nor a window that ends before
the revisit solves a pose graph.

The window runs passes closed loop. Each pass reads the directory through
the KITTI reader's own iterator (``KittiSequence.iter_frames``: the native
PNG decoder on its loader thread), wrapped so that it ends once the
window's seconds have passed; a pass that reaches the route's last frame
ends there, and the next pass starts from frame 0 in a new call.
``tracked_fps`` is the frames posed in the window over its wall seconds,
to the return of the last call (``finalize_run`` included). The traced
stretch is a pass like the warm-up's, from frame 0, before the window.

The judge reads the window's first pass: its diagnostics and keyframes,
each frame's pose relative to the one before as the tracking step chained
it, before any loop correction, and its loop records, detected and
accepted.
"""

from __future__ import annotations

import contextlib
import math
import struct
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

import numpy as np

from portbench import drive
from portbench.reference.judge import ProgramAnswers

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def png_bytes(image: np.ndarray) -> bytes:
    """An (H, W) uint8 frame as an 8-bit grey PNG, each row Sub-filtered."""
    h, w = image.shape
    rows = np.empty((h, w + 1), np.uint8)
    rows[:, 0] = 1  # filter type Sub: each byte less the one to its left
    rows[:, 1] = image[:, 0]
    rows[:, 2:] = np.diff(image, axis=1)  # uint8 arithmetic wraps modulo 256, as the filter does

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    header = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    return PNG_SIGNATURE + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b"")


def write_kitti(root: Path, frames: np.ndarray, camera: dict, sequence: str) -> Path:
    """The frames as a KITTI odometry sequence under ``root``; returns it."""
    seq = root / "sequences" / sequence
    images = seq / "image_0"
    images.mkdir(parents=True)

    def write(i: int) -> None:
        (images / f"{i:06d}.png").write_bytes(png_bytes(frames[i]))

    with ThreadPoolExecutor(8) as pool:  # zlib lets go of the interpreter lock
        list(pool.map(write, range(len(frames))))
    fx, fy, cx, cy = (float(camera[k]) for k in ("fx", "fy", "cx", "cy"))
    (seq / "calib.txt").write_text(f"P0: {fx!r} 0 {cx!r} 0 0 {fy!r} {cy!r} 0 0 0 1 0\n")
    rate = float(camera["rate_hz"])
    (seq / "times.txt").write_text("".join(f"{i / rate:.6e}\n" for i in range(len(frames))))
    return root


class LoopAnswers(ProgramAnswers):
    """One pass's answers. A frame's relative pose is the one the tracking
    step chained for it, before any loop correction moved the trajectory;
    ``detected`` holds the pass's loop records, ``accepted`` those of its
    accepted loops, which the checks of loop edges and pose graphs judge."""

    def __init__(self, summary):
        system = summary.system
        diags = {d.frame_id: d for d in system.diagnostics}
        super().__init__(
            diags=diags,
            trajectory=dict(zip(system.trajectory.frame_ids, (np.asarray(p) for p in system.trajectory.poses))),
            keyframes={kf.frame_id: (kf.keypoints, kf.descriptors, kf.valid) for kf in system.keyframes.keyframes},
            prev_of={f: f - 1 for f in diags if f > 0},
        )
        self.odometry = summary.odometry
        self.detected: List[dict] = summary.loop_records
        self.accepted = [r for r in self.detected if r["gate"] is None]

    def relative(self, anchor):
        rel = np.linalg.inv(self.odometry[anchor.frame])  # X_cur = R X_prev + t
        return rel[:3, :3], rel[:3, 3]


class Driver(drive.Driver):
    """Closed loop over ``run_visual_slam``, one pass a call."""

    def __init__(self, name, config, traffic, cell, host_frames, device, seed, output_root):
        from mvslam_tpu_torch.slam.offline import SLAMRunConfig

        self.config, self.traffic, self.cell = config, traffic, cell
        self.frames = host_frames  # (F, H, W) uint8, numpy
        self.device = device
        self.root = Path(output_root)
        self.sequence = str(config["sequence"]["name"])
        self.run_config = lambda run_id: SLAMRunConfig(
            input_path=self.root / "kitti",
            input_kind="kitti",
            sequence=self.sequence,
            run_id=run_id,
            output_root=self.root / "runs",
            seed=int(seed) & 0x7FFFFFFF,
            **config["pipeline"]["run"],
        )
        self.calls = 0
        self.all_spans: List[tuple] = []
        self.window_unix = [math.inf, -math.inf]
        self.window_s = None
        self.judged = None
        self.warmup = {}

    def run_pass(self, max_frames=None, deadline=None) -> dict:
        """One ``run_visual_slam`` call over the directory through
        ``KittiSequence.iter_frames``, from frame 0: over its first
        ``max_frames`` frames, or ending at ``deadline`` (``perf_counter``
        seconds) after its first frame; returns its summary and keeps its
        spans."""
        from mvslam_tpu_torch.data.kitti import KittiSequence
        from mvslam_tpu_torch.slam.offline import run_visual_slam

        sequence = KittiSequence(self.root / "kitti", self.sequence)

        def source(recorder):
            with contextlib.closing(sequence.iter_frames(max_frames, recorder=recorder)) as packets:
                for i, packet in enumerate(packets):
                    if i and deadline is not None and time.perf_counter() >= deadline:
                        return
                    yield packet

        self.calls += 1
        summary = run_visual_slam(self.run_config(f"portbench_loops_{self.calls}"), device=self.device, source=source)
        events = summary.system.telemetry.events()
        self.all_spans.extend((e.name, e.timestamp_s - e.duration_s, e.timestamp_s) for e in events)
        return summary

    @staticmethod
    def outline(summary: dict) -> dict:
        """What a pass did: frames read and posed, the last frame reached,
        loops detected and accepted, rejections by gate, the mean
        ``loop_geometry`` span in ms."""
        diags = summary.system.diagnostics
        gates: Dict[str, int] = {}
        for r in summary.loop_records:
            if r.get("gate"):
                gates[r["gate"]] = gates.get(r["gate"], 0) + 1
        geometry = [e.duration_s for e in summary.system.telemetry.events() if e.name == "loop_geometry"]
        return {
            "frames": len(diags),
            "posed": sum(d.pose_success for d in diags),
            "last_frame": diags[-1].frame_id if diags else -1,
            "loops_detected": len(summary["loops_detected"]),
            "loops_accepted": len(summary["loops_accepted"]),
            "rejected": gates,
            "loop_geometry_ms": 1e3 * sum(geometry) / len(geometry) if geometry else None,
        }

    def setup(self) -> None:
        write_kitti(self.root / "kitti", self.frames, self.config["camera"], self.sequence)
        self.warmup = self.outline(self.run_pass(max_frames=int(self.traffic["warmup"]["frames"])))

    def trace(self, tracer) -> None:
        """A pass over the route's first frames, as the warm-up's, under
        the profiler, before the window, which runs untraced."""
        tracer.start()
        summary = self.run_pass(max_frames=int(self.traffic["trace"]["frames"]))
        tracer.stop(self.outline(summary)["posed"])

    def window(self, seconds: float, tracer=None) -> dict:
        if tracer is not None:
            self.trace(tracer)
        passes = []
        posed = attempted = 0
        self.window_unix = [time.time(), None]
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            summary = self.run_pass(deadline=deadline)
            if self.judged is None:
                self.judged = LoopAnswers(summary)
            passes.append(self.outline(summary))
            del summary
            posed += passes[-1]["posed"]
            attempted += passes[-1]["frames"]
            if time.perf_counter() >= deadline:
                break
        elapsed = time.perf_counter() - t0
        self.window_unix[1] = time.time()
        self.window_s = elapsed
        return {
            "attempted": attempted,
            "failed": attempted - posed,
            "metrics": {"tracked_fps": posed / elapsed},
            "window_s": elapsed,
            "passes": passes,
            "warmup": self.warmup,
        }

    def spans(self):
        return list(self.all_spans)

    def answers(self) -> LoopAnswers:
        return self.judged

    def extra(self) -> dict:
        return {"window_s": self.window_s}
