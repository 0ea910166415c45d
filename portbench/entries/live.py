"""The ``live`` entry: ``SLAMSystem.run_stream_async`` fed one frame at a
time at the cell's fixed ``rate_hz`` (open loop), each frame's latency
timed from when it was due to when the system handed back its diagnostics
with a pose. Set-up warms on a system of its own (see ``Driver.setup``)."""

from __future__ import annotations

import math
import time
from pathlib import Path
from typing import Dict, List, Optional

from portbench import drive
from portbench.stats import percentile


def _handed_features(diag) -> bool:
    """Whether the feature plane handed the frame's features to the tracker
    (not dropped, expired or failed in extraction): the tracker then
    matches the next frame against it."""
    return diag.model_type == "bootstrap" or diag.num_features > 0


class _TimedList(list):
    """The system's diagnostics list, stamping when each record is handed
    back."""

    def __init__(self, items):
        super().__init__(items)
        self.stamps: Dict[int, float] = {}

    def append(self, diag) -> None:
        self.stamps[diag.frame_id] = time.perf_counter()
        super().append(diag)


class Driver(drive.Driver):
    """Open loop over ``run_stream_async`` at the cell's fixed rate."""

    def _configs(self):
        from mvslam_tpu_torch.runtime.feature_plane import FeatureControlConfig
        from mvslam_tpu_torch.runtime.tracking_plane import TrackingControlConfig

        return (
            FeatureControlConfig(**self.traffic.get("feature_control", {})),
            TrackingControlConfig(**self.traffic.get("tracking_control", {})),
        )

    def _packet(self, p: int):
        from mvslam_tpu_torch.runtime.frame_stream import FramePacket

        return FramePacket(index=p, timestamp=p / self.rate, frame=self.frame(p))

    def setup(self) -> None:
        # Warm on a system of its own: a second run_stream_async on one
        # system starts a feature plane that waits for sequence number 0
        # while the frame ids go on, and every frame expires.
        warm = self._new_system("portbench_warmup")
        warm.run_stream_async([self._packet(p) for p in range(int(self.traffic["warmup_frames"]))], *self._configs())
        del warm
        self._all_diags = []

    def window(self, seconds: float, tracer=None) -> dict:
        rate = float(self.cell["rate_hz"])
        start_pos = self.pos
        stamps = _TimedList(self.system.diagnostics)
        self.system.diagnostics = stamps
        due: Dict[int, float] = {}
        lateness: List[float] = []
        trace_s = float(self.traffic["trace_seconds"])

        def packets():
            # The schedule stops while the profiler starts and stops (a
            # traced run reports no end-to-end metric), so no burst follows.
            t0 = time.perf_counter()
            i = 0
            while i / rate < seconds:
                if tracer is not None and (i == 0 or (tracer.active and i / rate >= trace_s)):
                    now = time.perf_counter()
                    if i == 0:
                        tracer.start()
                    else:
                        tracer.stop(sum(1 for f in stamps.stamps if f in due))
                        self.window_unix[0] = time.time()
                    t0 += time.perf_counter() - now
                target = t0 + i / rate
                now = time.perf_counter()
                if now < target:
                    time.sleep(target - now)
                p = start_pos + i
                due[p] = target
                lateness.append(max(0.0, time.perf_counter() - target))
                yield self._packet(p)
                i += 1

        self.window_unix = [time.time(), None]
        t0 = time.perf_counter()
        diags = self.system.run_stream_async(packets(), *self._configs())
        wall = time.perf_counter() - t0
        self.window_unix[1] = time.time()
        if tracer is not None and tracer.active:
            tracer.stop(sum(1 for f in stamps.stamps if f in due))
        self.pos = start_pos + len(due)
        self.window_diags = [d for d in diags if d.frame_id in due]
        self._all_diags += list(diags)
        posed = {d.frame_id for d in self.window_diags if d.pose_success}
        lat = [
            (stamps.stamps[f] - due[f]) * 1e3 if f in posed and f in stamps.stamps else math.inf
            for f in sorted(due)
        ]
        report_path = self.system.run_dir / "reports" / "control_plane_report.json"
        self.report = self._load(report_path)
        return {
            "attempted": len(due),
            "failed": len(due) - len(posed),
            "metrics": {
                "pose_latency_p50_ms": percentile(lat, 50),
                "pose_latency_p90_ms": percentile(lat, 90),
            },
            "window_s": wall,
            "generator_late_ms_max": max(lateness) * 1e3 if lateness else 0.0,
            "dropped": sum(1 for d in self.window_diags if not _handed_features(d)),
            "latencies_ms": lat,
        }

    @staticmethod
    def _load(path: Path) -> Optional[dict]:
        import json

        return json.loads(path.read_text()) if path.exists() else None

    def prev_of(self) -> Dict[int, int]:
        out, last = {}, None
        for d in sorted(self._all_diags, key=lambda d: d.frame_id):
            ok = _handed_features(d)
            if last is not None and ok:
                out[d.frame_id] = last
            if ok:
                last = d.frame_id
        return out

    def extra(self) -> dict:
        return {"control_plane": self.report}
