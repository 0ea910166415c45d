"""The ``offline`` entry: ``SLAMSystem.run_sequence`` over the rendered
sequence replayed ping-pong, one dispatch (``window`` x
``windows_per_dispatch`` frames) a call, on one system, as fast as it goes
(closed loop). Set-up warms the dispatch's shapes on the system the window
goes on with, in the same stream."""

from __future__ import annotations

import statistics
import time
from typing import Dict

from portbench import drive


class Driver(drive.Driver):
    """Closed loop over ``run_sequence``, one dispatch a call."""

    def _call(self, n: int):
        ps = range(self.pos, self.pos + n)
        diags = self.system.run_sequence(
            [self.frame(p) for p in ps],
            [p / self.rate for p in ps],
            window=int(self.traffic["window"]),
            windows_per_dispatch=int(self.traffic["windows_per_dispatch"]),
        )
        self.pos += n
        return diags

    def dispatch(self) -> int:
        return int(self.traffic["window"]) * int(self.traffic["windows_per_dispatch"])

    def setup(self) -> None:
        # The first frame bootstraps; then one dispatch with the frames the
        # warm-up asks for (the dispatch is padded to its full size, so the
        # device runs the window's shapes).
        self._call(1 + int(self.traffic["warmup_frames"]))

    def trace(self, tracer) -> None:
        """Whole dispatches under the profiler, until ``trace_seconds`` have
        passed (at least one); before the window, which runs untraced."""
        tracer.start()
        t0 = time.perf_counter()
        frames = 0
        while True:
            frames += sum(d.pose_success for d in self._call(self.dispatch()))
            if time.perf_counter() - t0 >= float(self.traffic["trace_seconds"]):
                break
        tracer.stop(frames)

    def window(self, seconds: float, tracer=None) -> dict:
        if tracer is not None:
            self.trace(tracer)
        start_pos = self.pos
        calls = []
        self.window_unix = [time.time(), None]
        t0 = time.perf_counter()
        while True:
            t1 = time.perf_counter()
            self.window_diags.extend(self._call(self.dispatch()))
            calls.append(time.perf_counter() - t1)
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        self.window_unix[1] = time.time()
        posed = sum(d.pose_success for d in self.window_diags)
        return {
            "attempted": self.pos - start_pos,
            "failed": self.pos - start_pos - posed,
            "metrics": {"tracked_fps": posed / elapsed},
            "window_s": elapsed,
            "dispatch_s_quartiles": statistics.quantiles(calls, n=4) if len(calls) > 1 else calls,
        }

    def prev_of(self) -> Dict[int, int]:
        return {d.frame_id: d.frame_id - 1 for d in self.window_diags if d.frame_id > 0}
