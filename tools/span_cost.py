"""What the port's spans cost when they record, and how far a device span's
clock drifts from the host's, on a CUDA card.

    python3 tools/span_cost.py [--spans 100000] [--device-spans 4000] [--drift 1,5,15]

Prints one JSON line: ns of host time per host span (``timed_event``) and
per device span (``device_span`` on an idle stream, and the later
placement of its events on the recorder's clock), each beside the same
loop without a recorder; and, for an anchor taken once, the error of the
time it gives a second anchor's event 1, 5, 15 s later (the drift a span
would carry without the anchor's renewal), beside how far unix time moved
from the monotonic clock over the same seconds.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from mvslam_tpu_torch.core.telemetry import (  # noqa: E402
    RunTelemetryRecorder,
    _DeviceClock,
    device_span,
    timed_event,
)


def _ns_per(loop, n: int) -> float:
    start = time.perf_counter_ns()
    loop(n)
    return (time.perf_counter_ns() - start) / n


def host_span_ns(n: int) -> dict:
    def spans(recorder):
        def loop(k):
            for _ in range(k):
                with timed_event(recorder, "x"):
                    pass

        return loop

    _ns_per(spans(RunTelemetryRecorder()), 1000)  # warm
    return {"with_recorder": _ns_per(spans(RunTelemetryRecorder()), n), "without": _ns_per(spans(None), n)}


def device_span_ns(n: int, device) -> dict:
    def spans(recorder):
        def loop(k):
            for _ in range(k):
                with device_span(recorder, "x", device):
                    pass

        return loop

    rec = RunTelemetryRecorder()
    spans(rec)(100)
    rec.events()
    rec = RunTelemetryRecorder()
    spans(rec)(1)  # the first span synchronises once, to anchor the device's clock
    torch.cuda.synchronize(device)
    enter_exit = _ns_per(spans(rec), n)
    torch.cuda.synchronize(device)
    start = time.perf_counter_ns()
    placed = len(rec.events())
    resolve = (time.perf_counter_ns() - start) / n
    return {"with_recorder": enter_exit, "without": _ns_per(spans(None), n), "placing": resolve, "spans": placed}


def drift_us(after_s, device) -> dict:
    """By the first anchor's age: the host time an anchor taken once gives
    a later anchor's event, less that anchor's own host time (``device``);
    and how far unix time has moved from the monotonic clock the recorder
    maps to it once (``unix``: an adjusted system clock)."""
    rec = RunTelemetryRecorder()
    stream = torch.cuda.current_stream(device)
    torch.cuda.synchronize(device)
    first = _DeviceClock(rec.now)
    first._take_anchor(stream)
    anchor, at = first.anchor
    unix0 = time.time_ns() - time.perf_counter_ns()
    out, t0 = {"device": {}, "unix": {}}, time.perf_counter()
    for age in after_s:
        time.sleep(max(0.0, t0 + age - time.perf_counter()))
        torch.cuda.synchronize(device)
        later = _DeviceClock(rec.now)
        later._take_anchor(stream)
        event, event_at = later.anchor
        out["device"][str(age)] = 1e6 * (at + anchor.elapsed_time(event) / 1e3 - event_at)
        out["unix"][str(age)] = (time.time_ns() - time.perf_counter_ns() - unix0) / 1e3
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--spans", type=int, default=100_000)
    parser.add_argument("--device-spans", type=int, default=4000)
    parser.add_argument("--drift", default="1,5,15")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_cost: needs a CUDA device", file=sys.stderr)
        return 4
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    result = {
        "card": card,
        "host_span_ns": host_span_ns(args.spans),
        "device_span_ns": device_span_ns(args.device_spans, device),
        "drift_us": drift_us([float(a) for a in args.drift.split(",")], device),
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
