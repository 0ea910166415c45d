"""One-off rate sweep of a live cell: the cell at each offered rate, for a
fixed window, in one process. It finds the highest rate the system
sustains without a growing backlog; the cell file then fixes its
``rate_hz`` at four fifths of that.

    python3 -m portbench.sweep --workload tum.live --rates 2,2.5,3,3.5,4 --seconds 20 --seed 7

A rate is sustained when every offered frame was posed or failed only in
its pose gates (nothing dropped or expired) and the median latency of the
window's last third is within a quarter of its first third's. One JSON
line per rate; the sustained maximum last.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import run  # noqa: E402


def backlog_growth(latencies_ms) -> float:
    """Median latency of the last third over the first third's (finite
    values only)."""
    third = max(1, len(latencies_ms) // 3)
    first = [x for x in latencies_ms[:third] if math.isfinite(x)]
    last = [x for x in latencies_ms[-third:] if math.isfinite(x)]
    if not first or not last:
        return math.inf
    return statistics.median(last) / statistics.median(first)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", default="tum.live")
    parser.add_argument("--rates", required=True, help="comma-separated frames/s")
    parser.add_argument("--seconds", type=float, default=20.0)
    parser.add_argument("--seed", type=int, default=7)
    args = parser.parse_args(argv)
    run.set_cache_dirs()
    sustained = None
    for rate in (float(r) for r in args.rates.split(",")):
        res = run.run_cell(args.workload, args.seed, args.seconds, False, overrides={"cell": {"rate_hz": rate}})
        lat = res["window"]["latencies_ms"]
        growth = backlog_growth(lat)
        dropped = res["window"]["dropped"]
        ok = dropped == 0 and growth <= 1.25
        if ok:
            sustained = rate
        print(json.dumps({
            "rate_hz": rate,
            "offered": res["attempted"],
            "failed": res["failed"],
            "dropped": dropped,
            "p50_ms": res["metrics"]["pose_latency_p50_ms"]["value"],
            "p90_ms": res["metrics"]["pose_latency_p90_ms"]["value"],
            "backlog_growth": growth,
            "generator_late_ms_max": res["window"]["generator_late_ms_max"],
            "correct": res["correct"],
            "sustained": ok,
        }, default=str), flush=True)
    print(json.dumps({"sustained_max_hz": sustained, "cell_rate_hz": None if sustained is None else 0.8 * sustained}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
