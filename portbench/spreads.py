"""Spreads of a cell's end-to-end metrics over sets of runs, and the bound
they suggest.

    python3 -m portbench.spreads <dir> <cell>

reads the result files ``<dir>/<cell>.<set>.<seed>.out`` (the last line of
``portbench.run``'s standard output; sets named ``A``, ``B``, ...), and
prints for each metric each set's median and spread (the distance between
the first and third quartiles over the median) and five times the widest
spread, never under 1%: the bound to start from.
"""

from __future__ import annotations

import collections
import json
import statistics
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.stats import spread  # noqa: E402


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    folder, cell = Path(args[0]), args[1]
    values = collections.defaultdict(lambda: collections.defaultdict(list))
    correct = collections.Counter()
    for path in sorted(folder.glob(f"{cell}.*.out")):
        set_name = path.name[len(cell) + 1 :].split(".", 1)[0]
        lines = path.read_text().strip().splitlines()
        if not lines:
            continue
        result = json.loads(lines[-1])
        correct[(set_name, result["correct"])] += 1
        for name, metric in result["metrics"].items():
            values[name][set_name].append(metric["value"])
    print(json.dumps({"correct": {f"{s}:{c}": n for (s, c), n in sorted(correct.items())}}))
    for name, sets in values.items():
        rows = {s: {"median": statistics.median(v), "spread": spread(v), "runs": v} for s, v in sets.items() if len(v) >= 2}
        widest = max((r["spread"] for r in rows.values()), default=float("nan"))
        print(json.dumps({"metric": name, "sets": rows, "widest": widest, "bound": max(0.01, 5 * widest)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
