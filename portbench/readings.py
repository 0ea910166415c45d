"""Readings that set the judge's limits: the judged numbers of the program
over many seeds and of the control (the reference in bfloat16 in the
program's place) on some of them, in one process, with short windows at
the cell's own load.

    python3 -m portbench.readings --workload <cell> --seeds 11,12,... --control-seeds 3 --seconds 6

One JSON line per seed on standard output (also appended, with the
judge's per-anchor record, to ``chiprun_out/readings.jsonl``); the largest
reading of each number over the program's seeds and the smallest over the
control's at the end. ``--numbers`` names the numbers judged (by default
every number the judge has, whichever the cell limits).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import run, spec  # noqa: E402
from portbench.reference.judge import NUMBERS  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--control-seeds", type=int, default=3, help="judge the control on the first N seeds")
    parser.add_argument("--seconds", type=float, default=6.0)
    parser.add_argument("--out", default="chiprun_out/readings.jsonl")
    parser.add_argument("--numbers", default=",".join(NUMBERS), help="comma-separated")
    args = parser.parse_args(argv)
    run.set_cache_dirs()
    seeds = [int(s) for s in args.seeds.split(",")]
    wanted = tuple(args.numbers.split(","))
    program, control = {k: [] for k in wanted}, {k: [] for k in wanted}
    out = spec.ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    for i, seed in enumerate(seeds):
        res = run.run_cell(args.workload, seed, args.seconds, False, control=i < args.control_seeds, wanted=wanted)
        line = {
            "workload": args.workload,
            "seed": seed,
            "correct": res["correct"],
            "attempted": res["attempted"],
            "failed": res["failed"],
            "program": {k: res["judge"][k] for k in wanted},
            "control": res.get("control_checks"),
            "judge": res["judge"],
        }
        for k in wanted:
            program[k].append(line["program"].get(k, math.nan))
            if line["control"]:
                control[k].append(line["control"][k])
        text = json.dumps(line, default=str)
        print(text, flush=True)
        with open(out, "a") as f:
            f.write(json.dumps({**line, "details": res["judge_details"]}, default=str) + "\n")
    summary = {
        "workload": args.workload,
        "lower": {k: max(v) for k, v in program.items()},
        "upper": {k: min(v) for k, v in control.items() if v},
    }
    print(json.dumps(summary, default=str), flush=True)
    with open(out, "a") as f:
        f.write(json.dumps(summary, default=str) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
