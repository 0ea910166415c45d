"""Runs one cell of the benchmark once and prints its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up renders the configuration's sequence from the seed on the card,
builds ``SLAMSystem`` and warms the cell's own shapes; the window then
drives the system for ``--seconds``. With ``--trace 1`` a stretch of the
window runs under the device profiler and the per-layer metrics are
printed in place of the end-to-end ones. After the window the judge
(``reference/``) compares a sample of the program's answers with the
plain reference. The last line of standard output is the result as JSON;
the judged numbers and their limits are the last lines of standard error.
"""

from __future__ import annotations

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):  # run as a script: the checkout's root holds both packages
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mvslam_tpu")
NEVER = 1e9  # the latency, in ms, reported for a percentile over frames never posed
CACHE = spec.ROOT / ".portbench_cache"


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's (names compared whole)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def device_info(device) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": 1,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0)),
    }


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda", control: bool = False, overrides=None, wanted=None) -> dict:
    """One run of cell ``name``; returns the result with its judged numbers
    (``checks``). ``control`` also judges the reference in a lower
    precision in the program's place, on the same sample
    (``control_checks``); ``overrides`` updates parts of the cell's files
    (a test's smaller size, a sweep's rate); ``wanted`` names the numbers
    the judge computes (by default those the cell limits)."""
    import torch

    from portbench import scene
    from portbench.reference.judge import ControlAnswers, Judge, verdict
    from portbench.trace import DeviceTracer, breakdown

    cell = spec.find(name)
    for key, value in (overrides or {}).items():
        getattr(cell, key).update(value)
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(device)
    out_root = Path(tempfile.gettempdir()) / "portbench_runs" / name
    shutil.rmtree(out_root, ignore_errors=True)
    try:
        import mvslam_tpu_torch  # noqa: F401  (set-up: the program loads)

        rendered = scene.render(cell.config, seed, device)
        print(f"scene: {len(rendered.frames)} frames rendered in {rendered.seconds:.3f} s", file=sys.stderr)
        host_frames = rendered.frames.cpu().numpy()
        driver = spec.driver(cell.traffic["entry"])(
            name, cell.config, cell.traffic, cell.cell, host_frames, device, seed, out_root
        )
        driver.setup()
        if device.type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - _STARTED

        tracer = None
        if trace:
            from mvslam_tpu_torch.ops.cuda_fast import fast_detect
            from mvslam_tpu_torch.ops.cuda_patches import extract_patches

            tracer = DeviceTracer({"k1": fast_detect, "k2": extract_patches})
        window = driver.window(seconds, tracer)
        info = device_info(device)  # the peak, before the judge runs

        answers = driver.answers()
        spans = driver.spans()
        window_spans = driver.window_spans()
        extra = driver.extra()
        del driver
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        bad = forbidden_modules()
        judge_cfg = cell.traffic["judge"]
        judge = Judge(cell.config, rendered.frames, rendered.intrinsics, seed, device, judge_cfg["sample"], judge_cfg["keep"])
        limits = cell.cell["limits"]
        wanted = tuple(limits) if wanted is None else tuple(wanted)
        anchors = judge.anchors(answers)
        numbers = judge.judge(answers, anchors, wanted)
        correct = verdict(numbers, limits) and not bad

        result = {
            "correct": bool(correct),
            "attempted": int(window["attempted"]),
            "failed": int(window["failed"]),
            "metrics": {},
            "device": info,
        }
        units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
        if not trace:
            values = dict(window["metrics"], setup_s=setup_s)
            for m in cell.end_to_end:
                # A percentile that falls on a frame never posed is later
                # than any limit: a number, since the line holds numbers.
                value = values[m["name"]] if math.isfinite(values[m["name"]]) else NEVER
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            t = tracer.trace
            ctx = {"trace": t, "spans": window_spans, "cell": cell, **extra}
            for m in cell.per_layer:
                value = spec.reader(m["name"])(ctx)
                if value is not None:
                    result["metrics"][m["name"]] = {"value": value, "unit": units[m["name"]]}
            if t is not None:
                result["device"]["busy_s"] = t.busy_s()
                result["device"]["window_s"] = t.window_s
                result["breakdown"] = breakdown(t, spans)
                result["trace_overhead_s"] = tracer.overhead
        result["checks"] = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
        if bad:
            result["checks"]["forbidden_modules"] = {"value": len(bad), "limit": 0}
        if control:
            result["control_checks"] = judge.judge(ControlAnswers(judge), anchors, wanted)
        result["forbidden"] = bad
        result["window"] = {k: v for k, v in window.items() if k != "metrics"}
        result["judge"] = {k: numbers[k] for k in ("frames_checked", "anchors", *wanted)}
        result["judge_details"] = judge.details
        return result
    finally:
        shutil.rmtree(out_root, ignore_errors=True)


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def _clean(obj):
    """``obj`` with every number that is not finite written as a string
    (JSON has no infinity)."""
    if isinstance(obj, dict):
        return {k: _clean(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_clean(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    return obj


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = spec.find(args.workload)
    set_cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(
            f"portbench: needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
            file=sys.stderr,
        )
        return 4
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    if result.pop("forbidden"):
        print(f"portbench: loaded {forbidden_modules()} in the measuring process", file=sys.stderr)
        for k, v in result["checks"].items():
            print(f"check {k}: {_finite(v['value'])} (limit {v['limit']})", file=sys.stderr)
        return 5
    line = {k: v for k, v in result.items() if k not in ("checks", "window", "judge", "judge_details", "control_checks")}
    line["window"] = {k: v for k, v in result["window"].items() if k != "latencies_ms"}
    line["judge"] = result["judge"]
    line["checks"] = result["checks"]  # last: each judged number beside its limit
    print(json.dumps(_clean(line)), file=sys.stdout)
    for k, v in result["checks"].items():
        print(f"check {k}: {_finite(v['value'])} (limit {v['limit']})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
