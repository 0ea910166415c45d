"""The port's evaluation layer (``mvslam_tpu_torch/eval``: baselines, the
harness, the regression gate, the CI scorer, governance, determinism
validation, readiness) against the JAX package's on the same inputs.

Summaries are compared as JSON. What may differ, and is dropped by name
before the comparison: paths of run directories (each package writes its
own) and wall-clock fields (``updated_at``, ``elapsed_s``,
``peak_rss_bytes``). Digests are compared as strings. The harness is run
over a run directory written by the port and over one written by the
reference, in both packages.
"""

import asyncio
import json
from pathlib import Path

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)

from mvslam_tpu.eval import baselines as jbaselines
from mvslam_tpu.eval import ci_runner as jci
from mvslam_tpu.eval import determinism_validation as jdet
from mvslam_tpu.eval import governance as jgov
from mvslam_tpu.eval import harness as jharness
from mvslam_tpu.eval import readiness as jready
from mvslam_tpu.eval import regression_gate as jgate
from mvslam_tpu.slam import runner as jrunner
from mvslam_tpu_torch.data.synthetic import write_kitti_sequence
from mvslam_tpu_torch.eval import baselines as tbaselines
from mvslam_tpu_torch.eval import ci_runner as tci
from mvslam_tpu_torch.eval import determinism_validation as tdet
from mvslam_tpu_torch.eval import governance as tgov
from mvslam_tpu_torch.eval import harness as tharness
from mvslam_tpu_torch.eval import readiness as tready
from mvslam_tpu_torch.eval import regression_gate as tgate
from mvslam_tpu_torch.slam import runner as trunner

VOLATILE = {"run_dir", "updated_at", "elapsed_s", "peak_rss_bytes"}


def _stable(obj):
    """JSON text of ``obj`` without the volatile keys (at any depth)."""

    def strip(o):
        if isinstance(o, dict):
            return {k: strip(v) for k, v in o.items() if k not in VOLATILE}
        if isinstance(o, (list, tuple)):
            return [strip(v) for v in o]
        return o

    return json.dumps(strip(json.loads(json.dumps(obj, default=str))), sort_keys=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A small KITTI layout with ground truth, and run directories written
    by the port's runner (twice, with a loss injected so that relocalization
    shows in the artifacts) and the reference's (once) over it."""
    tmp = tmp_path_factory.mktemp("eval")
    num, h, w, shift = 8, 96, 128, 4
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 30, size=(h, w + shift * num)).astype(np.float32)
    for _ in range(80):
        y, x, s = rng.integers(22, h - 28), rng.integers(22, base.shape[1] - 28), rng.integers(3, 7)
        base[y : y + s, x : x + s] = rng.uniform(140, 255)
    frames = [
        np.concatenate([base[: h // 2, (i * shift) // 2 : (i * shift) // 2 + w], base[h // 2 :, i * shift : i * shift + w]])
        for i in range(num)
    ]
    gt = np.stack([np.array([0.04 * i, 0.0, 0.01 * i]) for i in range(num)])
    root, gt_path = write_kitti_sequence(tmp / "kitti", frames, gt, (100.0, 100.0, w / 2, h / 2))
    pipeline = tmp / "pipeline.json"
    pipeline.write_text(json.dumps({"feature": {"num_features": 256, "max_matches": 128}, "pose": {"num_hypotheses": 64}}))
    kw = dict(sequence="00", seed=1, max_frames=6, window=2, config_path=pipeline)
    port = [trunner.run_kitti_sequence(root, run_id="port", output_root=tmp / f"port{i}", device="cpu",
                                       inject_loss_at=4, **kw) for i in range(2)]
    # No loss injected into the reference's run: its relocalizer's first
    # compile would cost ~40 s.
    ref = jrunner.run_kitti_sequence(root, run_id="ref", output_root=tmp / "ref", **kw)
    gt6 = tmp / "gt6.txt"
    gt6.write_text("\n".join(gt_path.read_text().splitlines()[:6]) + "\n")
    return dict(tmp=tmp, gt=gt6, port=[r.run_dir for r in port], ref=ref.run_dir)


def _config(path, runs, run_dir, name, baseline=None):
    cfg = {
        "run": {"run_id": name, "output_root": str(runs["tmp"] / "evals" / name), "seed": 3},
        "evaluation": {"rpe_delta": 1, "trajectories": [{"name": "seq", "gt": str(runs["gt"]), "est_run_dir": str(run_dir)}]},
    }
    if baseline is not None:
        cfg["baseline"] = baseline
    path.write_text(json.dumps(cfg))
    return path


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_harness_equals_reference_on_a_run_directory_of_either_package(runs, writer, tmp_path):
    run_dir = runs["port"][0] if writer == "port" else runs["ref"]
    cfg = _config(tmp_path / "cfg.json", runs, run_dir, f"h_{writer}")
    ours = tharness.run_evaluation(tharness.load_config(cfg))
    ref = jharness.run_evaluation(jharness.load_config(cfg))
    assert ours["status"] == "pass" and "ATE_RMSE" in ours["aggregate"]
    seq = ours["sequences"]["seq"]
    assert {"telemetry_summary", "frame_diagnostics_summary", "relocalization_frames"} <= set(seq)
    assert _stable(ours) == _stable(ref)
    for name in ("summary.json", "summary.csv", "sequences/seq.json", "sequences/seq.csv", "sequences/seq.txt"):
        a, b = Path(ours["run_dir"]) / name, Path(ref["run_dir"]) / name
        if name.endswith(".json"):
            assert _stable(json.loads(a.read_text())) == _stable(json.loads(b.read_text())), name
        else:
            assert a.read_text() == b.read_text(), name


def test_harness_cli_and_baseline_flow_equal_reference(runs, tmp_path, capsys):
    """``python -m mvslam_tpu_torch.eval.harness --config``: a baseline
    written on the first run, compared on the second, in both packages."""
    outs = {}
    for pkg, mod in (("port", tharness), ("ref", jharness)):
        store = tmp_path / f"{pkg}_baselines.json"
        baseline = {"store": str(store), "key": "k", "write": False,
                    "metric_thresholds": {"ATE_RMSE": {"direction": "lower", "tolerance": 0.05}},
                    "telemetry_thresholds": {"telemetry_stage_frame_process_errors": {"max_delta": 0.0}}}
        cfg = _config(tmp_path / f"{pkg}.json", runs, runs["port"][0], f"cli_{pkg}", baseline)
        first = mod.main(["--config", str(cfg), "--write-baseline"])
        printed = [json.loads(capsys.readouterr().out)]
        second = mod.main(["--config", str(cfg)])
        printed.append(json.loads(capsys.readouterr().out))
        assert (first, second) == (1, 0)  # missing baseline, then pass
        outs[pkg] = (printed, json.loads(store.read_text()))
    assert _stable(outs["port"]) == _stable(outs["ref"])
    assert outs["port"][0][1]["status"] == "pass"


def test_baselines_equal_reference(tmp_path):
    current = {"ATE_RMSE": 1.2, "RPE_RMSE": 0.4, "fps": 30.0, "only_now": 1.0}
    base = {"ATE_RMSE": 1.0, "RPE_RMSE": 0.5, "fps": 33.0}
    spec = {"ATE_RMSE": {"direction": "lower", "tolerance": 0.1}, "RPE_RMSE": {"max_delta": 0.2},
            "fps": {"min_ratio": 0.95}, "absent": {"max_ratio": 2.0}}
    ours = tbaselines.compare_metrics(current, base, {k: tbaselines.MetricThreshold.from_config(v) for k, v in spec.items()})
    ref = jbaselines.compare_metrics(current, base, {k: jbaselines.MetricThreshold.from_config(v) for k, v in spec.items()})
    assert _stable(ours.to_dict()) == _stable(ref.to_dict()) and ours.status == "regressed"
    none = tbaselines.compare_metrics(current, None, {"fps": tbaselines.MetricThreshold(min_ratio=0.9)})
    assert _stable(none.to_dict()) == _stable(
        jbaselines.compare_metrics(current, None, {"fps": jbaselines.MetricThreshold(min_ratio=0.9)}).to_dict())
    for mod, name in ((tbaselines, "port.json"), (jbaselines, "ref.json")):
        store = mod.BaselineStore(tmp_path / name)
        store.upsert_baseline("k", base, "hash")
        mod.upsert_baseline(tmp_path / name, "k2", current)
    assert _stable(json.loads((tmp_path / "port.json").read_text())) == _stable(json.loads((tmp_path / "ref.json").read_text()))
    assert tbaselines.BaselineStore(tmp_path / "ref.json").load_baseline("k") == base


def test_regression_gate_and_ci_scores_equal_reference(runs, tmp_path):
    good = _config(tmp_path / "good.json", runs, runs["port"][0], "gate")
    bad = tmp_path / "bad.json"
    bad.write_text("{invalid")
    for configs in ([good], [bad, good]):
        ours = asyncio.run(tgate.execute_gate(configs, max_concurrency=1))
        ref = asyncio.run(jgate.execute_gate(configs, max_concurrency=1))
        assert _stable(ours) == _stable(ref)
    assert ours["status"] == "error"
    suites = []
    for pkg, mod in (("port", tci), ("ref", jci)):  # each with a baseline store of its own
        gov = tmp_path / f"gov_{pkg}.json"
        gov.write_text(json.dumps({"benchmarks": [{"name": "echo", "command": ["python", "-c", "print('{\"fps\": 2.5}')"],
                                                   "metric_thresholds": {"fps": {"min_ratio": 0.9}}}],
                                   "baseline_store": str(tmp_path / f"perf_{pkg}.json"), "write_baseline": True}))
        suites.append([asyncio.run(mod.run_ci_suite([good], max_concurrency=1, governance_config=gov)) for _ in range(2)])
    assert _stable(suites[0]) == _stable(suites[1])
    assert [s["status"] for s in suites[0]] == ["pass", "pass"]
    perf = [s["perf_gate"]["benchmarks"][0]["baseline_comparison"]["status"] for s in suites[0]]
    assert perf == ["missing_baseline", "pass"]
    comp = {"metric": "ATE_RMSE", "status": "regressed", "current": 1.5, "baseline": 1.0}
    detail = {"baseline_comparisons": {"metrics": {"comparisons": [comp, dict(comp, metric="RPE_RMSE", current=3.0)]}}}
    assert tci.score_run(detail, tci.SeverityWeights()) == jci.score_run(detail, jci.SeverityWeights()) > 0
    assert tci.metric_severity(comp, tci.SeverityWeights()) == jci.metric_severity(comp, jci.SeverityWeights())


def test_governance_equals_reference(tmp_path):
    benchmarks = [
        {"name": "ok", "command": ["python", "-c", "print('{\"metric\": \"v\", \"value\": 2}')"]},
        {"name": "fails", "command": ["python", "-c", "import sys; sys.exit(3)"]},
        {"name": "slow", "command": ["python", "-c", "import time; time.sleep(2)"], "runtime_budget_s": 0.3},
    ]
    for fail_fast in (True, False):
        cfg = tmp_path / f"gov{fail_fast}.json"
        cfg.write_text(json.dumps({"benchmarks": benchmarks, "fail_fast": fail_fast}))
        ours = tgov.run_governance(tgov.load_governance_config(cfg))
        ref = jgov.run_governance(jgov.load_governance_config(cfg))
        assert _stable(ours) == _stable(ref)
    assert [b["status"] for b in ours["benchmarks"]] == ["pass", "failed", "budget_exceeded"]
    assert tgov._parse_metrics('x\n{"a": 1, "b": "s"}\n{"metric": "m", "value": 3}') == jgov._parse_metrics(
        'x\n{"a": 1, "b": "s"}\n{"metric": "m", "value": 3}')


def test_determinism_validation_equals_reference(runs):
    """Per-artifact digests string-equal to the reference's; the port's two
    runs agree with each other, and the two packages' runs are compared
    alike by both."""
    a, b = runs["port"]
    digests = tdet.build_run_digest(a)
    assert digests == jdet.build_run_digest(a) and len(digests) >= 8
    ours, ref = tdet.build_determinism_report(a, b), jdet.build_determinism_report(a, b)
    assert ours.to_dict() == ref.to_dict()
    assert ours.passed, ours.to_dict()
    cross = tdet.build_determinism_report(a, runs["ref"])
    assert cross.to_dict() == jdet.build_determinism_report(a, runs["ref"]).to_dict()
    assert tdet.main([str(a), str(b)]) == 0


def test_readiness_equals_reference(runs, tmp_path):
    inputs = [
        ({"stages": {"ingestion": {"state": "healthy"}, "feature": {"state": "degraded"}}},
         {"status": "pass", "aggregate": {"ATE_RMSE": 0.1}},
         {"total_events": 10, "stages": {"s": {"errors": 0}}}),
        (None, {"status": "regressed"}, None),
        (None, None, None),
    ]
    for args in inputs:
        ours, ref = tready.generate_readiness_report(*args), jready.generate_readiness_report(*args)
        assert json.dumps(ours, sort_keys=True) == json.dumps(ref, sort_keys=True)
    summary = Path(runs["port"][0]) / "reports" / "telemetry_summary.json"
    paths = dict(evaluation_path=None, telemetry_path=summary if summary.exists() else None)
    ours = tready.run_readiness_report(out_path=tmp_path / "port.json", **paths)
    ref = jready.run_readiness_report(out_path=tmp_path / "ref.json", **paths)
    assert ours == ref and ours["digest"] == ref["digest"]
    assert (tmp_path / "port.json").read_text() == (tmp_path / "ref.json").read_text()


def test_console_scripts_name_the_port_counterparts():
    """``pyproject.toml`` gives every console script of the JAX package a
    ``mvslam-torch-`` counterpart at the same module path in the port, and
    each target is a ``main(argv)`` that prints its help."""
    import importlib
    import tomllib
    from pathlib import Path

    scripts = tomllib.loads((Path(__file__).resolve().parents[1] / "pyproject.toml").read_text())["project"]["scripts"]
    jax_scripts = {k: v for k, v in scripts.items() if not k.startswith("mvslam-torch-")}
    assert jax_scripts and all(v.startswith("mvslam_tpu.") for v in jax_scripts.values())
    for name, target in jax_scripts.items():
        port = scripts[name.replace("mvslam-", "mvslam-torch-", 1)]
        assert port == target.replace("mvslam_tpu.", "mvslam_tpu_torch.", 1)
        module, func = port.split(":")
        with pytest.raises(SystemExit) as exit_info:
            getattr(importlib.import_module(module), func)(["--help"])
        assert exit_info.value.code == 0
