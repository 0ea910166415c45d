"""BENCHMARK.json keeps to its contract, and every cell, configuration,
traffic mix and metric is found by its name."""

import json
import shutil

import pytest

from portbench import drive, spec

BENCH = spec.benchmark()


def test_benchmark_has_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(workload):
    cell = spec.find(workload)
    assert cell.chips == 1
    assert "limits" in cell.cell
    assert issubclass(spec.driver(cell.traffic["entry"]), drive.Driver)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_reader_loads_by_name(metric):
    assert callable(spec.reader(metric))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_file_states_its_source_and_cuts(config):
    data = spec.load_json(spec.ROOT / config["file"])
    assert len(data["source"]) <= 200
    assert isinstance(data["assumed"], dict)
    assert sorted(data["reduced"]) == sorted(config["reduced"])


def test_names_and_units_keep_to_the_characters():
    assert spec.names_ok(BENCH) == {}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert 1 <= len(m["unit"]) <= 16
        assert m["better"] in ("lower", "higher")


def test_metrics_move_a_reported_end_to_end_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


def test_a_cell_added_as_files_is_found_without_editing(tmp_path):
    shutil.copytree(spec.HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(
        {"name": "kitti.live", "config": "kitti_odom", "traffic": "live", "chips": 1, "why": "a later cell"}
    )
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench" / "cells" / "kitti.live.json").write_text(
        json.dumps({"rate_hz": 1.0, "limits": {"keypoints_off": 0}})
    )
    cell = spec.find("kitti.live", tmp_path)
    assert cell.cell["rate_hz"] == 1.0 and cell.traffic["entry"] == "live"
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]


def test_an_entry_added_as_a_file_is_found_by_name(tmp_path):
    shutil.copytree(spec.HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "portbench" / "entries" / "replay.py").write_text(
        "from portbench import drive\n\n\nclass Driver(drive.Driver):\n    kind = 'replay'\n"
    )
    (tmp_path / "portbench" / "traffic" / "replay.json").write_text(json.dumps({"entry": "replay"}))
    found = spec.driver("replay", tmp_path)
    assert found.kind == "replay" and issubclass(found, drive.Driver)
    assert spec.driver("offline", tmp_path) is not spec.driver("offline")  # by path, not by name alone
