"""A judged number that a cell adds as a file of its own
(``checks/<number>.py``) enters ``checks``, ``correct``,
``control_checks`` and ``portbench.readings`` with no other file edited;
a limit with no number behind it fails before set-up; the core numbers
read what ``Judge.judge`` gives directly. On the CPU at the judge tests'
small size."""

import copy
import json
import shutil

import pytest

from portbench import readings, run, spec
from portbench.reference import judge as judge_mod
from portbench.tests.test_portbench_judge import SMALL, few_threads, live_run, small_run  # noqa: F401  (few_threads: autouse)

SEED = 2**31 + 11
# A check that counts the anchors it was handed; its control reads 100 more.
CHECK = '''
def judge(ctx):
    ctx["judge"].details.append({"check": "sampled_frames", "ctx": sorted(ctx)})
    return float(len(ctx["anchors"]))


def control(ctx):
    return 100.0 + len(ctx["anchors"])
'''


def checkout(tmp_path, limits):
    """A checkout at ``tmp_path`` whose ``kitti.track`` limits ``limits``
    besides its own, with ``checks/sampled_frames.py``."""
    shutil.copytree(spec.HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    (tmp_path / "portbench" / "checks").mkdir(exist_ok=True)
    (tmp_path / "portbench" / "checks" / "sampled_frames.py").write_text(CHECK)
    path = tmp_path / "portbench" / "cells" / "kitti.track.json"
    cell = json.loads(path.read_text())
    cell["limits"].update(limits)
    path.write_text(json.dumps(cell))
    return tmp_path


@pytest.mark.parametrize("limit,correct", [(4, True), (3, False)], ids=["under", "over"])
def test_a_check_file_enters_checks_and_correct(tmp_path, limit, correct):
    root = checkout(tmp_path, {"sampled_frames": limit})
    res = run.run_cell("kitti.track", SEED, 2.0, False, device="cpu", overrides=copy.deepcopy(SMALL), root=root)
    assert res["checks"]["sampled_frames"] == {"value": 4.0, "limit": limit}
    assert res["correct"] is correct, res["checks"]
    assert res["judge"]["sampled_frames"] == 4.0
    assert {"check": "sampled_frames", "ctx": ["anchors", "answers", "cell", "extra", "judge"]} in res["judge_details"]
    assert spec.names_ok(spec.benchmark(root), root) == {}


def test_its_control_enters_control_checks_and_the_readings(tmp_path, monkeypatch, capsys):
    root = checkout(tmp_path, {"sampled_frames": 4})
    original = run.run_cell

    def small(name, seed, seconds, trace, **kw):
        return original(name, seed, seconds, trace, device="cpu", overrides=copy.deepcopy(SMALL), root=root, **kw)

    monkeypatch.setattr(run, "run_cell", small)
    out = tmp_path / "readings.jsonl"
    argv = ["--workload", "kitti.track", "--seeds", str(SEED), "--control-seeds", "1", "--seconds", "2", "--out", str(out)]
    assert readings.main(argv) == 0
    line, summary = (json.loads(t) for t in capsys.readouterr().out.strip().splitlines())
    assert line["control"]["sampled_frames"] == 104.0
    limited = ["keypoints_off", "descriptor_bits_off", "counts_off", "inliers_recount_gap", "sampled_frames"]
    assert list(line["program"]) == limited
    assert summary["lower"]["sampled_frames"] == 4.0 and summary["upper"]["sampled_frames"] == 104.0
    assert set(summary["upper"]) >= set(limited)
    assert out.read_text().count("\n") == 2


@pytest.mark.parametrize("where", ["limits", "wanted"])
def test_a_number_with_nothing_behind_it_fails_before_rendering(tmp_path, monkeypatch, where):
    from portbench import scene

    def never(*args, **kw):
        raise AssertionError("rendered before the judged numbers were found")

    monkeypatch.setattr(scene, "render", never)
    root = checkout(tmp_path, {"no_such_number": 0} if where == "limits" else {})
    if where == "limits":
        with pytest.raises(KeyError, match="no_such_number"):
            spec.find("kitti.track", root)
    with pytest.raises((KeyError, FileNotFoundError), match="no_such_number"):
        run.run_cell("kitti.track", SEED, 2.0, False, device="cpu", root=root, wanted=None if where == "limits" else ("no_such_number",))


@pytest.mark.parametrize("cell", ["kitti.track", "tum.live"])
def test_the_core_numbers_read_what_the_judge_gives_directly(monkeypatch, cell):
    made = []

    class Recording(judge_mod.Judge):
        def __init__(self, *args):
            super().__init__(*args)
            made.append(args)

        def anchors(self, answers):
            made.append(answers)
            return super().anchors(answers)

    monkeypatch.setattr(judge_mod, "Judge", Recording)
    kw = {"wanted": judge_mod.NUMBERS}
    res = small_run(cell, **kw) if cell == "kitti.track" else live_run(**kw)
    args, answers = made
    fresh = judge_mod.Judge(*args)
    direct = fresh.judge(answers, fresh.anchors(answers))
    assert res["judge"] == {k: direct[k] for k in ("frames_checked", "anchors", *judge_mod.NUMBERS)}
    assert res["correct"], res["checks"]
