"""The readers of ``kitti.loops``'s per-layer metrics, on hand-made span
lists: each reads what its docstring says, and nothing (None) where its
spans are absent, as in a checkout of the program that does not record
them."""

import pytest

from portbench import spec
from portbench.tests.test_portbench_span_readers import _spans

WINDOW = _spans(
    ("frame_decode", 0.007), ("bow_keyframe", 0.003), ("loop_geometry", 0.120), ("frame_decode", 0.009),
    ("bow_keyframe", 0.004), ("loop_geometry", 0.110), ("frame_process", 0.001),
)
CTX = {"spans": WINDOW, "window_s": 0.5, "trace": None}

CASES = [
    ("loop_share.loops", (0.003 + 0.120 + 0.004 + 0.110) / 0.5, ("bow_keyframe", "loop_geometry")),
    ("loop_geometry_ms.loops", 1e3 * (0.120 + 0.110) / 2, ("loop_geometry",)),
    ("bow_ms.loops", 1e3 * (0.003 + 0.004) / 2, ("bow_keyframe",)),
    ("decode_ms.loops", 1e3 * (0.007 + 0.009) / 2, ("frame_decode",)),
]


@pytest.mark.parametrize("metric,expected,spans", CASES, ids=[c[0] for c in CASES])
def test_loop_reader_reads_its_spans(metric, expected, spans):
    assert spec.reader(metric)(dict(CTX)) == pytest.approx(expected, rel=1e-6)


@pytest.mark.parametrize("metric,expected,spans", CASES, ids=[c[0] for c in CASES])
def test_loop_reader_finds_nothing_without_its_spans(metric, expected, spans):
    ctx = dict(CTX, spans=[s for s in WINDOW if s[0] not in spans])
    assert spec.reader(metric)(ctx) is None
    assert spec.reader(metric)({"spans": [], "trace": None}) is None


def test_the_loop_metrics_are_entries_of_the_benchmark():
    entries = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for metric, _, _ in CASES:
        m = entries[metric]
        assert m["source"] == "program_span" and m["better"] == "lower" and m["workloads"] == ["kitti.loops"]
        assert m["moves"] == "tracked_fps"
    assert "kitti.loops" in next(m for m in spec.benchmark()["end_to_end"] if m["name"] == "tracked_fps")["workloads"]
