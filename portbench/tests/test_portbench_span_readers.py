"""The readers of the program's spans, on hand-made span lists: each
reads what its docstring says, and nothing (None) where its span is
absent, as in a checkout of the program that does not record it."""

import pytest

from portbench import spec


def _spans(*items):
    """(name, start, end) spans laid one after another, each ``(name, seconds)``."""
    out, t = [], 1000.0
    for name, seconds in items:
        out.append((name, t, t + seconds))
        t += seconds
    return out


OFFLINE = _spans(
    ("dispatch_stage", 0.030), ("track_enqueue", 0.400), ("detect.device", 0.004), ("match.device", 0.002),
    ("pose.device", 0.010), ("detect.device", 0.004), ("match.device", 0.002), ("pose.device", 0.010),
    ("scalar_pull", 0.001), *[("frame_process", 0.0002)] * 100,
)
LIVE = _spans(
    ("feature_queue", 0.010), ("feature_batch", 0.020), ("ready_wait", 0.470), ("frame_process", 0.300),
    ("local_ba", 0.280), ("ba_gate", 0.030), ("ba_tracks", 0.060), ("ba_solve", 0.180),
    ("feature_queue", 0.030), ("ready_wait", 0.430), ("local_ba", 0.200), ("ba_tracks", 0.040), ("ba_solve", 0.140),
)

CASES = [
    ("stage_ms.offline", OFFLINE, 1e3 * 0.030 / 100),
    ("enqueue_ms.offline", OFFLINE, 1e3 * 0.400 / 100),
    ("detect_device_ms.offline", OFFLINE, 1e3 * 0.008 / 100),
    ("match_device_ms.offline", OFFLINE, 1e3 * 0.004 / 100),
    ("pose_device_ms.offline", OFFLINE, 1e3 * 0.020 / 100),
    ("ready_wait_ms.live", LIVE, 1e3 * (0.470 + 0.430) / 2),
    ("feature_queue_ms.live", LIVE, 1e3 * (0.010 + 0.030) / 2),
    ("ba_tracks_ms.live", LIVE, 1e3 * (0.060 + 0.040) / 2),
    ("ba_solve_ms.live", LIVE, 1e3 * (0.180 + 0.140) / 2),
]
SPAN_OF = {
    "stage_ms.offline": "dispatch_stage", "enqueue_ms.offline": "track_enqueue",
    "detect_device_ms.offline": "detect.device", "match_device_ms.offline": "match.device",
    "pose_device_ms.offline": "pose.device", "ready_wait_ms.live": "ready_wait",
    "feature_queue_ms.live": "feature_queue", "ba_tracks_ms.live": "ba_tracks", "ba_solve_ms.live": "ba_solve",
}


@pytest.mark.parametrize("metric,spans,expected", CASES, ids=[c[0] for c in CASES])
def test_span_reader_reads_its_spans(metric, spans, expected):
    assert spec.reader(metric)({"spans": spans, "trace": None}) == pytest.approx(expected, rel=1e-6)


@pytest.mark.parametrize("metric,spans,expected", CASES, ids=[c[0] for c in CASES])
def test_span_reader_finds_nothing_without_its_span(metric, spans, expected):
    """The parent's program records none of the new spans: the reader
    returns None and the harness leaves the metric out."""
    without = [s for s in spans if s[0] != SPAN_OF[metric]]
    assert spec.reader(metric)({"spans": without, "trace": None}) is None
    assert spec.reader(metric)({"spans": [], "trace": None}) is None


def test_the_new_metrics_are_entries_of_the_benchmark():
    entries = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for metric in SPAN_OF:
        m = entries[metric]
        assert m["source"] == "program_span" and m["unit"] == "ms" and m["better"] == "lower"
        assert m["workloads"] == (["kitti.track"] if metric.endswith(".offline") else ["tum.live"])
