"""The readers of the share of tracking calls replayed as captured graphs,
on hand-made span lists: every call replayed reads 1, none replayed reads
0, a window without the pose stage's spans reads nothing (None), and a
program without the graph cache reads nothing."""

import importlib.util

import pytest

from portbench import spec


def _spans(*names):
    return [(name, 1000.0 + i, 1000.5 + i) for i, name in enumerate(names)]


WINDOW = ("pair_graph_replay", "match.device", "pose.device")
EAGER = ("match.device", "pose.device")
METRICS = ["pair_graph_share.offline", "pair_graph_share.live"]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize(
    "spans,expected",
    [
        (_spans(*WINDOW * 6, "scalar_pull", *["frame_process"] * 96), 1.0),
        (_spans(*EAGER * 6, *["frame_process"] * 96), 0.0),
        (_spans(*WINDOW * 3, *EAGER), 0.75),
        (_spans("track_enqueue", "detect.device", *["frame_process"] * 96), None),
        ([], None),
    ],
    ids=["all_replayed", "none_replayed", "three_of_four", "no_pose_span", "no_spans"],
)
def test_pair_graph_share_reads_replays_over_pose_spans(metric, spans, expected):
    got = spec.reader(metric)({"spans": spans, "trace": None})
    assert got == (None if expected is None else pytest.approx(expected))


@pytest.mark.parametrize("metric", METRICS)
def test_pair_graph_share_reads_nothing_without_the_graph_cache(metric, monkeypatch):
    """The parent's program has no ``slam/pair_graphs.py`` and records no
    replay: the reader returns None and the harness leaves the metric out."""
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: None if name == "mvslam_tpu_torch.slam.pair_graphs" else find_spec(name, *a),
    )
    assert spec.reader(metric)({"spans": _spans(*EAGER * 6), "trace": None}) is None
