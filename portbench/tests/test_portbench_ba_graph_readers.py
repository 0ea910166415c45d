"""The reader of the share of window BA's solves replayed as captured
graphs, on hand-made span lists: every solve replayed reads 1, the
parent's spans (no replay) read 0, part of them replayed reads the part,
and a window without a ``ba_solve`` span reads nothing (None)."""

import pytest

from portbench import spec


def _spans(*names):
    return [(name, 1000.0 + i, 1000.5 + i) for i, name in enumerate(names)]


BA = ("local_ba", "ba_gate", "ba_tracks", "ba_solve")


@pytest.mark.parametrize(
    "spans,expected",
    [
        (_spans(*(BA + ("ba_graph_replay",)) * 8, *["frame_process"] * 8), 1.0),
        (_spans(*BA * 8, *["frame_process"] * 8), 0.0),
        (_spans(*(BA + ("ba_graph_replay",)) * 3, *BA), 0.75),
        (_spans("local_ba", "ba_gate", "ba_tracks", "frame_process"), None),
        ([], None),
    ],
    ids=["all_replayed", "parent_none_replayed", "three_of_four", "no_solve", "no_spans"],
)
def test_ba_graph_share_reads_replays_over_solves(spans, expected):
    got = spec.reader("ba_graph_share.live")({"spans": spans, "trace": None})
    assert got == (None if expected is None else pytest.approx(expected))
