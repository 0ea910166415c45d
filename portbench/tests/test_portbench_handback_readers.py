"""The reader of the share of live frames tracked on the readiness signal,
on hand-made span lists: every frame woken for reads 1, a program that
records no ``ready_wake`` (the parent of the hand-back) reads 0, and a
window without ``ready_wait`` reads nothing (None)."""

import pytest

from portbench import spec


def _spans(*names):
    return [(name, 1000.0 + i, 1000.5 + i) for i, name in enumerate(names)]


FRAME = ("input_wait", "feature_queue", "feature_batch", "ready_wait", "frame_process")
WOKEN = ("input_wait", "feature_queue", "feature_batch", "ready_wake", "ready_wait", "frame_process")


@pytest.mark.parametrize(
    "spans,expected",
    [
        (_spans(*WOKEN * 8), 1.0),
        (_spans(*FRAME * 8), 0.0),
        (_spans(*WOKEN * 3, *FRAME), 0.75),
        (_spans("input_wait", "feature_queue", "feature_batch"), None),
        ([], None),
    ],
    ids=["every_frame_woken", "no_ready_wake", "three_of_four", "no_ready_wait", "no_spans"],
)
def test_ready_wake_share_reads_wakes_over_ready_waits(spans, expected):
    got = spec.reader("ready_wake_share.live")({"spans": spans, "trace": None})
    assert got == (None if expected is None else pytest.approx(expected))
