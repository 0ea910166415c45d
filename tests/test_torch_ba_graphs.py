"""Window BA's captured graphs (``backend/bundle_adjustment.py``,
``BA_GRAPHS``) on the CPU: the fixed shapes a window of W keyframes takes
(``window_shapes``) on host-built windows, the worst ones included; the
fixed-width segment tables adding exact zeros; the solve at the fixed
shapes against the power-of-two shapes the CPU keeps; the cache's key,
bookkeeping and spans with the capture and the replay stubbed out; the CPU
taking no graph; the synthetic windows the live warm-up captures. The
graphs themselves run only on the card (``tests/test_torch_cuda.py``)."""

import json
import threading

import numpy as np
import pytest
import torch

from mvslam_tpu_torch.backend import bundle_adjustment as tba
from mvslam_tpu_torch.backend.keyframes import Keyframe
from mvslam_tpu_torch.backend.segments import segment_sum, segment_table
from mvslam_tpu_torch.core.telemetry import RunTelemetryRecorder

M = tba._PAIR_GATE_M
K = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]])


def _project(points, pose):
    cam = points - pose[:3, 3]
    return (cam[:, :2] / cam[:, 2:] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]).astype(np.float32)


def _worst_window(num_poses, mode, matches=M, seed=0):
    """A window of ``num_poses`` keyframes 0.3 apart and the gated matches
    of its consecutive pairs, ``matches`` each: with ``mode`` "extend"
    every match carries the track of its first feature on (feature m of
    every keyframe sees point m), with "start" every match starts a track
    (keyframe k's features 0..M-1 see the points of pair k-1, its features
    M..2M-1 those of pair k)."""
    rng = np.random.default_rng(seed)

    def points(n):
        return np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(5, 10, n)], axis=1)

    poses = np.stack([np.eye(4)] * num_poses)
    poses[:, 0, 3] = 0.3 * np.arange(num_poses)
    m = np.arange(matches)
    if mode == "extend":
        seen = [points(matches)] * num_poses
        gated = [np.stack([m, m], axis=1)] * (num_poses - 1)
    else:
        sets = [points(matches) for _ in range(num_poses - 1)]
        seen = [np.concatenate([sets[k - 1] if k else points(matches), sets[k] if k < num_poses - 1 else points(matches)])
                for k in range(num_poses)]
        gated = [np.stack([matches + m, m], axis=1)] * (num_poses - 1)
    n = len(seen[0])
    window = [Keyframe(k, 0.1 * k, poses[k], _project(seen[k], poses[k]), np.zeros((n, 8), np.uint32),
                       np.ones(n, bool)) for k in range(num_poses)]
    return window, poses, gated


def _adjuster():
    return tba.WindowBundleAdjuster(K, device="cpu")


@pytest.mark.parametrize("mode", ["extend", "start"])
@pytest.mark.parametrize("num_poses", [2, 3, 4, 5])
def test_a_window_built_from_full_pair_gates_fits_its_fixed_shapes(num_poses, mode):
    """Every pair gated at the full M matches: the observations and points
    the adjuster keeps fit the fixed shapes of the window, the worst case
    ("start": every match starts a track) filling the observation and
    point budgets and an inner pose's table width, "extend" a point's."""
    window, poses, gated = _worst_window(num_poses, mode)
    points, obs = _adjuster()._observations(window, poses, gated)
    pose_ids = [o.pose_index for o in obs]
    point_ids = [o.point_index for o in obs]
    budget, pbudget, widths = tba.window_shapes(num_poses, pose_ids, point_ids, len(points))
    assert (budget, pbudget, widths) == (2 * M * (num_poses - 1), M * (num_poses - 1), (2 * M, num_poses, 1))
    per_pose, per_point = np.bincount(pose_ids), np.bincount(point_ids)
    if mode == "start":
        assert (len(obs), len(points)) == (budget, pbudget)
        assert per_pose.max() == (2 * M if num_poses > 2 else M)
    else:
        assert (len(obs), len(points)) == (M * num_poses, M)
        assert per_point.max() == num_poses
    arrays = tba.padded_arrays(obs, np.stack(points), budget, pbudget)
    tables = tba.ba_tables(arrays[0], arrays[1], arrays[3], num_poses, pbudget, widths=widths)
    assert [tuple(t.shape) for t in tables] == [(num_poses, 2 * M), (pbudget, num_poses), (num_poses * pbudget, 1)]


def test_the_window_assertion_trips_beyond_the_pair_gate():
    """One match more than the pair gate keeps: the window's observations
    exceed its fixed shapes, and the adjuster's assertion says so."""
    window, poses, gated = _worst_window(3, "start", matches=M + 1)
    with pytest.raises(AssertionError, match="pair gate"):
        _adjuster()._observations(window, poses, gated)


@pytest.mark.parametrize("case", ["observations", "points", "pose_width", "pair_width"])
def test_window_shapes_refuse_what_a_window_cannot_hold(case):
    """None where the observations exceed the fixed shapes, so that the
    solve takes the power-of-two budgets instead: one observation or
    point over the budget, a pose seen 2M + 1 times, a point seen twice by
    one pose."""
    W = 5
    budget, pbudget, _ = tba.window_shapes(W, [], [], 0)
    poses, points, num_points = {
        "observations": (np.arange(budget + 1) % W, np.arange(budget + 1) // W, (budget + 1) // W + 1),
        "points": (np.zeros(1), np.zeros(1), pbudget + 1),
        "pose_width": (np.ones(2 * M + 1), np.arange(2 * M + 1), 2 * M + 1),
        "pair_width": (np.array([0, 0, 1]), np.array([3, 3, 3]), 4),
    }[case]
    assert tba.window_shapes(W, poses.astype(np.int64), points.astype(np.int64), num_points) is None


def test_fixed_width_tables_add_exact_zeros():
    """A table of a fixed width lists each segment's members as the
    table of the largest segment's width does, in the same order, and
    points every further slot at the appended zero row: its sums equal
    the narrow table's exactly (integer-valued floats, so any order of
    the additions is exact). A segment wider than the width raises."""
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 6, 50)
    keep = rng.random(50) > 0.3
    narrow = segment_table(ids, 6, keep=keep)
    wide = segment_table(ids, 6, keep=keep, width=narrow.shape[1] + 7)
    assert torch.equal(wide[:, : narrow.shape[1]], narrow)
    assert (wide[:, narrow.shape[1] :] == len(ids)).all()
    values = torch.from_numpy(rng.integers(-1000, 1000, (50, 3, 2)).astype(np.float32))
    assert torch.equal(segment_sum(values, wide), segment_sum(values, narrow))
    with pytest.raises(ValueError, match="exceeds the table's width"):
        segment_table(ids, 6, keep=keep, width=narrow.shape[1] - 1)


def _solve_at(poses, points, obs, shapes, config):
    """The eager solve on the CPU at the given (budget, point budget,
    widths): the arrays ``run_bundle_adjustment`` uploads, solved as a
    graph would be."""
    budget, pbudget, widths = shapes
    obs_pose, obs_point, obs_uv, obs_mask, pts = tba.padded_arrays(obs, points, budget, pbudget)
    W = len(poses)
    inputs = (
        torch.as_tensor(poses, dtype=torch.float32), torch.as_tensor(pts), torch.as_tensor(obs_pose),
        torch.as_tensor(obs_point), torch.as_tensor(obs_uv), torch.as_tensor(obs_mask),
        torch.as_tensor(K, dtype=torch.float32), *tba.ba_tables(obs_pose, obs_point, obs_mask, W, pbudget, None, widths),
    )
    free = tba._free_coordinates(W, config, "cpu", torch.float32)
    return tba._with_conditioning(*tba._solve_window(inputs, config, free), config).numpy()


@pytest.mark.parametrize("num_poses", [3, 5])
def test_the_fixed_shapes_solve_as_the_power_of_two_shapes(num_poses):
    """On a noisy window the eager solve at the fixed shapes against
    ``run_bundle_adjustment`` on the CPU (power-of-two budgets): the padded
    rows and slots add exact zeros, so only the order of the sums differs
    (the CPU parity tests' tolerances: poses 1e-4, points 2e-3, costs 1e-4
    relative)."""
    rng = np.random.default_rng(num_poses)
    window, poses, gated = _worst_window(num_poses, "extend", matches=60, seed=num_poses)
    points, obs = _adjuster()._observations(window, poses, gated)
    noisy_poses = poses.copy()
    noisy_poses[2:, :3, 3] += rng.normal(scale=0.02, size=(num_poses - 2, 3))
    noisy_points = np.stack(points) + rng.normal(scale=0.05, size=(len(points), 3))
    obs = [tba.Observation(o.pose_index, o.point_index, o.uv + rng.normal(scale=0.5, size=2)) for o in obs]
    config = tba.BundleAdjustmentConfig()
    ref = tba.run_bundle_adjustment(noisy_poses, noisy_points, obs, K, config, device="cpu")
    shapes = tba.window_shapes(num_poses, [o.pose_index for o in obs], [o.point_index for o in obs], len(points))
    packed = _solve_at(noisy_poses, noisy_points, obs, shapes, config)
    assert not ref.diagnostics.conditioning_tripped
    assert packed[0] == pytest.approx(ref.diagnostics.initial_cost, rel=1e-4)
    assert packed[1] == pytest.approx(ref.diagnostics.final_cost, rel=1e-4)
    np.testing.assert_allclose(packed[4 : 4 + num_poses * 16].reshape(num_poses, 4, 4), ref.poses, atol=1e-4)
    np.testing.assert_allclose(packed[4 + num_poses * 16 :].reshape(-1, 3)[: len(points)], ref.points, atol=2e-3)
    assert packed[2] / max(packed[3], 1e-30) == pytest.approx(1 / ref.diagnostics.condition_number, rel=1e-2)


def _inputs(num_poses, points_dtype=torch.float32):
    """Zero tensors of the fixed shapes of a window of ``num_poses``, in
    ``run_bundle_adjustment``'s order."""
    budget, pbudget, widths = tba.window_shapes(num_poses, [], [], 0)
    z = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype)  # noqa: E731
    i64 = torch.int64
    return (
        z(num_poses, 4, 4), z(pbudget, 3, dtype=points_dtype), z(budget, dtype=i64), z(budget, dtype=i64),
        z(budget, 2), z(budget, dtype=torch.bool), z(3, 3), z(num_poses, widths[0], dtype=i64),
        z(pbudget, widths[1], dtype=i64), z(num_poses * pbudget, widths[2], dtype=i64),
    )


class _StubGraphs(tba.BAGraphs):
    """The cache with the capture and the replay stubbed: what it records
    and keeps, without a card."""

    def __init__(self):
        super().__init__()
        self.captures = 0

    def _capture(self, inputs, config):
        self.captures += 1
        return ("entry", self.captures)

    def _replay(self, entry, inputs, config):
        return entry


def test_signature_tells_apart_the_window_lengths_and_configs():
    config = tba.BundleAdjustmentConfig()
    sigs = {W: tba.signature(_inputs(W), config) for W in (2, 3, 4, 5)}
    assert len(set(sigs.values())) == 4
    assert tba.signature(_inputs(3), tba.BundleAdjustmentConfig()) == sigs[3]
    assert tba.signature(_inputs(3), tba.BundleAdjustmentConfig(max_iterations=9)) != sigs[3]
    assert tba.signature(_inputs(3, torch.float64), config) != sigs[3]


def test_cache_keeps_the_newest_entries_per_device_and_records_its_spans():
    graphs = _StubGraphs()
    assert graphs.ENTRIES_PER_DEVICE == 8
    recorder = RunTelemetryRecorder()
    config = tba.BundleAdjustmentConfig()
    for W in range(2, 10):
        assert graphs.solve(_inputs(W), config, recorder) == ("entry", W - 1)
    assert graphs.solve(_inputs(2), config, recorder) == ("entry", 1)  # replayed: now the newest
    assert graphs.solve(_inputs(10), config, recorder) == ("entry", 9)  # evicts W = 3, the least recently used
    assert [sig[0][1][0] for sig in graphs.entries("cpu")] == [4, 5, 6, 7, 8, 9, 2, 10]
    assert graphs.solve(_inputs(3), config, recorder) == ("entry", 10)  # captured again
    assert graphs.captures == 10

    events = recorder.events()
    captures = [e for e in events if e.name == "ba_graph_capture"]
    replays = [e for e in events if e.name == "ba_graph_replay"]
    assert len(captures) == 10 and len(replays) == 11
    meta = json.loads(json.dumps(captures[0].metadata))
    assert meta["device"] == "cpu"
    assert meta["inputs"][1] == [[M, 3], "float32"] and meta["inputs"][2] == [[2 * M], "int64"]
    assert meta["configs"][0]["max_iterations"] == 10


def test_captures_closed_replays_known_signatures_and_captures_none_on_its_thread():
    graphs = _StubGraphs()
    recorder = RunTelemetryRecorder()
    config = tba.BundleAdjustmentConfig()
    graphs.solve(_inputs(2), config)
    with graphs.captures_closed():
        assert graphs.solve(_inputs(2), config, recorder) == ("entry", 1)
        assert graphs.solve(_inputs(3), config, recorder) is None  # the caller solves eagerly
        other = []
        thread = threading.Thread(target=lambda: other.append(graphs.solve(_inputs(4), config)))
        thread.start()
        thread.join(timeout=30)
        assert not thread.is_alive() and other == [("entry", 2)]  # closed on this thread only
    assert graphs.solve(_inputs(3), config) == ("entry", 3)
    assert [e.name for e in recorder.events()] == ["ba_graph_replay"]


def test_run_bundle_adjustment_on_the_cpu_takes_no_graph(monkeypatch):
    def refuse(*args):
        raise AssertionError("the graphs are for CUDA devices")

    monkeypatch.setattr(tba.BA_GRAPHS, "solve", refuse)
    window, poses, gated = _worst_window(4, "extend", matches=40)
    points, obs = _adjuster()._observations(window, poses, gated)
    recorder = RunTelemetryRecorder()
    result = tba.run_bundle_adjustment(poses, np.stack(points), obs, K, device="cpu", recorder=recorder)
    assert not result.diagnostics.conditioning_tripped
    assert not [e for e in recorder.events() if e.name.startswith("ba_graph")]


@pytest.mark.parametrize("num_poses", [2, 3, 4, 5])
def test_the_synthetic_windows_solve_and_fit_their_shapes(num_poses, monkeypatch):
    """The windows the live warm-up solves to capture each length's graph
    are well posed (the solve is not gated off, the cost falls to its
    exact zero) and take the window's fixed shapes; on the CPU the warm-up
    solves nothing."""
    poses, points, obs = tba._synthetic_window(num_poses, K)
    assert tba.window_shapes(num_poses, [o.pose_index for o in obs], [o.point_index for o in obs], len(points))
    result = tba.run_bundle_adjustment(poses, points, obs, K, device="cpu")
    assert not result.diagnostics.conditioning_tripped
    assert result.diagnostics.final_cost <= 1e-6
    monkeypatch.setattr(tba, "run_bundle_adjustment", lambda *a, **k: pytest.fail("solved on the CPU"))
    _adjuster().capture_graphs(num_poses)
