"""What ``run_visual_slam`` hands back and records of its loop closure, on
the CPU: a caller's packet source in place of the reader, the loop records
and odometry of the in-memory summary, the spans and counters of the loop
stages and the reader's decode, and the pose-graph solve against the plain
float64 reference the benchmark judges it by.

The whole runs use ``tests/test_accuracy.py``'s loop-closure scene (29
frames, 320x240, out 14 frames and back), window BA off as in the
benchmark's ``kitti.loops`` cell, with the loop settings under which its
loops close at this size (gap 12, threshold 0.7, 25 inliers).
"""

import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)

from mvslam_tpu_torch.backend.pose_graph import PoseGraph3D
from mvslam_tpu_torch.backend.solvers import SolverConfig, solve_problem
from mvslam_tpu_torch.data.kitti import KittiSequence
from mvslam_tpu_torch.data.synthetic import render_scene, write_kitti_sequence
from mvslam_tpu_torch.geometry import lie_np
from mvslam_tpu_torch.slam import offline as toffline
from portbench import spec
from portbench.reference import pose_graph as ref_pose_graph

HALF = 14
LOOPS = dict(seed=3, loop_min_frame_gap=12, loop_similarity_threshold=0.7, loop_min_inliers=25, enable_local_ba=False)


def _out_and_back(i):
    x = 0.25 * i if i <= HALF else 0.25 * (2 * HALF - i)
    return np.eye(3), np.array([x, 0.0, 0.0])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two runs over the same KITTI layout: the reader's own stream, and a
    caller's source that wraps the same reader."""
    out = tmp_path_factory.mktemp("offline_loops")
    frames, gt_pos, intrinsics, _ = render_scene(num_frames=2 * HALF + 1, traj_fn=_out_and_back, noise=6.0, seed=2)
    root, _ = write_kitti_sequence(out / "kitti", frames, gt_pos, intrinsics)
    opened = []

    def source(recorder):
        opened.append(recorder)
        yield from KittiSequence(root, "00").iter_frames(recorder=recorder)

    bows = []
    original_bow = toffline.BoWDatabase

    def recording_bow(config, **kw):
        bows.append(config)
        return original_bow(config, **kw)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(toffline, "BoWDatabase", recording_bow)
        common = dict(input_path=root, input_kind="kitti", sequence="00", run_id="loops", **LOOPS)
        file = toffline.run_visual_slam(toffline.SLAMRunConfig(output_root=out / "file", **common), device="cpu")
        caller = toffline.run_visual_slam(toffline.SLAMRunConfig(output_root=out / "caller", **common), device="cpu", source=source)
    assert len(opened) == 1 and opened[0] is caller.system.telemetry
    return SimpleNamespace(file=file, caller=caller, bow=bows[0])


def _events(summary, name):
    return [e for e in summary.system.telemetry.events() if e.name == name]


def test_a_callers_source_gives_the_readers_summary_and_trajectory(runs):
    a, b = Path(runs.file["run_dir"]), Path(runs.caller["run_dir"])
    assert (a / "offline_summary.json").read_bytes() == (b / "offline_summary.json").read_bytes()
    ta, tb = np.load(a / "trajectories" / "estimated.npz"), np.load(b / "trajectories" / "estimated.npz")
    assert sorted(ta.files) == sorted(tb.files) and all(np.array_equal(ta[k], tb[k]) for k in ta.files)
    assert runs.file.odometry.keys() == runs.caller.odometry.keys()
    assert all(np.array_equal(runs.file.odometry[f], runs.caller.odometry[f]) for f in runs.file.odometry)
    assert len(runs.file.loop_records) == len(runs.caller.loop_records) >= 1
    for x, y in zip(runs.file.loop_records, runs.caller.loop_records):
        assert x.keys() == y.keys()
        assert all(np.array_equal(x[k], y[k]) for k in x)


def test_the_persisted_summary_keeps_its_keys_and_content(runs):
    """``offline_summary.json`` holds what it held: the counts and, per
    loop, only the fields it always had; the loop records agree with it."""
    summary = runs.file
    persisted = json.loads((Path(summary["run_dir"]) / "offline_summary.json").read_text())
    assert set(persisted) == {"frames", "keyframes", "failures", "loops_detected", "loops_accepted"}
    assert set(summary) == set(persisted) | {"run_dir"}
    assert persisted == json.loads(json.dumps({k: v for k, v in summary.items() if k != "run_dir"}, default=str))
    assert all(set(d) == {"query", "candidate", "bow_score"} for d in persisted["loops_detected"])
    assert all(set(d) == {"query", "candidate", "inliers", "inlier_ratio"} for d in persisted["loops_accepted"])
    records = summary.loop_records
    assert [(r["query"], r["candidate"], r["bow_score"]) for r in records] == [
        (d["query"], d["candidate"], d["bow_score"]) for d in summary["loops_detected"]
    ]
    accepted = [r for r in records if r["gate"] is None]
    assert [(r["query"], r["candidate"], r["num_inliers"], r["inlier_ratio"]) for r in accepted] == [
        (d["query"], d["candidate"], d["inliers"], d["inlier_ratio"]) for d in summary["loops_accepted"]
    ]


def test_the_loop_records_hold_each_loops_edge_and_solve(runs):
    summary = runs.file
    system = summary.system
    records = summary.loop_records
    assert {r["gate"] for r in records} <= {None, "matches", "inliers", "ratio"}
    for r in records:
        assert r["idx_a"].shape == r["ok"].shape == (toffline._LOOP_GEOM_M,)
        assert int(r["ok"].sum()) <= r["num_valid"] <= toffline._LOOP_GEOM_M
    accepted = [r for r in records if r["gate"] is None]
    assert accepted
    kf_ids = [k.frame_id for k in system.keyframes.keyframes]
    for r in accepted:
        assert r["num_inliers"] >= LOOPS["loop_min_inliers"] and r["inlier_ratio"] >= 0.4
        assert r["threshold_px"] == 2.0 and r["weight"] == 5.0 and 1 <= r["iterations"] <= 15
        R, t = r["R"], r["t"]
        assert np.allclose(R @ R.T, np.eye(3), atol=1e-5) and abs(np.linalg.norm(t) - 1) < 1e-5
        assert np.allclose(r["rel"][:3, :3], R.T) and np.allclose(r["rel"][:3, 3], -R.T @ (t * r["scale"]))
        n = len(r["poses_before"])
        assert r["poses_after"].shape == (n, 4, 4) and r["nodes"] == (kf_ids.index(r["candidate"]), kf_ids.index(r["query"]))
        assert not np.allclose(r["poses_after"], r["poses_before"])
    # The last correction's output is what the keyframes hold now.
    assert np.allclose(np.stack([k.pose for k in system.keyframes.keyframes][: len(accepted[-1]["poses_after"])]), accepted[-1]["poses_after"])


def test_the_odometry_is_the_chain_before_loop_corrections(runs):
    """Each frame's recorded relative pose is the step the tracking step
    chained: the pose graph of every accepted loop was built on a chain
    whose last step, to the query, is the query's recorded one; composed,
    they are not the corrected trajectory, which the loops moved."""
    summary = runs.file
    ids = sorted(summary.odometry)
    assert ids == list(summary.system.trajectory.frame_ids)
    chained, pose = [], np.eye(4)
    for f in ids:
        pose = pose @ summary.odometry[f]
        chained.append(pose)
    assert not np.allclose(np.stack(chained), np.stack(summary.system.trajectory.poses), atol=1e-6)
    kf_ids = [k.frame_id for k in summary.system.keyframes.keyframes]
    checked = 0
    for r in summary.loop_records:
        k = r.get("nodes", (0, 0))[1]
        if r["gate"] is None and kf_ids[k - 1] == r["query"] - 1:
            step = np.linalg.inv(r["poses_before"][k - 1]) @ r["poses_before"][k]
            assert np.allclose(step, summary.odometry[r["query"]], atol=1e-9)
            checked += 1
    assert checked >= 1


def test_the_loop_stages_record_spans_and_counters(runs):
    summary = runs.file
    root, = _events(summary, "run_visual_slam")
    assert root.metadata["frames"] == summary["frames"] == 2 * HALF + 1
    assert root.metadata["loops_detected"] == len(summary["loops_detected"])
    assert root.metadata["loops_accepted"] == len(summary["loops_accepted"]) >= 1
    geometry = _events(summary, "loop_geometry")
    assert [(e.metadata["query"], e.metadata["candidate"], e.metadata["gate"], e.metadata["accepted"]) for e in geometry] == [
        (r["query"], r["candidate"], r["gate"], r["gate"] is None) for r in summary.loop_records
    ]
    accepted = [r for r in summary.loop_records if r["gate"] is None]
    graphs = _events(summary, "loop_pose_graph")
    assert [(e.metadata["nodes"], e.metadata["edges"], e.metadata["iterations"]) for e in graphs] == [
        (len(r["poses_before"]), len(r["poses_before"]), r["iterations"]) for r in accepted
    ]
    assert all(e.parent_id == root.span_id for e in geometry + graphs)
    decode = _events(summary, "frame_decode")
    assert sorted(e.metadata["index"] for e in decode) == list(range(2 * HALF + 1))
    assert {e.thread for e in decode} == {"frame-loader"}
    assert len(_events(summary, "bow_keyframe")) == summary["keyframes"]
    # Device spans record only on a CUDA device.
    assert not _events(summary, "pose_graph.device") and not _events(summary, "loop_geometry.device")


def test_the_kitti_loops_pipeline_is_what_run_visual_slam_builds(runs):
    """``portbench/configs/kitti_loops.json``'s ``pipeline`` states the
    system ``run_visual_slam`` builds from its ``run`` group, and the loop
    stage's fixed settings."""
    config = spec.find("kitti.loops").config
    pipe = config["pipeline"]
    run_cfg = toffline.SLAMRunConfig(input_path=Path("."), **pipe["run"])
    assert run_cfg == toffline.SLAMRunConfig(input_path=Path("."), enable_local_ba=False)  # the CLI's defaults, --no-local-ba
    built = runs.file.system.config
    assert dataclasses.asdict(built.feature) == pipe["feature"]
    assert dataclasses.asdict(built.pose) == pipe["pose"]
    assert dataclasses.asdict(built.keyframe) == pipe["keyframe"]
    assert {k: getattr(built, k) for k in pipe["system"]} == pipe["system"]
    assert {k: getattr(run_cfg, k) for k in ("enable_local_ba", "pose_source")} == {k: pipe["system"][k] for k in ("enable_local_ba", "pose_source")}
    loop = pipe["loop"]
    assert (runs.bow.vocab_size, runs.bow.min_train_descriptors_factor) == (loop["bow_vocab_size"], loop["bow_min_train_descriptors_factor"])
    assert (toffline._LOOP_GEOM_M, toffline._LOOP_THRESHOLD_PX, toffline._LOOP_WEIGHT) == (
        loop["geometry_matches"], loop["geometry_threshold_px"], loop["edge_weight"]
    )
    solver = SolverConfig(max_iterations=15, damping=1e-4)
    assert {k: getattr(solver, k) for k in loop["solver"]} == loop["solver"]


def _chain(n=40, seed=3):
    """A seeded chain of ``n`` poses a unit step apart, turning a little at
    every step, and a loop edge from node 5 to node 35 that disagrees with
    the chain by a few tenths of a step and a degree."""
    rng = np.random.default_rng(seed)
    poses = [np.eye(4)]
    for _ in range(n - 1):
        step = lie_np.se3_params_to_matrix(np.concatenate([[0.05 * rng.normal(), 0.02 * rng.normal(), 1.0], rng.normal(0, 0.03, 3)]))
        poses.append(poses[-1] @ step)
    poses = np.stack(poses)
    edge = np.linalg.inv(poses[5]) @ poses[35] @ lie_np.se3_params_to_matrix(np.array([0.5, -0.3, 0.8, 0.01, -0.02, 0.015]))
    return poses, edge


def _gap(a, b, poses):
    step = np.median(np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1))
    return np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1).max() / step


def test_pose_graph_solve_equals_the_float64_reference():
    """The program's solve, on the graph ``_correct_keyframe_chain``
    builds, against ``portbench/reference/pose_graph.py``. In float64 the
    two take the same iterations and meet to rounding (1e-5 of a step: the
    solver hands its parameters back in float32, ~40 steps from the origin).
    In float32, as the program runs it, the Huber-weighted Gauss-Newton
    still lowers the cost by ~1e-4 of itself an iteration at the end, and a
    float32 cost comparison ends the solve an iteration or two before
    float64's does: the positions then differ by up to ~3% of a step, under
    the 0.1 of a step allowed. The reference rounded to bfloat16 in the
    program's place lies a whole step off (the benchmark's control)."""
    poses, edge = _chain()
    graph = PoseGraph3D.from_pose_matrices(list(poses), device="cpu")
    graph.add_loop_matrix(5, 35, edge, weight=toffline._LOOP_WEIGHT)
    config = SolverConfig(max_iterations=15, damping=1e-4)
    x64 = solve_problem(graph._build_graph().build_problem(dtype=torch.float64, device="cpu"), config).x
    result = graph.optimize(config)
    reference = ref_pose_graph.solve_chain(poses, (5, 35), edge, toffline._LOOP_WEIGHT)
    assert _gap(lie_np.se3_params_to_matrix(x64), reference, poses) < 1e-5
    assert _gap(graph.poses(), reference, poses) < 0.1 and result.iterations >= 10
    assert _gap(poses, reference, poses) > 0.3  # the loop edge moves the chain
    control = ref_pose_graph.solve_chain(poses, (5, 35), edge, toffline._LOOP_WEIGHT, dtype=torch.bfloat16)
    assert _gap(control, reference, poses) > 0.3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (device spans record only on the card)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_the_loop_stages_record_device_spans_on_the_card(cuda, tmp_path):
    """On the card the loop geometry's launches and each pose-graph solve
    are device spans inside their host spans."""
    frames, gt_pos, intrinsics, _ = render_scene(num_frames=2 * HALF + 1, traj_fn=_out_and_back, noise=6.0, seed=2)
    root, _ = write_kitti_sequence(tmp_path / "kitti", frames, gt_pos, intrinsics)
    cfg = toffline.SLAMRunConfig(input_path=root, sequence="00", output_root=tmp_path / "runs", **LOOPS)
    summary = toffline.run_visual_slam(cfg, device=cuda)
    events = summary.system.telemetry.events()
    by_id = {e.span_id: e for e in events}
    for host, dev in (("loop_geometry", "loop_geometry.device"), ("loop_pose_graph", "pose_graph.device")):
        spans = [e for e in events if e.name == dev]
        assert len(spans) == sum(e.name == host for e in events) >= 1
        for e in spans:
            parent = by_id[e.parent_id]
            assert parent.name == host
            assert parent.start_s - 1e-4 <= e.start_s <= e.timestamp_s <= parent.timestamp_s + 1e-4


def test_the_readers_loader_sleeps_while_its_buffer_is_full(monkeypatch):
    """The loader thread waits for room on a condition, not by polling (a
    poll every 0.5 ms took the interpreter lock from the tracking thread and
    slowed ``kitti.loops``'s window by ~25% on the card), hands over every
    frame in order, and ends soon once the consumer closes the stream."""
    import threading
    import time

    from mvslam_tpu_torch.runtime import frame_stream as tfs

    sleeps = []
    monkeypatch.setattr(tfs.time, "sleep", lambda s: sleeps.append(s))
    reads = []
    stream = tfs.FrameStream([Path(f"{i}.png") for i in range(6)], buffer_size=2,
                             read_fn=lambda p: reads.append(p) or np.full((2, 2), len(reads), np.uint8))
    packets = iter(stream)
    first = next(packets)
    deadline = time.monotonic() + 2.0
    while len(reads) < 4 and time.monotonic() < deadline:  # one handed over, two buffered, one waiting for room
        threading.Event().wait(0.01)
    threading.Event().wait(0.2)
    assert len(reads) == 4 and not sleeps
    rest = list(packets)
    assert [first.index] + [p.index for p in rest] == list(range(6)) and not sleeps

    stalled = tfs.FrameStream([Path(f"{i}.png") for i in range(50)], buffer_size=2, read_fn=lambda p: np.zeros((2, 2), np.uint8))
    it = iter(stalled)
    next(it)
    threading.Event().wait(0.1)
    it.close()  # the consumer leaves while the loader waits for room
    assert not stalled._thread.is_alive() and stalled.stats.loaded < 50


def test_the_ring_buffers_put_waits_for_room_and_gives_up_on_stop():
    import threading

    from mvslam_tpu_torch.runtime.frame_stream import BoundedRingBuffer

    buf, stop, done = BoundedRingBuffer(1), threading.Event(), []
    assert buf.put("a", stop)
    waiter = threading.Thread(target=lambda: done.append(buf.put("b", stop)))
    waiter.start()
    waiter.join(0.2)
    assert waiter.is_alive() and len(buf) == 1  # full: asleep
    assert buf.pop(timeout=1.0) == "a"
    waiter.join(2.0)
    assert done == [True] and buf.pop(timeout=1.0) == "b"
    assert buf.put("c", stop)
    stop.set()
    assert buf.put("d", stop) is False and len(buf) == 1
