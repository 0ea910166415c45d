"""Loop closure on a long out-and-back drive, stage by stage against the
JAX package on the same keyframes.

The reference's ``run_visual_slam`` runs once over a 61-frame revisit scene
(320x240, 0.1 per frame out to frame 30 and back, window BA off so that the
stage under test is the only one that moves keyframes) with a recorder on
its loop stage: for every detected loop the keyframes and trajectory as they
stood, the loop-geometry rows, the verdict and edge of ``_verify_loop``, and
for every accepted loop the keyframes and trajectory after the pose-graph
correction. Each recorded step then goes through the port's functions from
the reference's own state, so a difference cannot build up along the run:

- ``_loop_geometry`` + ``_verify_loop`` on the same keyframe pairs: the same
  verdicts, and the same edges wherever the pair determines them;
- ``_verify_loop`` on the reference's rows: its edges exactly (scale and
  edge assembly are host math);
- ``_correct_keyframe_chain`` from the same keyframes and edge: the
  reference's corrected keyframes; ``_propagate_correction``: its
  trajectory exactly.

On this drive every accepted loop but one is an exact revisit (frame q shows
the place of frame 60 - q): a zero-baseline pair, which leaves the direction
of the translation undetermined in both packages (all 256 matches are
inliers of any skew matrix). Those edges are held on their rotation and on
the cap of their length; the translation is held where the pair has a
baseline.
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)

from mvslam_tpu.slam import offline as joffline
from mvslam_tpu_torch.backend.keyframes import Keyframe
from mvslam_tpu_torch.core.determinism import DeterminismRegistry
from mvslam_tpu_torch.data.synthetic import render_scene, write_kitti_sequence
from mvslam_tpu_torch.slam import offline as toffline

HALF = 30
STEP = 0.1
LOOP_SETTINGS = dict(seed=3, loop_min_frame_gap=12, loop_similarity_threshold=0.7, loop_min_inliers=25)


def _out_and_back(i):
    x = STEP * i if i <= HALF else STEP * (2 * HALF - i)
    return np.eye(3), np.array([x, 0.0, 0.0])


def _angle_deg(Ra, Rb):
    return float(np.degrees(np.arccos(np.clip((np.trace(Ra.T @ Rb) - 1) / 2, -1, 1))))


def _state(system):
    return dict(
        kf_poses={int(k.frame_id): np.array(k.pose, np.float64) for k in system.keyframes.keyframes},
        traj_ids=[int(f) for f in system.trajectory.frame_ids],
        traj_poses=[np.array(p, np.float64) for p in system.trajectory.poses],
        pose=np.array(system._pose, np.float64),
    )


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """The reference's run with a recorder on ``_loop_geometry``,
    ``_verify_loop`` and the "loop accepted" log line, which it writes
    right after the correction has been propagated."""
    out = tmp_path_factory.mktemp("long_drive")
    frames, gt_pos, intrinsics, _ = render_scene(num_frames=2 * HALF + 1, traj_fn=_out_and_back, noise=6.0, seed=2)
    root, gt_path = write_kitti_sequence(out / "kitti", frames, gt_pos, intrinsics)
    steps, seen = [], {}
    verify, geometry = joffline._verify_loop, joffline._loop_geometry

    def recording_geometry(system, kf_a, kf_bs, salts):
        seen["rows"] = np.array(geometry(system, kf_a, kf_bs, salts))
        return seen["rows"]

    def recording_verify(system, kf_a, kf_b, config, kf_a_next=None):
        seen["system"] = system
        step = dict(
            cand=int(kf_a.frame_id), query=int(kf_b.frame_id),
            cand_next=None if kf_a_next is None else int(kf_a_next.frame_id), before=_state(system),
        )
        result = verify(system, kf_a, kf_b, config, kf_a_next=kf_a_next)
        step["rows"] = seen["rows"]
        step["verified"] = None if result is None else (np.array(result[0], np.float64), result[1], result[2])
        steps.append(step)
        return result

    class Recorder:
        def info(self, message, *args, **kwargs):
            if message == "loop accepted":
                steps[-1]["after"] = _state(seen["system"])

        def __getattr__(self, name):
            return lambda *args, **kwargs: None

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(joffline, "_verify_loop", recording_verify)
        patch.setattr(joffline, "_loop_geometry", recording_geometry)
        patch.setattr(joffline, "logger", Recorder())
        summary = joffline.run_visual_slam(joffline.SLAMRunConfig(
            input_path=root, input_kind="kitti", sequence="00", ground_truth_path=gt_path, run_id="long",
            output_root=out / "runs", enable_local_ba=False, **LOOP_SETTINGS,
        ))
    system = seen["system"]
    features = {
        int(k.frame_id): dict(timestamp=float(k.timestamp), keypoints=np.array(k.keypoints),
                              descriptors=np.array(k.descriptors), valid=np.array(k.valid))
        for k in system.keyframes.keyframes
    }
    assert len(steps) == len(summary["loops_detected"]) >= 40
    assert sum(s["verified"] is not None for s in steps) == len(summary["loops_accepted"]) >= 20
    return SimpleNamespace(steps=steps, features=features, K=np.array(system.K, np.float64))


def _keyframe(recorded, frame_id, poses):
    return Keyframe(frame_id=frame_id, pose=poses[frame_id].copy(), **recorded.features[frame_id])


def _port_system(recorded, state=None):
    """What the port's loop stage reads of a ``SLAMSystem``, on the CPU, at
    a recorded state of the reference."""
    system = SimpleNamespace(K=recorded.K, registry=DeterminismRegistry(seed=LOOP_SETTINGS["seed"]),
                             device=torch.device("cpu"), telemetry=None)
    if state is not None:
        ids = sorted(state["kf_poses"])
        system.keyframes = SimpleNamespace(keyframes=[_keyframe(recorded, i, state["kf_poses"]) for i in ids])
        system.trajectory = SimpleNamespace(frame_ids=list(state["traj_ids"]), poses=[p.copy() for p in state["traj_poses"]])
        system._pose = state["pose"].copy()
    return system


def _config():
    return toffline.SLAMRunConfig(input_path=Path("."), **LOOP_SETTINGS)


def _pair(recorded, step):
    poses = step["before"]["kf_poses"]
    nxt = None if step["cand_next"] is None else _keyframe(recorded, step["cand_next"], poses)
    return _keyframe(recorded, step["cand"], poses), _keyframe(recorded, step["query"], poses), nxt


def test_loop_verdicts_and_edges_equal_reference_on_a_long_drive(recorded, monkeypatch):
    """Every detected loop of the drive through the port's geometry: the
    verdict is the reference's on all of them. Rows on which both packages
    count the same inliers, at least 15 and at most three quarters of the
    matches (a model that tells inliers from outliers, and the same winner
    of the vote): R within 0.1 degrees, unit t within 1e-3. Rows where nearly
    every match is an inlier (exact revisits, and chain neighbours 0.1
    apart) do not determine t, in either package. Accepted edges:
    inliers within 3, rotation within 0.1 degrees of the reference's, scale
    within the cap ``max(chain distance, 1)``; and where the pair has a
    baseline, the whole edge, scale included, within 1e-3 of its length.
    On exact revisits both packages' edges are a good part of a chain step
    long although the truth is 0."""
    system, config = _port_system(recorded), _config()
    geometry, seen = toffline._loop_geometry, {}

    def keeping_geometry(*args):
        seen["rows"] = geometry(*args)
        return seen["rows"]

    monkeypatch.setattr(toffline, "_loop_geometry", keeping_geometry)
    determined = with_baseline = 0
    revisit_lengths = {"port": [], "reference": []}
    for step in recorded.steps:
        cand, query, nxt = _pair(recorded, step)
        ours, ref = toffline._verify_loop(system, cand, query, config, kf_a_next=nxt), step["verified"]
        where = f"query {step['query']}, candidate {step['cand']}"
        assert (ours is None) == (ref is None), where
        for row, ref_row in zip(seen["rows"], step["rows"]):
            a, b = toffline._unpack_loop_row(row), toffline._unpack_loop_row(ref_row)
            assert a["num_valid"] == b["num_valid"] and np.array_equal(a["idx_a"], b["idx_a"]), where
            if a["num_inliers"] == b["num_inliers"] and 15 <= a["num_inliers"] <= 0.75 * a["num_valid"]:
                determined += 1
                assert _angle_deg(a["R"], b["R"]) < 0.1 and np.abs(a["t"] - b["t"]).max() < 1e-3, where
        if ours is None:
            continue
        assert abs(ours[1] - ref[1]) <= 3 and abs(ours[2] - ref[2]) <= 3 / 256, where
        assert _angle_deg(ours[0][:3, :3], ref[0][:3, :3]) < 0.1, where
        # The cap bounds the scale; the edge is -Rᵀ(t·scale) with f32 R and
        # unit t, whose norms miss 1 by ulps (the reference's own edge on
        # query 35 is 6e-8 longer than the cap), so divide them out.
        cap = max(float(np.linalg.norm(query.pose[:3, 3] - cand.pose[:3, 3])), 1.0)
        loop = toffline._unpack_loop_row(seen["rows"][0])
        scale = np.linalg.norm(ours[0][:3, 3]) / np.linalg.norm(loop["R"].T @ loop["t"])
        assert scale <= cap + 1e-9, where
        if step["cand"] + step["query"] == 2 * HALF:  # an exact revisit: the true translation is 0
            revisit_lengths["port"].append(np.linalg.norm(ours[0][:3, 3]))
            revisit_lengths["reference"].append(np.linalg.norm(ref[0][:3, 3]))
        if ref[1] < 256:  # not every match an inlier: the pair has a baseline
            with_baseline += 1
            length = np.linalg.norm(ref[0][:3, 3])
            assert np.linalg.norm(ours[0][:3, 3] - ref[0][:3, 3]) < 1e-3 * length, where
    assert determined >= 6 and with_baseline >= 1
    # What both packages hand the pose graph on an exact revisit: an edge a
    # good part of a chain step long (one step is 1: the tracker's unit
    # translations) where the truth is 0, because depth ratios of a
    # zero-baseline triangulation carry no scale. Pinned so that a repair of
    # the scale estimate in either package shows here.
    assert len(revisit_lengths["reference"]) >= 20
    for package, lengths in revisit_lengths.items():
        assert np.median(lengths) > 0.1, (package, sorted(lengths))


def test_verify_loop_on_the_references_rows_gives_its_edges_exactly(recorded, monkeypatch):
    """Gates, structure-transfer scale, cap and edge assembly are host
    math: on the reference's rows the port returns the reference's verdict
    and edge bit for bit, on every detected loop of the drive."""
    system, config = _port_system(recorded), _config()
    for step in recorded.steps:
        monkeypatch.setattr(toffline, "_loop_geometry", lambda *args, rows=step["rows"]: rows)
        cand, query, nxt = _pair(recorded, step)
        ours, ref = toffline._verify_loop(system, cand, query, config, kf_a_next=nxt), step["verified"]
        assert (ours is None) == (ref is None)
        if ours is not None:
            assert np.array_equal(ours[0], ref[0]) and ours[1:] == ref[1:]


def test_pose_graph_correction_and_propagation_equal_reference(recorded):
    """Each accepted loop's correction from the reference's own keyframes
    and edge. The zero-baseline edges leave the cost flat along part of the
    chain (the reference's own answers after 15 and after 60 iterations lie
    up to 10% of the correction apart, at equal cost to five digits), and
    each package stops where rounding ends its descent. So the corrected
    keyframe positions are held to the reference's within 10% of the largest
    move on every loop and within 1e-3 of it on the median loop, rotations
    within 0.5 degrees. Propagation into the trajectory is host math: from
    the reference's corrected keyframes, its trajectory within 1e-9."""
    accepted = [s for s in recorded.steps if s["verified"] is not None]
    relative = []
    for step in accepted:
        before, after = step["before"], step["after"]
        ids = sorted(before["kf_poses"])
        system = _port_system(recorded, before)
        toffline._correct_keyframe_chain(system, step["cand"], step["query"], step["verified"][0])
        ours = np.stack([k.pose for k in system.keyframes.keyframes])
        ref = np.stack([after["kf_poses"][i] for i in ids])
        start = np.stack([before["kf_poses"][i] for i in ids])
        moved = np.abs(ref[:, :3, 3] - start[:, :3, 3]).max()
        relative.append(np.abs(ours[:, :3, 3] - ref[:, :3, 3]).max() / moved)
        assert relative[-1] < 0.1, (step["query"], relative[-1], moved)
        assert max(_angle_deg(a[:3, :3], b[:3, :3]) for a, b in zip(ours, ref)) < 0.5
        assert np.array_equal(system._pose, ours[-1]) and len(system.trajectory.poses) == len(after["traj_poses"])

        system = _port_system(recorded, before)
        toffline._propagate_correction(system, ref)
        np.testing.assert_allclose(np.stack(system.trajectory.poses), np.stack(after["traj_poses"]), rtol=0, atol=1e-9)
        assert all(np.array_equal(k.pose, after["kf_poses"][i]) for k, i in zip(system.keyframes.keyframes, ids))
        np.testing.assert_array_equal(system._pose, after["pose"])
    assert np.median(relative) < 1e-3, sorted(relative)
