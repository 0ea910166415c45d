"""The port's offline pipeline, runner and relocalization demo against the
JAX package's.

Loop geometry is compared stage by stage on the same keyframe pairs; the
host gates are compared exactly on the reference's rows. The whole runs are
held to ground truth, each package on its own, because RANSAC's essential
model is set by f32 rounding where hypotheses nearly tie (ROADMAP Queue 3),
so two right implementations do not chain into equal trajectories.
"""

import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from torch_parity import desc_u32, to_np

from mvslam_tpu.core.determinism import DeterminismRegistry as JRegistry
from mvslam_tpu.data.synthetic import render_scene
from mvslam_tpu.slam import offline as joffline
from mvslam_tpu.slam import relocalization_demo as jdemo
from mvslam_tpu.slam import runner as jrunner
from mvslam_tpu_torch.backend.keyframes import Keyframe, KeyframeConfig
from mvslam_tpu_torch.core.determinism import DeterminismRegistry
from mvslam_tpu_torch.data.synthetic import write_kitti_sequence
from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
from mvslam_tpu_torch.slam import api as tapi
from mvslam_tpu_torch.slam import offline as toffline
from mvslam_tpu_torch.slam import relocalization_demo as tdemo
from mvslam_tpu_torch.slam import runner as trunner
from mvslam_tpu_torch.slam.tracking import bootstrap_frame

HALF = 14


def _out_and_back(i):
    x = 0.25 * i if i <= HALF else 0.25 * (2 * HALF - i)
    return np.eye(3), np.array([x, 0.0, 0.0])


@pytest.fixture(scope="module")
def revisit(tmp_path_factory):
    """``tests/test_accuracy.py``'s loop-closure scene (29 frames, 320x240,
    out 14 frames and back) as a KITTI layout written by the port."""
    frames, gt_pos, intrinsics, poses = render_scene(num_frames=2 * HALF + 1, traj_fn=_out_and_back, noise=6.0, seed=2)
    root, gt_path = write_kitti_sequence(tmp_path_factory.mktemp("revisit") / "kitti", frames, gt_pos, intrinsics)
    return SimpleNamespace(frames=frames, gt=gt_pos, intrinsics=intrinsics, poses=poses, root=root, gt_path=gt_path)


def test_run_config_equals_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(toffline.SLAMRunConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(joffline.SLAMRunConfig)
    ]
    assert toffline._LOOP_GEOM_M == joffline._LOOP_GEOM_M == 256
    rng = np.random.default_rng(0)
    a, b = rng.integers(0, 256, (8, 9)).astype(np.uint8), rng.integers(0, 256, (8, 9)).astype(np.uint8)
    assert np.array_equal(toffline.mask_dynamic_regions(a, b, 40.0), joffline.mask_dynamic_regions(a, b, 40.0))
    assert toffline.mask_dynamic_regions(a, None, 40.0) is a


# ----------------------------------------------------------------------
# Loop geometry
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def loop_rows(revisit):
    """Keyframes 4 (out), 22 (back, two steps short of 4's place: at the
    same place the baseline is zero and the translation's direction is
    noise in both packages) and 5 (4's chain neighbour), and the rows of
    both packages for the pairs (4, 22) and (4, 5) with ``_verify_loop``'s
    salts."""
    fx, fy, cx, cy = revisit.intrinsics
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    kfs = {}
    for i in (4, 5, 22):
        fs = bootstrap_frame(torch.from_numpy(revisit.frames[i]), FeaturePipelineConfig(num_features=512, max_matches=256))
        kfs[i] = Keyframe(frame_id=i, timestamp=0.1 * i, pose=revisit.poses[i].copy(), keypoints=to_np(fs.xy),
                          descriptors=desc_u32(fs.descriptors), valid=to_np(fs.valid))
    ours = SimpleNamespace(K=K, registry=DeterminismRegistry(seed=3), device=torch.device("cpu"), telemetry=None)
    ref = SimpleNamespace(K=K, registry=JRegistry(seed=3))
    salts = [22, 4 * 2 + 1]
    rows = toffline._loop_geometry(ours, kfs[4], [kfs[22], kfs[5]], salts)
    ref_rows = joffline._loop_geometry(ref, kfs[4], [kfs[22], kfs[5]], salts)
    return SimpleNamespace(kfs=kfs, ours=ours, ref=ref, rows=rows, ref_rows=np.array(ref_rows))


def test_loop_geometry_rows_equal_reference(loop_rows):
    """One (P, 16 + 3·256) float32 array per call. Integer fields exact
    (match counts, which feature of kf_a sits in each slot); inliers within
    the vote tolerance of near-tied hypotheses; R and t within the geometry
    tests' tolerance (2 degrees, 0.05); inverse depths within 1e-3 (unit
    baseline) where both mark the slot ok and the two fits agree on the
    baseline: 1e-3 relative for points a baseline away, and looser with
    distance as two-ray triangulation loses digits with 1/parallax."""
    rows, ref_rows = loop_rows.rows, loop_rows.ref_rows
    assert rows.shape == ref_rows.shape == (2, 16 + 3 * 256) and rows.dtype == np.float32
    for row, ref_row in zip(rows, ref_rows):
        a, b = toffline._unpack_loop_row(row), joffline._unpack_loop_row(ref_row)
        assert a["num_valid"] == b["num_valid"] >= 100
        assert np.array_equal(a["idx_a"], b["idx_a"])
        assert abs(a["num_inliers"] - b["num_inliers"]) <= max(3, 0.1 * b["num_inliers"])
        assert abs(a["ratio"] - a["num_inliers"] / a["num_valid"]) < 1e-6 and row[3] == 0.0
        cos = (np.trace(a["R"].T @ b["R"]) - 1) / 2
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 2.0
        assert np.abs(a["t"] - b["t"]).max() < 0.05
        both = a["ok"] & b["ok"]
        assert both.sum() >= 0.8 * min(a["ok"].sum(), b["ok"].sum())
        if np.abs(a["t"] - b["t"]).max() < 1e-4 and np.abs(a["R"] - b["R"]).max() < 1e-5:
            za, zb = a["depths"][both].astype(np.float64), b["depths"][both].astype(np.float64)
            np.testing.assert_allclose(1.0 / za, 1.0 / zb, atol=1e-3, rtol=0)


def test_loop_geometry_is_one_fetch_and_bit_equal_across_calls(loop_rows):
    kfs = loop_rows.kfs
    again = toffline._loop_geometry(loop_rows.ours, kfs[4], [kfs[22], kfs[5]], [22, 9])
    assert np.array_equal(again, loop_rows.rows)
    # One pair alone gives the same row: pairs do not see each other.
    alone = toffline._loop_geometry(loop_rows.ours, kfs[4], [kfs[5]], [9])
    assert np.array_equal(alone[0], loop_rows.rows[1])


def test_scale_and_verify_gates_equal_reference_on_its_rows(loop_rows, monkeypatch):
    """Host math on identical rows: exact."""
    kfs, ref_rows = loop_rows.kfs, loop_rows.ref_rows
    loop, chain = toffline._unpack_loop_row(ref_rows[0]), toffline._unpack_loop_row(ref_rows[1])
    jloop, jchain = joffline._unpack_loop_row(ref_rows[0]), joffline._unpack_loop_row(ref_rows[1])
    for k in loop:
        assert np.array_equal(loop[k], jloop[k])
    scale = toffline._scale_from_rows(loop, chain, kfs[4], kfs[5])
    assert scale == joffline._scale_from_rows(jloop, jchain, kfs[4], kfs[5]) and scale is not None
    starved = dict(chain, num_inliers=3)
    assert toffline._scale_from_rows(loop, starved, kfs[4], kfs[5]) is None
    monkeypatch.setattr(toffline, "_loop_geometry", lambda *a: ref_rows)
    monkeypatch.setattr(joffline, "_loop_geometry", lambda *a: ref_rows)
    for cfg_kw in (dict(), dict(loop_min_inliers=25), dict(loop_min_inliers=10_000), dict(loop_min_inlier_ratio=0.999)):
        for nxt in (kfs[5], None):
            a = toffline._verify_loop(loop_rows.ours, kfs[4], kfs[22], toffline.SLAMRunConfig(input_path=Path("."), **cfg_kw), kf_a_next=nxt)
            b = joffline._verify_loop(loop_rows.ref, kfs[4], kfs[22], joffline.SLAMRunConfig(input_path=Path("."), **cfg_kw), kf_a_next=nxt)
            assert (a is None) == (b is None)
            if a is not None:
                assert np.array_equal(a[0], b[0]) and a[1:] == b[1:]


# ----------------------------------------------------------------------
# Whole runs
# ----------------------------------------------------------------------

def test_offline_refuses_animation_and_unknown_inputs(layered_kitti, tmp_path, monkeypatch):
    """Animation, refused until the viz package was ported, now runs; an
    unknown input kind is still refused before any artifact."""
    monkeypatch.setenv("MPLBACKEND", "Agg")
    summary = toffline.run_visual_slam(
        toffline.SLAMRunConfig(input_path=layered_kitti, output_root=tmp_path / "runs", max_frames=6, window=2,
                               enable_animation=True), device="cpu")
    assert summary["frames"] == 6 and (Path(summary["run_dir"]) / "offline_summary.json").exists()
    with pytest.raises(ValueError, match="unknown input kind"):
        toffline._load_frames(toffline.SLAMRunConfig(input_path=tmp_path / "none", input_kind="lidar"))
    assert not (tmp_path / "none").exists()


def test_offline_cli_on_an_image_directory(revisit, tmp_path, capsys):
    """``main`` with ``--kind images --device cpu``: intrinsics from the
    field of view, frames through the port's decoder."""
    images = revisit.root / "sequences" / "00" / "image_0"
    rc = toffline.main([
        "--input", str(images), "--kind", "images", "--max-frames", "5", "--output-root", str(tmp_path),
        "--device", "cpu", "--no-loop-closure", "--window", "2",
    ])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["frames"] == 5 and out["loops_accepted"] == 0
    assert (Path(out["run_dir"]) / "offline_summary.json").exists()


def _small_config(api, root, **kw):
    from mvslam_tpu.backend.keyframes import KeyframeConfig as JKC
    from mvslam_tpu.frontend.feature_pipeline import FeaturePipelineConfig as JFC
    from mvslam_tpu.frontend.pose_estimator import RobustPoseEstimatorConfig as JPC

    FC, PC, KC = (FeaturePipelineConfig, RobustPoseEstimatorConfig, KeyframeConfig) if api is tapi else (JFC, JPC, JKC)
    return api.SLAMSystemConfig(
        run_id="reloc", output_root=root, seed=7, fx=120.0, fy=120.0, cx=96.0, cy=64.0,
        feature=FC(num_features=256, max_matches=128), pose=PC(num_hypotheses=128),
        keyframe=KC(min_translation=0.01), relocalization_min_inliers=15, **kw,
    )


def _dolly(num_frames=8, h=128, w=192, shift=5, seed=21):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 30, size=(h, w + shift * num_frames)).astype(np.float32)
    for _ in range(120):
        y, x, s = rng.integers(25, h - 30), rng.integers(25, base.shape[1] - 30), rng.integers(3, 8)
        base[y : y + s, x : x + s] = rng.uniform(140, 255)
    return [base[:, i * shift : i * shift + w].copy() for i in range(num_frames)]


def test_default_configuration_relocalizes_after_an_injected_loss(tmp_path):
    """``tests/test_slam_api.py``'s relocalization flow with BA,
    relocalization and snapshots at their defaults (all on), in both
    packages: the same frames fail and relocalize; then the persisted
    snapshot arms a second system, which relocalizes the same frame."""
    from mvslam_tpu.slam import api as japi

    frames = _dolly()
    results = {}
    for name, api in (("port", tapi), ("ref", japi)):
        cfg = _small_config(api, tmp_path / name)
        assert cfg.enable_relocalization and cfg.persist_map_snapshot and cfg.enable_local_ba
        system = api.SLAMSystem(cfg, device="cpu") if api is tapi else api.SLAMSystem(cfg)
        system.inject_tracking_loss(6)
        diags = system.run_sequence(frames, window=1)
        results[name] = (system, diags, system.finalize_run())
    system, diags, result = results["port"]
    _, ref_diags, ref_result = results["ref"]
    assert diags[6].injected_loss and not diags[6].pose_success and diags[6].relocalized
    fields = ("pose_success", "failure_reason", "relocalized", "injected_loss", "is_keyframe", "num_features", "num_matches")
    assert [[getattr(d, f) for f in fields] for d in diags] == [[getattr(d, f) for f in fields] for d in ref_diags]
    assert result.num_relocalizations == ref_result.num_relocalizations >= 1
    assert result.map_snapshot_paths is not None and result.map_snapshot_paths["arrays"].exists()
    assert {k: p.name for k, p in result.map_snapshot_paths.items()} == {
        k: p.name for k, p in ref_result.map_snapshot_paths.items()
    }
    names = [e.name for e in system.telemetry.events()]
    assert "map_snapshot_build" in names and "relocalization_search" in names

    second = tapi.SLAMSystem(_small_config(tapi, tmp_path / "second"), device="cpu")
    second.load_map_snapshot(result.map_snapshot_paths["arrays"], result.map_snapshot_paths["metadata"])
    # The snapshot persisted is the one built on demand at the loss (the
    # keyframes of frames 0-5), as in the reference.
    assert second._relocalizer is not None and len(second._map_snapshot.keyframes) == 6
    second.inject_tracking_loss(6)
    again = second.run_sequence(frames, window=1)
    assert again[6].relocalized and second.finalize_run().num_relocalizations >= 1
    # ...and the reference loads the port's snapshot too.
    third = japi.SLAMSystem(_small_config(japi, tmp_path / "third"))
    third.load_map_snapshot(result.map_snapshot_paths["arrays"], result.map_snapshot_paths["metadata"])
    assert len(third._map_snapshot.keyframes) == 6


@pytest.mark.parametrize("stage", ["relocalizer", "snapshot"])
def test_only_a_starved_map_is_forgiven(tmp_path, monkeypatch, stage):
    """Too little map for a vocabulary (the builder's ``ValueError``) means
    "not relocalized" and "no snapshot persisted", as in the reference. Any
    other failure of the builder, such as a device error, propagates from
    the frame (relocalizer) or from ``finalize_run`` (snapshot)."""
    from mvslam_tpu_torch.loopclosure.map_builder import MapSnapshotBuilder

    frames = _dolly()

    def run(error):
        system = tapi.SLAMSystem(_small_config(tapi, tmp_path / stage / type(error).__name__), device="cpu")
        if stage == "relocalizer":
            system.inject_tracking_loss(6)
        monkeypatch.setattr(MapSnapshotBuilder, "build_snapshot", lambda self, keyframes: (_ for _ in ()).throw(error))
        diags = system.run_sequence(frames, window=1)
        return diags, system.finalize_run()

    diags, result = run(ValueError("need >= 64 descriptors, got 3"))
    assert not diags[6].relocalized and result.map_snapshot_paths is None and result.num_relocalizations == 0
    with pytest.raises(RuntimeError, match="device-side"):
        run(RuntimeError("CUDA error: device-side assert triggered"))


def _artifacts(run_dir):
    run_dir = Path(run_dir)
    return sorted(str(p.relative_to(run_dir)) for p in run_dir.rglob("*") if p.is_file())


@pytest.fixture(scope="module")
def layered_kitti(tmp_path_factory):
    """``tests/test_slam_runner.py``'s fake KITTI: two depth layers, so the
    motion is observable; written with the port's PNG writer."""
    num_frames, h, w, shift = 8, 96, 128, 4
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 30, size=(h, w + shift * num_frames)).astype(np.float32)
    for _ in range(80):
        y, x, s = rng.integers(22, h - 28), rng.integers(22, base.shape[1] - 28), rng.integers(3, 7)
        base[y : y + s, x : x + s] = rng.uniform(140, 255)
    frames = [
        np.concatenate([base[: h // 2, (i * shift) // 2 : (i * shift) // 2 + w], base[h // 2 :, i * shift : i * shift + w]])
        for i in range(num_frames)
    ]
    root, _ = write_kitti_sequence(tmp_path_factory.mktemp("layered") / "kitti", frames, np.zeros((num_frames, 3)),
                                   (100.0, 100.0, w / 2, h / 2))
    return root


@pytest.mark.parametrize("ingestion", ["sync", "stream", "async", "native"])
def test_run_kitti_sequence_writes_the_references_artifacts(layered_kitti, tmp_path, ingestion):
    kw = dict(sequence="00", run_id="kitti_run", seed=1, max_frames=6, ingestion=ingestion, inject_loss_at=4, window=2)
    ours = trunner.run_kitti_sequence(layered_kitti, output_root=tmp_path / "port", device="cpu", **kw)
    ref = jrunner.run_kitti_sequence(layered_kitti, output_root=tmp_path / "ref", **kw)
    assert _artifacts(ours.run_dir) == _artifacts(ref.run_dir)
    assert (ours.num_frames, ours.num_keyframes, ours.num_failures) == (ref.num_frames, ref.num_keyframes, ref.num_failures)
    assert ours.num_frames == 6 and ours.num_failures >= 1
    assert (ours.map_snapshot_paths is None) == (ref.map_snapshot_paths is None)
    if ingestion == "native":
        report, ref_report = (json.loads((r.run_dir / "reports" / "ingestion_report.json").read_text()) for r in (ours, ref))
        assert report.keys() == ref_report.keys()
        assert (report["backend"], report["decoded"], report["failed"]) == (ref_report["backend"], ref_report["decoded"], 0)


def test_runner_config_and_refusals(layered_kitti, tmp_path, monkeypatch):
    cfg = tmp_path / "pipeline.json"
    cfg.write_text(json.dumps({"feature": {"num_features": 128}, "pose": {"num_hypotheses": 64}, "keyframe": {"window_size": 3}}))
    ours, ref = trunner.load_pipeline_config(cfg), jrunner.load_pipeline_config(cfg)
    assert {k: dataclasses.asdict(v) for k, v in ours.items()} == {k: dataclasses.asdict(v) for k, v in ref.items()}
    assert trunner.load_pipeline_config(None) == {}
    cfg.write_text(json.dumps({"feature": {"bogus": 1}}))
    with pytest.raises(ValueError, match="unknown feature config"):
        trunner.load_pipeline_config(cfg)
    cfg.write_text(json.dumps({"extra": {}}))
    with pytest.raises(ValueError, match="unknown pipeline config sections"):
        trunner.load_pipeline_config(cfg)
    with monkeypatch.context() as m:  # native mode without the library is refused, as the reference's is
        m.setattr(trunner.native, "native_available", lambda: False)
        with pytest.raises(RuntimeError, match="C\\+\\+ library is unavailable"):
            trunner.run_kitti_sequence(layered_kitti, output_root=tmp_path / "runs", ingestion="native", device="cpu")
    with pytest.raises(ValueError, match="unknown ingestion"):
        trunner.run_kitti_sequence(layered_kitti, output_root=tmp_path / "runs", ingestion="carrier", device="cpu")
    with pytest.raises(ValueError, match="validation failed"):
        trunner.run_kitti_sequence(tmp_path / "nothing", output_root=tmp_path / "runs", device="cpu")
    assert not (tmp_path / "runs").exists()  # refused before any artifact


def test_relocalization_demo_writes_the_references_report(layered_kitti, tmp_path):
    kw = dict(dataset_root=layered_kitti, inject_at_frame=5, max_frames=8, seed=1)
    ours = tdemo.run_relocalization_demo(tdemo.RelocalizationDemoConfig(output_root=tmp_path / "port", **kw), device="cpu")
    ref = jdemo.run_relocalization_demo(jdemo.RelocalizationDemoConfig(output_root=tmp_path / "ref", **kw))
    assert _artifacts(ours["run_dir"]) == _artifacts(ref["run_dir"])
    assert Path(ours["report_path"]).name == "relocalization_demo_report.json"
    assert ours.keys() == ref.keys() and ours["injected_frames"] == ref["injected_frames"] == [5]
    assert ours["events_summary"].keys() == ref["events_summary"].keys()
    assert ours["frames_summary"].keys() == ref["frames_summary"].keys()
    assert ours["recovered"] == ref["recovered"]
    assert [(f.name, f.default) for f in dataclasses.fields(tdemo.RelocalizationDemoConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(jdemo.RelocalizationDemoConfig)
    ]
