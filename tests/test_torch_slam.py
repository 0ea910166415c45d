"""The port's ``SLAMSystem`` against the JAX package's, on one rendered 3-D
scene, run three ways: superwindows with a padded tail, one frame at a
time, and flow-first one frame at a time. Both run with window BA,
relocalization and map snapshots off (the port refuses them).

What is compared, and why so:

- Integer stages agree exactly: features, matches or LK tracks per frame,
  and with them the gates' outcomes (``pose_success``, ``failure_reason``)
  and the keyframe decisions.
- RANSAC does not: where the best essential hypotheses of a pair are
  within a vote or two of each other, or the pair is E-degenerate, f32
  rounding in the 8-point null vector picks the winner, in the reference
  as in the port (a float64 port disagrees with the reference as much;
  ROADMAP Queue 3). So ``model_type`` agrees on most frames, not all, and
  the trajectories are held to ground truth by the same gate as
  ``tests/test_accuracy.py`` rather than to each other.
- The host engine is compared exactly on identical scalar bundles.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)

from mvslam_tpu.data.synthetic import render_scene
from mvslam_tpu.eval.trajectory import compute_ate
from mvslam_tpu.frontend.feature_pipeline import FeaturePipelineConfig as JFeatureConfig
from mvslam_tpu.frontend.pose_estimator import RobustPoseEstimatorConfig as JPoseConfig
from mvslam_tpu.slam import api as japi
from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
from mvslam_tpu_torch.slam import api as tapi

NUM_FRAMES = 12
MODES = {
    "superwindow": dict(window=4, windows_per_dispatch=2),  # 1 + 8 + 3 padded to 8
    "per_frame": dict(window=1),
    "flow_first": dict(window=1),
}
FLAGS = ("pose_success", "failure_reason", "is_keyframe", "num_features", "num_matches", "injected_loss")
INJECTED = 6


@pytest.fixture(scope="module")
def scene():
    frames, gt, intrinsics, _ = render_scene(num_frames=NUM_FRAMES, h=240, w=320, seed=1)
    return frames, gt, intrinsics


def _config(pkg, intrinsics, root, mode, **kw):
    fx, fy, cx, cy = intrinsics
    feature, pose = (
        (JFeatureConfig, JPoseConfig) if pkg is japi else (FeaturePipelineConfig, RobustPoseEstimatorConfig)
    )
    return pkg.SLAMSystemConfig(
        run_id=f"parity_{mode}", output_root=root, seed=3, fx=fx, fy=fy, cx=cx, cy=cy,
        feature=feature(num_features=256, max_matches=128), pose=pose(num_hypotheses=128),
        pose_source="flow_first" if mode == "flow_first" else "features",
        enable_local_ba=False, enable_relocalization=False, persist_map_snapshot=False, **kw,
    )


def _run(pkg, scene, root, mode, inject=None):
    frames, _, intrinsics = scene
    cfg = _config(pkg, intrinsics, root, mode)
    system = pkg.SLAMSystem(cfg) if pkg is japi else pkg.SLAMSystem(cfg, device="cpu")
    if inject is not None:
        system.inject_tracking_loss(inject)
    diags = system.run_sequence(frames, **MODES[mode])
    return system, diags, system.finalize_run()


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    """mode -> (reference run, port run), each (system, diags, result)."""
    root = tmp_path_factory.mktemp("slam")
    return {
        mode: (_run(japi, scene, root / f"ref_{mode}", mode), _run(tapi, scene, root / f"port_{mode}", mode))
        for mode in MODES
    }


@pytest.mark.parametrize("mode", list(MODES))
def test_frame_flags_equal_reference(runs, mode):
    (_, jd, _), (_, td, _) = runs[mode]
    assert len(td) == len(jd) == NUM_FRAMES
    for a, b in zip(jd, td):
        for name in FLAGS:
            assert getattr(b, name) == getattr(a, name), (a.frame_id, name)
        assert b.model_type.split("_")[0] == a.model_type.split("_")[0]  # bootstrap / flow_ / matched
    tracked = [(a.model_type, b.model_type) for a, b in zip(jd[1:], td[1:])]
    assert sum(a == b for a, b in tracked) >= 0.8 * len(tracked), tracked
    assert sum(d.pose_success for d in td) >= NUM_FRAMES - 1
    if mode == "flow_first":
        assert all(d.model_type.startswith("flow_") for d in td[1:])


@pytest.mark.parametrize("mode", list(MODES))
def test_trajectory_passes_reference_gate(runs, scene, mode):
    """Both trajectories pass ``tests/test_accuracy.py``'s gate: Sim3 ATE
    under 8% of the extent and a consistent direction of travel."""
    _, gt, _ = scene
    extent = np.linalg.norm(gt[-1] - gt[0])
    for system, _, _ in runs[mode]:
        est = np.stack(system.trajectory.poses)[:, :3, 3]
        assert np.isfinite(est).all()
        assert compute_ate(est, gt) < 0.08 * extent
        steps = np.diff(est, axis=0)
        assert (steps @ np.array([1.0, 0.0, 0.2]) > 0).mean() > 0.7


def _key_shape(x):
    """The nesting of dict keys in a JSON value; a list gives the set of its
    elements' shapes."""
    if isinstance(x, dict):
        return {k: _key_shape(v) for k, v in x.items()}
    if isinstance(x, list):
        return sorted({json.dumps(_key_shape(e), sort_keys=True) for e in x})
    return None


@pytest.mark.parametrize("mode", list(MODES))
def test_artifacts_equal_reference(runs, mode):
    """Same files, same JSON keys, same determinism payloads."""
    (_, _, jres), (_, _, tres) = runs[mode]
    jfiles = sorted(str(p.relative_to(jres.run_dir)) for p in jres.run_dir.rglob("*"))
    tfiles = sorted(str(p.relative_to(tres.run_dir)) for p in tres.run_dir.rglob("*"))
    assert tfiles == jfiles
    for name in jfiles:
        if name.endswith(".json"):
            a = json.loads((jres.run_dir / name).read_text())
            b = json.loads((tres.run_dir / name).read_text())
            assert _key_shape(b) == _key_shape(a), name
            if isinstance(a, dict) and "determinism" in a:
                assert b["determinism"] == a["determinism"] == {"seed": 3, "config_hash": ""}, name
    npz_a, npz_b = np.load(jres.trajectory_path), np.load(tres.trajectory_path)
    assert sorted(npz_b.files) == sorted(npz_a.files)
    assert np.array_equal(npz_b["frame_ids"], npz_a["frame_ids"])
    assert np.array_equal(npz_b["timestamps"], npz_a["timestamps"])
    for field in ("num_frames", "num_keyframes", "num_failures", "num_relocalizations"):
        assert getattr(tres, field) == getattr(jres, field), field
    assert tres.map_snapshot_paths is None and jres.map_snapshot_paths is None


def test_dispatch_shapes_give_identical_runs(runs):
    """Per-frame keys fold the global frame id: superwindows with a padded
    tail and one frame at a time make the same trajectory, bit for bit."""
    (_, _, _), (sw, swd, _) = runs["superwindow"]
    (_, _, _), (pf, pfd, _) = runs["per_frame"]
    assert np.array_equal(np.stack(sw.trajectory.poses), np.stack(pf.trajectory.poses))
    for a, b in zip(swd, pfd):
        # correlation ids hash the run id, which names the mode
        assert dict(a.to_dict(), correlation_id="") == dict(b.to_dict(), correlation_id="")


def test_inject_tracking_loss_equals_reference(scene, tmp_path):
    """An injected loss fails that frame in both, in superwindow mode, and
    the pose chain holds across it."""
    jsys, jd, _ = _run(japi, scene, tmp_path / "ref", "superwindow", inject=INJECTED)
    tsys, td, tres = _run(tapi, scene, tmp_path / "port", "superwindow", inject=INJECTED)
    for a, b in zip(jd, td):
        for name in FLAGS:
            assert getattr(b, name) == getattr(a, name), (a.frame_id, name)
    assert td[INJECTED].failure_reason == "injected_tracking_loss" and td[INJECTED].injected_loss
    assert not td[INJECTED].pose_success and tres.num_failures >= 1
    assert np.array_equal(tsys.trajectory.poses[INJECTED], tsys.trajectory.poses[INJECTED - 1])


def _scalar_stream(n, seed=0):
    """Scalar bundles as ``pull_scalars`` gives them, some failing gates."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        angle = rng.uniform(-0.05, 0.05)
        c, s = np.cos(angle), np.sin(angle)
        t = rng.normal(size=3)
        out.append({
            "rotation": np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32),
            "translation": (t / np.linalg.norm(t)).astype(np.float32),
            "use_essential": bool(rng.uniform() > 0.5),
            "num_inliers": np.float32(rng.integers(5, 120)),
            "inlier_ratio": np.float32(rng.uniform(0.1, 0.9)),
            "median_parallax_deg": np.float32(rng.uniform(0.05, 3.0)),
            "cheirality_ratio": np.float32(rng.uniform(0.4, 1.0)),
            "score": np.float32(rng.uniform(-0.1, 1.0)),
            "median_displacement_px": np.float32(rng.uniform(0.2, 10.0)),
            "num_matches": np.float32(rng.integers(0, 200)),
            "num_features": np.float32(rng.integers(150, 256)),
        })
    return out


def test_host_engine_equals_reference_on_same_scalars(tmp_path):
    """Gates, pose chaining, keyframes and diagnostics from identical scalar
    bundles: bit-equal poses and records, the same keyframes."""
    intrinsics = (200.0, 200.0, 160.0, 120.0)
    systems = [
        japi.SLAMSystem(_config(japi, intrinsics, tmp_path / "ref", "per_frame")),
        tapi.SLAMSystem(_config(tapi, intrinsics, tmp_path / "port", "per_frame"), device="cpu"),
    ]
    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 300, (256, 2)).astype(np.float32)
    desc = rng.integers(0, 2**32, (256, 8), dtype=np.uint64).astype(np.uint32)
    valid = rng.uniform(size=256) > 0.3
    for system in systems:
        system.inject_tracking_loss(7)
        for i, scalars in enumerate(_scalar_stream(30)):
            d = (japi if system is systems[0] else tapi).FrameDiagnostics(frame_id=i, timestamp=0.1 * i)
            system._handle_tracked_frame(i, 0.1 * i, d, dict(scalars), lambda: (xy, desc, valid))
    ref, port = systems
    assert [d.to_dict() for d in port.diagnostics] == [d.to_dict() for d in ref.diagnostics]
    assert np.array_equal(np.stack(port.trajectory.poses), np.stack(ref.trajectory.poses))
    assert [k.frame_id for k in port.keyframes.keyframes] == [k.frame_id for k in ref.keyframes.keyframes]
    assert port._failure_count == ref._failure_count > 0
    assert any(d.pose_success for d in port.diagnostics)


def test_run_stream_equals_run_sequence(scene, tmp_path):
    from mvslam_tpu_torch.runtime.frame_stream import packets_from_arrays

    frames, _, intrinsics = scene
    a = tapi.SLAMSystem(_config(tapi, intrinsics, tmp_path / "a", "superwindow"), device="cpu")
    b = tapi.SLAMSystem(_config(tapi, intrinsics, tmp_path / "b", "superwindow"), device="cpu")
    da = a.run_sequence(frames[:6], window=4)
    db = b.run_stream(packets_from_arrays(frames[:6]), window=4)
    assert [d.to_dict() for d in da] == [d.to_dict() for d in db]
    assert np.array_equal(np.stack(a.trajectory.poses), np.stack(b.trajectory.poses))


@pytest.mark.parametrize(
    "ours,ref",
    [
        (tapi.SLAMSystemConfig, japi.SLAMSystemConfig),
        (tapi.FrameDiagnostics, japi.FrameDiagnostics),
        (tapi.SLAMRunResult, japi.SLAMRunResult),
    ],
)
def test_api_dataclasses_equal_reference(ours, ref):
    """Same fields, order and defaults; nested config defaults equal field
    for field."""
    assert [(f.name, f.default) for f in dataclasses.fields(ours)] == [
        (f.name, f.default) for f in dataclasses.fields(ref)
    ]
    for a, b in zip(dataclasses.fields(ours), dataclasses.fields(ref)):
        if a.default_factory is not dataclasses.MISSING:
            assert dataclasses.asdict(a.default_factory()) == dataclasses.asdict(b.default_factory())
    assert ours.__dataclass_params__.frozen == ref.__dataclass_params__.frozen


@pytest.mark.parametrize(
    "flag,step",
    [("enable_local_ba", "step 11"), ("enable_relocalization", "step 12"), ("persist_map_snapshot", "step 12")],
)
def test_unported_stages_are_refused(tmp_path, flag, step):
    """Each stage by the ROADMAP step that brought it: steps 11 (window BA)
    and 12 (relocalization, map snapshots) are ported, so no flag is
    refused any more and the default configuration constructs."""
    cfg = _config(tapi, (200.0, 200.0, 160.0, 120.0), tmp_path, "per_frame")
    system = tapi.SLAMSystem(dataclasses.replace(cfg, **{flag: True}), device="cpu")
    assert getattr(system.config, flag) is True
    if step == "step 11":
        assert system._local_ba is not None and system.keyframes._on_window == system._on_keyframe_window
    assert not hasattr(tapi, "_NOT_PORTED")
    default = tapi.SLAMSystem(tapi.SLAMSystemConfig(output_root=tmp_path), device="cpu")
    assert default.config.enable_relocalization and default.config.persist_map_snapshot
    assert default._relocalizer is None and default._map_snapshot is None  # built on demand


def test_device_is_explicit(tmp_path):
    cfg = _config(tapi, (200.0, 200.0, 160.0, 120.0), tmp_path, "per_frame")
    with pytest.raises(TypeError):
        tapi.SLAMSystem(cfg)
    system = tapi.SLAMSystem(cfg, device=torch.device("cpu"))
    assert system.device == torch.device("cpu") and system._K_dev.device == system.device
