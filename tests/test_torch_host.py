"""The port's host modules against the JAX package's: determinism, hashing,
persistence, telemetry, keyframe policy, frame ingestion, the scene
renderer, the benchmark's frames and the trajectory metrics. All are numpy
code copied into the port, so every comparison is exact."""

import ast
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from torch_parity import t, to_np

from mvslam_tpu.backend import keyframes as jkf
from mvslam_tpu.core import determinism as jdet
from mvslam_tpu.core import integrity as jint
from mvslam_tpu.core import persistence as jpers
from mvslam_tpu.core import telemetry as jtel
from mvslam_tpu.data import synthetic as jsyn
from mvslam_tpu.eval import telemetry_intelligence as jti
from mvslam_tpu.eval import trajectory as jtraj
from mvslam_tpu.runtime import frame_stream as jfs
from mvslam_tpu_torch.backend import keyframes as tkf
from mvslam_tpu_torch.core import determinism as tdet
from mvslam_tpu_torch.core import integrity as tint
from mvslam_tpu_torch.core import persistence as tpers
from mvslam_tpu_torch.core import telemetry as ttel
from mvslam_tpu_torch.data import bench_frames as tbf
from mvslam_tpu_torch.data import synthetic as tsyn
from mvslam_tpu_torch.eval import telemetry_intelligence as tti
from mvslam_tpu_torch.eval import trajectory as ttraj
from mvslam_tpu_torch.runtime import frame_stream as tfs

REPO = Path(__file__).resolve().parents[1]


def _payload():
    rng = np.random.default_rng(0)
    return {
        "seed": 7,
        "name": "run",
        "poses": rng.normal(size=(3, 4, 4)),
        "ids": np.arange(5, dtype=np.int32),
        "flags": [True, False, np.bool_(True)],
        "nested": {"x": 1.5, "y": [np.float32(0.25), None], "p": Path("a/b")},
        "set": {3, 1, 2},
    }


def test_stable_hash_equals_reference():
    payload = _payload()
    assert tint.stable_hash(payload) == jint.stable_hash(payload)
    assert tint.stable_hash(payload, exclude_keys=["name"]) == jint.stable_hash(payload, exclude_keys=["name"])
    # A CPU tensor hashes like the numpy array it holds.
    assert tint.stable_hash({"a": torch.arange(4)}) == jint.stable_hash({"a": np.arange(4)})
    events = [{"name": "s", "duration_s": 0.5, "timestamp_s": i, "metadata": {"i": i}} for i in range(3)]
    assert tint.stable_event_digest(events) == jint.stable_event_digest(events)


@pytest.mark.parametrize("seed", [0, 7, 2**40 + 3])
@pytest.mark.parametrize("component", ["tracking", "local_ba", "relocalization"])
def test_key_for_equals_reference(seed, component):
    """The port's key words equal ``jax.random.key_data`` of the reference's key."""
    ours = tdet.DeterminismRegistry(seed=seed).key_for(component)
    ref = jdet.DeterminismRegistry(seed=seed).key_for(component)
    assert np.array_equal(to_np(ours), np.asarray(jax.random.key_data(ref)))
    assert tdet.DeterminismRegistry(seed=seed).seed_for(component) == jdet.DeterminismRegistry(seed=seed).seed_for(component)


def test_registry_metadata_and_rngs_equal_reference(tmp_path):
    cfg = tmp_path / "c.json"
    cfg.write_text('{"a": 1}')
    ours, ref = tdet.build_registry(5, cfg), jdet.build_registry(5, cfg)
    assert ours.metadata() == ref.metadata()
    assert np.array_equal(ours.rng_for("x").normal(size=4), ref.rng_for("x").normal(size=4))


def test_run_store_artifacts_equal_reference(tmp_path):
    """Same run directory layout, file names and JSON contents."""
    from mvslam_tpu.core import experiments as jexp
    from mvslam_tpu_torch.core import experiments as texp

    rng = np.random.default_rng(1)
    poses = rng.normal(size=(4, 4, 4))
    dirs = []
    for exp, pers, root in ((jexp, jpers, tmp_path / "ref"), (texp, tpers, tmp_path / "port")):
        arts = exp.create_run_artifacts(root, "run", metadata={"seed": 1, "config_hash": "h"})
        store = pers.RunDataStore(arts.run_dir, determinism={"seed": 1, "config_hash": "h"})
        acc = pers.TrajectoryAccumulator()
        for i, p in enumerate(poses):
            acc.append(i, 0.1 * i, p)
        store.save_trajectory("estimated", acc)
        store.save_metrics("run_metrics", {"n": 4, **pers.summarize_trajectory(acc.as_arrays()["poses"])})
        store.save_frame_diagnostics("frame_diagnostics", [{"frame_id": i, "ok": True} for i in range(4)])
        store.save_report("r", {"k": [1, 2]})
        dirs.append(arts.run_dir)
    names = [sorted(str(p.relative_to(d)) for p in d.rglob("*")) for d in dirs]
    assert names[0] == names[1]
    for name in names[0]:
        a, b = dirs[0] / name, dirs[1] / name
        if name.endswith(".json") and name != "run_metadata.json":
            assert json.loads(a.read_text()) == json.loads(b.read_text()), name
        elif name.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert np.array_equal(za[k], zb[k]), k
    diag = dirs[1] / "diagnostics" / "frame_diagnostics.json"
    assert tpers.summarize_frame_diagnostics_streaming(diag) == jpers.summarize_frame_diagnostics_streaming(diag)


def test_telemetry_equals_reference(tmp_path):
    ours = ttel.TelemetryCorrelationRegistry(3, "h", "run")
    ref = jtel.TelemetryCorrelationRegistry(3, "h", "run")
    assert [ours.correlation_id(s) for s in ("a", "b")] == [ref.correlation_id(s) for s in ("a", "b")]
    rec = ttel.RunTelemetryRecorder(run_id="run", clock=lambda: 1.0)
    for i in range(20):
        rec.record(["track", "keyframe"][i % 2], 0.01 * (i + 1), metadata={"i": i})
    with ttel.device_span(rec, "device_stage", torch.device("cpu")):
        t(np.ones(3)) + t(np.zeros(3))
    assert len(rec.events()) == 20 and not any(e.name.endswith(".device") for e in rec.events())
    path = rec.flush_to_json(tmp_path / "events.json")
    assert tti.summarize_telemetry_streaming(path) == jti.summarize_telemetry_streaming(path)


def test_keyframe_decisions_equal_reference():
    """The same pose stream makes the same keyframes in both managers."""
    rng = np.random.default_rng(2)
    cfg = dict(min_translation=0.3, min_rotation_deg=4.0, max_match_ratio=0.3, window_size=3, max_keyframes=6)
    windows = {"port": [], "ref": []}
    ours = tkf.KeyframeManager(tkf.KeyframeConfig(**cfg), on_window=lambda w: windows["port"].append([k.frame_id for k in w]))
    ref = jkf.KeyframeManager(jkf.KeyframeConfig(**cfg), on_window=lambda w: windows["ref"].append([k.frame_id for k in w]))
    pose = np.eye(4)
    desc_i32 = rng.integers(-(2**31), 2**31, size=(16, 8), dtype=np.int64).astype(np.int32)
    for i in range(40):
        angle = np.radians(rng.uniform(0, 3))
        c, s = np.cos(angle), np.sin(angle)
        step = np.eye(4)
        step[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        step[:3, 3] = rng.normal(0, 0.15, 3)
        pose = pose @ step
        ratio = float(rng.uniform(0.1, 0.9))
        xy = rng.uniform(0, 100, (16, 2)).astype(np.float32)
        valid = rng.uniform(size=16) > 0.2
        a = ours.maybe_add(i, 0.1 * i, pose, ratio, xy, desc_i32.view(np.uint32), valid)
        b = ref.maybe_add(i, 0.1 * i, pose, ratio, xy, desc_i32.view(np.uint32), valid)
        assert (a is None) == (b is None)
        assert ours.should_add(pose, ratio) == ref.should_add(pose, ratio)
    assert [k.frame_id for k in ours.keyframes] == [k.frame_id for k in ref.keyframes]
    assert windows["port"] == windows["ref"] and len(windows["ref"]) > 5
    for a, b in zip(ours.keyframes, ref.keyframes):
        assert a.descriptors.dtype == np.uint32 and np.array_equal(a.descriptors, b.descriptors)
        assert np.array_equal(a.pose, b.pose) and np.array_equal(a.valid, b.valid)


def test_keyframe_config_equals_reference():
    import dataclasses

    assert [(f.name, f.default) for f in dataclasses.fields(tkf.KeyframeConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(jkf.KeyframeConfig)
    ]


@pytest.mark.parametrize(
    "kw",
    [
        dict(num_frames=3, h=120, w=160, seed=0),
        dict(num_frames=2, h=96, w=200, seed=4, planar=True, n_pts=80, noise=2.0),
        dict(num_frames=2, h=100, w=150, seed=1, n_pts=60, traj_fn="yaw"),
    ],
)
def test_render_scene_bit_equal_reference(kw):
    kw = dict(kw)
    if kw.get("traj_fn") == "yaw":
        kw["traj_fn"] = lambda i: (
            np.array([[np.cos(0.05 * i), 0, np.sin(0.05 * i)], [0, 1, 0], [-np.sin(0.05 * i), 0, np.cos(0.05 * i)]]),
            np.array([0.1 * i, 0.0, 0.0]),
        )
    ours, ref = tsyn.render_scene(**kw), jsyn.render_scene(**kw)
    assert len(ours[0]) == len(ref[0]) == kw["num_frames"]
    for a, b in zip(ours[0], ref[0]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(ours[1], ref[1]) and ours[2] == ref[2] and np.array_equal(ours[3], ref[3])


def test_trajectory_metrics_equal_reference():
    rng = np.random.default_rng(3)
    gt = np.cumsum(rng.normal(size=(30, 3)), axis=0)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    est = 0.5 * gt @ R.T + rng.normal(0, 0.05, size=gt.shape) + 2.0
    assert ttraj.compute_ate(est, gt) == jtraj.compute_ate(est, gt)
    assert ttraj.compute_rpe(est, gt, delta=2) == jtraj.compute_rpe(est, gt, delta=2)
    assert ttraj.compute_additional_metrics(est, gt) == jtraj.compute_additional_metrics(est, gt)


def test_frame_stream_equals_reference(tmp_path):
    paths = [tmp_path / f"{i}.png" for i in range(6)]
    frames = {str(p): np.full((4, 5), i, np.uint8) for i, p in enumerate(paths)}
    read = lambda p: None if p.name == "3.png" else frames[str(p)]
    ours = list(tfs.FrameStream(paths, read_fn=read, buffer_size=2))
    ref = list(jfs.FrameStream(paths, read_fn=read, buffer_size=2))
    assert [(p.index, p.timestamp, p.frame.tolist()) for p in ours] == [
        (p.index, p.timestamp, p.frame.tolist()) for p in ref
    ]
    a = tfs.packets_from_arrays(list(frames.values()))
    b = jfs.packets_from_arrays(list(frames.values()))
    assert [(p.index, p.timestamp) for p in a] == [(p.index, p.timestamp) for p in b]
    ring = tfs.BoundedRingBuffer(2)
    assert ring.push(1) and ring.push(2) and not ring.push(3) and ring.dropped == 1 and ring.pop() == 2


def test_frame_stream_needs_a_reader(tmp_path, monkeypatch):
    """The port has its own default decoder now: no reader is no refusal.
    A missing file is a counted read failure. A format the port's decoders
    cannot read goes to cv2 (None where cv2 cannot read it either, as in
    the reference's reader), and without cv2 and Pillow raises with the
    format's name."""
    from mvslam_tpu_torch.data.synthetic import write_png_gray

    img = np.arange(35, dtype=np.uint8).reshape(5, 7)
    write_png_gray(tmp_path / "0.png", img)
    stream = tfs.FrameStream([tmp_path / "0.png", tmp_path / "missing.png"])
    assert stream.read_fn is tfs._default_read_fn
    packets = list(stream)
    assert len(packets) == 1 and np.array_equal(packets[0].frame, img) and stream.stats.read_failures == 1
    (tmp_path / "x.jpg").write_bytes(b"\xff\xd8\xff\xe0 not decoded here")
    assert tfs._default_read_fn(tmp_path / "x.jpg") is None
    for name in ("cv2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ValueError, match="jpg"):
        tfs._default_read_fn(tmp_path / "x.jpg")


def test_host_modules_import_without_jax():
    code = (
        "import sys; import mvslam_tpu_torch.slam.api, mvslam_tpu_torch.eval.trajectory, "
        "mvslam_tpu_torch.data.synthetic, mvslam_tpu_torch.runtime.frame_stream, "
        "mvslam_tpu_torch.backend.bundle_adjustment, mvslam_tpu_torch.backend.pose_graph, "
        "mvslam_tpu_torch.backend.optimization_control, mvslam_tpu_torch.geometry.lie_np, "
        "mvslam_tpu_torch.geometry.alignment, mvslam_tpu_torch.loopclosure, mvslam_tpu_torch.loopclosure.validation, "
        "mvslam_tpu_torch.slam.offline, mvslam_tpu_torch.slam.runner, mvslam_tpu_torch.slam.relocalization_demo, "
        "mvslam_tpu_torch.data.kitti, mvslam_tpu_torch.data.tum, mvslam_tpu_torch.data.validation, "
        "mvslam_tpu_torch.data.camera_rig, mvslam_tpu_torch.eval.relocalization_metrics; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'mvslam_tpu.'))]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _reference_bench():
    spec = importlib.util.spec_from_file_location("bench", REPO / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("num_frames,seed", [(1, 0), (5, 0), (3, 7)])
def test_bench_frames_equal_reference(num_frames, seed):
    """The port's copy of ``bench.make_frames`` gives the same frames bit
    for bit."""
    bench = _reference_bench()
    assert (tbf.H, tbf.W) == (bench.H, bench.W)
    ours, ref = tbf.make_frames(num_frames, seed=seed), bench.make_frames(num_frames, seed=seed)
    assert len(ours) == len(ref) == num_frames
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and a.shape == (370, 1226) and np.array_equal(a, b)


def test_chip_smoke_imports_nothing_of_the_reference():
    """Every import in ``chip_smoke.py``, nested ones included, is of the
    port or of third-party packages: no jax, no ``mvslam_tpu``, no
    ``bench`` (the machine with the card has none of them)."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    assert "mvslam_tpu_torch.data.bench_frames" in names
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "mvslam_tpu", "bench", "PIL", "cv2")], names


def _imports(path):
    """(module-level imports, every import) of a source file, by name."""
    tree = ast.parse(path.read_text())

    def names(nodes):
        out = set()
        for node in nodes:
            if isinstance(node, ast.Import):
                out.update(alias.name for alias in node.names)
            elif isinstance(node, ast.ImportFrom):
                out.add(node.module or "")
        return out

    return names(tree.body), names(ast.walk(tree))


def test_no_module_of_the_port_imports_the_reference_or_an_image_library():
    """Every source file of the port: no import of jax, ``mvslam_tpu`` or
    ``bench`` anywhere, and none of ``PIL`` or ``cv2`` at module level
    (the machine with the card is promised neither: the port decodes PNG
    and PGM itself). ``cv2`` stays a lazy import where the reference has
    one too (video input, seeding its RNG, the demo's synthetic clip, the
    default reader's fallback for other formats); ``PIL`` appears only in
    that fallback, after cv2, as in the reference's reader."""
    files = sorted((REPO / "mvslam_tpu_torch").rglob("*.py"))
    assert len(files) > 60
    lazy_cv2 = set()
    for path in files:
        top, every = _imports(path)
        rel = str(path.relative_to(REPO))
        assert not [n for n in every if n.split(".")[0] in ("jax", "jaxlib", "mvslam_tpu", "bench")], rel
        assert not [n for n in top if n.split(".")[0] in ("cv2", "PIL")], rel
        if rel != "mvslam_tpu_torch/runtime/frame_stream.py":
            assert not [n for n in every if n.split(".")[0] == "PIL"], rel
        if any(n.split(".")[0] == "cv2" for n in every):
            lazy_cv2.add(rel)
    assert lazy_cv2 == {
        "mvslam_tpu_torch/core/determinism.py", "mvslam_tpu_torch/slam/offline.py",
        "mvslam_tpu_torch/data/demo_utils.py",  # the synthetic clip's video writer, as in the reference
        "mvslam_tpu_torch/runtime/frame_stream.py",  # the default reader's fallback, as in the reference
    }
