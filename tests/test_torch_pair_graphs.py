"""The tracking step's captured stage graphs (``slam/pair_graphs.py``) on the
CPU: the cache key, the cache's bookkeeping and spans with the capture and
replay stubbed out, the packed outputs' round trip, the eager stages taken
on the CPU, and the constants made capturable equal to their old
construction. The graphs themselves run only on the card
(``tests/test_torch_cuda.py``)."""

import json
import threading

import numpy as np
import pytest
import torch

from mvslam_tpu_torch.core import prng
from mvslam_tpu_torch.core.graphs import _flatten, _pack, _unflatten, signature
from mvslam_tpu_torch.core.telemetry import RunTelemetryRecorder
from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig, FeatureSet
from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
from mvslam_tpu_torch.geometry import epipolar
from mvslam_tpu_torch.ops import hamming, ransac
from mvslam_tpu_torch.ops.hamming import MatchConfig
from mvslam_tpu_torch.slam import tracking
from mvslam_tpu_torch.slam.pair_graphs import PairGraphs


def _features(batch, n, device="cpu", xy_dtype=torch.float32):
    return FeatureSet(
        xy=torch.zeros((batch, n, 2), dtype=xy_dtype, device=device),
        scores=None,
        descriptors=torch.zeros((batch, n, 8), dtype=torch.int32, device=device),
        angles=None,
        valid=torch.zeros((batch, n), dtype=torch.bool, device=device),
    )


def _inputs(batch=4, n1=64, n2=64, device="cpu", xy_dtype=torch.float32):
    keys = torch.zeros((batch, 2), dtype=torch.int64, device=device)
    K = torch.eye(3, device=device)
    return keys, _features(batch, n1, device, xy_dtype), _features(batch, n2, device), K


def _signature(inputs, match_args=(MatchConfig(), 512), pose=RobustPoseEstimatorConfig()):
    keys, f1, f2, K = inputs
    return signature((keys, f1.xy, f1.descriptors, f1.valid, f2.xy, f2.descriptors, f2.valid, K), match_args, pose)


@pytest.mark.parametrize(
    "variant",
    ["batch", "source_features", "target_features", "xy_dtype", "device", "match_config", "max_matches", "pose_config"],
)
def test_signature_tells_apart_what_the_graphs_depend_on(variant):
    base = _signature(_inputs())
    changed = {
        "batch": lambda: _signature(_inputs(batch=3)),
        "source_features": lambda: _signature(_inputs(n1=32)),
        "target_features": lambda: _signature(_inputs(n2=32)),
        "xy_dtype": lambda: _signature(_inputs(xy_dtype=torch.float64)),
        "device": lambda: _signature(_inputs(device="meta")),
        "match_config": lambda: _signature(_inputs(), match_args=(MatchConfig(cross_check=False), 512)),
        "max_matches": lambda: _signature(_inputs(), match_args=(MatchConfig(), 256)),
        "pose_config": lambda: _signature(_inputs(), pose=RobustPoseEstimatorConfig(num_hypotheses=256)),
    }[variant]()
    assert changed != base


def test_equal_configs_and_shapes_give_one_signature():
    a = _signature(_inputs(), (MatchConfig(ratio=0.8), 512), RobustPoseEstimatorConfig(num_hypotheses=512))
    b = _signature(_inputs(), (MatchConfig(), 512), RobustPoseEstimatorConfig())
    assert a == b and hash(a) == hash(b)
    assert len({a: 0, b: 1}) == 1


class _StubGraphs(PairGraphs):
    """The cache with the capture and the replay stubbed: what it records
    and keeps, without a card."""

    def __init__(self):
        super().__init__(None, None)
        self.captures = 0

    def _capture(self, inputs, match_args, pose_config):
        self.captures += 1
        return ("entry", self.captures)

    def _replay(self, entry, inputs, recorder):
        return entry


def _call(graphs, batch, recorder=None):
    keys, f1, f2, K = _inputs(batch=batch)
    return graphs.track(keys, f1, f2, K, (MatchConfig(), 512), RobustPoseEstimatorConfig(), recorder)


def test_cache_keeps_the_newest_entries_per_device_and_records_its_spans():
    graphs = _StubGraphs()
    assert graphs.ENTRIES_PER_DEVICE == 4
    recorder = RunTelemetryRecorder()
    for batch in (1, 2, 3, 4):
        assert _call(graphs, batch, recorder) == ("entry", batch)
    assert _call(graphs, 1, recorder) == ("entry", 1)  # replayed: now the newest
    assert _call(graphs, 5, recorder) == ("entry", 5)  # evicts batch 2, the least recently used
    assert [s[0][1][0] for s in graphs.entries("cpu")] == [3, 4, 1, 5]
    assert _call(graphs, 2, recorder) == ("entry", 6)  # captured again
    assert graphs.captures == 6

    events = recorder.events()
    captures = [e for e in events if e.name == "pair_graph_capture"]
    replays = [e for e in events if e.name == "pair_graph_replay"]
    assert len(captures) == 6 and len(replays) == 7
    meta = json.loads(json.dumps(captures[0].metadata))
    assert meta["device"] == "cpu"
    assert meta["inputs"][0] == [[1, 2], "int64"] and meta["inputs"][1] == [[1, 64, 2], "float32"]
    assert meta["configs"][0][1] == 512 and meta["configs"][1]["num_hypotheses"] == 512


def test_captures_closed_replays_known_signatures_and_captures_none_on_its_thread():
    graphs = _StubGraphs()
    recorder = RunTelemetryRecorder()
    _call(graphs, 1)
    with graphs.captures_closed():
        assert _call(graphs, 1, recorder) == ("entry", 1)
        assert _call(graphs, 2, recorder) is None  # the caller runs the eager stages
        other = []
        thread = threading.Thread(target=lambda: other.append(_call(graphs, 5)))
        thread.start()
        thread.join(timeout=30)
        assert not thread.is_alive() and other == [("entry", 2)]  # closed on this thread only
    assert _call(graphs, 2) == ("entry", 3)
    names = [e.name for e in recorder.events()]
    assert names == ["pair_graph_replay"]


def _small_pairs(batch):
    from mvslam_tpu_torch.data.bench_frames import make_frames

    fc = FeaturePipelineConfig(num_features=128, max_matches=64)
    frames = torch.from_numpy(np.stack([f.astype(np.uint8)[:120, :240] for f in make_frames(batch + 1)]))
    feats = tracking._detect_describe(frames, fc)
    f1 = FeatureSet(*(a[:-1] for a in feats))
    f2 = FeatureSet(*(a[1:] for a in feats))
    keys = prng.fold_in(prng.key(7), torch.arange(1, batch + 1))
    K = torch.tensor([[300.0, 0.0, 120.0], [0.0, 300.0, 60.0], [0.0, 0.0, 1.0]])
    return keys, f1, f2, K, fc, RobustPoseEstimatorConfig(num_hypotheses=64)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("batch", [1, 3])
def test_packed_outputs_round_trip_bit_for_bit(batch):
    keys, f1, f2, K, fc, pc = _small_pairs(batch)
    track = tracking._track_pairs(keys, f1, f2, K, fc, pc)
    packed, layout = _pack(track)
    assert packed.dtype == torch.uint8
    assert packed.numel() == sum(x.numel() * x.element_size() for x in _flatten(track))
    out = packed.clone()
    back = _unflatten(track, (out[a:b].view(dtype).view(shape) for a, b, dtype, shape in layout))
    assert type(back) is type(track) and type(back.pose) is type(track.pose)
    for x, y in zip(_flatten(back), _flatten(track)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(_bits(x), _bits(y))


def test_track_pairs_on_the_cpu_runs_the_eager_stages(monkeypatch):
    keys, f1, f2, K, fc, pc = _small_pairs(2)

    def refuse(*args):
        raise AssertionError("the graphs are for CUDA devices")

    monkeypatch.setattr(tracking.PAIR_GRAPHS, "track", refuse)
    recorder = RunTelemetryRecorder()
    track = tracking._track_pairs(keys, f1, f2, K, fc, pc, recorder)
    match_args = (tracking._configs(fc)[2], fc.max_matches)
    eager = tracking._pose_stage(keys, f2, K, tracking._match_stage(f1, f2, *match_args), pc)
    for x, y in zip(_flatten(track), _flatten(eager)):
        assert torch.equal(_bits(x), _bits(y))
    assert not [e for e in recorder.events() if e.name.startswith("pair_graph")]


class _OldConstruction:
    """``torch`` as a module saw it before the constants became fills: a
    0-dim ``torch.full`` built by ``torch.tensor``, a host-to-device copy on
    a card."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def full(size, fill_value, *, dtype=None, device=None):
        if tuple(size) == ():
            return torch.tensor(fill_value, dtype=dtype, device=device)
        return torch.full(size, fill_value, dtype=dtype, device=device)


def _old_sign_pairs(dtype, device):
    return torch.tensor([[1.0, 1.0], [1.0, -1.0], [-1.0, 1.0], [-1.0, -1.0]], dtype=dtype, device=device)


def _descriptors(seed, n):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(2, n, 8), dtype=np.uint64).astype(np.uint32).view(np.int32)
    return torch.from_numpy(words), torch.from_numpy(rng.random((2, n)) > 0.2)


def _hamming_match():
    d1, v1 = _descriptors(1, 48)
    d2, v2 = _descriptors(2, 40)
    return hamming.match_descriptors(d1, v1, d2, v2, MatchConfig(use_ratio_test=True))


def _hamming_select():
    d1, v1 = _descriptors(3, 48)
    d2, v2 = _descriptors(4, 40)
    return hamming.select_matches(hamming.match_descriptors(d1, v1, d2, v2), max_matches=64)


def _uniform():
    keys = prng.fold_in(prng.key(11), torch.arange(3))
    tiny = float(torch.finfo(torch.float32).tiny)
    return tuple(
        prng.uniform(keys, (17, 5), minval=lo, maxval=hi)
        for lo, hi in ((0.0, 1.0), (1e-12, 1.0), (tiny, 1.0), (-2.5, 3.7))
    )


def _homography():
    rng = np.random.default_rng(5)
    H = torch.from_numpy(np.eye(3) + 0.05 * rng.standard_normal((4, 3, 3))).to(torch.float32)
    p1 = torch.from_numpy(rng.uniform(-0.5, 0.5, (4, 30, 2))).to(torch.float32)
    p2 = p1 + 0.01
    return epipolar.decompose_homography(H, p1, p2)


def _threshold():
    rng = np.random.default_rng(6)
    like = torch.from_numpy(rng.uniform(-1, 1, (2, 40, 2))).to(torch.float32)
    key = prng.fold_in(prng.key(2), torch.arange(2))
    mask = torch.ones((2, 40), dtype=torch.bool)
    res = ransac.ransac_homography(key, like, like * 1.01 + 0.002, mask, ransac.RansacConfig(num_hypotheses=32, threshold=0.05))
    return (ransac._as_threshold_sq(1.5, like), ransac._as_threshold_sq(2e-3, like)) + tuple(res)


@pytest.mark.parametrize(
    "case,module,attribute,old,run",
    [
        ("hamming_match_big", hamming, "torch", _OldConstruction(), _hamming_match),
        ("hamming_select_big", hamming, "torch", _OldConstruction(), _hamming_select),
        ("prng_uniform_bounds", prng, "torch", _OldConstruction(), _uniform),
        ("homography_signs", epipolar, "_sign_pairs", _old_sign_pairs, _homography),
        ("ransac_threshold", ransac, "torch", _OldConstruction(), _threshold),
    ],
)
def test_capturable_constants_equal_their_old_construction(monkeypatch, case, module, attribute, old, run):
    """Each constant of the stages that was a ``torch.tensor`` (a pageable
    host-to-device copy, which a CUDA graph cannot capture) is now a fill
    of the same dtype and value: the functions that use it give the same
    bits either way."""
    new = _flatten(run())
    monkeypatch.setattr(module, attribute, old)
    before = _flatten(run())
    assert len(new) == len(before)
    for x, y in zip(new, before):
        assert x.dtype == y.dtype and x.shape == y.shape, case
        assert torch.equal(_bits(x), _bits(y)), case
