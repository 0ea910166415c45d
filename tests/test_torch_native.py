"""The port's C++ host library (``mvslam_tpu_torch/native``) against the JAX
package's (``mvslam_tpu/native``, which decodes PNG with libpng) and
against the port's own numpy decoder and torch matcher.

Decode is held bit for bit on PNG files written here from the
specification at every colour type, bit depth, filter type and with Adam7
interlacing, and on PGM; the loader on ordering, failures and shutdown;
the matcher bit for bit; the build key on the host's CPU identity; and the
host matching paths (the window-BA pair gate, loop geometry, the
relocalizer) against the port's device path on the CPU.
"""

import struct
import sys
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from torch_parity import desc_u32, random_descriptors, to_np

from mvslam_tpu import native as jnative
from mvslam_tpu.runtime import frame_stream as jfs
from mvslam_tpu_torch import native
from mvslam_tpu_torch.native import build as nbuild
from mvslam_tpu_torch.ops import hamming as thamming
from mvslam_tpu_torch.runtime import frame_stream as tfs


@pytest.fixture(scope="module", autouse=True)
def _libraries():
    assert native.native_available(), "the port's native library did not build"
    assert jnative.native_available(), "the reference's native library did not build"


# ----------------------------------------------------------------------
# A PNG encoder from the specification
# ----------------------------------------------------------------------

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _pack_rows(samples, depth):
    """(h, w, C) samples → (h, rowbytes) uint8 as PNG stores them."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.uint32)
    if depth == 16:
        return np.stack([flat >> 8, flat & 255], -1).reshape(h, -1).astype(np.uint8)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = (flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1  # MSB first
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


def _filter_rows(raw, bpp, filter_type):
    """Filter every scanline (``"mixed"``: the five types in turn). Filters
    read raw bytes only, so the whole image is filtered at once."""
    x = raw.astype(np.int32)
    up = np.vstack([np.zeros((1, x.shape[1]), np.int32), x[:-1]])
    left = np.hstack([np.zeros((x.shape[0], bpp), np.int32), x[:, :-bpp]])
    upleft = np.hstack([np.zeros((x.shape[0], bpp), np.int32), up[:, :-bpp]])
    preds = [np.zeros_like(x), left, up, (left + up) >> 1, _paeth(left, up, upleft)]
    types = np.array([y % 5 if filter_type == "mixed" else filter_type for y in range(x.shape[0])])
    pred = np.choose(types[:, None], preds)
    out = ((x - pred) % 256).astype(np.uint8)
    return np.hstack([types[:, None].astype(np.uint8), out])


def encode_png(samples, color, depth, filter_type=0, interlace=False, palette=None, trns=None):
    """PNG bytes of (H, W, C) integer samples (palette indices for colour
    type 3), the IDAT stream split over two chunks."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, c = samples.shape
    assert c == CHANNELS[color]
    bpp = max(1, c * depth // 8)
    passes = ADAM7 if interlace else [(0, 0, 1, 1)]
    raw = bytearray()
    for xs, ys, dx, dy in passes:
        sub = samples[ys::dy, xs::dx]
        if sub.size:
            raw += _filter_rows(_pack_rows(sub, depth), bpp, filter_type).tobytes()

    def chunk(ctype, body):
        return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))

    comp = zlib.compress(bytes(raw))
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    out += chunk(b"tEXt", b"Comment\x00ancillary chunks are skipped")
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    half = len(comp) // 2
    return out + chunk(b"IDAT", comp[:half]) + chunk(b"IDAT", comp[half:]) + chunk(b"IEND", b"")


def _samples(color, depth, h=19, w=37, seed=0):
    rng = np.random.default_rng(seed + 100 * color + depth)
    c = CHANNELS[color]
    top = (1 << depth) - 1 if color != 3 else min(255, (1 << depth) - 1)
    noise = rng.integers(0, top + 1, size=(h, w, c))
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = ((yy * 5 + xx * 3)[..., None] * max(1, top // 64) + 40 * np.arange(c)) % (top + 1)
    return np.where(rng.uniform(size=(h, w, 1)) < 0.5, smooth, noise)


def _decode_all(tmp_path, data, name="x.png"):
    path = tmp_path / name
    path.write_bytes(data)
    return native.decode_gray(path), jnative.decode_gray(path)


FILTERS = [0, 1, 2, 3, 4, "mixed"]


@pytest.mark.parametrize("color,depth", [
    (0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (4, 8), (4, 16), (2, 8), (2, 16), (6, 8), (6, 16),
])
def test_decode_equals_libpng_at_every_depth_filter_and_interlace(color, depth, tmp_path):
    """Bit-equal to the reference's libpng decoder; 8-bit grey, RGB and RGBA
    non-interlaced also bit-equal to the port's numpy decoder."""
    img = _samples(color, depth)
    for interlace in (False, True):
        for ft in FILTERS:
            data = encode_png(img, color, depth, ft, interlace)
            ours, ref = _decode_all(tmp_path, data)
            assert ref is not None and ref.shape == img.shape[:2]
            assert ours is not None and ours.dtype == np.uint8
            np.testing.assert_array_equal(ours, ref, err_msg=f"filter {ft} interlace {interlace}")
            if depth == 8 and color != 4 and not interlace:
                np.testing.assert_array_equal(tfs.decode_png(data), ref)


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
@pytest.mark.parametrize("trns", [False, True])
def test_palette_decode_equals_libpng(depth, trns, tmp_path):
    """Palette images, with and without a tRNS chunk (its alpha is dropped),
    and an index past a short palette (black in libpng)."""
    rng = np.random.default_rng(depth)
    entries = 1 << depth
    palette = rng.integers(0, 256, size=(max(1, entries - 1), 3))  # one short
    palette[0] = (90, 90, 90)  # a grey entry passes unchanged
    idx = _samples(3, depth, seed=3) % entries
    alpha = rng.integers(0, 256, size=len(palette)).astype(np.uint8).tobytes() if trns else None
    for interlace in (False, True):
        for ft in (0, 4, "mixed"):
            ours, ref = _decode_all(tmp_path, encode_png(idx, 3, depth, ft, interlace, palette=palette, trns=alpha))
            assert ref is not None
            np.testing.assert_array_equal(ours, ref)


def test_grey_trns_and_tiny_interlaced_images(tmp_path):
    """A grey tRNS chunk, and interlaced images so small that some Adam7
    passes are empty."""
    img = _samples(0, 8)
    ours, ref = _decode_all(tmp_path, encode_png(img, 0, 8, 1, trns=struct.pack(">H", 7)))
    np.testing.assert_array_equal(ours, ref)
    for h, w in [(1, 1), (1, 5), (3, 2), (5, 1), (2, 9)]:
        for color, depth in [(0, 1), (0, 8), (2, 16)]:
            img = _samples(color, depth, h=h, w=w)
            ours, ref = _decode_all(tmp_path, encode_png(img, color, depth, "mixed", True))
            assert ref is not None and ref.shape == (h, w)
            np.testing.assert_array_equal(ours, ref)


def test_rgb_decode_equals_libpng_on_every_triple(tmp_path):
    """All 2^24 RGB triples: the native decoder, the reference's libpng
    decoder and the port's numpy decoder agree on every one."""
    v = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)
    raw = np.concatenate([np.zeros((4096, 1), np.uint8), rgb.reshape(4096, -1)], 1).tobytes()

    def chunk(ctype, body):
        return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))

    data = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 4096, 4096, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))
    path = tmp_path / "all.png"
    path.write_bytes(data)
    ours = native.decode_gray(path, 4096, 4096)
    ref = jnative.decode_gray(path, 4096, 4096)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(tfs.decode_png(data), ref)


@pytest.mark.parametrize("maxval", [255, 100, 65535, 1000])
def test_pgm_decode_equals_reference(maxval, tmp_path):
    rng = np.random.default_rng(maxval)
    img = rng.integers(0, maxval + 1, size=(33, 47))
    body = img.astype(">u2").tobytes() if maxval > 255 else img.astype(np.uint8).tobytes()
    path = tmp_path / "x.pgm"
    path.write_bytes(b"P5\n# a comment\n47 33\n%d\n" % maxval + body)
    ours, ref = native.decode_gray(path), jnative.decode_gray(path)
    assert ref is not None
    np.testing.assert_array_equal(ours, ref)
    if maxval == 255:
        np.testing.assert_array_equal(ours, img)
        np.testing.assert_array_equal(ours, tfs._default_read_fn(path))


def test_missing_corrupt_and_oversized_files_fail_alike(tmp_path):
    """Each case returns None in both packages: a missing file, a PNG
    signature over garbage, a text file, a truncated PNG, a broken IDAT
    CRC, an image past the capacity guard."""
    good = encode_png(_samples(0, 8), 0, 8, 1)
    cases = {
        "missing.png": None,
        "garbage.png": b"\x89PNG\r\n\x1a\n" + b"garbage" * 10,
        "text.txt": b"hello world",
        "truncated.png": good[: len(good) // 2],
        "no_iend.png": good[:-12],
        "bad_crc.png": good[:-20] + bytes([good[-20] ^ 1]) + good[-19:],
        "short.pgm": b"P5\n4 4\n255\n" + b"\x00" * 7,
    }
    for name, data in cases.items():
        path = tmp_path / name
        if data is not None:
            path.write_bytes(data)
        assert jnative.decode_gray(path) is None, name
        assert native.decode_gray(path) is None, name
    path = tmp_path / "big.png"
    path.write_bytes(good)
    assert jnative.decode_gray(path, max_h=8, max_w=8) is None
    assert native.decode_gray(path, max_h=8, max_w=8) is None
    assert native.decode_gray(path, max_h=19, max_w=37).shape == (19, 37)


def test_default_read_fn_takes_the_native_path(tmp_path, monkeypatch):
    """A 16-bit PNG only the native decoder reads: decoded by default;
    under ``MVSLAM_NATIVE_DECODE=0`` the numpy decoder does not read it, so
    it goes to cv2 as in the reference's reader, and with cv2 and Pillow
    blocked it is refused by name. A PPM, which the native decoder does
    not read, goes to cv2 (the reference's frame), and to numpy only with
    both blocked."""
    img = _samples(0, 16)
    path = tmp_path / "deep.png"
    path.write_bytes(encode_png(img, 0, 16, 4))
    np.testing.assert_array_equal(tfs._default_read_fn(path), (img[..., 0] >> 8).astype(np.uint8))
    ppm = tmp_path / "c.ppm"
    rgb = _samples(2, 8).astype(np.uint8)
    ppm.write_bytes(b"P6\n37 19\n255\n" + rgb.tobytes())
    np.testing.assert_array_equal(tfs._default_read_fn(ppm), jfs._default_read_fn(ppm))
    assert tfs._default_read_fn(tmp_path / "missing.png") is None
    monkeypatch.setenv("MVSLAM_NATIVE_DECODE", "0")
    np.testing.assert_array_equal(tfs._default_read_fn(path), jfs._default_read_fn(path))
    for name in ("cv2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ValueError, match="16-bit"):
        tfs._default_read_fn(path)
    np.testing.assert_array_equal(tfs._default_read_fn(ppm), tfs._luma_bt601(rgb))
    grey = tmp_path / "g.png"
    grey.write_bytes(encode_png(_samples(0, 8), 0, 8, 3))
    np.testing.assert_array_equal(tfs._default_read_fn(grey), _samples(0, 8)[..., 0])


def test_stream_and_pipeline_load_the_decoder_when_they_start(tmp_path, monkeypatch):
    """The default reader's library is built or loaded when a stream or an
    ingestion pipeline is made, not in its first read; an injected reader
    needs none."""
    from mvslam_tpu_torch.runtime import ingestion as tingestion

    calls = []
    monkeypatch.setattr(tfs, "_native_decoder", lambda: calls.append(1))
    monkeypatch.setattr(tingestion, "_native_decoder", lambda: calls.append(1))
    paths = [tmp_path / "a.png"]
    tfs.FrameStream(paths)
    tingestion.AsyncIngestionPipeline(paths)
    assert len(calls) == 2
    tfs.FrameStream(paths, read_fn=lambda p: None)
    tingestion.AsyncIngestionPipeline(paths, read_fn=lambda p: None)
    assert len(calls) == 2


# ----------------------------------------------------------------------
# The frame loader
# ----------------------------------------------------------------------

def _frames(tmp_path, n, h=24, w=32):
    rng = np.random.default_rng(6)
    frames, paths = [], []
    for i in range(n):
        img = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
        path = tmp_path / f"f{i:04d}.png"
        path.write_bytes(encode_png(img, 0, 8, i % 5))
        frames.append(img)
        paths.append(path)
    return frames, paths


def test_loader_delivers_in_order_with_many_workers(tmp_path):
    frames, paths = _frames(tmp_path, 64)
    with native.NativeFrameLoader(paths, workers=4, capacity=4) as loader:
        items = list(loader)
        stats = loader.stats()
    assert [it.index for it in items] == list(range(64))
    for it, ref in zip(items, frames):
        assert it.status == "ok"
        np.testing.assert_array_equal(it.frame, ref)
    assert stats.decoded == 64 and stats.failed == 0
    with pytest.raises(RuntimeError, match="closed"):
        loader.stats()


def test_loader_reports_failures_in_sequence_as_the_reference(tmp_path):
    _, paths = _frames(tmp_path, 10)
    paths[3] = tmp_path / "missing.png"
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\nnot a png")
    paths[7] = bad
    paths[8] = tmp_path / "notes.txt"
    paths[8].write_bytes(b"not an image")

    def run(mod):
        with mod.NativeFrameLoader(paths, workers=3, capacity=2) as loader:
            items = [(it.index, it.status, None if it.frame is None else it.frame.tolist()) for it in loader]
            stats = loader.stats()
        return items, (stats.decoded, stats.failed)

    ours, ref = run(native), run(jnative)
    assert ours == ref
    statuses = [s for _, s, _ in ours[0]]
    assert statuses[3] == "open_failed" and statuses[7] == "corrupt" and statuses[8] == "unknown_format"
    assert ours[1] == (7, 3)


def test_loader_empty_single_early_close_and_repeat(tmp_path):
    with native.NativeFrameLoader([], workers=2, capacity=2) as loader:
        assert list(loader) == []
    frames, paths = _frames(tmp_path, 32)
    with native.NativeFrameLoader(paths[:1], workers=4, capacity=8) as loader:
        items = list(loader)
    assert len(items) == 1
    np.testing.assert_array_equal(items[0].frame, frames[0])
    loader = native.NativeFrameLoader(paths, workers=4, capacity=2)
    it = iter(loader)
    next(it)
    next(it)
    loader.close()  # workers blocked on backpressure exit
    assert list(it) == []

    def run():
        with native.NativeFrameLoader(paths, workers=4, capacity=3) as loader:
            return [(it.index, int(it.frame.sum())) for it in loader]

    assert run() == run()
    with pytest.raises(ValueError):
        native.NativeFrameLoader(paths, workers=0)


# ----------------------------------------------------------------------
# The matcher
# ----------------------------------------------------------------------

@pytest.mark.parametrize("na,nb", [(0, 5), (1, 1), (513, 200), (2048, 2048)])
def test_hamming_match_equals_reference_and_torch_matcher(na, nb):
    rng = np.random.default_rng(na + nb)
    da = random_descriptors(na, seed=na + 1) if na else np.zeros((0, 8), np.uint32)
    db = random_descriptors(nb, seed=nb + 2)
    if na and nb:  # near-duplicates, so that real minima and ties occur
        k = min(na, nb) // 2
        db[:k] = da[:k] ^ (rng.integers(0, 2, size=(k, 8)) << rng.integers(0, 32, size=(k, 8))).astype(np.uint32)
        db[k // 2] = db[0]  # a duplicated column: second == best
    va = rng.uniform(size=na) > 0.1
    vb = rng.uniform(size=nb) > 0.1
    ours, ref = native.hamming_match(da, va, db, vb), jnative.hamming_match(da, va, db, vb)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if na == 0:
        return
    words = lambda d: torch.from_numpy(np.ascontiguousarray(d).view(np.int32))
    dev = thamming.match_descriptors(words(da), torch.from_numpy(va), words(db), torch.from_numpy(vb),
                                     thamming.MatchConfig(cross_check=True))
    best_idx, best, second, col_best = ours
    np.testing.assert_array_equal(best_idx, to_np(dev.indices))
    np.testing.assert_array_equal(best, to_np(dev.distances))
    np.testing.assert_array_equal(second, to_np(dev.second_distances))
    host = thamming.match_descriptors_host(da, va, db, vb, thamming.MatchConfig(cross_check=True))
    for a, b in zip(host, dev):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(to_np(a), to_np(b))
    with pytest.raises(ValueError, match="uint32 descriptors"):
        native.hamming_match(da[:, :4], va, db, vb)


# ----------------------------------------------------------------------
# The build
# ----------------------------------------------------------------------

def test_build_key_follows_the_cpu_and_the_flags(monkeypatch):
    """The ``-march=native`` binary's key folds in the CPU's identity, the
    generic fallback's does not, and the two never share a file."""
    native_key = nbuild.build_key(nbuild.NATIVE_ARCH)
    generic_key = nbuild.build_key(nbuild.GENERIC_ARCH)
    assert native_key != generic_key
    assert nbuild.build_key(nbuild.NATIVE_ARCH) == native_key  # stable
    here = nbuild.library_path(nbuild.NATIVE_ARCH)
    assert nbuild.build() == here and here.exists() and here.name.startswith("libmvslam_native_")
    monkeypatch.setattr(nbuild, "cpu_identity", lambda: "x86_64:another-cpu")
    assert nbuild.build_key(nbuild.NATIVE_ARCH) != native_key
    assert nbuild.library_path(nbuild.NATIVE_ARCH) != here  # another CPU never loads this binary
    assert nbuild.build_key(nbuild.GENERIC_ARCH) == generic_key  # a generic binary runs anywhere


# ----------------------------------------------------------------------
# The host matching paths against the device path, on the CPU
# ----------------------------------------------------------------------

def test_matcher_for_takes_the_cpp_matcher_on_the_cpu_only(monkeypatch):
    assert thamming.matcher_for("cpu") is thamming.match_descriptors_host
    assert thamming.matcher_for(torch.device("cuda")) is thamming.match_descriptors
    assert thamming.matcher_for("meta") is thamming.match_descriptors
    monkeypatch.setattr(native, "native_available", lambda: False)  # no compiler on this host
    assert thamming.matcher_for("cpu") is thamming.match_descriptors


def _spy_host_matcher(monkeypatch):
    """Counts the C++ matcher's calls made through ``matcher_for``."""
    calls = []
    real = thamming.match_descriptors_host
    monkeypatch.setattr(thamming, "match_descriptors_host", lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def _two_view_keyframes(n=160, seed=0):
    from mvslam_tpu_torch.backend.keyframes import Keyframe

    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(8, 16, n)], axis=1)
    desc = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    kfs = []
    for k, x in enumerate((0.0, 0.6, 0.2)):
        T = np.eye(4)
        T[0, 3] = x
        cam = pts - T[:3, 3]
        uv = (cam[:, :2] / cam[:, 2:]) * 400 + [160, 120] + rng.normal(scale=0.3, size=(n, 2))
        d = desc.copy()
        d[rng.uniform(size=n) < 0.15] ^= np.uint32(1 << 7)  # a few flipped bits
        valid = rng.uniform(size=n) > 0.05
        kfs.append(Keyframe(frame_id=3 * k + 1, timestamp=0.1 * k, pose=T, keypoints=uv.astype(np.float32),
                            descriptors=d, valid=valid))
    K = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]])
    return kfs, K


def test_pair_gate_on_the_cpu_equals_the_torch_matcher_path(monkeypatch):
    from mvslam_tpu_torch.backend import bundle_adjustment as tba
    from mvslam_tpu_torch.core import prng

    kfs, K = _two_view_keyframes()
    a, b = kfs[0], kfs[1]
    put = lambda arr, dtype=None: torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype)
    args = (
        prng.key(0), a.frame_id, b.frame_id,
        put(a.descriptors.view(np.int32)), put(a.valid), put(a.keypoints, torch.float32),
        put(b.descriptors.view(np.int32)), put(b.valid), put(b.keypoints, torch.float32),
        put(K, torch.float32), 2.0 / 400.0,
    )
    calls = _spy_host_matcher(monkeypatch)
    host = tba._gated_pair_packed(*args)
    assert calls, "the C++ matcher was not taken"
    monkeypatch.setattr(native, "native_available", lambda: False)  # the torch matcher
    dev = tba._gated_pair_packed(*args)
    assert len(calls) == 1 and torch.equal(host, dev)
    assert (to_np(dev)[2 * tba._PAIR_GATE_M:] > 0.5).sum() >= 100


def test_loop_geometry_on_the_cpu_equals_the_torch_matcher_path(monkeypatch):
    from mvslam_tpu_torch.core.determinism import DeterminismRegistry
    from mvslam_tpu_torch.slam import offline as toffline

    kfs, K = _two_view_keyframes(seed=1)
    system = SimpleNamespace(K=K, registry=DeterminismRegistry(seed=3), device=torch.device("cpu"), telemetry=None)
    calls = _spy_host_matcher(monkeypatch)
    host = toffline._loop_geometry(system, kfs[0], [kfs[1], kfs[2]], [22, 9])
    assert len(calls) == 2, "the C++ matcher was not taken for both pairs"
    monkeypatch.setattr(native, "native_available", lambda: False)  # the torch matcher
    dev = toffline._loop_geometry(system, kfs[0], [kfs[1], kfs[2]], [22, 9])
    assert host.dtype == dev.dtype == np.float32
    np.testing.assert_array_equal(host, dev)
    assert host[0, 1] >= 40  # inliers


def test_relocalizer_on_the_cpu_equals_the_torch_matcher_path(monkeypatch):
    from mvslam_tpu_torch.core import prng
    from mvslam_tpu_torch.loopclosure import persistent_map as tmap
    from mvslam_tpu_torch.loopclosure.map_builder import MapBuilderConfig, MapSnapshotBuilder

    kfs, K = _two_view_keyframes(n=240, seed=2)
    mkf = [tmap.MapKeyframe(frame_id=k.frame_id, pose=k.pose, keypoints=k.keypoints, descriptors=k.descriptors,
                            valid=k.valid) for k in kfs[:2]]
    snap, _ = MapSnapshotBuilder(MapBuilderConfig(vocab_size=8), key=prng.key(5), device="cpu").build_snapshot(mkf)
    q = kfs[2]
    calls = _spy_host_matcher(monkeypatch)
    reloc = lambda: tmap.MapRelocalizer(snap, K, min_inliers=20, key=prng.key(2), device="cpu").relocalize(
        q.keypoints, q.descriptors, q.valid)
    host = reloc()
    assert calls, "the C++ matcher was not taken"
    monkeypatch.setattr(native, "native_available", lambda: False)  # the torch matcher
    n = len(calls)
    dev = reloc()
    assert len(calls) == n
    assert host is not None and dev is not None
    for a, b in zip(host, dev):
        if isinstance(a, dict):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)
