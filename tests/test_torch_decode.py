"""The port's own frame decoder (numpy + zlib) against Pillow, its PNG
writer, and the dataset readers built on it against the JAX package's on
fake datasets.

Grey PNG/PGM pixels are exact. Colour goes to grey by BT.601 in fixed
point as libpng, and so the reference's native decoder, does (truncated);
Pillow rounds its own fixed point, so colour agrees within 1 level.
"""

import io
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import torch_parity  # noqa: F401  (one torch thread per worker)

from mvslam_tpu.data import kitti as jkitti
from mvslam_tpu.data import tum as jtum
from mvslam_tpu.data import validation as jvalidation
from mvslam_tpu.data.camera_rig import CameraRig as JCameraRig
from mvslam_tpu_torch.data import kitti as tkitti
from mvslam_tpu_torch.data import tum as ttum
from mvslam_tpu_torch.data import validation as tvalidation
from mvslam_tpu_torch.data.camera_rig import CameraRig
from mvslam_tpu_torch.data.synthetic import write_kitti_sequence, write_png_gray
from mvslam_tpu_torch.runtime import frame_stream as tfs

COLOR_TYPES = {"L": (0, 1), "RGB": (2, 3), "RGBA": (6, 4)}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def _encode_png(img: np.ndarray, mode: str, filter_type) -> bytes:
    """A PNG with the given filter type on every scanline (``"mixed"``:
    the five types in turn), written from the specification."""
    color, bpp = COLOR_TYPES[mode]
    h, w = img.shape[:2]
    rows = img.reshape(h, w * bpp).astype(int)
    raw = bytearray()
    prev = np.zeros(w * bpp, int)
    for y in range(h):
        ft = y % 5 if filter_type == "mixed" else filter_type
        cur = rows[y]
        left = np.concatenate([np.zeros(bpp, int), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, int), prev[:-bpp]])
        pred = {
            0: np.zeros_like(cur), 1: left, 2: prev, 3: (left + prev) // 2,
            4: np.array([_paeth(a, b, c) for a, b, c in zip(left, prev, upleft)]),
        }[ft]
        raw.append(ft)
        raw += ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur

    def chunk(ctype, body):
        return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))

    comp = zlib.compress(bytes(raw))
    half = len(comp) // 2  # two IDAT chunks: the stream may be split anywhere
    return (
        b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
        + chunk(b"tEXt", b"Comment\x00ancillary chunks are skipped")
        + chunk(b"IDAT", comp[:half]) + chunk(b"IDAT", comp[half:]) + chunk(b"IEND", b"")
    )


def _image(mode, seed=0, h=23, w=37):
    rng = np.random.default_rng(seed)
    channels = COLOR_TYPES[mode][1]
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = ((yy * 5 + xx * 3)[..., None] + 40 * np.arange(channels)) % 256
    noise = rng.integers(0, 256, size=(h, w, channels))
    img = np.where(rng.uniform(size=(h, w, 1)) < 0.5, smooth, noise).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_png_decoder_against_pillow(mode, filter_type):
    img = _image(mode, seed=3)
    data = _encode_png(img, mode, filter_type)
    with Image.open(io.BytesIO(data)) as im:
        assert im.mode == mode and np.array_equal(np.asarray(im), img)  # the test's encoder is right
        ref = np.asarray(im.convert("L"))
    got = tfs.decode_png(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    diff = int(np.abs(got.astype(int) - ref.astype(int)).max())
    assert diff == 0 if mode == "L" else diff <= 1


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_png_written_by_pillow(mode, tmp_path):
    """Pillow's own encoder (adaptive filters, optimised) through the
    default reader."""
    img = _image(mode, seed=5, h=64, w=80)
    path = tmp_path / "a.png"
    Image.fromarray(img, mode=mode).save(path, optimize=True)
    got = tfs._default_read_fn(path)
    ref = np.asarray(Image.open(path).convert("L"))
    diff = int(np.abs(got.astype(int) - ref.astype(int)).max())
    assert diff == 0 if mode == "L" else diff <= 1


def test_grey_levels_of_grey_colour_are_exact():
    """R = G = B = v decodes to v for every level (the weights sum to one)."""
    v = np.arange(256, dtype=np.uint8).reshape(16, 16)
    assert np.array_equal(tfs.decode_png(_encode_png(np.stack([v, v, v], -1), "RGB", 1)), v)


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_pnm_decoder_against_pillow(mode, tmp_path):
    img = _image(mode, seed=7)
    path = tmp_path / ("a.pgm" if mode == "L" else "a.ppm")
    Image.fromarray(img, mode=mode).save(path)
    got = tfs._default_read_fn(path)
    ref = np.asarray(Image.open(path).convert("L"))
    diff = int(np.abs(got.astype(int) - ref.astype(int)).max())
    assert diff == 0 if mode == "L" else diff <= 1
    # A comment in the header is skipped. (A colour PPM reaches the numpy
    # decoder only where neither cv2 nor Pillow is installed.)
    body = path.read_bytes()
    commented = body[:3] + b"# made by a test\n" + body[3:]
    assert np.array_equal(tfs.decode_pnm(commented), tfs.decode_pnm(body))
    if mode == "L":
        assert np.array_equal(tfs.decode_pnm(body), got)


def test_png_writer_round_trips(tmp_path):
    img = _image("L", seed=9, h=370, w=1226)
    write_png_gray(tmp_path / "a.png", img)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "a.png")), img)
    assert np.array_equal(tfs._default_read_fn(tmp_path / "a.png"), img)
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        write_png_gray(tmp_path / "b.png", np.zeros((2, 3, 3), np.uint8))


@pytest.mark.parametrize("what", ["16bit", "palette", "grey_alpha", "interlaced", "jpeg", "ascii_pgm"])
def test_unsupported_formats_are_named(what, tmp_path, monkeypatch):
    """The numpy decoder names each format it does not read; under
    ``MVSLAM_NATIVE_DECODE=0`` such a PNG, a JPEG and an ASCII PGM go to cv2
    or Pillow, as in the JAX package's reader, and with both blocked the
    default reader names their format. With the native decoder on, the
    default reader decodes the PNG formats the numpy one does not."""
    img = _image("L", seed=1)
    path = tmp_path / "x.png"
    if what == "16bit":
        Image.fromarray(img.astype(np.uint16) * 257).save(path)
        match = "16-bit"
    elif what == "palette":
        Image.fromarray(img).convert("P").save(path)
        match = "palette"
    elif what == "grey_alpha":
        Image.fromarray(np.stack([img, img], -1), mode="LA").save(path)
        match = "grey\\+alpha"
    elif what == "interlaced":
        data = bytearray(_encode_png(img, "L", 0))
        data[28] = 1  # IHDR's interlace byte, then IHDR's CRC over its type and body
        data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
        path.write_bytes(bytes(data))
        match = "interlaced"
    elif what == "jpeg":
        path = tmp_path / "x.jpg"
        Image.fromarray(img).save(path)
        match = "jpg"
    else:
        path = tmp_path / "x.pgm"
        path.write_bytes(b"P2\n2 2\n255\n1 2 3 4\n")
        match = "pgm"
    if what in ("16bit", "palette", "grey_alpha"):
        expected = img if what == "16bit" else np.asarray(Image.open(path).convert("L"))
        assert np.array_equal(tfs._default_read_fn(path), expected)
    monkeypatch.setenv("MVSLAM_NATIVE_DECODE", "0")
    _block_libraries(monkeypatch)
    with pytest.raises(ValueError, match=match):
        tfs._default_read_fn(path)
    assert tfs._default_read_fn(tmp_path / "missing.png") is None


def _block_libraries(monkeypatch):
    """Make ``import cv2`` and ``from PIL import Image`` fail."""
    for name in ("cv2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)


def _outcome(read, path):
    """What a reader gives for ``path``: its frame (or None), or the type of
    the exception it raised."""
    try:
        return read(path)
    except Exception as exc:  # noqa: BLE001  (the outcome is compared, whatever it is)
        return type(exc)


def _reads_as_the_reference(path):
    """The port's default reader against the reference's on one file: the
    same frame bit for bit, or both None, or the same exception type."""
    from mvslam_tpu.runtime import frame_stream as jfs

    ours, ref = _outcome(tfs._default_read_fn, path), _outcome(jfs._default_read_fn, path)
    if isinstance(ref, np.ndarray):
        assert isinstance(ours, np.ndarray), (ours, "the reference read a frame")
        assert ours.dtype == ref.dtype == np.uint8
        np.testing.assert_array_equal(ours, ref)
    else:
        assert ours is ref
    return ours


@pytest.mark.parametrize("native_decode", ["1", "0"])
def test_colour_ppm_reads_as_the_reference(native_decode, tmp_path, monkeypatch):
    """A colour PPM (P6), which neither package's C++ decoder reads, is
    cv2's frame in both (cv2 weighs colour otherwise than libpng: on this
    seeded file the two differ by a level at many pixels); with cv2 blocked
    both give Pillow's; with Pillow blocked too the port converts it
    itself, with libpng's weights."""
    pytest.importorskip("cv2")
    monkeypatch.setenv("MVSLAM_NATIVE_DECODE", native_decode)
    rgb = np.random.default_rng(12).integers(0, 256, size=(48, 64, 3), dtype=np.uint8)
    path = tmp_path / "colour.ppm"
    path.write_bytes(b"P6\n64 48\n255\n" + rgb.tobytes())
    ours = _reads_as_the_reference(path)
    assert ours.shape == (48, 64) and (ours != tfs._luma_bt601(rgb)).sum() > 100
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(_reads_as_the_reference(path), np.asarray(Image.open(path).convert("L")))
    _block_libraries(monkeypatch)
    np.testing.assert_array_equal(tfs._default_read_fn(path), tfs._luma_bt601(rgb))


@pytest.mark.parametrize("native_decode", ["1", "0"])
@pytest.mark.parametrize("kind", ["pgm_16_bit", "pgm_maxval_100", "ppm_maxval_100"])
def test_pnm_variants_read_as_the_reference(kind, native_decode, tmp_path, monkeypatch):
    """A 16-bit PGM (which the numpy decoder does not read: cv2's frame
    without the native decoder), a PGM with maxval 100 (the C++ decoders
    rescale it, cv2 and numpy keep the samples) and a PPM with maxval 100."""
    pytest.importorskip("cv2")
    monkeypatch.setenv("MVSLAM_NATIVE_DECODE", native_decode)
    rng = np.random.default_rng(14)
    if kind == "pgm_16_bit":
        data = b"P5\n64 48\n65535\n" + rng.integers(0, 65536, size=(48, 64)).astype(">u2").tobytes()
    elif kind == "pgm_maxval_100":
        data = b"P5\n64 48\n100\n" + rng.integers(0, 101, size=(48, 64), dtype=np.uint8).tobytes()
    else:
        data = b"P6\n64 48\n100\n" + rng.integers(0, 101, size=(48, 64, 3), dtype=np.uint8).tobytes()
    path = tmp_path / ("a.ppm" if kind.startswith("ppm") else "a.pgm")
    path.write_bytes(data)
    assert _reads_as_the_reference(path) is not None


GAMMA_FIXTURES = sorted(p.name for p in (Path(__file__).parent / "data" / "png_gamma").glob("*.png"))


@pytest.mark.parametrize("name", GAMMA_FIXTURES)
def test_gamma_fixtures_without_the_native_decoder_read_as_the_reference(name, monkeypatch):
    """Under ``MVSLAM_NATIVE_DECODE=0`` every committed gamma fixture reads
    as in the reference: the numpy decoder's frame where it reads the file,
    cv2's where it does not (16-bit, palette, Adam7)."""
    pytest.importorskip("cv2")
    monkeypatch.setenv("MVSLAM_NATIVE_DECODE", "0")
    assert _reads_as_the_reference(Path(__file__).parent / "data" / "png_gamma" / name) is not None


def _damaged(kind: str) -> tuple:
    """(file name, bytes) of a truncated or corrupt frame file, made from a
    seeded image."""
    rng = np.random.default_rng(13)
    grey = rng.integers(0, 256, size=(48, 64), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(grey if "grey" in kind else np.stack([grey, grey[::-1], grey[:, ::-1]], -1)).save(buf, "PNG")
    png = buf.getvalue()
    idat = png.index(b"IDAT") + 4
    pgm = b"P5\n64 48\n255\n" + grey.tobytes()
    return {
        "grey_png_without_iend": ("a.png", png[:-12]),
        "rgb_png_cut_in_iend": ("a.png", png[:-6]),
        "rgb_png_cut_in_its_data": ("a.png", png[: len(png) // 2]),
        "grey_png_cut_in_its_header": ("a.png", png[:20]),
        "rgb_png_with_a_bad_data_crc": ("a.png", png[:idat] + bytes([png[idat] ^ 1]) + png[idat + 1 :]),
        "grey_pgm_cut_short": ("a.pgm", pgm[:-10]),
        "grey_pgm_cut_in_its_header": ("a.pgm", b"P5\n64 4"),
        "rgb_ppm_cut_short": ("a.ppm", b"P6\n64 48\n255\n" + rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()),
    }[kind]


@pytest.mark.parametrize("library", ["cv2", "pillow"])
@pytest.mark.parametrize("native_decode", ["1", "0"])
@pytest.mark.parametrize("kind", [
    "grey_png_without_iend", "rgb_png_cut_in_iend", "rgb_png_cut_in_its_data", "grey_png_cut_in_its_header",
    "rgb_png_with_a_bad_data_crc", "grey_pgm_cut_short", "grey_pgm_cut_in_its_header", "rgb_ppm_cut_short",
])
def test_truncated_and_corrupt_files_read_as_the_reference(kind, native_decode, library, tmp_path, monkeypatch):
    """A truncated or corrupt PNG, PGM or PPM has the reference's outcome:
    None where cv2 gives up (every case here), and with cv2 blocked Pillow's
    frame or exception (it reads a PNG without IEND)."""
    pytest.importorskip("cv2")
    monkeypatch.setenv("MVSLAM_NATIVE_DECODE", native_decode)
    if library == "pillow":
        monkeypatch.setitem(sys.modules, "cv2", None)
    name, data = _damaged(kind)
    path = tmp_path / name
    path.write_bytes(data)
    outcome = _reads_as_the_reference(path)
    if library == "cv2":
        assert outcome is None


def _library_frame(h=60, w=90, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(yy * 3 + xx) % 256, (xx * 2) % 256, (yy * 4) % 256], -1)
    return np.clip(base + rng.integers(-20, 21, size=(h, w, 3)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("ext", ["jpg", "bmp", "tiff"])
@pytest.mark.parametrize("native_decode", ["1", "0"])
def test_library_formats_equal_the_reference(ext, native_decode, tmp_path, monkeypatch):
    """A JPEG, a BMP and a TIFF written with cv2 (colour) read equal to the
    reference's default reader, with the native decoder on and off; with
    cv2 blocked both fall to Pillow and agree again; with both blocked the
    port's reader names the format."""
    import cv2

    from mvslam_tpu.runtime import frame_stream as jfs

    monkeypatch.setenv("MVSLAM_NATIVE_DECODE", native_decode)
    path = tmp_path / f"frame.{ext}"
    assert cv2.imwrite(str(path), _library_frame(seed=len(ext)))
    ours, ref = tfs._default_read_fn(path), jfs._default_read_fn(path)
    assert ours is not None and ours.dtype == np.uint8 and ours.shape == (60, 90)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
    monkeypatch.setitem(sys.modules, "cv2", None)
    ours, ref = tfs._default_read_fn(path), jfs._default_read_fn(path)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, np.asarray(Image.open(path).convert("L")))
    _block_libraries(monkeypatch)
    with pytest.raises(ValueError, match=rf"\.{ext}.*cv2 or Pillow"):
        tfs._default_read_fn(path)
    assert tfs._default_read_fn(tmp_path / f"missing.{ext}") is None


def test_images_run_over_jpegs_feeds_the_tracker_the_reference_frames(tmp_path, monkeypatch):
    """``run_visual_slam(input_kind="images")`` over a folder of JPEGs: the
    port's run hands its tracker the same frames, timestamps and shape (so
    the same intrinsics) as the reference's run."""
    import cv2

    from mvslam_tpu.slam import api as japi
    from mvslam_tpu.slam import offline as joffline
    from mvslam_tpu_torch.slam import api as tapi
    from mvslam_tpu_torch.slam import offline as toffline

    folder = tmp_path / "jpegs"
    folder.mkdir()
    base = _library_frame(h=96, w=128, seed=4)
    for i in range(4):
        assert cv2.imwrite(str(folder / f"{i:06d}.jpg"), np.roll(base, 3 * i, axis=1))

    def record(api, store):
        run = api.SLAMSystem._run_windowed

        def recording(self, frames, *args, **kwargs):
            def tee():
                for frame, stamp in frames:
                    store.append((np.array(frame), stamp))
                    yield frame, stamp

            store.append(("K", self.config.fx, self.config.fy, self.config.cx, self.config.cy))
            return run(self, tee(), *args, **kwargs)

        monkeypatch.setattr(api.SLAMSystem, "_run_windowed", recording)

    ours, ref = [], []
    record(tapi, ours)
    record(japi, ref)
    common = dict(input_path=folder, input_kind="images", enable_loop_closure=False, seed=3)
    toffline.run_visual_slam(toffline.SLAMRunConfig(output_root=tmp_path / "t", **common), device="cpu")
    joffline.run_visual_slam(joffline.SLAMRunConfig(output_root=tmp_path / "j", **common))
    assert len(ours) == len(ref) == 5
    assert ours[0] == ref[0]
    for (a, sa), (b, sb) in zip(ours[1:], ref[1:]):
        assert sa == sb and a.shape == (96, 128)
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------
# Dataset readers on fake datasets
# ----------------------------------------------------------------------

def _strip(num_frames, h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(h, w), dtype=np.uint8) for _ in range(num_frames)]


@pytest.fixture()
def fake_kitti(tmp_path):
    frames = _strip(5)
    root, gt = write_kitti_sequence(tmp_path / "kitti", frames, np.arange(15.0).reshape(5, 3), (100.0, 101.0, 32.0, 24.0))
    seq_dir = root / "sequences" / "00"
    P = "100.0 0 32.0 0 0 101.0 24.0 0 0 0 1 0"
    (seq_dir / "calib.txt").write_text(f"P0: {P}\nP1: {P.replace('0 0 0 1 0', '-38.6 0 0 1 0')}\n")
    (seq_dir / "image_1").mkdir()
    for i, f in enumerate(frames):
        write_png_gray(seq_dir / "image_1" / f"{i:06d}.png", f[:, ::-1])
    return root, gt, frames


def _packets(packets):
    return [(p.index, p.timestamp, p.frame.tolist(), p.path.name) for p in packets]


def test_kitti_sequence_equals_reference(fake_kitti):
    """The reference decodes these files with its C++ library or Pillow,
    the port with its own decoder: the same packets."""
    root, gt, frames = fake_kitti
    ours, ref = tkitti.KittiSequence(root, "00"), jkitti.KittiSequence(root, "00")
    assert len(ours) == len(ref) == 5
    assert np.array_equal(ours.camera_intrinsics(), ref.camera_intrinsics())
    assert [(e.index, e.timestamp, e.path) for e in ours.frame_entries(3)] == [
        (e.index, e.timestamp, e.path) for e in ref.frame_entries(3)
    ]
    got = _packets(ours.iter_frames(4))
    assert got == _packets(ref.iter_frames(4)) and len(got) == 4
    assert got[2][2] == frames[2].tolist()
    assert ours.nearest_frame(0.26) == ref.nearest_frame(0.26)
    assert np.array_equal(tkitti.load_ground_truth_poses(gt), jkitti.load_ground_truth_poses(gt))
    calib = tkitti.parse_kitti_calib_file(root / "sequences" / "00" / "calib.txt")
    ref_calib = jkitti.parse_kitti_calib_file(root / "sequences" / "00" / "calib.txt")
    assert calib.keys() == ref_calib.keys() and all(np.array_equal(calib[k], ref_calib[k]) for k in calib)
    multi, ref_multi = tkitti.MultiCameraKittiSequence(root, "00"), jkitti.MultiCameraKittiSequence(root, "00")
    assert isinstance(multi.rig(), CameraRig) and isinstance(ref_multi.rig(), JCameraRig)
    assert [c for c in multi.rig().cameras] == [c for c in ref_multi.rig().cameras]


def test_validate_kitti_equals_reference(fake_kitti, tmp_path):
    root, _, _ = fake_kitti
    ours, ref = tvalidation.validate_kitti(root, "00", 0), jvalidation.validate_kitti(root, "00", 0)
    assert ours.ok and ours.to_dict() == ref.to_dict()
    ours, ref = tvalidation.validate_kitti_multi_camera(root, "00"), jvalidation.validate_kitti_multi_camera(root, "00")
    assert ours.to_dict() == ref.to_dict()
    (root / "sequences" / "00" / "times.txt").write_text("0.0\n0.1\n")
    ours, ref = tvalidation.validate_kitti(root, "00", 0), jvalidation.validate_kitti(root, "00", 0)
    assert ours.to_dict() == ref.to_dict()
    ours, ref = tvalidation.validate_kitti(tmp_path / "none", "00", 0), jvalidation.validate_kitti(tmp_path / "none", "00", 0)
    assert not ours.ok and ours.to_dict() == ref.to_dict()


def test_kitti_raw_session_equals_reference(tmp_path):
    date = "2011_09_26"
    drive_dir = tmp_path / date / f"{date}_drive_0001_sync"
    (drive_dir / "image_00" / "data").mkdir(parents=True)
    (drive_dir / "oxts" / "data").mkdir(parents=True)
    frames = _strip(4, seed=2)
    for i, f in enumerate(frames):
        write_png_gray(drive_dir / "image_00" / "data" / f"{i:010d}.png", f)
        lon = 8.43 + np.degrees(0.8 * i / (6378137.0 * np.cos(np.radians(49.0))))
        (drive_dir / "oxts" / "data" / f"{i:010d}.txt").write_text(f"49.000000000 {lon:.12f} 112.000 0 0 0 0 0 0 0\n")
    (tmp_path / date / "calib_cam_to_cam.txt").write_text("P_rect_00: 100 0 32 0 0 100 24 0 0 0 1 0\n")
    ours = tkitti.KittiRawSession(base_dir=tmp_path, date=date, drive="1")
    ref = jkitti.KittiRawSession(base_dir=tmp_path, date=date, drive="1")
    assert ours.image_paths() == ref.image_paths() and len(ours.image_paths()) == 4
    assert np.array_equal(ours.camera_intrinsics(), ref.camera_intrinsics())
    assert np.array_equal(ours.oxts_positions(), ref.oxts_positions())
    assert _packets(ours.iter_frames(3)) == _packets(ref.iter_frames(3))


def test_tum_sequence_equals_reference(tmp_path):
    (tmp_path / "rgb").mkdir()
    frames = _strip(4, seed=3)
    stamps = [1305031102.175304 + 0.033 * i for i in range(4)]
    for s, f in zip(stamps, frames):
        Image.fromarray(np.stack([f, f, f], -1), mode="RGB").save(tmp_path / "rgb" / f"{s:.6f}.png")
    (tmp_path / "rgb.txt").write_text(
        "# color images\n# timestamp filename\n" + "\n".join(f"{s:.6f} rgb/{s:.6f}.png" for s in stamps) + "\n"
    )
    (tmp_path / "groundtruth.txt").write_text(
        "# ground truth\n" + "\n".join(f"{s:.4f} {i} 0 0 0 0 0 1" for i, s in enumerate(stamps)) + "\n"
    )
    (tmp_path / "K.txt").write_text("500 501 320 240\n")
    ours, ref = ttum.TumSequence(tmp_path), jtum.TumSequence(tmp_path)
    assert len(ours) == len(ref) == 4
    assert np.array_equal(ours.camera_intrinsics(), ref.camera_intrinsics())
    assert np.array_equal(ours.camera_intrinsics(tmp_path / "K.txt"), ref.camera_intrinsics(tmp_path / "K.txt"))
    got = _packets(ours.iter_frames())
    assert got == _packets(ref.iter_frames()) and got[1][2] == frames[1].tolist()  # grey RGB decodes exactly
    for a, b in zip(ours.ground_truth(), ref.ground_truth()):
        assert np.array_equal(a, b)
    assert tvalidation.validate_tum(tmp_path).to_dict() == jvalidation.validate_tum(tmp_path).to_dict()
    (tmp_path / "rgb.txt").unlink()
    assert [(e.index, e.timestamp, e.path) for e in ttum.TumSequence(tmp_path).entries] == [
        (e.index, e.timestamp, e.path) for e in jtum.TumSequence(tmp_path).entries
    ]
