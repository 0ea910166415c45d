"""Single-loader-thread frame streaming with a bounded ring buffer.

Parity: reference ``frame_stream.py`` — one background thread decodes
frames (cv2.imread or an injected ``read_fn``) into a bounded thread-safe
ring buffer; the consumer iterates :class:`FramePacket`s in order;
backpressure drops the oldest buffered frame and counts it.

This is host-side I/O; the windowed device-batch engine
(``slam.api.SLAMSystem._run_windowed``) consumes it. Given a telemetry
``recorder``, the loader records each read as a ``frame_decode`` span on
its thread (``frame-loader``), with the file's index.

Port of ``mvslam_tpu/runtime/frame_stream.py``. The JAX package's default
reader decodes with its C++ library, then cv2, then Pillow. The port's
default reader decodes with its own C++ library (``mvslam_tpu_torch.native``)
and then, for PNG and PGM, with numpy: :func:`decode_png` and
:func:`decode_pnm` read 8-bit grey, RGB and RGBA non-interlaced PNG and
binary PGM/PPM with numpy and ``zlib``, colour to grey as libpng, and so
the native decoder, does (BT.601 in fixed point, through libpng's gamma
tables where a gAMA or sRGB chunk calls for them); on those the numpy
decoder gives cv2's frame. Neither cv2 nor Pillow is needed for them. What
the numpy decoders do not read (another PNG variant, a truncated or corrupt
file), colour PPM (which the C++ decoders leave to cv2 and cv2 converts
with its own weights) and every other format go to cv2 and then Pillow,
where installed, as in the JAX package; colour PPM falls back to numpy
where neither is.
"""

from __future__ import annotations

import math
import os
import struct
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Iterator, List, Optional, Sequence

import numpy as np

from mvslam_tpu_torch.core.telemetry import RunTelemetryRecorder, timed_event


@dataclass(frozen=True)
class FramePacket:
    """Parity: ``frame_stream.py`` FramePacket."""

    index: int
    timestamp: float
    frame: np.ndarray
    path: Optional[Path] = None


@dataclass
class FrameStreamStats:
    """Parity: ``frame_stream.py:35-58``."""

    loaded: int = 0
    yielded: int = 0
    dropped: int = 0
    read_failures: int = 0
    wait_time_s: float = 0.0

    def to_dict(self) -> dict:
        return {
            "loaded": self.loaded,
            "yielded": self.yielded,
            "dropped": self.dropped,
            "read_failures": self.read_failures,
            "wait_time_s": self.wait_time_s,
        }


_STOP_RECHECK_S = 0.05  # how often a full buffer's ``put`` looks at its stop event


class BoundedRingBuffer:
    """Thread-safe bounded buffer; push drops the oldest when full, put
    waits for room.

    Parity: ``frame_stream.py:61-111``.
    """

    def __init__(self, capacity: int) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._items: deque = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self.dropped = 0

    def push(self, item: Any) -> bool:
        """Returns False if an old item was dropped to make room."""
        with self._lock:
            clean = True
            if len(self._items) >= self.capacity:
                self._items.popleft()
                self.dropped += 1
                clean = False
            self._items.append(item)
            self._not_empty.notify()
            return clean

    def put(self, item: Any, stop: threading.Event) -> bool:
        """Append ``item``, asleep while the buffer is full; False, without
        appending, once ``stop`` is set (looked at every ``_STOP_RECHECK_S``)."""
        with self._not_full:
            while len(self._items) >= self.capacity and not stop.is_set():
                self._not_full.wait(_STOP_RECHECK_S)
            if stop.is_set():
                return False
            self._items.append(item)
            self._not_empty.notify()
            return True

    def pop(self, timeout: Optional[float] = None) -> Optional[Any]:
        with self._not_empty:
            if not self._items:
                self._not_empty.wait(timeout)
            if not self._items:
                return None
            self._not_full.notify()
            return self._items.popleft()

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # grey, RGB, RGBA
_PNG_COLOR_NAMES = {3: "palette", 4: "grey+alpha"}


def _luma_bt601(rgb: np.ndarray, file_gamma: int = 0) -> np.ndarray:
    """(H, W, 3+) uint8 → (H, W) uint8 as libpng's
    ``png_set_rgb_to_gray_fixed(png, 1, 29900, 58700)`` gives it: BT.601
    weights (0.299, 0.587) truncated to 15-bit fixed point (9797, 19234),
    blue the remainder (3737), the sum truncated. Grey colour (R = G = B)
    stays exact because the weights sum to 2^15. A ``file_gamma`` (units of
    1e-5, from :func:`_png_file_gamma`) that libpng deems significant takes
    libpng's gamma path instead (:func:`_gamma_tables`)."""
    c = rgb[..., :3].astype(np.uint32)
    tables = _gamma_tables(file_gamma)
    if tables is None:
        return ((9797 * c[..., 0] + 19234 * c[..., 1] + 3737 * c[..., 2]) >> 15).astype(np.uint8)
    to1, from1, grey = tables
    lin = (9797 * to1[c[..., 0]] + 19234 * to1[c[..., 1]] + 3737 * to1[c[..., 2]] + 16384) >> 15
    same = (c[..., 0] == c[..., 1]) & (c[..., 0] == c[..., 2])
    return np.where(same, grey[c[..., 0]], from1[lin]).astype(np.uint8)


# libpng 1.6's gamma path for rgb_to_gray (the C++ decoder's GammaPath). With
# no screen gamma set, libpng takes the screen gamma to be the reciprocal of
# the file's and converts through gamma tables when either lies more than
# PNG_GAMMA_THRESHOLD_FIXED from 1.0: colour to linear, weighted and rounded,
# and back; grey colour through the file-to-screen table. Each entry is
# libpng's own double expression, evaluated by the C library's pow (``math``).
_FIXED_ONE = 100000
_GAMMA_SRGB = 45455  # PNG_GAMMA_sRGB_INVERSE


def _gamma_significant(g: int) -> bool:
    return g < _FIXED_ONE - 5000 or g > _FIXED_ONE + 5000


def _fixed_round(r: float) -> int:
    r = math.floor(r + 0.5)
    return int(r) if -2147483648.0 <= r <= 2147483647.0 else 0


def _gamma_table8(gamma: int) -> np.ndarray:
    """png_build_8bit_table with png_gamma_8bit_correct."""
    if not _gamma_significant(gamma):
        return np.arange(256, dtype=np.uint32)
    inner = [math.floor(255 * math.pow(v / 255.0, gamma * 0.00001) + 0.5) for v in range(1, 255)]
    return np.array([0, *inner, 255], dtype=np.uint32)


def _gamma_tables(file_gamma: int):
    """(to_1, from_1, grey) for 8-bit samples, or None where libpng takes
    the plain path."""
    if file_gamma == 0:
        return None
    screen = _fixed_round(1e10 / file_gamma)
    if not (_gamma_significant(file_gamma) or _gamma_significant(screen)):
        return None
    r = 1e15 / file_gamma
    r /= screen
    return (_gamma_table8(_fixed_round(1e10 / file_gamma)), _gamma_table8(_fixed_round(1e10 / screen)),
            _gamma_table8(_fixed_round(r)))


def _png_file_gamma(chunks) -> int:
    """The file gamma (1e-5 units, 0 for none) that libpng reads from the
    ``(type, body)`` gAMA and sRGB chunks before PLTE and IDAT whose CRC
    holds: a gAMA out of [16, 625000000], a second stored gAMA, or an sRGB
    with an undefined intent marks the colour space invalid, after which no
    gAMA or sRGB is stored; sRGB sets 45455 once; a gAMA after sRGB is stored
    only where it agrees with 45455 within the threshold."""
    gamma, from_gama, from_srgb, invalid = 0, False, False, False
    for ctype, body in chunks:
        if ctype == b"gAMA" and len(body) == 4:
            g = struct.unpack(">I", body)[0]
            if not 16 <= g <= 625000000 or from_gama:
                invalid = True
            elif not invalid:
                if from_srgb:
                    r = math.floor(float(gamma) * _FIXED_ONE / g + 0.5)
                    if r > 2147483647.0 or _gamma_significant(int(r)):
                        continue
                gamma, from_gama = g, True
        elif ctype == b"sRGB" and len(body) == 1 and not (invalid or from_srgb):
            if body[0] > 3:
                invalid = True
            else:
                gamma, from_srgb = _GAMMA_SRGB, True
    return gamma


def _unfilter_png(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG scanline filters; returns (height, stride) uint8."""
    data = np.frombuffer(raw, dtype=np.uint8)
    if data.size != height * (stride + 1):
        raise ValueError("PNG image data has the wrong length")
    data = data.reshape(height, stride + 1)
    out = np.empty((height, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(height):
        ftype = int(data[y, 0])
        line = data[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum per channel, modulo 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average, Paeth: each byte needs the one to its left
            row = bytearray(line.tobytes())
            up = prev.tobytes()
            if ftype == 3:
                for i in range(stride):
                    left = row[i - bpp] if i >= bpp else 0
                    row[i] = (row[i] + ((left + up[i]) >> 1)) & 0xFF
            else:
                for i in range(stride):
                    a = row[i - bpp] if i >= bpp else 0
                    b = up[i]
                    c = up[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                    row[i] = (row[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(row), dtype=np.uint8)
        else:
            raise ValueError(f"PNG filter type {ftype} is not defined")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """Decode an 8-bit grey, RGB or RGBA non-interlaced PNG to (H, W) uint8
    grey (alpha dropped). Any other PNG raises ``ValueError`` naming it; so
    does a truncated or corrupt one (a chunk cut short, no IEND, a critical
    chunk whose CRC fails, image data that does not inflate), which libpng
    refuses too."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    header = None
    idat = []
    colour = []  # gAMA and sRGB chunks libpng reads: before PLTE and IDAT, CRC intact
    before_data = True
    while True:
        if pos + 12 > len(data):
            raise ValueError("truncated PNG: it ends before its IEND chunk")
        length, ctype = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        crc = data[pos + 8 + length : pos + 12 + length]
        pos += 12 + length  # length, type, body, CRC
        if pos > len(data):
            raise ValueError(f"truncated PNG: its {ctype.decode('latin-1')} chunk is cut short")
        crc_holds = crc == struct.pack(">I", zlib.crc32(ctype + body))
        if ctype[0] < 0x61 and not crc_holds:  # upper-case first letter: a critical chunk
            raise ValueError(f"corrupt PNG: the CRC of its {ctype.decode('latin-1')} chunk fails")
        if ctype == b"IHDR":
            if length != 13:
                raise ValueError("corrupt PNG: its IHDR chunk is not 13 bytes")
            header = struct.unpack(">IIBBBBB", body)
        elif ctype in (b"PLTE", b"IDAT"):
            if ctype == b"IDAT":
                idat.append(body)
            before_data = False
        elif ctype in (b"gAMA", b"sRGB") and before_data and crc_holds:
            colour.append((ctype, body))
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace != 0:
        kind = _PNG_COLOR_NAMES.get(color, f"colour type {color}")
        raise ValueError(
            f"unsupported PNG format: {depth}-bit {kind}"
            f"{', interlaced' if interlace else ''} (8-bit grey, RGB and RGBA, non-interlaced, are read)"
        )
    channels = _PNG_CHANNELS[color]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise ValueError(f"corrupt PNG: its image data does not inflate ({exc})") from None
    rows = _unfilter_png(raw, height, width * channels, channels)
    if channels == 1:
        return rows
    return _luma_bt601(rows.reshape(height, width, channels), _png_file_gamma(colour))


def decode_pnm(data: bytes) -> np.ndarray:
    """Decode a binary PGM (P5) or PPM (P6) with maxval ≤ 255 to (H, W)
    uint8 grey."""
    magic = data[:2]
    if magic not in (b"P5", b"P6"):
        raise ValueError(f"unsupported PNM format {magic!r} (binary P5 and P6 are read)")
    fields: List[int] = []
    pos = 2
    while len(fields) < 3:
        while data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":  # comment to the end of the line
            pos = data.find(b"\n", pos) + 1
            if pos == 0:
                break
            continue
        end = pos
        while end < len(data) and not data[end : end + 1].isspace():
            end += 1
        if end == pos or end == len(data) or not data[pos:end].isdigit():
            break
        fields.append(int(data[pos:end]))
        pos = end
    if len(fields) < 3:
        raise ValueError("truncated or corrupt PNM header (width, height and maxval are read)")
    pos += 1  # the single whitespace byte after maxval
    width, height, maxval = fields
    if maxval > 255:
        raise ValueError(f"unsupported PNM format: maxval {maxval} (8-bit samples are read)")
    channels = 1 if magic == b"P5" else 3
    if len(data) - pos < width * height * channels:
        raise ValueError("truncated PNM: fewer samples than its header gives")
    pix = np.frombuffer(data, dtype=np.uint8, count=width * height * channels, offset=pos)
    if channels == 1:
        return pix.reshape(height, width).copy()
    return _luma_bt601(pix.reshape(height, width, 3))


def _native_decoder():
    """The native library when the default reader decodes with it, else
    None (``MVSLAM_NATIVE_DECODE=0``, or no compiler). The first call in a
    process builds or loads the library, so the readers' owners
    (:class:`FrameStream`, the ingestion pipeline) call it when they start,
    not in their first read."""
    if os.environ.get("MVSLAM_NATIVE_DECODE", "1") == "0":
        return None
    from mvslam_tpu_torch import native

    return native if native.native_available() else None


def _library_read(path: Path):
    """cv2, then Pillow, as the JAX package's reader takes them: ``(True,
    frame)`` from the first that is installed (cv2's frame is None where
    cv2 cannot read the file; Pillow raises), ``(False, None)`` with
    neither."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        return True, cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    try:
        from PIL import Image
    except ImportError:
        return False, None
    with Image.open(path) as im:
        return True, np.asarray(im.convert("L"))


def _default_read_fn(path: Path) -> Optional[np.ndarray]:
    """Decode one frame file to (H, W) uint8 grey; None when the file is
    missing or cv2 cannot read it. The JAX package's order: the native C++
    decoder first (every PNG and binary PGM); then, where it does not
    decode the file or under ``MVSLAM_NATIVE_DECODE=0``, cv2 and then
    Pillow, where installed. The numpy decoders stand in for cv2 on the
    PNG and PGM files they read (the same frame); colour PPM, which cv2
    converts with its own weights, goes to cv2 and Pillow and falls back to
    numpy only where neither is installed. With neither, any other file
    raises naming its format or why numpy did not read it."""
    path = Path(path)
    native = _native_decoder()
    if native is not None:
        img = native.decode_gray(path)
        if img is not None:
            return img
    if not path.exists():
        return None
    data = path.read_bytes()
    unread = f"unsupported image format {path.suffix or data[:4]!r}"
    if data[:8] == _PNG_SIGNATURE or data[:2] == b"P5":
        try:
            return decode_pnm(data) if data[:2] == b"P5" else decode_png(data)
        except ValueError as exc:
            unread = str(exc)
    installed, img = _library_read(path)
    if installed:
        return img
    if data[:2] == b"P6":
        try:
            return decode_pnm(data)
        except ValueError as exc:
            unread = str(exc)
    raise ValueError(
        f"{unread} for {path.name}: the default reader decodes 8-bit PNG and binary PGM/PPM itself; "
        "cv2 or Pillow would read it, and neither is installed"
    )


class FrameStream:
    """Iterate frames loaded by one background thread.

    Parity: ``frame_stream.py:123-211``. ``read_fn`` is injectable for
    tests/benchmarks (synthetic frames without disk I/O); the default is
    :func:`_default_read_fn`. ``recorder`` takes a ``frame_decode`` span
    per read.
    """

    def __init__(
        self,
        paths: Sequence[Path],
        timestamps: Optional[Sequence[float]] = None,
        buffer_size: int = 8,
        read_fn: Optional[Callable[[Path], Optional[np.ndarray]]] = None,
        drop_on_backpressure: bool = False,
        recorder: Optional[RunTelemetryRecorder] = None,
    ) -> None:
        self.paths = [Path(p) for p in paths]
        self.timestamps = list(timestamps) if timestamps is not None else [float(i) for i in range(len(self.paths))]
        if len(self.timestamps) != len(self.paths):
            raise ValueError("timestamps must match paths length")
        self.read_fn = read_fn or _default_read_fn
        if read_fn is None:
            _native_decoder()  # builds the default reader's library now, not in the first read
        self.drop_on_backpressure = drop_on_backpressure
        self.recorder = recorder
        self.stats = FrameStreamStats()
        self._buffer = BoundedRingBuffer(buffer_size)
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _run_loader(self) -> None:
        for index, path in enumerate(self.paths):
            frame = None
            try:
                with timed_event(self.recorder, "frame_decode", metadata={"index": index}):
                    frame = self.read_fn(path)
            except Exception:
                frame = None
            if frame is None:
                self.stats.read_failures += 1
                continue
            packet = FramePacket(index=index, timestamp=self.timestamps[index], frame=frame, path=path)
            if self.drop_on_backpressure:
                if not self._buffer.push(packet):
                    self.stats.dropped += 1
            # Asleep until there is room: polling would take the interpreter
            # lock from the consuming thread thousands of times a second.
            elif not self._buffer.put(packet, self._done):
                return
            self.stats.loaded += 1
        self._done.set()

    def __iter__(self) -> Iterator[FramePacket]:
        self._thread = threading.Thread(target=self._run_loader, name="frame-loader", daemon=True)
        self._thread.start()
        try:
            while True:
                start = time.perf_counter()
                packet = self._buffer.pop(timeout=0.05)
                self.stats.wait_time_s += time.perf_counter() - start
                if packet is None:
                    if self._done.is_set() and len(self._buffer) == 0:
                        return
                    continue
                self.stats.yielded += 1
                yield packet
        finally:
            self._done.set()
            if self._thread is not None:
                self._thread.join(timeout=2.0)


def packets_from_arrays(
    frames: Sequence[np.ndarray], timestamps: Optional[Sequence[float]] = None
) -> List[FramePacket]:
    """Wrap in-memory frames as packets (sync-mode ingestion)."""
    ts = timestamps if timestamps is not None else [float(i) for i in range(len(frames))]
    return [FramePacket(index=i, timestamp=float(ts[i]), frame=np.asarray(f)) for i, f in enumerate(frames)]
