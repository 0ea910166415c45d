"""PNG files with gamma chunks, and the fixtures of ``tests/data/png_gamma/``.

The encoder writes PNG from the specification with numpy and zlib (filter
0, optional Adam7, any extra chunks before PLTE, IDAT or IEND), so the
files do not depend on the decoders they test. ``main`` writes the
committed fixtures and ``digests.json`` beside them: the SHA-256 of the
grey image the JAX package's libpng decoder gives for each file, with its
shape and whether the port's numpy decoder reads it (8-bit RGB and RGBA,
non-interlaced).

    python tests/png_gamma_fixtures.py   # rewrite the fixtures and digests
"""

from __future__ import annotations

import hashlib
import json
import struct
import sys
import zlib
from pathlib import Path

import numpy as np

FIXTURE_DIR = Path(__file__).resolve().parent / "data" / "png_gamma"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]


def chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def gama(value: int) -> bytes:
    return chunk(b"gAMA", struct.pack(">I", value))


def srgb(intent: int = 0) -> bytes:
    return chunk(b"sRGB", bytes([intent]))


def sbit(*bits: int) -> bytes:
    return chunk(b"sBIT", bytes(bits))


# cHRM with the sRGB primaries and D65 white (x, y in 1e-5 units).
CHRM_SRGB = chunk(b"cHRM", struct.pack(">8I", 31270, 32900, 64000, 33000, 30000, 60000, 15000, 6000))


def _rows(samples: np.ndarray, depth: int) -> np.ndarray:
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.uint32)
    if depth == 16:
        return np.stack([flat >> 8, flat & 255], -1).reshape(h, -1).astype(np.uint8)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = (flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


def encode(samples, color: int, depth: int, before=(), palette=None, trns=None, interlace=False,
           after=()) -> bytes:
    """PNG bytes of (H, W, C) samples (palette indices for colour type 3);
    ``before`` chunks go between IHDR and PLTE/IDAT, ``after`` ones between
    IDAT and IEND."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, c = samples.shape
    assert c == CHANNELS[color]
    raw = bytearray()
    for xs, ys, dx, dy in (ADAM7 if interlace else [(0, 0, 1, 1)]):
        sub = samples[ys::dy, xs::dx]
        if sub.size:
            rows = _rows(sub, depth)
            raw += np.hstack([np.zeros((rows.shape[0], 1), np.uint8), rows]).tobytes()
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    out += b"".join(before)
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(bytes(raw))) + b"".join(after) + chunk(b"IEND", b"")


def colour_samples(color: int, depth: int, h: int = 48, w: int = 64, seed: int = 0) -> np.ndarray:
    """Noise beside smooth ramps, with a band of grey colour (R = G = B)."""
    rng = np.random.default_rng(seed + 100 * color + depth)
    top = (1 << depth) - 1
    c = CHANNELS[color]
    noise = rng.integers(0, top + 1, size=(h, w, c))
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = ((yy * 5 + xx * 3)[..., None] * max(1, top // 64) + (top // 6) * np.arange(c)) % (top + 1)
    img = np.where(rng.uniform(size=(h, w, 1)) < 0.5, smooth, noise)
    if c >= 3:
        img[: h // 6, :, 1] = img[: h // 6, :, 0]
        img[: h // 6, :, 2] = img[: h // 6, :, 0]
    return img


def fixtures() -> dict:
    """name → PNG bytes of every committed fixture."""
    rgb8 = colour_samples(2, 8)
    rgba8 = colour_samples(6, 8)
    rgb16 = colour_samples(2, 16)
    rng = np.random.default_rng(7)
    palette = rng.integers(0, 256, size=(16, 3))
    palette[0] = (120, 120, 120)
    idx = colour_samples(3, 4) % 16
    return {
        "rgb8_srgb.png": encode(rgb8, 2, 8, [srgb()]),
        "rgb8_gama45455.png": encode(rgb8, 2, 8, [gama(45455)]),
        "rgb8_gama95000.png": encode(rgb8, 2, 8, [gama(95000)]),
        "rgb8_gama96000.png": encode(rgb8, 2, 8, [gama(96000)]),
        "rgba8_srgb_gama_chrm.png": encode(rgba8, 6, 8, [srgb(), gama(45455), CHRM_SRGB]),
        "rgb8_adam7_gama55556.png": encode(rgb8, 2, 8, [gama(55556)], interlace=True),
        "rgb16_gama45455.png": encode(rgb16, 2, 16, [gama(45455)]),
        "rgb16_sbit10_gama220000.png": encode(rgb16, 2, 16, [sbit(10, 10, 10), gama(220000)]),
        "palette4_trns_gama45455.png": encode(idx, 3, 4, [gama(45455)], palette=palette,
                                               trns=bytes(range(0, 256, 32))),
    }


def numpy_reads(data: bytes) -> bool:
    """Whether the port's numpy decoder reads the file (8-bit grey, RGB and
    RGBA, non-interlaced)."""
    _, _, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", data[16:29])
    return depth == 8 and color in (0, 2, 6) and interlace == 0


def gray_digest(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img, dtype=np.uint8).tobytes()).hexdigest()


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from mvslam_tpu import native as reference

    FIXTURE_DIR.mkdir(parents=True, exist_ok=True)
    digests = {}
    for name, data in fixtures().items():
        path = FIXTURE_DIR / name
        path.write_bytes(data)
        img = reference.decode_gray(path)
        if img is None:
            raise SystemExit(f"libpng did not decode {name}")
        digests[name] = {"sha256": gray_digest(img), "shape": list(img.shape), "numpy": numpy_reads(data)}
    (FIXTURE_DIR / "digests.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")
    print(f"{len(digests)} fixtures in {FIXTURE_DIR}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
