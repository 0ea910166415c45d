"""libpng's gamma path in the port's two PNG decoders.

The JAX package decodes PNG with libpng under
``png_set_rgb_to_gray_fixed(png, 1, 29900, 58700)``; with a gAMA or sRGB
chunk whose gamma libpng deems significant, its colour-to-grey conversion
goes through gamma tables. Both of the port's decoders (the C++ one in
``mvslam_tpu_torch/native`` and the numpy one in ``runtime/frame_stream``)
are held here to the reference's libpng decoder bit for bit: on every 8-bit
RGB triple under sRGB and gAMA 45455, at the gamma values that pin the edge
of the path, on 16-bit RGB (C++ only: the numpy decoder reads 8-bit files),
palette with and without tRNS, RGBA, grey, Adam7 and cHRM, on libpng's
chunk rules, and on the committed fixtures of ``tests/data/png_gamma``.
"""

import json
import struct

import numpy as np
import pytest

import png_gamma_fixtures as F
from png_gamma_fixtures import CHRM_SRGB, chunk, colour_samples, encode, gama, sbit, srgb

from mvslam_tpu import native as jnative
from mvslam_tpu_torch import native
from mvslam_tpu_torch.runtime import frame_stream as tfs


@pytest.fixture(scope="module", autouse=True)
def _libraries():
    assert native.native_available(), "the port's native library did not build"
    assert jnative.native_available(), "the reference's native library did not build"


def _decode(tmp_path, data, cap=4096):
    """(port C++, port numpy or None, reference libpng) grey images."""
    path = tmp_path / "g.png"
    path.write_bytes(data)
    ref = jnative.decode_gray(path, cap, cap)
    assert ref is not None, "libpng refused the file"
    ours = native.decode_gray(path, cap, cap)
    numpy_img = tfs.decode_png(data) if F.numpy_reads(data) else None
    return ours, numpy_img, ref


def _assert_equal(tmp_path, data, cap=4096):
    ours, numpy_img, ref = _decode(tmp_path, data, cap)
    np.testing.assert_array_equal(ours, ref)
    if numpy_img is not None:
        np.testing.assert_array_equal(numpy_img, ref)
    return ref


def _plain_luma(rgb):
    """The plain path (no gamma): libpng's truncated fixed-point weights."""
    c = rgb[..., :3].astype(np.uint32)
    return ((9797 * c[..., 0] + 19234 * c[..., 1] + 3737 * c[..., 2]) >> 15).astype(np.uint8)


def _every_triple():
    v = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)


@pytest.mark.parametrize("tag", ["sRGB", "gAMA45455"])
def test_every_rgb_triple_equals_libpng(tag, tmp_path):
    """All 2^24 8-bit RGB triples under an sRGB chunk and under gAMA 45455
    (1/2.2): both port decoders give libpng's pixels."""
    before = [srgb()] if tag == "sRGB" else [gama(45455)]
    ref = _assert_equal(tmp_path, encode(_every_triple(), 2, 8, before))
    assert (ref != _plain_luma(_every_triple())).sum() > 10_000_000  # the gamma path is taken


def test_srgb_file_no_longer_differs(tmp_path):
    """A 64 × 64 RGB file tagged sRGB: the plain conversion the decoders
    used before differs from libpng in most pixels; the port now differs in
    none."""
    rgb = np.random.default_rng(11).integers(0, 256, size=(64, 64, 3)).astype(np.uint8)
    ref = _assert_equal(tmp_path, encode(rgb, 2, 8, [srgb()]))
    assert (_plain_luma(rgb) != ref).sum() > 3500


# gAMA values around the edge of the path: libpng builds its tables when the
# file gamma or its reciprocal (the screen gamma it assumes) lies outside
# [95000, 105000]; 95000 is in range but 1e10 / 95000 = 105263 is not.
EDGE = {55556: True, 94000: True, 95000: True, 95237: True, 95238: False, 96000: False,
        100000: False, 104000: False, 105000: False, 105001: True, 106000: True, 220000: True}


@pytest.mark.parametrize("gamma", sorted(EDGE))
def test_edge_gamma_values_pin_the_path(gamma, tmp_path):
    rng = np.random.default_rng(gamma)
    rgb = rng.integers(0, 256, size=(256, 256, 3)).astype(np.uint8)
    rgb[:16, :, 1] = rgb[:16, :, 2] = rgb[:16, :, 0]  # grey colour
    ref = _assert_equal(tmp_path, encode(rgb, 2, 8, [gama(gamma)]))
    assert (tfs._gamma_tables(gamma) is not None) == EDGE[gamma]
    plain = _plain_luma(rgb)
    assert ((ref != plain).sum() > 0) == EDGE[gamma]
    np.testing.assert_array_equal(ref[:16], rgb[:16, :, 0])  # grey colour is unchanged


@pytest.mark.parametrize("gamma", [45455, 95000, 96000, 106000, 220000, 16, 625000000])
def test_16bit_rgb_equals_libpng(gamma, tmp_path):
    """16-bit RGB and RGBA (the C++ decoder): colour through libpng's 16-bit
    tables before strip_16, every grey level through its 16-to-8 table."""
    v = np.arange(65536).reshape(256, 256)
    grey = np.stack([v, v, v], -1)
    _assert_equal(tmp_path, encode(grey, 2, 16, [gama(gamma)]))
    rng = np.random.default_rng(gamma % 1000)
    _assert_equal(tmp_path, encode(rng.integers(0, 65536, size=(128, 256, 3)), 2, 16, [gama(gamma)]))
    _assert_equal(tmp_path, encode(rng.integers(0, 65536, size=(64, 96, 4)), 6, 16, [gama(gamma)]))


@pytest.mark.parametrize("bits", [(10, 10, 10), (12, 9, 3), (4, 4, 4), (16, 16, 16), (0, 10, 10), (17, 1, 1)])
def test_16bit_sbit_sets_the_table_shift(bits, tmp_path):
    """An sBIT chunk narrows libpng's 16-bit tables (an invalid one is
    dropped); only 16-bit colour under a gamma chunk feels it."""
    rng = np.random.default_rng(sum(bits))
    v = np.arange(65536).reshape(256, 256)
    for img in (np.stack([v, v, v], -1), rng.integers(0, 65536, size=(128, 256, 3))):
        _assert_equal(tmp_path, encode(img, 2, 16, [sbit(*bits), gama(45455)]))


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
@pytest.mark.parametrize("trns", [False, True])
def test_palette_with_gamma_equals_libpng(depth, trns, tmp_path):
    """Palette entries expand to RGB before the gamma path; tRNS alpha is
    dropped."""
    rng = np.random.default_rng(depth)
    entries = 1 << depth
    palette = rng.integers(0, 256, size=(entries, 3))
    palette[0] = (90, 90, 90)
    idx = colour_samples(3, depth, h=19, w=37) % entries
    alpha = rng.integers(0, 256, size=entries).astype(np.uint8).tobytes() if trns else None
    for before in ([gama(45455)], [srgb()], [gama(220000)]):
        for interlace in (False, True):
            _assert_equal(tmp_path, encode(idx, 3, depth, before, palette=palette, trns=alpha, interlace=interlace))


def test_rgba_grey_adam7_chrm_and_trns_with_gamma(tmp_path):
    """RGBA (alpha dropped first), grey files (no colour conversion, so no
    gamma), Adam7, cHRM beside gAMA (the weights were set explicitly, so
    cHRM does not change them), and RGB tRNS."""
    for before in ([gama(45455)], [srgb(), gama(45455), CHRM_SRGB], [CHRM_SRGB, gama(55556)]):
        _assert_equal(tmp_path, encode(colour_samples(6, 8), 6, 8, before))
        _assert_equal(tmp_path, encode(colour_samples(2, 8), 2, 8, before, interlace=True))
        _assert_equal(tmp_path, encode(colour_samples(2, 8), 2, 8, before, trns=struct.pack(">3H", 7, 9, 11)))
        for color, depth in [(0, 8), (0, 16), (0, 4), (4, 8), (4, 16)]:
            img = colour_samples(color, depth)
            ref = _assert_equal(tmp_path, encode(img, color, depth, before))
            if color == 0 and depth == 8:
                np.testing.assert_array_equal(ref, img[..., 0])


def _bad_crc(c):
    return c[:-1] + bytes([c[-1] ^ 1])


# Chunk sequences before IDAT, libpng's rules for each (see _png_file_gamma).
CHUNK_RULES = {
    "sRGB then gAMA 45455": [srgb(), gama(45455)],
    "gAMA 45455 then sRGB": [gama(45455), srgb()],
    "sRGB then a disagreeing gAMA": [srgb(), gama(100000)],
    "gAMA then sRGB overrides": [gama(100000), srgb()],
    "sRGB then an agreeing gAMA": [srgb(), gama(45000)],
    "sRGB, disagreeing then agreeing gAMA": [srgb(), gama(50000), gama(45000)],
    "second gAMA invalidates": [gama(100000), gama(45455)],
    "second gAMA keeps the first": [gama(50000), gama(80000)],
    "gAMA with a bad CRC": [_bad_crc(gama(45455))],
    "bad CRC, then gAMA": [_bad_crc(gama(45455)), gama(50000)],
    "sRGB with a bad CRC": [_bad_crc(srgb())],
    "gAMA of length 5, then gAMA": [chunk(b"gAMA", b"\0\0\xb1\x8f\0"), gama(50000)],
    "gAMA 0": [gama(0)],
    "gAMA 15, then gAMA": [gama(15), gama(50000)],
    "gAMA, then gAMA 15": [gama(50000), gama(15)],
    "gAMA past 2^31": [gama(2 ** 31 + 5)],
    "gAMA 625000001": [gama(625000001)],
    "gAMA 16": [gama(16)],
    "sRGB then gAMA 16": [srgb(), gama(16)],
    "sRGB intent 3": [srgb(3)],
    "sRGB intent 4, then gAMA": [srgb(4), gama(50000)],
    "gAMA, then sRGB intent 4": [gama(50000), srgb(4)],
    "sRGB of length 2, then gAMA": [chunk(b"sRGB", b"\0\0"), gama(50000)],
    "two sRGB": [srgb(0), srgb(1)],
    "gAMA 15, then sRGB": [gama(15), srgb()],
    "cHRM then gAMA": [CHRM_SRGB, gama(50000)],
}


@pytest.mark.parametrize("name", sorted(CHUNK_RULES))
def test_gamma_chunk_rules_equal_libpng(name, tmp_path):
    for color, depth in [(2, 8), (6, 8), (2, 16)]:
        _assert_equal(tmp_path, encode(colour_samples(color, depth, h=24, w=40), color, depth, CHUNK_RULES[name]))


def test_gamma_chunks_after_plte_or_idat_are_ignored(tmp_path):
    rgb = colour_samples(2, 8)
    plte = chunk(b"PLTE", bytes(range(48)))  # a suggested palette in an RGB file
    for data in (encode(rgb, 2, 8, [plte, gama(45455)]), encode(rgb, 2, 8, [plte, srgb()]),
                 encode(rgb, 2, 8, after=[gama(45455)]), encode(rgb, 2, 8, after=[srgb()])):
        ref = _assert_equal(tmp_path, data)
        np.testing.assert_array_equal(ref, _plain_luma(rgb))


def test_committed_fixtures_match_libpng_digests():
    """The fixtures of tests/data/png_gamma: libpng's grey output here
    hashes to the committed digest, and so do both port decoders' (the
    same check runs on the card's host, which has no libpng)."""
    digests = json.loads((F.FIXTURE_DIR / "digests.json").read_text())
    assert set(digests) == set(F.fixtures())
    for name, want in sorted(digests.items()):
        path = F.FIXTURE_DIR / name
        ref = jnative.decode_gray(path)
        assert list(ref.shape) == want["shape"] and F.gray_digest(ref) == want["sha256"], name
        assert F.gray_digest(native.decode_gray(path)) == want["sha256"], name
        assert want["numpy"] == F.numpy_reads(path.read_bytes())
        if want["numpy"]:
            assert F.gray_digest(tfs.decode_png(path.read_bytes())) == want["sha256"], name
