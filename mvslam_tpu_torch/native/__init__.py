"""ctypes bindings for the port's C++ host library (``src/mvslam_native.cc``).

The compute path is PyTorch and CUDA; this package is the host runtime
around it: image decode (PNG on zlib, PGM), the multithreaded in-order
frame loader that the runner's ``native`` ingestion mode drives, and the
packed-Hamming matcher that the matching paths use on the CPU
(``ops/hamming.py::matcher_for``).

Port of ``mvslam_tpu/native/`` with the same C ABI. The library is built
by :func:`native_available` (g++ at first use, cached under
``mvslam_tpu_torch/_build/``): the owners of the paths that use it call
it when they start, so no frame pays the compile. If no compiler works, ``native_available()`` is False and callers take their
PyTorch or numpy path; a failed build logs the compiler's stderr once.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Iterator, NamedTuple, Optional, Sequence

import numpy as np

from mvslam_tpu_torch.native.build import build as _build_library

_DECODE_ERRORS = {
    -1: "open_failed",
    -2: "unknown_format",
    -3: "exceeds_capacity",
    -4: "corrupt",
}

_P = ctypes.POINTER
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_U8P = _P(ctypes.c_uint8)
_I32P = _P(ctypes.c_int32)
_I64P = _P(ctypes.c_int64)
# C entry points: name -> (restype, argtypes).
_SIGNATURES = {
    "mvn_abi_version": (_I32, []),
    "mvn_decode_gray": (_I32, [ctypes.c_char_p, _U8P, _I32, _I32, _I32P, _I32P]),
    "mvn_decode_gray_buffer": (_I32, [_U8P, _I64, _U8P, _I32, _I32, _I32P, _I32P]),
    "mvn_loader_create": (ctypes.c_void_p, [_P(ctypes.c_char_p), _I32, _I32, _I32, _I32, _I32]),
    "mvn_loader_next": (_I32, [ctypes.c_void_p, _U8P, _I32P, _I32P, _I32P, _I32P]),
    "mvn_loader_stats": (None, [ctypes.c_void_p, _I64P, _I64P, _I64P, _I64P]),
    "mvn_loader_destroy": (None, [ctypes.c_void_p]),
    "mvn_hamming_match": (
        None,
        [_P(ctypes.c_uint32), _U8P, _I32, _P(ctypes.c_uint32), _U8P, _I32,
         _I32P, _P(ctypes.c_float), _P(ctypes.c_float), _I32P],
    ),
}

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and dlopen the library; cached process-wide."""
    global _lib, _lib_failed
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        path = _build_library()
        if path is None:
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _lib_failed = True
            return None
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        if lib.mvn_abi_version() != 1:
            _lib_failed = True
            return None
        _lib = lib
        return _lib


def native_available() -> bool:
    """True when the C++ library compiled and loaded on this host (builds
    it on the first call)."""
    return _load() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def hamming_match(
    desc_a: np.ndarray,
    valid_a: np.ndarray,
    desc_b: np.ndarray,
    valid_b: np.ndarray,
):
    """Brute-force packed-Hamming match (C++; see ``mvn_hamming_match``).

    Inputs: (N, 8) uint32 packed descriptors and (N,) bool masks. Returns
    ``(best_idx i32 (Na,), best f32, second f32, col_best i32 (Nb,))``,
    equal bit for bit to the torch matcher
    (``ops/hamming.py::match_descriptors``; parity:
    ``tests/test_torch_native.py``). None when the library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    desc_a = np.ascontiguousarray(desc_a, np.uint32)
    desc_b = np.ascontiguousarray(desc_b, np.uint32)
    va = np.ascontiguousarray(valid_a, np.uint8)
    vb = np.ascontiguousarray(valid_b, np.uint8)
    na, nb = desc_a.shape[0], desc_b.shape[0]
    if desc_a.shape != (na, 8) or desc_b.shape != (nb, 8) or va.shape != (na,) or vb.shape != (nb,):
        raise ValueError("hamming_match expects (N, 8) uint32 descriptors and (N,) masks")
    best_idx = np.empty(na, np.int32)
    best = np.empty(na, np.float32)
    second = np.empty(na, np.float32)
    col_best = np.empty(nb, np.int32)
    lib.mvn_hamming_match(
        _ptr(desc_a, ctypes.c_uint32), _ptr(va, ctypes.c_uint8), na,
        _ptr(desc_b, ctypes.c_uint32), _ptr(vb, ctypes.c_uint8), nb,
        _ptr(best_idx, ctypes.c_int32), _ptr(best, ctypes.c_float),
        _ptr(second, ctypes.c_float), _ptr(col_best, ctypes.c_int32),
    )
    return best_idx, best, second, col_best


# Default capacity bounds: generous for KITTI (1242x376) and TUM (640x480)
# while keeping per-slot buffers ~2 MB.
DEFAULT_MAX_H = 1216
DEFAULT_MAX_W = 2048


def decode_gray(
    path: Path | str, max_h: int = DEFAULT_MAX_H, max_w: int = DEFAULT_MAX_W
) -> Optional[np.ndarray]:
    """Decode PNG/PGM to an (H, W) uint8 array; None on failure (a missing
    file, another format, an image larger than ``max_h`` x ``max_w``, a
    corrupt file) or when the library is unavailable.

    Colour goes to grey as libpng's ``png_set_rgb_to_gray_fixed(…, 29900,
    58700)`` does, and as the numpy decoder
    (``runtime/frame_stream.py::decode_png``) does.
    """
    lib = _load()
    if lib is None:
        return None
    buf = np.empty(max_h * max_w, dtype=np.uint8)  # rows packed at stride w
    h = ctypes.c_int32(0)
    w = ctypes.c_int32(0)
    rc = lib.mvn_decode_gray(str(path).encode(), _ptr(buf, ctypes.c_uint8), max_h, max_w, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        return None
    return buf[: h.value * w.value].reshape(h.value, w.value).copy()


def native_read_fn(path: Path) -> Optional[np.ndarray]:
    """``read_fn``-compatible decode (``FrameStream``, ``AsyncIngestionPipeline``)."""
    return decode_gray(path)


class NativeLoaderStats(NamedTuple):
    decoded: int
    failed: int
    consumer_wait_s: float
    worker_wait_s: float


class LoadedFrame(NamedTuple):
    index: int
    frame: Optional[np.ndarray]  # None when decode failed
    status: str  # "ok" or a decode error name


class NativeFrameLoader:
    """C++ decode pool with strict in-order delivery and backpressure.

    Worker threads live in C++; frames arrive in sequence order whatever
    order the decodes finish in, and at most ``capacity`` frames are
    buffered (a slot ring, allocated once).

    Usage::

        with NativeFrameLoader(paths, workers=4) as loader:
            for item in loader:   # LoadedFrame, in path order
                ...
    """

    def __init__(
        self,
        paths: Sequence[Path | str],
        workers: int = 4,
        capacity: int = 16,
        max_h: int = DEFAULT_MAX_H,
        max_w: int = DEFAULT_MAX_W,
    ) -> None:
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable (no working C++ compiler)")
        if capacity <= 0 or workers <= 0:
            raise ValueError("workers and capacity must be positive")
        self._lib = lib
        self._paths = [str(p) for p in paths]
        self._max_h = int(max_h)
        self._max_w = int(max_w)
        encoded = [p.encode() for p in self._paths]
        arr = (ctypes.c_char_p * len(encoded))(*encoded) if encoded else (ctypes.c_char_p * 1)()
        self._handle = lib.mvn_loader_create(arr, len(encoded), int(workers), int(capacity), self._max_h, self._max_w)
        if not self._handle:
            raise RuntimeError("mvn_loader_create failed")
        self._out = np.empty(self._max_h * self._max_w, dtype=np.uint8)  # rows packed at stride w
        self._closed = False

    def __enter__(self) -> "NativeFrameLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Stop the workers (those blocked on backpressure included) and
        free the loader."""
        if not self._closed:
            self._lib.mvn_loader_destroy(self._handle)
            self._closed = True

    def __del__(self) -> None:
        if getattr(self, "_handle", None) and not getattr(self, "_closed", True):
            self.close()

    def __iter__(self) -> Iterator[LoadedFrame]:
        index = ctypes.c_int32(0)
        h = ctypes.c_int32(0)
        w = ctypes.c_int32(0)
        status = ctypes.c_int32(0)
        out_ptr = _ptr(self._out, ctypes.c_uint8)
        while not self._closed:
            rc = self._lib.mvn_loader_next(
                self._handle, out_ptr, ctypes.byref(index), ctypes.byref(h), ctypes.byref(w), ctypes.byref(status)
            )
            if rc == 0:
                return
            if status.value == 0:
                frame = self._out[: h.value * w.value].reshape(h.value, w.value).copy()
                yield LoadedFrame(index=index.value, frame=frame, status="ok")
            else:
                yield LoadedFrame(index=index.value, frame=None, status=_DECODE_ERRORS.get(status.value, "unknown_error"))

    def stats(self) -> NativeLoaderStats:
        if self._closed:
            raise RuntimeError("the loader is closed; read its stats before close()")
        vals = [ctypes.c_int64(0) for _ in range(4)]
        self._lib.mvn_loader_stats(self._handle, *(ctypes.byref(v) for v in vals))
        decoded, failed, cw, ww = (v.value for v in vals)
        return NativeLoaderStats(decoded=decoded, failed=failed, consumer_wait_s=cw / 1e9, worker_wait_s=ww / 1e9)


__all__ = [
    "native_available",
    "hamming_match",
    "decode_gray",
    "native_read_fn",
    "NativeFrameLoader",
    "NativeLoaderStats",
    "LoadedFrame",
    "DEFAULT_MAX_H",
    "DEFAULT_MAX_W",
]
