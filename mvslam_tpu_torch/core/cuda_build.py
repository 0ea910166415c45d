"""Build the port's CUDA kernels (nvcc → shared object) and load them.

All kernels in ``csrc/*.cu`` compile into ONE shared library with a plain
C interface, loaded with ``ctypes``: no PyTorch headers, so the build takes
seconds (one nvcc per source, all started together, then one link). The
library is built at first use into ``mvslam_tpu_torch/_build/``
(git-ignored), keyed by a SHA-256 of the sources, the nvcc command and the
nvcc version, so a source edit triggers exactly one rebuild.

There is no fallback: a missing ``nvcc`` or a failed build raises, because
only CUDA tensors reach this module.

:func:`launch` is the launch path every kernel wrapper shares: it switches
devices only when the tensors are not on the current one, takes the raw
handle of the current stream, calls the entry point, raises on a refused
launch and counts it. A wrapper calls it once per kernel launch (LK calls
K2 thirty times a frame), so it costs a few microseconds of host time and
builds nothing per call that can be built once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from functools import lru_cache
from pathlib import Path

import torch

_PKG_DIR = Path(__file__).resolve().parents[1]
_CSRC = _PKG_DIR / "csrc"
_BUILD_DIR = _PKG_DIR / "_build"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes. Every entry point returns the
# cudaError_t of its launch (0 = success).
_SIGNATURES = {
    # img, det, raw, B, H, W, threshold, margin, stream
    "fast_detect_u8": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "fast_detect_f32": [_P, _P, _P, _I, _I, _I, _F, _I, _P],
    # img, xy, out, B, H, W, N, stream
    "extract_patches_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "extract_patches_bf16": [_P, _P, _P, _I, _I, _I, _I, _P],
}


def _sources() -> list:
    return sorted(_CSRC.glob("*.cu"))


def nvcc_path() -> str:
    """The nvcc binary (``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or PATH)."""
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin, PATH): "
        "the CUDA kernels cannot be built"
    )


def _build_key(nvcc: str) -> str:
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True).stdout
    digest = hashlib.sha256(version.encode())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    for src in _sources() + sorted(_CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return digest.hexdigest()[:16]


def build() -> Path:
    """Compile the kernel library if it is not built yet; return its path."""
    nvcc = nvcc_path()
    out = _BUILD_DIR / f"libmvslam_kernels_{_build_key(nvcc)}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build in a temp directory, then rename: concurrent builders race benignly.
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        objects, procs = [], []
        for src in _sources():
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            procs.append((cmd, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)))
            objects.append(str(obj))
        try:
            for cmd, proc in procs:
                _, stderr = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{stderr[-4000:]}")
        finally:
            for _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        lib = Path(tmp) / out.name
        cmd = [nvcc, "-shared", "-o", str(lib), *objects]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{proc.stderr[-4000:]}")
        lib.replace(out)
    return out


@lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with argtypes set.

    Cached for the life of the process: the first call pays the build.
    """
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


_ENTRIES: dict = {}  # entry point name -> ctypes function, filled at the first launch
# Launches come from any thread (the feature plane's assembler among them).
_COUNT_LOCK = threading.Lock()
# The launch counters' keys hold dtypes by name, as ``str(dtype)`` gives it.
DTYPE_NAMES = {dtype: str(dtype) for dtype in (torch.uint8, torch.float32, torch.bfloat16)}


def launch(wrapper, name: str, shape_key: tuple, device_index: int, *args) -> None:
    """Launch entry point ``name`` with ``args`` on the current stream of
    CUDA device ``device_index`` (the stream is the last C argument), raise
    if the launch was refused, then count it on ``wrapper``: ``launches``
    and ``launch_shapes[shape_key]``."""
    fn = _ENTRIES.get(name)
    if fn is None:
        lib = load()
        _ENTRIES.update((entry, getattr(lib, entry)) for entry in _SIGNATURES)
        fn = _ENTRIES[name]
    if device_index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(device_index))
    else:
        with torch.cuda.device(device_index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(device_index))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
    with _COUNT_LOCK:
        wrapper.launches += 1
        wrapper.launch_shapes[shape_key] += 1
