"""Build the port's CUDA kernels (nvcc → shared object) and load them.

All kernels in ``csrc/*.cu`` compile into ONE shared library with a plain
C interface, loaded with ``ctypes``: no PyTorch headers, so the build takes
seconds. The library is built at first use into ``mvslam_tpu_torch/_build/``
(git-ignored), keyed by a SHA-256 of the sources, the nvcc command and the
nvcc version, so a source edit triggers exactly one rebuild.

There is no fallback: a missing ``nvcc`` or a failed build raises, because
only CUDA tensors reach this module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[1]
_CSRC = _PKG_DIR / "csrc"
_BUILD_DIR = _PKG_DIR / "_build"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
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
    # Build to a temp name, then rename: concurrent builders race benignly.
    with tempfile.NamedTemporaryFile(dir=_BUILD_DIR, suffix=".so", delete=False) as tmp:
        tmp_path = Path(tmp.name)
    cmd = [nvcc, *_NVCC_FLAGS, "-o", str(tmp_path), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        tmp_path.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{proc.stderr[-4000:]}")
    tmp_path.replace(out)
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


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
