"""Build the port's C++ host library (g++ → shared object).

The library is compiled on demand into ``mvslam_tpu_torch/_build/``
(git-ignored) as ``libmvslam_native_<key>.so``. The key is a SHA-256 of
the source, the compiler and its version, the flags actually used and, for
the ``-march=native`` build, the host CPU's identity (machine and the
``flags`` line of ``/proc/cpuinfo``): a binary tuned for one CPU is never
loaded on a host that lacks its instructions, and the generic fallback
build has a key of its own. Plain g++ + zlib, loaded with ctypes; no
libpng, no pybind11.

Run ``python -m mvslam_tpu_torch.native.build`` to build it ahead of use.
"""

from __future__ import annotations

import hashlib
import logging
import os
import platform
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path
from typing import List, Optional

logger = logging.getLogger(__name__)

_NATIVE_DIR = Path(__file__).resolve().parent
SOURCE = _NATIVE_DIR / "src" / "mvslam_native.cc"
_BUILD_DIR = _NATIVE_DIR.parent / "_build"

_CXX_FLAGS = ["-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC", "-fvisibility=hidden", "-Wall", "-pthread"]
# Host-tuned ISA for the Hamming matcher's popcount loop (AVX-512 VPOPCNTQ
# where the CPU has it). Tried first; if the compiler rejects it, build()
# retries with the generic flag set.
NATIVE_ARCH = ["-march=native"]
GENERIC_ARCH: List[str] = []
_LIBS = ["-lz"]


def cpu_identity() -> str:
    """The machine and a digest of the CPU's feature flags."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as fh:
            flags = next((line for line in fh if line.startswith("flags")), "")
    except OSError:
        flags = platform.processor()
    return f"{platform.machine()}:{hashlib.sha256(flags.encode()).hexdigest()[:16]}"


@lru_cache(maxsize=1)
def _compiler() -> Optional[tuple]:
    """(compiler, its ``--version`` line) of the first one that runs."""
    for cand in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if not cand:
            continue
        try:
            proc = subprocess.run([cand, "--version"], capture_output=True, text=True, check=True)
        except (OSError, subprocess.CalledProcessError):
            continue
        return cand, proc.stdout.splitlines()[0] if proc.stdout else ""
    return None


def build_key(arch: List[str], cxx: str = "g++", version: str = "") -> str:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join([cxx, version, *_CXX_FLAGS, *arch, *_LIBS]).encode())
    if arch:  # a host-tuned binary is valid only on this CPU
        digest.update(cpu_identity().encode())
    return digest.hexdigest()[:16]


def library_path(arch: List[str]) -> Optional[Path]:
    """Where the library built with ``arch`` lives (it may not exist yet);
    None without a compiler."""
    cc = _compiler()
    if cc is None:
        return None
    return _BUILD_DIR / f"libmvslam_native_{build_key(arch, *cc)}.so"


def _compile(cxx: str, arch: List[str], out: Path) -> bool:
    """Compile to a temporary name, then rename: concurrent builders (test
    workers, parallel runs) race benignly, since rename is atomic on POSIX."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.NamedTemporaryFile(dir=_BUILD_DIR, suffix=".so", delete=False) as tmp:
        tmp_path = Path(tmp.name)
    cmd = [cxx, *_CXX_FLAGS, *arch, "-o", str(tmp_path), str(SOURCE), *_LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        tmp_path.unlink(missing_ok=True)
        logger.warning("native build failed to launch: %s", exc)
        return False
    if proc.returncode != 0:
        tmp_path.unlink(missing_ok=True)
        logger.warning("native build with %s failed:\n%s", arch or "generic flags", proc.stderr[-4000:])
        return False
    tmp_path.replace(out)
    logger.info("built native library: %s", out)
    return True


def build(force: bool = False) -> Optional[Path]:
    """Compile the library if needed; return its path, or None when no
    compiler works (the compiler's stderr is logged)."""
    cc = _compiler()
    if cc is None:
        logger.warning("no C++ compiler found; the native host library is unavailable")
        return None
    cxx = cc[0]
    targets = [(arch, library_path(arch)) for arch in (NATIVE_ARCH, GENERIC_ARCH)]
    if not force:
        for _, path in targets:
            if path.exists():
                return path
    for arch, path in targets:
        if _compile(cxx, arch, path):
            return path
    return None


def main() -> int:
    logging.basicConfig(level=logging.INFO)
    path = build(force=True)
    if path is None:
        print("native build FAILED")
        return 1
    print(f"native build ok: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
