"""Single-loader-thread frame streaming with a bounded ring buffer.

Parity: reference ``frame_stream.py`` — one background thread decodes
frames (cv2.imread or an injected ``read_fn``) into a bounded thread-safe
ring buffer; the consumer iterates :class:`FramePacket`s in order;
backpressure drops the oldest buffered frame and counts it.

This is host-side I/O; the windowed device-batch engine
(``slam.api.SLAMSystem._run_windowed``) consumes it.

Port of ``mvslam_tpu/runtime/frame_stream.py``. The JAX package's default
reader decodes with its C++ PNG/PGM decoder, which the port does not build
yet (ROADMAP step 14): until then :class:`FrameStream` needs an explicit
``read_fn`` and raises ``NotImplementedError`` without one.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Iterator, List, Optional, Sequence

import numpy as np


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


class BoundedRingBuffer:
    """Thread-safe bounded buffer; push drops the oldest when full.

    Parity: ``frame_stream.py:61-111``.
    """

    def __init__(self, capacity: int) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._items: deque = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
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

    def pop(self, timeout: Optional[float] = None) -> Optional[Any]:
        with self._not_empty:
            if not self._items:
                self._not_empty.wait(timeout)
            if not self._items:
                return None
            return self._items.popleft()

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


class FrameStream:
    """Iterate frames loaded by one background thread.

    Parity: ``frame_stream.py:123-211``. ``read_fn(path)`` decodes one
    frame (None on failure); it is required until the port has a decoder
    of its own (ROADMAP step 14).
    """

    def __init__(
        self,
        paths: Sequence[Path],
        timestamps: Optional[Sequence[float]] = None,
        buffer_size: int = 8,
        read_fn: Optional[Callable[[Path], Optional[np.ndarray]]] = None,
        drop_on_backpressure: bool = False,
    ) -> None:
        self.paths = [Path(p) for p in paths]
        self.timestamps = list(timestamps) if timestamps is not None else [float(i) for i in range(len(self.paths))]
        if len(self.timestamps) != len(self.paths):
            raise ValueError("timestamps must match paths length")
        if read_fn is None:
            raise NotImplementedError(
                "FrameStream needs an explicit read_fn: the port's default frame decoder "
                "(the C++ PNG/PGM decoder) comes with ROADMAP step 14"
            )
        self.read_fn = read_fn
        self.drop_on_backpressure = drop_on_backpressure
        self.stats = FrameStreamStats()
        self._buffer = BoundedRingBuffer(buffer_size)
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _run_loader(self) -> None:
        for index, path in enumerate(self.paths):
            frame = None
            try:
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
            else:
                # Block politely until there is room.
                while len(self._buffer) >= self._buffer.capacity and not self._done.is_set():
                    time.sleep(0.0005)
                if self._done.is_set():
                    return
                self._buffer.push(packet)
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
