"""Multi-stage async decode pipeline.

Port of ``mvslam_tpu/runtime/ingestion.py`` over the port's own decoder
(``runtime.frame_stream._default_read_fn``: the native C++ decoder, then
numpy + zlib, then cv2 or Pillow for other formats). Parity:
reference ``ingestion_pipeline.py`` — producer thread → N decode
workers (threads, or a ProcessPoolExecutor behind dispatcher/collector
threads — the only cross-process boundary) → output queue →
deterministic reorder buffer → ordered ``FramePacket`` iteration; decode
retries with jittered backoff (ref L718-730), circuit breaker on the
decode stage (ref L200, L480-523), adaptive queues + dynamic worker
scaling via the stage supervisor, drop markers, an
``IngestionFailureReport`` and a ``health_snapshot`` (ref L247-286).

Decode is host CPU work; this pipeline feeds ``SLAMSystem.run_stream``
(the runner's ``async`` mode). The process pool starts its workers with
``spawn``, not Linux's default ``fork``: the parent holds a CUDA context
and live threads, which a forked child would inherit half-copied. The
decode task is a top-level function of this module, which imports no
torch code of its own, so a worker initialises no CUDA.
"""

from __future__ import annotations

import multiprocessing
import random
import threading
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from mvslam_tpu_torch.runtime.frame_stream import FramePacket, _default_read_fn, _native_decoder
from mvslam_tpu_torch.runtime.ingestion_control import (
    AdaptiveBoundedQueue,
    CircuitBreaker,
    CircuitBreakerConfig,
    DeterministicEventLog,
    DeterministicReorderBuffer,
    DynamicWorkerPool,
    IngestionFailureReport,
    OrderingBufferConfig,
    QueueTuningConfig,
    RetryPolicyConfig,
    StageSupervisor,
    WorkerPoolConfig,
)

_SENTINEL = object()


@dataclass(frozen=True)
class IngestionPipelineConfig:
    """Parity: ``ingestion_pipeline.py:71-124``."""

    num_workers: int = 2
    use_process_pool: bool = False
    queue_capacity: int = 8
    retry: RetryPolicyConfig = RetryPolicyConfig()
    breaker: CircuitBreakerConfig = CircuitBreakerConfig()
    ordering: OrderingBufferConfig = OrderingBufferConfig()
    queue_tuning: QueueTuningConfig = QueueTuningConfig()
    worker_pool: WorkerPoolConfig = WorkerPoolConfig()
    supervise: bool = True
    output_timeout_s: float = 0.05


def _decode_task(path_str: str) -> Optional[np.ndarray]:
    """Top-level function so the process pool can pickle it."""
    return _default_read_fn(Path(path_str))


class AsyncIngestionPipeline:
    """Iterate decoded frames in order, decoded by a supervised worker set.

    Parity: ``ingestion_pipeline.py:161-798``.
    """

    def __init__(
        self,
        paths: Sequence[Path],
        timestamps: Optional[Sequence[float]] = None,
        config: Optional[IngestionPipelineConfig] = None,
        read_fn: Optional[Callable[[Path], Optional[np.ndarray]]] = None,
    ) -> None:
        self.paths = [Path(p) for p in paths]
        self.timestamps = (
            list(timestamps) if timestamps is not None else [0.1 * i for i in range(len(self.paths))]
        )
        if len(self.timestamps) != len(self.paths):
            raise ValueError("timestamps must match paths length")
        self.config = config or IngestionPipelineConfig()
        self.read_fn = read_fn or _default_read_fn
        if self.config.use_process_pool and read_fn is not None:
            raise ValueError("injected read_fn is incompatible with the process pool")
        if read_fn is None:
            _native_decoder()  # builds the default reader's library now (the pool's workers load it)

        self.entry_queue = AdaptiveBoundedQueue(self.config.queue_capacity)
        self.output_queue = AdaptiveBoundedQueue(self.config.queue_capacity)
        self.reorder = DeterministicReorderBuffer(self.config.ordering)
        self.breaker = CircuitBreaker(self.config.breaker)
        self.events = DeterministicEventLog()
        self.report = IngestionFailureReport()
        self.worker_pool = DynamicWorkerPool(self.config.worker_pool)
        self.supervisor = StageSupervisor(
            self.entry_queue, self.worker_pool, self.config.queue_tuning, self.events
        )
        self._threads: List[threading.Thread] = []
        self._producer_done = threading.Event()
        self._workers_done = 0
        self._workers_lock = threading.Lock()
        self._stop = threading.Event()
        self._started = False

    # -- stages ---------------------------------------------------------

    def _run_producer(self) -> None:
        for index, path in enumerate(self.paths):
            if self._stop.is_set():
                break
            while not self.entry_queue.put((index, path), timeout=0.1):
                if self._stop.is_set():
                    break
        self._producer_done.set()

    def _decode_with_retries(self, path: Path) -> Optional[np.ndarray]:
        """Parity: ``ingestion_pipeline.py:718-730``."""
        retry = self.config.retry
        for attempt in range(1, retry.max_attempts + 1):
            try:
                frame = self.read_fn(path)
            except Exception:
                frame = None
            if frame is not None:
                return frame
            if attempt < retry.max_attempts:
                self.report.retries += 1
                time.sleep(retry.backoff_base_s * attempt + random.random() * retry.backoff_jitter_s)
        return None

    def _finish_worker(self) -> None:
        with self._workers_lock:
            self._workers_done += 1
            if self._workers_done >= len([t for t in self._threads if t.name.startswith("decode")]):
                self.output_queue.put(_SENTINEL, timeout=5.0)

    def _run_decoder(self) -> None:
        """Parity: ``ingestion_pipeline.py:464-556``."""
        while not self._stop.is_set():
            ok, item = self.entry_queue.get(timeout=0.05)
            if not ok:
                if self._producer_done.is_set() and len(self.entry_queue) == 0:
                    break
                continue
            index, path = item
            if not self.breaker.allow():
                self.report.dropped += 1
                self.events.emit("frame_dropped", message="circuit_breaker_open", index=index)
                self.output_queue.put((index, None), timeout=1.0)
                continue
            frame = self._decode_with_retries(path)
            if frame is None:
                self.breaker.record_failure()
                self.report.record_failure("decode_failed")
                if self.breaker.state == "open":
                    self.report.breaker_trips = self.breaker.trip_count
                    self.events.emit("breaker_open", message=str(path), index=index)
                self.output_queue.put((index, None), timeout=1.0)
            else:
                self.breaker.record_success()
                self.report.decoded += 1
                self.output_queue.put((index, frame), timeout=5.0)
        self._finish_worker()

    def _run_process_dispatcher(self, executor: ProcessPoolExecutor) -> None:
        """Dispatcher + collector around the process pool.

        Parity: ``ingestion_pipeline.py:558-716`` (the only cross-process
        boundary; frames return as arrays through pickle).
        """
        from concurrent.futures import FIRST_COMPLETED, wait

        inflight = {}
        max_inflight = self.config.num_workers * 2
        while not self._stop.is_set():
            while len(inflight) < max_inflight:
                ok, item = self.entry_queue.get(timeout=0.02)
                if not ok:
                    break
                index, path = item
                if not self.breaker.allow():
                    self.report.dropped += 1
                    self.output_queue.put((index, None), timeout=1.0)
                    continue
                inflight[executor.submit(_decode_task, str(path))] = index
            if not inflight:
                if self._producer_done.is_set() and len(self.entry_queue) == 0:
                    break
                continue
            done, _ = wait(list(inflight), timeout=0.1, return_when=FIRST_COMPLETED)
            for future in done:
                index = inflight.pop(future)
                try:
                    frame = future.result()
                except Exception:
                    frame = None
                if frame is None:
                    self.breaker.record_failure()
                    self.report.record_failure("decode_failed")
                    self.output_queue.put((index, None), timeout=1.0)
                else:
                    self.breaker.record_success()
                    self.report.decoded += 1
                    self.output_queue.put((index, frame), timeout=5.0)
        self.output_queue.put(_SENTINEL, timeout=5.0)

    # -- public ------------------------------------------------------------

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        producer = threading.Thread(target=self._run_producer, name="ingest-producer", daemon=True)
        self._threads.append(producer)
        if self.config.use_process_pool:
            self._executor = ProcessPoolExecutor(
                max_workers=self.config.num_workers, mp_context=multiprocessing.get_context("spawn")
            )
            dispatcher = threading.Thread(
                target=self._run_process_dispatcher,
                args=(self._executor,),
                name="ingest-dispatcher",
                daemon=True,
            )
            self._threads.append(dispatcher)
        else:
            for k in range(self.config.num_workers):
                self._threads.append(
                    threading.Thread(target=self._run_decoder, name=f"decode-{k}", daemon=True)
                )
        for t in self._threads:
            t.start()

    def __iter__(self) -> Iterator[FramePacket]:
        """Parity: ``ingestion_pipeline.py:329-368``."""
        self.start()
        finished = False
        ticks = 0
        try:
            while not finished or len(self.reorder) > 0:
                if not finished:
                    ok, item = self.output_queue.get(timeout=self.config.output_timeout_s)
                    if ok:
                        if item is _SENTINEL:
                            finished = True
                        else:
                            index, frame = item
                            self.reorder.push(index, frame)
                    ticks += 1
                    if self.config.supervise and ticks % 8 == 0:
                        self.supervisor.tick()
                ready = self.reorder.pop_ready() if not finished else self.reorder.flush_all()
                for seq, frame in ready:
                    if frame is None:
                        self.report.dropped += 1
                        self.events.emit("frame_dropped", message="decode_failed", index=seq)
                        continue
                    yield FramePacket(
                        index=seq,
                        timestamp=self.timestamps[seq] if seq < len(self.timestamps) else 0.0,
                        frame=np.asarray(frame),
                        path=self.paths[seq] if seq < len(self.paths) else None,
                    )
            self.report.forced_flushes = self.reorder.forced_flushes
        finally:
            self.close()

    def close(self) -> None:
        self._stop.set()
        if self.config.use_process_pool and hasattr(self, "_executor"):
            # Waits for the workers to exit: no decode process outlives the pipeline.
            self._executor.shutdown(wait=True, cancel_futures=True)
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads.clear()

    def failure_report(self) -> IngestionFailureReport:
        self.report.forced_flushes = self.reorder.forced_flushes
        self.report.breaker_trips = self.breaker.trip_count
        return self.report

    def health_snapshot(self) -> Dict[str, Any]:
        """Parity: ``ingestion_pipeline.py:247-286``."""
        return {
            "stage": "ingestion",
            "state": "tripped" if self.breaker.state == "open" else "healthy",
            "entry_queue_depth": len(self.entry_queue),
            "output_queue_depth": len(self.output_queue),
            "entry_capacity": self.entry_queue.capacity,
            "breaker_state": self.breaker.state,
            "decoded": self.report.decoded,
            "failed": self.report.failed,
            "dropped": self.report.dropped,
            "retries": self.report.retries,
            "workers_target": self.worker_pool.target,
        }
