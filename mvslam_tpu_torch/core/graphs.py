"""Captured CUDA graphs: a per-device LRU of captured entries, keyed by
what a capture depends on.

A stage of PyTorch operations with static shapes and no host
synchronisation can be captured once into a CUDA graph and replayed in
place of its eager launches: a graph replays the kernels it captured in
their order, so every output bit is the eager stage's. Where such a stage
is hundreds or thousands of small operations, the host's launches set its
pace and a replay takes them away.

:class:`GraphCache` keeps the entries, per device, the least recently used
evicted first, and records a ``<span>_capture`` span around each capture
(the signature in its metadata) and a ``<span>_replay`` span around each
call that replays. A subclass says what an entry holds and how a call
replays it. Inside :meth:`GraphCache.captures_closed` a call with a new
signature captures nothing and returns None, and its caller runs the eager
stage: another thread may launch on the device then, and no capture may
run beside it. :func:`capture` captures stages the way every entry is
captured.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from mvslam_tpu_torch.core.telemetry import RunTelemetryRecorder, timed_event


def signature(tensors, *configs) -> Tuple:
    """What a captured stage depends on: every input's device, shape and
    dtype, and the (frozen, hashable) configs. Equal configs give equal
    signatures."""
    return tuple((t.device, tuple(t.shape), t.dtype) for t in tensors) + configs


def _describe(sig: Tuple, num_tensors: int) -> dict:
    """A signature as JSON-ready span metadata."""
    tensors, configs = sig[:num_tensors], sig[num_tensors:]

    def plain(c):
        if dataclasses.is_dataclass(c):
            return dataclasses.asdict(c)
        return [plain(x) for x in c] if isinstance(c, tuple) else c

    return {
        "device": str(tensors[0][0]),
        "inputs": [[list(shape), str(dtype).replace("torch.", "")] for _, shape, dtype in tensors],
        "configs": plain(configs),
    }


def _flatten(tree) -> List[torch.Tensor]:
    """The tensor leaves of a (nested) NamedTuple, in field order."""
    if isinstance(tree, tuple):
        return [leaf for item in tree for leaf in _flatten(item)]
    return [tree]


def _unflatten(template, leaves: Iterator[torch.Tensor]):
    """A tree shaped like ``template`` with its leaves taken in order."""
    if isinstance(template, tuple):
        return type(template)(*(_unflatten(item, leaves) for item in template))
    return next(leaves)


def _pack(tree) -> Tuple[torch.Tensor, List[tuple]]:
    """Every leaf's bytes in one uint8 buffer, the widest dtypes first so
    that each leaf starts at a multiple of its element size; the layout
    gives each leaf's (start, end, dtype, shape), in leaf order."""
    leaves = _flatten(tree)
    order = sorted(range(len(leaves)), key=lambda i: -leaves[i].element_size())
    layout: List[Optional[tuple]] = [None] * len(leaves)
    parts, offset = [], 0
    for i in order:
        leaf = leaves[i]
        part = leaf.reshape(-1).view(torch.uint8)
        layout[i] = (offset, offset + part.numel(), leaf.dtype, leaf.shape)
        offset += part.numel()
        parts.append(part)
    return torch.cat(parts), layout


def static_copies(inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Device copies of ``inputs`` that a graph reads and each replay
    overwrites."""
    return [torch.empty(x.shape, dtype=x.dtype, device=x.device).copy_(x) for x in inputs]


def capture(device, stages: Sequence[Callable[[Any], Any]]) -> Tuple[List[torch.cuda.CUDAGraph], List[Any]]:
    """Each of ``stages`` captured into a CUDA graph of one memory pool, in
    order (they must replay in that order); stage i is called with stage
    i−1's output, the first with None. Returns the graphs and the outputs
    the captures left in the pool, which each replay overwrites.

    The stages run once eagerly first, on the capture's side stream, so
    that cuBLAS, cuSOLVER and the sorts allocate their workspaces outside
    the capture."""
    with torch.cuda.device(device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            out = None
            for stage in stages:
                out = stage(out)
        torch.cuda.current_stream(device).wait_stream(side)
        graphs, outputs, out, pool = [], [], None, None
        for stage in stages:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, stream=side, capture_error_mode="thread_local"):
                out = stage(out)
            pool = graph.pool() if pool is None else pool
            graphs.append(graph)
            outputs.append(out)
    return graphs, outputs


class GraphCache:
    """Per-device LRU of captured entries; one instance is shared by every
    caller in the process, as the device's memory is: callers with one
    signature share one entry. Each call holds the cache's lock through its
    capture and replay."""

    ENTRIES_PER_DEVICE = 4

    def __init__(self, span: str) -> None:
        self._span = span
        self._entries: Dict[torch.device, "OrderedDict[Tuple, Any]"] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    @contextmanager
    def captures_closed(self) -> Iterator[None]:
        """While open, calls on this thread replay the entries there are
        and return None for a new signature, capturing nothing."""
        before = getattr(self._local, "closed", False)
        self._local.closed = True
        try:
            yield
        finally:
            self._local.closed = before

    def entries(self, device) -> List[Tuple]:
        """The signatures held for ``device``, least recently used first."""
        with self._lock:
            return list(self._entries.get(torch.device(device), ()))

    def _call(self, device, sig: Tuple, num_tensors: int, capture_entry: Callable[[], Any],
              replay: Callable[[Any], Any], recorder: Optional[RunTelemetryRecorder]):
        """``replay(entry)`` of the signature's entry on ``device``,
        captured first by ``capture_entry()`` where the signature is new;
        None where a new signature may not be captured. ``num_tensors``:
        how many of the signature's items describe input tensors."""
        with self._lock:
            entries = self._entries.setdefault(torch.device(device), OrderedDict())
            entry = entries.get(sig)
            if entry is None:
                if getattr(self._local, "closed", False):
                    return None
                with timed_event(recorder, f"{self._span}_capture", metadata=_describe(sig, num_tensors)):
                    entry = capture_entry()
                entries[sig] = entry
                while len(entries) > self.ENTRIES_PER_DEVICE:
                    entries.popitem(last=False)
            else:
                entries.move_to_end(sig)
            with timed_event(recorder, f"{self._span}_replay"):
                return replay(entry)
