"""Captured CUDA graphs of the tracking step's match and pose stages.

``slam.tracking._track_pairs`` runs two stages over a batch of frame pairs:
``match`` (matching, selection, gathering the matched points) and ``pose``
(the dual-model pose estimate through the packed outputs). Together they
are ~4,400 small PyTorch operations a 16-pair window, with static shapes
and no host synchronisation; launched one by one, the host's launches set
the pace. On a CUDA device :class:`PairGraphs` captures each stage once
per input signature into a CUDA graph and replays the two in place of the
eager launches. A graph replays the kernels it captured in their order, so
every output bit is the eager stages'.

An entry holds the two graphs (one memory pool: they always replay in the
order they were captured), static copies of the inputs, and every output
packed byte for byte into one buffer. A call copies its inputs in, replays
both graphs on the caller's current stream and clones the packed outputs
before it returns, so no result aliases the static buffers that the next
replay overwrites. Entries are keyed by :func:`signature` and kept per
device, the least recently used evicted first. An entry reserves ~1.05 GB
of device memory at 16 pairs of 2,048 features, mostly for the stages'
peak intermediates (the 16 x 2,048 x 2,048 distance matrices); ~40 MB of
it stays allocated, the static inputs and outputs (PERF.md).

A new signature is captured at its first call: its eager stages run once
on a side stream, so that cuBLAS and the sorts allocate their workspaces
before the capture, then each stage is captured on that stream. Inside
:meth:`PairGraphs.captures_closed` a call with a new signature runs the
eager stages instead: another thread may launch on the device then
(``SLAMSystem.run_stream_async``'s feature plane), and no capture may run
beside it.

Spans: ``pair_graph_capture`` around each capture (the signature in its
metadata) and ``pair_graph_replay`` around each call that replays, both
stages' ``device_span``\\ s inside it.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

from mvslam_tpu_torch.core.telemetry import RunTelemetryRecorder, device_span, timed_event
from mvslam_tpu_torch.frontend.feature_pipeline import FeatureSet


def signature(tensors, *configs) -> Tuple:
    """What a captured stage pair depends on: every input's device, shape
    and dtype, and the (frozen, hashable) configs. Equal configs give equal
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


class _Entry:
    """One signature's two graphs and the buffers they read and write."""

    def __init__(self, inputs, matched, template, packed, layout, match_graph, pose_graph):
        self.inputs = inputs  # static copies, in the order of the call's inputs
        self.matched = matched  # the match graph's outputs, which the pose graph reads
        self.template = template  # the pose graph's output tree
        self.packed = packed
        self.layout = layout
        self.match_graph = match_graph
        self.pose_graph = pose_graph
        self.stream: Optional[torch.cuda.Stream] = None  # the stream of the last replay


class PairGraphs:
    """Per-device LRU of captured (match, pose) stage pairs.

    ``match_stage(f1, f2, *match_args)`` returns what
    ``pose_stage(keys, f2, K, matched, pose_config)`` reads; the feature
    sets need only ``xy``, ``descriptors`` and ``valid``. The instance is
    shared by every caller in the process, as the device's memory is:
    callers with one signature share one entry.
    """

    ENTRIES_PER_DEVICE = 4

    def __init__(self, match_stage: Callable, pose_stage: Callable) -> None:
        self._match_stage = match_stage
        self._pose_stage = pose_stage
        self._entries: Dict[torch.device, "OrderedDict[Tuple, _Entry]"] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    @contextmanager
    def captures_closed(self) -> Iterator[None]:
        """While open, calls on this thread replay the entries there are
        and run the eager stages for a new signature, capturing nothing."""
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

    def track(self, keys, f1, f2, K, match_args: tuple, pose_config, recorder: Optional[RunTelemetryRecorder] = None):
        """Both stages by replay (capturing a new signature first), or None
        where a new signature may not be captured: the caller then runs
        the eager stages."""
        inputs = (keys, f1.xy, f1.descriptors, f1.valid, f2.xy, f2.descriptors, f2.valid, K)
        sig = signature(inputs, match_args, pose_config)
        device = keys.device
        with self._lock:
            entries = self._entries.setdefault(device, OrderedDict())
            entry = entries.get(sig)
            if entry is None:
                if getattr(self._local, "closed", False):
                    return None
                meta = _describe(sig, len(inputs))
                with timed_event(recorder, "pair_graph_capture", metadata=meta):
                    entry = self._capture(inputs, match_args, pose_config)
                entries[sig] = entry
                while len(entries) > self.ENTRIES_PER_DEVICE:
                    entries.popitem(last=False)
            else:
                entries.move_to_end(sig)
            with timed_event(recorder, "pair_graph_replay"):
                return self._replay(entry, inputs, recorder)

    def _capture(self, inputs, match_args, pose_config) -> _Entry:
        device = inputs[0].device
        with torch.cuda.device(device):
            static = [torch.empty(x.shape, dtype=x.dtype, device=device).copy_(x) for x in inputs]
            keys, x1, d1, v1, x2, d2, v2, K = static
            f1, f2 = FeatureSet(x1, None, d1, None, v1), FeatureSet(x2, None, d2, None, v2)
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):  # the warm-up: workspaces allocated outside the capture
                self._pose_stage(keys, f2, K, self._match_stage(f1, f2, *match_args), pose_config)
            torch.cuda.current_stream(device).wait_stream(side)
            match_graph, pose_graph = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
            with torch.cuda.graph(match_graph, stream=side, capture_error_mode="thread_local"):
                matched = self._match_stage(f1, f2, *match_args)
            with torch.cuda.graph(pose_graph, pool=match_graph.pool(), stream=side, capture_error_mode="thread_local"):
                template = self._pose_stage(keys, f2, K, matched, pose_config)
                packed, layout = _pack(template)
        return _Entry(static, matched, template, packed, layout, match_graph, pose_graph)

    def _replay(self, entry: _Entry, inputs, recorder):
        device = inputs[0].device
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device)
            if entry.stream is not None and entry.stream != stream:
                stream.wait_stream(entry.stream)  # the last replay's use of the static buffers first
            entry.stream = stream
            with device_span(recorder, "match", device):
                for static, x in zip(entry.inputs, inputs):
                    static.copy_(x)
                entry.match_graph.replay()
            with device_span(recorder, "pose", device):
                entry.pose_graph.replay()
                out = entry.packed.clone()
        return _unflatten(entry.template, (out[a:b].view(dtype).view(shape) for a, b, dtype, shape in entry.layout))
