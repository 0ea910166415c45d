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
replay overwrites. Entries are keyed by the inputs' signature and kept
per device, the least recently used evicted first (``core/graphs.py``'s
:class:`GraphCache`, as window BA's graphs are). An entry reserves ~1.05 GB
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

from typing import Callable, Optional

import torch

from mvslam_tpu_torch.core.graphs import GraphCache, _pack, _unflatten, capture, signature, static_copies
from mvslam_tpu_torch.core.telemetry import RunTelemetryRecorder, device_span
from mvslam_tpu_torch.frontend.feature_pipeline import FeatureSet


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


class PairGraphs(GraphCache):
    """Per-device LRU of captured (match, pose) stage pairs.

    ``match_stage(f1, f2, *match_args)`` returns what
    ``pose_stage(keys, f2, K, matched, pose_config)`` reads; the feature
    sets need only ``xy``, ``descriptors`` and ``valid``.
    """

    def __init__(self, match_stage: Callable, pose_stage: Callable) -> None:
        super().__init__("pair_graph")
        self._match_stage = match_stage
        self._pose_stage = pose_stage

    def track(self, keys, f1, f2, K, match_args: tuple, pose_config, recorder: Optional[RunTelemetryRecorder] = None):
        """Both stages by replay (capturing a new signature first), or None
        where a new signature may not be captured: the caller then runs
        the eager stages."""
        inputs = (keys, f1.xy, f1.descriptors, f1.valid, f2.xy, f2.descriptors, f2.valid, K)
        return self._call(
            keys.device, signature(inputs, match_args, pose_config), len(inputs),
            lambda: self._capture(inputs, match_args, pose_config),
            lambda entry: self._replay(entry, inputs, recorder),
            recorder,
        )

    def _capture(self, inputs, match_args, pose_config) -> _Entry:
        device = inputs[0].device
        with torch.cuda.device(device):
            static = static_copies(inputs)
        keys, x1, d1, v1, x2, d2, v2, K = static
        f1, f2 = FeatureSet(x1, None, d1, None, v1), FeatureSet(x2, None, d2, None, v2)

        def pose(matched):
            template = self._pose_stage(keys, f2, K, matched, pose_config)
            return (template, *_pack(template))

        (match_graph, pose_graph), (matched, (template, packed, layout)) = capture(
            device, [lambda _: self._match_stage(f1, f2, *match_args), pose]
        )
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
