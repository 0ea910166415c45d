"""Live web dashboard: per-frame status over WebSockets + static HTTP.

Parity: reference ``web_dashboard_server.py`` — a self-contained live
tracker streaming per-frame ``FrameStatus`` JSON over websockets (port
8000) plus a static HTTP server (port 8001) for the vanilla-JS dashboard
(ref L40-277). The tracker here is the port's own ``SLAMSystem``
(``process_frame`` on its device) instead of a duplicated ORB pipeline.

The message schema is the *richer* one the reference's Next.js frontend
expected but never received (``frontend/hooks/useSlamData.ts:31-40``):
``pose_matrix``, raw + optimized trajectories, match/inlier metrics.

Copied close to verbatim from ``mvslam_tpu/viz/dashboard_server.py``,
with the port's own copy of the static files (``web_dashboard/``).
"""

from __future__ import annotations

import asyncio
import http.server
import json
import logging
import threading
from dataclasses import asdict, dataclass, field
from functools import partial
from pathlib import Path
from typing import Iterable, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

WEB_ROOT = Path(__file__).parent / "web_dashboard"


@dataclass
class FrameStatus:
    """Parity: ``web_dashboard_server.py:40-75`` (+ richer frontend schema)."""

    frame_id: int
    timestamp: float
    num_features: int = 0
    num_matches: int = 0
    num_inliers: int = 0
    inlier_ratio: float = 0.0
    pose_success: bool = False
    model_type: str = ""
    pose_matrix: List[List[float]] = field(default_factory=lambda: np.eye(4).tolist())
    position: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    trajectory: List[List[float]] = field(default_factory=list)
    optimized_trajectory: List[List[float]] = field(default_factory=list)
    graph_edges: List[List[int]] = field(default_factory=list)
    progress: float = 0.0

    def to_json(self) -> str:
        return json.dumps(asdict(self))


class DashboardStream:
    """Drive a SLAMSystem over frames, yielding FrameStatus per frame.

    Parity: ``web_dashboard_server.py:107-205`` (which embeds its own
    ORB+essential tracker; here the production system is reused).
    """

    def __init__(self, system, frames: Iterable[np.ndarray], timestamps=None) -> None:
        self.system = system
        self.frames = list(frames)
        self.timestamps = timestamps or [0.1 * i for i in range(len(self.frames))]
        self.trajectory_xz: List[List[float]] = []

    def __iter__(self):
        total = len(self.frames)
        for i, frame in enumerate(self.frames):
            diag = self.system.process_frame(frame, self.timestamps[i])
            pose = self.system.pose
            self.trajectory_xz.append([float(pose[0, 3]), float(pose[2, 3])])
            yield FrameStatus(
                frame_id=diag.frame_id,
                timestamp=diag.timestamp,
                num_features=diag.num_features,
                num_matches=diag.num_matches,
                num_inliers=diag.num_inliers,
                inlier_ratio=diag.inlier_ratio,
                pose_success=diag.pose_success,
                model_type=diag.model_type,
                pose_matrix=pose.tolist(),
                position=[float(v) for v in pose[:3, 3]],
                trajectory=list(self.trajectory_xz),
                progress=(i + 1) / max(total, 1),
            )


class DashboardServer:
    """WS (default 8000) + static HTTP (default 8001) server pair.

    Parity: ``web_dashboard_server.py:208-277``. ``websockets`` is a gated
    host dependency.
    """

    def __init__(
        self,
        ws_port: int = 8000,
        http_port: int = 8001,
        web_root: Path = WEB_ROOT,
    ) -> None:
        self.ws_port = ws_port
        self.http_port = http_port
        self.web_root = Path(web_root)
        self._clients: set = set()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._http_server: Optional[http.server.ThreadingHTTPServer] = None
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()

    # -- websocket side ------------------------------------------------------

    async def _ws_handler(self, websocket):
        self._clients.add(websocket)
        try:
            async for _ in websocket:  # clients don't send; keep alive
                pass
        finally:
            self._clients.discard(websocket)

    async def _ws_main(self):
        import websockets

        async with websockets.serve(self._ws_handler, "0.0.0.0", self.ws_port):
            while not self._stop.is_set():
                await asyncio.sleep(0.1)

    def broadcast(self, status: FrameStatus) -> None:
        """Thread-safe broadcast of one frame status to all clients."""
        if self._loop is None:
            return
        message = status.to_json()

        async def send():
            dead = []
            for client in list(self._clients):
                try:
                    await client.send(message)
                except Exception:
                    dead.append(client)
            for client in dead:
                self._clients.discard(client)

        asyncio.run_coroutine_threadsafe(send(), self._loop)

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        def ws_thread():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
            try:
                self._loop.run_until_complete(self._ws_main())
            except Exception as exc:
                logger.warning("websocket server stopped", extra={"error": str(exc)})

        handler = partial(http.server.SimpleHTTPRequestHandler, directory=str(self.web_root))
        self._http_server = http.server.ThreadingHTTPServer(("0.0.0.0", self.http_port), handler)
        self._threads = [
            threading.Thread(target=ws_thread, name="dashboard-ws", daemon=True),
            threading.Thread(
                target=self._http_server.serve_forever, name="dashboard-http", daemon=True
            ),
        ]
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()
        if self._http_server is not None:
            self._http_server.shutdown()
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads.clear()
