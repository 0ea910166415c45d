"""Interface launcher: choose GUI viewer or web dashboard.

Parity: reference ``main.py`` — validates dependencies/ports, then
launches the GUI (matplotlib viewer) or the web dashboard server over a
KITTI sequence or synthetic frames (ref L61-126).

Port of ``mvslam_tpu/viz/launcher.py``: the system is the port's
``SLAMSystem`` on ``--device`` (``cuda`` unless asked for ``cpu``).
Entry point: ``python -m mvslam_tpu_torch.viz.launcher --dataset DIR``.
"""

from __future__ import annotations

import argparse
import logging
import socket
import sys
import time
from pathlib import Path
from typing import List, Optional

logger = logging.getLogger(__name__)


def _port_free(port: int) -> bool:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        return sock.connect_ex(("127.0.0.1", port)) != 0


def _check_deps(names: List[str]) -> List[str]:
    missing = []
    for name in names:
        try:
            __import__(name)
        except ImportError:
            missing.append(name)
    return missing


def _build_system(args):
    from mvslam_tpu_torch.data.kitti import KittiSequence
    from mvslam_tpu_torch.slam.api import SLAMSystem, SLAMSystemConfig

    seq = KittiSequence(args.dataset, args.sequence)
    K = seq.camera_intrinsics()
    system = SLAMSystem(
        SLAMSystemConfig(
            run_id="viewer",
            output_root=Path(args.output_root),
            fx=float(K[0, 0]),
            fy=float(K[1, 1]),
            cx=float(K[0, 2]),
            cy=float(K[1, 2]),
        ),
        device=args.device,
    )
    return system, seq


def launch_gui(args) -> int:
    missing = _check_deps(["matplotlib"])
    if missing:
        print(f"missing GUI dependencies: {missing}", file=sys.stderr)
        return 2
    from mvslam_tpu_torch.viz.viewer import SlamViewer

    system, seq = _build_system(args)
    viewer = SlamViewer(interactive=not args.headless, total_frames=args.max_frames)
    for packet in seq.iter_frames(args.max_frames):
        diag = system.process_frame(packet.frame, packet.timestamp)
        feats = system._prev_features
        viewer.update(
            packet.frame,
            None if feats is None else feats.xy.cpu().numpy(),
            system.pose,
            None if feats is None else feats.valid.cpu().numpy(),
            diagnostics=diag,
        )
    system.finalize_run()
    if args.headless and args.screenshot:
        viewer.render_frame_png(args.screenshot)
    return 0


def launch_web(args) -> int:
    missing = _check_deps(["websockets"])
    if missing:
        print(f"missing web dependencies: {missing}", file=sys.stderr)
        return 2
    for port in (args.ws_port, args.http_port):
        if not _port_free(port):
            print(f"port {port} already in use", file=sys.stderr)
            return 2
    from mvslam_tpu_torch.viz.dashboard_server import DashboardServer, DashboardStream

    system, seq = _build_system(args)
    server = DashboardServer(ws_port=args.ws_port, http_port=args.http_port)
    server.start()
    print(f"dashboard: http://localhost:{args.http_port}  (ws {args.ws_port})")
    packets = list(seq.iter_frames(args.max_frames))
    stream = DashboardStream(system, [p.frame for p in packets], [p.timestamp for p in packets])
    try:
        for status in stream:
            server.broadcast(status)
            time.sleep(args.frame_delay_s)
        system.finalize_run()
        if args.keep_serving:
            while True:
                time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Launch a SLAM interface")
    parser.add_argument("--dataset", type=Path, required=True)
    parser.add_argument("--sequence", default="00")
    parser.add_argument("--output-root", type=Path, default=Path("runs"))
    parser.add_argument("--device", default="cuda", help="torch device of the SLAM system (cuda, cpu)")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--gui", action="store_true")
    parser.add_argument("--web", action="store_true")
    parser.add_argument("--headless", action="store_true")
    parser.add_argument("--screenshot", type=Path, default=None)
    parser.add_argument("--ws-port", type=int, default=8000)
    parser.add_argument("--http-port", type=int, default=8001)
    parser.add_argument("--frame-delay-s", type=float, default=0.0)
    parser.add_argument("--keep-serving", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.web:
        return launch_web(args)
    return launch_gui(args)


if __name__ == "__main__":
    sys.exit(main())
