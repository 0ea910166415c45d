"""Pull a packet source on a thread of its own, one packet ahead of the caller.

``SLAMSystem.run_stream_async`` waits for whichever comes first: the next
packet, or a feature result ready to track. A source that blocks until its
next frame is due (a camera, an open-loop replay) would otherwise hold every
ready result behind it until the next frame arrives. The pump pulls the
source on a daemon thread and hands each packet over through a slot of one;
it pulls the next packet only after the caller has handed the slot back
(:meth:`PacketPump.advance`, once the packet is submitted), so the source
feels the caller's back-pressure as before. Each hand-over notifies
``signal``, the condition the feature plane notifies when a result is ready,
so the caller waits on one condition for both.

Spans: ``input_wait`` around each pull (thread ``packet-pump``), carrying the
``frame_id`` the caller gives the packet.
"""

from __future__ import annotations

import threading
from typing import Any, Iterable, Optional

from mvslam_tpu_torch.core.telemetry import RunTelemetryRecorder, timed_event


class PacketPump:
    """A daemon thread pulling ``packets`` into a slot of one.

    The caller, holding ``signal``, checks :meth:`ready`, reads the slot with
    :meth:`take` and, once the packet is submitted, frees it with
    :meth:`advance`. :meth:`close` stops the thread, joins it and closes the
    source; call it whenever the caller stops.
    """

    END = object()  # the slot's value once the source is exhausted

    def __init__(
        self,
        packets: Iterable[Any],
        signal: threading.Condition,
        recorder: Optional[RunTelemetryRecorder] = None,
        first_frame_id: int = 0,
    ) -> None:
        self._packets = iter(packets)
        self._signal = signal
        self._recorder = recorder
        self._next_frame_id = first_frame_id
        self._slot: Any = None
        self._error: Optional[BaseException] = None
        self._stopped = False
        self._thread = threading.Thread(target=self._run, name="packet-pump", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def ready(self) -> bool:
        """With ``signal`` held: a packet, the source's end or its error waits."""
        return self._slot is not None or self._error is not None

    def take(self) -> Any:
        """With ``signal`` held: the packet waiting, :attr:`END` or None.
        Raises what the source raised."""
        if self._error is not None:
            raise self._error
        return self._slot

    def advance(self) -> None:
        """Free the slot: the pump pulls the next packet."""
        with self._signal:
            self._slot = None
            self._signal.notify_all()

    def close(self) -> None:
        """Stop pulling, join the thread (a pull under way ends first) and
        close the source."""
        with self._signal:
            self._stopped = True
            self._signal.notify_all()
        if self._thread.ident is not None:
            self._thread.join()

    def _run(self) -> None:
        try:
            while True:
                with self._signal:
                    self._signal.wait_for(lambda: self._slot is None or self._stopped)
                    if self._stopped:
                        return
                with timed_event(self._recorder, "input_wait") as meta:
                    packet = next(self._packets, self.END)
                    if packet is not self.END:
                        meta["frame_id"] = self._next_frame_id
                        self._next_frame_id += 1
                with self._signal:
                    self._slot = packet
                    self._signal.notify_all()
                if packet is self.END:
                    return
        except BaseException as exc:  # raised again on the caller's thread by ``take``
            with self._signal:
                self._error = exc
                self._signal.notify_all()
        finally:
            # The source is closed on the thread that pulls it: a generator
            # cannot be closed while another thread runs it.
            close = getattr(self._packets, "close", None)
            if close is not None:
                close()
