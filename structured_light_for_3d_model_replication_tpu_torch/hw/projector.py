"""Projector display drivers: fullscreen window + virtual frame buffer.

The reference displays patterns through a borderless OpenCV window moved onto
the projector's extended desktop (`server/sl_system.py:22-37`:
``namedWindow`` / ``moveWindow(offset)`` / ``setWindowProperty(FULLSCREEN)``)
with a per-frame ``waitKey`` dwell (`server/sl_system.py:464-465`: 200 ms
scan, 250 ms calibration).

:class:`VirtualProjector` is the headless counterpart: it holds the currently
"displayed" frame in memory where the synthetic camera (and any test) can see
it, with the dwell collapsed to zero. Orchestration code is written against
the common ``show / close`` surface so the same scan loop drives either.
"""

from __future__ import annotations

import numpy as np

from ..config import ProjectorConfig
from ..utils.log import get_logger

log = get_logger(__name__)


class WindowProjector:
    """Physical projector via a fullscreen cv2 window on the extended
    desktop. Lazy cv2 import — everything else runs without OpenCV."""

    WINDOW_NAME = "slproj"

    def __init__(self, proj: ProjectorConfig = ProjectorConfig(),
                 offset_x: int | None = None, dwell_ms: int = 200):
        import cv2  # lazy: display host only

        self._cv2 = cv2
        self.proj = proj
        self.dwell_ms = dwell_ms
        offset = proj.offset_x if offset_x is None else offset_x
        cv2.namedWindow(self.WINDOW_NAME, cv2.WINDOW_NORMAL)
        cv2.moveWindow(self.WINDOW_NAME, offset, 0)
        cv2.setWindowProperty(self.WINDOW_NAME, cv2.WND_PROP_FULLSCREEN,
                              cv2.WINDOW_FULLSCREEN)

    def show(self, frame: np.ndarray, dwell_ms: int | None = None) -> None:
        """Display the frame and block for the projection dwell so the
        camera sees a settled image (`server/sl_system.py:464-465`)."""
        self._cv2.imshow(self.WINDOW_NAME, np.asarray(frame))
        # waitKey(0) means "block for a keypress" to OpenCV — clamp so a
        # zero dwell pumps the event loop without hanging the scan.
        self._cv2.waitKey(max(1, self.dwell_ms if dwell_ms is None
                              else dwell_ms))

    def close(self) -> None:
        self._cv2.destroyWindow(self.WINDOW_NAME)


class VirtualProjector:
    """In-memory projector: ``current_frame`` is what a virtual camera sees.

    ``history`` (optional) records every shown frame for protocol assertions
    in tests — e.g. that a scan displayed the 46 frames in order.
    """

    def __init__(self, proj: ProjectorConfig = ProjectorConfig(),
                 record: bool = False):
        self.proj = proj
        self.current_frame = np.zeros((proj.height, proj.width), np.uint8)
        self.record = record
        self.history: list[np.ndarray] = []
        self.closed = False

    def show(self, frame: np.ndarray, dwell_ms: int | None = None) -> None:
        frame = np.asarray(frame, np.uint8)
        if frame.shape[:2] != (self.proj.height, self.proj.width):
            raise ValueError(
                f"frame {frame.shape[:2]} != projector "
                f"{(self.proj.height, self.proj.width)}")
        self.current_frame = frame
        if self.record:
            self.history.append(frame.copy())

    def close(self) -> None:
        self.closed = True
