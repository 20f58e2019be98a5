"""Camera backends: pull-mode phone, push-mode Android host, synthetic.

One ``capture(path) -> bool`` surface over the reference's three capture
paths:

* :class:`PullCamera` — the shipped path: arm a ``capture`` command on the
  :mod:`command_server` channel and wait for the phone browser's upload
  (`server/sl_system.py:88-109` + `frotend/App.tsx:195-248`).
* :class:`PushCamera` — the Android Camera2 host path: request the JPEG
  directly over HTTP from the NanoHTTPD server on :8765
  (`android_camera_host/.../CameraHostServer.kt:14-78`, client
  `Old/android_camera_host_client.py:8-104`): ``GET /status``,
  ``GET /capabilities``, ``POST /settings``, ``POST /capture/jpeg`` with
  capture metadata in the ``X-Capture-Meta`` response header.
* :class:`SyntheticCamera` — headless: shades whatever the virtual projector
  currently displays through the synthetic scene raycaster
  (`models/synthetic.FrameShader`). This is the phone simulator the
  reference lacks (SURVEY §4).
"""

from __future__ import annotations

import dataclasses
import json
import urllib.request

import numpy as np

from ..io.images import write_frame
from ..utils.log import get_logger

log = get_logger(__name__)


class PullCamera:
    """Capture by command/upload handshake over a CommandChannel."""

    def __init__(self, channel, timeout: float = 20.0):
        self.channel = channel
        self.timeout = timeout

    @property
    def connected(self) -> bool:
        return self.channel.connected

    def capture(self, path: str) -> bool:
        return self.channel.trigger_capture(path, timeout=self.timeout)


@dataclasses.dataclass
class CameraSettings:
    """Manual Camera2 controls for structured light: auto-exposure and
    autofocus OFF so frames are photometrically consistent across the stack
    (`Old/scanner_controller_android.py:37-43`)."""

    ae_mode: str = "off"
    iso: int = 400
    exposure_ns: int = 20_000_000
    af_mode: str = "off"
    focus_diopters: float = 2.0
    awb_mode: str = "auto"
    zoom: float = 1.0
    torch: bool = False

    def to_json(self) -> bytes:
        return json.dumps(dataclasses.asdict(self)).encode()


class PushCamera:
    """Client for the Android Camera2 host's push-mode REST protocol."""

    def __init__(self, base_url: str = "http://127.0.0.1:8765",
                 timeout: float = 10.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.last_meta: dict | None = None

    def _get(self, route: str) -> dict:
        with urllib.request.urlopen(self.base_url + route,
                                    timeout=self.timeout) as r:
            return json.loads(r.read().decode())

    def status(self) -> dict:
        return self._get("/status")

    def capabilities(self) -> dict:
        return self._get("/capabilities")

    @property
    def connected(self) -> bool:
        try:
            return bool(self.status())
        except Exception:
            return False

    def apply_settings(self, settings: CameraSettings) -> dict:
        req = urllib.request.Request(
            self.base_url + "/settings", data=settings.to_json(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read().decode())

    def capture_jpeg(self) -> bytes:
        """JPEG bytes; capture metadata lands in ``self.last_meta``
        (`CameraHostServer.kt:59-66`: body = image, meta = header)."""
        req = urllib.request.Request(self.base_url + "/capture/jpeg",
                                     data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            meta = r.headers.get("X-Capture-Meta")
            self.last_meta = json.loads(meta) if meta else None
            return r.read()

    def capture(self, path: str) -> bool:
        try:
            data = self.capture_jpeg()
        except Exception as e:
            log.warning("push capture failed: %s", e)
            return False
        with open(path, "wb") as f:
            f.write(data)
        return True


class LocalCamera:
    """Local USB/builtin webcam via ``cv2.VideoCapture`` — the no-phone
    capture path of the reference's webcam calibration rig
    (`Old/sl_calib_capture.py:46-123`: open ``CAM_ID``, force
    ``CAP_PROP_FRAME_WIDTH/HEIGHT``, ``cap.read()`` per projected frame).

    ``flush`` frames are read and discarded before the kept one:
    ``VideoCapture`` buffers a few frames internally, so without the flush a
    capture taken right after the projector swaps patterns can return a
    frame photographed under the PREVIOUS pattern — fatal for Gray-code
    decoding. (The reference sidesteps this with 200–500 ms ``waitKey``
    dwells; flushing is deterministic.)

    cv2 imports lazily so the package works on bare images.
    """

    def __init__(self, device_id: int = 0, width: int | None = 1920,
                 height: int | None = 1080, flush: int = 2):
        import cv2  # lazy: only this class needs it

        self._cv2 = cv2
        self.device_id = device_id
        self.flush = flush
        self._cap = cv2.VideoCapture(device_id)
        if not self._cap.isOpened():
            raise RuntimeError(f"cannot open local camera {device_id}")
        if width is not None:
            self._cap.set(cv2.CAP_PROP_FRAME_WIDTH, width)
        if height is not None:
            self._cap.set(cv2.CAP_PROP_FRAME_HEIGHT, height)
        self.connected = True

    def capture_array(self) -> np.ndarray:
        for _ in range(self.flush):
            self._cap.read()
        ok, frame = self._cap.read()
        if not ok or frame is None:
            raise RuntimeError(f"camera {self.device_id} returned no frame")
        return frame  # BGR uint8, as cv2 delivers it

    def capture(self, path: str) -> bool:
        try:
            frame = self.capture_array()
        except Exception as e:
            log.warning("local capture failed: %s", e)
            return False
        return bool(self._cv2.imwrite(path, frame))

    def release(self) -> None:
        self._cap.release()
        self.connected = False


class SyntheticCamera:
    """Renders the virtual projector's current frame through the scene.

    The shader (scene geometry at the current turntable pose) is supplied by
    the owning rig via ``shader_fn`` so rotation invalidation lives in one
    place (`hw/rig.py`).
    """

    def __init__(self, projector, shader_fn):
        self.projector = projector
        self._shader_fn = shader_fn
        self.connected = True

    def capture_array(self) -> np.ndarray:
        return self._shader_fn().shade(self.projector.current_frame)

    def capture(self, path: str) -> bool:
        write_frame(path, self.capture_array())
        return True
