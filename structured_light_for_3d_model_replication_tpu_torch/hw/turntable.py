"""Turntable drivers: serial ESP32 protocol + timing-faithful simulator.

The reference drives a stepper turntable over a 115200-baud serial line with
a newline-terminated decimal-degrees protocol and a ``DONE`` completion reply
(`server/arduino.py:16-71`; firmware `ESP_code.ino:21-44` and the NEMA17
variant `Old/arduino_turntable.txt:17-80`). Semantics preserved here:

* ``rotate(deg)`` sends ``f"{deg}\n"`` and returns immediately;
* ``wait_for_done(timeout)`` blocks for the ``DONE`` line; on timeout the
  caller warns and continues (`server/gui.py:760-762` — a missed DONE is not
  fatal, the scan proceeds);
* port auto-discovery tries likely device names when none is given
  (`server/arduino.py:16-33`).

:class:`SimulatedTurntable` replaces the reference's inline
"Simulation mode" sleep (`server/gui.py:690-693,764-765`) with a first-class
driver: same API, a 10 RPM motion model (`ESP_code.ino:12`), and an angle
readout the virtual rig uses to rotate the synthetic scene.
"""

from __future__ import annotations

import glob
import threading
import time

from ..health import ScanFault
from ..utils.log import get_logger

log = get_logger(__name__)

BAUD_RATE = 115200
DONE_TOKEN = "DONE"
DEFAULT_RPM = 10.0  # ESP_code.ino:12 — 10 RPM stepper


class TurntableError(ScanFault):
    """Turntable transport failure (part of the scan error taxonomy)."""


class SerialTurntable:
    """PC↔ESP32 driver (`server/arduino.py`). Needs pyserial; import is
    lazy so the rest of the framework stays importable without it."""

    def __init__(self, port: str | None = None, baud: int = BAUD_RATE,
                 timeout: float = 1.0):
        try:
            import serial  # type: ignore
        except ImportError as e:  # pragma: no cover - env without pyserial
            raise TurntableError(
                "pyserial is not installed; use SimulatedTurntable") from e
        self._serial_mod = serial
        self._conn = None
        self.port = port
        self.baud = baud
        self.timeout = timeout

    @property
    def connected(self) -> bool:
        return self._conn is not None and self._conn.is_open

    def connect(self) -> bool:
        """Open the port (auto-discover if unset), give the MCU its reset
        settle time (`server/arduino.py:36-39`: 2 s after open)."""
        candidates = ([self.port] if self.port
                      else sorted(glob.glob("/dev/ttyUSB*"))
                      + sorted(glob.glob("/dev/ttyACM*")))
        for cand in candidates:
            try:
                self._conn = self._serial_mod.Serial(
                    cand, self.baud, timeout=self.timeout)
                time.sleep(2.0)  # board resets on open
                self._conn.reset_input_buffer()
                self.port = cand
                log.info("turntable connected on %s", cand)
                return True
            # Only transport-level failures mean "try the next port";
            # anything else (bad baud type, programming error) must surface.
            except (self._serial_mod.SerialException,
                    OSError) as e:  # pragma: no cover - hardware path
                log.debug("no turntable on %s: %s", cand, e)
                # A post-open failure (e.g. unplugged during the reset
                # sleep) leaves a half-open handle in self._conn: close it
                # so `connected` cannot report True after a failed probe.
                if self._conn is not None:
                    try:
                        self._conn.close()
                    except (self._serial_mod.SerialException, OSError):
                        log.debug("close of half-open %s failed", cand)
                    self._conn = None
        log.warning("turntable connection failed; tried %s",
                    candidates or "no candidate ports")
        return False

    def rotate(self, degrees: float) -> None:
        if not self.connected:
            raise TurntableError("not connected")
        self._conn.write(f"{degrees}\n".encode("ascii"))
        self._conn.flush()

    def wait_for_done(self, timeout: float = 30.0) -> bool:
        """Block for the ``DONE`` line; False on timeout (caller decides —
        the reference warns and continues)."""
        if not self.connected:
            raise TurntableError("not connected")
        deadline = time.monotonic() + timeout
        buf = b""
        while time.monotonic() < deadline:
            chunk = self._conn.readline()
            buf += chunk
            if DONE_TOKEN.encode() in buf:
                return True
        log.warning("turntable DONE timeout after %.1fs", timeout)
        return False

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None


class SimulatedTurntable:
    """Headless turntable with the real driver's API and timing shape.

    Motion completes after ``|deg| / (rpm·6) `` seconds (10 RPM → 6°/s) on a
    background timer, so orchestration code exercises the same
    rotate→wait_for_done handshake it would against hardware. ``angle_deg``
    accumulates the commanded rotations for the virtual rig.
    """

    def __init__(self, rpm: float = DEFAULT_RPM, time_scale: float = 1.0):
        self.rpm = rpm
        self.time_scale = time_scale  # tests shrink real waits
        self.angle_deg = 0.0
        self._done = threading.Event()
        self._done.set()
        self._lock = threading.Lock()
        self._timer: threading.Timer | None = None
        self._pending = 0.0
        self._gen = 0
        self.connected = True

    def connect(self) -> bool:
        return True

    def rotate(self, degrees: float) -> None:
        with self._lock:
            # A new command supersedes an in-flight move: cancel its timer
            # and land its rotation NOW (the real firmware is blocking, so
            # overlap only happens if the caller skipped wait_for_done).
            # The generation counter makes a fired-but-lock-blocked timer
            # from the old move a no-op.
            self._gen += 1
            gen = self._gen
            if self._timer is not None:
                self._timer.cancel()
                if not self._done.is_set():
                    self.angle_deg = (self.angle_deg + self._pending) % 360.0
            self._done.clear()
            self._pending = degrees
            duration = abs(degrees) / (self.rpm * 6.0) * self.time_scale

            def finish():
                with self._lock:
                    if self._gen != gen:
                        return
                    self.angle_deg = (self.angle_deg + degrees) % 360.0
                    self._done.set()

            self._timer = threading.Timer(duration, finish)
            self._timer.daemon = True
            self._timer.start()

    def wait_for_done(self, timeout: float = 30.0) -> bool:
        ok = self._done.wait(timeout)
        if not ok:
            log.warning("simulated turntable DONE timeout after %.1fs",
                        timeout)
        return ok

    def close(self) -> None:
        pass
