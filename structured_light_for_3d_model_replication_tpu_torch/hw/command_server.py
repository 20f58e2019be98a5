"""Pull-mode command channel: PC↔phone HTTP control + image upload plane.

The port's copy of the JAX package's ``hw/command_server.py``, the
equivalent of the reference's Flask server
(`server/server.py`): the phone browser polls ``GET /poll_command`` every
500 ms (`frotend/App.tsx:5,195-220`), deduplicates on the command's UUID, and
answers a ``capture`` command by POSTing the JPEG to ``/upload``
(`frotend/App.tsx:222-248`). The PC side arms a capture with
:meth:`CommandChannel.trigger_capture` and blocks on an event with a 20 s
abort timeout (`server/sl_system.py:88-109`).

Differences from the reference, on purpose:

* stdlib ``ThreadingHTTPServer`` — no web-framework dependency;
* ``CommandChannel`` state is guarded by a lock (SURVEY §5 flags the
  reference's ``SERVER_STATE`` two-thread mutation without one as a known
  hazard — fixed here, not preserved);
* the disconnect watchdog (`server/server.py:80-93`: connected flips false
  after 5 s of poll silence) is event-driven rather than a polling thread.
"""

from __future__ import annotations

import email.parser
import email.policy
import json
import os
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..utils.log import get_logger

log = get_logger(__name__)

POLL_SILENCE_DISCONNECT_S = 5.0   # server/server.py:86
CAPTURE_TIMEOUT_S = 20.0          # server/sl_system.py:103


class CommandChannel:
    """Thread-safe command/upload handshake state (SERVER_STATE analogue,
    `server/server.py:18-25`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._uploaded = threading.Event()
        self._command = "idle"
        self._command_id = str(uuid.uuid4())
        self._save_path: str | None = None
        self._last_poll = 0.0
        self.on_upload = None  # optional callback(path)

    # -- PC side -----------------------------------------------------------

    def trigger_capture(self, save_path: str,
                        timeout: float = CAPTURE_TIMEOUT_S) -> bool:
        """Arm a capture command and block until the client uploads (True)
        or the timeout lapses (False; command resets to idle either way) —
        `SLSystem.trigger_capture` semantics (`server/sl_system.py:88-109`).
        """
        with self._lock:
            self._uploaded.clear()
            self._save_path = save_path
            self._command_id = str(uuid.uuid4())
            self._command = "capture"
        ok = self._uploaded.wait(timeout)
        with self._lock:
            self._command = "idle"
            # Disarm so a LATE upload from this (timed-out) capture can't
            # satisfy the next trigger with the wrong image.
            self._save_path = None
        if not ok:
            log.warning("capture timed out after %.0fs (%s)", timeout,
                        save_path)
        return ok

    @property
    def connected(self) -> bool:
        with self._lock:
            return (time.monotonic() - self._last_poll
                    ) < POLL_SILENCE_DISCONNECT_S

    # -- HTTP side ---------------------------------------------------------

    def poll(self) -> dict:
        # BOTH keys: the reference frontend reads ``data.action``
        # (`frotend/App.tsx:207`, `server/server.py:44`), this framework's
        # client reads ``data.command`` — serving both makes either client a
        # drop-in against this server.
        with self._lock:
            self._last_poll = time.monotonic()
            return {"action": self._command, "command": self._command,
                    "id": self._command_id}

    def accept_upload(self, data: bytes) -> str:
        with self._lock:
            # Only an ARMED capture accepts an upload; anything else is a
            # stray (double upload, or a late one from a timed-out command).
            path = self._save_path if self._command == "capture" else None
            cmd_id = self._command_id
        if path is None:
            raise RuntimeError("upload with no capture armed")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        if self.on_upload is not None:
            self.on_upload(path)
        with self._lock:
            # Signal only if THIS command is still the armed one: a slow
            # upload that straddles a timeout + re-arm must not satisfy the
            # NEXT capture (its file was written to the old path).
            if self._command_id == cmd_id:
                self._uploaded.set()
        return path


def _extract_upload(handler: BaseHTTPRequestHandler) -> bytes:
    """File bytes from a POST body: multipart/form-data (what the React
    client sends, `frotend/App.tsx:236-247`) or a raw body."""
    length = int(handler.headers.get("Content-Length", 0))
    body = handler.rfile.read(length)
    ctype = handler.headers.get("Content-Type", "")
    if ctype.startswith("multipart/form-data"):
        # Reparse with the email machinery: prepend the header block.
        msg = email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(
            b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + body)
        for part in msg.iter_parts():
            if part.get_filename() or part.get_content_type().startswith(
                    "image/"):
                return part.get_payload(decode=True)
        raise ValueError("multipart body without a file part")
    return body


class _Handler(BaseHTTPRequestHandler):
    channel: CommandChannel  # set by make_server

    def _json(self, obj, status=200):
        data = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path == "/poll_command":
            self._json(self.channel.poll())
        elif self.path == "/status":
            self._json({"connected": self.channel.connected})
        else:
            self._json({"error": "not found"}, 404)

    def do_POST(self):
        if self.path == "/upload":
            try:
                path = self.channel.accept_upload(_extract_upload(self))
                self._json({"saved": os.path.basename(path)})
            except Exception as e:
                log.warning("upload failed: %s", e)
                self._json({"error": str(e)}, 400)
        else:
            self._json({"error": "not found"}, 404)

    def log_message(self, fmt, *args):  # silence per-request stderr noise
        log.debug("http: " + fmt, *args)


class CommandServer:
    """Owns the HTTP listener thread (daemonized like `server/main.py:17`)."""

    def __init__(self, channel: CommandChannel | None = None,
                 host: str = "0.0.0.0", port: int = 5000):
        self.channel = channel or CommandChannel()
        handler = type("BoundHandler", (_Handler,),
                       {"channel": self.channel})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._started = False

    def start(self) -> "CommandServer":
        self._thread.start()
        self._started = True
        log.info("command server on :%d", self.port)
        return self

    def stop(self) -> None:
        # shutdown() waits on serve_forever's exit event and would deadlock
        # if the serve thread never started.
        if self._started:
            self._httpd.shutdown()
        self._httpd.server_close()
