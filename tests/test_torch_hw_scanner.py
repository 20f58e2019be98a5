"""The port's capture layer — turntable, projector, cameras, the pull-mode
command server, the virtual rig, the scan orchestrator and ``cli scan`` —
against the JAX package's on the same inputs.

Everything compared here is exact: frames on disk equal the JAX package's
bit for bit (both render with the same numpy rig), the health reports'
JSON is equal, the command server's responses carry the same keys. The
transport tests (the phone's poll/upload protocol, the Android host, the
webcam) run the port's classes on their own: the JAX package's twins are
the same stdlib code and are held by tests/test_hw_scanner.py.

Every wait has its own bound (the ``timeout`` of each join, ``wait`` or
request), so a slow host fails one step, never a whole-file figure.
"""

import json
import os
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from structured_light_for_3d_model_replication_tpu import scanner as jscan
from structured_light_for_3d_model_replication_tpu.cli import scan as jcli_scan
from structured_light_for_3d_model_replication_tpu.config import (
    ProjectorConfig as JProjectorConfig,
)
from structured_light_for_3d_model_replication_tpu.hw import (
    VirtualRig as JVirtualRig,
)
from structured_light_for_3d_model_replication_tpu.hw import (
    command_server as jcs,
)
from structured_light_for_3d_model_replication_tpu.io import (
    layout as jlayout,
)
from structured_light_for_3d_model_replication_tpu.ops.patterns import (
    pattern_stack_for as jpattern_stack_for,
)
from structured_light_for_3d_model_replication_tpu_torch import cli
from structured_light_for_3d_model_replication_tpu_torch import (
    scanner as scan_mod,
)
from structured_light_for_3d_model_replication_tpu_torch.config import (
    ProjectorConfig,
)
from structured_light_for_3d_model_replication_tpu_torch.health import (
    ScanHealthReport,
)
from structured_light_for_3d_model_replication_tpu_torch.hw import (
    CameraSettings,
    CommandChannel,
    CommandServer,
    PullCamera,
    PushCamera,
    SimulatedTurntable,
    VirtualProjector,
    VirtualRig,
)
from structured_light_for_3d_model_replication_tpu_torch.hw import (
    command_server as cs_mod,
)
from structured_light_for_3d_model_replication_tpu_torch.io.images import (
    load_stack,
)
from structured_light_for_3d_model_replication_tpu_torch.io.layout import (
    SessionLayout,
)
from structured_light_for_3d_model_replication_tpu_torch.models import (
    synthetic,
)
from structured_light_for_3d_model_replication_tpu_torch.ops.patterns import (
    pattern_stack_for,
)

TINY = ProjectorConfig(width=64, height=32)
JTINY = JProjectorConfig(width=64, height=32)


# ---------------------------------------------------------------------------
# Turntable
# ---------------------------------------------------------------------------


def test_simulated_turntable_motion_matches_jax():
    """The same commands land the same angles, bit for bit, in both
    packages (the virtual rig rotates its scene by this angle)."""
    from structured_light_for_3d_model_replication_tpu.hw import (
        SimulatedTurntable as JSimulatedTurntable,
    )

    angles = {}
    for name, cls in (("port", SimulatedTurntable),
                      ("jax", JSimulatedTurntable)):
        tt = cls(time_scale=0.01)
        seen = []
        for deg in (30.0, 345.0, 15.0, 15.0):
            tt.rotate(deg)
            assert tt.wait_for_done(timeout=5.0)
            seen.append(tt.angle_deg)
        angles[name] = seen
    assert angles["port"] == angles["jax"]
    assert angles["port"][:2] == [30.0, 15.0]      # wraps mod 360


def test_simulated_turntable_timeout_warns_not_raises():
    tt = SimulatedTurntable(time_scale=10.0)  # 30° takes ~50 s scaled
    tt.rotate(30.0)
    assert tt.wait_for_done(timeout=0.05) is False  # reference: warn, go on


def test_turntable_accumulates_k_times_step_exactly():
    """24 turns of 15° land exactly on k·15°: the angle the rig renders at
    equals the one the ring's renderer uses, to the last bit."""
    tt = SimulatedTurntable(time_scale=0.0)
    for k in range(1, 24):
        tt.rotate(15.0)
        assert tt.wait_for_done(timeout=5.0)
        assert tt.angle_deg == k * 15.0


# ---------------------------------------------------------------------------
# Pull-mode command server (phone protocol loopback)
# ---------------------------------------------------------------------------


@pytest.fixture()
def command_server():
    srv = CommandServer(host="127.0.0.1", port=0).start()
    yield srv
    srv.stop()


def _get_json(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return json.loads(r.read().decode())


def _multipart(payload: bytes, boundary: str, filename: str) -> bytes:
    return (
        f"--{boundary}\r\n"
        f'Content-Disposition: form-data; name="file"; '
        f'filename="{filename}"\r\n'
        f"Content-Type: image/jpeg\r\n\r\n"
    ).encode() + payload + f"\r\n--{boundary}--\r\n".encode()


def _post_upload(base, payload, ctype="application/octet-stream"):
    req = urllib.request.Request(base + "/upload", data=payload,
                                 headers={"Content-Type": ctype},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _wait_armed(base, not_id=None, tries=200):
    for _ in range(tries):
        st = _get_json(base + "/poll_command")
        if st["command"] == "capture" and st["id"] != not_id:
            return st
        time.sleep(0.005)
    raise AssertionError("the capture was never armed")


def test_poll_keys_match_jax():
    """Both packages' channels answer a poll with the same keys — the
    reference client's ``action`` and this framework's ``command`` — and
    the same idle state."""
    st, jst = CommandChannel().poll(), jcs.CommandChannel().poll()
    assert set(st) == set(jst) == {"action", "command", "id"}
    assert (st["action"], st["command"]) == (jst["action"], jst["command"])


def test_poll_idle_then_capture_roundtrip(command_server, tmp_path):
    base = f"http://127.0.0.1:{command_server.port}"
    st = _get_json(base + "/poll_command")
    assert st["command"] == "idle"

    target = str(tmp_path / "shot.jpg")
    results = {}
    t = threading.Thread(target=lambda: results.setdefault(
        "ok", command_server.channel.trigger_capture(target, timeout=10)))
    t.start()
    _wait_armed(base, not_id=st["id"])
    payload = b"\xff\xd8JPEGDATA\xff\xd9"
    code, body = _post_upload(
        base, _multipart(payload, "BoUnDaRy123", "c.jpg"),
        "multipart/form-data; boundary=BoUnDaRy123")
    assert (code, body["saved"]) == (200, "shot.jpg")
    t.join(timeout=10)
    assert results["ok"] is True
    with open(target, "rb") as f:
        assert f.read() == payload
    assert _get_json(base + "/poll_command")["command"] == "idle"
    assert _get_json(base + "/status")["connected"] is True


def test_trigger_capture_times_out_without_upload(tmp_path):
    ch = CommandChannel()
    assert ch.trigger_capture(str(tmp_path / "never.jpg"),
                              timeout=0.05) is False


def test_reference_frontend_replay_drives_full_capture(command_server,
                                                       tmp_path):
    """Traffic shaped like the reference React client (`frotend/App.tsx:
    195-248`: reads only ``action``, dedups on ``id``, uploads a FormData
    part ``file`` named ``capture.jpg``) drives a 3-frame capture."""
    base = f"http://127.0.0.1:{command_server.port}"
    state = {"last_id": None, "sent": 0}

    def poll_once():
        data = _get_json(base + "/poll_command")
        if data["action"] == "capture" and data["id"] != state["last_id"]:
            state["last_id"] = data["id"]
            payload = b"\xff\xd8frame%d\xff\xd9" % state["sent"]
            boundary = "----WebKitFormBoundaryREF"
            _post_upload(base, _multipart(payload, boundary, "capture.jpg"),
                         f"multipart/form-data; boundary={boundary}")
            state["sent"] += 1
            return True
        return False

    stop = threading.Event()

    def phone_loop():
        while not stop.is_set():
            poll_once()
            stop.wait(0.01)

    t = threading.Thread(target=phone_loop, daemon=True)
    t.start()
    try:
        for i in range(3):
            target = str(tmp_path / f"{i:02d}.jpg")
            assert command_server.channel.trigger_capture(target, timeout=10)
            with open(target, "rb") as f:
                assert f.read() == b"\xff\xd8frame%d\xff\xd9" % i
    finally:
        stop.set()
        t.join(timeout=5)
    assert state["sent"] == 3
    assert poll_once() is False          # id dedup holds after the scan


def test_pull_camera_stack_equals_render_scan(command_server, tmp_path):
    """A ``Scanner`` over a ``PullCamera``: a phone thread answers each
    capture command with the virtual rig's PNG of the displayed frame, and
    the stack on disk equals ``render_scan``'s, bit for bit."""
    import io as _io

    from PIL import Image

    rig = VirtualRig(proj=TINY, cam_height=24, cam_width=40)
    base = f"http://127.0.0.1:{command_server.port}"
    stop = threading.Event()
    last = {"id": None}

    def phone_loop():
        while not stop.is_set():
            data = _get_json(base + "/poll_command")
            if data["action"] == "capture" and data["id"] != last["id"]:
                last["id"] = data["id"]
                buf = _io.BytesIO()
                Image.fromarray(rig.camera.capture_array()).save(buf, "PNG")
                _post_upload(base, buf.getvalue(), "image/png")
            stop.wait(0.002)

    t = threading.Thread(target=phone_loop, daemon=True)
    t.start()
    try:
        layout = SessionLayout(root=str(tmp_path / "session")).ensure()
        sc = scan_mod.Scanner(PullCamera(command_server.channel, timeout=10),
                              rig.projector, proj=TINY, layout=layout,
                              settle_s=0.0)
        out = sc.capture_scan("obj")
    finally:
        stop.set()
        t.join(timeout=5)
    want, _ = synthetic.render_scan(rig.scene, rig.cam_K, rig.proj_K, rig.R,
                                    rig.T, 24, 40, TINY)
    np.testing.assert_array_equal(load_stack(out), want)


def _stale_upload_case(tmp_path, same_path: bool):
    """A slow upload from a timed-out capture A straddles the re-arm of
    capture B (a new path, or the retry's same path): it must not satisfy
    B. Returns (B's result, the stale upload's result)."""
    import builtins

    ch = CommandChannel()
    path_a = str(tmp_path / "a.jpg")
    path_b = path_a if same_path else str(tmp_path / "b.jpg")
    entered, release = threading.Event(), threading.Event()
    real_open = builtins.open
    results = {}

    def slow_upload():
        try:
            results["path"] = ch.accept_upload(b"stale-bytes")
        except RuntimeError as e:
            results["err"] = str(e)

    def blocking_open(f, mode="r", *a, **k):
        if f == path_a and "w" in mode and not entered.is_set():
            entered.set()
            release.wait(5)
        return real_open(f, mode, *a, **k)

    t_a = threading.Thread(target=lambda: results.setdefault(
        "a_ok", ch.trigger_capture(path_a, 1.5)), daemon=True)
    t_a.start()
    time.sleep(0.05)
    builtins.open = blocking_open
    done_b = {}
    try:
        up = threading.Thread(target=slow_upload, daemon=True)
        up.start()
        assert entered.wait(5), "upload never reached the file write"
        t_a.join(3)
        assert results.get("a_ok") is False          # capture A timed out
        t_b = threading.Thread(target=lambda: done_b.setdefault(
            "ok", ch.trigger_capture(path_b, 0.6)), daemon=True)
        t_b.start()
        time.sleep(0.05)
        release.set()
        up.join(2)
        t_b.join(2)
    finally:
        builtins.open = real_open
        release.set()
    return done_b.get("ok"), results


@pytest.mark.parametrize("same_path", [False, True])
def test_stale_upload_cannot_satisfy_next_capture(tmp_path, same_path):
    ok_b, results = _stale_upload_case(tmp_path, same_path)
    assert ok_b is False, "a stale upload satisfied the next capture"
    assert results.get("path") == str(tmp_path / "a.jpg")


def test_parallel_uploads_race_one_armed_capture(command_server, tmp_path):
    """8 simultaneous uploads against one armed capture: it completes, no
    request fails with a 5xx, the file holds one racer's whole payload."""
    base = f"http://127.0.0.1:{command_server.port}"
    target = str(tmp_path / "race.jpg")
    trig = {}
    t = threading.Thread(target=lambda: trig.setdefault(
        "ok", command_server.channel.trigger_capture(target, timeout=10)))
    t.start()
    _wait_armed(base)
    results, lock = [], threading.Lock()
    start = threading.Barrier(8)

    def racer(i):
        start.wait(timeout=10)
        out = _post_upload(base, b"\xff\xd8RACE%d\xff\xd9" % i)
        with lock:
            results.append(out)

    threads = [threading.Thread(target=racer, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    t.join(timeout=10)
    assert trig["ok"] is True
    codes = sorted(c for c, _ in results)
    assert all(c in (200, 400) for c in codes), codes
    assert codes.count(200) >= 1
    with open(target, "rb") as f:
        data = f.read()
    assert data.startswith(b"\xff\xd8RACE") and data.endswith(b"\xff\xd9")


def test_parallel_stray_uploads_all_rejected(command_server):
    base = f"http://127.0.0.1:{command_server.port}"
    results, lock = [], threading.Lock()

    def racer(i):
        out = _post_upload(base, b"stray-%d" % i)
        with lock:
            results.append(out)

    threads = [threading.Thread(target=racer, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert [c for c, _ in results] == [400] * 8
    assert _get_json(base + "/status") is not None


def test_concurrent_polls_dedup_on_stable_id(command_server, tmp_path):
    """16 concurrent polls during one armed capture see one id; the next
    trigger mints a new one."""
    base = f"http://127.0.0.1:{command_server.port}"
    ch = command_server.channel
    t = threading.Thread(target=lambda: ch.trigger_capture(
        str(tmp_path / "a.jpg"), timeout=5))
    t.start()
    _wait_armed(base)
    seen, lock = [], threading.Lock()

    def poller():
        st = _get_json(base + "/poll_command")
        with lock:
            seen.append((st["command"], st["id"]))

    threads = [threading.Thread(target=poller) for _ in range(16)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert len(seen) == 16 and {c for c, _ in seen} == {"capture"}
    first_ids = {i for _, i in seen}
    assert len(first_ids) == 1
    _post_upload(base, b"\xff\xd8A\xff\xd9")
    t.join(timeout=10)
    t2 = threading.Thread(target=lambda: ch.trigger_capture(
        str(tmp_path / "b.jpg"), timeout=5))
    t2.start()
    st = _wait_armed(base)
    assert st["id"] not in first_ids
    _post_upload(base, b"\xff\xd8B\xff\xd9")
    t2.join(timeout=10)


def test_poll_silence_flips_connected_after_window(command_server,
                                                   monkeypatch):
    monkeypatch.setattr(cs_mod, "POLL_SILENCE_DISCONNECT_S", 0.2)
    base = f"http://127.0.0.1:{command_server.port}"
    _get_json(base + "/poll_command")
    assert _get_json(base + "/status")["connected"] is True
    time.sleep(0.3)
    assert _get_json(base + "/status")["connected"] is False
    _get_json(base + "/poll_command")
    assert _get_json(base + "/status")["connected"] is True


# ---------------------------------------------------------------------------
# Local webcam, with a fake cv2 (the card's machine has no OpenCV)
# ---------------------------------------------------------------------------


def test_local_camera_flushes_stale_frames(tmp_path, monkeypatch):
    frames = [np.full((8, 8, 3), v, np.uint8) for v in (10, 20, 30, 40)]
    written = {}

    class FakeCap:
        def __init__(self, dev):
            self.i = 0
            self.props = {}

        def isOpened(self):
            return True

        def set(self, prop, val):
            self.props[prop] = val

        def read(self):
            f = frames[min(self.i, len(frames) - 1)]
            self.i += 1
            return True, f.copy()

        def release(self):
            pass

    def imwrite(path, img):
        written[path] = img.copy()
        return True

    fake = types.SimpleNamespace(VideoCapture=FakeCap, imwrite=imwrite,
                                 CAP_PROP_FRAME_WIDTH=3,
                                 CAP_PROP_FRAME_HEIGHT=4)
    monkeypatch.setitem(sys.modules, "cv2", fake)
    from structured_light_for_3d_model_replication_tpu_torch.hw.camera import (
        LocalCamera,
    )

    cam = LocalCamera(0, width=640, height=480, flush=2)
    assert cam._cap.props == {3: 640, 4: 480}
    # Two buffered frames (10, 20) are flushed; the kept frame is 30.
    assert cam.capture_array()[0, 0, 0] == 30
    out = str(tmp_path / "local.png")
    assert cam.capture(out)
    assert written[out][0, 0, 0] == 40
    cam.release()
    assert cam.connected is False


# ---------------------------------------------------------------------------
# Push-mode camera (Android host protocol against a stub)
# ---------------------------------------------------------------------------


class _AndroidHostStub(BaseHTTPRequestHandler):
    def do_GET(self):
        body = json.dumps({"camera": "open"} if self.path == "/status"
                          else {"iso_range": [100, 3200]}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n)
        if self.path == "/capture/jpeg":
            jpeg = b"\xff\xd8stubjpeg\xff\xd9"
            self.send_response(200)
            self.send_header("X-Capture-Meta",
                             json.dumps({"iso": 400, "exposure_ns": 1000}))
            self.send_header("Content-Length", str(len(jpeg)))
            self.end_headers()
            self.wfile.write(jpeg)
        else:  # /settings echoes back what it applied
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    def log_message(self, *a):
        pass


def test_push_camera_protocol(tmp_path):
    from structured_light_for_3d_model_replication_tpu.hw import (
        CameraSettings as JCameraSettings,
    )

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _AndroidHostStub)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        cam = PushCamera(f"http://127.0.0.1:{httpd.server_address[1]}")
        assert cam.connected and cam.status()["camera"] == "open"
        assert "iso_range" in cam.capabilities()
        echoed = cam.apply_settings(CameraSettings(iso=800))
        assert echoed["iso"] == 800 and echoed["ae_mode"] == "off"
        # The settings body is the JAX package's, byte for byte.
        assert CameraSettings(iso=800).to_json() \
            == JCameraSettings(iso=800).to_json()
        out = str(tmp_path / "push.jpg")
        assert cam.capture(out)
        assert cam.last_meta == {"iso": 400, "exposure_ns": 1000}
        assert scan_mod.frame_file_ok(out)
    finally:
        httpd.shutdown()
        httpd.server_close()


# ---------------------------------------------------------------------------
# Virtual rig + scanner orchestration
# ---------------------------------------------------------------------------


def _make_scanner(tmp_path, turntable=True, sub="session"):
    rig = VirtualRig(proj=TINY, cam_height=24, cam_width=40)
    layout = SessionLayout(root=str(tmp_path / sub)).ensure()
    sc = scan_mod.Scanner(
        rig.camera, rig.projector,
        turntable=rig.turntable if turntable else None,
        proj=TINY, layout=layout, settle_s=0.0)
    return rig, sc


def _make_jax_scanner(tmp_path, sub="jax"):
    rig = JVirtualRig(proj=JTINY, cam_height=24, cam_width=40)
    layout = jlayout.SessionLayout(root=str(tmp_path / sub)).ensure()
    return rig, jscan.Scanner(rig.camera, rig.projector, rig.turntable,
                              proj=JTINY, layout=layout, settle_s=0.0)


def _frames(folder):
    return {f: open(os.path.join(folder, f), "rb").read()
            for f in sorted(os.listdir(folder))}


def test_capture_stack_matches_jax_and_render_scan(tmp_path):
    """``capture_scan`` over the port's rig writes the JAX rig's frames
    (the same names, the same decoded pixels) and ``render_scan``'s stack,
    bit for bit."""
    rig, sc = _make_scanner(tmp_path)
    out = sc.capture_scan("obj")
    _, jsc = _make_jax_scanner(tmp_path)
    jout = jsc.capture_scan("obj")
    assert sorted(os.listdir(out)) == sorted(os.listdir(jout))
    assert len(os.listdir(out)) == TINY.n_frames
    stack = load_stack(out)
    np.testing.assert_array_equal(stack, load_stack(jout))
    want, _ = synthetic.render_scan(rig.scene, rig.cam_K, rig.proj_K, rig.R,
                                    rig.T, 24, 40, TINY)
    np.testing.assert_array_equal(stack, want)


def test_auto_scan_rotates_scene_and_resumes(tmp_path):
    rig, sc = _make_scanner(tmp_path)
    rig.turntable.time_scale = 0.001
    progress = []
    stops = sc.auto_scan_360("obj", degrees_per_turn=120.0, turns=3,
                             on_progress=progress.append)
    assert len(stops) == 3 and all(os.path.isdir(s) for s in stops)
    s0, s1 = load_stack(stops[0]), load_stack(stops[1])
    assert (s0[0] != s1[0]).any()          # the scene really rotated
    assert [p.stop for p in progress] == [1, 2, 3]
    assert progress[-1].remaining_s == pytest.approx(0.0)
    # The JAX package's loop gives the same folders and frames.
    jrig, jsc = _make_jax_scanner(tmp_path)
    jrig.turntable.time_scale = 0.001
    jstops = jsc.auto_scan_360("obj", degrees_per_turn=120.0, turns=3)
    assert [os.path.relpath(s, sc.layout.root) for s in stops] \
        == [os.path.relpath(s, jsc.layout.root) for s in jstops]
    for s, js in zip(stops, jstops):
        np.testing.assert_array_equal(load_stack(s), load_stack(js))
    # Resume: a second run captures nothing (camera disabled proves it).
    sc.camera = None
    health = ScanHealthReport()
    assert sc.auto_scan_360("obj", degrees_per_turn=120.0, turns=3,
                            health=health) == stops
    assert [s.status for s in health.stops.values()] == ["resumed"] * 3


def test_capture_abort_on_camera_timeout(tmp_path):
    class DeadCamera:
        connected = False

        def capture(self, path):
            return False

    _, sc = _make_scanner(tmp_path)
    sc.camera = DeadCamera()
    with pytest.raises(scan_mod.ScanAborted):
        sc.capture_scan("obj")
    jrig, jsc = _make_jax_scanner(tmp_path)
    jsc.camera = DeadCamera()
    with pytest.raises(jscan.ScanAborted):
        jsc.capture_scan("obj")


def test_virtual_projector_rejects_wrong_shape():
    vp = VirtualProjector(TINY)
    with pytest.raises(ValueError):
        vp.show(np.zeros((8, 8), np.uint8))


def test_rig_ground_truth_tracks_angle():
    rig = VirtualRig(proj=TINY, cam_height=24, cam_width=40)
    rig.turntable.time_scale = 0.001
    gt0 = rig.ground_truth["object_mask"].copy()
    rig.turntable.rotate(90.0)
    assert rig.turntable.wait_for_done(5.0)
    assert (gt0 != rig.ground_truth["object_mask"]).any()


def test_pattern_protocol_order(tmp_path):
    """The displayed sequence is white, black, then pattern/inverse pairs:
    the JAX package's ``pattern_stack_for`` and the renderer's
    ``pattern_frames``, frame for frame."""
    rig, sc = _make_scanner(tmp_path)
    sc.capture_scan("proto")
    frames = rig.projector.history
    assert len(frames) == TINY.n_frames
    want = np.asarray(jpattern_stack_for(JTINY))
    np.testing.assert_array_equal(np.stack(frames), want)
    np.testing.assert_array_equal(np.stack(frames),
                                  synthetic.pattern_frames(TINY))
    np.testing.assert_array_equal(
        pattern_stack_for(TINY, device="cpu").numpy(), want)


def test_calibration_pose_and_single_scan_layout(tmp_path):
    """``capture_calibration_pose`` and ``capture_scan`` write where the
    JAX package's do, relative to the session root."""
    _, sc = _make_scanner(tmp_path)
    _, jsc = _make_jax_scanner(tmp_path)
    for port_dir, jax_dir in ((sc.capture_calibration_pose(2),
                               jsc.capture_calibration_pose(2)),
                              (sc.capture_scan("one"),
                               jsc.capture_scan("one"))):
        assert os.path.relpath(port_dir, sc.layout.root) \
            == os.path.relpath(jax_dir, jsc.layout.root)
        np.testing.assert_array_equal(load_stack(port_dir),
                                      load_stack(jax_dir))


# ---------------------------------------------------------------------------
# cli scan
# ---------------------------------------------------------------------------


def test_cli_scan_virtual_matches_jax_and_resumes(tmp_path, capsys):
    """``scan auto360 --virtual`` (the CLI's 96×160 rig) in both packages:
    the same dated folders and frames, the same health JSON; a second
    port run resumes every stop and captures nothing; ``single`` and
    ``calib-pose`` write their folders."""
    args = ["auto360", "--virtual", "--turns", "2", "--degrees", "180",
            "--name", "obj"]
    hp, hj = tmp_path / "port.json", tmp_path / "jax.json"
    assert cli.main(["scan", *args, "--session", str(tmp_path / "p"),
                     "--health-json", str(hp)]) == 0
    assert jcli_scan.main([*args, "--session", str(tmp_path / "j"),
                           "--health-json", str(hj)]) == 0
    assert "done: 2 stops" in capsys.readouterr().err

    def stops(root):
        lay = SessionLayout.today(str(root))
        return lay, lay.stop_dirs("obj", 180.0)

    lay, port_stops = stops(tmp_path / "p")
    _, jax_stops = stops(tmp_path / "j")
    assert [os.path.basename(s) for s in port_stops] \
        == [os.path.basename(s) for s in jax_stops] \
        == ["obj_0deg_scan", "obj_180deg_scan"]
    for s, js in zip(port_stops, jax_stops):
        np.testing.assert_array_equal(load_stack(s), load_stack(js))
    doc, jdoc = json.loads(hp.read_text()), json.loads(hj.read_text())
    doc.pop("scan_id"), jdoc.pop("scan_id")
    assert doc == jdoc
    mtimes = {s: os.path.getmtime(os.path.join(s, "01.png"))
              for s in port_stops}
    assert cli.main(["scan", *args, "--session", str(tmp_path / "p"),
                     "--health-json", str(hp)]) == 0
    assert [s["status"] for s in json.loads(hp.read_text())["stops"]] \
        == ["resumed", "resumed"]
    assert mtimes == {s: os.path.getmtime(os.path.join(s, "01.png"))
                      for s in port_stops}
    assert cli.main(["scan", "single", "--virtual", "--name", "one",
                     "--session", str(tmp_path / "p")]) == 0
    assert cli.main(["scan", "calib-pose", "--virtual", "--pose", "3",
                     "--session", str(tmp_path / "p")]) == 0
    assert len(os.listdir(lay.scan_dir("one"))) \
        == len(os.listdir(lay.pose_dir(3))) \
        == len(os.listdir(port_stops[0]))
