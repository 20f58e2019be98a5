"""The port's GUI orchestrator: headless-safe import, the worker plumbing,
the pose-culling rule (each against the JAX package's), and its
workflows run headless on ``device="cpu"`` through stand-ins for the Tk
variables — the virtual rig's connect, an auto-scan, a cleanup, a mesh and
a preview — so every button's call reaches the port's entry points with
the GUI's device.

The Tk widget tree itself needs a display; nothing here creates a Tk
root."""

import os
import threading
import time
import types

import numpy as np

from structured_light_for_3d_model_replication_tpu import gui as jgui
from structured_light_for_3d_model_replication_tpu_torch import gui
from structured_light_for_3d_model_replication_tpu_torch.io import ply as ply_io
from structured_light_for_3d_model_replication_tpu_torch.io.layout import (
    SessionLayout,
)

class FakeRoot:
    """Tk-root stand-in: ``after`` runs the callback on a timer thread."""

    def after(self, ms, fn):
        t = threading.Timer(ms / 1000.0, fn)
        t.daemon = True
        t.start()


class Var:
    """A Tk variable stand-in (``get`` / ``set``)."""

    def __init__(self, value):
        self.value = value

    def get(self):
        return self.value

    def set(self, value):
        self.value = value


def test_module_imports_headless():
    """Importing the GUI creates no Tk root (that no ``tkinter``, ``cv2``
    or JAX module loads with it is checked in a fresh interpreter by
    tests/test_torch_import.py)."""
    assert hasattr(gui, "ScannerGUI") and hasattr(gui, "main")
    assert hasattr(gui, "WorkerMixin") and hasattr(gui, "selected_pose_dirs")


def _worker():
    w = gui.WorkerMixin()
    w._init_worker(FakeRoot())
    return w


def test_worker_mixin_marshals_results():
    w = _worker()
    got, done = [], threading.Event()
    w.run_bg("test", lambda: 41 + 1,
             lambda v: (got.append(v), done.set()))
    assert done.wait(3.0)
    assert got == [42]


def test_worker_mixin_routes_errors():
    w = _worker()
    errs, done = [], threading.Event()

    def work():
        raise RuntimeError("boom")

    w.run_bg("test", work, on_done=lambda v: None,
             on_error=lambda e: (errs.append(str(e)), done.set()))
    assert done.wait(3.0)
    assert errs == ["boom"]


def test_worker_runs_off_ui_thread():
    w = _worker()
    names, done = [], threading.Event()

    def work():
        names.append(threading.current_thread().name)

    w.run_bg("bg-name", work, lambda _: done.set())
    assert done.wait(3.0)
    assert names == ["bg-name"]


def test_selected_pose_dirs_matches_jax():
    dirs = ["/s/calib/pose_1", "/s/calib/pose_2", "/s/calib/pose_3"]
    for sel in ({}, {"pose_1": True, "pose_2": False, "pose_3": True},
                {"pose_1": True}):
        assert gui.selected_pose_dirs(dirs, sel) \
            == jgui.selected_pose_dirs(dirs, sel)
    assert gui.selected_pose_dirs(dirs, {"pose_1": True}) == [dirs[0]]


def _no_display(root):
    raise RuntimeError("no display")


def _headless_gui(tmp_path, **vars_):
    """A ``ScannerGUI`` without its widget tree: the worker plumbing, the
    session layout, the device ``cpu`` and stand-ins for the Tk variables
    the workflows read; ``lines`` collects the log lines."""
    g = gui.ScannerGUI.__new__(gui.ScannerGUI)
    g._init_worker(FakeRoot())
    g.device = "cpu"
    g.layout = SessionLayout(root=str(tmp_path / "session")).ensure()
    g.server = g.scanner = g._virtual_rig = None
    g.lines = []
    g.log_line = g.lines.append
    g.tk = types.SimpleNamespace(Toplevel=_no_display)
    g.root = None
    for k, v in vars_.items():
        setattr(g, k, Var(v))
    return g


def _wait_for(g, needle, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        hits = [ln for ln in g.lines if needle in ln]
        if hits:
            return hits[-1]
        time.sleep(0.05)
    raise AssertionError(f"no {needle!r} in {g.lines}")


def test_virtual_connect_and_auto_scan(tmp_path):
    """Connection tab with the virtual rig, then the scan tab's auto-scan:
    the port's ``Scanner`` over the port's ``VirtualRig`` writes every
    stop."""
    g = _headless_gui(tmp_path, var_virtual=True, var_status="",
                      var_scan_name="obj", var_turns=2, var_degrees=180.0,
                      var_resume=True)
    g.do_connect()
    _wait_for(g, "rig connected")
    from structured_light_for_3d_model_replication_tpu_torch.hw.rig import (
        VirtualRig,
    )

    assert isinstance(g._virtual_rig, VirtualRig)
    assert g.var_status.get() == "ready (virtual)"
    g.scanner.timings = type(g.scanner.timings)(settle_s=0.0)
    g.do_auto_scan()
    _wait_for(g, "auto scan done: 2 stops")
    stops = g.layout.stop_dirs("obj", 180.0)
    assert len(stops) == 2
    assert all(len(os.listdir(s)) == g._virtual_rig.proj.n_frames
               for s in stops)


def test_cleanup_mesh_and_preview_run_on_the_gui_device(tmp_path, rng):
    """The process tab's cleanup buttons, the mesh tab and a preview reach
    the port's entry points with ``device="cpu"``: the cloud is cleaned in
    place, the STL written, the PNG written and the popup's failure
    logged."""
    v = rng.normal(size=(3000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = (v * 40.0 + np.array([0.0, 0.0, 500.0])).astype(np.float32)
    pts[:20] += 400.0                      # far outliers
    src = str(tmp_path / "merged.ply")
    ply_io.write_ply(src, ply_io.PointCloud(points=pts))
    out = str(tmp_path / "model.stl")
    g = _headless_gui(tmp_path, var_merge_out=src, var_mesh_in=src,
                      var_mesh_out=out, var_mesh_depth=5, var_mesh_trim=0.0,
                      var_mesh_orient="radial")
    g.do_remove_outliers()
    line = _wait_for(g, "remove-outliers:")
    assert line.startswith("remove-outliers: 3000 -> ")
    assert len(ply_io.read_ply(src)) < 3000
    g.do_mesh()
    _wait_for(g, "meshed ->")
    assert os.path.getsize(out) > 0
    g.do_preview(g.var_merge_out.get, mode="outliers")
    _wait_for(g, "preview window unavailable")
    assert os.path.getsize(str(tmp_path / "merged_outliers.png")) > 0
