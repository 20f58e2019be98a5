"""Tkinter GUI orchestrator — the interactive six-tab workstation (the
port's copy of the JAX package's ``gui.py``).

Feature parity with the reference's `ScannerGUI` (`server/gui.py:15-774`,
6 tabs: connection, calibration, scanning, cloud generation, processing,
meshing) rebuilt over this framework's headless layers: the GUI owns a
:class:`~.scanner.Scanner`, a :class:`~.hw.command_server.CommandServer` and
a :class:`~.hw.turntable.SerialTurntable`/:class:`SimulatedTurntable`, and
every button dispatches onto a daemon worker thread with results marshalled
back via ``root.after`` — the reference's threading discipline
(`server/gui.py:475,541,620,641,684,773`, marshalling `:495-498`).

Differences by design:

* all compute buttons call the port's pipeline entry points on the device
  the GUI is given (default ``cuda``; the reference calls NumPy/Open3D
  inline);
* the auto-scan tab supports RESUME (skips complete stops) and a
  "virtual rig" toggle — the reference's only simulation is a sleep stub
  (`server/gui.py:690-693,764-765`);
* progress/elapsed/remaining timing mirrors `server/gui.py:727-731`.

Headless-safe: importing this module must not require a display; the Tk
root is only created inside :func:`main` / :class:`ScannerGUI`.
"""

from __future__ import annotations

import os
import queue
import threading
import traceback

from .config import ProjectorConfig, TurntableConfig
from .io.layout import SessionLayout
from .utils.log import get_logger

log = get_logger(__name__)


class WorkerMixin:
    """One daemon worker per action + an `after`-pumped result queue."""

    POLL_MS = 100

    def _init_worker(self, root):
        self._root = root
        self._q: queue.Queue = queue.Queue()
        self._pump()

    def _pump(self):
        try:
            while True:
                fn, args = self._q.get_nowait()
                fn(*args)
        except queue.Empty:
            pass
        self._root.after(self.POLL_MS, self._pump)

    def call_ui(self, fn, *args):
        """Queue a callable for the Tk thread (root.after marshalling,
        `server/gui.py:495-498`)."""
        self._q.put((fn, args))

    def run_bg(self, name: str, work, on_done=None, on_error=None):
        def runner():
            try:
                result = work()
            except Exception as e:  # surface, never kill the UI
                log.error("%s failed: %s\n%s", name, e,
                          traceback.format_exc())
                if on_error is not None:
                    self.call_ui(on_error, e)
                return
            if on_done is not None:
                self.call_ui(on_done, result)

        threading.Thread(target=runner, daemon=True, name=name).start()


def selected_pose_dirs(all_pose_dirs, selection: dict) -> list:
    """Pose-culling filter (the reference's pose-selection step,
    `server/gui.py:500-523`): keep a pose directory iff its basename is
    checked. With no analysis yet (empty selection) every pose is used —
    the reference's 'all' answer."""
    if not selection:
        return list(all_pose_dirs)
    return [d for d in all_pose_dirs
            if selection.get(os.path.basename(d), False)]


class ScannerGUI(WorkerMixin):
    """Six-tab Tk application. Instantiate with a ``tk.Tk()`` root."""

    def __init__(self, root, session_base: str = ".", device: str = "cuda"):
        import tkinter as tk
        from tkinter import ttk

        self.tk = tk
        self.ttk = ttk
        self.root = root
        root.title("Structured Light 3D Scanner")
        self._init_worker(root)
        self.device = device

        self.layout = SessionLayout.today(session_base).ensure()
        self.proj_cfg = ProjectorConfig()
        self.tt_cfg = TurntableConfig()

        self.server = None
        self.turntable = None
        self.scanner = None
        self._virtual_rig = None

        # -- runtime parameters (the reference's ~30 Tk vars,
        # `server/gui.py:27-83`) --
        self.var_port = tk.IntVar(value=5000)
        self.var_serial = tk.StringVar(value="/dev/ttyUSB0")
        self.var_virtual = tk.BooleanVar(value=False)
        self.var_scan_name = tk.StringVar(value="scan")
        self.var_turns = tk.IntVar(value=self.tt_cfg.turns)
        self.var_degrees = tk.DoubleVar(value=self.tt_cfg.degrees_per_turn)
        self.var_resume = tk.BooleanVar(value=True)
        self.var_pose = tk.IntVar(value=1)
        self.var_calib_file = tk.StringVar(value=self.layout.calib_mat)
        self.var_scan_dir = tk.StringVar(value="")
        self.var_cloud_out = tk.StringVar(value="cloud.ply")
        self.var_thresholds = tk.StringVar(value="adaptive")
        self.var_merge_dir = tk.StringVar(value="")
        self.var_merge_out = tk.StringVar(value="merged.ply")
        self.var_merge_method = tk.StringVar(value="posegraph")
        self.var_voxel = tk.DoubleVar(value=0.02)
        self.var_mesh_in = tk.StringVar(value="merged.ply")
        self.var_mesh_out = tk.StringVar(value="model.stl")
        self.var_mesh_depth = tk.IntVar(value=8)  # ≤8 dense; 9-16 sparse solver
        self.var_mesh_trim = tk.DoubleVar(value=0.0)
        self.var_mesh_orient = tk.StringVar(value="radial")
        self.var_status = tk.StringVar(value="disconnected")

        nb = ttk.Notebook(root)
        nb.pack(fill="both", expand=True)
        self._build_connection_tab(nb)
        self._build_calibration_tab(nb)
        self._build_scan_tab(nb)
        self._build_cloud_tab(nb)
        self._build_process_tab(nb)
        self._build_mesh_tab(nb)

        self.log_box = tk.Text(root, height=8, state="disabled")
        self.log_box.pack(fill="x")

    # ------------------------------------------------------------------
    # UI plumbing
    # ------------------------------------------------------------------

    def log_line(self, msg: str):
        log.info("%s", msg)
        self.log_box.configure(state="normal")
        self.log_box.insert("end", msg + "\n")
        self.log_box.see("end")
        self.log_box.configure(state="disabled")

    def _row(self, parent, label, widget_fn):
        f = self.ttk.Frame(parent)
        f.pack(fill="x", padx=8, pady=2)
        self.ttk.Label(f, text=label, width=22).pack(side="left")
        w = widget_fn(f)
        w.pack(side="left", fill="x", expand=True)
        return w

    def _entry(self, parent, label, var):
        return self._row(parent, label,
                         lambda f: self.ttk.Entry(f, textvariable=var))

    def _button(self, parent, text, cmd):
        b = self.ttk.Button(parent, text=text, command=cmd)
        b.pack(fill="x", padx=8, pady=3)
        return b

    def _tab(self, nb, title):
        frame = self.ttk.Frame(nb)
        nb.add(frame, text=title)
        return frame

    # ------------------------------------------------------------------
    # Tab 1: connection (`server/gui.py` connection tab; `server/main.py`)
    # ------------------------------------------------------------------

    def _build_connection_tab(self, nb):
        t = self._tab(nb, "Connection")
        self._entry(t, "HTTP port", self.var_port)
        self._entry(t, "Turntable serial", self.var_serial)
        self.ttk.Checkbutton(
            t, text="Virtual rig (ray-traced simulator)",
            variable=self.var_virtual).pack(anchor="w", padx=8)
        self._button(t, "Start capture stack", self.do_connect)
        self._button(t, "Stop", self.do_disconnect)
        self._row(t, "Status",
                  lambda f: self.ttk.Label(f, textvariable=self.var_status))

    def do_connect(self):
        def work():
            return self._build_scanner()

        def done(scanner):
            self.scanner = scanner
            self.var_status.set("ready (virtual)" if self.var_virtual.get()
                                else "ready")
            self.log_line("rig connected")

        self.run_bg("connect", work, done,
                    lambda e: self.var_status.set(f"error: {e}"))

    def _build_scanner(self):
        from .scanner import Scanner

        if self.var_virtual.get():
            from .hw.rig import VirtualRig

            rig = VirtualRig()
            self._virtual_rig = rig
            return Scanner(rig.camera, rig.projector, rig.turntable,
                           proj=rig.proj, layout=self.layout)

        from .hw.camera import PullCamera
        from .hw.command_server import CommandServer
        from .hw.projector import WindowProjector

        self.server = CommandServer(port=self.var_port.get()).start()
        camera = PullCamera(self.server.channel)
        projector = WindowProjector(self.proj_cfg)
        turntable = None
        port = self.var_serial.get().strip()
        if port:
            try:
                from .hw.turntable import SerialTurntable

                turntable = SerialTurntable(port, baud=self.tt_cfg.baud)
            except Exception as e:
                # The reference offers "Continue anyway (Simulation)?"
                # (`server/gui.py:690-693`); headless default: warn + no table.
                self.call_ui(self.log_line,
                             f"turntable unavailable ({e}); continuing "
                             f"without rotation")
        return Scanner(camera, projector, turntable, proj=self.proj_cfg,
                       layout=self.layout)

    def do_disconnect(self):
        if self.server is not None:
            self.server.stop()
            self.server = None
        self.scanner = None
        self.var_status.set("disconnected")
        self.log_line("disconnected")

    # ------------------------------------------------------------------
    # Tab 2: calibration (`server/gui.py:470-523`)
    # ------------------------------------------------------------------

    def _build_calibration_tab(self, nb):
        t = self._tab(nb, "Calibration")
        self._entry(t, "Pose index", self.var_pose)
        self._button(t, "Capture pose", self.do_calib_capture)
        self._button(t, "Analyze poses (reprojection)", self.do_calib_analyze)
        # Pose-culling list (the reference's prompt_pose_selection dialog,
        # `server/gui.py:500-523`): Analyze fills one checkbox per pose
        # with its reprojection errors; Final calibrates on the CHECKED
        # subset only (all poses until an analysis has run).
        self._row(t, "Poses (after analyze)",
                  lambda f: self.ttk.Label(f, text="all (run Analyze to "
                                                   "cull)"))
        self.pose_list_frame = self.ttk.Frame(t)
        self.pose_list_frame.pack(fill="x", padx=30)
        self.pose_checks: dict = {}
        self._button(t, "Final stereo calibration (selected poses)",
                     self.do_calib_final)
        self._entry(t, "Calibration file", self.var_calib_file)

    def _need_scanner(self):
        if self.scanner is None:
            self.log_line("connect a rig first (Connection tab)")
            return True
        return False

    def do_calib_capture(self):
        if self._need_scanner():
            return
        pose = self.var_pose.get()
        self.run_bg(
            "calib-capture",
            lambda: self.scanner.capture_calibration_pose(pose),
            lambda out: (self.log_line(f"pose {pose} captured -> {out}"),
                         self.var_pose.set(pose + 1)))

    def do_calib_analyze(self):
        from . import calibration

        calib_dir = self.layout.calib_dir

        def work():
            return calibration.analyze_calibration(calib_dir,
                                                   device=self.device)

        def done(res):
            errors, _poses = res
            self.log_line("per-pose reprojection (px): " + ", ".join(
                f"{p}: cam={ce:.2f} proj={pe:.2f}"
                for p, (ce, pe) in errors.items()))
            self._populate_pose_checks(errors)

        self.run_bg("calib-analyze", work, done,
                    on_error=lambda e: self.log_line(f"analyze failed: {e}"))

    def _populate_pose_checks(self, errors):
        """Rebuild the pose-culling checkboxes from an analysis result
        ({pose: (cam_err, proj_err)}); everything starts checked, like the
        reference's 'all' default (`server/gui.py:514-515`)."""
        for child in self.pose_list_frame.winfo_children():
            child.destroy()
        self.pose_checks = {}
        for pose, (ce, pe) in errors.items():
            var = self.tk.BooleanVar(value=True)
            self.ttk.Checkbutton(
                self.pose_list_frame,
                text=f"{pose}   cam={ce:.2f}px  proj={pe:.2f}px",
                variable=var).pack(anchor="w")
            self.pose_checks[pose] = var

    def do_calib_final(self):
        from . import calibration

        out = self.var_calib_file.get()
        selection = {p: bool(v.get()) for p, v in self.pose_checks.items()}
        pose_dirs = selected_pose_dirs(self.layout.pose_dirs(), selection)
        if len(pose_dirs) < 3:
            self.log_line(f"need >= 3 selected poses ({len(pose_dirs)} "
                          f"checked)")
            return

        def work():
            return calibration.calibrate_final(pose_dirs, out,
                                               device=self.device)

        self.run_bg("calib-final", work,
                    lambda res: self.log_line(
                        f"calibration saved -> {out} "
                        f"({len(pose_dirs)} poses, "
                        f"stereo RMS {res[1].rms:.3f})"))

    # ------------------------------------------------------------------
    # Tab 3: scanning (`server/gui.py:686-773`)
    # ------------------------------------------------------------------

    def _build_scan_tab(self, nb):
        t = self._tab(nb, "Scan")
        self._entry(t, "Scan name", self.var_scan_name)
        self._button(t, "Capture single scan", self.do_single_scan)
        self._entry(t, "Turns", self.var_turns)
        self._entry(t, "Degrees per turn", self.var_degrees)
        self.ttk.Checkbutton(t, text="Resume incomplete session",
                             variable=self.var_resume).pack(anchor="w",
                                                            padx=8)
        self._button(t, "START AUTO SCAN", self.do_auto_scan)

    def do_single_scan(self):
        if self._need_scanner():
            return
        name = self.var_scan_name.get()
        self.run_bg("scan", lambda: self.scanner.capture_scan(name),
                    lambda out: self.log_line(f"scan captured -> {out}"))

    def do_auto_scan(self):
        if self._need_scanner():
            return
        name = self.var_scan_name.get()
        turns, degs = self.var_turns.get(), self.var_degrees.get()
        resume = self.var_resume.get()

        def progress(p):
            self.call_ui(self.log_line,
                         f"stop {p.stop}/{p.total_stops} "
                         f"elapsed {p.elapsed_s:.0f}s "
                         f"avg {p.avg_stop_s:.1f}s "
                         f"remaining ~{p.remaining_s:.0f}s")

        self.run_bg(
            "auto-scan",
            lambda: self.scanner.auto_scan_360(
                name, degrees_per_turn=degs, turns=turns, resume=resume,
                on_progress=progress),
            lambda stops: self.log_line(f"auto scan done: {len(stops)} "
                                        f"stops"))

    # ------------------------------------------------------------------
    # Tab 4: cloud generation (`server/gui.py:549-567`, batch `:600-615`)
    # ------------------------------------------------------------------

    def _build_cloud_tab(self, nb):
        t = self._tab(nb, "Cloud")
        self._entry(t, "Scan folder (or batch root)", self.var_scan_dir)
        self._entry(t, "Calibration .mat", self.var_calib_file)
        self._entry(t, "Output .ply / dir", self.var_cloud_out)
        self._row(t, "Thresholds", lambda f: self.ttk.Combobox(
            f, textvariable=self.var_thresholds,
            values=("adaptive", "fixed"), state="readonly"))
        self._button(t, "Generate point cloud(s)", self.do_cloud_gen)
        self._button(t, "Preview cloud (PNG)",
                     lambda: self.do_preview(self.var_cloud_out.get))

    def do_cloud_gen(self):
        from .cli import process_cloud

        argv = ["-i", self.var_scan_dir.get(),
                "-c", self.var_calib_file.get(),
                "-o", self.var_cloud_out.get(),
                "--thresholds", self.var_thresholds.get(),
                "--device", self.device]
        self.run_bg("cloud-gen", lambda: process_cloud.main(argv),
                    lambda rc: self.log_line(
                        f"cloud generation {'done' if rc == 0 else 'failed'}"
                        f" -> {self.var_cloud_out.get()}"))

    # ------------------------------------------------------------------
    # Tab 5: processing/merge (`server/gui.py:620-641`)
    # ------------------------------------------------------------------

    def _build_process_tab(self, nb):
        t = self._tab(nb, "Process")
        self._entry(t, "Cloud folder", self.var_merge_dir)
        self._entry(t, "Merged output", self.var_merge_out)
        self._row(t, "Method", lambda f: self.ttk.Combobox(
            f, textvariable=self.var_merge_method,
            values=("posegraph", "sequential"), state="readonly"))
        self._entry(t, "Voxel size", self.var_voxel)
        self._button(t, "Merge 360 point clouds", self.do_merge)
        self._button(t, "Remove background (plane)", self.do_remove_bg)
        self._button(t, "Remove outliers (SOR)", self.do_remove_outliers)
        self._button(t, "Preview merged (PNG)",
                     lambda: self.do_preview(self.var_merge_out.get))
        self._button(t, "Preview outliers (PNG)",
                     lambda: self.do_preview(self.var_merge_out.get,
                                             mode="outliers"))
        self._button(t, "Preview plane split (PNG)",
                     lambda: self.do_preview(self.var_merge_out.get,
                                             mode="plane"))

    def do_merge(self):
        from .models import merge

        folder, out = self.var_merge_dir.get(), self.var_merge_out.get()
        params = merge.MergeParams(voxel_size=self.var_voxel.get())
        method = self.var_merge_method.get()

        self.run_bg(
            "merge",
            lambda: merge.merge_360_files(folder, out, params=params,
                                          method=method, device=self.device),
            lambda merged: self.log_line(
                f"merged {folder} -> {out} ({len(merged)} pts)"))

    def _cleanup(self, fn, tag):
        from .io import ply as ply_io

        src = self.var_merge_out.get()

        def work():
            cloud = ply_io.read_ply(src)
            cleaned = fn(cloud, device=self.device)
            ply_io.write_ply(src, cleaned)
            return len(cloud), len(cleaned)

        self.run_bg(tag, work,
                    lambda r: self.log_line(f"{tag}: {r[0]} -> {r[1]} pts "
                                            f"({src})"))

    def do_remove_bg(self):
        from .models import merge

        self._cleanup(merge.remove_background, "remove-background")

    def do_remove_outliers(self):
        from .models import merge

        self._cleanup(merge.remove_outliers, "remove-outliers")

    def do_preview(self, path_getter, mode: str | None = None):
        """Render a .ply/.stl to PNG (``cli view``) and pop it up in a
        Toplevel — the offline twin of the reference's Open3D viewer
        buttons (`Old/New360.py:72`, `Old/StatisticalOutlierRemoval.py:66`).
        Tk ≥ 8.6 reads PNG natively; headless use still gets the file."""
        src = path_getter() if callable(path_getter) else path_getter
        if not src:
            self.log_line("preview: set an output path first")
            return
        png = os.path.splitext(src)[0] + (f"_{mode}" if mode else "") + ".png"

        def work():
            from .cli import view as view_cli

            argv = [src, "-o", png, "--device", self.device] + (
                [f"--{mode}"] if mode else [])
            rc = view_cli.main(argv)
            if rc != 0:
                raise RuntimeError(f"view exited {rc}")
            return png

        def done(path):
            self.log_line(f"preview -> {path}")
            try:
                top = self.tk.Toplevel(self.root)
                top.title(path)
                photo = self.tk.PhotoImage(file=path)
                label = self.ttk.Label(top, image=photo)
                label.image = photo  # keep a ref: Tk GCs otherwise
                label.pack()
            except Exception as e:  # headless / pre-8.6 Tk: file still wrote
                self.log_line(f"preview window unavailable ({e}); "
                              f"open {path} manually")

        self.run_bg("preview", work, done,
                    on_error=lambda e: self.log_line(f"preview failed: {e}"))

    # ------------------------------------------------------------------
    # Tab 6: meshing (`server/gui.py:643-684`)
    # ------------------------------------------------------------------

    def _build_mesh_tab(self, nb):
        t = self._tab(nb, "Mesh")
        self._entry(t, "Input cloud", self.var_mesh_in)
        self._entry(t, "Output STL", self.var_mesh_out)
        self._entry(t, "Poisson depth", self.var_mesh_depth)
        self._entry(t, "Density trim quantile", self.var_mesh_trim)
        self._row(t, "Normal orientation", lambda f: self.ttk.Combobox(
            f, textvariable=self.var_mesh_orient,
            values=("radial", "tangent"), state="readonly"))
        self._button(t, "Run 360 meshing", self.do_mesh)
        self._button(t, "Preview mesh (PNG)",
                     lambda: self.do_preview(self.var_mesh_out.get))

    def do_mesh(self):
        from .io import ply as ply_io
        from .models import meshing

        src, out = self.var_mesh_in.get(), self.var_mesh_out.get()
        depth = self.var_mesh_depth.get()
        trim = self.var_mesh_trim.get()
        orient = self.var_mesh_orient.get()

        def work():
            cloud = ply_io.read_ply(src)
            return meshing.mesh_360(cloud, out, depth=depth,
                                    quantile_trim=trim,
                                    orientation_mode=orient,
                                    device=self.device)

        self.run_bg("mesh", work,
                    lambda mesh: self.log_line(
                        f"meshed -> {out} ({len(mesh.vertices)} verts, "
                        f"{len(mesh.faces)} faces)"))


def main(argv: list[str] | None = None) -> int:
    import argparse
    import tkinter as tk

    ap = argparse.ArgumentParser(description="the six-tab scanner GUI")
    ap.add_argument("--device", default="cuda",
                    help="torch device every compute button runs on "
                         "(default cuda; cpu runs on the host)")
    args = ap.parse_args(argv)
    root = tk.Tk()
    ScannerGUI(root, session_base=os.environ.get("SL_SESSION_BASE", "."),
               device=args.device)
    root.mainloop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
