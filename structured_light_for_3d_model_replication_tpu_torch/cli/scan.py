"""``scan``: drive a capture rig — real hardware or the virtual simulator
(the port's copy of the JAX package's ``cli/scan.py``).

Headless version of the GUI's capture workflows (`server/gui.py`): single
scans, calibration poses, and the flagship auto-360 loop
(`server/gui.py:686-773`), with resume. ``--virtual`` swaps in the ray-traced
rig (`hw/rig.VirtualRig`) — the reference has no equivalent (its only mock is
a `time.sleep(2)` turntable stub, `server/gui.py:690-693`).

Real-hardware mode starts the pull-mode command server (`server/server.py`
semantics) for the phone browser client and, when ``--serial`` is given, the
ESP32 turntable driver (`server/arduino.py`).

Capture is host work (project → trigger → wait), so this tool takes no
``--device``.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="scan",
                                description="Capture scans, 360 sessions or "
                                            "calibration poses")
    p.add_argument("command", choices=("auto360", "single", "calib-pose"))
    p.add_argument("--name", default="scan", help="scan/session base name")
    p.add_argument("--session", default=".",
                   help="session root (dated layout created inside)")
    p.add_argument("--turns", type=int, default=12)
    p.add_argument("--degrees", type=float, default=30.0)
    p.add_argument("--pose", type=int, default=1,
                   help="calibration pose index")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--virtual", action="store_true",
                   help="ray-traced virtual rig instead of hardware")
    p.add_argument("--port", type=int, default=5000,
                   help="pull-mode HTTP command server port")
    p.add_argument("--serial", default=None,
                   help="turntable serial port (e.g. /dev/ttyUSB0); "
                        "omit to scan without rotation control")
    p.add_argument("--push-host", default=None,
                   help="push-mode Android host base URL instead of the "
                        "pull-mode server (e.g. http://127.0.0.1:8765)")
    p.add_argument("--local-cam", type=int, default=None, metavar="ID",
                   help="local webcam device id (cv2.VideoCapture) instead "
                        "of a phone — the reference's no-phone capture rig "
                        "(Old/sl_calib_capture.py)")
    p.add_argument("--cam-size", default="1920x1080", metavar="WxH",
                   help="requested local-camera frame size")
    p.add_argument("--health-json", default=None, metavar="PATH",
                   help="write the capture health report (per-stop retries, "
                        "failed/skipped stops) as JSON — auto360 only")
    return p


def _build_rig(args):
    from ..config import ProjectorConfig
    from ..io.layout import SessionLayout
    from ..scanner import Scanner

    layout = SessionLayout.today(args.session).ensure()
    if args.virtual:
        from ..hw.rig import VirtualRig

        rig = VirtualRig()
        return Scanner(rig.camera, rig.projector, rig.turntable,
                       proj=rig.proj, layout=layout), None

    proj_cfg = ProjectorConfig()
    from ..hw.projector import WindowProjector

    projector = WindowProjector(proj_cfg)

    server = None
    if args.local_cam is not None:
        from ..hw.camera import LocalCamera

        w, h = (int(x) for x in args.cam_size.lower().split("x"))
        camera = LocalCamera(args.local_cam, width=w, height=h)
    elif args.push_host:
        from ..hw.camera import PushCamera

        camera = PushCamera(args.push_host)
    else:
        from ..hw.command_server import CommandServer

        server = CommandServer(port=args.port)
        server.start()
        print(f"command server on :{args.port} — point the phone client at "
              f"this host", file=sys.stderr)
        from ..hw.camera import PullCamera

        camera = PullCamera(server.channel)

    turntable = None
    if args.serial:
        from ..hw.turntable import SerialTurntable

        turntable = SerialTurntable(args.serial)

    return Scanner(camera, projector, turntable, proj=proj_cfg,
                   layout=layout), server


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    scanner, server = _build_rig(args)
    try:
        if args.command == "single":
            out = scanner.capture_scan(args.name)
        elif args.command == "calib-pose":
            out = scanner.capture_calibration_pose(args.pose)
        else:
            def progress(p):
                print(f"stop {p.stop}/{p.total_stops}: elapsed "
                      f"{p.elapsed_s:.0f}s avg {p.avg_stop_s:.1f}s "
                      f"remaining ~{p.remaining_s:.0f}s", file=sys.stderr)

            from ..health import ScanHealthReport

            health = ScanHealthReport()
            stops = scanner.auto_scan_360(
                args.name, degrees_per_turn=args.degrees, turns=args.turns,
                resume=not args.no_resume, on_progress=progress,
                health=health)
            out = f"{len(stops)} stops"
            if health.failed_stops:
                print(f"degraded: stops {health.failed_stops} failed and "
                      f"were skipped", file=sys.stderr)
            health.emit()
            if args.health_json:
                health.write(args.health_json)
        print(f"done: {out}", file=sys.stderr)
        return 0
    finally:
        if server is not None:
            server.stop()


if __name__ == "__main__":
    raise SystemExit(main())
