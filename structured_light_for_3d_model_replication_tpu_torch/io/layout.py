"""Filesystem session layout — the checkpoint/resume system (counterpart of
the JAX ``io/layout.py``).

The reference's durability model is its directory tree: every stage writes
files the next stage re-reads, so any stage can resume from disk
(SURVEY.md §5; layout constants at `server/gui.py:31-40,82-83,703-740`):

    {dd_mm_YYYY}_3Dscan/
      calib/pose_N/{01..NN}.png     calibration captures, one folder per pose
      calib/calib.mat               the stereo calibration artifact
      scans/{name}/{01..NN}.bmp     single scans
      scans_360/{base}_{deg}deg_AUTO/{base}_{angle}deg_scan/   auto-scan stops

Typed paths, enumeration in numeric order, and resume detection (which
stops already hold a full stack).
"""

from __future__ import annotations

import dataclasses
import glob
import os

from ..config import dated_output_root
from .images import numeric_sort


def frame_name(idx: int, ext: str = "png") -> str:
    """1-based protocol index → filename (`{idx:02d}` per the reference's
    capture numbering `server/sl_system.py:158-178,436-451`)."""
    return f"{idx:02d}.{ext}"


@dataclasses.dataclass(frozen=True)
class SessionLayout:
    root: str

    @classmethod
    def today(cls, base: str = ".") -> "SessionLayout":
        return cls(dated_output_root(base))

    # -- calibration ------------------------------------------------------
    @property
    def calib_dir(self) -> str:
        return os.path.join(self.root, "calib")

    @property
    def calib_mat(self) -> str:
        return os.path.join(self.calib_dir, "calib.mat")

    def pose_dir(self, pose: int) -> str:
        return os.path.join(self.calib_dir, f"pose_{pose}")

    def pose_dirs(self) -> list[str]:
        return numeric_sort(glob.glob(os.path.join(self.calib_dir, "pose_*")))

    # -- single scans -----------------------------------------------------
    @property
    def scans_dir(self) -> str:
        return os.path.join(self.root, "scans")

    def scan_dir(self, name: str) -> str:
        return os.path.join(self.scans_dir, name)

    # -- 360° auto scans --------------------------------------------------
    @property
    def scans_360_dir(self) -> str:
        return os.path.join(self.root, "scans_360")

    def auto_session_dir(self, base: str, degrees: float) -> str:
        return os.path.join(self.scans_360_dir,
                            f"{base}_{degrees:g}deg_AUTO")

    def stop_dir(self, base: str, degrees: float, angle: float) -> str:
        return os.path.join(self.auto_session_dir(base, degrees),
                            f"{base}_{angle:g}deg_scan")

    def stop_dirs(self, base: str, degrees: float) -> list[str]:
        pat = os.path.join(self.auto_session_dir(base, degrees), "*_scan")
        return numeric_sort(glob.glob(pat))

    # -- resume -----------------------------------------------------------
    def completed_stops(self, base: str, degrees: float,
                        expected_frames: int) -> list[str]:
        """Stop folders that already hold a full frame stack — the resume
        point for an interrupted auto-scan."""
        done = []
        for d in self.stop_dirs(base, degrees):
            n = 0
            for ext in ("bmp", "png", "jpg", "jpeg"):
                n = max(n, len(glob.glob(os.path.join(d, f"*.{ext}"))))
            if n >= expected_frames:
                done.append(d)
        return done

    def ensure(self) -> "SessionLayout":
        for d in (self.calib_dir, self.scans_dir, self.scans_360_dir):
            os.makedirs(d, exist_ok=True)
        return self


def list_clouds(folder: str) -> list[str]:
    """All .ply files, numerically ordered (`server/processing.py:121-129`
    sorts lexically; the legacy numeric sort is strictly better)."""
    return numeric_sort(glob.glob(os.path.join(folder, "*.ply")))
