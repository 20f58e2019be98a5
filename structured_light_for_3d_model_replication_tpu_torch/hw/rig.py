"""Virtual scanning rig: projector + camera + turntable, fully headless.

Binds a synthetic :class:`~..models.synthetic.Scene` to the hardware
abstractions so the complete capture stack — pattern display, camera
trigger, turntable rotation, file layout — runs with zero hardware. The
reference can only simulate the turntable (`server/gui.py:690-693`); its
capture path needs a physical phone (SURVEY §4). This rig closes that gap
and doubles as the integration-test harness for the scanner orchestrator.

The turntable angle rotates the SCENE (object on the table), not the camera
— same physics as the real rig (`models/synthetic.rotated_scene`).
"""

from __future__ import annotations

import numpy as np

from ..config import ProjectorConfig
from ..models import synthetic
from .camera import SyntheticCamera
from .projector import VirtualProjector
from .turntable import SimulatedTurntable


class VirtualRig:
    def __init__(
        self,
        scene: synthetic.Scene | None = None,
        cam_height: int = 96,
        cam_width: int = 160,
        proj: ProjectorConfig = ProjectorConfig(width=256, height=128),
        calibration=None,
        time_scale: float = 0.0,
    ):
        self.scene = scene or synthetic.Scene()
        self.cam_height, self.cam_width = cam_height, cam_width
        self.proj = proj
        if calibration is None:
            calibration = synthetic.default_calibration(cam_height, cam_width,
                                                        proj)
        self.cam_K, self.proj_K, self.R, self.T = calibration
        self.projector = VirtualProjector(proj, record=True)
        self.turntable = SimulatedTurntable(time_scale=time_scale)
        self.camera = SyntheticCamera(self.projector, self._shader)
        self._shader_cache: tuple[float, synthetic.FrameShader] | None = None

    def _shader(self) -> synthetic.FrameShader:
        angle = self.turntable.angle_deg
        if self._shader_cache is None or self._shader_cache[0] != angle:
            sc = synthetic.rotated_scene(self.scene, angle)
            self._shader_cache = (angle, synthetic.FrameShader(
                sc, self.cam_K, self.proj_K, self.R, self.T,
                self.cam_height, self.cam_width, self.proj))
        return self._shader_cache[1]

    @property
    def ground_truth(self) -> dict:
        """Analytic ground truth at the CURRENT turntable angle."""
        return self._shader().ground_truth

    def white_frame(self) -> np.ndarray:
        return np.full((self.proj.height, self.proj.width),
                       self.proj.brightness, np.uint8)
