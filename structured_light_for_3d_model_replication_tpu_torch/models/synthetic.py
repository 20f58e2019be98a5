"""Synthetic structured-light scanner (NumPy copy of the JAX package's
``models/synthetic.py`` scan half): a ray-traced simulator that renders the
frame stack a camera would capture while the projector plays the Gray-code
sequence over a known scene, so the port can be driven end to end — on the
host or on the card — without the JAX package.

Scenes are unions of spheres plus an optional background wall. A turntable
is simulated by rotating the spheres about a vertical axis through a pivot.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import ProjectorConfig
from .oracle import camera_rays_np


@dataclasses.dataclass(frozen=True)
class Sphere:
    center: tuple  # (x, y, z) mm, camera frame at angle 0
    radius: float
    albedo: float = 0.9  # fraction of projector brightness reflected


@dataclasses.dataclass(frozen=True)
class Scene:
    spheres: tuple = (
        Sphere((0.0, 10.0, 500.0), 80.0, 0.9),
        Sphere((45.0, -55.0, 470.0), 35.0, 0.7),  # bump: breaks symmetry
    )
    wall_z: float | None = 700.0
    wall_albedo: float = 0.35
    pivot: tuple = (0.0, 0.0, 500.0)  # turntable axis through this, along +y
    ambient: float = 4.0


def default_calibration(cam_height: int = 270, cam_width: int = 480,
                        proj: ProjectorConfig = ProjectorConfig()):
    """A plausible synthetic camera/projector rig: (cam_K, proj_K, R, T)
    with stereoCalibrate convention X_p = R X_c + T (mm)."""
    f_cam = 1.1 * cam_width
    cam_K = np.array(
        [[f_cam, 0, cam_width / 2 - 0.5],
         [0, f_cam, cam_height / 2 - 0.5],
         [0, 0, 1]], dtype=np.float64)
    f_proj = 1.2 * proj.width
    proj_K = np.array(
        [[f_proj, 0, proj.width / 2 - 0.5],
         [0, f_proj, proj.height / 2 - 0.5],
         [0, 0, 1]], dtype=np.float64)
    # Projector sits 150 mm to the camera's left, toed in ~8° about y.
    ang = np.deg2rad(8.0)
    R = np.array(
        [[np.cos(ang), 0, -np.sin(ang)],
         [0, 1, 0],
         [np.sin(ang), 0, np.cos(ang)]], dtype=np.float64)
    T = np.array([150.0, 0.0, 20.0], dtype=np.float64)
    return cam_K, proj_K, R, T


def rotated_scene(scene: Scene, angle_deg: float) -> Scene:
    """Scene after the turntable rotates by angle_deg about the pivot's y."""
    th = np.deg2rad(angle_deg)
    Ry = np.array([[np.cos(th), 0, np.sin(th)],
                   [0, 1, 0],
                   [-np.sin(th), 0, np.cos(th)]], dtype=np.float64)
    pivot = np.asarray(scene.pivot)
    spheres = tuple(
        Sphere(tuple(pivot + Ry @ (np.asarray(s.center) - pivot)), s.radius,
               s.albedo)
        for s in scene.spheres)
    return dataclasses.replace(scene, spheres=spheres)


def raycast(scene: Scene, rays: np.ndarray):
    """Intersect unit rays from the origin with the scene: (t, albedo,
    hit_object, hit_any), nearest positive hit wins; the wall is a hit but
    not "object"."""
    N = rays.shape[0]
    t_best = np.full(N, np.inf)
    albedo = np.zeros(N)
    is_object = np.zeros(N, dtype=bool)
    for s in scene.spheres:
        c = np.asarray(s.center, np.float64)
        b = rays @ c
        disc = b * b - (c @ c - s.radius**2)
        ok = disc > 0
        sq = np.sqrt(np.where(ok, disc, 0.0))
        t0 = b - sq
        t1 = b + sq
        t = np.where(t0 > 1e-6, t0, t1)
        ok &= t > 1e-6
        closer = ok & (t < t_best)
        t_best = np.where(closer, t, t_best)
        albedo = np.where(closer, s.albedo, albedo)
        is_object = np.where(closer, True, is_object)
    if scene.wall_z is not None:
        rz = rays[:, 2]
        ok = rz > 1e-6
        t = np.where(ok, scene.wall_z / np.where(ok, rz, 1.0), np.inf)
        closer = ok & (t < t_best)
        t_best = np.where(closer, t, t_best)
        albedo = np.where(closer, scene.wall_albedo, albedo)
        is_object = np.where(closer, False, is_object)
    hit = np.isfinite(t_best)
    t_best = np.where(hit, t_best, 0.0)
    return t_best, albedo, is_object, hit


class FrameShader:
    """Geometry of one scene pose, precomputed once; shades ANY projector
    frame into the camera image."""

    def __init__(self, scene: Scene, cam_K, proj_K, R, T,
                 cam_height: int, cam_width: int,
                 proj: ProjectorConfig = ProjectorConfig()):
        self.cam_height, self.cam_width = cam_height, cam_width
        self.proj = proj
        rays = camera_rays_np(cam_K, cam_height, cam_width).reshape(-1, 3)
        t, albedo, is_object, hit = raycast(scene, rays)
        points = t[:, None] * rays
        P_p = points @ R.T + T[None, :]
        z = P_p[:, 2]
        ok_z = z > 1e-6
        u = np.where(ok_z, (proj_K[0, 0] * P_p[:, 0] + proj_K[0, 2] * z)
                     / np.where(ok_z, z, 1.0), -1.0)
        v = np.where(ok_z, (proj_K[1, 1] * P_p[:, 1] + proj_K[1, 2] * z)
                     / np.where(ok_z, z, 1.0), -1.0)
        ui = np.round(u).astype(np.int64)
        vi = np.round(v).astype(np.int64)
        lit = (hit & ok_z & (ui >= 0) & (ui < proj.width)
               & (vi >= 0) & (vi < proj.height))
        self._ui = np.clip(ui, 0, proj.width - 1)
        self._vi = np.clip(vi, 0, proj.height - 1)
        self._lit = lit
        self._hit = hit
        self._albedo = albedo
        self._ambient = scene.ambient
        self.ground_truth = {
            "points": points.reshape(cam_height, cam_width, 3),
            "proj_u": u.reshape(cam_height, cam_width),
            "proj_v": v.reshape(cam_height, cam_width),
            "object_mask": is_object.reshape(cam_height, cam_width),
            "hit_mask": hit.reshape(cam_height, cam_width),
            "lit_mask": lit.reshape(cam_height, cam_width),
        }

    def shade(self, frame: np.ndarray) -> np.ndarray:
        """(proj_h, proj_w[, 3]) frame -> (cam_h, cam_w) uint8 image."""
        frame = np.asarray(frame)
        if frame.ndim == 3:
            frame = frame.mean(axis=-1)
        proj_val = frame[self._vi, self._ui].astype(np.float64)
        val = np.where(self._lit, self._albedo * proj_val + self._ambient,
                       np.where(self._hit, self._ambient, 0.0))
        return np.clip(val, 0, 255).astype(np.uint8).reshape(
            self.cam_height, self.cam_width)


def pattern_frames(proj: ProjectorConfig) -> np.ndarray:
    """The projector's protocol-ordered Gray-code frames as a host array."""
    from ..ops.patterns import pattern_stack_for

    return pattern_stack_for(proj, device="cpu").numpy()


def render_scan(scene: Scene, cam_K, proj_K, R, T, cam_height: int,
                cam_width: int, proj: ProjectorConfig = ProjectorConfig(),
                frames: np.ndarray | None = None):
    """Render one turntable stop: (stack (n_frames, H, W) uint8,
    ground-truth dict)."""
    if frames is None:
        frames = pattern_frames(proj)
    shader = FrameShader(scene, cam_K, proj_K, R, T, cam_height, cam_width,
                         proj)
    return np.stack([shader.shade(f) for f in frames]), shader.ground_truth


def render_turntable_scans(scene: Scene, n_stops: int,
                           degrees_per_stop: float, cam_K, proj_K, R, T,
                           cam_height: int, cam_width: int,
                           proj: ProjectorConfig = ProjectorConfig()):
    """Stacks for a turntable schedule: list of (stack, gt)."""
    frames = pattern_frames(proj)
    return [render_scan(rotated_scene(scene, k * degrees_per_stop), cam_K,
                        proj_K, R, T, cam_height, cam_width, proj, frames)
            for k in range(n_stops)]
