"""Synthetic structured-light scanner (NumPy copy of the JAX package's
``models/synthetic.py`` scan and calibration halves): a ray-traced
simulator that renders the frame stack a camera would capture while the
projector plays the Gray-code sequence over a known scene — or over a
printed checkerboard (:func:`render_calibration_pose`) — so the port can be
driven end to end, on the host or on the card, without the JAX package.

Scenes are unions of spheres plus an optional background wall. A turntable
is simulated by rotating the spheres about a vertical axis through a pivot.
"""

from __future__ import annotations

import dataclasses
import threading

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


# numpy's OpenBLAS (seen with 0.3.27) returns wrong products when several
# threads call it at once: calibration poses rendered in a thread pool came
# out with pixels off by up to 81 grey levels, and a calibration solved on
# such poses to 11 px rms. Every matrix product of a render (a scan stop's
# :class:`FrameShader` and a calibration pose) takes this lock, so a render
# in a thread equals the sequential one bit for bit (and the JAX package's,
# which renders one pose at a time).
_PRODUCTS_LOCK = threading.Lock()


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
        with _PRODUCTS_LOCK:
            rays = camera_rays_np(cam_K, cam_height,
                                  cam_width).reshape(-1, 3)
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

    # torchlint: disable=host-read -- made on the host (device="cpu")
    return pattern_stack_for(proj, device="cpu").numpy()


# ``render_scan``'s and ``render_calibration_pose``'s ``pattern_frames``
# argument (the JAX package's name) shadows the function above in them.
_protocol_frames = pattern_frames


def render_scan(scene: Scene, cam_K, proj_K, R, T, cam_height: int,
                cam_width: int, proj: ProjectorConfig = ProjectorConfig(),
                pattern_frames: np.ndarray | None = None):
    """Render one turntable stop: (stack (n_frames, H, W) uint8,
    ground-truth dict). ``pattern_frames`` defaults to the protocol's."""
    if pattern_frames is None:
        pattern_frames = _protocol_frames(proj)
    shader = FrameShader(scene, cam_K, proj_K, R, T, cam_height, cam_width,
                         proj)
    return (np.stack([shader.shade(f) for f in pattern_frames]),
            shader.ground_truth)


def render_turntable_scans(scene: Scene, n_stops: int,
                           degrees_per_stop: float, cam_K, proj_K, R, T,
                           cam_height: int, cam_width: int,
                           proj: ProjectorConfig = ProjectorConfig()):
    """Stacks for a turntable schedule: list of (stack, gt)."""
    frames = pattern_frames(proj)
    return [render_scan(rotated_scene(scene, k * degrees_per_stop), cam_K,
                        proj_K, R, T, cam_height, cam_width, proj, frames)
            for k in range(n_stops)]


def render_calibration_pose(
    board_R: np.ndarray,
    board_t: np.ndarray,
    cam_K: np.ndarray,
    proj_K: np.ndarray,
    R: np.ndarray,
    T: np.ndarray,
    cam_height: int,
    cam_width: int,
    proj: ProjectorConfig = ProjectorConfig(),
    checker_cols: int = 7,
    checker_rows: int = 7,
    square_mm: float = 35.0,
    pattern_frames: np.ndarray | None = None,
    supersample: int = 3,
):
    """Render one calibration pose: a checkerboard plane under the projector.

    The board plane carries a printed checkerboard (dark/light squares) so
    `findChessboardCorners` has real corners to detect, and reflects the
    Gray-code patterns so the projector coordinates can be decoded at those
    corners — the full substrate of the reference's calibration capture
    (`server/sl_system.py:114-182`).

    board_R/board_t map board coords (x, y, 0) into the camera frame. Inner
    corners sit at (i*square, j*square), i in [0, cols), j in [0, rows).
    Returns (stack uint8, gt dict with corner camera pixels + projector uv).
    """
    if pattern_frames is None:
        pattern_frames = _protocol_frames(proj)

    sq = square_mm
    # Supersampled render: a real sensor pixel integrates over its footprint;
    # point-sampling a binary checker gives aliased edges that cap
    # cornerSubPix at ~0.5 px. Render at s x resolution and box-average.
    s = max(1, int(supersample))
    K_ss = cam_K.copy().astype(np.float64)
    K_ss[:2, :] *= s
    K_ss[0, 2] += (s - 1) / 2.0
    K_ss[1, 2] += (s - 1) / 2.0
    hs, ws = cam_height * s, cam_width * s
    with _PRODUCTS_LOCK:
        rays = camera_rays_np(K_ss, hs, ws).reshape(-1, 3)
        n = board_R[:, 2]  # board plane normal in camera frame
        denom = rays @ n
        ok = np.abs(denom) > 1e-9
        t_hit = np.where(ok, (board_t @ n) / np.where(ok, denom, 1.0),
                         np.inf)
        ok &= t_hit > 1e-6
        points = t_hit[:, None] * rays
        local = (points - board_t[None, :]) @ board_R  # board coords
        # Projector coordinates of every board point (same math as
        # render_scan).
        P_p = points @ R.T + T[None, :]
    bx, by = local[:, 0], local[:, 1]

    # Checker field spans one square beyond the inner-corner grid on each
    # side; a 1.5-square white margin rings it (printed board on white card).
    in_checker = (ok & (bx >= -sq) & (bx <= checker_cols * sq)
                  & (by >= -sq) & (by <= checker_rows * sq))
    in_margin = (ok & ~in_checker
                 & (bx >= -2.5 * sq) & (bx <= (checker_cols + 1.5) * sq)
                 & (by >= -2.5 * sq) & (by <= (checker_rows + 1.5) * sq))
    parity = (np.floor(bx / sq).astype(np.int64)
              + np.floor(by / sq).astype(np.int64)) % 2
    albedo = np.where(in_checker, np.where(parity == 0, 0.08, 0.85),
                      np.where(in_margin, 0.92, 0.0))
    hit = in_checker | in_margin

    z = P_p[:, 2]
    ok_z = z > 1e-6
    u = np.where(ok_z, (proj_K[0, 0] * P_p[:, 0] + proj_K[0, 2] * z)
                 / np.where(ok_z, z, 1.0), -1.0)
    v = np.where(ok_z, (proj_K[1, 1] * P_p[:, 1] + proj_K[1, 2] * z)
                 / np.where(ok_z, z, 1.0), -1.0)
    ui = np.clip(np.round(u).astype(np.int64), 0, proj.width - 1)
    vi = np.clip(np.round(v).astype(np.int64), 0, proj.height - 1)
    lit = (hit & ok_z & (u >= 0) & (u < proj.width)
           & (v >= 0) & (v < proj.height))

    # Room light illuminates the printed board everywhere (so the checker
    # pattern is detectable even outside the projector frustum, as in a real
    # calibration room); the projector adds pattern light on top.
    room = 60.0
    sensor_floor = 4.0
    n_frames = pattern_frames.shape[0]
    stack = np.empty((n_frames, cam_height, cam_width), dtype=np.uint8)
    for f in range(n_frames):
        proj_val = np.where(lit, pattern_frames[f][vi, ui], 0.0)
        val = np.where(hit, albedo * (proj_val + room) + sensor_floor, 0.0)
        img = val.reshape(hs, ws)
        if s > 1:  # box-filter downsample = per-pixel integration
            img = img.reshape(cam_height, s, cam_width, s).mean(axis=(1, 3))
        stack[f] = np.clip(img, 0, 255).astype(np.uint8)

    # Ground truth for the inner corners.
    ii, jj = np.meshgrid(np.arange(checker_cols), np.arange(checker_rows),
                         indexing="ij")
    corners_board = np.stack(
        [ii.ravel() * sq, jj.ravel() * sq, np.zeros(ii.size)], axis=-1)
    corners_cam3 = corners_board @ board_R.T + board_t[None, :]
    cu = cam_K[0, 0] * corners_cam3[:, 0] / corners_cam3[:, 2] + cam_K[0, 2]
    cv_ = cam_K[1, 1] * corners_cam3[:, 1] / corners_cam3[:, 2] + cam_K[1, 2]
    corners_proj3 = corners_cam3 @ R.T + T[None, :]
    pu = proj_K[0, 0] * corners_proj3[:, 0] / corners_proj3[:, 2] + proj_K[0, 2]
    pv = proj_K[1, 1] * corners_proj3[:, 1] / corners_proj3[:, 2] + proj_K[1, 2]

    gt = {
        "corner_cam_px": np.stack([cu, cv_], axis=-1),
        "corner_proj_px": np.stack([pu, pv], axis=-1),
        "corner_points": corners_cam3,
    }
    return stack, gt


def calibration_pose_set(n_poses: int = 5, distance: float = 900.0):
    """(board_R, board_t) list: tilted/rotated board poses for calibration.

    Placement keeps every inner corner inside the (narrower) projector
    frustum of `default_calibration`'s rig so the corner decode is valid;
    the board's white margin only needs room light, not projector light.
    """
    poses = []
    rng = np.random.default_rng(7)
    for k in range(n_poses):
        tilt_x = np.deg2rad(rng.uniform(-22, 22))
        tilt_y = np.deg2rad(rng.uniform(-22, 22))
        roll = np.deg2rad(rng.uniform(-12, 12))
        Rx = np.array([[1, 0, 0],
                       [0, np.cos(tilt_x), -np.sin(tilt_x)],
                       [0, np.sin(tilt_x), np.cos(tilt_x)]])
        Ry = np.array([[np.cos(tilt_y), 0, np.sin(tilt_y)],
                       [0, 1, 0],
                       [-np.sin(tilt_y), 0, np.cos(tilt_y)]])
        Rz = np.array([[np.cos(roll), -np.sin(roll), 0],
                       [np.sin(roll), np.cos(roll), 0],
                       [0, 0, 1]])
        board_R = Rx @ Ry @ Rz
        board_t = np.array([
            rng.uniform(-120, -60), rng.uniform(-150, -100),
            distance + rng.uniform(-60, 60)])
        poses.append((board_R, board_t))
    return poses
