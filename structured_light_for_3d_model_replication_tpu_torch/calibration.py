"""Camera–projector stereo calibration (counterpart of the JAX package's
``calibration.py``).

Reimplements the reference's calibration stack (`server/sl_system.py:114-417`):

* corner detection with the same enhancement chain — Gaussian blur + CLAHE
  before ``findChessboardCorners``, sub-pixel refinement on the raw gray
  (`server/sl_system.py:229-240`),
* Gray-decode of the projector coordinate at each detected corner — the
  reference XOR-accumulates per-bit at 49 corner pixels in Python
  (`:257-288`); here the WHOLE stack is decoded by the ``decode_maps``
  kernel (``ops/decode.py``; its maps equal ``decode_bits`` with the
  stripe-centre rescale at every pixel) and gathered at the corner pixels,
  identical values by construction (same int truncation of the sub-pixel
  coordinate),
* quick per-pose reprojection errors for pose culling (`:307-327`),
* final stereo calibration: ``calibrateCamera`` x2 then ``stereoCalibrate``
  with ``CALIB_FIX_INTRINSIC`` (`:335-343`),
* an optional Levenberg–Marquardt refinement of the stereo extrinsics on
  the device (:func:`refine_stereo_torch`).

Bundle-adjusted intrinsics over a handful of 49-corner poses are host-side
OpenCV solves. Everything downstream of (K, R, T) — the ray grid and the
light planes — is ``ops.triangulate.make_calibration`` on the device.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ._device import resolve_device
from .config import CheckerboardConfig, ProjectorConfig
from .io import layout as _layout
from .io.images import list_frames, load_stack
from .io.matcal import save_calibration_mat
from .ops.decode import decode_maps
from .ops.registration import exp_so3
from .ops.triangulate import Calibration, make_calibration


@dataclasses.dataclass
class StereoResult:
    cam_K: np.ndarray
    cam_dist: np.ndarray
    proj_K: np.ndarray
    proj_dist: np.ndarray
    R: np.ndarray
    T: np.ndarray
    rms: float


def object_points(board: CheckerboardConfig) -> np.ndarray:
    """Planar board corner coordinates in mm (`server/sl_system.py:206-209`)."""
    objp = np.zeros((board.rows * board.cols, 3), np.float32)
    objp[:, :2] = np.mgrid[0:board.rows, 0:board.cols].T.reshape(-1, 2)
    return objp * board.square_mm


def detect_chessboard(img_gray: np.ndarray, board: CheckerboardConfig):
    """(found, corners (N,1,2) float32) with the reference's enhancement chain
    (`server/sl_system.py:229-240`): blur+CLAHE for detection, sub-pixel
    refinement against the raw gray image."""
    import cv2

    blurred = cv2.GaussianBlur(img_gray, (5, 5), 0)
    clahe = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
    enhanced = clahe.apply(blurred)
    found, corners = cv2.findChessboardCorners(
        enhanced, (board.rows, board.cols), None)
    if not found:
        return False, None
    # The reference refines with a fixed (11, 11) half-window
    # (`server/sl_system.py:240`), sized for full-res captures. A window
    # wider than half the square spacing makes cornerSubPix stray to the
    # neighboring corners, so cap it by the observed corner pitch.
    pts = np.asarray(corners, np.float32).reshape(-1, 2)
    pitch = np.linalg.norm(np.diff(pts[: board.rows], axis=0), axis=-1).min()
    win = int(np.clip(0.4 * pitch, 2, 11))
    corners = cv2.cornerSubPix(
        img_gray, corners, (win, win), (-1, -1),
        (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 0.001))
    # OpenCV version drift: normalize to the classic (N, 1, 2) layout.
    return True, np.asarray(corners, np.float32).reshape(-1, 1, 2)


def decode_at_corners(
    stack: np.ndarray,
    corners: np.ndarray,
    proj: ProjectorConfig,
    device=None,
) -> np.ndarray:
    """Projector (u, v) at each corner pixel, (N, 2) float32.

    One decode of the full stack on ``device`` (None means the card: the
    ``decode_maps`` kernel, whose maps are ``decode_bits`` · D + (D − 1) // 2
    at every pixel), then a gather at the int-truncated corner coordinates —
    bit-for-bit the reference's per-corner XOR loop
    (`server/sl_system.py:257-296`, `vp = img_p[y.astype(int), x.astype(int)]`).
    """
    dev = resolve_device(device)
    stacks = torch.from_numpy(np.ascontiguousarray(stack, np.uint8))[None]
    col_map, row_map = decode_maps(stacks.to(dev), proj.col_bits,
                                   proj.row_bits, proj.downsample)
    x = torch.from_numpy(corners[:, 0, 0].astype(np.int64)).to(dev)
    y = torch.from_numpy(corners[:, 0, 1].astype(np.int64)).to(dev)
    uv = torch.stack([col_map[0, y, x], row_map[0, y, x]], dim=-1)
    return uv.cpu().numpy().astype(np.float32)


@dataclasses.dataclass
class CalibData:
    obj_pts: list          # per pose (N, 3) float32
    cam_pts: list          # per pose (N, 1, 2) float32
    proj_pts: list         # per pose (N, 1, 2) float32
    img_shape: tuple       # (w, h)
    poses: list            # pose dir names that survived detection


def load_calib_data(
    pose_dirs: list[str],
    proj: ProjectorConfig = ProjectorConfig(),
    board: CheckerboardConfig = CheckerboardConfig(),
    device=None,
) -> CalibData:
    """Detect + decode every pose folder (`server/sl_system.py:204-305`);
    the corner decode runs on ``device`` (None means the card)."""
    import cv2

    objp = object_points(board)
    data = CalibData([], [], [], None, [])
    for path in pose_dirs:
        files = list_frames(path)
        img = cv2.imread(files[0], cv2.IMREAD_GRAYSCALE)
        if img is None:
            continue
        if data.img_shape is None:
            data.img_shape = (img.shape[1], img.shape[0])
        found, corners = detect_chessboard(img, board)
        if not found:
            continue
        if len(files) < proj.n_frames:
            continue
        stack = load_stack(path, expected_frames=None)[: proj.n_frames]
        uv = decode_at_corners(stack, corners, proj, device=device)
        data.obj_pts.append(objp)
        data.cam_pts.append(corners)
        data.proj_pts.append(uv.reshape(-1, 1, 2))
        data.poses.append(os.path.basename(path))
    return data


def reprojection_errors(
    data: CalibData,
    proj: ProjectorConfig = ProjectorConfig(),
) -> dict[str, tuple[float, float]]:
    """Per-pose (camera_err, projector_err) for manual pose culling
    (`server/sl_system.py:307-327`)."""
    import cv2

    _, mc, dc, rvc, tvc = cv2.calibrateCamera(
        data.obj_pts, data.cam_pts, data.img_shape, None, None)
    _, mp, dp, rvp, tvp = cv2.calibrateCamera(
        data.obj_pts, data.proj_pts, (proj.width, proj.height), None, None)
    errors = {}
    for i, pose in enumerate(data.poses):
        p2c, _ = cv2.projectPoints(data.obj_pts[i], rvc[i], tvc[i], mc, dc)
        ec = cv2.norm(data.cam_pts[i], p2c.astype(np.float32),
                      cv2.NORM_L2) / len(p2c)
        p2p, _ = cv2.projectPoints(data.obj_pts[i], rvp[i], tvp[i], mp, dp)
        ep = cv2.norm(data.proj_pts[i].astype(np.float32),
                      p2p.astype(np.float32), cv2.NORM_L2) / len(p2p)
        errors[pose] = (float(ec), float(ep))
    return errors


def analyze_calibration(
    calib_dir: str,
    proj: ProjectorConfig = ProjectorConfig(),
    board: CheckerboardConfig = CheckerboardConfig(),
    device=None,
):
    """(errors, pose_names) for the pose-selection step
    (`server/sl_system.py:187-202`; >= 3 poses required)."""
    pose_dirs = _layout.numeric_sort([
        os.path.join(calib_dir, d) for d in os.listdir(calib_dir)
        if os.path.isdir(os.path.join(calib_dir, d))])
    if len(pose_dirs) < 3:
        raise ValueError(f"need at least 3 pose folders in {calib_dir}")
    data = load_calib_data(pose_dirs, proj, board, device=device)
    if len(data.obj_pts) < 3:
        raise ValueError(
            f"chessboard detected in only {len(data.obj_pts)} of "
            f"{len(pose_dirs)} poses; need >= 3")
    return reprojection_errors(data, proj), data.poses


def stereo_calibrate(
    data: CalibData,
    proj: ProjectorConfig = ProjectorConfig(),
) -> StereoResult:
    """calibrateCamera x2 + stereoCalibrate(FIX_INTRINSIC)
    (`server/sl_system.py:335-343`). X_p = R X_c + T."""
    import cv2

    _, mc, dc, _, _ = cv2.calibrateCamera(
        data.obj_pts, data.cam_pts, data.img_shape, None, None)
    _, mp, dp, _, _ = cv2.calibrateCamera(
        data.obj_pts, data.proj_pts, (proj.width, proj.height), None, None)
    rms, K1, D1, K2, D2, R, T, _, _ = cv2.stereoCalibrate(
        data.obj_pts, data.cam_pts, data.proj_pts, mc, dc, mp, dp,
        data.img_shape, flags=cv2.CALIB_FIX_INTRINSIC)
    return StereoResult(K1, D1, K2, D2, R, T.reshape(3), float(rms))


def _undistort(pts, K, D) -> np.ndarray:
    """Ideal-pinhole observations re-projected through K (``P=K``). A
    zero/absent distortion model is the identity here (synthetic rigs)."""
    if D is None or not np.any(np.abs(np.asarray(D)) > 0):
        return np.asarray(pts, np.float32).reshape(-1, 2)
    import cv2

    und = cv2.undistortPoints(
        np.asarray(pts, np.float64).reshape(-1, 1, 2),
        np.asarray(K, np.float64), np.asarray(D, np.float64),
        P=np.asarray(K, np.float64))
    return und.reshape(-1, 2).astype(np.float32)


def stereo_problem(data: CalibData, stereo: StereoResult, device=None,
                   init=None):
    """The refinement's least-squares problem on ``device``: ``(x0,
    residuals)``. ``x0`` (6 + 6·P,) float32 stacks the stereo extrinsics
    (ω, t) and each pose's board extrinsics (ωᵢ, tᵢ): ``init`` if given,
    else OpenCV's stereo solution and ``solvePnP`` per pose;
    ``residuals(x)`` is the (4·P·N,) camera + projector reprojection error
    of the ideal pinhole model against the undistorted observations, pose
    by pose (camera then projector), as the JAX package orders it."""
    dev = resolve_device(device)
    n_poses = len(data.obj_pts)
    n_pts = min(len(o) for o in data.obj_pts)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    obj = f32(np.stack([o[:n_pts] for o in data.obj_pts]))     # (P, N, 3)
    cam_np = np.stack([_undistort(c[:n_pts], stereo.cam_K, stereo.cam_dist)
                       for c in data.cam_pts])
    cam = f32(cam_np)
    prj = f32(np.stack([_undistort(q[:n_pts], stereo.proj_K,
                                   stereo.proj_dist)
                        for q in data.proj_pts]))
    cam_K = f32(stereo.cam_K)
    proj_K = f32(stereo.proj_K)

    if init is not None:
        x0 = f32(np.asarray(init, np.float32).reshape(6 + 6 * n_poses))
    else:
        # Stereo from OpenCV; per-pose extrinsics from solvePnP.
        import cv2

        rvec0, _ = cv2.Rodrigues(np.asarray(stereo.R, np.float64))
        x0 = [np.asarray(rvec0, np.float32).reshape(3),
              np.asarray(stereo.T, np.float32).reshape(3)]
        for i in range(n_poses):
            ok, rv, tv = cv2.solvePnP(
                np.asarray(data.obj_pts[i][:n_pts], np.float64),
                np.asarray(cam_np[i], np.float64),  # undistorted
                np.asarray(stereo.cam_K, np.float64), None)
            if not ok:
                raise RuntimeError(f"solvePnP failed for pose {i}")
            x0.append(np.asarray(rv, np.float32).reshape(3))
            x0.append(np.asarray(tv, np.float32).reshape(3))
        x0 = f32(np.concatenate(x0))

    def project(K, X):
        uvw = X @ K.T
        return uvw[..., :2] / torch.clamp_min(uvw[..., 2:3], 1e-9)

    def residuals(x):
        R_st = exp_so3(x[0:3])
        t_st = x[3:6]
        poses = x[6:].reshape(n_poses, 6)
        R_i = exp_so3(poses[:, :3])                             # (P, 3, 3)
        Xc = torch.einsum("pij,pnj->pni", R_i, obj) + poses[:, None, 3:]
        Xp = torch.einsum("ij,pnj->pni", R_st, Xc) + t_st
        r_cam = (project(cam_K, Xc) - cam).reshape(n_poses, -1)
        r_prj = (project(proj_K, Xp) - prj).reshape(n_poses, -1)
        return torch.stack([r_cam, r_prj], dim=1).reshape(-1)

    return x0, residuals


def refine_stereo_torch(
    data: CalibData,
    stereo: StereoResult,
    iterations: int = 30,
    device=None,
    init=None,
) -> StereoResult:
    """Levenberg–Marquardt refinement of the stereo solve on ``device``
    (None means the card).

    Re-derives the optimization inside ``cv2.stereoCalibrate``: joint LM
    over the stereo extrinsics (ω, t) and the per-pose board extrinsics
    (ωᵢ, tᵢ), intrinsics FIXED (the CALIB_FIX_INTRINSIC semantics the
    reference uses, `server/sl_system.py:341-343`), minimizing the combined
    camera + projector reprojection error. The residual model is an ideal
    pinhole — matching how the precomputed rays/planes consume the result
    (`ops/triangulate.py`) — so the OBSERVATIONS are first undistorted
    (``cv2.undistortPoints`` with ``P=K``) using the lens models OpenCV
    estimated jointly with the intrinsics.

    The problem is tiny and dense (6 + 6·P parameters, 4·P·N residuals):
    each step is one ``torch.func.jacfwd`` Jacobian, a damped normal-
    equations solve (``torch.linalg.solve``), and the JAX package's
    accept/reject rule (a step is kept iff it lowers the squared residual
    sum; λ halves on accept and quadruples on reject, from 1e-3), in
    float32 with TF32 off and no host read until the end. Initialized from
    the OpenCV solution, or from ``init`` (see :func:`stereo_problem`: a
    start that needs no OpenCV where the lens models are zero); returns a
    StereoResult with the refined R/T and the refined RMS in pixels over
    point observations (OpenCV's convention).

    Through ``ops.registration.exp_so3``, whose small-angle mask is the
    JAX package's, the Jacobian's rotation columns of a pose at exactly
    ω = 0 are zero, as they are in the JAX package.
    """
    dev = resolve_device(device)
    x, residuals = stereo_problem(data, stereo, dev, init)
    jac = torch.func.jacfwd(residuals)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lam = torch.full((), 1e-3, dtype=torch.float32, device=dev)
        eye = torch.eye(x.shape[0], dtype=torch.float32, device=dev)
        for _ in range(iterations):
            r = residuals(x)
            J = jac(x)
            dx = torch.linalg.solve(J.T @ J + lam * eye, J.T @ r)
            x_new = x - dx
            better = (residuals(x_new) ** 2).sum() < (r ** 2).sum()
            x = torch.where(better, x_new, x)
            lam = torch.where(better, lam * 0.5, lam * 4.0)
        r = residuals(x).reshape(-1, 2)
        rms = torch.sqrt(torch.mean(torch.sum(r ** 2, dim=1)))
        R = exp_so3(x[0:3])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return StereoResult(stereo.cam_K, stereo.cam_dist, stereo.proj_K,
                        stereo.proj_dist, R.cpu().numpy(),
                        x[3:6].cpu().numpy(), float(rms))


#: The JAX package's name for the refinement.
refine_stereo_jax = refine_stereo_torch


def calibrate_final(
    pose_dirs: list[str],
    output_mat: str | None = None,
    proj: ProjectorConfig = ProjectorConfig(),
    board: CheckerboardConfig = CheckerboardConfig(),
    device=None,
) -> tuple[Calibration, StereoResult]:
    """Full final calibration (`server/sl_system.py:329-417`): stereo solve on
    the selected poses, then the ray-grid/light-plane precompute on
    ``device`` (None means the card), then the reference-layout .mat
    artifact."""
    data = load_calib_data(pose_dirs, proj, board, device=device)
    if len(data.obj_pts) < 3:
        raise ValueError(
            f"chessboard detected in only {len(data.obj_pts)} poses; need >= 3")
    stereo = stereo_calibrate(data, proj)
    w, h = data.img_shape
    calib = make_calibration(
        stereo.cam_K, stereo.proj_K, stereo.R, stereo.T, h, w,
        proj_width=proj.width, proj_height=proj.height, device=device)
    if output_mat:
        os.makedirs(os.path.dirname(output_mat) or ".", exist_ok=True)
        save_calibration_mat(output_mat, calib)
    return calib, stereo
