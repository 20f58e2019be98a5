"""Calibration: the port's ``calibration.py`` against the JAX package's on
the JAX tests' six rendered checkerboard poses (``PROJ`` 512×256, camera
240×320, tests/test_calibration.py's rig), on the CPU.

Tolerances: the rendered poses, the corner decode, the detected corners,
the decoded projector points and the OpenCV stereo solve exact (the same
numpy renderer and the same OpenCV on the same points); the LM refinement
(float32 in both, the port's Jacobian by ``torch.func.jacfwd``, JAX's by
``jax.jacfwd``) within 1e-3 px of rms, 1e-3° of R and 1e-4·‖T‖ of T; the
residual Jacobian within 1e-5 of its largest entry at the OpenCV start (a
non-zero rotation) and at ω = 0 for every rotation (where both give zero
rotation columns), its residuals within 4 float32 ulps of the largest pixel
coordinate; the final ``Calibration`` rays and planes at rtol 1e-5
(as tests/test_torch_pipeline.py holds ``make_calibration``).
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu import (
    calibration as jcalibration,
)
from structured_light_for_3d_model_replication_tpu.models import (
    synthetic as jsynthetic,
)
from structured_light_for_3d_model_replication_tpu.ops.registration import (
    exp_so3 as jexp_so3,
)
from structured_light_for_3d_model_replication_tpu_torch import calibration
from structured_light_for_3d_model_replication_tpu_torch.config import (
    CheckerboardConfig,
    ProjectorConfig,
)
from structured_light_for_3d_model_replication_tpu_torch.io import (
    images,
    layout,
)
from structured_light_for_3d_model_replication_tpu_torch.models import (
    synthetic,
)
from structured_light_for_3d_model_replication_tpu_torch.ops.triangulate import (
    Calibration,
)

cv2 = pytest.importorskip("cv2")

PROJ = ProjectorConfig(width=512, height=256)
H, W = 240, 320
BOARD = CheckerboardConfig(cols=7, rows=7, square_mm=35.0)


@pytest.fixture(autouse=True, scope="module")
def _share_cores_with_workers():
    """Give this module's PyTorch ops the worker's share of the cores (see
    tests/test_torch_meshing.py), and OpenCV one thread: its threaded
    solvers sum in a schedule-dependent order, so two calls on the same
    points differ in the last bits unless it runs serially."""
    n = torch.get_num_threads()
    n_cv = cv2.getNumThreads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, n // workers))
    cv2.setNumThreads(1)
    yield
    torch.set_num_threads(n)
    cv2.setNumThreads(n_cv)


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """Six poses rendered by the port's synthetic rig, written as the
    reference's calibration session; pose 0 also rendered by the JAX
    package's, which must give the same frames."""
    root = tmp_path_factory.mktemp("calib_torch")
    rig = synthetic.default_calibration(H, W, PROJ)
    lay = layout.SessionLayout(str(root)).ensure()
    frames = synthetic.pattern_frames(PROJ)

    def render(pose):
        return synthetic.render_calibration_pose(
            *pose, *rig, H, W, PROJ, checker_cols=BOARD.cols,
            checker_rows=BOARD.rows, square_mm=BOARD.square_mm,
            pattern_frames=frames)

    with ThreadPoolExecutor(max_workers=3) as ex:
        rendered = list(ex.map(render, synthetic.calibration_pose_set(6)))
    gts, stacks = [], []
    for i, (stack, gt) in enumerate(rendered):
        d = lay.pose_dir(i)
        os.makedirs(d, exist_ok=True)
        for f in range(stack.shape[0]):
            images.write_frame(os.path.join(d, layout.frame_name(f + 1)),
                               stack[f])
        gts.append(gt)
        stacks.append(stack)
    return lay, rig, gts, stacks


@pytest.fixture(scope="module")
def solved(session):
    """Both packages' corner data and OpenCV stereo solve on the session."""
    lay = session[0]
    data = calibration.load_calib_data(lay.pose_dirs(), PROJ, BOARD,
                                       device="cpu")
    jdata = jcalibration.load_calib_data(lay.pose_dirs(), PROJ, BOARD)
    return (data, calibration.stereo_calibrate(data, PROJ),
            jdata, jcalibration.stereo_calibrate(jdata, PROJ))


def test_render_calibration_pose_matches_jax(session):
    _, rig, gts, stacks = session
    bR, bt = jsynthetic.calibration_pose_set(6)[0]
    for a, b in zip(synthetic.calibration_pose_set(6),
                    jsynthetic.calibration_pose_set(6)):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    jstack, jgt = jsynthetic.render_calibration_pose(
        bR, bt, *rig, H, W, PROJ, checker_cols=BOARD.cols,
        checker_rows=BOARD.rows, square_mm=BOARD.square_mm)
    assert np.array_equal(stacks[0], jstack)
    for k in jgt:
        assert np.array_equal(gts[0][k], jgt[k]), k


def test_decode_at_corners_equals_jax(session):
    lay, _, gts, stacks = session
    img = cv2.imread(os.path.join(lay.pose_dir(0), "01.png"),
                     cv2.IMREAD_GRAYSCALE)
    found, corners = calibration.detect_chessboard(img, BOARD)
    assert found
    uv = calibration.decode_at_corners(stacks[0], corners, PROJ,
                                       device="cpu")
    juv = jcalibration.decode_at_corners(stacks[0], corners, PROJ)
    assert uv.dtype == np.float32 and np.array_equal(uv, juv)
    # And the decode is right: within the stripe quantisation of the truth.
    d = np.linalg.norm(corners[:, 0][None] - gts[0]["corner_cam_px"][:, None],
                       axis=-1)
    err = np.linalg.norm(uv[d.argmin(1)] - gts[0]["corner_proj_px"], axis=-1)
    assert np.median(err) < 1.5


def test_stereo_calibrate_equals_jax(session, solved):
    data, stereo, jdata, jstereo = solved
    assert data.poses == jdata.poses and len(data.poses) == 6
    assert data.img_shape == jdata.img_shape
    for name in ("obj_pts", "cam_pts", "proj_pts"):
        for a, b in zip(getattr(data, name), getattr(jdata, name)):
            assert np.array_equal(a, b), name
    for name in ("cam_K", "cam_dist", "proj_K", "proj_dist", "R", "T"):
        assert np.array_equal(getattr(stereo, name),
                              getattr(jstereo, name)), name
    assert stereo.rms == jstereo.rms


def test_reprojection_errors_match_jax(session, solved):
    lay = session[0]
    errors, poses = calibration.analyze_calibration(lay.calib_dir, PROJ,
                                                    BOARD, device="cpu")
    jerrors, jposes = jcalibration.analyze_calibration(lay.calib_dir, PROJ,
                                                       BOARD)
    assert poses == jposes and errors == jerrors
    for ec, ep in errors.values():
        assert ec < 0.5 and ep < 2.0


def _angle_deg(Ra, Rb) -> float:
    """The angle of Raᵀ·Rb from its rotation vector: well conditioned near
    0, where the trace formula's arccos loses ~0.01° to float32 rounding."""
    rel = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    return float(np.degrees(np.linalg.norm(cv2.Rodrigues(rel)[0])))


@pytest.mark.parametrize("iterations", [30, 0])
def test_refine_stereo_torch_matches_jax(solved, session, iterations):
    data, stereo, _, _ = solved
    T_gt = session[1][3]
    got = calibration.refine_stereo_torch(data, stereo, iterations,
                                          device="cpu")
    ref = jcalibration.refine_stereo_jax(data, stereo, iterations)
    assert calibration.refine_stereo_jax is calibration.refine_stereo_torch
    assert abs(got.rms - ref.rms) < 1e-3, (got.rms, ref.rms)
    assert _angle_deg(got.R, ref.R) < 1e-3
    assert np.linalg.norm(got.T - ref.T) < 1e-4 * np.linalg.norm(ref.T)
    # An explicit start (no OpenCV needed to form it) is the same problem.
    x0, _ = calibration.stereo_problem(data, stereo, device="cpu")
    again = calibration.refine_stereo_torch(data, stereo, iterations,
                                            device="cpu", init=x0.numpy())
    assert np.array_equal(again.R, got.R) and again.rms == got.rms
    if iterations:
        base = calibration.refine_stereo_torch(data, stereo, 0, device="cpu")
        assert got.rms <= base.rms + 1e-3
        assert np.linalg.norm(got.T - T_gt) < 0.2 * np.linalg.norm(T_gt)


def _jax_residuals(data, stereo):
    """The JAX package's ``refine_stereo_jax`` residual function, built on
    the same inputs (its closure is not reachable from outside)."""
    n_poses = len(data.obj_pts)
    n_pts = min(len(o) for o in data.obj_pts)
    obj = jnp.asarray(np.stack([o[:n_pts] for o in data.obj_pts]),
                      jnp.float32)
    und = calibration._undistort            # the same cv2.undistortPoints
    cam = jnp.asarray(np.stack([und(c[:n_pts], stereo.cam_K,
                                    stereo.cam_dist) for c in data.cam_pts]))
    prj = jnp.asarray(np.stack([und(q[:n_pts], stereo.proj_K,
                                    stereo.proj_dist)
                                for q in data.proj_pts]))
    cam_K = jnp.asarray(stereo.cam_K, jnp.float32)
    proj_K = jnp.asarray(stereo.proj_K, jnp.float32)
    hi = jax.lax.Precision.HIGHEST

    def project(K, X):
        uvw = X @ K.T
        return uvw[..., :2] / jnp.maximum(uvw[..., 2:3], 1e-9)

    def residuals(x):
        R_st, t_st = jexp_so3(x[0:3]), x[3:6]
        res = []
        for i in range(n_poses):
            o = 6 + 6 * i
            R_i, t_i = jexp_so3(x[o:o + 3]), x[o + 3:o + 6]
            Xc = jnp.einsum("ij,nj->ni", R_i, obj[i], precision=hi) + t_i
            Xp = jnp.einsum("ij,nj->ni", R_st, Xc, precision=hi) + t_st
            res.append((project(cam_K, Xc) - cam[i]).reshape(-1))
            res.append((project(proj_K, Xp) - prj[i]).reshape(-1))
        return jnp.concatenate(res)

    return residuals


@pytest.mark.parametrize("at", ["opencv_start", "zero_rotation"])
def test_residual_jacobian_matches_jax(solved, at):
    data, stereo, _, _ = solved
    x0, residuals = calibration.stereo_problem(data, stereo, device="cpu")
    x = x0.clone()
    if at == "zero_rotation":
        x.reshape(-1, 3)[0::2] = 0.0          # ω of the stereo and each pose
    J = torch.func.jacfwd(residuals)(x).numpy()
    jres = _jax_residuals(data, stereo)
    jx = jnp.asarray(x.numpy())
    JJ = np.asarray(jax.jacfwd(jres)(jx))
    assert J.shape == JJ.shape == (4 * 6 * 49, 6 + 6 * 6)
    # Residuals: projected pixels less observations, so within a few
    # float32 ulps of the largest pixel coordinate (512).
    np.testing.assert_allclose(residuals(x).numpy(), np.asarray(jres(jx)),
                               rtol=0, atol=4 * np.spacing(np.float32(512)))
    np.testing.assert_allclose(J, JJ, rtol=0, atol=1e-5 * np.abs(JJ).max())
    rot_cols = np.concatenate([np.arange(o, o + 3)
                               for o in range(0, J.shape[1], 6)])
    if at == "zero_rotation":
        # The masked exp_so3 of both packages: no rotation signal at ω = 0.
        assert not J[:, rot_cols].any() and not JJ[:, rot_cols].any()
    else:
        assert np.abs(J[:, rot_cols]).max() > 1.0


def test_calibrate_final_matches_jax(session, tmp_path):
    lay, (cam_K, proj_K, R, T), _, _ = session
    mat = str(tmp_path / "calib.mat")
    calib, stereo = calibration.calibrate_final(
        lay.pose_dirs(), output_mat=mat, proj=PROJ, board=BOARD,
        device="cpu")
    jcalib, jstereo = jcalibration.calibrate_final(lay.pose_dirs(),
                                                   proj=PROJ, board=BOARD)
    assert np.array_equal(stereo.R, jstereo.R)
    for name in Calibration._fields:
        np.testing.assert_allclose(getattr(calib, name).numpy(),
                                   np.asarray(getattr(jcalib, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    # tests/test_calibration.py's bounds against the rendered rig.
    assert abs(stereo.cam_K[0, 0] - cam_K[0, 0]) / cam_K[0, 0] < 0.02
    assert abs(stereo.proj_K[0, 0] - proj_K[0, 0]) / proj_K[0, 0] < 0.05
    assert _angle_deg(stereo.R, R) < 3.0
    assert np.linalg.norm(stereo.T - T) < 0.12 * np.linalg.norm(T)
    assert stereo.rms < 1.5
    from structured_light_for_3d_model_replication_tpu_torch.io.matcal import (
        load_calibration_mat,
    )

    back = load_calibration_mat(mat, H, W, device="cpu")
    np.testing.assert_allclose(back.plane_cols.numpy(),
                               calib.plane_cols.numpy(), atol=1e-5)
