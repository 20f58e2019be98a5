"""The port's capture I/O against the JAX package's on the CPU: frame stacks
(``io/images.py``), the ``.mat`` calibration (``io/matcal.py``), the session
layout (``io/layout.py``), the shared file-object plumbing
(``io/_fileobj.py``) and the sensor degradation chain
(``models/realism.py``).

Tolerances: all exact. Frames are decoded by the same codec on both sides
(OpenCV where it imports, PIL where it does not) and PIL agrees with OpenCV
on every pixel of the photoreal JPEG fixture; the ``.mat`` stores float64
copies of float32 values, so a round trip returns the same bits; the
degradation chain is the same numpy code fed the same seed.
"""

import io
import os

import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.io import images as jimages
from structured_light_for_3d_model_replication_tpu.io import layout as jlayout
from structured_light_for_3d_model_replication_tpu.io import matcal as jmatcal
from structured_light_for_3d_model_replication_tpu.models import (
    realism as jrealism,
)
from structured_light_for_3d_model_replication_tpu.models import synthetic
from structured_light_for_3d_model_replication_tpu.ops import (
    triangulate as jtri,
)
from structured_light_for_3d_model_replication_tpu_torch.io import (
    _fileobj,
    images,
    layout,
    matcal,
    ply,
    stl,
)
from structured_light_for_3d_model_replication_tpu_torch.models import realism
from structured_light_for_3d_model_replication_tpu_torch.ops import (
    triangulate as tri,
)

from .conftest import CAM_H, CAM_W, SMALL_PROJ

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "realistic_stack")


@pytest.fixture(scope="module")
def stack(synth_rig):
    """One rendered stop of the small rig, (32, 96, 160) uint8."""
    cam_K, proj_K, R, T = synth_rig
    s, _ = synthetic.render_scan(synthetic.Scene(), cam_K, proj_K, R, T,
                                 CAM_H, CAM_W, SMALL_PROJ)
    return np.asarray(s)


@pytest.mark.parametrize("ext", ["png", "bmp"])
def test_load_stack_matches_jax_and_round_trips(tmp_path, stack, ext):
    """Frames written by the port's ``write_frame`` read back bit for bit,
    by both packages' ``load_stack``; frame 01 as RGB too."""
    for f, frame in enumerate(stack):
        images.write_frame(str(tmp_path / layout.frame_name(f + 1, ext)),
                           frame)
    assert images.list_frames(str(tmp_path))[0].endswith(f"01.{ext}")
    got = images.load_stack(str(tmp_path), expected_frames=len(stack))
    np.testing.assert_array_equal(got, stack)
    np.testing.assert_array_equal(got, jimages.load_stack(str(tmp_path)))
    rgb = images.load_white_rgb(str(tmp_path))
    np.testing.assert_array_equal(rgb, jimages.load_white_rgb(str(tmp_path)))
    assert rgb.shape == (CAM_H, CAM_W, 3)
    np.testing.assert_array_equal(rgb[..., 0], stack[0])
    dev = images.device_stack(str(tmp_path), device="cpu")
    assert dev.dtype == torch.uint8 and torch.equal(dev,
                                                    torch.from_numpy(stack))
    with pytest.raises(ValueError, match="expected 5"):
        images.load_stack(str(tmp_path), expected_frames=5)


def test_frame_order_and_errors(tmp_path):
    """The reference's extension order (.bmp first), numeric sorting, the
    ragged-shape error and an empty folder."""
    a = np.zeros((4, 6), np.uint8)
    images.write_frame(str(tmp_path / "01.png"), a)
    images.write_frame(str(tmp_path / "01.bmp"), a + 1)
    images.write_frame(str(tmp_path / "02.bmp"), np.zeros((5, 6), np.uint8))
    assert [os.path.basename(p) for p in images.list_frames(
        str(tmp_path))] == ["01.bmp", "02.bmp"]
    assert images.list_frames(str(tmp_path)) == jimages.list_frames(
        str(tmp_path))
    with pytest.raises(ValueError, match="inconsistent frame shapes"):
        images.load_stack(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        images.list_frames(str(tmp_path / "nowhere"))
    names = ["s/scan_10.ply", "s/scan_2.ply", "s/x.ply", "s/scan_1.ply"]
    assert images.numeric_sort(names) == jimages.numeric_sort(names) == \
        ["s/x.ply", "s/scan_1.ply", "s/scan_2.ply", "s/scan_10.ply"]
    assert layout.numeric_sort is images.numeric_sort


def test_jpeg_fixture_decodes_alike(monkeypatch):
    """The photoreal JPEG fixture: the port's stack equals the JAX
    package's, and PIL (the decoder on a machine without OpenCV) agrees
    with OpenCV on every pixel, grey and RGB."""
    pytest.importorskip("cv2")
    cv_grey = images.load_stack(FIXTURE)
    np.testing.assert_array_equal(cv_grey, jimages.load_stack(FIXTURE))
    assert cv_grey.shape == (32, 96, 160)
    cv_rgb = [images._imread_rgb(p) for p in images.list_frames(FIXTURE)]
    monkeypatch.setattr(images, "_cv2", lambda: None)
    pil_grey = images.load_stack(FIXTURE)
    pil_rgb = [images._imread_rgb(p) for p in images.list_frames(FIXTURE)]
    assert int((pil_grey != cv_grey).sum()) == 0
    assert sum(int((a != b).sum()) for a, b in zip(pil_rgb, cv_rgb)) == 0
    np.testing.assert_array_equal(images.load_white_rgb(FIXTURE), cv_rgb[0])


def test_pil_writer_round_trips(tmp_path, stack, monkeypatch):
    """Without OpenCV frames are written and read through PIL, lossless."""
    monkeypatch.setattr(images, "_cv2", lambda: None)
    for f, frame in enumerate(stack[:4]):
        images.write_frame(str(tmp_path / f"{f + 1:02d}.png"), frame)
    np.testing.assert_array_equal(images.load_stack(str(tmp_path)),
                                  stack[:4])
    rgb = np.stack([stack[0], stack[1], stack[2]], axis=-1)
    images.write_frame(str(tmp_path / "rgb.bmp"), rgb)
    np.testing.assert_array_equal(images._imread_rgb(str(tmp_path /
                                                         "rgb.bmp")), rgb)


def _jax_calib(rig, h=CAM_H, w=CAM_W):
    return jtri.make_calibration(*rig, h, w, SMALL_PROJ.width,
                                 SMALL_PROJ.height)


def _same_calib(port, jax_cal):
    for name in tri.Calibration._fields:
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(jax_cal, name)),
                                      err_msg=name)


def test_mat_round_trips_between_packages(tmp_path, synth_rig):
    """A ``.mat`` written by either package loads in the other to the same
    bits, and matches the in-memory calibration."""
    jcal = _jax_calib(synth_rig)
    cal = tri.calibration_from_numpy(
        {k: np.asarray(v) for k, v in jcal._asdict().items()}, device="cpu")
    jmatcal.save_calibration_mat(str(tmp_path / "j.mat"), jcal)
    matcal.save_calibration_mat(str(tmp_path / "p.mat"), cal)
    for path in ("j.mat", "p.mat"):
        got = matcal.load_calibration_mat(str(tmp_path / path), CAM_H, CAM_W,
                                          device="cpu")
        ref = jmatcal.load_calibration_mat(str(tmp_path / path), CAM_H,
                                           CAM_W)
        _same_calib(got, ref)
        _same_calib(got, jcal)
        assert got.Nc.device.type == "cpu"
    with open(tmp_path / "j.mat", "rb") as f, open(tmp_path / "p.mat",
                                                   "rb") as g:
        assert f.read()[128:] == g.read()[128:]  # past the dated header


def test_mat_regenerates_rays_at_another_size(tmp_path, synth_rig):
    """A capture at another resolution than the calibration's: the rays are
    regenerated from ``cam_K`` as the JAX package does, the planes kept as
    stored."""
    jcal = _jax_calib(synth_rig)
    jmatcal.save_calibration_mat(str(tmp_path / "c.mat"), jcal)
    got = matcal.load_calibration_mat(str(tmp_path / "c.mat"), 48, 80,
                                      device="cpu")
    ref = jmatcal.load_calibration_mat(str(tmp_path / "c.mat"), 48, 80)
    assert got.Nc.shape == (48, 80, 3)
    np.testing.assert_allclose(got.Nc.numpy(), np.asarray(ref.Nc), atol=1e-6)
    np.testing.assert_array_equal(got.plane_cols.numpy(),
                                  np.asarray(jcal.plane_cols))
    np.testing.assert_array_equal(got.plane_rows.numpy(),
                                  np.asarray(jcal.plane_rows))


def test_mat_missing_keys_and_device(tmp_path, synth_rig, monkeypatch):
    import scipy.io

    scipy.io.savemat(str(tmp_path / "bad.mat"), {"cam_K": np.eye(3)})
    with pytest.raises(ValueError, match="missing keys"):
        matcal.load_calibration_mat(str(tmp_path / "bad.mat"), 4, 4,
                                    device="cpu")
    jmatcal.save_calibration_mat(str(tmp_path / "c.mat"),
                                 _jax_calib(synth_rig))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        matcal.load_calibration_mat(str(tmp_path / "c.mat"), CAM_H, CAM_W)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        images.device_stack(str(tmp_path))


def test_session_layout_matches_jax(tmp_path):
    assert layout.frame_name(3) == jlayout.frame_name(3) == "03.png"
    assert layout.frame_name(12, "bmp") == "12.bmp"
    ours = layout.SessionLayout(str(tmp_path)).ensure()
    ref = jlayout.SessionLayout(str(tmp_path))
    for attr in ("calib_dir", "calib_mat", "scans_dir", "scans_360_dir"):
        assert getattr(ours, attr) == getattr(ref, attr)
    assert ours.pose_dir(2) == ref.pose_dir(2)
    assert ours.scan_dir("cup") == ref.scan_dir("cup")
    assert ours.auto_session_dir("obj", 15.0) == ref.auto_session_dir(
        "obj", 15.0) == os.path.join(str(tmp_path), "scans_360",
                                     "obj_15deg_AUTO")
    for angle, n in ((0, 4), (15, 4), (30, 2), (135, 4)):
        d = ours.stop_dir("obj", 15, angle)
        assert d == ref.stop_dir("obj", 15, angle)
        os.makedirs(d)
        for i in range(n):
            images.write_frame(os.path.join(d, layout.frame_name(i + 1)),
                               np.zeros((2, 2), np.uint8))
    for pose in (10, 2):
        os.makedirs(ours.pose_dir(pose))
    assert ours.stop_dirs("obj", 15) == ref.stop_dirs("obj", 15)
    assert [os.path.basename(d) for d in ours.stop_dirs("obj", 15)] == [
        "obj_0deg_scan", "obj_15deg_scan", "obj_30deg_scan",
        "obj_135deg_scan"]
    assert ours.completed_stops("obj", 15, 4) == ref.completed_stops(
        "obj", 15, 4)
    assert len(ours.completed_stops("obj", 15, 4)) == 3
    assert ours.pose_dirs() == ref.pose_dirs()
    assert os.path.basename(layout.SessionLayout.today(str(tmp_path)).root) \
        == os.path.basename(jlayout.SessionLayout.today(str(tmp_path)).root)
    assert layout.list_clouds(str(tmp_path)) == []


def test_codecs_take_paths_and_file_objects(tmp_path):
    """PLY and STL write to and read from an open binary file object as
    they do to a path; the caller's buffer stays open."""
    rng = np.random.default_rng(0)
    cloud = ply.PointCloud(points=rng.normal(size=(20, 3)).astype(np.float32))
    buf = io.BytesIO()
    ply.write_ply(buf, cloud)
    assert not buf.closed
    ply.write_ply(str(tmp_path / "c.ply"), cloud)
    assert buf.getvalue() == (tmp_path / "c.ply").read_bytes()
    buf.seek(0)
    np.testing.assert_array_equal(ply.read_ply(buf).points, cloud.points)
    mesh = stl.TriangleMesh(cloud.points[:6],
                            np.array([[0, 1, 2], [3, 4, 5]], np.int32))
    sbuf = io.BytesIO()
    stl.write_stl(sbuf, mesh)
    stl.write_stl(str(tmp_path / "m.stl"), mesh)
    assert sbuf.getvalue() == (tmp_path / "m.stl").read_bytes()
    with _fileobj.binary_source(str(tmp_path / "m.stl")) as f:
        assert f.read(5) == sbuf.getvalue()[:5]


def test_degrade_stack_matches_jax(stack, synth_rig, monkeypatch):
    """The same seed gives the JAX package's photoreal stack; without
    OpenCV both pass the JPEG stage through."""
    import dataclasses
    import sys

    cam_K = synth_rig[0]
    assert dataclasses.asdict(realism.SensorParams()) == dataclasses.asdict(
        jrealism.SensorParams())
    params = realism.SensorParams(jpeg_quality=80)
    jparams = jrealism.SensorParams(jpeg_quality=80)
    got = realism.degrade_stack(stack[:3], cam_K, params, seed=4)
    np.testing.assert_array_equal(
        got, jrealism.degrade_stack(stack[:3], cam_K, jparams, seed=4))
    assert got.shape == stack[:3].shape and got.dtype == np.uint8
    assert not np.array_equal(got, stack[:3])
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now fails
    raw = realism.degrade_stack(stack[:3], cam_K, params, seed=4)
    np.testing.assert_array_equal(
        raw, jrealism.degrade_stack(stack[:3], cam_K, jparams, seed=4))
    assert not np.array_equal(raw, got)
