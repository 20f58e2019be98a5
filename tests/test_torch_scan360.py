"""The whole slice: 360° capture stacks → merged cloud through the port's
``scan_stacks_to_cloud`` against the JAX package's, on the 4-stop, 10° rig
of tests/test_scan360.py with its FAST parameters, sequential method.

The RANSAC streams differ (``torch.Generator`` vs ``jax.random``), so this
compares outcomes, not bits. Tolerances: every pose angle within 0.5° of the
JAX pose's and within 3° of i·10°; per-edge fitness ±0.02; merged point
count within 5%; the merged cloud carries colours and normals.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from structured_light_for_3d_model_replication_tpu.models import merge as jmerge
from structured_light_for_3d_model_replication_tpu.models import (
    scan360 as jscan360,
)
from structured_light_for_3d_model_replication_tpu.models import (
    synthetic as jsynthetic,
)
from structured_light_for_3d_model_replication_tpu.ops import (
    triangulate as jtri,
)
from structured_light_for_3d_model_replication_tpu_torch.config import (
    ProjectorConfig,
)
from structured_light_for_3d_model_replication_tpu_torch.models import (
    merge,
    scan360,
    synthetic,
)
from structured_light_for_3d_model_replication_tpu_torch.ops import (
    triangulate as tri,
)

from .conftest import CAM_H, CAM_W, SMALL_PROJ

SPHERES = ((0.0, 10.0, 500.0, 80.0, 0.9), (60.0, -40.0, 460.0, 35.0, 0.7),
           (-70.0, 40.0, 530.0, 30.0, 0.8), (20.0, 70.0, 440.0, 25.0, 0.75))
FAST = dict(voxel_size=6.0, ransac_iterations=2048, icp_iterations=20,
            fpfh_max_nn=32, normals_k=12, max_points=2048)


def _angle(T):
    return np.degrees(np.arccos(np.clip((np.trace(T[:3, :3]) - 1) / 2,
                                        -1, 1)))


@pytest.fixture(scope="module")
def stacks(synth_rig):
    scene = jsynthetic.Scene(wall_z=None, spheres=tuple(
        jsynthetic.Sphere((x, y, z), r, a) for x, y, z, r, a in SPHERES))
    cam_K, proj_K, R, T = synth_rig
    scans = jsynthetic.render_turntable_scans(
        scene, n_stops=4, degrees_per_stop=10.0, cam_K=cam_K, proj_K=proj_K,
        R=R, T=T, cam_height=CAM_H, cam_width=CAM_W, proj=SMALL_PROJ)
    return np.stack([s for s, _ in scans])


def test_port_synthetic_renders_the_same_stacks(synth_rig, stacks):
    """The port's numpy rig (used to drive it on the card without the JAX
    package) renders the JAX rig's stacks bit for bit."""
    scene = synthetic.Scene(wall_z=None, spheres=tuple(
        synthetic.Sphere((x, y, z), r, a) for x, y, z, r, a in SPHERES))
    cam_K, proj_K, R, T = synth_rig
    proj = ProjectorConfig(width=SMALL_PROJ.width, height=SMALL_PROJ.height,
                           brightness=SMALL_PROJ.brightness)
    ours = synthetic.render_turntable_scans(scene, 4, 10.0, cam_K, proj_K, R,
                                            T, CAM_H, CAM_W, proj)
    assert np.array_equal(np.stack([s for s, _ in ours]), stacks)
    for ours_m, ref_m in zip(synthetic.default_calibration(CAM_H, CAM_W, proj),
                             synth_rig):
        assert np.array_equal(ours_m, ref_m)


def test_scan_stacks_to_cloud_matches_jax(synth_rig, stacks):
    cam_K, proj_K, R, T = synth_rig
    jcal = jtri.make_calibration(cam_K, proj_K, R, T, CAM_H, CAM_W,
                                 SMALL_PROJ.width, SMALL_PROJ.height)
    jparams = jscan360.Scan360Params(merge=jmerge.MergeParams(**FAST),
                                     method="sequential", view_cap=8192)
    jmerged, jposes, jstats = jscan360.scan_stacks_to_cloud(
        jnp.asarray(stacks), jcal, SMALL_PROJ.col_bits, SMALL_PROJ.row_bits,
        params=jparams, with_stats=True)

    cal = tri.calibration_from_numpy(
        {k: np.asarray(v) for k, v in jcal._asdict().items()}, device="cpu")
    params = scan360.Scan360Params(merge=merge.MergeParams(**FAST),
                                   view_cap=8192)
    timing = {}
    merged, poses, stats = scan360.scan_stacks_to_cloud(
        stacks, cal, SMALL_PROJ.col_bits, SMALL_PROJ.row_bits, params=params,
        with_stats=True, timing=timing, device="cpu")

    assert poses.shape == (4, 4, 4) and poses.dtype == np.float32
    for i in range(4):
        a, ja = _angle(poses[i]), _angle(np.asarray(jposes[i]))
        assert abs(a - ja) <= 0.5, (i, a, ja)
        assert abs(a - 10.0 * i) <= 3.0, (i, a)
    fits = [e["fitness"] for e in stats["edges"]]
    jfits = [e["fitness"] for e in jstats["edges"]]
    assert len(fits) == len(jfits) == 3
    np.testing.assert_allclose(fits, jfits, atol=0.02)
    assert abs(len(merged) - len(jmerged)) <= 0.05 * len(jmerged)
    assert len(merged) > 200
    assert merged.colors is not None and merged.colors.dtype == np.uint8
    assert merged.normals is not None
    assert np.isfinite(merged.points).all()
    np.testing.assert_allclose(np.linalg.norm(merged.normals, axis=1), 1.0,
                               atol=1e-4)
    assert set(timing) >= {"decode_triangulate_s", "subsample_s",
                           "register_s", "merge_s"}


def test_scan_stacks_rejects_unported_method(synth_rig, stacks):
    cam_K, proj_K, R, T = synth_rig
    cal = tri.make_calibration(cam_K, proj_K, R, T, CAM_H, CAM_W,
                               SMALL_PROJ.width, SMALL_PROJ.height,
                               device="cpu")
    with pytest.raises(ValueError, match="method"):
        scan360.scan_stacks_to_cloud(
            stacks, cal, SMALL_PROJ.col_bits, SMALL_PROJ.row_bits,
            params=scan360.Scan360Params(method="fused"), device="cpu")


@pytest.mark.parametrize("knob, match", [("ring_strategy", "ring strategy"),
                                         ("decode_strategy",
                                          "decode_strategy")])
def test_bad_scan360_knob_raises_as_jax_does(synth_rig, stacks, knob, match):
    """An unknown ring or decode strategy raises ValueError in both
    packages (the decode strategy before any work, the ring strategy where
    the ring is registered)."""
    cam_K, proj_K, R, T = synth_rig
    jcal = jtri.make_calibration(cam_K, proj_K, R, T, CAM_H, CAM_W,
                                 SMALL_PROJ.width, SMALL_PROJ.height)
    with pytest.raises(ValueError, match=match):
        jscan360.scan_stacks_to_cloud(
            jnp.asarray(stacks), jcal, SMALL_PROJ.col_bits,
            SMALL_PROJ.row_bits,
            params=jscan360.Scan360Params(**{knob: "bogus"}))
    cal = tri.calibration_from_numpy(
        {k: np.asarray(v) for k, v in jcal._asdict().items()}, device="cpu")
    with pytest.raises(ValueError, match=match):
        scan360.scan_stacks_to_cloud(
            stacks, cal, SMALL_PROJ.col_bits, SMALL_PROJ.row_bits,
            params=scan360.Scan360Params(**{knob: "bogus"}), device="cpu")


def _two_stop_runs(synth_rig, stacks, **knobs):
    """The port's batch and streamed rings over the first two stops, FAST
    parameters, with ``knobs`` set: (merged, poses) of each."""
    cam_K, proj_K, R, T = synth_rig
    cal = tri.make_calibration(cam_K, proj_K, R, T, CAM_H, CAM_W,
                               SMALL_PROJ.width, SMALL_PROJ.height,
                               device="cpu")
    params = scan360.Scan360Params(merge=merge.MergeParams(**FAST),
                                   view_cap=8192, stop_chunk=1, **knobs)
    batch = scan360.scan_stacks_to_cloud(
        stacks[:2], cal, SMALL_PROJ.col_bits, SMALL_PROJ.row_bits,
        params=params, device="cpu")
    stream = scan360.scan_stream_to_cloud(
        iter(stacks[:2]), cal, SMALL_PROJ.col_bits, SMALL_PROJ.row_bits,
        params=params, device="cpu")
    return batch[:2], stream[:2]


@pytest.fixture(scope="module")
def two_stop_default(synth_rig, stacks):
    return _two_stop_runs(synth_rig, stacks)


@pytest.mark.parametrize("knob, value", [("decode_strategy", "scan"),
                                         ("reduce_chunk", 3)])
def test_jax_only_knob_off_its_default_raises(synth_rig, stacks,
                                              two_stop_default, knob,
                                              value):
    """``decode_strategy="scan"`` and any ``reduce_chunk`` run, as in the
    JAX package (``"scan"`` is a dispatch choice there, ``reduce_chunk`` is
    ignored): the port's one decode schedule serves both, so its batch and
    streamed rings equal the default run bit for bit."""
    got = _two_stop_runs(synth_rig, stacks, **{knob: value})
    for (merged, poses), (ref_merged, ref_poses) in zip(got,
                                                        two_stop_default):
        assert np.array_equal(poses, ref_poses)
        assert np.array_equal(merged.points, ref_merged.points)
        assert np.array_equal(merged.colors, ref_merged.colors)
        assert np.array_equal(merged.normals, ref_merged.normals)


def test_decode_strategy_scan_matches_jax(synth_rig, stacks):
    """``decode_strategy="scan"`` against the JAX package's ``"scan"`` run
    (tests/test_scan360.py holds JAX's to its loop at poses ``atol=1e-4``,
    sizes within 2). The RANSAC streams differ (``torch.Generator`` vs
    ``jax.random``), so the rotations are held at 1e-4 and the
    translations at 0.1 mm (0.037 mm measured on this rig)."""
    cam_K, proj_K, R, T = synth_rig
    jcal = jtri.make_calibration(cam_K, proj_K, R, T, CAM_H, CAM_W,
                                 SMALL_PROJ.width, SMALL_PROJ.height)
    jmerged, jposes = jscan360.scan_stacks_to_cloud(
        jnp.asarray(stacks), jcal, SMALL_PROJ.col_bits, SMALL_PROJ.row_bits,
        params=jscan360.Scan360Params(
            merge=jmerge.MergeParams(**FAST), method="sequential",
            view_cap=8192, stop_chunk=2, decode_strategy="scan"))
    cal = tri.calibration_from_numpy(
        {k: np.asarray(v) for k, v in jcal._asdict().items()}, device="cpu")
    merged, poses = scan360.scan_stacks_to_cloud(
        stacks, cal, SMALL_PROJ.col_bits, SMALL_PROJ.row_bits,
        params=scan360.Scan360Params(
            merge=merge.MergeParams(**FAST), view_cap=8192, stop_chunk=2,
            decode_strategy="scan"), device="cpu")
    jposes = np.asarray(jposes)
    np.testing.assert_allclose(poses[:, :3, :3], jposes[:, :3, :3],
                               atol=1e-4)
    np.testing.assert_allclose(poses[:, :3, 3], jposes[:, :3, 3], atol=0.1)
    assert abs(len(merged) - len(jmerged)) <= 2
