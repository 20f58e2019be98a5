"""The quality-gated 360° tail (``Scan360Params.gates``, ``health``,
``stop_labels``) — the port's against the JAX package's, on the 4-stop, 10°
rig of tests/test_scan360.py with its FAST parameters
(``final_max_points=4096`` in both packages) and
``QualityGates(min_coverage=0.02, min_edge_fitness=0.2)``.

Tolerances. On the clean stacks the gated path runs the ungated ring (no
stop dropped, every edge passes), so within the port it is bit-equal to the
ungated multi-launch path: poses, points, colours, normals. With stop 1's
stack zeroed, against the JAX package's gated run on the same stacks: the
same dropped stops, the same ``(src, dst, gap)`` edges, the same edge
verdicts and actions, the same health notes, and the survivors' pose angles
within 0.5° of the JAX poses' (the RANSAC streams differ); the dropped stop
keeps the identity pose in both. The terminal guard is held to the JAX
package's on the same host inputs: equal points and equal notes.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu import health as jhealth
from structured_light_for_3d_model_replication_tpu.io.ply import (
    PointCloud as JPointCloud,
)
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
from structured_light_for_3d_model_replication_tpu_torch import health
from structured_light_for_3d_model_replication_tpu_torch.io.ply import (
    PointCloud,
)
from structured_light_for_3d_model_replication_tpu_torch.models import (
    merge,
    scan360,
)
from structured_light_for_3d_model_replication_tpu_torch.ops import (
    triangulate as tri,
)

from .conftest import CAM_H, CAM_W, SMALL_PROJ

SPHERES = ((0.0, 10.0, 500.0, 80.0, 0.9), (60.0, -40.0, 460.0, 35.0, 0.7),
           (-70.0, 40.0, 530.0, 30.0, 0.8), (20.0, 70.0, 440.0, 25.0, 0.75))
FAST = dict(voxel_size=6.0, ransac_iterations=2048, icp_iterations=20,
            fpfh_max_nn=32, normals_k=12, max_points=2048,
            final_max_points=4096)
GATES = dict(min_coverage=0.02, min_edge_fitness=0.2)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    """This module's PyTorch ops get the worker's share of the cores (see
    tests/test_torch_meshing.py)."""
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, n // workers))
    yield
    torch.set_num_threads(n)


def _angle(T):
    return np.degrees(np.arccos(np.clip((np.trace(T[:3, :3]) - 1) / 2,
                                        -1, 1)))


@pytest.fixture(scope="module")
def rig(synth_rig):
    scene = jsynthetic.Scene(wall_z=None, spheres=tuple(
        jsynthetic.Sphere((x, y, z), r, a) for x, y, z, r, a in SPHERES))
    cam_K, proj_K, R, T = synth_rig
    scans = jsynthetic.render_turntable_scans(
        scene, n_stops=4, degrees_per_stop=10.0, cam_K=cam_K, proj_K=proj_K,
        R=R, T=T, cam_height=CAM_H, cam_width=CAM_W, proj=SMALL_PROJ)
    stacks = np.stack([s for s, _ in scans])
    zeroed = stacks.copy()
    zeroed[1] = 0
    jcal = jtri.make_calibration(cam_K, proj_K, R, T, CAM_H, CAM_W,
                                 SMALL_PROJ.width, SMALL_PROJ.height)
    cal = tri.calibration_from_numpy(
        {k: np.asarray(v) for k, v in jcal._asdict().items()}, device="cpu")
    return stacks, zeroed, jcal, cal


def _port(rig, stacks, gates=True, report=None, **kw):
    params = scan360.Scan360Params(
        merge=merge.MergeParams(**FAST), view_cap=8192,
        gates=health.QualityGates(**GATES) if gates else None)
    return scan360.scan_stacks_to_cloud(
        stacks, rig[3], SMALL_PROJ.col_bits, SMALL_PROJ.row_bits,
        params=params, with_stats=True, health=report, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_zeroed(rig):
    params = jscan360.Scan360Params(
        merge=jmerge.MergeParams(**FAST), view_cap=8192,
        gates=jhealth.QualityGates(**GATES))
    report = jhealth.ScanHealthReport()
    merged, poses, stats = jscan360.scan_stacks_to_cloud(
        jnp.asarray(rig[1]), rig[2], SMALL_PROJ.col_bits,
        SMALL_PROJ.row_bits, params=params, with_stats=True, health=report)
    return merged, poses, stats, report


def test_gated_clean_is_the_ungated_path(rig):
    report = health.ScanHealthReport()
    merged, poses, stats = _port(rig, rig[0], report=report)
    ref, ref_poses, ref_stats = _port(rig, rig[0], gates=False)
    assert np.array_equal(poses, ref_poses)
    assert np.array_equal(merged.points, ref.points)
    assert np.array_equal(merged.colors, ref.colors)
    assert np.array_equal(merged.normals, ref.normals)
    assert stats["dropped_stops"] == [] and report.dropped_stops == []
    assert [(e["src"], e["dst"], e["gap"]) for e in stats["edges"]] == [
        (1, 0, 1), (2, 1, 1), (3, 2, 1)]
    assert [e["fitness"] for e in stats["edges"]] == [
        e["fitness"] for e in ref_stats["edges"]]
    assert all(e.verdict == "pass" and e.action == "kept"
               for e in report.edges)
    assert report.notes == []


def test_gated_drop_matches_jax(rig, jax_zeroed):
    jmerged, jposes, jstats, jreport = jax_zeroed
    report = health.ScanHealthReport()
    merged, poses, stats = _port(rig, rig[1], report=report)
    assert stats["dropped_stops"] == jstats["dropped_stops"] == [1]
    assert report.dropped_stops == jreport.dropped_stops == [1]
    assert [(e["src"], e["dst"], e["gap"]) for e in stats["edges"]] == [
        (e["src"], e["dst"], e["gap"]) for e in jstats["edges"]] == [
        (2, 0, 2), (3, 2, 1)]
    assert [(e.verdict, e.action) for e in report.edges] == [
        (e.verdict, e.action) for e in jreport.edges]
    assert report.notes == jreport.notes
    np.testing.assert_allclose([e["fitness"] for e in stats["edges"]],
                               [e["fitness"] for e in jstats["edges"]],
                               atol=0.02)
    for i in (0, 2, 3):
        a, ja = _angle(poses[i]), _angle(np.asarray(jposes[i]))
        assert abs(a - ja) <= 0.5, (i, a, ja)
        assert abs(a - 10.0 * i) <= 3.0, (i, a)
    assert np.array_equal(poses[1], np.eye(4, dtype=np.float32))
    assert np.array_equal(np.asarray(jposes[1]), np.eye(4, dtype=np.float32))
    assert abs(len(merged) - len(jmerged)) <= 0.05 * len(jmerged)
    assert merged.colors.dtype == np.uint8 and merged.normals is not None
    assert report.to_dict()["stops"][1]["status"] == "dropped"


def test_stop_labels_key_the_report_and_mismatch_raises(rig):
    report = health.ScanHealthReport()
    _, _, stats = _port(rig, rig[1], report=report, stop_labels=[0, 2, 3, 5])
    assert stats["dropped_stops"] == [2]
    assert [(e["src"], e["dst"], e["gap"]) for e in stats["edges"]] == [
        (3, 0, 3), (5, 3, 2)]
    with pytest.raises(ValueError, match="stop_labels"):
        _port(rig, rig[0], stop_labels=[0, 1, 2])


def _guard_inputs():
    sub_pts = np.zeros((2, 8, 3), np.float32)
    sub_pts[1, :4] = np.arange(12, dtype=np.float32).reshape(4, 3)
    sub_val = np.zeros((2, 8), bool)
    sub_val[1, :4] = True
    return sub_pts, sub_val, np.array([0.0, 0.5])


@pytest.mark.parametrize("case", ["nan", "empty"])
def test_terminal_guard_matches_jax(case):
    sub_pts, sub_val, cov = _guard_inputs()
    pts = (np.array([[0, 0, 0], [np.nan, 1, 2], [3, 4, 5]], np.float32)
           if case == "nan" else np.zeros((0, 3), np.float32))
    cols = np.arange(pts.size, dtype=np.uint8).reshape(pts.shape)
    jreport, report = jhealth.ScanHealthReport(), health.ScanHealthReport()
    ref = jscan360._terminal_guard_cloud(
        JPointCloud(points=pts, colors=cols, normals=pts.copy()), sub_pts,
        sub_val, cov, jreport)
    out = scan360._terminal_guard_cloud(
        PointCloud(points=pts, colors=cols, normals=pts.copy()),
        torch.from_numpy(sub_pts), torch.from_numpy(sub_val), cov, report)
    assert np.array_equal(out.points, ref.points)
    assert len(out) == (2 if case == "nan" else 4)
    assert np.isfinite(out.points).all()
    assert report.notes == jreport.notes and len(report.notes) == 1
    for attr in ("colors", "normals"):
        a, b = getattr(out, attr), getattr(ref, attr)
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a, b)
