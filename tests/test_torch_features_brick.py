"""The brick-layout FPFH of the port (``ops/features_brick.py``) and the
file-level ring merges of ``models/merge.py`` against the JAX package.

Tolerances:
* ``fpfh_brick`` at ``tests/test_features_brick.py``'s tolerances for one
  estimator against another — validity ≥ 99.5% equal, the per-row max
  descriptor gap < 1e-3 at the median, cosine > 0.999 at worst — here met
  far inside: the two forms compute the same pairs and differ only by
  float32 sum order; overflow counts equal;
* ``merge_pro_360`` / ``merge_posegraph_360`` / ``merge_360_files`` on the
  JAX merge tests' 4-view ring: the RANSAC draws differ (``torch.Generator``
  against ``jax.random``), so poses are compared by outcome — every pose
  within 0.5° of the JAX package's and of the commanded turntable step —
  and merged point counts within 5%.
"""

import os

import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.io import ply as jply
from structured_light_for_3d_model_replication_tpu.models import (
    merge as jmerge,
)
from structured_light_for_3d_model_replication_tpu.ops import (
    features_brick as jfb,
)
from structured_light_for_3d_model_replication_tpu.ops import pointcloud as jpc
from structured_light_for_3d_model_replication_tpu_torch.io import ply
from structured_light_for_3d_model_replication_tpu_torch.models import merge
from structured_light_for_3d_model_replication_tpu_torch.ops import (
    features_brick,
)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    old = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(old)


def _surface(rng, n, scale=100.0):
    """``tests/test_features_brick.py``'s wavy surface, normals by the JAX
    package's PCA (both engines get the same normals)."""
    xy = rng.uniform(-scale, scale, (n, 2)).astype(np.float32)
    z = 12.0 * np.sin(xy[:, 0] / 25.0) * np.cos(xy[:, 1] / 30.0)
    pts = np.column_stack([xy, z]).astype(np.float32)
    nrm, nv = jpc.estimate_normals(pts, k=12)
    return pts, np.asarray(nrm), np.asarray(nv)


def _cos(a, b):
    return np.sum(a * b, 1) / np.maximum(
        np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1), 1e-9)


@pytest.mark.parametrize("n,scale,radius,slots,max_cells", [
    (1500, 100.0, 12.0, 64, 1024),     # the cap unbound
    (4000, 60.0, 15.0, 64, 1024),      # dense: some cells overflow 64 slots
    (3000, 100.0, 12.0, 16, 64),       # slot and cell budgets both bind
])
def test_fpfh_brick_matches_jax(n, scale, radius, slots, max_cells):
    rng = np.random.default_rng(7)
    pts, nrm, nv = _surface(rng, n, scale)
    jf, jv, jo = (np.asarray(a) for a in jfb.fpfh_brick(
        pts, nrm, radius, valid=nv, slots=slots, max_cells=max_cells))
    f, v, o = features_brick.fpfh_brick(
        torch.tensor(pts), torch.tensor(nrm), radius, valid=torch.tensor(nv),
        slots=slots, max_cells=max_cells)
    f, v = f.numpy(), v.numpy()
    assert o == int(jo)
    assert (v == jv).mean() >= 0.995
    both = v & jv
    err = np.abs(f[both] - jf[both]).max(axis=1)
    assert np.median(err) < 1e-3
    assert _cos(f[both], jf[both]).min() > 0.999
    np.testing.assert_allclose(f[both].reshape(-1, 3, 11).sum(-1), 100.0,
                               atol=1e-3)


def _rot_z(deg):
    th = np.deg2rad(deg)
    c, s = np.cos(th), np.sin(th)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return T


def _ring(n_views=4, deg=12.0, n_pts=600):
    """``tests/test_merge.py``'s ring: a bumpy closed surface seen from a
    turntable, view i holding the object rotated by −i·deg."""
    rng = np.random.default_rng(0)
    u = rng.normal(size=(n_pts, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    r = 1.0 + 0.3 * np.sin(4 * u[:, 0]) * np.cos(3 * u[:, 1]) \
        + 0.15 * np.sin(5 * u[:, 2])
    base = (u * r[:, None]).astype(np.float32)
    views = []
    for i in range(n_views):
        pts = base @ _rot_z(-deg * i)[:3, :3].T
        pts += rng.normal(scale=0.003, size=pts.shape)
        keep = rng.random(n_pts) > (0.05 * i)
        views.append(pts[keep].astype(np.float32))
    return views


FAST = dict(voxel_size=0.08, ransac_iterations=2048, icp_iterations=20,
            fpfh_max_nn=32, normals_k=12, posegraph_iterations=20)


def _rot_gap_deg(a, b):
    R = a[:3, :3].astype(np.float64) @ b[:3, :3].astype(np.float64).T
    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1,
                                              1))))


def _check_poses(poses, jposes, deg=12.0):
    assert poses.shape == jposes.shape
    for i, (p, jp) in enumerate(zip(poses, jposes)):
        assert _rot_gap_deg(p, jp) <= 0.5, (i, _rot_gap_deg(p, jp))
        assert _rot_gap_deg(p, _rot_z(deg * i)) <= 0.5


@pytest.mark.parametrize("engine", ["gather", "brick"])
def test_merge_pro_360_matches_jax(engine):
    views = _ring()
    colors = [np.full((len(v), 3), 128, np.uint8) for v in views]
    jm, jposes = jmerge.merge_pro_360(
        [jply.PointCloud(v, c) for v, c in zip(views, colors)],
        jmerge.MergeParams(**FAST, fpfh_engine=engine))
    m, poses = merge.merge_pro_360(
        [ply.PointCloud(v, c) for v, c in zip(views, colors)],
        merge.MergeParams(**FAST, fpfh_engine=engine), device="cpu")
    _check_poses(poses, jposes)
    assert abs(len(m) - len(jm)) <= 0.05 * len(jm)
    assert m.colors is not None and m.normals is not None


def test_merge_360_files_matches_jax(tmp_path):
    """The pose-graph method from a folder of PLY files (numeric order:
    scan_10 sorts after scan_2), brick FPFH, written and read back."""
    views = _ring(n_views=3)
    for i, v in enumerate(views):
        jply.write_ply(str(tmp_path / f"scan_{(i + 1) * 4}.ply"),
                       jply.PointCloud(v))
    params = dict(FAST, fpfh_engine="brick")
    jm = jmerge.merge_360_files(str(tmp_path), str(tmp_path / "j.out"),
                                jmerge.MergeParams(**params))
    m = merge.merge_360_files(str(tmp_path), str(tmp_path / "t.out"),
                              merge.MergeParams(**params), device="cpu")
    back = ply.read_ply(str(tmp_path / "t.out"))
    assert len(back) == len(m) > 0
    assert abs(len(m) - len(jm)) <= 0.05 * len(jm)
    # The poses themselves, through the same clouds.
    clouds = [ply.read_ply(str(tmp_path / f"scan_{(i + 1) * 4}.ply"))
              for i in range(3)]
    _, poses = merge.merge_posegraph_360(clouds, merge.MergeParams(**params),
                                         device="cpu")
    _, jposes = jmerge.merge_posegraph_360(
        [jply.PointCloud(c.points) for c in clouds],
        jmerge.MergeParams(**params))
    _check_poses(poses, jposes)


def test_register_pair_clouds_matches_jax():
    views = _ring(n_views=2)
    params = dict(FAST, fpfh_engine="brick")
    res, info = merge.register_pair_clouds(
        ply.PointCloud(views[1]), ply.PointCloud(views[0]),
        merge.MergeParams(**params), device="cpu")
    jres, jinfo = jmerge.register_pair_clouds(
        jply.PointCloud(views[1]), jply.PointCloud(views[0]),
        jmerge.MergeParams(**params))
    T = res.transformation.numpy()
    assert _rot_gap_deg(T, np.asarray(jres.transformation)) <= 0.5
    assert _rot_gap_deg(T, _rot_z(12.0)) <= 0.5
    assert abs(float(res.fitness) - float(jres.fitness)) <= 0.05
    assert info.shape == (6, 6)
