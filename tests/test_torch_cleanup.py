"""The cleanup path of the port — RANSAC plane removal, statistical and
radius outlier removal, DBSCAN, the self-query KNN dispatch and the PLY
reader — against the JAX package on the same numpy clouds.

Tolerances:
* ``segment_plane``: the two packages draw different hypothesis triples
  (``torch.Generator`` against ``jax.random``), so outcomes are compared:
  plane normals within 0.1°, offsets within 0.05 mm, inlier masks ≥ 99.9%
  equal;
* ``remove_background`` / ``remove_outliers`` / ``radius_outlier_removal``:
  keep masks ≥ 99.5% equal (the KNN engines are the same algorithm; the
  plane's draws differ);
* DBSCAN labels and the largest-cluster mask exact (the exact KNN's sets
  equal the JAX package's);
* the ``"auto"`` KNN route equal to the JAX package's on and off its
  accelerator, for every (n, k) at the edges of the rule;
* the PLY reader exact.
"""

import io
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.io import ply as jply
from structured_light_for_3d_model_replication_tpu.models import (
    merge as jmerge,
)
from structured_light_for_3d_model_replication_tpu.ops import cluster as jcl
from structured_light_for_3d_model_replication_tpu.ops import pointcloud as jpc
from structured_light_for_3d_model_replication_tpu.ops import (
    segmentation as jseg,
)
from structured_light_for_3d_model_replication_tpu_torch.io import ply
from structured_light_for_3d_model_replication_tpu_torch.models import merge
from structured_light_for_3d_model_replication_tpu_torch.ops import (
    cluster,
    pointcloud,
    segmentation,
)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    old = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(old)


def _wall_scene(seed=0, n_wall=2500, n_obj=1500, outliers=40):
    """A capture-like cloud in mm: the wall at z = 700 behind a sphere of
    radius 80 at z = 500, 0.3 mm noise, a few gross outliers."""
    rng = np.random.default_rng(seed)
    wall = np.column_stack([rng.uniform(-250, 250, (n_wall, 2)),
                            np.full(n_wall, 700.0)])
    u = rng.normal(size=(n_obj, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    u[:, 2] = -np.abs(u[:, 2])                       # the side facing us
    obj = u * 80.0 + np.array([0.0, 10.0, 500.0])
    far = rng.uniform(-200, 200, (outliers, 3)) + np.array([0, 0, 450.0])
    pts = np.vstack([wall, obj, far]) + rng.normal(0, 0.3, (n_wall + n_obj
                                                            + outliers, 3))
    return pts.astype(np.float32)


def _mask_of(cloud_pts, kept_pts):
    """Row mask of ``cloud_pts`` whose (unique) rows survive in ``kept``."""
    view = np.dtype((np.void, 12))
    return np.isin(np.ascontiguousarray(cloud_pts).view(view).ravel(),
                   np.ascontiguousarray(kept_pts).view(view).ravel())


def _angle_deg(a, b):
    c = abs(float(np.dot(a, b))) / (np.linalg.norm(a) * np.linalg.norm(b))
    return float(np.degrees(np.arccos(min(c, 1.0))))


def test_segment_plane_matches_jax():
    pts = _wall_scene()
    jplane, jinl = (np.asarray(a) for a in jseg.segment_plane(
        jnp.asarray(pts), distance_threshold=10.0, num_iterations=1000))
    plane, inl = segmentation.segment_plane(torch.tensor(pts), 10.0, 1000)
    plane, inl = plane.numpy(), inl.numpy()
    assert _angle_deg(plane[:3], jplane[:3]) <= 0.1
    sign = np.sign(np.dot(plane[:3], jplane[:3]))
    assert abs(plane[3] * sign - jplane[3]) <= 0.05
    assert (inl == jinl).mean() >= 0.999
    assert np.linalg.norm(plane[:3]) == pytest.approx(1.0, abs=1e-6)
    # The wall is the plane: z = 700 within 1 mm, every wall point an inlier.
    assert abs(abs(plane[3] / plane[2]) - 700.0) < 1.0
    assert inl[:2500].all() and inl[2500:4000].mean() < 0.05


def test_remove_background_matches_jax():
    pts = _wall_scene(1)
    cloud = ply.PointCloud(pts, colors=np.zeros((len(pts), 3), np.uint8))
    stats = {}
    out = merge.remove_background(cloud, stats=stats, device="cpu")
    jout = jmerge.remove_background(jply.PointCloud(pts))
    keep, jkeep = _mask_of(pts, out.points), _mask_of(pts, jout.points)
    assert (keep == jkeep).mean() >= 0.995
    assert out.colors is not None and len(out.colors) == len(out)
    assert stats["inliers"] == len(pts) - len(out)
    assert abs(abs(stats["plane"][3] / stats["plane"][2]) - 700.0) < 1.0


@pytest.mark.parametrize("method", ["dense", "rescue"])
def test_remove_outliers_matches_jax(method):
    """SOR on the cloud left after the wall: both packages' SOR with the
    KNN engine forced on the same padded cloud, and at this size (which
    routes to ``dense``) both ``remove_outliers`` entry points."""
    pts = _wall_scene(2)[2500:]
    p_pad, v_pad = merge._pad_cloud(pts, "cpu")
    keep = pointcloud.statistical_outlier_removal(
        p_pad, valid=v_pad, nb_neighbors=20, std_ratio=2.0,
        neighbor_method=method).numpy()[:len(pts)]
    jp_pad, jv_pad = jmerge._pad_cloud(jnp.asarray(pts))
    jkeep = np.asarray(jpc.statistical_outlier_removal(
        jp_pad, valid=jv_pad, nb_neighbors=20, std_ratio=2.0,
        neighbor_method=method))[:len(pts)]
    assert (keep == jkeep).mean() >= 0.995
    assert keep[-40:].mean() < 0.3          # the far outliers go
    if method == "dense":
        out = merge.remove_outliers(ply.PointCloud(pts), device="cpu")
        jout = jmerge.remove_outliers(jply.PointCloud(pts))
        assert np.array_equal(_mask_of(pts, out.points), keep)
        assert np.array_equal(_mask_of(pts, jout.points), jkeep)


@pytest.mark.parametrize("method", ["dense", "rescue"])
def test_radius_outlier_removal_matches_jax(method):
    pts = _wall_scene(3)[2500:]
    valid = np.random.default_rng(4).random(len(pts)) > 0.1
    jkeep = np.asarray(jpc.radius_outlier_removal(
        jnp.asarray(pts), 6.0, 5, valid=jnp.asarray(valid),
        neighbor_method=method))
    keep = pointcloud.radius_outlier_removal(
        torch.tensor(pts), 6.0, 5, valid=torch.tensor(valid),
        neighbor_method=method).numpy()
    assert (keep == jkeep).mean() >= 0.995
    assert not keep[~valid].any()


def _blobs(seed=5):
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 4.0, (900, 3)) + np.array([0, 0, 500.0])
    b = rng.normal(0, 3.0, (500, 3)) + np.array([60, 0, 500.0])
    noise = rng.uniform(-100, 100, (60, 3)) + np.array([0, 0, 500.0])
    return np.vstack([a, b, noise]).astype(np.float32)


def test_dbscan_and_keep_largest_cluster_match_jax():
    pts = _blobs()
    valid = np.ones(len(pts), bool)
    valid[::37] = False
    jl, jn = jcl.dbscan(jnp.asarray(pts), 3.0, 10, jnp.asarray(valid), 32)
    labels, n_clusters = cluster.dbscan(torch.tensor(pts), 3.0, 10,
                                        torch.tensor(valid), 32)
    assert n_clusters == int(jn) >= 2
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    jk = np.asarray(jcl.keep_largest_cluster(jnp.asarray(pts), 3.0, 10,
                                             jnp.asarray(valid), 32))
    keep = cluster.keep_largest_cluster(torch.tensor(pts), 3.0, 10,
                                        torch.tensor(valid), 32).numpy()
    np.testing.assert_array_equal(keep, jk)
    assert keep[:900].mean() > 0.8 and not keep[900:].any()
    # All noise: every valid point is kept.
    keep = cluster.keep_largest_cluster(torch.tensor(pts), 0.01, 10,
                                        torch.tensor(valid), 32).numpy()
    np.testing.assert_array_equal(keep, valid)


def test_self_knn_auto_route_matches_jax(monkeypatch):
    """The port's ``"auto"`` rule against the JAX package's
    ``_self_knn`` dispatch, which is run with its engines replaced by
    recorders and its backend test set: a CUDA device is the port's side
    of the JAX package's accelerator, the CPU the other."""
    seen = []

    def recorder(name):
        def engine(points, k, *a, **kw):
            seen.append(name)
        return engine

    for name in ("knn", "morton_knn", "brick_knn", "grid_knn"):
        monkeypatch.setattr(jpc, name, recorder(name))
    engines = {"knn": "dense", "morton_knn": "morton",
               "brick_knn": "rescue", "grid_knn": "grid"}
    for on_accel, device in ((True, "cuda"), (False, "cpu")):
        monkeypatch.setattr(jpc._backend, "tpu_backend", lambda v=on_accel: v)
        for n in (131_071, 131_072, 1 << 20, 1 << 24, (1 << 24) + 1):
            for k in (5, 20, 32, 33):
                jpc._self_knn(types.SimpleNamespace(shape=(n, 3)), k, None,
                              True)
                assert pointcloud._auto_method(n, k, device) \
                    == engines[seen[-1]], (n, k, device)
    # A CPU tensor above the threshold goes to the Morton engine.
    calls = []
    monkeypatch.setattr(pointcloud, "morton_knn",
                        lambda *a, **kw: calls.append("morton"))
    pointcloud._self_knn(torch.zeros((131_072, 3)), 20, None, True)
    assert calls == ["morton"]


def test_random_subsample_keeps_valid_points():
    pts = torch.arange(300, dtype=torch.float32).reshape(100, 3)
    valid = torch.arange(100) % 3 == 0               # 34 valid
    out, attrs, ov = pointcloud.random_subsample(pts, 20, valid=valid,
                                                 attrs=pts[:, 0])
    assert ov.all() and bool(valid[(out[:, 0] / 3).long()].all())
    assert len(set(out[:, 0].tolist())) == 20
    assert torch.equal(attrs, out[:, 0])
    out, _, ov = pointcloud.random_subsample(pts, 50, valid=valid)
    assert int(ov.sum()) == 34 and bool((out[~ov] == 0).all())


@pytest.mark.parametrize("binary", [True, False])
def test_read_ply_round_trip(binary):
    rng = np.random.default_rng(6)
    cloud = ply.PointCloud(
        points=rng.uniform(-100, 100, (257, 3)).astype(np.float32),
        colors=rng.integers(0, 256, (257, 3)).astype(np.uint8),
        normals=rng.normal(size=(257, 3)).astype(np.float32))
    buf = io.BytesIO()
    ply.write_ply(buf, cloud, binary=binary)
    back = ply.read_ply(io.BytesIO(buf.getvalue()))
    jback = jply.read_ply(io.BytesIO(buf.getvalue()))
    tol = 0 if binary else 5e-5          # ASCII keeps four decimals
    for a, b, c in ((back.points, jback.points, cloud.points),
                    (back.normals, jback.normals, cloud.normals)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, c, rtol=0, atol=tol + 1e-6 * 100)
    np.testing.assert_array_equal(back.colors, cloud.colors)
    np.testing.assert_array_equal(back.colors, jback.colors)
    bare = io.BytesIO()
    ply.write_ply(bare, ply.PointCloud(cloud.points), binary=binary)
    b2 = ply.read_ply(io.BytesIO(bare.getvalue()))
    assert b2.colors is None and b2.normals is None and len(b2) == 257
