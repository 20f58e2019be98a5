"""The port's offline renderer (``viz``) and ``cli view`` against the JAX
package's on the same seeded clouds and meshes.

``viz`` is numpy in both packages, so every image is compared bit for bit.
``cli view`` runs on ``--device cpu`` in every mode: the plain and mesh
renders and the pair panel without ``--icp`` equal the JAX tool's PNG;
``--outliers`` and ``--plane`` compute their masks with the port's SOR
and RANSAC, which equal the JAX package's on these clouds, so their PNGs
are equal too; ``--compare --icp`` registers with the port's RANSAC + ICP
(its draws are the port's own), held to an aligned pair.
"""

import os

import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu import viz as jviz
from structured_light_for_3d_model_replication_tpu.cli import view as jview
from structured_light_for_3d_model_replication_tpu_torch import cli, viz
from structured_light_for_3d_model_replication_tpu_torch.cli import view
from structured_light_for_3d_model_replication_tpu_torch.io import ply as ply_io
from structured_light_for_3d_model_replication_tpu_torch.io import stl as stl_io


@pytest.fixture(scope="module", autouse=True)
def _threads():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    old = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(old)


def _sphere_cloud(rng, n=4000, radius=50.0, center=(0.0, 0.0, 0.0)):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (np.asarray(center) + radius * v).astype(np.float32)


def _wall_scene(rng, n_wall=1500, n_obj=900, outliers=30):
    """A capture-like cloud in mm: a wall at z = 700 behind a sphere of
    radius 80, 0.3 mm noise, a few far outliers."""
    wall = np.column_stack([rng.uniform(-250, 250, (n_wall, 2)),
                            np.full(n_wall, 700.0)])
    u = rng.normal(size=(n_obj, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    u[:, 2] = -np.abs(u[:, 2])
    obj = u * 80.0 + np.array([0.0, 10.0, 500.0])
    far = rng.uniform(-200, 200, (outliers, 3)) + np.array([0, 0, 450.0])
    pts = np.vstack([wall, obj, far])
    return (pts + rng.normal(0, 0.3, pts.shape)).astype(np.float32)


def _uv_sphere(radius=40.0, n_lat=24, n_lon=32):
    lat = np.linspace(0, np.pi, n_lat + 1)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    la, lo = np.meshgrid(lat, lon, indexing="ij")
    verts = radius * np.stack([np.sin(la) * np.cos(lo), np.cos(la),
                               np.sin(la) * np.sin(lo)], -1).reshape(-1, 3)
    faces = []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            c, d = a + n_lon, b + n_lon
            faces += [(a, c, b), (b, c, d)]
    return verts, np.asarray(faces, np.int64)


def _nonbg(img):
    return np.any(img != np.asarray(viz.BACKGROUND, np.uint8), axis=-1)


# ---------------------------------------------------------------------------
# viz: bit for bit against the JAX package
# ---------------------------------------------------------------------------


def test_palette_and_png_roundtrip(tmp_path, rng):
    for name in ("INLIER_GREY", "OUTLIER_RED", "PAIR_ORANGE", "PAIR_BLUE",
                 "PLANE_GREEN", "MESH_BONE", "BACKGROUND"):
        assert getattr(viz, name) == getattr(jviz, name)
    img = rng.integers(0, 256, size=(37, 53, 3), dtype=np.uint8)
    viz.save_png(tmp_path / "x.png", img)
    jviz.save_png(tmp_path / "j.png", img)
    assert (tmp_path / "x.png").read_bytes() == (tmp_path / "j.png"
                                                 ).read_bytes()
    np.testing.assert_array_equal(viz.load_png(tmp_path / "x.png"), img)


@pytest.mark.parametrize("colored", [False, True])
def test_render_points_equals_jax(rng, colored):
    pts = _sphere_cloud(rng)
    cols = rng.integers(0, 256, (len(pts), 3), dtype=np.uint8) \
        if colored else None
    kw = dict(width=320, height=240, azim=40.0, elev=15.0, point_px=3)
    img = viz.render_points(pts, cols, **kw)
    np.testing.assert_array_equal(img, jviz.render_points(pts, cols, **kw))
    assert 0.02 < _nonbg(img).mean() < 0.8
    empty = viz.render_points(np.zeros((0, 3), np.float32))
    assert not _nonbg(empty).any()


def test_render_inliers_and_plane_split_equal_jax(rng):
    pts = _wall_scene(rng)
    keep = rng.random(len(pts)) > 0.1
    kw = dict(width=240, height=180)
    img = viz.render_inliers(pts, keep, **kw)
    np.testing.assert_array_equal(img, jviz.render_inliers(pts, keep, **kw))
    assert (img == np.uint8(viz.OUTLIER_RED)).all(-1).sum() > 5
    plane = pts[:, 2] > 690
    img = viz.render_plane_split(pts, plane, **kw)
    np.testing.assert_array_equal(img,
                                  jviz.render_plane_split(pts, plane, **kw))
    assert (img == np.uint8(viz.PLANE_GREEN)).all(-1).any()


def test_render_pair_equals_jax(rng):
    a = _sphere_cloud(rng, n=800)
    b = a + np.float32([30.0, 0, 0])
    t = np.eye(4)
    t[:3, 3] = [30.0, 0.0, 0.0]
    for transform in (None, t):
        img = viz.render_pair(a, b, transform, width=400, height=150)
        np.testing.assert_array_equal(
            img, jviz.render_pair(a, b, transform, width=400, height=150))
        assert (img == np.uint8(viz.PAIR_ORANGE)).all(-1).any()
        assert (img == np.uint8(viz.PAIR_BLUE)).all(-1).any()


def test_render_mesh_equals_jax():
    verts, faces = _uv_sphere()
    img = viz.render_mesh(verts, faces, width=320, height=240)
    np.testing.assert_array_equal(img, jviz.render_mesh(verts, faces,
                                                        width=320,
                                                        height=240))
    on = _nonbg(img)
    ys, xs = np.nonzero(on)
    cy, cx = int(ys.mean()), int(xs.mean())
    assert on[cy - 15:cy + 15, cx - 15:cx + 15].mean() > 0.98


# ---------------------------------------------------------------------------
# cli view, every mode, on --device cpu
# ---------------------------------------------------------------------------


def _both_view(tmp_path, argv, name):
    """Run ``view`` in both packages with ``argv`` (``{}`` marks the
    output); return the two decoded PNGs."""
    out = str(tmp_path / f"{name}_port.png")
    jout = str(tmp_path / f"{name}_jax.png")
    assert cli.main(["view", *[a.format(out) for a in argv],
                     "--device", "cpu"]) == 0
    assert jview.main([a.format(jout) for a in argv]) == 0
    return viz.load_png(out), viz.load_png(jout)


@pytest.fixture()
def wall_ply(tmp_path, rng):
    pts = _wall_scene(rng)
    cols = rng.integers(0, 256, (len(pts), 3), dtype=np.uint8)
    path = tmp_path / "wall.ply"
    ply_io.write_ply(str(path), ply_io.PointCloud(points=pts, colors=cols))
    return str(path), pts


@pytest.mark.parametrize("mode", ["plain", "no-color"])
def test_cli_view_plain_equals_jax(tmp_path, wall_ply, mode):
    src, _ = wall_ply
    flags = ["--no-color"] if mode == "no-color" else []
    img, jimg = _both_view(tmp_path, [src, "-o", "{}", "--size", "240x180",
                                      *flags], mode)
    np.testing.assert_array_equal(img, jimg)
    assert _nonbg(img).any()


def test_cli_view_outliers_mask_equals_jax(tmp_path, wall_ply, capsys):
    """``--outliers``: the port's SOR mask on the cloud equals the JAX
    package's, so the PNGs are equal; the rejected count is printed."""
    import jax.numpy as jnp

    from structured_light_for_3d_model_replication_tpu.ops import (
        pointcloud as jpc,
    )

    src, pts = wall_ply
    keep = view.outlier_mask(pts, "cpu")
    jkeep = np.asarray(jpc.statistical_outlier_removal(
        jnp.asarray(pts), nb_neighbors=20, std_ratio=2.0))
    np.testing.assert_array_equal(keep, jkeep)
    assert keep[-30:].mean() < 0.3
    img, jimg = _both_view(tmp_path, [src, "-o", "{}", "--outliers",
                                      "--size", "240x180"], "outliers")
    np.testing.assert_array_equal(img, jimg)
    assert f"outliers: {int((~keep).sum())}/{len(pts)} rejected" \
        in capsys.readouterr().err


def test_cli_view_plane_mask_equals_jax(tmp_path, wall_ply, capsys):
    """``--plane`` at the default threshold (bbox diagonal / 50): the
    port's RANSAC inlier mask equals the JAX package's (the wall), so the
    PNGs are equal."""
    import jax.numpy as jnp

    from structured_light_for_3d_model_replication_tpu.ops import (
        segmentation as jseg,
    )

    src, pts = wall_ply
    thresh = view.plane_threshold(pts)
    pm = view.plane_mask(pts, thresh, "cpu")
    _, jinl = jseg.segment_plane(jnp.asarray(pts), distance_threshold=thresh,
                                 num_iterations=1000)
    np.testing.assert_array_equal(pm, np.asarray(jinl))
    assert pm[:1500].all() and pm[1500:2400].mean() < 0.05
    img, jimg = _both_view(tmp_path, [src, "-o", "{}", "--plane",
                                      "--size", "240x180"], "plane")
    np.testing.assert_array_equal(img, jimg)
    assert f"plane: {int(pm.sum())}/{len(pts)} points" \
        in capsys.readouterr().err


def _icp_line(err: str) -> tuple[float, float]:
    """(fitness, rmse) from the ``icp: fitness=… rmse=…`` line."""
    line = err.split("icp: fitness=")[1].split("\n")[0]
    return float(line.split()[0]), float(line.split("rmse=")[1])


def test_cli_view_compare_and_icp(tmp_path, rng, capsys):
    """``--compare`` without ``--icp`` equals the JAX tool's panel; with
    ``--icp`` the port's registration moves the source onto the target as
    the JAX tool's does on the same PLYs: the printed fitness within 0.01
    and rmse within 2% of the JAX tool's (their RANSAC draws differ), the
    unmoved left panels equal."""
    a = _sphere_cloud(rng, n=1500)
    a[:200, 1] *= 1.6                     # break the sphere's symmetry
    ang = np.radians(12.0)
    rot = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                    [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    b = (a @ rot.T + np.float32([8.0, 0, 0])).astype(np.float32)
    pa, pb = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    ply_io.write_ply(pa, ply_io.PointCloud(points=a))
    ply_io.write_ply(pb, ply_io.PointCloud(points=b))
    img, jimg = _both_view(tmp_path, [pa, "-o", "{}", "--compare", pb,
                                      "--size", "200x150"], "pair")
    np.testing.assert_array_equal(img, jimg)
    out, jout = str(tmp_path / "icp.png"), str(tmp_path / "icp_jax.png")
    capsys.readouterr()
    assert cli.main(["view", pa, "-o", out, "--compare", pb, "--icp",
                     "--size", "200x150", "--device", "cpu"]) == 0
    fitness, rmse = _icp_line(capsys.readouterr().err)
    assert jview.main([pa, "-o", jout, "--compare", pb, "--icp",
                       "--size", "200x150"]) == 0
    jfitness, jrmse = _icp_line(capsys.readouterr().err)
    assert fitness > 0.9
    assert abs(fitness - jfitness) <= 0.01
    assert abs(rmse - jrmse) <= 0.02 * jrmse
    icp, jicp = viz.load_png(out), viz.load_png(jout)
    assert icp.shape == jicp.shape == (150, 400, 3)
    np.testing.assert_array_equal(icp[:, :200], jicp[:, :200])
    assert (icp[:, 101:] == np.uint8(viz.PAIR_ORANGE)).all(-1).any()


def test_cli_view_mesh_equals_jax(tmp_path):
    verts, faces = _uv_sphere(n_lat=8, n_lon=12)
    path = str(tmp_path / "m.stl")
    stl_io.write_stl(path, stl_io.TriangleMesh(
        vertices=verts.astype(np.float32), faces=faces))
    img, jimg = _both_view(tmp_path, [path, "-o", "{}", "--size", "200x150"],
                           "mesh")
    np.testing.assert_array_equal(img, jimg)
    assert _nonbg(img).any()


def test_cli_view_bad_size_exits_2(tmp_path, wall_ply):
    src, _ = wall_ply
    assert cli.main(["view", src, "-o", str(tmp_path / "x.png"), "--size",
                     "big", "--device", "cpu"]) == 2
